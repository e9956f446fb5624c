"""Husky skid-steer dynamics: first-order wheel-speed lag + diff-drive map.

Reproduces ``_convert_inputs_to_velocities``
(thesis_master/warp_implementation/sampling_warp.py:96-139):

    w_t   = a * w_{t-1} + k * (1 - a) * u_t          (per wheel, unclamped)
    v_t   = clamp((w_l + w_r) / 2,       v_min, v_max)
    omega = clamp((-w_l + w_r) / track,  w_min, w_max)

where ``track`` is the reference's ``robot.radius`` (1.2 m, config.yaml:2),
``(k, a) = (3.5, 0.96)`` for sampled rollouts and ``(3.0, 0.92)`` for the
optimal sequence (MPPI_isaac.py:532-552, 672-692).

Two implementations:

* :func:`wheel_lag_scan` — the exact sequential semantics via ``lax.scan``
  (bit-matches the per-trajectory loop; used for oracle parity).
* :func:`wheel_lag_matmul` — the same linear recurrence as a lower-triangular
  Toeplitz matmul. The recurrence is linear in ``u`` (clamping only
  touches the *outputs*), so
  ``w_t = a^{t+1} w_init + k(1-a) * sum_s a^{t-s} u_s`` is one ``(K,H)@(H,H)``
  matmul per side — the formulation for large sample batches.
  Differs from the scan only in float summation order.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array


class DiffDriveLimits(NamedTuple):
    """Velocity clamps (config.yaml:10-16)."""

    v_min: float = 0.0
    v_max: float = 2.0
    w_min: float = -1.0
    w_max: float = 1.0


def _to_velocities(
    w_left: Array, w_right: Array, track: Array, limits: DiffDriveLimits
) -> tuple[Array, Array]:
    lin = jnp.clip((w_left + w_right) / 2.0, limits.v_min, limits.v_max)
    ang = jnp.clip((-w_left + w_right) / track, limits.w_min, limits.w_max)
    return lin, ang


def wheel_lag_scan(
    u1: Array,
    u2: Array,
    left0: Array,
    right0: Array,
    track: Array,
    limits: DiffDriveLimits,
    k: float,
    a: float,
) -> tuple[Array, Array]:
    """Exact sequential wheel-lag conversion.

    Args:
        u1, u2: left/right wheel input sequences, shape ``(..., H)``.
        left0, right0: current wheel speeds (broadcast against batch).
    Returns:
        (linear_velocities, angular_velocities), each ``(..., H)``.
    """
    u1 = jnp.asarray(u1)
    batch = u1.shape[:-1]
    l0 = jnp.broadcast_to(jnp.asarray(left0, u1.dtype), batch)
    r0 = jnp.broadcast_to(jnp.asarray(right0, u1.dtype), batch)

    def step(carry, u):
        left_prev, right_prev = carry
        ul, ur = u
        left = left_prev * a + ul * k * (1.0 - a)
        right = right_prev * a + ur * k * (1.0 - a)
        return (left, right), (left, right)

    # scan over time: move H to the leading axis
    us = (jnp.moveaxis(u1, -1, 0), jnp.moveaxis(u2, -1, 0))
    _, (wl, wr) = jax.lax.scan(step, (l0, r0), us)
    wl = jnp.moveaxis(wl, 0, -1)
    wr = jnp.moveaxis(wr, 0, -1)
    return _to_velocities(wl, wr, track, limits)


@functools.partial(jax.jit, static_argnames=("horizon", "k", "a", "dtype"))
def _lag_matrix(horizon: int, k: float, a: float, dtype=jnp.float32) -> Array:
    """Lower-triangular Toeplitz kernel L[t, s] = k(1-a) a^(t-s) for s <= t."""
    t = jnp.arange(horizon)
    expo = t[:, None] - t[None, :]
    mat = jnp.where(expo >= 0, a ** expo.astype(dtype), 0.0).astype(dtype)
    return mat * (k * (1.0 - a))


def wheel_lag_matmul(
    u1: Array,
    u2: Array,
    left0: Array,
    right0: Array,
    track: Array,
    limits: DiffDriveLimits,
    k: float,
    a: float,
) -> tuple[Array, Array]:
    """Matmul formulation of :func:`wheel_lag_scan` (same math, matmul
    order)."""
    u1 = jnp.asarray(u1)
    horizon = u1.shape[-1]
    dt = u1.dtype
    lag = _lag_matrix(horizon, k, a, dtype=dt)
    decay = a ** jnp.arange(1, horizon + 1, dtype=dt)
    # precision=HIGHEST: a reduced-precision f32 matmul (bf16 passes, or
    # TF32 on the GPU) would inject ~0.1-0.4% error into every commanded
    # wheel velocity — far beyond the documented summation-order delta vs
    # wheel_lag_scan
    wl = jnp.asarray(left0, dt)[..., None] * decay + jnp.einsum(
        "...s,ts->...t", u1, lag, preferred_element_type=dt,
        precision=jax.lax.Precision.HIGHEST,
    )
    wr = jnp.asarray(right0, dt)[..., None] * decay + jnp.einsum(
        "...s,ts->...t", u2, lag, preferred_element_type=dt,
        precision=jax.lax.Precision.HIGHEST,
    )
    return _to_velocities(wl, wr, track, limits)


def inverse_diff_drive(lin: Array, ang: Array, track: Array) -> tuple[Array, Array]:
    """Wheel speeds realizing (v, omega): the controller's post-step update
    (MPPI_isaac.py:783-784): ``left = v - w*track/2``, ``right = v + w*track/2``."""
    half = ang * track / 2.0
    return lin - half, lin + half
