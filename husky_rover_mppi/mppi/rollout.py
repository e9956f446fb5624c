"""Batched 2.5D / 2D trajectory rollouts over a heightfield.

A re-design of ``_generate_trajectories_kernel`` and
``_generate_trajectories_2D_kernel``
(thesis_master/warp_implementation/projection_warp.py:284-383).

The reference runs one CUDA thread per trajectory, each doing a sequential
H-step loop of scalar DEM loads. :func:`rollout_25d` instead advances the
*whole sample batch one horizon step at a time* under a single ``lax.scan``:
each step is one vectorized gather + fused elementwise block over all K
samples (and any leading rover axes). The horizon axis stays sequential — it
is a true data dependence (SURVEY.md §5). :func:`rollout_25d_pallas` runs
the reference's own shape instead: one fused GPU kernel with the horizon
loop inside each sample's lane.

Per-step op order matches the Warp kernel exactly (projection_warp.py:312-350)
so fixed-seed rollouts bit-match the NumPy oracle in float64.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from ..core import geometry as geom
from ..core import heightfield as hfield
from ..core import patch as patch_mod
from ..core.heightfield import HeightField
from ..core.patch import PatchField

WHEEL_OFFSET = 0.2  # m, lateral wheel-track offset (projection_warp.py:333)


class ChunkedField(NamedTuple):
    """Reach-adaptive patch schedule: consecutive horizon chunks read from
    successively larger patches (all centered on the robot start). Rollouts
    are reach-limited — after ``t`` steps no lookup can be farther than
    ``t*dt*v_max + WHEEL_OFFSET`` from the start — so early steps only need
    a small patch, and the one-hot selection cost scales with patch *area*:
    a 128-cell patch costs 1/4 of a 256-cell one per step.
    Values are bit-identical to a single covering patch (each chunk's patch
    covers every lookup its steps can make).

    ``lengths`` are trace-time Python ints (this pytree is always built
    inside ``mppi_step``, never passed across a jit boundary)."""

    patches: tuple    # tuple[PatchField, ...], smallest first
    lengths: tuple    # tuple[int, ...] horizon steps served by each patch


def _field_ops(hf):
    """Terrain-read ops for either a HeightField (direct XLA gathers) or a
    PatchField (one-hot matmul selection — bit-identical values, see
    core/patch.py). Dispatch is static at trace time."""
    if isinstance(hf, PatchField):
        corners = lambda x, y: patch_mod.corners_at(hf, x, y)
        wheels = lambda lx, ly, rx, ry: patch_mod.nearest_height_pair(
            hf, lx, ly, rx, ry)
        height = lambda x, y: patch_mod.height_at(hf, x, y)
    else:
        corners = lambda x, y: hfield.corners_at(hf, x, y)
        wheels = lambda lx, ly, rx, ry: (
            hfield.nearest_height(hf, lx, ly),
            hfield.nearest_height(hf, rx, ry),
        )
        height = lambda x, y: hfield.height_at(hf, x, y)
    return corners, wheels, height


def _as_chunks(hf, horizon: int):
    """Normalize a field argument to ((field, n_steps), ...)."""
    if isinstance(hf, ChunkedField):
        if sum(hf.lengths) != horizon:
            raise ValueError(
                f"chunk lengths {hf.lengths} do not sum to horizon {horizon}")
        return tuple(zip(hf.patches, hf.lengths))
    return ((hf, horizon),)


class Rollout(NamedTuple):
    """Trajectory bundle, each field ``batch + (H, 3)``."""

    trajectory: Array       # (x, y, bilinear height)
    headings: Array         # unit heading vectors after each step
    left_wheel: Array       # (x, y, nearest-cell height) of left wheel track
    right_wheel: Array      # same for right wheel track


def rollout_25d(
    hf: HeightField,
    position: Array,
    heading: Array,
    linear_velocities: Array,
    angular_velocities: Array,
    dt: float,
) -> Rollout:
    """Surface-riding kinematic rollout (projection_warp.py:284-350).

    Args:
        hf: heightfield window.
        position: start position ``batch + (2,)`` (every sample starts at the
            robot pose, MPPI_isaac.py:452).
        heading: previous heading vector ``(3,)`` or ``batch + (3,)``
            (shared across samples in the reference).
        linear_velocities, angular_velocities: ``batch + (H,)``.
        dt: step duration.

    Returns:
        :class:`Rollout` with fields ``batch + (H, 3)``.
    """
    lin = jnp.asarray(linear_velocities)
    batch = lin.shape[:-1]
    pos = jnp.broadcast_to(jnp.asarray(position, lin.dtype), batch + (2,))
    hv = jnp.broadcast_to(jnp.asarray(heading, lin.dtype), batch + (3,))
    chunks = _as_chunks(hf, lin.shape[-1])
    first = chunks[0][0]

    # Pre-loop init: project the shared heading onto the start-cell plane
    # (projection_warp.py:306-310).
    corners0, _, _ = _field_ops(first)
    q0 = corners0(pos[..., 0], pos[..., 1])
    n0 = hfield.quad_normal(q0, first.resolution)
    prev = hfield.tangent_project(n0, hv)

    def chunk_scan(field, carry, seq):
        corners, wheels, _ = _field_ops(field)

        def step(carry, inputs):
            pos, prev = carry
            lin_k, ang_k = inputs

            x, y = geom.update_position(pos[..., 0], pos[..., 1], prev, lin_k, dt)
            q = corners(x, y)
            height = hfield.bilinear(x, y, q, field.resolution)
            normal = hfield.quad_normal(q, field.resolution)
            prev = hfield.tangent_project(normal, prev)
            current = geom.update_orientation(prev, ang_k, normal, dt)

            traj = jnp.stack([x, y, height], axis=-1)

            # Wheel tracks: +/- offset along normal x heading, nearest-cell
            # height (projection_warp.py:332-348).
            right = WHEEL_OFFSET * jnp.cross(normal, current)
            lx, ly = x + right[..., 0], y + right[..., 1]
            rx, ry = x - right[..., 0], y - right[..., 1]
            lz, rz = wheels(lx, ly, rx, ry)
            lw = jnp.stack([lx, ly, lz], axis=-1)
            rw = jnp.stack([rx, ry, rz], axis=-1)

            new_pos = jnp.stack([x, y], axis=-1)
            return (new_pos, current), (traj, current, lw, rw)

        return jax.lax.scan(step, carry, seq)

    lin_t = jnp.moveaxis(lin, -1, 0)
    ang_t = jnp.moveaxis(jnp.asarray(angular_velocities), -1, 0)
    carry, outs, t0 = (pos, prev), [], 0
    for field, n in chunks:
        carry, ys = chunk_scan(
            field, carry, (lin_t[t0:t0 + n], ang_t[t0:t0 + n]))
        outs.append(ys)
        t0 += n
    traj, headings, lw, rw = (
        jnp.concatenate([o[i] for o in outs], axis=0) if len(outs) > 1
        else outs[0][i]
        for i in range(4)
    )

    mv = lambda arr: jnp.moveaxis(arr, 0, -2)
    return Rollout(mv(traj), mv(headings), mv(lw), mv(rw))


def rollout_25d_pallas(
    hf: HeightField,
    position: Array,
    heading: Array,
    linear_velocities: Array,
    angular_velocities: Array,
    dt: float,
    compute_wheels: bool = True,
    interpret: bool = False,
) -> Rollout:
    """:func:`rollout_25d` through the fused rollout kernel
    (ops/rollout_pallas.py): one kernel launch runs the whole horizon for
    every sample, reading the full heightfield. Same math; differs from the
    XLA path only in how multiply-adds are contracted.

    The kernel is compiled for the GPU; ``interpret=True`` runs it in the
    Pallas interpreter instead (tests). Anywhere else it raises."""
    from ..ops import rollout_pallas as rp

    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the fused rollout kernel compiles only for the GPU (backend is "
            f"{jax.default_backend()!r}); use gather_engine='direct'")
    if not isinstance(hf, HeightField):
        raise ValueError("the fused rollout kernel reads a full HeightField")
    lin = jnp.asarray(linear_velocities)
    if lin.ndim != 2:
        raise ValueError("the fused rollout kernel expects one sample axis")
    K = lin.shape[0]
    pos = jnp.asarray(position, lin.dtype)
    hv = jnp.asarray(heading, lin.dtype)
    if pos.ndim != 1 or hv.ndim != 1:
        raise ValueError("the fused rollout kernel expects a shared start "
                         "position and heading")
    # pre-loop init: project the heading onto the start-cell plane
    # (projection_warp.py:306-310)
    n0 = hfield.quad_normal(hfield.corners_at(hf, pos[0], pos[1]),
                            hf.resolution)
    prev = hfield.tangent_project(n0, hv)
    traj, heads, lw, rw = rp.rollout_chunk(
        hf, jnp.full((K,), pos[0]), jnp.full((K,), pos[1]),
        jnp.broadcast_to(prev, (K, 3)), lin,
        jnp.asarray(angular_velocities), dt, interpret=interpret,
        wheels=compute_wheels)
    return Rollout(traj, heads, lw, rw)


def rollout_2d(
    hf: HeightField,
    position: Array,
    heading: Array,
    linear_velocities: Array,
    angular_velocities: Array,
    dt: float,
) -> tuple[Array, Array]:
    """Flat-ground rollout: planar rotation, z looked up from the DEM only
    (projection_warp.py:353-383). Returns (trajectory, headings)."""
    lin = jnp.asarray(linear_velocities)
    batch = lin.shape[:-1]
    pos = jnp.broadcast_to(jnp.asarray(position, lin.dtype), batch + (2,))
    prev = jnp.broadcast_to(jnp.asarray(heading, lin.dtype), batch + (3,))
    chunks = _as_chunks(hf, lin.shape[-1])

    def chunk_scan(field, carry, seq):
        _, _, height_at = _field_ops(field)

        def step(carry, inputs):
            pos, prev = carry
            lin_k, ang_k = inputs
            x, y = geom.update_position(pos[..., 0], pos[..., 1], prev, lin_k, dt)
            current = geom.update_orientation_2d(prev, ang_k, dt)
            height = height_at(x, y)
            traj = jnp.stack([x, y, height], axis=-1)
            return (jnp.stack([x, y], axis=-1), current), (traj, current)

        return jax.lax.scan(step, carry, seq)

    lin_t = jnp.moveaxis(lin, -1, 0)
    ang_t = jnp.moveaxis(jnp.asarray(angular_velocities), -1, 0)
    carry, outs, t0 = (pos, prev), [], 0
    for field, n in chunks:
        carry, ys = chunk_scan(
            field, carry, (lin_t[t0:t0 + n], ang_t[t0:t0 + n]))
        outs.append(ys)
        t0 += n
    traj, headings = (
        jnp.concatenate([o[i] for o in outs], axis=0) if len(outs) > 1
        else outs[0][i]
        for i in range(2)
    )
    return jnp.moveaxis(traj, 0, -2), jnp.moveaxis(headings, 0, -2)
