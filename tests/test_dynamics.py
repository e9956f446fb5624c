"""Skid-steer wheel-lag dynamics vs the NumPy oracle."""

import jax.numpy as jnp
import numpy as np

from husky_rover_mppi.compat import warp_oracle as wo
from husky_rover_mppi.dynamics import (
    DiffDriveLimits,
    inverse_diff_drive,
    wheel_lag_matmul,
    wheel_lag_scan,
)

LIMITS = DiffDriveLimits(v_min=0.0, v_max=2.0, w_min=-1.0, w_max=1.0)
TRACK = 1.2


def _oracle(u1, u2, l0, r0, k, a):
    return wo.wheel_lag(
        u1, u2, l0, r0, TRACK, LIMITS.v_min, LIMITS.v_max, LIMITS.w_min,
        LIMITS.w_max, k, a,
    )


def test_scan_matches_oracle_exactly(rng):
    u1 = rng.uniform(-1, 1, size=(16, 40))
    u2 = rng.uniform(-1, 1, size=(16, 40))
    lin_o, ang_o = _oracle(u1, u2, 0.3, -0.2, 3.5, 0.96)
    lin_j, ang_j = wheel_lag_scan(
        jnp.asarray(u1), jnp.asarray(u2), 0.3, -0.2, TRACK, LIMITS, 3.5, 0.96
    )
    # XLA may reassociate the constant product k*(1-a); tolerance is a few ulp.
    np.testing.assert_allclose(np.asarray(lin_j), lin_o, rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(np.asarray(ang_j), ang_o, rtol=1e-13, atol=1e-14)


def test_matmul_matches_scan(rng):
    u1 = rng.uniform(-1, 1, size=(8, 100))
    u2 = rng.uniform(-1, 1, size=(8, 100))
    for k, a in [(3.5, 0.96), (3.0, 0.92)]:
        lin_s, ang_s = wheel_lag_scan(
            jnp.asarray(u1), jnp.asarray(u2), 0.1, 0.2, TRACK, LIMITS, k, a
        )
        lin_m, ang_m = wheel_lag_matmul(
            jnp.asarray(u1), jnp.asarray(u2), 0.1, 0.2, TRACK, LIMITS, k, a
        )
        np.testing.assert_allclose(np.asarray(lin_m), np.asarray(lin_s), atol=1e-10)
        np.testing.assert_allclose(np.asarray(ang_m), np.asarray(ang_s), atol=1e-10)


def test_matmul_float32_close(rng):
    u1 = rng.uniform(-1, 1, size=(8, 100)).astype(np.float32)
    u2 = rng.uniform(-1, 1, size=(8, 100)).astype(np.float32)
    lin_o, ang_o = _oracle(
        u1.astype(np.float64), u2.astype(np.float64), 0.0, 0.0, 3.5, 0.96
    )
    lin_m, ang_m = wheel_lag_matmul(
        jnp.asarray(u1), jnp.asarray(u2), jnp.float32(0.0), jnp.float32(0.0),
        jnp.float32(TRACK), LIMITS, 3.5, 0.96,
    )
    assert lin_m.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(lin_m), lin_o, atol=5e-5)
    np.testing.assert_allclose(np.asarray(ang_m), ang_o, atol=5e-5)


def test_inverse_diff_drive():
    left, right = inverse_diff_drive(jnp.asarray(1.5), jnp.asarray(0.4), jnp.asarray(TRACK))
    # MPPI_isaac.py:783-784
    assert float(left) == 1.5 - 0.4 * TRACK / 2
    assert float(right) == 1.5 + 0.4 * TRACK / 2


def test_velocity_clamps(rng):
    u1 = np.full((1, 10), 1.0)
    u2 = np.full((1, 10), 1.0)
    lin, ang = wheel_lag_scan(
        jnp.asarray(u1) * 10, jnp.asarray(u2) * 10, 0.0, 0.0, TRACK, LIMITS,
        3.5, 0.96,
    )
    assert np.asarray(lin).max() <= LIMITS.v_max
    assert np.asarray(ang).min() >= LIMITS.w_min
