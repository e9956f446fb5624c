"""Batched rollouts vs the Warp-semantics oracle (float64 exactness) and the
thesis NumPy reference implementation."""

import jax.numpy as jnp
import numpy as np

from husky_rover_mppi.compat import numpy_oracle as no
from husky_rover_mppi.compat import warp_oracle as wo
from husky_rover_mppi.core import HeightField
from husky_rover_mppi.mppi import rollout_25d, rollout_2d
from husky_rover_mppi.terrain import bump_surface


def _setup(grid=256, half_width=20.0):
    z = np.asarray(
        bump_surface(grid, half_width, no.REFERENCE_BUMPS, dtype=jnp.float64)
    )
    hf = HeightField.create(z, half_width, dtype=jnp.float64)
    return hf, z, half_width


def test_rollout_25d_matches_warp_oracle(rng):
    hf, z, hw = _setup()
    num, horizon = 8, 25
    lin = rng.uniform(0.5, 2.0, size=(num, horizon))
    ang = rng.uniform(-1.0, 1.0, size=(num, horizon))
    pos = np.array([3.0, -4.0])
    heading = np.array([0.6, 0.8, 0.0])

    r = rollout_25d(hf, jnp.asarray(pos), jnp.asarray(heading),
                    jnp.asarray(lin), jnp.asarray(ang), 0.045)

    res = float(hf.resolution)
    for t in range(num):
        traj_o, head_o, lw_o, rw_o = wo.rollout_25d(
            z, -hw, -hw, res, pos, heading, lin[t], ang[t], 0.045
        )
        np.testing.assert_allclose(np.asarray(r.trajectory[t]), traj_o, atol=1e-12)
        np.testing.assert_allclose(np.asarray(r.headings[t]), head_o, atol=1e-12)
        np.testing.assert_allclose(np.asarray(r.left_wheel[t]), lw_o, atol=1e-12)
        np.testing.assert_allclose(np.asarray(r.right_wheel[t]), rw_o, atol=1e-12)


def test_rollout_2d_matches_warp_oracle(rng):
    hf, z, hw = _setup()
    num, horizon = 4, 30
    lin = rng.uniform(0.5, 2.0, size=(num, horizon))
    ang = rng.uniform(-1.0, 1.0, size=(num, horizon))
    pos = np.array([-2.0, 1.0])
    heading = np.array([1.0, 0.5, 0.0])

    traj, headings = rollout_2d(hf, jnp.asarray(pos), jnp.asarray(heading),
                                jnp.asarray(lin), jnp.asarray(ang), 0.045)
    res = float(hf.resolution)
    for t in range(num):
        traj_o, head_o = wo.rollout_2d(z, -hw, -hw, res, pos, heading,
                                       lin[t], ang[t], 0.045)
        np.testing.assert_allclose(np.asarray(traj[t]), traj_o, atol=1e-12)
        np.testing.assert_allclose(np.asarray(headings[t]), head_o, atol=1e-12)


def test_rodrigues_equals_scipy_rotvec(rng):
    """The Warp Rodrigues formula and the thesis reference's scipy
    rotation-vector update are the same math (different fp paths)."""
    from scipy.spatial.transform import Rotation

    for _ in range(50):
        normal = rng.normal(size=3)
        normal /= np.linalg.norm(normal)
        heading = rng.normal(size=3)
        heading /= np.linalg.norm(heading)
        angle = rng.uniform(-0.5, 0.5)
        rod = wo.update_orientation(heading, angle, normal, 1.0)
        sp = Rotation.from_rotvec(angle * normal).apply(heading)
        sp /= np.linalg.norm(sp)
        np.testing.assert_allclose(rod, sp, atol=1e-12)


def test_reference_rollout_bitmatches_thesis_oracle():
    """BASELINE bit-match contract: the thesis-convention JAX rollout equals
    ``python_mppi_projection`` trajectories at fixed inputs (float64)."""
    from husky_rover_mppi.mppi import rollout_25d_reference

    grid, hw = 400, 20.0
    z = np.asarray(bump_surface(grid, hw, no.REFERENCE_BUMPS, dtype=jnp.float64))
    res = 2 * hw / grid
    iterations = 200
    rng_local = np.random.RandomState(42)
    lin = no.generate_velocities(rng_local, iterations, 1.5, 0.1, 1.5, 2.5)
    ang = no.generate_velocities(rng_local, iterations, 0.0, 0.05, -0.4, 0.4)
    traj_ref = no.generate_trajectory_25d(
        6.0, -6.0, [-0.5, 4.0, 0.0], lin, ang, 0.05, iterations, res, z, hw
    )
    assert traj_ref is not None

    traj = rollout_25d_reference(
        jnp.asarray(z), jnp.asarray(hw), jnp.asarray(res),
        jnp.asarray([6.0, -6.0]), jnp.asarray([-0.5, 4.0, 0.0]),
        jnp.asarray(lin)[None], jnp.asarray(ang)[None], 0.05,
    )
    np.testing.assert_allclose(np.asarray(traj[0]), traj_ref, atol=1e-9)


def test_warp_vs_thesis_convention_agreement():
    """The production (Warp-convention) and thesis-convention rollouts follow
    the same dynamics; on a smooth surface they stay within a few grid cells
    over a 6 s horizon (they sample different cells by construction)."""
    from husky_rover_mppi.mppi import rollout_25d_reference

    grid, hw = 400, 20.0
    z = np.asarray(bump_surface(grid, hw, no.REFERENCE_BUMPS, dtype=jnp.float64))
    res = 2 * hw / grid
    iterations = 120
    lin = np.full(iterations, 1.5)
    ang = np.full(iterations, 0.1)
    traj_ref = np.asarray(rollout_25d_reference(
        jnp.asarray(z), jnp.asarray(hw), jnp.asarray(res),
        jnp.asarray([6.0, -6.0]), jnp.asarray([-0.5, 4.0, 0.0]),
        jnp.asarray(lin)[None], jnp.asarray(ang)[None], 0.05,
    )[0])

    hf = HeightField.create(z[::-1].copy(), hw, dtype=jnp.float64)
    r = rollout_25d(hf, jnp.asarray([6.0, -6.0]),
                    jnp.asarray([-0.5, 4.0, 0.0]),
                    jnp.asarray(lin)[None], jnp.asarray(ang)[None], 0.05)
    traj = np.asarray(r.trajectory[0])
    err = np.linalg.norm(traj[:, :2] - traj_ref[:, :2], axis=-1)
    # The conventions sample different cells (the thesis -2 offset), so paths
    # diverge chaotically with horizon; early waypoints must agree closely
    # and the full 6 s horizon stays within a few meters.
    assert err[:40].max() < 0.5, err[:40].max()
    assert err.max() < 5.0, err.max()
