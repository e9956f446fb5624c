"""Sharded MPPI step on a virtual 8-device CPU mesh vs the single-device path."""

import jax
import jax.numpy as jnp
import numpy as np

from husky_rover_mppi.core import HeightField
from husky_rover_mppi.mppi import (
    ControllerState,
    MPPIConfig,
    RobotState,
    mppi_step,
)
from husky_rover_mppi.parallel import (
    make_mesh,
    shard_samples,
    sharded_mppi_step,
)
from husky_rover_mppi.terrain import as_costmap, crater_surface


def test_eight_virtual_devices():
    assert jax.device_count() >= 8


def test_sharded_step_matches_single_device():
    dtype = jnp.float64
    hw = 25.0
    z = crater_surface(128, hw, [((-5.0, 8.0), 1.5, 8.0)], dtype=dtype)
    hf = HeightField.create(z, hw, dtype=dtype)
    rng = np.random.default_rng(11)
    cm = as_costmap(rng.uniform(0, 0.9, (16, 16)) ** 4, hw, dtype=dtype)

    config = MPPIConfig(num_samples=64, horizon=20, exact=True)
    goal = jnp.asarray([10.0, 9.0], dtype)
    robot = RobotState.create(-9.0, -7.0, [1.0, 0.3, 0.0], dtype=dtype)
    ctrl = ControllerState.create(config, dtype)
    noise = jnp.asarray(rng.normal(size=(2, 64, 20)))

    ctrl_ref, out_ref = mppi_step(config, hf, cm, goal, robot, ctrl, noise)

    mesh = make_mesh((8,), ("sample",))
    noise_sharded = shard_samples(mesh, noise)
    ctrl_sh, out_sh = sharded_mppi_step(
        config, mesh, hf, cm, goal, robot, ctrl, noise_sharded
    )

    np.testing.assert_allclose(
        np.asarray(out_sh.costs), np.asarray(out_ref.costs), rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(out_sh.weights), np.asarray(out_ref.weights), rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(ctrl_sh.optimal_u1), np.asarray(ctrl_ref.optimal_u1), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(ctrl_sh.optimal_u2), np.asarray(ctrl_ref.optimal_u2), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(out_sh.optimal_trajectory),
        np.asarray(out_ref.optimal_trajectory),
        atol=1e-10,
    )


def test_sharded_step_matches_nondefault_config():
    """The sharded step must follow EVERY config axis the single-device
    step does — sigma_base, slope_critic, projection, return_rollouts —
    not just the defaults (parity contract of sharded_mppi_step)."""
    dtype = jnp.float64
    hw = 25.0
    z = crater_surface(128, hw, [((-5.0, 8.0), 1.5, 8.0)], dtype=dtype)
    hf = HeightField.create(z, hw, dtype=dtype)
    rng = np.random.default_rng(23)
    cm = as_costmap(rng.uniform(0, 0.9, (16, 16)) ** 4, hw, dtype=dtype)
    goal = jnp.asarray([10.0, 9.0], dtype)
    robot = RobotState.create(-9.0, -7.0, [1.0, 0.3, 0.0], dtype=dtype)
    mesh = make_mesh((8,), ("sample",))

    for kwargs in (
        dict(sigma_base=0.3, slope_critic="body", return_rollouts=True),
        dict(projection="2d"),
    ):
        config = MPPIConfig(num_samples=64, horizon=20, exact=True, **kwargs)
        ctrl = ControllerState.create(config, dtype)
        noise = jnp.asarray(rng.normal(size=(2, 64, 20)))
        ctrl_ref, out_ref = mppi_step(config, hf, cm, goal, robot, ctrl, noise)
        ctrl_sh, out_sh = sharded_mppi_step(
            config, mesh, hf, cm, goal, robot, ctrl,
            shard_samples(mesh, noise))
        np.testing.assert_allclose(
            np.asarray(out_sh.costs), np.asarray(out_ref.costs), rtol=1e-12)
        # sigma adaptation uses config.sigma_base on both paths
        np.testing.assert_allclose(
            np.asarray(ctrl_sh.std_u1), np.asarray(ctrl_ref.std_u1),
            atol=1e-12)
        if config.return_rollouts:
            np.testing.assert_allclose(
                np.asarray(out_sh.rollouts), np.asarray(out_ref.rollouts),
                atol=1e-10)
        else:
            assert out_sh.rollouts is None
