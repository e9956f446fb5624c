"""Full MPPI control step vs an end-to-end composition of the NumPy oracle,
plus a goal-seek smoke run."""

import jax
import jax.numpy as jnp
import numpy as np

from husky_rover_mppi.compat import warp_oracle as wo
from husky_rover_mppi.core import HeightField
from husky_rover_mppi.dynamics import DiffDriveLimits
from husky_rover_mppi.mppi import (
    ControllerState,
    InputLimits,
    MPPIConfig,
    RobotState,
    goal_seek,
    kinematic_advance,
    mppi_step,
)
from husky_rover_mppi.terrain import (
    STANDALONE_CRATER_BUMPS,
    as_costmap,
    bump_surface,
    crater_surface,
)


def _small_world(dtype=jnp.float64, grid=200, hw=25.0):
    rng = np.random.default_rng(7)
    z = np.asarray(crater_surface(grid, hw, [
        ((-5.0, 8.0), 2.0, 6.0), ((10.0, -6.0), 3.0, 8.0),
    ], dtype=dtype))
    hf = HeightField.create(z, hw, dtype=dtype)
    cm_img = rng.uniform(0, 0.9, size=(grid // 8, grid // 8)).astype(np.float64) ** 4
    cm = as_costmap(cm_img, hw, dtype=dtype)
    return hf, cm, z, hw, cm_img


def test_mppi_step_matches_oracle(rng):
    hf, cm, z, hw, cm_img = _small_world()
    config = MPPIConfig(num_samples=24, horizon=30, exact=True)
    goal = jnp.asarray([15.0, 12.0], jnp.float64)
    robot = RobotState.create(-10.0, -8.0, [1.0, 0.4, 0.0], dtype=jnp.float64)
    ctrl = ControllerState.create(config, jnp.float64)
    noise = jnp.asarray(rng.normal(size=(2, 24, 30)))

    new_ctrl, out = mppi_step(config, hf, cm, goal, robot, ctrl, noise)
    ref = wo.mppi_step(config, z, hw, cm_img, float(cm.resolution), goal,
                       robot, ctrl, noise)

    np.testing.assert_allclose(np.asarray(out.costs), ref["costs"], rtol=1e-12)
    np.testing.assert_allclose(np.asarray(out.weights), ref["weights"], rtol=1e-11)
    np.testing.assert_allclose(np.asarray(new_ctrl.optimal_u1), ref["opt_u1"], atol=1e-12)
    np.testing.assert_allclose(np.asarray(new_ctrl.optimal_u2), ref["opt_u2"], atol=1e-12)
    np.testing.assert_allclose(np.asarray(out.optimal_linear), ref["opt_lin"], atol=1e-12)
    np.testing.assert_allclose(np.asarray(out.optimal_angular), ref["opt_ang"], atol=1e-12)
    np.testing.assert_allclose(np.asarray(out.optimal_trajectory), ref["opt_traj"], atol=1e-10)
    np.testing.assert_allclose(np.asarray(out.optimal_headings), ref["opt_head"], atol=1e-10)

    # adaptive stds (MPPI_isaac.py:777-778)
    ang0 = ref["opt_ang"][0]
    assert float(new_ctrl.std_u1) == max(0.4, 0.4 - ang0 * ang0)
    assert float(new_ctrl.std_u2) == max(0.4, 0.4 + ang0 * ang0)


def test_second_step_receding_horizon(rng):
    """The next loop perturbs the shifted previous optimal sequence."""
    hf, cm, z, hw, cm_img = _small_world()
    config = MPPIConfig(num_samples=8, horizon=12, exact=True)
    goal = jnp.asarray([15.0, 12.0], jnp.float64)
    robot = RobotState.create(-10.0, -8.0, [1.0, 0.4, 0.0], dtype=jnp.float64)
    ctrl = ControllerState.create(config, jnp.float64)
    noise = jnp.asarray(rng.normal(size=(2, 8, 12)))
    ctrl, out = mppi_step(config, hf, cm, goal, robot, ctrl, noise)
    robot = kinematic_advance(config, robot, out)
    ctrl2, out2 = mppi_step(config, hf, cm, goal, robot, ctrl,
                            jnp.zeros((2, 8, 12)))
    # with zero noise every sample equals the shifted optimal sequence
    u_expected = np.concatenate([np.asarray(ctrl.optimal_u1)[1:],
                                 np.asarray(ctrl.optimal_u1)[-1:]])
    w = np.asarray(out2.weights)
    np.testing.assert_allclose(w, w[0], rtol=1e-9)  # identical samples
    np.testing.assert_allclose(np.asarray(ctrl2.optimal_u1),
                               np.clip(u_expected, -1, 1), atol=1e-12)


def test_kinematic_advance_semantics(rng):
    hf, cm, z, hw, cm_img = _small_world()
    config = MPPIConfig(num_samples=8, horizon=12, exact=True)
    goal = jnp.asarray([15.0, 12.0], jnp.float64)
    robot = RobotState.create(-10.0, -8.0, [1.0, 0.4, 0.0], dtype=jnp.float64)
    ctrl = ControllerState.create(config, jnp.float64)
    noise = jnp.asarray(rng.normal(size=(2, 8, 12)))
    _, out = mppi_step(config, hf, cm, goal, robot, ctrl, noise)
    new_robot = kinematic_advance(config, robot, out)
    np.testing.assert_array_equal(
        np.asarray(new_robot.position), np.asarray(out.optimal_trajectory)[0, :2]
    )
    lin0, ang0 = float(out.linear_velocity), float(out.angular_velocity)
    assert float(new_robot.left_wheel_speed) == lin0 - ang0 * config.robot_radius / 2
    assert float(new_robot.right_wheel_speed) == lin0 + ang0 * config.robot_radius / 2


def test_goal_seek_reaches_goal():
    """Standalone goal-seeking loop on a smooth crater surface (the
    MPPI_Controller.run semantics) terminates inside the 0.5 m box.

    World scale mirrors the reference setup (~0.2 m/px DEM; the slope
    critic's nearest-cell wheel lookups need fine resolution, as in the
    0.1 m/px 150 m standalone map)."""
    dtype = jnp.float32
    hw = 25.0
    z = crater_surface(256, hw, [((-12.0, 14.0), 1.5, 8.0)], dtype=dtype)
    hf = HeightField.create(z, hw, dtype=dtype)
    cm = as_costmap(np.zeros((32, 32), np.float32), hw, dtype=dtype)
    config = MPPIConfig(num_samples=256, horizon=50, exact=False)
    goal = jnp.asarray([4.0, 3.0], dtype)
    robot = RobotState.create(-8.0, -6.0, [1.0, 0.2, 0.0], dtype=dtype)
    ctrl = ControllerState.create(config, dtype)
    res = goal_seek(config, hf, cm, goal, robot, ctrl,
                    jax.random.key(0), max_loops=900)
    assert bool(res.reached), (np.asarray(res.robot.position), int(res.loops))
    assert int(res.loops) < 900
