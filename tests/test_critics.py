"""Critic stack + reduction vs the NumPy oracle."""

import jax.numpy as jnp
import numpy as np

from husky_rover_mppi.compat import warp_oracle as wo
from husky_rover_mppi.mppi import (
    avoid_obstacle_critic,
    avoid_slope_wheels_critic,
    evaluate_trajectories,
    maximise_speed_critic,
    path_follow_critic,
    softmax_weights,
    weighted_update,
)
from husky_rover_mppi.terrain import as_costmap


def _fake_batch(rng, num=16, horizon=40):
    traj = rng.normal(size=(num, horizon, 3)) * 2.0
    traj[..., 2] *= 0.1
    lw = traj + rng.normal(size=traj.shape) * 0.05
    rw = traj - rng.normal(size=traj.shape) * 0.05
    lin = rng.uniform(0.1, 2.0, size=(num, horizon))
    return traj, lw, rw, lin


def test_path_follow_far_and_near(rng):
    traj, *_ = _fake_batch(rng)
    goal_far = np.array([50.0, 40.0])
    goal_near = np.array([1.0, 1.5])
    for goal, x, y in [(goal_far, 0.0, 0.0), (goal_near, 0.5, 0.5)]:
        c = path_follow_critic(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(goal),
            jnp.asarray(traj), jnp.asarray(9.0),
        )
        for t in range(len(traj)):
            co = wo.path_follow_critic(x, y, goal, traj[t], 9.0)
            np.testing.assert_allclose(float(c[t]), co, rtol=1e-12)


def test_slope_wheels(rng):
    _, lw, rw, _ = _fake_batch(rng)
    c = avoid_slope_wheels_critic(jnp.asarray(lw), jnp.asarray(rw))
    for t in range(len(lw)):
        co = wo.avoid_slope_wheels_critic(lw[t], rw[t])
        np.testing.assert_allclose(float(c[t]), co, rtol=1e-12)


def test_obstacle_critic(rng):
    num, horizon, hw, size = 8, 30, 10.0, 64
    cost_img = rng.uniform(0, 1, size=(size, size))
    cm = as_costmap(cost_img, hw, dtype=jnp.float64)
    traj = rng.uniform(-hw + 1, hw - 1, size=(num, horizon, 3))
    c = avoid_obstacle_critic(jnp.asarray(traj), cm)
    res = float(cm.resolution)
    for t in range(num):
        co = wo.avoid_obstacle_critic(traj[t], cost_img, hw, res)
        np.testing.assert_allclose(float(c[t]), co, rtol=1e-12)


def test_speed_critic(rng):
    _, _, _, lin = _fake_batch(rng)
    goal = np.array([30.0, 0.0])
    c = maximise_speed_critic(
        jnp.asarray(0.0), jnp.asarray(0.0), jnp.asarray(goal),
        jnp.asarray(lin), jnp.asarray(2.0),
    )
    for t in range(len(lin)):
        co = wo.maximise_speed_critic(0.0, 0.0, goal, lin[t], 2.0)
        np.testing.assert_allclose(float(c[t]), co, rtol=1e-12)
    # gated off near the goal
    near = maximise_speed_critic(
        jnp.asarray(29.5), jnp.asarray(0.0), jnp.asarray(goal),
        jnp.asarray(lin), jnp.asarray(2.0),
    )
    np.testing.assert_array_equal(np.asarray(near), 0.0)


def test_total_cost_and_weights(rng):
    num, horizon, hw, size = 12, 40, 12.0, 48
    traj, lw, rw, lin = _fake_batch(rng, num, horizon)
    cost_img = rng.uniform(0, 1, size=(size, size)) ** 3
    cm = as_costmap(cost_img, hw, dtype=jnp.float64)
    goal = np.array([25.0, -10.0])

    costs = evaluate_trajectories(
        jnp.asarray(0.0), jnp.asarray(0.0), jnp.asarray(goal),
        jnp.asarray(traj), jnp.asarray(lw), jnp.asarray(rw), jnp.asarray(lin),
        jnp.asarray(2.0), cm, jnp.asarray(9.0),
    )
    costs_o = wo.evaluate_trajectories(
        0.0, 0.0, goal, traj, lw, rw, lin, 2.0, cost_img, hw,
        float(cm.resolution), 9.0,
    )
    np.testing.assert_allclose(np.asarray(costs), costs_o, rtol=1e-12)

    w = softmax_weights(costs, 0.3)
    w_o = wo.softmax_weights(costs_o, 0.3)
    np.testing.assert_allclose(np.asarray(w), w_o, rtol=1e-12)

    u1 = rng.normal(size=(num, horizon))
    u2 = rng.normal(size=(num, horizon))
    o1, o2 = weighted_update(w, jnp.asarray(u1), jnp.asarray(u2))
    o1_o, o2_o = wo.weighted_update(w_o, u1, u2)
    np.testing.assert_allclose(np.asarray(o1), o1_o, atol=1e-12)
    np.testing.assert_allclose(np.asarray(o2), o2_o, atol=1e-12)


def test_goal_angle_critic_reference_semantics():
    """critics_warp.py:4-40: zero beyond 0.5 m of the goal; |atan(dy/dx) -
    goal_orientation| of the last segment inside (atan quirk kept)."""
    import jax.numpy as jnp
    import numpy as np

    from husky_rover_mppi.mppi.critics import goal_angle_critic

    goal = jnp.asarray([0.0, 0.0])
    traj = jnp.asarray(
        [[[-1.0, -1.0, 0.0], [-0.5, -0.5, 0.0], [0.0, 0.0, 0.0]]]
    )
    # far from goal -> 0
    far = goal_angle_critic(jnp.asarray(5.0), jnp.asarray(5.0), goal,
                            jnp.asarray(1.0), traj)
    np.testing.assert_allclose(np.asarray(far), [0.0])
    # near goal: last segment slope atan(0.5/0.5) = pi/4
    near = goal_angle_critic(jnp.asarray(0.1), jnp.asarray(0.1), goal,
                             jnp.asarray(1.0), traj)
    np.testing.assert_allclose(np.asarray(near), [abs(np.arctan(1.0) - 1.0)],
                               rtol=1e-6)


def test_path_orientation_critic_reference_semantics():
    """critics_warp.py:43-82: zero when the last segment points toward the
    goal; -scalar_product / L1(goal offset) when pointing away."""
    import jax.numpy as jnp
    import numpy as np

    from husky_rover_mppi.mppi.critics import (
        path_orientation_critic,
    )

    goal = jnp.asarray([10.0, 0.0])
    toward = jnp.asarray([[[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [1.0, 0.0, 0.0]]])
    away = jnp.asarray([[[1.0, 0.0, 0.0], [0.5, 0.0, 0.0], [0.0, 0.0, 0.0]]])
    x = jnp.asarray(0.0)
    y = jnp.asarray(0.0)
    np.testing.assert_allclose(
        np.asarray(path_orientation_critic(x, y, goal, toward)), [0.0]
    )
    # sp = 10 * (-0.5) = -5 -> penalty 5 / 10 = 0.5
    np.testing.assert_allclose(
        np.asarray(path_orientation_critic(x, y, goal, away)), [0.5]
    )
