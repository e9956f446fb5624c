"""Tests for the host simulation shell: robot manager, pub/sub bus, rate
throttle, thread monitor, simulation manager loop."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from husky_rover_mppi.core import HeightField
from husky_rover_mppi.env import (
    RobotManager,
    RoverParams,
    contact_forces,
    rover_sim,
)
from husky_rover_mppi.shell import (
    MessageBus,
    Rate,
    SimulationManager,
    SimulationManagerConf,
    ThreadMonitor,
    Topics,
)
from husky_rover_mppi.terrain import as_costmap, crater_surface


def _world(grid=64, hw=10.0):
    z = crater_surface(grid, hw, [((2.0, -3.0), 1.5, 3.0)], dtype=jnp.float32)
    hf = HeightField.create(z, hw, dtype=jnp.float32)
    cm = as_costmap(np.zeros((grid // 8, grid // 8), np.float32), hw)
    return hf, cm


# -- RobotManager ----------------------------------------------------------


def test_robot_manager_spawn_defers_until_applied():
    hf, _ = _world()
    rm = RobotManager(max_robots=3)
    rm.spawn("husky_0", (1.0, 2.0))
    state = rm.initial_state(hf)
    rm.teleport("husky_0", (-4.0, -4.0))
    assert rm.pending == 2
    # Nothing applied yet: state still at initial spawn pose.
    np.testing.assert_allclose(np.asarray(state.position[0]), [1.0, 2.0])
    state = rm.apply_modifications(state, hf)
    assert rm.pending == 0
    np.testing.assert_allclose(np.asarray(state.position[0]), [-4.0, -4.0])


def test_robot_manager_capacity_and_duplicate():
    rm = RobotManager(max_robots=1)
    rm.spawn("a", (0.0, 0.0))
    with pytest.raises(ValueError):
        rm.spawn("a", (0.0, 0.0))
    with pytest.raises(RuntimeError):
        rm.spawn("b", (0.0, 0.0))


def test_robot_manager_reset_restores_spawn_pose():
    hf, _ = _world()
    rm = RobotManager(max_robots=2)
    rm.spawn("r0", (3.0, 3.0))
    rm.spawn("r1", (-3.0, -3.0))
    state = rm.initial_state(hf)
    rm.teleport("r0", (5.0, 5.0))
    state = rm.apply_modifications(state, hf)
    rm.reset_all()
    state = rm.apply_modifications(state, hf)
    np.testing.assert_allclose(np.asarray(state.position[0]), [3.0, 3.0])
    np.testing.assert_allclose(np.asarray(state.position[1]), [-3.0, -3.0])
    # teleport zeroes wheel state (robot.py:316-329 semantics)
    assert float(state.wheel_left[0]) == 0.0


def test_contact_forces_weight_on_flat_ground():
    hw = 10.0
    z = jnp.zeros((64, 64), jnp.float32)
    hf = HeightField.create(z, hw, dtype=jnp.float32)
    params = RoverParams()
    state = rover_sim.RoverState.create(
        np.zeros((2, 2)), [1.0, 0.0, 0.0], hf
    )
    f = np.asarray(contact_forces(params, hf, state))
    # Flat ground: pure vertical support = m * g.
    np.testing.assert_allclose(f[:, 2], params.mass * params.gravity, rtol=1e-6)
    np.testing.assert_allclose(f[:, :2], 0.0, atol=1e-6)


def test_external_wrench_accelerates_body():
    hf, _ = _world()
    params = RoverParams()
    state = rover_sim.RoverState.create(np.zeros((1, 2)), [1.0, 0.0, 0.0], hf)
    zero_cmd = jnp.zeros((1,), jnp.float32)
    pushed = rover_sim.step(
        params, hf, state, zero_cmd, zero_cmd,
        ext_force=jnp.asarray([[500.0, 0.0, 0.0]], jnp.float32),
        ext_torque=jnp.asarray([2.0], jnp.float32),
    )
    still = rover_sim.step(params, hf, state, zero_cmd, zero_cmd)
    assert float(pushed.position[0, 0]) > float(still.position[0, 0])
    assert float(pushed.yaw_rate[0]) > float(still.yaw_rate[0])


# -- MessageBus ------------------------------------------------------------


def test_bus_publish_subscribe_and_latch():
    bus = MessageBus()
    got = []
    assert bus.publish("/t", 1) == 0
    bus.subscribe("/t", got.append)
    assert bus.publish("/t", 2) == 1
    bus.publish("/latched", "hello", latch=True)
    late = []
    bus.subscribe("/latched", late.append)
    assert late == ["hello"]
    assert got == [2]


# -- Rate ------------------------------------------------------------------


def test_rate_paces_and_counts_overruns():
    t = {"now": 0.0}
    slept = []

    def clock():
        return t["now"]

    def sleeper(s):
        slept.append(s)
        t["now"] += s

    r = Rate(10.0, clock=clock, sleeper=sleeper)  # period 0.1
    t["now"] += 0.03  # fast tick
    assert r.sleep() == pytest.approx(0.07)
    t["now"] += 0.25  # slow tick: overrun
    assert r.sleep() < 0
    assert r.overruns == 1


# -- ThreadMonitor ---------------------------------------------------------


def test_monitor_fires_shutdowns_once_when_sim_dies():
    alive = {"ok": True}
    fired = []
    mon = ThreadMonitor(poll_s=0.02, sim_alive=lambda: alive["ok"])
    mon.register_shutdown(lambda: fired.append(1))
    mon.start()
    assert mon.is_alive
    alive["ok"] = False
    deadline = time.time() + 2.0
    while mon.is_alive and time.time() < deadline:
        time.sleep(0.01)
    assert not mon.is_alive
    mon.fire()  # idempotent
    mon.stop()
    assert fired == [1]


# -- SimulationManager -----------------------------------------------------


def test_simulation_manager_runs_and_applies_bus_requests():
    hf, cm = _world()
    rm = RobotManager(max_robots=2)
    rm.spawn("husky_0", (-6.0, -6.0))
    conf = SimulationManagerConf()
    sm = SimulationManager(
        conf, hf, cm, rm, goals=np.array([[6.0, 6.0], [0.0, 0.0]])
    )
    try:
        sm.run_simulation(6)
        assert sm.step_count == 6
        pos0 = np.asarray(sm.state.rovers.position[0])
        # rover drove away from spawn toward the goal
        assert np.linalg.norm(pos0 - [-6.0, -6.0]) > 1e-3
        # a teleport request over the bus is applied between steps
        sm.bus.publish(
            Topics.ROBOT_TELEPORT, {"name": "husky_0", "position": (5.0, 5.0)}
        )
        sm.step()
        np.testing.assert_allclose(
            np.asarray(sm.state.rovers.position[0]), [5.0, 5.0], atol=1e-5
        )
        # pose telemetry published each tick
        seen = []
        sm.bus.subscribe(Topics.POSE_STATE, seen.append)
        sm.step()
        assert len(seen) == 1 and seen[0]["positions"].shape == (2, 2)
    finally:
        sm.close()
