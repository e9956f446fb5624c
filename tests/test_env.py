"""Vectorized rover environment + closed-loop semantics."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np

from husky_rover_mppi.core import HeightField
from husky_rover_mppi.env import (
    BlockFrame,
    ClosedLoopConfig,
    RoverParams,
    RoverState,
    closed_loop_step,
    controller_to_world,
    goal_distances,
    heading_world_to_controller,
    init_loop_state,
    path_metrics,
    rebase_on_shift,
    run_episode,
    success_mask,
    teleport,
    world_to_controller,
)
from husky_rover_mppi.env import rover_sim
from husky_rover_mppi.mppi import MPPIConfig
from husky_rover_mppi.terrain import as_costmap, crater_surface


def _world(dtype=jnp.float32, grid=256, hw=25.0):
    z = crater_surface(grid, hw, [((-12.0, 14.0), 1.5, 8.0)], dtype=dtype)
    hf = HeightField.create(z, hw, dtype=dtype)
    cm = as_costmap(np.zeros((32, 32), np.float32), hw, dtype=dtype)
    return hf, cm, hw


def test_rover_sim_straight_line():
    hf, cm, hw = _world()
    n = 4
    state = RoverState.create(
        np.tile([[-5.0, -5.0]], (n, 1)), [1.0, 0.0, 0.0], hf
    )
    params = RoverParams(wheel_tau=0.02)
    cmd = jnp.full((n,), 1.0)
    step = jax.jit(lambda s: rover_sim.step(params, hf, s, cmd, cmd))
    for _ in range(120):  # 2 s
        state = step(state)
    pos = np.asarray(state.position)
    # equal wheel speeds -> straight +x travel ~ 2 m (minus spin-up)
    assert np.all(pos[:, 0] > -3.6)
    assert np.allclose(pos[:, 1], -5.0, atol=0.05)
    assert np.allclose(np.asarray(state.yaw_rate), 0.0, atol=1e-4)
    # wheel speeds converged to the command
    assert np.allclose(np.asarray(state.wheel_left), 1.0, atol=1e-3)


def test_rover_sim_turns_left():
    hf, cm, hw = _world()
    state = RoverState.create(np.array([[0.0, 0.0]]), [1.0, 0.0, 0.0], hf)
    params = RoverParams(wheel_tau=0.02)
    step = jax.jit(
        lambda s: rover_sim.step(
            params, hf, s, jnp.asarray([0.5]), jnp.asarray([1.5])
        )
    )
    for _ in range(60):
        state = step(state)
    # right wheel faster -> positive yaw rate -> heading rotates toward +y
    assert float(state.yaw_rate[0]) > 0.5
    assert float(state.heading[0, 1]) > 0.2


def test_wheel_contact_forces_flat_ground_is_quarter_weight():
    """On flat ground the per-wheel load model reduces exactly to the old
    m*g/4 constant (deformation_engine.py:666-680 regression input)."""
    hw = 20.0
    z = jnp.zeros((64, 64))
    hf = HeightField.create(z, hw)
    state = RoverState.create(np.array([[0.0, 0.0]]), [1.0, 0.0, 0.0], hf)
    params = RoverParams()
    loads = np.asarray(
        rover_sim.wheel_contact_forces(params, hf, state, wheelbase=0.512)
    )
    expect = params.mass * params.gravity / 4.0
    np.testing.assert_allclose(loads, expect, rtol=1e-5)


def test_wheel_contact_forces_side_slope_loads_downhill_wheels():
    """Driving along a side slope (+x heading on a surface rising with +y)
    shifts load to the downhill (right, -y) wheels — the measured-contact
    asymmetry the constant-force model missed."""
    hw = 20.0
    n = 64
    ys = jnp.linspace(-hw, hw, n)
    z = jnp.broadcast_to(0.3 * ys[None, :], (n, n))  # rises with +y (col=y)
    # HeightField layout: Z[j, i] with i=x col... use create + probe to get
    # the orientation: left axis (+y) uphill => right wheels downhill
    hf = HeightField.create(z.T, hw)
    state = RoverState.create(np.array([[0.0, 0.0]]), [1.0, 0.0, 0.0], hf)
    params = RoverParams()
    loads = np.asarray(
        rover_sim.wheel_contact_forces(params, hf, state, wheelbase=0.512)
    )[0]
    fl, fr, rl, rr = loads
    # verify the probe surface really tilts along y (guard the fixture)
    normal = np.asarray(
        rover_sim.hfield.normal_at(hf, jnp.asarray([0.0]), jnp.asarray([0.0]))
    )[0]
    assert abs(normal[1]) > 0.05, f"fixture not a side slope: {normal}"
    uphill_pair = (fl + rl) if normal[1] < 0 else (fr + rr)
    downhill_pair = (fr + rr) if normal[1] < 0 else (fl + rl)
    assert downhill_pair > uphill_pair * 1.1, loads
    # front/rear symmetric when heading is along the contour line
    np.testing.assert_allclose(fl, rl, rtol=1e-4)
    np.testing.assert_allclose(fr, rr, rtol=1e-4)
    # total vertical support stays m g n_z
    np.testing.assert_allclose(
        loads.sum(), params.mass * params.gravity * normal[2], rtol=1e-4
    )


def test_deform_window_asymmetric_sink_on_side_slope():
    """End-to-end: per-wheel measured loads produce deeper sink under the
    downhill track than the uphill one (the asymmetry a constant mass*g/4
    cannot produce)."""
    from husky_rover_mppi.physics import (
        DeformationEngine,
        DeformationEngineConf,
    )

    eng = DeformationEngine(DeformationEngineConf(terrain_resolution=0.05))
    window = jnp.zeros((200, 200))
    counts = jnp.zeros((200, 200), jnp.int32)
    track = 1.2
    body = np.array([5.0, 5.0])
    left = np.array([0.0, 1.0])
    positions = np.stack([
        body + left * track / 2, body - left * track / 2,
        body + left * track / 2 - [0.5, 0.0],
        body - left * track / 2 - [0.5, 0.0],
    ])
    loads = np.array([60.0, 120.0, 60.0, 120.0])  # right wheels downhill
    w2, _ = eng.deform_window(
        window, counts, 0.05, (0.0, 0.0), positions, np.zeros(4), loads
    )
    # depth under right (low-load-axis -y) track vs left track
    sink = np.asarray(w2 - window)
    col_left = int((5.0 + track / 2) / 0.05)
    col_right = int((5.0 - track / 2) / 0.05)
    left_sink = sink[:, col_left - 3: col_left + 4].min()
    right_sink = sink[:, col_right - 3: col_right + 4].min()
    assert right_sink < left_sink < 0.0, (left_sink, right_sink)


def test_teleport_resets_wheels():
    hf, cm, hw = _world()
    state = RoverState.create(np.zeros((3, 2)), [1.0, 0.0, 0.0], hf)
    state = state._replace(wheel_left=jnp.ones(3), wheel_right=jnp.ones(3))
    state = teleport(state, hf, 1, jnp.asarray([3.0, 4.0]), jnp.asarray([0.0, 1.0, 0.0]))
    assert np.allclose(np.asarray(state.position[1]), [3.0, 4.0])
    assert float(state.wheel_left[1]) == 0.0
    assert float(state.wheel_left[0]) == 1.0


def test_closed_loop_multi_rover_progress():
    """N rovers with individual goals all make progress under the latched
    PI-trimmed closed loop."""
    hf, cm, hw = _world()
    n = 4
    starts = np.array([[-8.0, -6.0], [-6.0, 6.0], [6.0, -8.0], [8.0, 6.0]])
    goals = jnp.asarray(-0.6 * starts, jnp.float32)
    config = ClosedLoopConfig(
        mppi=MPPIConfig(num_samples=128, horizon=40, exact=False),
        rover=RoverParams(wheel_tau=0.03),
    )
    rovers = RoverState.create(starts, [1.0, 0.0, 0.0], hf)
    state = init_loop_state(config, rovers)
    state, path = run_episode(
        config, hf, cm, goals, state, jax.random.key(0), num_steps=240
    )
    d0 = np.linalg.norm(starts - np.asarray(goals), axis=-1)
    d1 = np.asarray(goal_distances(state.rovers.position, goals))
    assert np.all(d1 < d0 - 1.0), (d0, d1)
    assert path.shape == (240, n, 2)


def test_latch_and_pi_semantics():
    """Commands only change on latch steps; the PI integrator resets there."""
    hf, cm, hw = _world()
    config = ClosedLoopConfig(
        mppi=MPPIConfig(num_samples=16, horizon=10, exact=False),
    )
    rovers = RoverState.create(np.array([[0.0, 0.0]]), [1.0, 0.0, 0.0], hf)
    state = init_loop_state(config, rovers)
    goals = jnp.asarray([[5.0, 0.0]], jnp.float32)
    step = jax.jit(lambda s, k: closed_loop_step(config, hf, cm, goals, s, k))
    key = jax.random.key(1)
    latched = []
    for i in range(7):
        key, sub = jax.random.split(key)
        state = step(state, sub)
        latched.append(float(state.latched_left[0]))
    # latches at steps 0, 3, 6 -> values constant inside each window
    assert latched[0] == latched[1] == latched[2]
    assert latched[3] == latched[4] == latched[5]


def test_frames_roundtrip_and_rebase(rng):
    frame = BlockFrame(
        jnp.asarray(50.0), jnp.asarray(-25.0), jnp.asarray(12.5)
    )
    xy = rng.uniform(-100, 100, size=(32, 2))
    cx, cy = world_to_controller(frame, jnp.asarray(xy[:, 0]), jnp.asarray(xy[:, 1]))
    x2, y2 = controller_to_world(frame, cx, cy)
    np.testing.assert_allclose(np.asarray(x2), xy[:, 0], atol=1e-12)
    np.testing.assert_allclose(np.asarray(y2), xy[:, 1], atol=1e-12)

    # a world shift (dx, dy) rebases ctrl points by (-dy, +dx): consistency
    # with the transform under a moved frame
    dx, dy = 25.0, -25.0
    frame2 = BlockFrame(frame.block_x + dx, frame.block_y + dy, frame.half_block)
    pts = jnp.stack([cx, cy], axis=-1)
    rebased = rebase_on_shift(pts, jnp.asarray(dx), jnp.asarray(dy))
    cx2, cy2 = world_to_controller(frame2, jnp.asarray(xy[:, 0]), jnp.asarray(xy[:, 1]))
    np.testing.assert_allclose(np.asarray(rebased[:, 0]), np.asarray(cx2), atol=1e-12)
    np.testing.assert_allclose(np.asarray(rebased[:, 1]), np.asarray(cy2), atol=1e-12)

    h = heading_world_to_controller(jnp.asarray([0.6, 0.8, 0.0]))
    np.testing.assert_allclose(np.asarray(h), [0.8, -0.6, 0.0])


def test_path_metrics_against_numpy_reference(rng):
    """path_metrics mirrors compute_path_metrics (MPPI_isaac.py:231-256)."""
    traj = rng.normal(size=(200, 3)).cumsum(axis=0) * 0.1

    total_length = 0.0
    up = down = dist_up = 0.0
    k = 20
    for i in range(1, len(traj) - k, k):
        seg = traj[i + k] - traj[i - 1]
        L = np.linalg.norm(seg)
        total_length += L
        if L > 0:
            a = np.degrees(np.arctan2(seg[2], np.linalg.norm(seg[:2])))
            if a > 0:
                up += a
            else:
                down += abs(a)
        if seg[2] > 0:
            dist_up += seg[2]

    m = path_metrics(jnp.asarray(traj))
    np.testing.assert_allclose(float(m["total_length"]), total_length, rtol=1e-6)
    np.testing.assert_allclose(float(m["total_angle_up"]), up, rtol=1e-6)
    np.testing.assert_allclose(float(m["total_angle_down"]), down, rtol=1e-6)
    np.testing.assert_allclose(float(m["total_distance_up"]), dist_up, rtol=1e-6)


def test_success_mask_box():
    pos = jnp.asarray([[0.4, -0.4], [0.6, 0.0], [0.0, 0.0]])
    goals = jnp.zeros((3, 2))
    np.testing.assert_array_equal(
        np.asarray(success_mask(pos, goals)), [True, False, True]
    )


def test_ema_quat_matches_reference_formula():
    # Scalar NumPy mirror of EMAquat (visual_terrain_stack_full_terrain.py:14-26).
    import math

    def ref(q1, q2, alpha):
        dot = sum(a * b for a, b in zip(q1, q2))
        a2 = -alpha if dot < 0 else alpha
        q = [q1[i] * (1 - a2) + q2[i] * a2 for i in range(4)]
        s = math.sqrt(sum(v * v for v in q))
        return [v / s for v in q]

    from husky_rover_mppi.env import ema_quat

    rng = np.random.default_rng(3)
    for _ in range(20):
        q1 = rng.normal(size=4)
        q1 /= np.linalg.norm(q1)
        q2 = rng.normal(size=4)
        q2 /= np.linalg.norm(q2)
        alpha = float(rng.uniform(0, 1))
        got = np.asarray(ema_quat(jnp.asarray(q1), jnp.asarray(q2), alpha))
        assert np.allclose(got, ref(list(q1), list(q2), alpha), atol=1e-12)
    # hemisphere flip: EMA of q and -q stays at q
    q = np.array([0.0, 0.0, 0.0, 1.0])
    out = np.asarray(ema_quat(jnp.asarray(q), jnp.asarray(-q), 0.3))
    assert np.allclose(out, q)


def test_teleport_dtype_mixed_state_no_upcast():
    # Regression: per-field dtypes survive teleport even when some fields were
    # replaced with float64 arrays under jax_enable_x64.
    hf, cm, hw = _world()
    state = RoverState.create(np.zeros((3, 2)), [1.0, 0.0, 0.0], hf)
    state = state._replace(wheel_left=jnp.ones(3, jnp.float64))
    with warnings.catch_warnings():
        warnings.simplefilter("error", FutureWarning)
        out = teleport(state, hf, 2, jnp.asarray([1.0, 2.0]),
                       jnp.asarray([0.0, 1.0, 0.0]))
    assert out.wheel_left.dtype == jnp.float64
    assert out.yaw_rate.dtype == state.yaw_rate.dtype
    assert float(out.wheel_left[2]) == 0.0
