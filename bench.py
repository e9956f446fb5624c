"""Benchmark: MPPI control-loop throughput on one GPU.

Prints ONE JSON line:
  {"metric": "mppi_rollout_steps_per_s", "value": N, "unit": "rollout-steps/s",
   "vs_baseline": N / 3.3e7}

Baseline: the reference Warp GPU controller runs ~3 ms per control loop at
K=1000 x H=100 => ~3.3e7 rollout-steps/s (BASELINE.md row 1).

Each control-loop number times one jitted ``lax.scan`` of N dependent
control loops (noise generated on device, robot state advanced kinematically
— the reference's ``run()`` loop semantics, MPPI_isaac.py:755-806), ended by
``block_until_ready``: the median of several runs, divided by N.

The unit of work is one full MPPI control step (sampling, wheel-lag
conversion, K surface rollouts incl. wheel tracks, critics with costmap
lookups, softmax weighting, optimal-sequence extraction + optimal rollout)
on the regenerated 150 m map + 750-obstacle costmap — the same workload as
the reference's 3 ms loop. Runs only on a GPU.
"""

import json
import os
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from husky_rover_mppi.core import HeightField
from husky_rover_mppi.mppi import (
    ControllerState,
    MPPIConfig,
    RobotState,
    mppi_step,
    sample_noise,
)
from husky_rover_mppi.mppi.controller import kinematic_advance, select_engine
from husky_rover_mppi.terrain import (
    STANDALONE_CRATER_BUMPS,
    costmap_750,
    crater_surface,
)
from husky_rover_mppi.utils import enable_compile_cache

BASELINE_ROLLOUT_STEPS_PER_S = 3.3e7
DTYPE = jnp.float32


def build_world():
    hw = 75.0
    z = crater_surface(1500, hw, STANDALONE_CRATER_BUMPS, dtype=DTYPE)
    hf = HeightField.create(z, hw, dtype=DTYPE)
    cm = costmap_750(half_width=hw, size=750, use_exact_edt=True)
    cm = cm._replace(cost=cm.cost.astype(DTYPE),
                     half_width=cm.half_width.astype(DTYPE),
                     resolution=cm.resolution.astype(DTYPE))
    return hf, cm


def _median_time(fn, reps: int = 5) -> float:
    """Median wall time of ``fn()``, which must end in block_until_ready."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def bench_control_loop(hf, cm, config: MPPIConfig, n: int = 32):
    """Seconds per control loop (each = one mppi_step + kinematic advance,
    on-device threefry noise) and rollout-steps/s, from a scan of ``n``
    dependent loops."""
    goal = jnp.asarray([65.0, 60.0], DTYPE)
    robot = RobotState.create(-60.0, -60.0, [1.0, 0.5, 0.0], dtype=DTYPE)
    ctrl = ControllerState.create(config, DTYPE)
    K, H = config.num_samples, config.horizon

    @partial(jax.jit, static_argnums=(0, 3))
    def run(config, carry0, key, n):
        def body(carry, _):
            r, c, k = carry
            k, sub = jax.random.split(k)
            noise = sample_noise(sub, K, H, DTYPE)
            c, out = mppi_step(config, hf, cm, goal, r, c, noise)
            r = kinematic_advance(config, r, out)
            return (r, c, k), None
        (r, c, _), _ = jax.lax.scan(body, carry0 + (key,), None, length=n)
        return r.position[0] + c.optimal_u1[0]

    key = jax.random.key(50)
    jax.block_until_ready(run(config, (robot, ctrl), key, n))  # compile
    per_loop = _median_time(
        lambda: jax.block_until_ready(run(config, (robot, ctrl), key, n))) / n
    return per_loop, K * H / per_loop


def bench_vec_env(hf, num_rovers=4096):
    """BASELINE config 2: N Husky instances in lockstep (skid-steer dynamics
    + surface riding) under one jit on one card."""
    from husky_rover_mppi.env import RoverParams, RoverState
    from husky_rover_mppi.env import rover_sim

    params = RoverParams()
    key = jax.random.key(0)
    pos = jax.random.uniform(key, (num_rovers, 2), DTYPE, -50.0, 50.0)
    state0 = RoverState.create(pos, [1.0, 0.0, 0.0], hf)
    cmd = jnp.full((num_rovers,), 1.5, DTYPE)

    @partial(jax.jit, static_argnames=("n_steps",))
    def run(state, n_steps):
        def body(s, _):
            return rover_sim.step(params, hf, s, cmd, cmd), None
        s, _ = jax.lax.scan(body, state, None, length=n_steps)
        return s.position[0, 0] + s.position[-1, 1]

    n = 400
    jax.block_until_ready(run(state0, n))  # compile
    per_step = _median_time(lambda: jax.block_until_ready(run(state0, n))) / n
    return per_step, num_rovers / per_step


def bench_goal_seek(hf, cm, config: MPPIConfig, max_loops=400):
    """End-to-end goal-seek: the full ``lax.while_loop`` episode
    (MPPI_Controller.run semantics) in one dispatch; seconds per executed
    loop."""
    from husky_rover_mppi.mppi import goal_seek

    goal = jnp.asarray([65.0, 60.0], DTYPE)
    robot = RobotState.create(-60.0, -60.0, [1.0, 0.5, 0.0], dtype=DTYPE)
    ctrl = ControllerState.create(config, DTYPE)

    run = jax.jit(lambda r, c, k: goal_seek(
        config, hf, cm, goal, r, c, k, max_loops=max_loops))
    jax.block_until_ready(run(robot, ctrl, jax.random.key(0)))  # compile
    ts, loops = [], 1
    for s in range(3):
        t0 = time.perf_counter()
        res = jax.block_until_ready(run(robot, ctrl, jax.random.key(2 + s)))
        loops = int(res.loops)
        ts.append((time.perf_counter() - t0) / max(loops, 1))
    return float(np.median(ts)), loops


def bench_closed_loop(hf, cm, config: MPPIConfig, n: int = 64):
    """Full-stack closed-loop env rate (3:1 latched/PI loop + rover physics +
    MPPI per sim step, run_episode lax.scan) — the visual_terrain_stack
    equivalent sim-steps/s."""
    from husky_rover_mppi.env import (
        ClosedLoopConfig,
        RoverState,
        init_loop_state,
        run_episode,
    )

    cl = ClosedLoopConfig(mppi=config)
    rng = np.random.default_rng(0)
    starts = rng.uniform(-40, 40, (1, 2))
    goals = jnp.asarray(rng.uniform(-40, 40, (1, 2)), DTYPE)
    rovers = RoverState.create(starts, [1.0, 0.0, 0.0], hf)
    state0 = init_loop_state(cl, rovers)

    @partial(jax.jit, static_argnames=("num_steps",))
    def run(state, key, num_steps):
        s, _ = run_episode(cl, hf, cm, goals, state, key, num_steps=num_steps)
        return s.rovers.position[0, 0]

    key = jax.random.key(10)
    jax.block_until_ready(run(state0, key, n))  # compile
    per_step = _median_time(
        lambda: jax.block_until_ready(run(state0, key, n))) / n
    return per_step, 1.0 / per_step


def bench_largescale(traverse_m: float = 100.0):
    """Streamed-terrain closed loop at the reference demo's scale
    (visual_terrain_stack_full_terrain.py:424-426: 25 m blocks @2.5 cm/px,
    num_blocks=2 => 7000^2-px window, 875^2 costmap @0.2 m): drive a
    >=100 m traverse on chip and report steady-state sim-steps/s + block
    -shift latency. The controller's gather engine is "auto" (the fused
    rollout kernel on the GPU)."""
    from husky_rover_mppi.env.closed_loop import ClosedLoopConfig
    from husky_rover_mppi.env.largescale_loop import (
        LargeScaleClosedLoop,
        LargeScaleLoopConf,
    )
    from husky_rover_mppi.env.rover_sim import RoverParams
    from husky_rover_mppi.terrain.orchestrator import (
        LargeScaleConf,
    )

    conf = LargeScaleLoopConf(
        terrain=LargeScaleConf(),       # shipped reference-scale defaults
        loop=ClosedLoopConfig(
            mppi=MPPIConfig(num_samples=1000, horizon=100),
            rover=RoverParams(),
        ),
        start=(0.0, 0.0),
        goal=(traverse_m, 8.0),
        max_steps=40000,
        # Terrain decisions quantize at the 2 m travel gate and the goal
        # stop box is checked every sim step on device (in-scan masked
        # freeze), so 48-step chunks (~1.6 m at 2 m/s) lose nothing while
        # polling the host a quarter as often as the 12-step default.
        terrain_check_every=48,
    )
    t_build = time.perf_counter()
    loop = LargeScaleClosedLoop(conf)
    jax.block_until_ready(loop.lstm.map_manager.streamer.window)
    t_build = time.perf_counter() - t_build
    res = loop.run(record_path=False)
    shifts = res.shift_latencies_s
    # back-to-back chunk dispatches with one final block = device rate; the
    # wall rate above additionally pays the per-chunk host readback and
    # terrain bookkeeping
    device_rate = loop.measure_device_rate(chunks=20)
    return {
        "window_px": loop.lstm.map_manager.streamer.conf.window_px,
        "resolution_m": loop.lstm.map_manager.streamer.conf.resolution,
        "costmap_px": conf.costmap_size,
        "build_s": round(t_build, 1),
        "build_phases_s": getattr(loop.lstm, "build_phase_acc", {}),
        "reached": bool(res.reached),
        "distance_m": round(res.distance_m, 1),
        "sim_steps": res.steps,
        "block_shifts": res.block_shifts,
        "wall_s": round(res.wall_s, 1),
        # steady-state rate (post-warmup): first-iteration compiles
        # dominate total wall otherwise
        "sim_steps_per_s": round(
            res.steady_steps / res.steady_wall_s, 1)
        if res.steady_wall_s > 0 else
        round(res.steps / max(res.wall_s, 1e-9), 1),
        "shift_latency_ms_mean": round(
            1e3 * float(np.mean(shifts)), 1) if shifts else None,
        "shift_latency_ms_max": round(
            1e3 * float(np.max(shifts)), 1) if shifts else None,
        "prestage_hits": res.prestage_hits,
        "prestage_misses": res.prestage_misses,
        "staged_window_swaps":
            loop.lstm.map_manager.streamer.staged_shift_hits,
        "shift_phases": loop.shift_phase_log,
        "host_phase_totals_s": {k: round(v, 1)
                                for k, v in loop.chunk_phase_acc.items()},
        "cascade_phase_totals_s": {
            k: (round(v, 1) if isinstance(v, float) else v)
            for k, v in loop.lstm.cascade_phase_acc.items()},
        "chunk_steps": conf.terrain_check_every,
        # device-compute rate with no per-chunk host readback
        "device_sim_steps_per_s": round(device_rate, 1),
        "gather_engine": select_engine(conf.loop.mppi),
    }


def main():
    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found "
                         f"{jax.default_backend()!r}")
    enable_compile_cache()
    hf, cm = build_world()

    def cfg(K, H, engine):
        return MPPIConfig(num_samples=K, horizon=H, exact=False,
                          gather_engine=engine, patch_size=256,
                          costmap_patch_size=128)

    # Reference workload: K=1000, H=100 (config.yaml), all engines;
    # "pallas" is the fused rollout kernel.
    loop_direct, sps_direct = bench_control_loop(hf, cm, cfg(1000, 100, "direct"))
    loop_onehot, sps_onehot = bench_control_loop(hf, cm, cfg(1000, 100, "onehot"))
    loop_pallas, sps_pallas = bench_control_loop(hf, cm, cfg(1000, 100, "pallas"))
    # Large batched config (BASELINE config 1): 16k x 64.
    loop_big, sps_big = bench_control_loop(hf, cm, cfg(16384, 64, "pallas"))
    # Same batch under the thesis-statistics (body-slope) critic: the fused
    # kernel skips the two wheel-track lookups
    import dataclasses as _dc

    loop_big_body, sps_big_body = bench_control_loop(
        hf, cm, _dc.replace(cfg(16384, 64, "pallas"), slope_critic="body"))

    env_dt, env_steps_per_s = bench_vec_env(hf)
    gs_cfg = cfg(1000, 100, "pallas")
    gs_loop_s, gs_loops = bench_goal_seek(hf, cm, gs_cfg)
    cl_dt, cl_steps_per_s = bench_closed_loop(hf, cm, gs_cfg)

    best_loop = min(loop_direct, loop_onehot, loop_pallas)
    best = 1000 * 100 / best_loop
    dev = jax.devices()[0]
    result = {
        "metric": "mppi_rollout_steps_per_s",
        "value": round(max(best, sps_big), 1),
        "unit": "rollout-steps/s",
        "vs_baseline": round(max(best, sps_big) / BASELINE_ROLLOUT_STEPS_PER_S, 4),
        "detail": {
            "methodology": "median wall time of scanned dependent control loops, block_until_ready",
            "k1000_h100_direct_loop_ms": round(loop_direct * 1e3, 4),
            "k1000_h100_onehot_loop_ms": round(loop_onehot * 1e3, 4),
            "k1000_h100_pallas_loop_ms": round(loop_pallas * 1e3, 4),
            "k1000_h100_steps_per_s": round(best, 1),
            "k1000_h100_vs_ref_3ms": round(3e-3 / best_loop, 2),
            "k16384_h64_pallas_loop_ms": round(loop_big * 1e3, 4),
            "k16384_h64_steps_per_s": round(sps_big, 1),
            "k16384_h64_body_critic_loop_ms": round(loop_big_body * 1e3, 4),
            "k16384_h64_body_critic_steps_per_s": round(sps_big_body, 1),
            "vec_env_4096_step_us": round(env_dt * 1e6, 2),
            "vec_env_rover_steps_per_s": round(env_steps_per_s, 1),
            "goal_seek_loop_ms": round(gs_loop_s * 1e3, 4),
            "goal_seek_loops": gs_loops,
            "closed_loop_step_ms": round(cl_dt * 1e3, 4),
            "closed_loop_steps_per_s": round(cl_steps_per_s, 1),
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
            "largescale_streamed": bench_largescale(),
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
