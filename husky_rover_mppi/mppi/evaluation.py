"""Offline controller evaluation: re-scoring logged runs through the critics.

Re-derivation of ``thesis_master/warp_implementation/evaluate_trajectory.py``
(:11-150) and the statistics of ``stats_results.py`` / ``compare_3d_2d.py``:
logged trajectories are re-scored with the critic stack (one trajectory at a
time, the reference's dim=1 launches), collisions counted against the
costmap, and run populations compared with trimmed means.
"""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from . import critics as crit
from .critics import Costmap


@dataclasses.dataclass
class TrajectoryLog:
    """One logged run (the reference's CSV schema: step id, XYZ, velocity,
    start, goal — trajectories_data.csv writers in MPPI_OO_current.py)."""

    step: int
    trajectory: np.ndarray          # (T, 3)
    linear_velocities: np.ndarray   # (T,)
    start: tuple
    goal: tuple


def save_trajectory_csv(path, logs):
    """CSV writer mirroring the reference schema."""
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        for log in logs:
            for i, p in enumerate(log.trajectory):
                w.writerow([
                    log.step, p[0], p[1], p[2], log.linear_velocities[i],
                    list(log.start), list(log.goal),
                ])


def load_trajectory_csv(path) -> list[TrajectoryLog]:
    import ast

    runs: dict[int, dict] = {}
    with open(path) as fh:
        for row in csv.reader(fh):
            if not row:
                continue
            step = int(float(row[0]))
            entry = runs.setdefault(step, {"pts": [], "v": [], "start": None,
                                           "goal": None})
            entry["pts"].append([float(row[1]), float(row[2]), float(row[3])])
            entry["v"].append(float(row[4]))
            entry["start"] = tuple(ast.literal_eval(row[5]))
            entry["goal"] = tuple(ast.literal_eval(row[6]))
    return [
        TrajectoryLog(step, np.array(e["pts"]), np.array(e["v"]), e["start"],
                      e["goal"])
        for step, e in sorted(runs.items())
    ]


def rescore_trajectory(
    log: TrajectoryLog, costmap: Costmap, target_speed: float = 2.0,
    horizon_m: float = 9.0, weights: crit.CriticWeights = crit.CriticWeights(),
) -> dict:
    """Critic re-scoring of one logged run (compute_cost,
    evaluate_trajectory.py:11-40): each critic evaluated on the whole
    trajectory with the start position as the robot pose. The wheel-slope
    critic degrades to the body-slope critic (wheel tracks are not logged —
    same fallback the reference uses offline)."""
    traj = jnp.asarray(log.trajectory)
    x, y = log.start
    goal = jnp.asarray(log.goal)
    pf = crit.path_follow_critic(
        jnp.asarray(x), jnp.asarray(y), goal, traj, jnp.asarray(horizon_m)
    )
    slope = crit.avoid_slope_critic(traj)
    speed = crit.maximise_speed_critic(
        jnp.asarray(x), jnp.asarray(y), goal,
        jnp.asarray(log.linear_velocities), jnp.asarray(target_speed),
    )
    obstacle = crit.avoid_obstacle_critic(traj, costmap)
    return {
        "distance": float(pf),
        "slope": float(slope),
        "speed": float(speed),
        "obstacle": float(obstacle),
        "total": float(
            weights.path_follow * pf + weights.slope_wheels * slope
            + weights.speed * speed + weights.obstacle * obstacle
        ),
    }


def count_collisions(log: TrajectoryLog, costmap: Costmap,
                     threshold: float = 0.99) -> int:
    """Waypoints inside collision cells (evaluate_trajectory.py:104-110).

    Uses the ONLINE critic's cell mapping (:func:`..mppi.critics
    .costmap_cells` + the same gather semantics) so offline collision
    verdicts can never disagree with the cells the controller penalized."""
    traj = jnp.asarray(log.trajectory)
    ix, iy = crit.costmap_cells(traj, costmap)
    cells = costmap.cost[iy, ix]
    return int(jnp.sum(cells > threshold))


def trimmed_mean(values, trim_fraction: float = 0.1) -> float:
    """Symmetric trimmed mean (the stats_results.py aggregation)."""
    v = np.sort(np.asarray(values, float))
    k = int(len(v) * trim_fraction)
    core = v[k: len(v) - k] if len(v) > 2 * k else v
    return float(core.mean())


def compare_populations(scores_a, scores_b, trim_fraction: float = 0.1) -> dict:
    """Per-critic trimmed-mean comparison of two run populations (the
    compare_3d_2d.py 2D-vs-3D tables)."""
    keys = scores_a[0].keys()
    out = {}
    for key in keys:
        a = trimmed_mean([s[key] for s in scores_a], trim_fraction)
        b = trimmed_mean([s[key] for s in scores_b], trim_fraction)
        out[key] = {
            "a": a, "b": b,
            "improvement_pct": 100.0 * (a - b) / a if a else 0.0,
        }
    return out


# -- the thesis's statistics protocol ----------------------------------------
#
# stats_results.py:8-80 / evaluate_trajectory.py:58-150: the *driven* path
# (one waypoint per control loop) is re-scored post-hoc, one critic at a
# time, with the "for stats" kernel variants (critics_warp.py:245-265
# commented block); runs are excluded (and counted) when they fail to reach
# the goal within 3500 loops or when any waypoint lands in a collision
# cell (the stats obstacle critic returns 1e8 for the whole path); the
# population aggregate drops the 5 greatest values per arm.


def path_length(trajectory: np.ndarray, stride: int = 5) -> float:
    """Driven path length over every ``stride``-th waypoint — the thesis's
    "distance critic" for the stats tables (compute_length,
    evaluate_trajectory.py:42-53; the ~157 m figures of
    stats_results.py:8-20 are path lengths, not goal-distance scores)."""
    pts = np.asarray(trajectory, float)[::stride]
    if len(pts) < 2:
        return 0.0
    return float(np.linalg.norm(np.diff(pts, axis=0), axis=1).sum())


def thesis_rescore(log: TrajectoryLog, costmap: Costmap,
                   target_speed: float = 2.0) -> dict:
    """Per-critic raw scores of one driven path under the thesis's stats
    protocol (evaluate_trajectory.py:93-110 with the "for stats" obstacle
    variant, critics_warp.py:256-265):

    * ``distance``: path length (:func:`path_length`);
    * ``speed``: sum (v_max - v)/(v + 1e-4) over the logged per-loop
      commanded velocities (critics_warp.py:269-300, far-goal pose keeps
      it enabled for the whole path);
    * ``slope``: body-slope critic over strided waypoint pairs of the whole
      path (the offline kernel has no wheel tracks — critics_warp _avoid_slope);
    * ``obstacle``: bucketed near-miss costs (+1 / +100 / +1e4 / +1e6 for
      cells in (0.65,0.75)/(0.75,0.85)/(0.85,0.95)/>0.95);
    * ``collided``: any waypoint cell > 0.99 (the stats kernel returns 1e8
      for the whole path -> the run is excluded and counted,
      evaluate_trajectory.py:104-110).

    The first waypoint (the start position) is dropped, like the
    reference's ``trajectories = trajectories[1:]``.
    """
    traj = np.asarray(log.trajectory, float)[1:]
    vels = np.asarray(log.linear_velocities, float)[1:]
    if len(traj) < 4:
        return {"distance": 0.0, "speed": 0.0, "slope": 0.0,
                "obstacle": 0.0, "collided": False}
    speed = float(np.sum((target_speed - vels) / (vels + 1e-4)))

    # body-slope critic over the driven path (critics_warp.py:130-166)
    slope = float(jnp.sum(crit.avoid_slope_critic(jnp.asarray(traj))))

    # costmap cells under every waypoint (truncated indexing,
    # critics_warp.py:245-248)
    half_w = float(costmap.half_width)
    res = float(costmap.resolution)
    size = costmap.size
    ix = np.trunc((traj[:, 0] + half_w) / res).astype(int)
    iy = np.trunc((-traj[:, 1] + half_w) / res).astype(int)
    cells = np.asarray(costmap.cost)[
        np.clip(iy, 0, size - 1), np.clip(ix, 0, size - 1)
    ]
    collided = bool((cells > 0.99).any())
    obstacle = float(
        np.sum((cells > 0.65) & (cells < 0.75)) * 1.0
        + np.sum((cells > 0.75) & (cells < 0.85)) * 100.0
        + np.sum((cells > 0.85) & (cells < 0.95)) * 1e4
        + np.sum(cells > 0.95) * 1e6
    )
    return {
        # same first-waypoint-dropped population as every other critic
        "distance": path_length(traj),
        "speed": speed,
        "slope": slope,
        "obstacle": obstacle,
        "collided": collided,
    }


def trim_greatest(values, n: int = 5) -> list:
    """Drop the ``n`` greatest values (the reference removes heapq.nlargest
    elements before averaging, evaluate_trajectory.py:178-196; exactly n
    dropped here instead of all value-equal duplicates)."""
    v = sorted(float(x) for x in values)
    return v[: max(len(v) - n, 1)] if len(v) > n else v


def run_2d_vs_3d_experiment(
    ks=(350, 500, 1000),
    runs_per_arm: int = 8,
    horizon: int = 100,
    max_loops: int = 1500,
    half_width: float = 75.0,
    grid_size: int = 1500,
    costmap_size: int = 750,
    seed: int = 42,
    trim_fraction: float = 0.1,
    dtype=None,
    gather_engine: str = "auto",
    span_fraction: float = 0.8,
) -> dict:
    """The thesis's 2D-vs-3D projection experiment
    (compare_3d_2d.py / stats_results.py:8-80): for each K in ``ks`` run
    ``runs_per_arm`` goal-seek episodes on the regenerated 150 m map +
    750-obstacle costmap with the 3D (surface-riding) and 2D (planar)
    projection, record realized trajectories on device, re-score them
    through the critic stack, count collisions, and emit the per-K
    trimmed-mean comparison table.

    Start/goal pairs are drawn per run from corner-to-corner bands like the
    thesis's ~200 m traverses; both arms share identical pairs and RNG keys
    so the comparison is paired.
    """
    import functools

    import jax

    from ..core.heightfield import HeightField
    from ..terrain import STANDALONE_CRATER_BUMPS, costmap_750, crater_surface
    from .controller import (
        ControllerState,
        MPPIConfig,
        RobotState,
        goal_seek_recorded,
    )

    dtype = dtype or jnp.float32
    z = crater_surface(grid_size, half_width, STANDALONE_CRATER_BUMPS,
                       dtype=dtype)
    hf = HeightField.create(z, half_width, dtype=dtype)
    cm = costmap_750(half_width=half_width, size=costmap_size,
                     use_exact_edt=True)
    cm = cm._replace(cost=cm.cost.astype(dtype),
                     half_width=cm.half_width.astype(dtype),
                     resolution=cm.resolution.astype(dtype))

    rng = np.random.default_rng(seed)
    lim = span_fraction * half_width
    pairs = []
    for _ in range(runs_per_arm):
        start = np.array([-lim, 0.0]) + rng.uniform(-0.15, 0.15, 2) * half_width
        goal = np.array([lim, 0.0]) + rng.uniform(-0.15, 0.15, 2) * half_width
        pairs.append((start, goal))

    table: dict = {"config": {"ks": list(ks), "runs_per_arm": runs_per_arm,
                              "horizon": horizon, "max_loops": max_loops},
                   "per_k": {}}
    import sys
    import time as _time

    # re-scoring is tiny host math; pin it to the CPU backend so per-episode
    # eager ops never round-trip through the accelerator
    cpu = jax.devices("cpu")[0]
    cm_host = jax.device_put(cm, cpu)

    for k in ks:
        arm_scores = {"3d": [], "2d": []}
        arm_collisions = {"3d": 0, "2d": 0}
        arm_reached = {"3d": 0, "2d": 0}
        for proj in ("3d", "2d"):
            config = MPPIConfig(num_samples=int(k), horizon=horizon,
                                projection=proj, gather_engine=gather_engine)
            runner = jax.jit(functools.partial(
                goal_seek_recorded, config, hf, cm,
                max_loops=max_loops,
            ))
            t_arm = _time.time()
            for run_idx, (start, goal) in enumerate(pairs):
                robot = RobotState.create(
                    start[0], start[1], [1.0, 0.0, 0.0], dtype=dtype
                )
                ctrl = ControllerState.create(config, dtype)
                trace = runner(
                    jnp.asarray(goal, dtype), robot, ctrl,
                    jax.random.key(seed * 1000 + run_idx),
                )
                loops = int(trace.loops)
                log = TrajectoryLog(
                    step=run_idx,
                    trajectory=np.asarray(trace.positions)[:max(loops, 2)],
                    linear_velocities=np.asarray(trace.velocities)[:max(loops, 2)],
                    start=tuple(start),
                    goal=tuple(goal),
                )
                with jax.default_device(cpu):
                    # re-score against the SAME horizon the controller
                    # optimized, not rescore_trajectory's 9 m default
                    arm_scores[proj].append(rescore_trajectory(
                        log, cm_host, horizon_m=float(config.horizon_m)))
                    arm_collisions[proj] += count_collisions(log, cm_host)
                arm_reached[proj] += int(trace.reached)
            print(f"[eval] K={k} {proj}: {len(pairs)} runs in "
                  f"{_time.time() - t_arm:.0f}s, reached={arm_reached[proj]}",
                  file=sys.stderr, flush=True)
        table["per_k"][int(k)] = {
            "trimmed_means": compare_populations(
                arm_scores["2d"], arm_scores["3d"], trim_fraction
            ),  # a = 2D, b = 3D; improvement_pct > 0 means 3D is better
            "collisions": dict(arm_collisions),
            "reached": dict(arm_reached),
        }
    return table


def run_thesis_protocol_experiment(
    ks=(350, 500, 1000),
    runs_per_arm: int = 64,
    horizon: int = 100,
    max_loops: int = 3500,
    half_width: float = 75.0,
    seed: int = 42,
    slope_weight: float = 35.5,
    sigma_base: float = 0.3,
    gather_engine: str = "auto",
    terrain_seed: int = 42,
    slope_critic: str = "body",
    terrain_z_scale: float = 1.0,
    dtype=None,
) -> dict:
    """The thesis's 2D-vs-3D statistics experiment under the thesis's OWN
    protocol — everything the episode-total
    EVAL.json recipe did differently is restored to the reference's form:

    * terrain statistically matched to the thesis map: 150 x 150 m at
      0.1 m/px, craters 1/5 m^2 (:func:`terrain.thesis_statistics_terrain`),
      with the regenerated 750-obstacle costmap (MPPI_OO_current.py:722-726);
    * paired start/goal bands: x in U(-70,-55) -> U(55,70) with
      y in U(-50,50), axis alternating per run, random heading
      (MPPI_OO_current.py:756-768); both arms share start/goal/heading/keys;
    * thesis initialization: optimal inputs = ones, wheel speeds = 1 m/s
      (MPPI_OO_current.py:367/374), adaptive-sigma base 0.3 (:684-685) —
      no zero-velocity startup spike feeding the hyperbolic speed critic;
    * the stats critic weights: slope weight 35.5 (the "reduced slope
      avoidance" condition where the thesis found its 3-5% 3D gains,
      critics_warp.py:325 annotation + work summarise:58-60);
    * 3500-loop cap, 0.5 m stop box (MPPI_OO_current.py:670);
    * per-critic rescoring of the driven path with the stats kernel
      variants, collision-abort, drop-5-greatest aggregation
      (:func:`thesis_rescore` / :func:`trim_greatest`).

    Collided and unreached runs are excluded from the per-critic means and
    counted, exactly like evaluate_trajectory.py:80-110.
    """
    import functools
    import sys
    import time as _time

    import jax

    from ..core.heightfield import HeightField
    from ..terrain import costmap_750, thesis_statistics_terrain
    from .controller import (
        ControllerState,
        MPPIConfig,
        RobotState,
        goal_seek_recorded,
    )

    dtype = dtype or jnp.float32
    z = thesis_statistics_terrain(seed=terrain_seed, size_m=2 * half_width,
                                  z_scale=terrain_z_scale,
                                  max_elevation=1.2 * terrain_z_scale,
                                  min_elevation=-1.2 * terrain_z_scale)
    hf = HeightField.create(jnp.asarray(z, dtype), half_width, dtype=dtype)
    # 0.1 m/px costmap — the reference protocol's grid (grid_size=1500 at
    # half_width 75, MPPI_OO_current.py:743 / stats_results.py). Collision
    # detection (>0.99 cells) and near-miss buckets quantize at this
    # resolution; a coarser grid is not protocol-comparable (ADVICE r04).
    cm = costmap_750(half_width=half_width,
                     size=int(round(2 * half_width / 0.1)),
                     use_exact_edt=True)
    cm = cm._replace(cost=cm.cost.astype(dtype),
                     half_width=cm.half_width.astype(dtype),
                     resolution=cm.resolution.astype(dtype))

    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(runs_per_arm):
        lo, hi = 55.0, min(70.0, half_width - 2.0)
        a = rng.uniform(lo, hi)
        b = rng.uniform(lo, hi)
        off_s = rng.uniform(-50.0, 50.0)
        off_g = rng.uniform(-50.0, 50.0)
        hr = rng.uniform(0.0, 1.0), rng.uniform(-1.0, 1.0)
        if i % 2 == 0:  # x-axis traverse (MPPI_OO_current.py:756-761)
            start, goal = (-a, off_s), (b, off_g)
            heading = [hr[0], hr[1], 0.0]
        else:           # y-axis traverse (:763-768)
            start, goal = (off_s, -a), (off_g, b)
            heading = [hr[1], hr[0], 0.0]
        pairs.append((np.asarray(start), np.asarray(goal), heading))

    weights = crit.CriticWeights(slope_wheels=slope_weight)
    cpu = jax.devices("cpu")[0]
    cm_host = jax.device_put(cm, cpu)

    table: dict = {
        "config": {
            "ks": list(ks), "runs_per_arm": runs_per_arm,
            "horizon": horizon, "max_loops": max_loops,
            "slope_weight": slope_weight, "sigma_base": sigma_base,
            "slope_critic": slope_critic,
            "terrain_z_scale": terrain_z_scale,
            "terrain": "thesis_statistics_terrain(150m@0.1m, craters 1/5m^2)",
            "protocol": "per-path rescore, collision-abort, drop-5-greatest",
        },
        "per_k": {},
    }
    for k in ks:
        per_arm: dict = {}
        for proj in ("3d", "2d"):
            config = MPPIConfig(
                num_samples=int(k), horizon=horizon, projection=proj,
                gather_engine=gather_engine, critic_weights=weights,
                sigma_base=sigma_base, slope_critic=slope_critic,
            )
            runner = jax.jit(functools.partial(
                goal_seek_recorded, config, hf, cm, max_loops=max_loops,
            ))
            scores, n_fail, n_collide = [], 0, 0
            loops_list, v_means, v_stalls = [], [], []
            t_arm = _time.time()
            for run_idx, (start, goal, heading) in enumerate(pairs):
                robot = RobotState.create(
                    start[0], start[1], heading, dtype=dtype, wheel_speed=1.0
                )
                ctrl = ControllerState.create(config, dtype, initial_u=1.0)
                trace = runner(
                    jnp.asarray(goal, dtype), robot, ctrl,
                    jax.random.key(seed * 1000 + run_idx),
                )
                loops = int(trace.loops)
                reached = bool(trace.reached)
                pts = np.asarray(trace.positions)[:max(loops, 2)]
                vels_arr = np.asarray(trace.velocities)[:max(loops, 2)]
                # The reference CSVs log the start pose as row 0 and the
                # rescorer drops it (trajectories[1:]); the trace buffer
                # records only driven waypoints, so prepend the start row
                # to keep thesis_rescore's [1:] from eating a real one.
                pts = np.vstack([[start[0], start[1], pts[0, 2]], pts])
                vels_arr = np.concatenate([vels_arr[:1], vels_arr])
                log = TrajectoryLog(
                    step=run_idx,
                    trajectory=pts,
                    linear_velocities=vels_arr,
                    start=tuple(start), goal=tuple(goal),
                )
                loops_list.append(loops)
                v = log.linear_velocities
                v_means.append(float(v.mean()) if len(v) else 0.0)
                v_stalls.append(float((v < 0.1).mean()) if len(v) else 0.0)
                if not reached:
                    n_fail += 1          # evaluate_trajectory.py:80-87
                    continue
                score = thesis_rescore(log, cm_host)
                if score.pop("collided"):
                    n_collide += 1       # :104-110 (1e8 -> excluded)
                    continue
                scores.append(score)
            per_arm[proj] = {
                "scores": scores,
                "failed": n_fail,
                "collided": n_collide,
                "completed": len(scores),
                "mean_loops": float(np.mean(loops_list)),
                "mean_velocity": float(np.mean(v_means)),
                "stall_fraction": float(np.mean(v_stalls)),
            }
            print(f"[thesis-eval] K={k} {proj}: {len(pairs)} runs in "
                  f"{_time.time() - t_arm:.0f}s, completed="
                  f"{len(scores)}, collided={n_collide}, failed={n_fail}",
                  file=sys.stderr, flush=True)
        entry: dict = {"arms": {
            p: {kk: vv for kk, vv in per_arm[p].items() if kk != "scores"}
            for p in per_arm
        }, "critics": {}}
        for critic in ("distance", "speed", "slope", "obstacle"):
            row = {}
            for p in ("2d", "3d"):
                vals = [s[critic] for s in per_arm[p]["scores"]]
                row[p] = float(np.mean(trim_greatest(vals))) if vals else None
            if row["2d"] is not None and row["3d"]:
                # stats_results.py convention: positive = 3D better.
                # `is not None` for the numerator: a legitimate 0.0 trimmed
                # mean (clean obstacle arm) must not drop the headline row.
                row["beaten_by_pct"] = 100.0 * (row["2d"] - row["3d"]) / row["3d"]
            entry["critics"][critic] = row
        table["per_k"][int(k)] = entry
    return table
