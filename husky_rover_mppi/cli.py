"""CLI entry point — the ``run.py`` equivalent.

Usage (Hydra-style overrides, run.py:76-87 / wiki/modes/Modes.md):

    python run.py mode=standalone mppi.num_samples=1000 goal.x=45 goal.y=40
    python run.py mode=closed_loop num_rovers=16 steps=600
    python run.py mode=sdg sdg.num_images=10

Modes:
    standalone  — MPPI goal-seek on the regenerated 150 m map + 750-obstacle
                  costmap (the thesis standalone experiment).
    closed_loop — N rovers under the latched/PI full-stack loop.
    sdg         — synthetic-data generation: randomized moonyard terrains
                  rendered through the labeling pipeline.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np


def _world_cfg(tree) -> dict:
    """World section of the composed tree: the environment group YAMLs nest
    it under ``environment.world``; flat ``world.*`` CLI overrides (and trees
    loaded from an env file directly) merge on top."""
    env = tree.get("environment", {})
    base = dict(env.get("world", {})) if isinstance(env, dict) else {}
    base.update(tree.get("world", {}) or {})
    return base


def _rover_params(tree):
    """RoverParams from the physics config group (cfg/physics/*.yaml
    ``rover:`` + top-level ``dt``/``gravity`` — the reference's
    default_physics.yaml -> RoverParams wiring)."""
    from .env.rover_sim import RoverParams

    phys = tree.get("physics", {})
    if not isinstance(phys, dict):
        return RoverParams()
    kw = {k: v for k, v in (phys.get("rover") or {}).items()
          if k in RoverParams._fields}
    if "dt" in phys and "physics_dt" not in kw:
        kw["physics_dt"] = float(phys["dt"])
    grav = phys.get("gravity")
    if isinstance(grav, (list, tuple)) and len(grav) == 3 and \
            "gravity" not in kw:
        kw["gravity"] = abs(float(grav[2]))
    return RoverParams(**kw)


def _moonyard_dem(moonyard: dict, grid: int):
    """Small-scale env family (lunalab / lunaryard): generate the DEM with the
    procedural moonyard stack instead of the thesis crater surface."""
    import numpy as np

    from .terrain.craters import CraterSamplerConf
    from .terrain.smallscale import (
        BaseTerrainGeneratorConf,
        MoonyardConf,
        MoonyardGenerator,
    )

    base = BaseTerrainGeneratorConf(**(moonyard.get("base") or {}))
    ck = {k: (tuple(tuple(r) for r in v) if k == "radius_ranges"
              else tuple(v) if k == "densities" else v)
          for k, v in (moonyard.get("crater") or {}).items()}
    conf = MoonyardConf(
        base=base,
        crater=CraterSamplerConf(**ck),
        is_lab=bool(moonyard.get("is_lab", False)),
        is_yard=bool(moonyard.get("is_yard", True)),
        z_scale=float(moonyard.get("z_scale", 1.0)),
    )
    dem = np.asarray(MoonyardGenerator(conf).randomize())
    # The heightfield window is square: crop/pad the (y, x) DEM to grid^2.
    out = np.zeros((grid, grid), dem.dtype)
    sy, sx = min(grid, dem.shape[0]), min(grid, dem.shape[1])
    out[:sy, :sx] = dem[:sy, :sx]
    return out


def _build_standalone_world(cfg, dtype, moonyard=None):
    import jax.numpy as jnp

    from .core import HeightField
    from .terrain import STANDALONE_CRATER_BUMPS, costmap_750, crater_surface

    hw = float(cfg.get("half_width", 75.0))
    grid = int(cfg.get("grid_size", 1500))
    if moonyard:
        z = jnp.asarray(_moonyard_dem(moonyard, grid), dtype)
    else:
        z = crater_surface(grid, hw, STANDALONE_CRATER_BUMPS, dtype=dtype)
    hf = HeightField.create(z, hw, dtype=dtype)
    size = int(cfg.get("costmap_size", 750))
    if moonyard:
        # No thesis obstacle field in the small-scale labs/yards: obstacle
        # cost comes from scattered rocks when configured, else free space.
        import numpy as np

        from .terrain import as_costmap

        cm = as_costmap(np.zeros((size, size), np.float32), hw, dtype=dtype)
    else:
        cm = costmap_750(half_width=hw, size=size, use_exact_edt=True)
    cm = cm._replace(cost=cm.cost.astype(dtype),
                     half_width=cm.half_width.astype(dtype),
                     resolution=cm.resolution.astype(dtype))
    return hf, cm, hw


def run_standalone(tree) -> dict:
    import jax
    import jax.numpy as jnp

    from .mppi import ControllerState, MPPIConfig, RobotState
    from .mppi.controller import goal_seek_recorded
    from .mppi.critics import costmap_cells
    from .utils import ScopedTimer

    dtype = jnp.float32
    mppi_cfg = tree.get("mppi")
    if not isinstance(mppi_cfg, MPPIConfig):
        mppi_cfg = MPPIConfig(**(mppi_cfg or {}))
    env = tree.get("environment", {})
    moonyard = env.get("moonyard") if isinstance(env, dict) else None
    hf, cm, hw = _build_standalone_world(_world_cfg(tree), dtype, moonyard)
    start = tree.get("start", {"x": -60.0, "y": -60.0})
    goal_d = tree.get("goal", {"x": 65.0, "y": 60.0})
    goal = jnp.asarray([goal_d["x"], goal_d["y"]], dtype)
    robot = RobotState.create(start["x"], start["y"], [1.0, 0.5, 0.0],
                              dtype=dtype)
    ctrl = ControllerState.create(mppi_cfg, dtype)

    with ScopedTimer("goal_seek", active=True) as t:
        res = goal_seek_recorded(
            mppi_cfg, hf, cm, goal, robot, ctrl,
            jax.random.key(int(tree.get("seed", 42))),
            max_loops=int(tree.get("max_loops", 3500)))
        jax.block_until_ready(res.robot.position)
    loops = int(res.loops)
    # highest costmap cell the driven path entered (> 0.99 is a collision
    # cell, critics_warp.py:220-267)
    ix, iy = costmap_cells(res.positions[:loops], cm)
    path_cost = float(jnp.max(cm.cost[iy, ix])) if loops else 0.0
    return {
        "mode": "standalone",
        "reached": bool(res.reached),
        "loops": loops,
        "final_position": np.asarray(res.robot.position).tolist(),
        "max_path_cost": path_cost,
        "wall_s": round(t.elapsed, 2),
    }


def run_closed_loop(tree) -> dict:
    import jax
    import jax.numpy as jnp

    from .env import (
        ClosedLoopConfig,
        RoverState,
        goal_distances,
        init_loop_state,
        run_episode,
    )
    from .mppi import MPPIConfig

    dtype = jnp.float32
    n = int(tree.get("num_rovers", 4))
    steps = int(tree.get("steps", 300))
    cl = tree.get("closed_loop")
    if not isinstance(cl, ClosedLoopConfig):
        mppi_cfg = tree.get("mppi", {"num_samples": 256, "horizon": 50})
        if not isinstance(mppi_cfg, MPPIConfig):
            mppi_cfg = MPPIConfig(**mppi_cfg)
        cl = ClosedLoopConfig(mppi=mppi_cfg, rover=_rover_params(tree))
    env = tree.get("environment", {})
    moonyard = env.get("moonyard") if isinstance(env, dict) else None
    hf, cm, hw = _build_standalone_world(_world_cfg(tree), dtype, moonyard)

    rng = np.random.default_rng(int(tree.get("seed", 42)))
    lim = min(40.0, 0.55 * hw)  # keep spawns + goals well inside the window
    starts = rng.uniform(-lim, lim, (n, 2))
    goals = jnp.asarray(rng.uniform(-lim, lim, (n, 2)), dtype)
    rovers = RoverState.create(starts, [1.0, 0.0, 0.0], hf)
    state = init_loop_state(cl, rovers)
    t0 = time.perf_counter()
    state, path = run_episode(cl, hf, cm, goals, state,
                              jax.random.key(0), num_steps=steps)
    jax.block_until_ready(state.rovers.position)
    wall = time.perf_counter() - t0
    d0 = np.linalg.norm(starts - np.asarray(goals), axis=-1)
    d1 = np.asarray(goal_distances(state.rovers.position, goals))
    return {
        "mode": "closed_loop",
        "num_rovers": n,
        "steps": steps,
        "mean_progress_m": float((d0 - d1).mean()),
        "wall_s": round(wall, 2),
        "sim_steps_per_s": round(steps / wall, 1),
    }


def _render_settings_from_cfg(tree):
    """cfg/rendering group -> RenderSettings, the ``startSim`` parity path
    (src/environments_wrappers/__init__.py:96-135 applies lens flares /
    chromatic aberrations / motion blur from the rendering config before
    the SDG loop runs)."""
    from .aux.render_fx import (
        ChromaticAberrationsConf,
        FlaresConf,
        MotionBlurConf,
        RenderSettings,
        apply_chromatic_aberrations,
        apply_lens_flare,
        apply_motion_blur,
    )

    rend = tree.get("rendering") or {}
    if not isinstance(rend, dict):
        return None
    settings = RenderSettings()
    fl = dict(rend.get("flares") or {})
    ca = dict(rend.get("chromatic_aberration") or {})
    mb = dict(rend.get("motion_blur") or {})
    if "strength" in ca:
        ca["strength"] = tuple(ca["strength"])
    apply_lens_flare(
        FlaresConf(**{k: v for k, v in fl.items()
                      if k in FlaresConf.__dataclass_fields__}), settings)
    apply_chromatic_aberrations(
        ChromaticAberrationsConf(
            **{k: v for k, v in ca.items()
               if k in ChromaticAberrationsConf.__dataclass_fields__}),
        settings)
    apply_motion_blur(
        MotionBlurConf(**{k: v for k, v in mb.items()
                          if k in MotionBlurConf.__dataclass_fields__}),
        settings)
    return settings


def run_sdg(tree) -> dict:
    import jax

    from .aux import AutonomousLabeling, LabelingConf
    from .terrain.smallscale import MoonyardConf, MoonyardGenerator

    import numpy as _np

    sdg = tree.get("sdg", {})
    conf = LabelingConf(**{k: v for k, v in sdg.items()
                           if k in LabelingConf.__dataclass_fields__})
    gen = MoonyardGenerator(MoonyardConf())
    labeler = AutonomousLabeling(conf, _render_settings_from_cfg(tree))
    # Optional robot-mounted perspective pass per frame (the reference's
    # camera render products, auto_label.py:174-230): `sdg.camera: {}`
    # enables it; keys width/height/pitch_deg/mount_height/steps/
    # cast_shadows override the defaults.
    cam_cfg = sdg.get("camera")
    if cam_cfg is True:
        cam_cfg = {}
    elif not isinstance(cam_cfg, dict):
        cam_cfg = None  # false / absent / anything non-mapping disables it
    # Per-frame rock scatter (the reference's lunalab/lunaryard SDG
    # randomizes + labels rocks each capture, auto_label.py +
    # rock_manager): hardcore-Poisson positions on the fresh DEM, labeled
    # in the top-down masks and occluding in the camera pass.
    # `sdg.rocks: false` disables; density/r_min/r_max override.
    rock_cfg = sdg.get("rocks", {})
    if rock_cfg is True:
        rock_cfg = {}
    elif not isinstance(rock_cfg, dict):
        rock_cfg = None
    rng = _np.random.default_rng(int(tree.get("seed", 42)))
    res = gen.conf.base.resolution
    for _ in range(conf.num_images):
        dem = gen.randomize()
        rock_xy = rock_r = None
        if rock_cfg is not None:
            from .terrain.point_process import BoundingBox, hardcore_poisson

            yard = BoundingBox(0.0, gen.conf.base.x_size,
                               0.0, gen.conf.base.y_size)
            rock_xy, rock_r = hardcore_poisson(
                rng, yard,
                (float(rock_cfg.get("density", 0.08)),),
                ((float(rock_cfg.get("r_min", 0.08)),
                  float(rock_cfg.get("r_max", 0.4))),),
            )
        # randomized sun between captures (stellar-driven in the reference)
        az = rng.uniform(0, 2 * _np.pi)
        el = rng.uniform(_np.deg2rad(10), _np.deg2rad(60))
        sun = (float(_np.cos(el) * _np.cos(az)),
               float(_np.cos(el) * _np.sin(az)), float(_np.sin(el)))
        frame_id = labeler.frame  # camera products join this capture's id
        labeler.record(dem, res, sun_direction=sun,
                       rock_xy=rock_xy, rock_radius=rock_r)
        if cam_cfg is not None:
            from .aux.labeling import CameraIntrinsics

            dem_np = _np.asarray(dem)
            h, w = dem_np.shape
            px = rng.uniform(0.15, 0.85) * h * res
            py = rng.uniform(0.15, 0.85) * w * res
            yaw = rng.uniform(0, 2 * _np.pi)
            gz = float(dem_np[int(px / res), int(py / res)])
            intr = CameraIntrinsics(
                width=int(cam_cfg.get("width", CameraIntrinsics.width)),
                height=int(cam_cfg.get("height", CameraIntrinsics.height)))
            labeler.record_camera(
                dem_np, res, (0.0, 0.0), (px, py),
                (float(_np.cos(yaw)), float(_np.sin(yaw))), gz,
                intrinsics=intr, sun_direction=sun,
                rock_xy=rock_xy, rock_radius=rock_r,
                mount_height=float(cam_cfg.get("mount_height", 0.8)),
                pitch_deg=float(cam_cfg.get("pitch_deg", 15.0)),
                steps=int(cam_cfg.get("steps", 128)),
                cast_shadows=bool(cam_cfg.get("cast_shadows", False)),
                frame=frame_id,
            )
    return {
        "mode": "sdg",
        "num_images": conf.num_images,
        "camera": cam_cfg is not None,
        "output_dir": str(labeler.run_dir),
    }


def run_largescale(tree) -> dict:
    """The full-stack streamed-terrain closed loop
    (visual_terrain_stack_full_terrain.py:293-582): MPPI drives a rover
    across procedurally streamed terrain with block-shift window re-seating,
    rocks->costmap refresh and frame rebasing."""
    import dataclasses as _dc

    from .env.largescale_loop import LargeScaleClosedLoop, LargeScaleLoopConf
    from .env.closed_loop import ClosedLoopConfig
    from .mppi import MPPIConfig
    from .physics.deformation import DeformationEngineConf
    from .terrain.orchestrator import LargeScaleConf
    from .terrain.rocks import RockDistConf

    env = tree.get("environment", {})
    ls = dict(env.get("largescale", {}) or tree.get("largescale", {}) or {})
    fields = {f.name for f in _dc.fields(LargeScaleConf)}
    kw = {k: v for k, v in ls.items() if k in fields}
    for key in ("crater_gen_densities",):
        if key in kw:
            kw[key] = tuple(kw[key])
    if "crater_gen_radius" in kw:
        kw["crater_gen_radius"] = tuple(tuple(r) for r in kw["crater_gen_radius"])
    if "rock_gen_cfgs" in kw:
        kw["rock_gen_cfgs"] = tuple(
            c if isinstance(c, RockDistConf) else RockDistConf(**c)
            for c in kw["rock_gen_cfgs"]
        )
    terrain = LargeScaleConf(**kw)

    mppi_cfg = tree.get("mppi")
    if not isinstance(mppi_cfg, MPPIConfig):
        mppi_cfg = MPPIConfig(**(mppi_cfg or {}))
    start = tree.get("start", {"x": 0.0, "y": 0.0})
    goal = tree.get("goal", {"x": 65.0, "y": 65.0})
    deform = None
    if tree.get("deformation", {}).get("enable"):
        deform = DeformationEngineConf(
            terrain_resolution=terrain.hr_dem_resolution
        )
    ck = tree.get("checkpoint", {}) or {}
    conf = LargeScaleLoopConf(
        terrain=terrain,
        loop=ClosedLoopConfig(mppi=mppi_cfg, rover=_rover_params(tree)),
        start=(start["x"], start["y"]),
        goal=(goal["x"], goal["y"]),
        max_steps=int(tree.get("max_steps", 20000)),
        terrain_check_every=int(tree.get("terrain_check_every", 12)),
        seed=int(tree.get("seed", 42)),
        deform=deform,
        checkpoint_path=ck.get("path"),
        checkpoint_every_steps=int(ck.get("every_steps", 0)),
    )
    # `resume: <checkpoint>` continues an interrupted traverse
    # (bit-identical on the synchronous path)
    resume_path = tree.get("resume")
    if resume_path:
        loop, info = LargeScaleClosedLoop.resume(conf, resume_path)
        res = loop.run(_resume=info)
    else:
        loop = LargeScaleClosedLoop(conf)
        res = loop.run()
    lat = res.shift_latencies_s
    return {
        "mode": "largescale",
        "reached": bool(res.reached),
        "steps": res.steps,
        "block_shifts": res.block_shifts,
        "costmap_rebuilds": res.costmap_rebuilds,
        "distance_m": round(res.distance_m, 2),
        "final_position": [round(v, 3) for v in res.final_position],
        "wall_s": round(res.wall_s, 2),
        "sim_steps_per_s": round(res.steps / res.wall_s, 1),
        "shift_latency_ms": {
            "mean": round(1e3 * float(np.mean(lat)), 2) if lat else None,
            "max": round(1e3 * float(np.max(lat)), 2) if lat else None,
        },
        "prestage": {"hits": res.prestage_hits,
                     "misses": res.prestage_misses},
    }


def run_evaluation(tree) -> dict:
    """The thesis's 2D-vs-3D projection experiment sweep
    (compare_3d_2d.py / stats_results.py shape): paired goal-seek runs per
    K, critic re-scoring, trimmed-mean table + collision counts per arm.

    ``evaluation.protocol: thesis`` selects the thesis's own statistics
    protocol (per-path per-critic rescore with collision-abort and
    drop-5-greatest on thesis-matched terrain —
    ``run_thesis_protocol_experiment``); the default ``episode`` protocol
    is the legacy episode-total comparison."""
    from .mppi.evaluation import (
        run_2d_vs_3d_experiment,
        run_thesis_protocol_experiment,
    )

    ev = tree.get("evaluation", {}) or {}
    world = _world_cfg(tree)
    if str(ev.get("protocol", "episode")) == "thesis":
        # Default runs_per_arm follows the protocol function's 64: thesis
        # aggregation drops the 5 greatest values per critic, so fewer than
        # ~16 runs/arm reports "thesis protocol" means from a handful of
        # survivors (ADVICE r04). An explicit config below the trim count
        # is refused rather than silently mislabeled.
        runs_per_arm = int(ev.get("runs_per_arm", 64))
        if runs_per_arm <= 5:
            raise SystemExit(
                "evaluation.runs_per_arm must exceed the thesis protocol's "
                "drop-5-greatest trim (got %d)" % runs_per_arm)
        table = run_thesis_protocol_experiment(
            ks=tuple(ev.get("ks", (350, 500, 1000))),
            runs_per_arm=runs_per_arm,
            horizon=int(ev.get("horizon", 100)),
            max_loops=int(ev.get("max_loops", 3500)),
            half_width=float(world.get("half_width", 75.0)),
            seed=int(tree.get("seed", 42)),
            slope_weight=float(ev.get("slope_weight", 35.5)),
            sigma_base=float(ev.get("sigma_base", 0.3)),
            gather_engine=str(ev.get("gather_engine", "auto")),
            terrain_seed=int(ev.get("terrain_seed", 42)),
            slope_critic=str(ev.get("slope_critic", "body")),
            terrain_z_scale=float(ev.get("terrain_z_scale", 1.0)),
        )
        return {"mode": "evaluation", **table}
    table = run_2d_vs_3d_experiment(
        ks=tuple(ev.get("ks", (350, 500, 1000))),
        runs_per_arm=int(ev.get("runs_per_arm", 8)),
        horizon=int(ev.get("horizon", 100)),
        max_loops=int(ev.get("max_loops", 1500)),
        half_width=float(world.get("half_width", 75.0)),
        grid_size=int(world.get("grid_size", 1500)),
        costmap_size=int(world.get("costmap_size", 750)),
        seed=int(tree.get("seed", 42)),
        gather_engine=str(ev.get("gather_engine", "auto")),
        span_fraction=float(ev.get("span_fraction", 0.8)),
    )
    return {"mode": "evaluation", **table}


MODES = {
    "standalone": run_standalone,
    "closed_loop": run_closed_loop,
    "largescale": run_largescale,
    "evaluation": run_evaluation,
    "sdg": run_sdg,
}


def main(argv=None) -> int:
    from .aux.config import apply_overrides, instantiate_configs, load_config

    argv = list(sys.argv[1:] if argv is None else argv)
    cfg_path = Path(__file__).parent.parent / "cfg" / "config.yaml"
    overrides = []
    for arg in argv:
        if arg.startswith("--config="):
            cfg_path = Path(arg.split("=", 1)[1])
        else:
            overrides.append(arg)
    tree = load_config(cfg_path) if cfg_path.exists() else {}
    # Hydra-style group overrides (`environment=lunalab_norobot`): swap in the
    # named file from the group directory, then apply dotted overrides on top.
    groups = ("environment", "rendering", "physics")
    group_ov = [o for o in overrides if o.split("=", 1)[0] in groups]
    overrides = [o for o in overrides if o not in group_ov]
    for o in group_ov:
        g, name = o.split("=", 1)
        tree[g] = load_config(cfg_path.parent / g / f"{name}.yaml")
    # mode is a config group too (reference cfg/mode/{ROS1,ROS2,SDG}.yaml):
    # `mode=X` merges cfg/mode/X.yaml (losing to later dotted overrides).
    for o in list(overrides):
        if o.startswith("mode="):
            mode_file = cfg_path.parent / "mode" / f"{o.split('=', 1)[1]}.yaml"
            if mode_file.exists():
                for k, v in load_config(mode_file).items():
                    if isinstance(v, dict) and isinstance(tree.get(k), dict):
                        tree[k].update(v)
                    else:
                        tree[k] = v
                overrides.remove(o)
    apply_overrides(tree, overrides)
    tree = instantiate_configs(tree)
    mode = tree.get("mode", "standalone")
    if mode not in MODES:
        print(f"unknown mode {mode!r}; choose from {sorted(MODES)}",
              file=sys.stderr)
        return 2
    result = MODES[mode](tree)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    from .utils import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())
