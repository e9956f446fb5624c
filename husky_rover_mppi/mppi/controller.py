"""The MPPI controller: one fully-jitted control step + goal-seeking loops.

Functional re-design of ``MPPI_Controller``
(thesis_master/warp_implementation/MPPI_isaac.py:402-806). The reference
mutates device buffers across 8 kernel launches per control loop; here one
control step is a single pure function ``(state, noise) -> (state', output)``
compiled once. Robot state and controller memory are separate pytrees because
the full-stack closed loop feeds the robot state from the physics engine
(visual_terrain_stack_full_terrain.py:488-497) while the standalone goal-seek
loop advances it kinematically from the optimal rollout (MPPI_isaac.py:769-784).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from ..core.heightfield import HeightField
from ..dynamics.skid_steer import (
    DiffDriveLimits,
    inverse_diff_drive,
    wheel_lag_matmul,
    wheel_lag_scan,
)
from . import critics as crit
from . import rollout as ro
from .critics import Costmap, CriticWeights
from .sampling import InputLimits, LoopSeedSequence, loop_key, perturb, sample_noise


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    """Static controller configuration (config.yaml + MPPI_isaac.py:419-440).

    Hashable so it can be a jit static argument; anything the goal-seek loop
    adapts online (the input std-devs) lives in traced state instead.
    """

    num_samples: int = 1000          # number_of_trajectories
    horizon: int = 100               # number_of_iterations
    dt: float = 0.045
    robot_radius: float = 1.2        # wheel track ("frame_work.robot_radius")
    temperature: float = 0.3
    initial_linear_velocity: float = 0.0
    initial_angular_velocity: float = 0.0
    limits: DiffDriveLimits = DiffDriveLimits()
    inputs: InputLimits = InputLimits()
    critic_weights: CriticWeights = CriticWeights()
    projection: str = "3d"           # "3d" | "2d" rollout for the samples
    # (k, a) wheel-lag constants: rollouts vs optimal sequence
    # (MPPI_isaac.py:548-549 / 688-689).
    rollout_lag: tuple = (3.5, 0.96)
    optimal_lag: tuple = (3.0, 0.92)
    # Adaptive exploration-noise floor: sigma = max(b, b -/+ omega^2) per
    # channel after each loop. The reference uses 0.4 in the standalone
    # controller (MPPI_isaac.py:777-778) and 0.3 in the thesis's statistics
    # runs (MPPI_OO_current.py:684-685).
    sigma_base: float = 0.4
    # Which slope critic scores the K rollouts. "wheels": per-pair max of
    # left/right wheel-track slopes (the Isaac production critic,
    # critics_warp.py:168-218). "body": body-trajectory slope — the variant
    # the thesis's statistics runs used (MPPI_OO_current.py launches the
    # 15-arg kernels with no lw/rw wheel arrays, :500-543; its critics
    # predate the wheel variant). In 2D projection mode the wheel critic
    # always degrades to body (no wheel tracks exist), so "wheels" gives
    # the 3D arm a nearest-cell-noise handicap the 2D arm never pays —
    # the stats experiment must use "body" for arm symmetry.
    slope_critic: str = "wheels"
    exact: bool = False              # True: lax.scan wheel lag (oracle parity)
                                     # False: Toeplitz matmul
    return_rollouts: bool = False    # include all K trajectories in the output
    # Terrain/costmap read engine. "direct": XLA gathers, one lax.scan step
    # per horizon step. "pallas": the fused rollout kernel
    # (ops/rollout_pallas.py), GPU only — one launch runs the whole horizon.
    # "onehot": one-hot matmul selection over a reach-covering patch
    # (core/patch.py), bit-identical to "direct"; patch_size cells must be
    # >= 2*reach/resolution + margin. "auto": "pallas" on the GPU, "direct"
    # elsewhere (:func:`select_engine`).
    gather_engine: str = "auto"      # "auto" | "direct" | "pallas" | "onehot"
    patch_size: int = 256            # DEM patch cells (onehot engine)
    costmap_patch_size: int = 128    # costmap patch cells (onehot engine)
    # Reach-adaptive patch chunking: serve early horizon steps (which cannot
    # yet have traveled far) from smaller patches — one-hot selection cost
    # scales with patch area. Bit-identical; needs a concrete resolution.
    chunk_patches: bool = True
    # Static resolution hints for when the field resolutions are traced
    # (e.g. under jit with donated heightfields); None = read from the field
    # when it is concrete, else fall back to a single unchunked patch.
    dem_resolution: float | None = None
    costmap_resolution: float | None = None

    def __post_init__(self):
        valid = ("auto", "direct", "onehot", "pallas")
        if self.gather_engine not in valid:
            raise ValueError(
                f"gather_engine={self.gather_engine!r} — must be one of {valid}"
            )
        if self.projection not in ("3d", "2d"):
            raise ValueError(
                f"projection={self.projection!r} — must be '3d' or '2d'"
            )
        if self.slope_critic not in ("wheels", "body"):
            raise ValueError(
                f"slope_critic={self.slope_critic!r} — must be 'wheels' or "
                "'body'"
            )

    @property
    def horizon_m(self) -> float:
        """Lookahead distance dt * v_max * H (MPPI_isaac.py:440)."""
        return self.dt * self.limits.v_max * self.horizon

    @property
    def reach_m(self) -> float:
        """Worst-case distance any rollout lookup can be from the robot:
        horizon travel + wheel-track offset (projection_warp.py:333)."""
        return self.horizon_m + ro.WHEEL_OFFSET

    def required_patch_cells(self, resolution: float) -> int:
        """Minimum one-hot patch side (cells) that covers ``reach_m`` at
        ``resolution`` m/px: 2*ceil(reach/res) plus index/truncation margin.
        The one-hot engine clamps escaping lookups to the patch edge, so an
        undersized patch silently reads wrong heights — callers must size
        patches with this (validated at trace time in :func:`mppi_step`)."""
        import math

        return 2 * math.ceil(self.reach_m / float(resolution)) + 6


def select_engine(config: MPPIConfig, backend: str | None = None) -> str:
    """The gather engine a step runs: an explicit choice stands; "auto"
    takes the fused rollout kernel on the GPU and XLA gathers elsewhere."""
    if config.gather_engine != "auto":
        return config.gather_engine
    if backend is None:
        backend = jax.default_backend()
    return "pallas" if backend == "gpu" else "direct"


class RobotState(NamedTuple):
    """Kinematic rover state (Robot, MPPI_isaac.py:381-400)."""

    position: Array          # (2,) x, y
    z: Array                 # scalar surface height
    heading: Array           # (3,) unit heading vector
    left_wheel_speed: Array  # scalar
    right_wheel_speed: Array # scalar

    @classmethod
    def create(cls, x, y, heading, dtype=jnp.float32,
               wheel_speed: float = 0.0) -> "RobotState":
        """``wheel_speed``: initial left/right wheel linear speed — the
        thesis experiment drivers start rolling at 1.0 m/s
        (MPPI_OO_current.py Robot init / compare_3d_2d.py:207-208)."""
        heading = jnp.asarray(heading, dtype)
        heading = heading / jnp.linalg.norm(heading)
        return cls(
            position=jnp.array([x, y], dtype),
            z=jnp.asarray(0.0, dtype),
            heading=heading,
            left_wheel_speed=jnp.asarray(wheel_speed, dtype),
            right_wheel_speed=jnp.asarray(wheel_speed, dtype),
        )


class ControllerState(NamedTuple):
    """Persistent controller memory across control loops."""

    optimal_u1: Array  # (H,)
    optimal_u2: Array  # (H,)
    std_u1: Array      # scalar, adapted online (MPPI_isaac.py:777-778)
    std_u2: Array      # scalar

    @classmethod
    def create(cls, config: MPPIConfig, dtype=jnp.float32,
               initial_u: float = 0.0) -> "ControllerState":
        """``initial_u``: initial optimal input fill — the thesis drivers
        initialize the sequences to ones (forward bias,
        MPPI_OO_current.py:367) so the first loops command ~1 m/s instead
        of spinning up from rest."""
        h = config.horizon
        return cls(
            optimal_u1=jnp.full((h,), initial_u, dtype),
            optimal_u2=jnp.full((h,), initial_u, dtype),
            std_u1=jnp.asarray(config.inputs.std_u1, dtype),
            std_u2=jnp.asarray(config.inputs.std_u2, dtype),
        )


class StepOutput(NamedTuple):
    """Result of one control step."""

    linear_velocity: Array   # scalar: optimal v for the next command
    angular_velocity: Array  # scalar: optimal omega
    optimal_trajectory: Array   # (H, 3) optimal rollout
    optimal_headings: Array     # (H, 3)
    optimal_linear: Array       # (H,) full optimal velocity profile
    optimal_angular: Array      # (H,)
    costs: Array                # (K,)
    weights: Array              # (K,)
    rollouts: Array | None      # (K, H, 3) when config.return_rollouts


def _static_float(x):
    """Concrete float of ``x`` or None when it is an abstract tracer."""
    try:
        return float(x)
    except (jax.errors.ConcretizationTypeError, TypeError):
        return None


def _check_patch_coverage(config: MPPIConfig, dem_res, cm_res) -> None:
    """Fail loudly (at trace time) when the one-hot patches cannot cover the
    horizon reach: the engine clamps escaping lookups to the patch edge, so
    an undersized ``patch_size`` would silently return wrong heights/costs
    instead of erroring (core/patch.py:19-36 exactness contract). Skipped
    only when the resolutions are themselves traced values."""
    for res, size, name in (
        (dem_res, config.patch_size, "patch_size"),
        (cm_res, config.costmap_patch_size, "costmap_patch_size"),
    ):
        if res is None:
            continue
        need = config.required_patch_cells(res)
        if size < need:
            raise ValueError(
                f"{name}={size} cannot cover the horizon reach "
                f"{config.reach_m:.2f} m at resolution {res} m/px: need >= "
                f"{need} cells. The one-hot engine clamps out-of-patch "
                f"lookups silently — enlarge {name}, coarsen the grid, or "
                f"use gather_engine='direct'."
            )


def _patch_schedule(config: MPPIConfig, res: float | None):
    """Reach-adaptive patch schedule ``((size, n_steps), ...)``.

    Sizes are multiples of 128; a chunk under 16 steps is not worth a scan
    split. With an unknown resolution or chunking disabled, one full-size
    patch serves the whole horizon."""
    import math

    H = config.horizon
    if res is None or not config.chunk_patches:
        return ((config.patch_size, H),)
    need = config.required_patch_cells(res)
    sizes = [*range(128, config.patch_size, 128), config.patch_size]
    final = next(s for s in sizes if s >= need)
    v_step = config.dt * config.limits.v_max
    schedule, t = [], 0
    for s in sizes:
        if s >= final:
            break
        reach_max = (s - 6) // 2 * res - ro.WHEEL_OFFSET
        n_cover = min(int(math.floor(reach_max / v_step)), H)
        if n_cover - t >= 16:
            schedule.append((s, n_cover - t))
            t = n_cover
        if t >= H:
            break
    if t < H:
        schedule.append((final, H - t))
    return tuple(schedule)


def mppi_step(
    config: MPPIConfig,
    hf: HeightField,
    costmap: Costmap,
    goal: Array,
    robot: RobotState,
    ctrl: ControllerState,
    noise: Array,
) -> tuple[ControllerState, StepOutput]:
    """One MPPI control step (MPPI_isaac.py:505-752), fully traceable.

    Kernel-launch sequence of the reference collapsed into one program:
    sample inputs -> wheel-lag conversion -> K rollouts -> critics ->
    two-pass softmax weights -> weighted optimal inputs -> optimal-sequence
    conversion -> optimal rollout.
    """
    wheel_lag = wheel_lag_scan if config.exact else wheel_lag_matmul
    track = jnp.asarray(config.robot_radius, noise.dtype)
    horizon_m = jnp.asarray(config.horizon_m, noise.dtype)

    # Terrain-read engine: "onehot" swaps the window for reach-covering
    # patches read by one-hot selection (bit-identical to "direct");
    # "pallas" runs both rollouts through the fused kernel on the full
    # field (same cells read, multiply-add-level differences).
    engine = select_engine(config)
    cm_patch = None
    if engine == "onehot":
        from ..core import patch as patch_mod

        # Prefer the concrete field resolution; static config hints only
        # stand in when the field's value is traced. When both are known
        # they must agree — a config whose hints were sized
        # against a different-resolution field would size the patch schedule
        # (and run _check_patch_coverage) against the stale hint and
        # silently edge-clamp lookups.
        def _resolve(hint, concrete, name):
            if concrete is None:
                return hint
            if hint is not None and abs(hint - concrete) > 1e-9 * max(
                    abs(hint), abs(concrete)):
                raise ValueError(
                    f"MPPIConfig.{name}={hint} does not match the field's "
                    f"concrete resolution {concrete}: the config was sized "
                    f"for a different grid. Drop the stale hint."
                )
            return concrete

        dem_res = _resolve(config.dem_resolution,
                           _static_float(hf.resolution), "dem_resolution")
        cm_res = _resolve(config.costmap_resolution,
                          _static_float(costmap.resolution),
                          "costmap_resolution")
        _check_patch_coverage(config, dem_res, cm_res)
        schedule = _patch_schedule(config, dem_res)
        x0, y0 = robot.position[0], robot.position[1]
        if len(schedule) == 1:
            hf = patch_mod.extract_patch(hf, x0, y0, schedule[0][0])
        else:
            hf = ro.ChunkedField(
                patches=tuple(patch_mod.extract_patch(hf, x0, y0, s)
                              for s, _ in schedule),
                lengths=tuple(n for _, n in schedule),
            )
        ic, jc = crit.costmap_cells(robot.position[None, :], costmap)
        cm_patch = patch_mod.extract_grid_patch(
            costmap.cost, ic[0], jc[0], config.costmap_patch_size
        )

    # 1. Receding-horizon input perturbation (sampling_warp.py:54-92).
    u1, u2 = perturb(
        ctrl.optimal_u1, ctrl.optimal_u2, noise, ctrl.std_u1, ctrl.std_u2,
        config.inputs,
    )

    # 2. Inputs -> wheel velocities -> (v, omega) (sampling_warp.py:96-139).
    k_r, a_r = config.rollout_lag
    lin, ang = wheel_lag(
        u1, u2, robot.left_wheel_speed, robot.right_wheel_speed, track,
        config.limits, k_r, a_r,
    )

    # 3. K surface-riding rollouts (projection_warp.py:284-350).
    if engine == "pallas":
        # body-slope mode never reads the wheel tracks, and the optimal
        # rollout's are never read either (only trajectory + headings feed
        # kinematic_advance): the kernel skips those lookups
        roll_25d = functools.partial(
            ro.rollout_25d_pallas,
            compute_wheels=(config.slope_critic == "wheels"))
        opt_roll = functools.partial(ro.rollout_25d_pallas,
                                     compute_wheels=False)
    else:
        roll_25d = ro.rollout_25d
        opt_roll = ro.rollout_25d
    if config.projection == "2d":
        traj, headings = ro.rollout_2d(
            hf, robot.position, robot.heading, lin, ang, config.dt
        )
        # The 2D variant has no wheel tracks; reuse body trajectory so the
        # wheel-slope critic degrades to the body-slope critic.
        lw = rw = traj
    else:
        r = roll_25d(hf, robot.position, robot.heading, lin, ang, config.dt)
        traj, headings, lw, rw = r
        if config.slope_critic == "body":
            # thesis-statistics critic form: body slope for both arms
            # (MPPI_OO_current.py:500-543 — kernels launched without lw/rw)
            lw = rw = traj

    # 4. Critic stack (critics_warp.py:302-329).
    costs = crit.evaluate_trajectories(
        robot.position[0], robot.position[1], goal, traj, lw, rw, lin,
        jnp.asarray(config.limits.v_max, noise.dtype), costmap, horizon_m,
        config.critic_weights, costmap_patch=cm_patch,
    )

    # 5. Importance weights + weighted optimal inputs (critics_warp.py:338-376).
    weights = crit.softmax_weights(costs, config.temperature)
    opt_u1, opt_u2 = crit.weighted_update(weights, u1, u2)

    # 6. Optimal-sequence conversion with the softer lag constants
    #    (MPPI_isaac.py:672-692).
    k_o, a_o = config.optimal_lag
    opt_lin, opt_ang = wheel_lag(
        opt_u1[None], opt_u2[None], robot.left_wheel_speed,
        robot.right_wheel_speed, track, config.limits, k_o, a_o,
    )
    opt_lin, opt_ang = opt_lin[0], opt_ang[0]

    # 7. Optimal rollout — always the 3D kernel, even in 2D mode
    #    (MPPI_isaac.py:696-720).
    opt = opt_roll(
        hf, robot.position, robot.heading, opt_lin[None], opt_ang[None], config.dt
    )

    b = config.sigma_base
    new_ctrl = ControllerState(
        optimal_u1=opt_u1,
        optimal_u2=opt_u2,
        # Adaptive exploration noise (MPPI_isaac.py:777-778 /
        # MPPI_OO_current.py:684-685).
        std_u1=jnp.maximum(b, b - opt_ang[0] * opt_ang[0]),
        std_u2=jnp.maximum(b, b + opt_ang[0] * opt_ang[0]),
    )
    out = StepOutput(
        linear_velocity=opt_lin[0],
        angular_velocity=opt_ang[0],
        optimal_trajectory=opt.trajectory[0],
        optimal_headings=opt.headings[0],
        optimal_linear=opt_lin,
        optimal_angular=opt_ang,
        costs=costs,
        weights=weights,
        rollouts=traj if config.return_rollouts else None,
    )
    return new_ctrl, out


def kinematic_advance(
    config: MPPIConfig, robot: RobotState, out: StepOutput
) -> RobotState:
    """Advance the robot to the first waypoint of the optimal rollout — the
    standalone goal-seek "sim" semantics (MPPI_isaac.py:769-784)."""
    left, right = inverse_diff_drive(
        out.linear_velocity, out.angular_velocity,
        jnp.asarray(config.robot_radius, out.linear_velocity.dtype),
    )
    return RobotState(
        position=out.optimal_trajectory[0, :2],
        z=out.optimal_trajectory[0, 2],
        heading=out.optimal_headings[0],
        left_wheel_speed=left,
        right_wheel_speed=right,
    )


class GoalSeekResult(NamedTuple):
    robot: RobotState
    ctrl: ControllerState
    loops: Array
    reached: Array


def goal_seek(
    config: MPPIConfig,
    hf: HeightField,
    costmap: Costmap,
    goal: Array,
    robot: RobotState,
    ctrl: ControllerState,
    key: Array,
    max_loops: int = 3500,
    unroll: int = 4,
) -> GoalSeekResult:
    """Fully-on-device goal-seeking loop (MPPI_Controller.run,
    MPPI_isaac.py:755-806): stop when |dx|<0.5 and |dy|<0.5 or after
    ``max_loops`` control loops. One ``lax.while_loop`` — zero host syncs.

    The loop body runs ``unroll`` *masked* control steps per while
    iteration: once the stop box is hit (or the loop cap), further sub-steps
    leave the state frozen, so results are bit-identical to the one-step
    body while the while-loop's fixed per-iteration overhead (condition
    evaluation + carry round-trip) amortizes over ``unroll`` steps. At most ``unroll - 1`` wasted masked
    steps per episode."""
    robot, ctrl, loops, halt, _, _ = _goal_seek_loop(
        config, hf, costmap, goal, robot, ctrl, key, max_loops, unroll,
        record=False)
    return GoalSeekResult(robot=robot, ctrl=ctrl, loops=loops, reached=halt)


def _goal_seek_loop(config, hf, costmap, goal, robot, ctrl, key,
                    max_loops, unroll, record):
    """Shared masked-unroll ``lax.while_loop`` body of :func:`goal_seek`
    and :func:`goal_seek_recorded` — ONE implementation so the stop-box,
    masking and unroll semantics cannot diverge between the benchmark and
    evaluation paths. ``record`` (Python-static) adds the fixed-size
    position/velocity buffers; the bare variant carries empty buffers and
    compiles without the writes."""
    dtype = robot.position.dtype
    bp = jnp.zeros((max_loops + 1 if record else 0, 3), dtype)
    bv = jnp.zeros((max_loops + 1 if record else 0,), dtype)

    def reached_now(r):
        dx = jnp.abs(r.position[0] - goal[0])
        dy = jnp.abs(r.position[1] - goal[1])
        return jnp.logical_and(dx <= 0.5, dy <= 0.5)

    def cond(carry):
        _, _, _, loop, halt, _, _ = carry
        return jnp.logical_and(jnp.logical_not(halt), loop < max_loops)

    def body(carry):
        robot, ctrl, key, loop, halt, bp, bv = carry
        for _ in range(unroll):
            active = jnp.logical_and(
                jnp.logical_not(halt), loop < max_loops)
            key, sub = jax.random.split(key)
            noise = sample_noise(
                sub, config.num_samples, config.horizon, dtype)
            ctrl2, out = mppi_step(
                config, hf, costmap, goal, robot, ctrl, noise)
            robot2 = kinematic_advance(config, robot, out)
            keep = lambda new, old: jnp.where(active, new, old)
            robot = jax.tree.map(keep, robot2, robot)
            ctrl = jax.tree.map(keep, ctrl2, ctrl)
            if record:
                bp = bp.at[loop].set(
                    jnp.concatenate([robot.position, robot.z[None]]))
                bv = bv.at[loop].set(
                    jnp.where(active, out.linear_velocity, bv[loop]))
            loop = loop + active.astype(jnp.int32)
            halt = reached_now(robot)
        return (robot, ctrl, key, loop, halt, bp, bv)

    loop0 = jnp.asarray(0, jnp.int32)
    robot, ctrl, key, loops, halt, bp, bv = jax.lax.while_loop(
        cond, body, (robot, ctrl, key, loop0, reached_now(robot), bp, bv))
    return robot, ctrl, loops, halt, bp, bv


class GoalSeekTrace(NamedTuple):
    """Recorded goal-seek episode (the CSV-logging run of the thesis
    experiments, MPPI_OO_current.py trajectory writers)."""

    robot: RobotState
    ctrl: ControllerState
    loops: Array
    reached: Array
    positions: Array   # (max_loops, 3) — valid up to ``loops``
    velocities: Array  # (max_loops,) commanded linear velocity per loop


def goal_seek_recorded(
    config: MPPIConfig,
    hf: HeightField,
    costmap: Costmap,
    goal: Array,
    robot: RobotState,
    ctrl: ControllerState,
    key: Array,
    max_loops: int = 1500,
    unroll: int = 4,
) -> GoalSeekTrace:
    """:func:`goal_seek` with an on-device trajectory recording: the
    ``lax.while_loop`` carries fixed-size position/velocity buffers written
    at the loop index, so early exit is kept and the whole episode still
    runs with zero host syncs. Body is masked-unrolled like
    :func:`goal_seek`; after the stop box is hit, frozen sub-steps rewrite
    index ``loops`` with the frozen state (consumers slice ``[:loops]``)."""
    robot, ctrl, loops, halt, buf_pos, buf_vel = _goal_seek_loop(
        config, hf, costmap, goal, robot, ctrl, key, max_loops, unroll,
        record=True)
    return GoalSeekTrace(
        robot=robot, ctrl=ctrl, loops=loops, reached=halt,
        positions=buf_pos[:max_loops], velocities=buf_vel[:max_loops],
    )


class MPPIController:
    """Host-side convenience wrapper mirroring the reference controller's
    surface API (``warp_setup``/``MPPI_step``/``run``) around the pure
    functions above. Owns the jitted step and the replayable per-loop seed
    stream."""

    def __init__(
        self,
        config: MPPIConfig,
        hf: HeightField,
        costmap: Costmap,
        goal_xy,
        seed: int = 42,
    ):
        if config.gather_engine == "onehot":
            # the patch engine clamps lookups to the patch edge — validate
            # coverage here while the field resolutions are still concrete
            # (inside the jitted step they are traced and the check can
            # only run from static config hints)
            _check_patch_coverage(config, hf.resolution, costmap.resolution)
        self.config = config
        self.hf = hf
        self.costmap = costmap
        self.goal = jnp.asarray(goal_xy, hf.z.dtype)
        self.base_key = jax.random.key(seed)
        self.seeds = LoopSeedSequence(config.horizon, seed)
        self._step = jax.jit(mppi_step, static_argnums=0)
        self.loop = 0

    def step(self, robot: RobotState, ctrl: ControllerState, noise=None):
        """One control step; draws the loop noise from the replayable seed
        stream unless ``noise`` is injected (oracle bit-match path)."""
        if noise is None:
            k = loop_key(self.base_key, self.seeds.next_seed())
            noise = sample_noise(
                k, self.config.num_samples, self.config.horizon,
                self.hf.z.dtype,
            )
        self.loop += 1
        return self._step(
            self.config, self.hf, self.costmap, self.goal, robot, ctrl, noise
        )

    def run(self, robot: RobotState, max_loops: int = 3500):
        """Host-visible goal-seek loop (useful for logging / debugging; the
        benchmark path uses :func:`goal_seek`)."""
        ctrl = ControllerState.create(self.config, self.hf.z.dtype)
        trajectory = [np.asarray(robot.position)]
        while (
            abs(float(robot.position[0]) - float(self.goal[0])) > 0.5
            or abs(float(robot.position[1]) - float(self.goal[1])) > 0.5
        ) and self.loop < max_loops:
            ctrl, out = self.step(robot, ctrl)
            robot = kinematic_advance(self.config, robot, out)
            trajectory.append(np.asarray(robot.position))
        return robot, ctrl, np.stack(trajectory)
