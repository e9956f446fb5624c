"""Streamed-terrain full-stack closed loop — a re-design of
``visual_terrain_stack_full_terrain.py:293-582``, the reference's headline
demo: an MPPI-driven rover crossing procedurally streamed lunar terrain.

The reference composes LargeScaleTerrainManager + a PhysX Husky + the Warp
MPPI controller, with three pieces of glue this module reproduces:

* the controller runs in the **rotated block-local frame**
  (``ctrl.x = world.y - oy``, ``ctrl.y = -(world.x - ox)`` with
  ``(ox, oy) = block + half_block``, :436-455, :492-497) — under that
  rotation the controller's ``Z[j, i]`` indexing maps exactly onto the
  streamer window layout (row = world x, col = world y), so the live window
  array seats directly as the MPPI heightfield (:423-431);
* commands are **latched every 3rd sim step with a PI yaw-rate trim**
  (:477-511) — reused from :mod:`.closed_loop` (same semantics, N=1);
* on every **block shift** (:546-576): the heightfield re-seats on the
  shifted window, the costmap rebuilds from the streamed ``rocks_data``
  at the new origin, and robot history + goal rebase by ``(-dy, +dx)``
  in the controller frame.

Everything inside a step is one jitted program over static shapes: the
window array changes contents on shift, coordinates rebase, nothing
recompiles.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from collections import deque
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.heightfield import HeightField
from ..mppi.controller import MPPIConfig
from ..mppi.critics import Costmap
from ..physics.deformation import DeformationEngine, DeformationEngineConf
from ..terrain.costmap import update_costmap_with_obstacles
from ..terrain.orchestrator import LargeScaleConf, LargeScaleTerrainManager
from . import closed_loop, frames
from .closed_loop import ClosedLoopConfig, LoopState
from .rover_sim import RoverState


@dataclasses.dataclass
class LargeScaleLoopConf:
    """Full-stack run configuration (the ``__main__`` parameters of
    visual_terrain_stack_full_terrain.py:377-455)."""

    terrain: LargeScaleConf = dataclasses.field(default_factory=LargeScaleConf)
    loop: ClosedLoopConfig = dataclasses.field(default_factory=ClosedLoopConfig)
    start: tuple = (0.0, 0.0)          # world (x, y) (:377-379)
    goal: tuple = (65.0, 65.0)         # world goal (:420-421)
    costmap_robot_radius: float = 0.3  # Surface radius_robot (:449)
    costmap_falloff: float = 20.0      # (1-d)^20 (MPPI_isaac.py:374-377)
    goal_tolerance: float = 0.5        # |dx|,|dy| stop box (MPPI_isaac.py:795)
    max_steps: int = 20000
    # Sim steps per jitted chunk = steps between host-side terrain polls.
    # The reference checks every tick but gates updates on 2 m of travel
    # (update_every_n_meters); 12 steps is <=0.4 m at 2 m/s — far finer
    # than the gate — with one host readback per chunk.
    terrain_check_every: int = 12
    # Pre-stage the next block shift: when the heading-lookahead position
    # crosses into a new block, build that window's costmap (and warm the
    # entering block band) ahead of time so the actual shift only swaps
    # arrays — the latency-hiding role of the reference's 8+1 worker
    # processes (high_resolution_DEM_workers.py:199-765).
    prestage_shifts: bool = True
    prestage_lookahead_m: float = 6.0
    # Chunks kept in flight beyond the one being processed: the host
    # consumes the rover pose only for terrain gating and logging, which
    # tolerates `depth` chunks of lag (<=0.5 m/chunk at the default
    # chunking vs the 2 m update gate and 6 m prestage lookahead), so each
    # chunk's pose readback overlaps the next chunks' device compute
    # instead of stalling the loop for one host readback per chunk.
    # 0 = synchronous; the deformation path always runs synchronously (its
    # donated window chain cannot outlive a background streamer roll).
    pipeline_depth: int = 4
    # Periodic checkpointing: every
    # `checkpoint_every_steps` sim steps the traverse state serializes to
    # `checkpoint_path` through aux.checkpoint; `LargeScaleClosedLoop.
    # resume(conf, path)` continues it. On the synchronous path the
    # continuation is bit-identical to the uninterrupted run (seeds +
    # per-block determinism); the pipelined path drains first, so its
    # snapshot is self-consistent at the drain point.
    checkpoint_path: Optional[str] = None
    checkpoint_every_steps: int = 0
    # Debug/test: on every pre-stage hit, also run the synchronous rebuild
    # and assert the staged costmap is bit-identical (defeats the latency
    # win — tests only).
    verify_prestage: bool = False
    seed: int = 42
    deform: Optional[DeformationEngineConf] = None  # wheel-track deformation
    wheelbase: float = 0.512  # Husky front<->rear wheel separation (m)

    @property
    def costmap_size(self) -> int:
        """costmap = DEM grid / 8 (MPPI_isaac.py:271-272)."""
        return self.terrain.streamer_conf.window_px // 8


@dataclasses.dataclass
class LargeScaleRunResult:
    reached: bool
    steps: int
    block_shifts: int
    distance_m: float
    final_position: tuple
    wall_s: float
    shift_latencies_s: List[float]
    costmap_rebuilds: int
    path_world: np.ndarray  # (T, 2)
    # steady-state rate: steps/time after the first `steady_after` sim steps
    # (first-iteration jit compiles dominate wall_s otherwise)
    steady_steps: int = 0
    steady_wall_s: float = 0.0
    # shift pre-staging effectiveness
    prestage_hits: int = 0
    prestage_misses: int = 0


@jax.jit
def _roll_pass_counts(counts, di_px, dj_px):
    """Shift the per-pixel deformation pass counts exactly like the window
    roll (streaming.py shift path: ``jnp.roll(window, (-di, -dj))``) and
    zero the newly-exposed band. A jump of a full window or more means the
    streamer took the full-rebuild path — nothing carries over, so the
    counts reset wholesale (mirroring the streamer's small-shift check;
    ADVICE r03: a wrapped roll would leave stale counts on rebuilt
    terrain). Shift amounts are traced (masked band zeroing) so ONE
    compiled program serves every shift direction — per-direction eager
    variants each cost a 15-40 s remote compile at reference scale."""
    di_px = jnp.asarray(di_px, jnp.int32)
    dj_px = jnp.asarray(dj_px, jnp.int32)
    n0, n1 = counts.shape
    rolled = jnp.roll(counts, (-di_px, -dj_px), (0, 1))
    rows = jnp.arange(n0, dtype=jnp.int32)[:, None]
    cols = jnp.arange(n1, dtype=jnp.int32)[None, :]
    keep_r = jnp.where(di_px >= 0, rows < n0 - di_px, rows >= -di_px)
    keep_c = jnp.where(dj_px >= 0, cols < n1 - dj_px, cols >= -dj_px)
    full_jump = (jnp.abs(di_px) >= n0) | (jnp.abs(dj_px) >= n1)
    keep = keep_r & keep_c & jnp.logical_not(full_jump)
    return jnp.where(keep, rolled, 0)


class _TerrainWorker:
    """One serial background thread owning EVERY terrain-side mutation of
    the pipelined streamed loop: shift pre-staging, the update cascade
    (streamer roll + crater sampling + clipmaps + rocks), and the
    shift-time costmap build. The main thread only dispatches chunk
    programs, submits (coalesced) poses here, and applies completed shift
    events — so the crater RNG, the rock DB, ``rocks_data`` and the
    streamer's window/anchor are touched by exactly one thread (the
    prestage-vs-shift RNG race of the old two-thread split is gone by
    construction; ADVICE r04). This is the worker-pool role of the
    reference's 8+1 terrain processes (high_resolution_DEM_workers.py)
    collapsed onto one thread, which suffices because the heavy work is
    asynchronous device dispatch."""

    def __init__(self, loop: "LargeScaleClosedLoop"):
        self.loop = loop
        self._cond = threading.Condition()
        self._pending = None      # newest submitted pose (coalesced)
        self._busy = False
        self._stop = False
        self._events: List[dict] = []
        self._last_block = (loop.block_x, loop.block_y)
        self.error: Optional[BaseException] = None
        self.terrain_s = 0.0
        self.prestage_s = 0.0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, pose) -> None:
        """Queue a world pose; a not-yet-started older pose is replaced
        (the cascade gates on 2 m of travel, so only the newest matters —
        and coalescing guarantees the streamer never re-anchors backwards
        off a stale pose)."""
        with self._cond:
            self._pending = pose
            self._cond.notify_all()

    def pop_events(self) -> List[dict]:
        with self._cond:
            evs, self._events = self._events, []
            return evs

    def drain(self) -> None:
        """Block until the queue is empty and the worker is idle."""
        with self._cond:
            while (self._pending is not None or self._busy) \
                    and self.error is None:
                self._cond.wait(timeout=0.2)

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._pending = None  # don't run one more cascade on teardown
            self._cond.notify_all()
        self._thread.join(timeout=60.0)

    def _run(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._stop:
                    self._cond.wait()
                if self._pending is None and self._stop:
                    return
                pose, self._pending = self._pending, None
                self._busy = True
            try:
                self._process(pose)
            except BaseException as e:  # surfaced by the main loop
                self.error = e
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def _process(self, pose) -> None:
        loop = self.loop
        wx, wy, hx, hy = pose
        t0 = time.perf_counter()
        if loop.conf.prestage_shifts:
            loop._prestage_inline(wx, wy, hx, hy)
        t1 = time.perf_counter()
        self.prestage_s += t1 - t0
        sp = loop.conf.terrain.starting_position
        updated, corrected = loop.lstm.update_visual_mesh(
            (wx - sp[0], wy - sp[1]))
        bx, by = loop.lstm.get_hr_map_current_block_coordinates()
        if (bx, by) != self._last_block:
            self._last_block = (bx, by)
            upd_pos = (loop.lstm._to_global(corrected) if updated
                       else (wx, wy))
            ev = loop._prepare_shift_event(bx, by, upd_pos)
            with self._cond:
                self._events.append(ev)
        self.terrain_s += time.perf_counter() - t1


class LargeScaleClosedLoop:
    """Host driver seating the jitted closed loop on the streamed window."""

    def __init__(self, conf: LargeScaleLoopConf, lstm=None, phase_cb=None):
        """``lstm`` injects a prebuilt terrain manager (profiling scripts
        time its sub-phases themselves); ``phase_cb(name, seconds)`` gets
        one call per construction phase so profilers measure the REAL
        build path instead of replicating it."""
        t0 = time.perf_counter()

        def _mark(name):
            nonlocal t0
            if phase_cb is not None:
                phase_cb(name, time.perf_counter() - t0)
            t0 = time.perf_counter()

        self.conf = conf
        if lstm is None:
            self.lstm = LargeScaleTerrainManager(conf.terrain)
            self.lstm.build()
        else:
            self.lstm = lstm
        _mark("terrain_build")
        streamer = self.lstm.map_manager.streamer
        self.window_half = streamer.conf.window_size / 2.0
        self.half_block = streamer.conf.block_size / 2.0

        # controller frame anchored at the current center block (:432-444)
        bx, by = self.lstm.get_hr_map_current_block_coordinates()
        self.block_x, self.block_y = bx, by
        self.frame = frames.BlockFrame(
            block_x=jnp.asarray(bx, jnp.float32),
            block_y=jnp.asarray(by, jnp.float32),
            half_block=jnp.asarray(self.half_block, jnp.float32),
        )

        self.hf = self._window_heightfield()
        _mark("window_heightfield")
        self.costmap = self._build_costmap()
        if phase_cb is not None:  # device-true timing only when profiling
            jax.block_until_ready(self.costmap.cost)
        _mark("first_costmap")
        self._step_fn = jax.jit(closed_loop.closed_loop_step, static_argnums=0)
        self.deform_engine = (
            DeformationEngine(conf.deform) if conf.deform is not None else None
        )
        self._chunk_fn = self._make_chunk_fn()
        _mark("chunk_fn_wrap")
        self._staged = None          # (center_block_key, rock_keys, costmap)
        self._prestage_thread = None
        self._prestage_error: Optional[BaseException] = None
        self.prestage_hits = 0
        self.prestage_misses = 0
        self.shift_phase_log: List[dict] = []  # per-shift phase timings

    def _make_chunk_fn(self):
        """One jitted program per terrain-check interval: `terrain_check_every`
        closed-loop steps as a ``lax.scan`` with on-device key derivation,
        the wheel-track deformation stamp, and the world-frame goal check all
        fused into a single dispatch. The host reads back only four scalars
        (world position, world heading, reached flag) per chunk — one
        readback per interval is the entire host<->device traffic of the
        streamed loop. Window and pass-count buffers
        are donated, so the 196 MB reference-scale window updates in place.
        """
        loop_conf = self.conf.loop
        n = self.conf.terrain_check_every
        tol = self.conf.goal_tolerance
        engine = self.deform_engine
        res = float(self.lstm.map_manager.streamer.conf.resolution)
        window_half = float(self.window_half)
        track = float(loop_conf.rover.track)
        wb = float(self.conf.wheelbase)

        def scan_and_pose(window, cm, goal_ctrl, state, base_key, idx,
                          frame_ox, frame_oy):
            """``terrain_check_every`` masked closed-loop steps: once the
            rover enters the goal stop box (checked EVERY sim step, in the
            rotated frame — the box is axis-swapped but identical) the
            state freezes, so long chunks cannot overshoot through the box
            between host polls (MPPI_OO_current.py:670 stop semantics —
            the same masked-freeze trick as controller.goal_seek)."""
            hf = HeightField.create(window, window_half)
            k = jax.random.fold_in(base_key, idx)
            keys = jax.random.split(k, n)

            def in_box(st):
                pos = st.rovers.position[0]
                return jnp.logical_and(
                    jnp.abs(pos[0] - goal_ctrl[0, 0]) < tol,
                    jnp.abs(pos[1] - goal_ctrl[0, 1]) < tol,
                )

            def body(carry, kk):
                st, done = carry
                new = closed_loop.closed_loop_step(loop_conf, hf, cm,
                                                   goal_ctrl, st, kk)
                st = jax.tree.map(
                    lambda a, b: jnp.where(done, b, a), new, st)
                return (st, jnp.logical_or(done, in_box(st))), None

            (state, done), _ = jax.lax.scan(body, (state, in_box(state)),
                                            keys)
            pos = state.rovers.position[0]
            h = state.rovers.heading[0]
            # rotated block frame -> world (frames.controller_to_world)
            wx = -pos[1] + frame_ox
            wy = pos[0] + frame_oy
            hx, hy = -h[1], h[0]
            return hf, state, wx, wy, hx, hy, done

        if engine is None:
            # no deformation: the window is read-only — no donation, so
            # its array identity stays stable between shifts (which lets
            # the streamer's identity-keyed shift pre-staging hold)
            def chunk(window, cm, goal_ctrl, state, base_key, idx,
                      frame_ox, frame_oy):
                _, state, wx, wy, hx, hy, done = scan_and_pose(
                    window, cm, goal_ctrl, state, base_key, idx,
                    frame_ox, frame_oy)
                return state, wx, wy, hx, hy, done

            return jax.jit(chunk)

        def chunk(window, counts, cm, goal_ctrl, state, base_key, idx,
                  frame_ox, frame_oy, win_ox, win_oy):
            hf, state, wx, wy, hx, hy, done = scan_and_pose(
                window, cm, goal_ctrl, state, base_key, idx,
                frame_ox, frame_oy)
            # wheel-track deformation from measured per-wheel loads
            # (simulation_manager_ros2.py:231-233 semantics, once per
            # chunk) — fully on device, no host round-trip
            from . import rover_sim

            loads = rover_sim.wheel_contact_forces(
                loop_conf.rover, hf, state.rovers, wheelbase=wb)
            yaw = jnp.arctan2(hy, hx)
            fwd = jnp.stack([hx, hy])
            left = jnp.stack([-hy, hx])
            body_w = jnp.stack([wx, wy])
            positions = jnp.stack([
                body_w + fwd * wb / 2 + left * track / 2,
                body_w + fwd * wb / 2 - left * track / 2,
                body_w - fwd * wb / 2 + left * track / 2,
                body_w - fwd * wb / 2 - left * track / 2,
            ])
            window, counts = engine.deform_window(
                window, counts, res, (win_ox, win_oy), positions,
                jnp.full((4,), yaw), loads[0],
            )
            return (window, counts, state, wx, wy, hx, hy, done)

        return jax.jit(chunk, donate_argnums=(0, 1))

    # -- window / costmap seating ---------------------------------------------

    def _window_heightfield(self) -> HeightField:
        """Seat the MPPI heightfield on the live streamed window (:423-431).
        Controller frame is window-centered, so half_width = window/2 and the
        raw window array is Z (row = x = controller j, col = y = controller i
        under the rotated frame)."""
        return HeightField.create(
            self.lstm.map_manager.streamer.window, self.window_half
        )

    def _rocks_for(self, position) -> np.ndarray:
        """Deterministic obstacle list for the rock region around a world
        position — exactly what ``update_visual_mesh`` + ``extract_rocks_data``
        produce once the rover is there (rock blocks are seed-deterministic
        and DB-cached, terrain/rocks.py), so a costmap staged from a
        *predicted* position is bit-identical to the synchronous rebuild."""
        span = self.conf.terrain.rock_block_span
        obstacles = []
        for sampler in self.lstm.rock_samplers:
            block = sampler.sample_region(position, block_span=span)
            pos = np.asarray(block.coordinates).reshape(-1, 2)
            sc = np.asarray(block.scale).reshape(-1, 3)
            if pos.shape[0] == 0:
                continue
            radius = np.maximum(sc[:, 0], sc[:, 1])
            obstacles.append(np.concatenate([pos, radius[:, None]], axis=-1))
        if not obstacles:
            return np.zeros((0, 3), np.float32)
        return np.concatenate(obstacles, axis=0)

    def _build_costmap(self, block_xy=None, obstacles=None) -> Costmap:
        """Costmap from the streamed rocks at the current (or a staged)
        window origin (:448-449, :559-563)."""
        bx, by = block_xy if block_xy is not None else (self.block_x,
                                                       self.block_y)
        origin = (bx + self.half_block, by + self.half_block)
        if obstacles is None:
            obstacles = self.lstm.extract_rocks_data()
        if obstacles.shape[0] == 0:
            # degenerate free-space window: zero cost everywhere (the minmax
            # normalization of the distance transform is undefined)
            size = self.conf.costmap_size
            from ..terrain.costmap import as_costmap

            return as_costmap(np.zeros((size, size), np.float32),
                              self.window_half)
        cm = update_costmap_with_obstacles(
            self.conf.costmap_size,
            self.window_half,
            obstacles[:, :2],
            obstacles[:, 2],
            self.conf.costmap_robot_radius,
            falloff_power=self.conf.costmap_falloff,
            origin=origin,
        )
        return cm

    # -- frame plumbing --------------------------------------------------------

    def _initial_state(self) -> LoopState:
        cx, cy = frames.world_to_controller(
            self.frame,
            jnp.asarray(self.conf.start[0], jnp.float32),
            jnp.asarray(self.conf.start[1], jnp.float32),
        )
        # world +x heading in the rotated frame (:440, :493: [h.y, -h.x, h.z])
        heading = frames.heading_world_to_controller(
            jnp.asarray([1.0, 0.0, 0.0], jnp.float32)
        )
        rovers = RoverState.create(
            jnp.stack([cx, cy])[None, :], heading[None, :], self.hf
        )
        return closed_loop.init_loop_state(self.conf.loop, rovers)

    def _goal_ctrl(self) -> jnp.ndarray:
        gx, gy = frames.world_to_controller(
            self.frame,
            jnp.asarray(self.conf.goal[0], jnp.float32),
            jnp.asarray(self.conf.goal[1], jnp.float32),
        )
        return jnp.stack([gx, gy])[None, :]

    def _world_position(self, state: LoopState) -> tuple:
        """One device->host transfer for the rover's world position."""
        cx, cy = np.asarray(jax.device_get(state.rovers.position[0]))
        ox = float(self.block_x) + self.half_block
        oy = float(self.block_y) + self.half_block
        # inverse of the rotated frame (frames.controller_to_world, host-side)
        return -float(cy) + ox, float(cx) + oy

    # -- shift pre-staging (the worker-pool latency hiding,
    #    high_resolution_DEM_workers.py:199-765) -------------------------------

    def _rock_keys(self, position) -> tuple:
        """Per-sampler rock-block indices a costmap built at ``position``
        depends on (sample_region quantizes to the sampler's block size)."""
        return tuple(
            (int(np.floor(position[0] / s.conf.block_size)),
             int(np.floor(position[1] / s.conf.block_size)))
            for s in self.lstm.rock_samplers
        )

    def _quantized_update_pos(self, wx: float, wy: float) -> tuple:
        """The position ``update_visual_mesh`` would refresh rocks at
        (orchestrator quantizes local coords to the update threshold)."""
        sp = self.conf.terrain.starting_position
        q = self.conf.terrain.update_every_n_meters
        lx, ly = wx - sp[0], wy - sp[1]
        return ((lx // q) * q + sp[0], (ly // q) * q + sp[1])

    def _would_shift(self, local) -> bool:
        """Predict whether ``update_visual_mesh(local)`` will shift the
        streamer window: replicate the orchestrator's 2 m travel gate + the
        quantization to the update threshold, then compare the anchor the
        streamer would adopt at that *corrected* position with its current
        one (update_visual_mesh :252-258 + streaming.update :484-487)."""
        lstm = self.lstm
        q = lstm.settings.update_every_n_meters
        last = lstm.last_update_coordinates
        if last is not None:
            dx = local[0] - last[0]
            dy = local[1] - last[1]
            if (dx * dx + dy * dy) ** 0.5 <= q:
                return False
        corrected = ((local[0] // q) * q, (local[1] // q) * q)
        gx, gy = lstm._to_global(corrected)
        streamer = lstm.map_manager.streamer
        n = streamer.conf.num_blocks + 1
        bx, by = streamer.block_index((gx, gy))
        return (bx - n, by - n) != streamer.anchor

    def _join_prestage(self):
        """Wait for an in-flight background pre-stage (bounded: it started
        at least one chunk earlier) and raise the error it hit, if any."""
        t = self._prestage_thread
        if t is not None and t.is_alive():
            t.join()
        self._prestage_thread = None
        err, self._prestage_error = self._prestage_error, None
        if err is not None:
            raise err

    def _predict_crossing(self, wx: float, wy: float, hx: float, hy: float):
        """Shared crossing predictor of both pre-staging paths: the heading
        lookahead's center-block SW corner + the anchor the streamer would
        adopt there, or ``None`` when no crossing is imminent. Returns
        ``(key, new_anchor, px, py)``."""
        streamer = self.lstm.map_manager.streamer
        bs = streamer.conf.block_size
        L = self.conf.prestage_lookahead_m
        norm = float(np.hypot(hx, hy)) or 1.0
        px, py = wx + L * hx / norm, wy + L * hy / norm
        pred_blk = streamer.block_index((px, py))
        cur_blk = streamer.block_index((wx, wy))
        if pred_blk == cur_blk:
            return None
        a = streamer.anchor
        new_anchor = (a[0] + pred_blk[0] - cur_blk[0],
                      a[1] + pred_blk[1] - cur_blk[1])
        return ((pred_blk[0] * bs, pred_blk[1] * bs), new_anchor, px, py)

    def _maybe_prestage(self, wx: float, wy: float, hx: float, hy: float):
        """Predict the next center-block crossing from the heading lookahead
        and build that window's costmap + the shifted window itself *now*,
        in a background thread, while the control chunks keep running — so
        the actual shift only swaps arrays and the staging's host work
        overlaps chunk compute (the GIL releases during blocking JAX calls).
        An error in the staging thread is kept and raised at the next
        crossing (:meth:`_join_prestage`).
        Thread-safety: the staged products are written atomically at the
        end; the main thread only touches the shared crater RNG inside
        shift handling, which joins this thread first."""
        import threading

        if self._prestage_thread is not None:
            if self._prestage_thread.is_alive():
                return  # one staging in flight at a time
            self._prestage_thread = None
        streamer = self.lstm.map_manager.streamer
        pred = self._predict_crossing(wx, wy, hx, hy)
        if pred is None:
            return
        key, new_anchor, px, py = pred
        if self._staged is not None and self._staged[0] == key:
            # costmap staged; make sure the window stage exists too
            streamer.prestage_shift(new_anchor)
            return

        def work():
            try:
                # stage the SHIFTED WINDOW inside the streamer (identity-
                # keyed) — except under deformation, where the chunk donates
                # a fresh window every interval (the snapshot could be
                # deleted mid-compose and the stage would be invalidated
                # anyway)
                if self.deform_engine is None:
                    streamer.prestage_shift(new_anchor)
                # stage the costmap for the predicted window
                qpos = self._quantized_update_pos(px, py)
                rock_keys = self._rock_keys(qpos)
                cm = self._build_costmap(block_xy=key,
                                         obstacles=self._rocks_for(qpos))
                self._staged = (key, rock_keys, cm)
            except Exception as e:  # raised by _join_prestage
                self._prestage_error = e

        self._prestage_thread = threading.Thread(target=work, daemon=True)
        self._prestage_thread.start()

    def _prestage_inline(self, wx: float, wy: float, hx: float, hy: float):
        """Synchronous pre-staging for the pipelined path — runs ON the
        terrain worker thread (already background), so no nested thread and
        no shared-RNG race. Same predictor as :meth:`_maybe_prestage`: when
        the heading lookahead crosses into a new center block, stage the
        shifted window inside the streamer and the costmap for the
        predicted anchor."""
        pred = self._predict_crossing(wx, wy, hx, hy)
        if pred is None:
            return
        key, new_anchor, px, py = pred
        self.lstm.map_manager.streamer.prestage_shift(new_anchor)
        if self._staged is not None and self._staged[0] == key:
            return
        qpos = self._quantized_update_pos(px, py)
        rock_keys = self._rock_keys(qpos)
        cm = self._build_costmap(block_xy=key,
                                 obstacles=self._rocks_for(qpos))
        self._staged = (key, rock_keys, cm)

    # -- pipelined shift events (worker -> main) -------------------------------

    def _prepare_shift_event(self, bx, by, upd_pos) -> dict:
        """Everything the main thread needs to re-seat after a block shift,
        assembled ON the worker thread (costmap build touches rocks_data and
        the rock DB): the shifted window reference, the costmap (pre-staged
        when anchor + rock-region keys match — bit-identical to the rebuild
        by seed-determinism), and phase timings."""
        t0 = time.perf_counter()
        staged = self._staged
        self._staged = None
        hit = (staged is not None and staged[0] == (bx, by)
               and staged[1] == self._rock_keys(upd_pos))
        if hit:
            cm = staged[2]
            if self.conf.verify_prestage:
                sync = self._build_costmap(block_xy=(bx, by))
                np.testing.assert_array_equal(
                    np.asarray(staged[2].cost), np.asarray(sync.cost),
                    err_msg="staged costmap != synchronous rebuild",
                )
        else:
            cm = self._build_costmap(block_xy=(bx, by))
        return {
            "bx": bx,
            "by": by,
            "window": self.lstm.map_manager.streamer.window,
            "costmap": cm,
            "hit": bool(hit),
            "costmap_s": round(time.perf_counter() - t0, 3),
        }

    def _apply_shift_event(self, ev: dict, state: LoopState, goal_ctrl):
        """Main-thread half of a pipelined block shift: pure host re-seating
        plus one device rebase of the (possibly still in-flight) state — a
        pointer swap, never a blocking wait."""
        t0 = time.perf_counter()
        bx, by = ev["bx"], ev["by"]
        shift_x = bx - self.block_x
        shift_y = by - self.block_y
        self.block_x, self.block_y = bx, by
        self.frame = frames.BlockFrame(
            block_x=jnp.asarray(bx, jnp.float32),
            block_y=jnp.asarray(by, jnp.float32),
            half_block=jnp.asarray(self.half_block, jnp.float32),
        )
        self.hf = HeightField.create(ev["window"], self.window_half)
        self.costmap = ev["costmap"]
        if ev["hit"]:
            self.prestage_hits += 1
        else:
            self.prestage_misses += 1
        sx = jnp.asarray(shift_x, jnp.float32)
        sy = jnp.asarray(shift_y, jnp.float32)
        new_pos = frames.rebase_on_shift(state.rovers.position, sx, sy)
        state = state._replace(rovers=state.rovers._replace(position=new_pos))
        goal_ctrl = frames.rebase_on_shift(goal_ctrl, sx, sy)
        self.shift_phase_log.append({
            "hit": ev["hit"],
            "reseat_s": 0.0,
            "costmap_s": ev["costmap_s"] if not ev["hit"] else 0.0,
            "rebase_s": round(time.perf_counter() - t0, 3),
        })
        return state, goal_ctrl

    # -- block-shift rebasing (:546-576) ---------------------------------------

    def _on_block_shift(self, state: LoopState, goal_ctrl,
                        update_pos=None) -> tuple:
        bx, by = self.lstm.get_hr_map_current_block_coordinates()
        shift_x = bx - self.block_x
        shift_y = by - self.block_y
        self.block_x, self.block_y = bx, by
        self.frame = frames.BlockFrame(
            block_x=jnp.asarray(bx, jnp.float32),
            block_y=jnp.asarray(by, jnp.float32),
            half_block=jnp.asarray(self.half_block, jnp.float32),
        )
        # re-seat the controller on the live window + rebuilt costmap,
        # reusing the pre-staged costmap when its anchor AND rock-region
        # keys match what the synchronous rebuild would use (bit-identical
        # by construction — rock blocks are seed-deterministic)
        t0 = time.perf_counter()
        self.hf = self._window_heightfield()
        staged = self._staged
        self._staged = None
        t1 = time.perf_counter()
        hit = (staged is not None and staged[0] == (bx, by)
               and update_pos is not None
               and staged[1] == self._rock_keys(update_pos))
        if hit:
            self.costmap = staged[2]
            self.prestage_hits += 1
            if self.conf.verify_prestage:
                sync = self._build_costmap()
                np.testing.assert_array_equal(
                    np.asarray(staged[2].cost), np.asarray(sync.cost),
                    err_msg="staged costmap != synchronous rebuild",
                )
        else:
            self.costmap = self._build_costmap()
            self.prestage_misses += 1
        t2 = time.perf_counter()
        self.shift_phase_log.append({
            "hit": bool(hit),
            "reseat_s": round(t1 - t0, 3),
            "costmap_s": round(t2 - t1, 3),
        })
        # rebase controller-frame points by (-dy, +dx) (:569-575)
        sx = jnp.asarray(shift_x, jnp.float32)
        sy = jnp.asarray(shift_y, jnp.float32)
        new_pos = frames.rebase_on_shift(state.rovers.position, sx, sy)
        state = state._replace(rovers=state.rovers._replace(position=new_pos))
        goal_ctrl = frames.rebase_on_shift(goal_ctrl, sx, sy)
        return state, goal_ctrl, (shift_x, shift_y)

    # -- checkpoint / resume ---------------------------------------------------

    def save_checkpoint(self, path, state: LoopState, chunk_idx: int,
                        steps: int, path_world, counts=None) -> None:
        """Serialize the traverse through :mod:`..aux.checkpoint`: loop
        state, costmap, crater metadata + the crater RNG stream, and frame/
        cascade cursors. Without deformation the window itself is NOT
        stored — it is bit-reproducible from the restored crater metadata
        (test_streamer_roll_shift_matches_full_rebuild pins roll==rebuild),
        which keeps reference-scale checkpoints small and avoids a ~200 MB
        device-to-host transfer. With deformation the window + pass counts
        carry wheel-track history and are stored verbatim."""
        from ..aux import checkpoint as ckpt

        streamer = self.lstm.map_manager.streamer
        craters = {
            f"{bx}|{by}": {
                "c": np.asarray(blk[0], np.float64).reshape(-1, 2),
                "r": np.asarray(blk[1], np.float64).reshape(-1),
            }
            for (bx, by), blk in streamer.crater_blocks.items()
        }
        payload = {
            "state": jax.device_get(state),
            "costmap": jax.device_get(self.costmap),
            "craters": craters,
            "path": np.asarray(path_world, np.float64).reshape(-1, 2),
        }
        if self.deform_engine is not None:
            payload["window"] = np.asarray(jax.device_get(streamer.window))
            payload["counts"] = np.asarray(jax.device_get(counts))
        lu = self.lstm.last_update_coordinates or (0.0, 0.0)
        rp = getattr(self.lstm, "_last_rocks_position", None)
        meta = {
            "chunk_idx": int(chunk_idx),
            "steps": int(steps),
            "block_x": float(self.block_x),
            "block_y": float(self.block_y),
            "anchor": [int(a) for a in streamer.anchor],
            "last_update": [float(v) for v in lu],
            "rocks_pos": [float(v) for v in rp] if rp is not None else None,
            "rng_state": streamer.rng.bit_generator.state,
            "crater_counts": {k: int(v["r"].shape[0])
                              for k, v in craters.items()},
            "path_len": int(np.asarray(payload["path"]).shape[0]),
            "prestage_hits": self.prestage_hits,
            "prestage_misses": self.prestage_misses,
            "has_window": self.deform_engine is not None,
        }
        ckpt.save(path, payload, meta)

    @classmethod
    def resume(cls, conf: LargeScaleLoopConf, path):
        """Rebuild a loop from a checkpoint. Returns ``(loop, resume_info)``;
        pass the info to :meth:`run` as ``_resume`` to continue the
        traverse — on the synchronous path bit-identically to the
        uninterrupted run (terrain blocks are seed-deterministic, the
        crater RNG stream is restored, and the window re-composes exactly
        from the restored metadata)."""
        from ..aux import checkpoint as ckpt

        meta = ckpt.load_metadata(path)
        loop = cls(conf)
        streamer = loop.lstm.map_manager.streamer
        state0 = loop._initial_state()
        template = {
            "state": jax.device_get(state0),
            "costmap": jax.device_get(loop.costmap),
            "craters": {
                k: {"c": np.zeros((n, 2), np.float64),
                    "r": np.zeros((n,), np.float64)}
                for k, n in meta["crater_counts"].items()
            },
            "path": np.zeros((meta["path_len"], 2), np.float64),
        }
        if meta["has_window"]:
            w = streamer.window
            template["window"] = np.zeros(w.shape, np.float32)
            template["counts"] = np.zeros(w.shape, np.int32)
        payload, meta = ckpt.restore(path, template)

        streamer.crater_blocks = {
            tuple(int(v) for v in k.split("|")): (
                np.asarray(payload["craters"][k]["c"]),
                np.asarray(payload["craters"][k]["r"]),
            )
            for k in payload["craters"]
        }
        streamer.rng.bit_generator.state = meta["rng_state"]
        streamer._staged_shift = None
        anchor = tuple(meta["anchor"])
        if meta["has_window"]:
            streamer.anchor = anchor
            streamer.window = jnp.asarray(payload["window"])
        elif streamer.anchor != anchor:
            # deterministic re-compose at the saved anchor from the
            # restored crater metadata (full-rebuild path)
            n_off = streamer.conf.num_blocks + 1
            bs = streamer.conf.block_size
            streamer.anchor = None
            streamer.update(((anchor[0] + n_off) * bs + bs / 2.0,
                             (anchor[1] + n_off) * bs + bs / 2.0))
            assert streamer.anchor == anchor, (streamer.anchor, anchor)

        loop.block_x = meta["block_x"]
        loop.block_y = meta["block_y"]
        loop.frame = frames.BlockFrame(
            block_x=jnp.asarray(loop.block_x, jnp.float32),
            block_y=jnp.asarray(loop.block_y, jnp.float32),
            half_block=jnp.asarray(loop.half_block, jnp.float32),
        )
        loop.hf = loop._window_heightfield()
        loop.costmap = payload["costmap"]
        loop.lstm.last_update_coordinates = tuple(meta["last_update"])
        loop.prestage_hits = meta["prestage_hits"]
        loop.prestage_misses = meta["prestage_misses"]
        if meta["rocks_pos"] is not None:
            # rocks_data re-assembles from the seed-keyed DB cache
            rp = tuple(meta["rocks_pos"])
            rocks_data = []
            for sampler in loop.lstm.rock_samplers:
                blk = sampler.sample_region(
                    rp, block_span=conf.terrain.rock_block_span)
                rocks_data.append(blk.coordinates)
                rocks_data.append(blk.scale)
            loop.lstm.rocks_data = rocks_data
            loop.lstm._last_rocks_position = rp
        resume_info = {
            "state": jax.tree.map(jnp.asarray, payload["state"]),
            "chunk_idx": meta["chunk_idx"],
            "steps": meta["steps"],
            "path": [tuple(p) for p in np.asarray(payload["path"])],
        }
        if meta["has_window"]:
            resume_info["counts"] = jnp.asarray(payload["counts"])
        return loop, resume_info

    # -- main loop (:466-576) ---------------------------------------------------

    def measure_device_rate(self, chunks: int = 20) -> float:
        """Pure device-compute rate of the streamed chunk program in sim
        steps/s: dispatch ``chunks`` chunks back-to-back with no host
        readback between them and block once at the end. The gap between
        this and the ``run()`` wall rate is the per-chunk host readback and
        terrain bookkeeping. Advances the loop state (call after ``run()``)."""
        conf = self.conf
        streamer = self.lstm.map_manager.streamer
        state = getattr(self, "last_state", None)
        if state is None:
            state = self._initial_state()
        goal_ctrl = self._goal_ctrl()
        key = jax.random.key(conf.seed + 1)
        window = streamer.window
        counts = (jnp.zeros_like(window, jnp.int32)
                  if self.deform_engine is not None
                  else jnp.zeros((1, 1), jnp.int32))
        frame_ox = jnp.asarray(float(self.block_x) + self.half_block,
                               jnp.float32)
        frame_oy = jnp.asarray(float(self.block_y) + self.half_block,
                               jnp.float32)
        wox, woy = streamer.window_origin()
        if self.deform_engine is not None:
            def call(i, state):
                nonlocal window, counts
                window, counts, state, *outs = self._chunk_fn(
                    window, counts, self.costmap, goal_ctrl, state, key,
                    np.int32(i), frame_ox, frame_oy,
                    jnp.asarray(wox, jnp.float32),
                    jnp.asarray(woy, jnp.float32))
                return state, outs
        else:
            def call(i, state):
                state, *outs = self._chunk_fn(
                    window, self.costmap, goal_ctrl, state, key,
                    np.int32(i), frame_ox, frame_oy)
                return state, outs

        # warm (compile already cached from run())
        state, outs = call(0, state)
        jax.block_until_ready(outs[-1])
        t0 = time.perf_counter()
        for i in range(1, chunks + 1):
            state, outs = call(i, state)
        jax.block_until_ready(outs[-1])
        dt = time.perf_counter() - t0
        streamer.window = window
        return chunks * conf.terrain_check_every / dt

    def run(self, record_path: bool = True,
            _resume: Optional[dict] = None) -> LargeScaleRunResult:
        """Drive the rover to the goal. The default path pipelines the
        per-chunk pose readback; deformation runs
        the synchronous loop — its donated window chain requires the
        streamer roll to happen between chunks. ``_resume`` is the info
        dict from :meth:`resume`."""
        if self.deform_engine is not None or self.conf.pipeline_depth <= 0:
            return self._run_sync(record_path, _resume)
        return self._run_pipelined(record_path, _resume)

    def _run_pipelined(self, record_path: bool = True,
                       _resume: Optional[dict] = None) -> LargeScaleRunResult:
        """Lag-tolerant streamed loop: keep ``pipeline_depth`` chunks in
        flight and consume poses ``depth`` chunks late. Correctness under
        lag: the goal stop box freezes the state ON DEVICE every sim step
        (scan_and_pose), terrain updates gate on 2 m of travel (>= 4x the
        lag distance), the window covers the rover +-87.5 m at reference
        scale, and a block shift is pure re-seating — in-flight chunks
        keep computing in the old (self-consistent) frame whose output
        world poses are frame-independent; the state future is rebased
        exactly once when the event applies. Matches the wall-rate role of
        the reference's realtime 60 Hz loop
        (cfg/environment/largescale.yaml:3-5) without per-chunk stalls."""
        conf = self.conf
        streamer = self.lstm.map_manager.streamer
        # chunks keep the pre-shift window alive as an input while the
        # worker composes the shifted one — never donate it
        streamer.donate_shifts = False
        state = self._initial_state()
        goal_ctrl = self._goal_ctrl()
        key = jax.random.key(conf.seed)
        window = streamer.window
        n = conf.terrain_check_every

        path: List[tuple] = []
        shift_latencies: List[float] = []
        costmap_rebuilds = 0
        block_shifts = 0
        reached = False
        processed_steps = 0
        steady_after = 240
        t_steady = None
        steps_at_steady = 0
        acc = {"dispatch_s": 0.0, "fetch_s": 0.0, "terrain_s": 0.0,
               "prestage_s": 0.0, "shift_s": 0.0}
        self.chunk_phase_acc = acc
        worker = _TerrainWorker(self)
        ready: deque = deque()   # (chunk_idx, scalar-output futures)
        chunk_idx = 0
        dispatched_steps = 0
        if _resume:
            state = _resume["state"]
            chunk_idx = _resume["chunk_idx"]
            dispatched_steps = processed_steps = _resume["steps"]
            path = list(_resume["path"]) if record_path else []
        last_ckpt = dispatched_steps
        t0 = time.perf_counter()

        def apply_events():
            nonlocal state, goal_ctrl, window, block_shifts, costmap_rebuilds
            for ev in worker.pop_events():
                t_s = time.perf_counter()
                state, goal_ctrl = self._apply_shift_event(
                    ev, state, goal_ctrl)
                window = ev["window"]
                block_shifts += 1
                costmap_rebuilds += 1
                dt = time.perf_counter() - t_s
                shift_latencies.append(dt)
                acc["shift_s"] += dt

        def process(ci, sc) -> bool:
            """Fetch + consume one matured chunk; True when the goal box
            latched inside it."""
            nonlocal processed_steps, t_steady, steps_at_steady
            t_b = time.perf_counter()
            wx, wy, hx, hy, reached_f = map(float, jax.device_get(sc))
            acc["fetch_s"] += time.perf_counter() - t_b
            if not reached:  # chunks after the goal latch are frozen
                processed_steps = (ci + 1) * n
            if t_steady is None and processed_steps >= steady_after:
                t_steady = time.perf_counter()
                steps_at_steady = processed_steps
            if record_path and not reached:  # drop frozen duplicate poses
                path.append((wx, wy))
            if reached_f:
                return True
            worker.submit((wx, wy, hx, hy))
            return False

        try:
            while dispatched_steps < conf.max_steps:
                if worker.error is not None:
                    raise worker.error
                apply_events()
                t_a = time.perf_counter()
                frame_ox = jnp.asarray(
                    float(self.block_x) + self.half_block, jnp.float32)
                frame_oy = jnp.asarray(
                    float(self.block_y) + self.half_block, jnp.float32)
                state, wx_d, wy_d, hx_d, hy_d, reached_d = self._chunk_fn(
                    window, self.costmap, goal_ctrl, state, key,
                    np.int32(chunk_idx), frame_ox, frame_oy,
                )
                scalars = (wx_d, wy_d, hx_d, hy_d, reached_d)
                for s in scalars:  # start the host transfers now; they
                    s.copy_to_host_async()  # are read `depth` chunks later
                ready.append((chunk_idx, scalars))
                chunk_idx += 1
                dispatched_steps += n
                acc["dispatch_s"] += time.perf_counter() - t_a
                if len(ready) <= conf.pipeline_depth:
                    continue
                if process(*ready.popleft()):
                    reached = True
                    break
                if (conf.checkpoint_every_steps and conf.checkpoint_path
                        and processed_steps - last_ckpt
                        >= conf.checkpoint_every_steps):
                    # settle to a consistent snapshot: drain in-flight
                    # chunks and the terrain worker first
                    while ready:
                        if process(*ready.popleft()):
                            reached = True
                    if reached:
                        break
                    worker.drain()
                    if worker.error is not None:
                        # never clobber the last good checkpoint with a
                        # torn snapshot — the worker thread may have died
                        # mid-cascade with streamer state half-mutated
                        raise worker.error
                    apply_events()
                    self.save_checkpoint(conf.checkpoint_path, state,
                                         chunk_idx, dispatched_steps, path)
                    last_ckpt = processed_steps
            # drain the pipeline: remaining poses (frozen after the goal
            # box), then trailing terrain events so the final seating
            # matches the streamer
            while ready:
                ci, sc = ready.popleft()
                if process(ci, sc):
                    reached = True
            worker.drain()
            if worker.error is not None:
                raise worker.error
            apply_events()
        finally:
            worker.stop()
            acc["terrain_s"] += worker.terrain_s
            acc["prestage_s"] += worker.prestage_s

        wall = time.perf_counter() - t0
        self.hf = self._window_heightfield()
        self.last_state = state
        wx, wy = self._world_position(state)
        start = np.asarray(conf.start, np.float64)
        goal_w = np.asarray(conf.goal, np.float64)
        return LargeScaleRunResult(
            reached=reached,
            steps=processed_steps,
            block_shifts=block_shifts,
            distance_m=float(np.linalg.norm(goal_w - start)),
            final_position=(wx, wy),
            wall_s=wall,
            shift_latencies_s=shift_latencies,
            costmap_rebuilds=costmap_rebuilds,
            path_world=np.asarray(path) if path else np.zeros((0, 2)),
            steady_steps=(processed_steps - steps_at_steady)
            if t_steady else 0,
            steady_wall_s=(time.perf_counter() - t_steady)
            if t_steady else 0.0,
            prestage_hits=self.prestage_hits,
            prestage_misses=self.prestage_misses,
        )

    def _run_sync(self, record_path: bool = True,
                  _resume: Optional[dict] = None) -> LargeScaleRunResult:
        conf = self.conf
        streamer = self.lstm.map_manager.streamer
        state = self._initial_state()
        goal_ctrl = self._goal_ctrl()
        key = jax.random.key(conf.seed)
        window = streamer.window
        if self.deform_engine is not None:
            counts = jnp.zeros_like(window, jnp.int32)
        else:
            counts = jnp.zeros((1, 1), jnp.int32)  # static no-deform branch

        path: List[tuple] = []
        shift_latencies: List[float] = []
        costmap_rebuilds = 0
        block_shifts = 0
        steps = 0
        reached = False
        chunk_idx = 0
        if _resume:
            state = _resume["state"]
            chunk_idx = _resume["chunk_idx"]
            steps = _resume["steps"]
            path = list(_resume["path"]) if record_path else []
            if self.deform_engine is not None and "counts" in _resume:
                counts = _resume["counts"]
        last_ckpt = steps
        t0 = time.perf_counter()
        goal_w = np.asarray(conf.goal, np.float64)
        steady_after = 240  # sim steps of warmup before steady-state timing
        t_steady = None
        steps_at_steady = 0
        # per-chunk host-side phase accumulators (rate decomposition)
        acc = {"dispatch_s": 0.0, "fetch_s": 0.0, "terrain_s": 0.0,
               "prestage_s": 0.0, "shift_s": 0.0}
        self.chunk_phase_acc = acc
        while steps < conf.max_steps:
            if t_steady is None and steps >= steady_after:
                t_steady = time.perf_counter()
                steps_at_steady = steps
            t_a = time.perf_counter()
            frame_ox = jnp.asarray(float(self.block_x) + self.half_block,
                                   jnp.float32)
            frame_oy = jnp.asarray(float(self.block_y) + self.half_block,
                                   jnp.float32)
            if self.deform_engine is not None:
                wox, woy = streamer.window_origin()
                window, counts, state, wx_d, wy_d, hx_d, hy_d, reached_d = (
                    self._chunk_fn(
                        window, counts, self.costmap, goal_ctrl, state, key,
                        np.int32(chunk_idx), frame_ox, frame_oy,
                        jnp.asarray(wox, jnp.float32),
                        jnp.asarray(woy, jnp.float32),
                    )
                )
                streamer.window = window  # live deformed heights
            else:
                state, wx_d, wy_d, hx_d, hy_d, reached_d = self._chunk_fn(
                    window, self.costmap, goal_ctrl, state, key,
                    np.int32(chunk_idx), frame_ox, frame_oy,
                )
            steps += conf.terrain_check_every
            chunk_idx += 1
            t_b = time.perf_counter()
            # the single host<->device round-trip of the interval
            wx, wy, hx, hy, reached_f = map(float, jax.device_get(
                (wx_d, wy_d, hx_d, hy_d, reached_d)))
            t_c = time.perf_counter()
            acc["dispatch_s"] += t_b - t_a
            acc["fetch_s"] += t_c - t_b
            if record_path:
                path.append((wx, wy))
            if reached_f:
                reached = True
                break

            # terrain cascade (update gate lives inside the orchestrator)
            local = (wx - conf.terrain.starting_position[0],
                     wy - conf.terrain.starting_position[1])
            # Will this update shift the streamer? Derive the guard from the
            # SAME 2 m-quantized corrected position the streamer will
            # re-anchor on (ADVICE r04: the raw position's block can lie one
            # block ahead of the corrected one when traveling in -x/-y, so a
            # raw-block guard could run the shift concurrently with a live
            # pre-stage thread sharing the crater RNG). If so, settle any
            # in-flight background staging first.
            if self._would_shift(local):
                self._join_prestage()
            updated, corrected = self.lstm.update_visual_mesh(local)
            acc["terrain_s"] += time.perf_counter() - t_c

            bx, by = self.lstm.get_hr_map_current_block_coordinates()
            if (bx, by) != (self.block_x, self.block_y):
                t_shift = time.perf_counter()
                upd_pos = (self.lstm._to_global(corrected)
                           if updated else (wx, wy))
                state, goal_ctrl, shift = self._on_block_shift(
                    state, goal_ctrl, update_pos=upd_pos)
                window = streamer.window  # rolled + fresh-band window
                if self.deform_engine is not None:
                    # roll the pass counts with the window so carried-over
                    # blocks keep their per-pixel decay state (matching
                    # deformation_engine.py:695-721 semantics); only the
                    # newly-exposed band resets
                    res = streamer.conf.resolution
                    counts = _roll_pass_counts(
                        counts,
                        int(round(shift[0] / res)),
                        int(round(shift[1] / res)),
                    )
                # NO block_until_ready here: with pre-staged windows and
                # costmaps the shift is a pointer swap and the loop never
                # waits — the next chunk queues behind any residual device
                # work, whose cost lands honestly in that chunk's fetch
                # time.
                self.shift_phase_log[-1]["rebase_s"] = round(
                    time.perf_counter() - t_shift
                    - self.shift_phase_log[-1]["reseat_s"]
                    - self.shift_phase_log[-1]["costmap_s"], 3)
                shift_latencies.append(time.perf_counter() - t_shift)
                acc["shift_s"] += time.perf_counter() - t_shift
                costmap_rebuilds += 1
                block_shifts += 1
            elif conf.prestage_shifts:
                t_p = time.perf_counter()
                self._maybe_prestage(wx, wy, hx, hy)
                acc["prestage_s"] += time.perf_counter() - t_p

            if (conf.checkpoint_every_steps and conf.checkpoint_path
                    and steps - last_ckpt >= conf.checkpoint_every_steps):
                self._join_prestage()
                self.save_checkpoint(
                    conf.checkpoint_path, state, chunk_idx, steps, path,
                    counts=counts if self.deform_engine is not None
                    else None)
                last_ckpt = steps

        wall = time.perf_counter() - t0
        streamer.window = window
        self.hf = self._window_heightfield()
        self.last_state = state  # exposed for tests / introspection
        wx, wy = self._world_position(state)
        start = np.asarray(conf.start, np.float64)
        return LargeScaleRunResult(
            reached=reached,
            steps=steps,
            block_shifts=block_shifts,
            distance_m=float(np.linalg.norm(goal_w - start)),
            final_position=(wx, wy),
            wall_s=wall,
            shift_latencies_s=shift_latencies,
            costmap_rebuilds=costmap_rebuilds,
            path_world=np.asarray(path) if path else np.zeros((0, 2)),
            steady_steps=steps - steps_at_steady if t_steady else 0,
            steady_wall_s=(time.perf_counter() - t_steady) if t_steady else 0.0,
            prestage_hits=self.prestage_hits,
            prestage_misses=self.prestage_misses,
        )
