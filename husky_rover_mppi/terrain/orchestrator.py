"""Large-scale terrain orchestrator — a re-design of
``src/terrain_management/large_scale_terrain_manager.py`` (:31-257).

The reference builds MapManager + NestedGeometryClipmapManager +
ColliderManager + RockManager from one flat conf (``LargeScaleTerrainConf``,
src/configurations/environments.py:126-290) and runs the update cascade
``update_visual_mesh(coords)`` every ``update_every_n_meters``: blocking
HR-DEM update -> clipmap DEM re-upload + clipmap update -> rock sample
(accumulating ``rocks_data`` for the MPPI costmap) -> collider shift.

Here the same cascade composes the repo's device-native pieces:

* HR DEM: :class:`~.map_manager.MapManager` /
  :class:`~.streaming.TerrainStreamer` (jitted block builds, rolled window);
* clipmaps: :class:`~.clipmap.NestedClipmap` re-seated on the live window;
* rocks: one :class:`~.rocks.RockSampler` per size class querying the
  streamer for height + tangent orientation, accumulating ``rocks_data`` as
  ``[positions, scales]`` pairs exactly as ``RockManager.sample`` does
  (rock_manager.py:702-737) so ``extract_rocks_data`` semantics carry over;
* colliders: :class:`~.collider.ColliderManager` window off the streamer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from .clipmap import Clipmap, ClipmapSpec, NestedClipmap
from .collider import ColliderConf, ColliderManager
from .craters import CraterSamplerConf
from .map_manager import MapManager, MapManagerConf
from .rocks import RockDistConf, RockSampler
from .streaming import StreamerConf


def _default_rock_cfgs() -> Tuple[RockDistConf, ...]:
    """The two rock size classes of the full-stack demo
    (visual_terrain_stack_full_terrain.py:79-111 RSCfg_3_D / RSCfg_4_D)."""
    return (
        RockDistConf(parent_density=0.003, child_density=4.0, sigma=4.5,
                     scale_min=0.5, scale_max=1.0, block_size=25.0, seed=67),
        RockDistConf(parent_density=0.004, child_density=3.0, sigma=8.5,
                     scale_min=1.0, scale_max=2.0, block_size=25.0, seed=67),
    )


@dataclasses.dataclass
class LargeScaleConf:
    """Flat user-facing configuration, mirroring the key grammar of
    ``LargeScaleTerrainConf`` (src/configurations/environments.py:126-290)
    and the full-stack demo's ``LSTCfg_D``
    (visual_terrain_stack_full_terrain.py:151-203). ``__post_init__``
    expands the flat keys into the nested manager confs, like the
    reference's ``MMConf_D``/``NGCMMConf_D``/``RMConf_D``/``CMConf_D``."""

    seed: int = 42
    crater_gen_seed: int = 57
    update_every_n_meters: float = 2.0
    z_scale: float = 1.0
    block_size: float = 25.0
    hr_dem_resolution: float = 0.025
    hr_dem_num_blocks: int = 2
    hr_dem_generate_craters: bool = True
    crater_gen_densities: Tuple[float, ...] = (0.025, 0.05, 0.5)
    crater_gen_radius: Tuple[Tuple[float, float], ...] = (
        (1.5, 2.5), (0.75, 1.5), (0.25, 0.5))
    crater_gen_padding: float = 10.0
    crater_gen_min_xy_ratio: float = 0.85
    crater_gen_max_xy_ratio: float = 1.0
    crater_gen_num_unique_profiles: int = 10000
    lr_dem_folder: Optional[str] = None   # None -> synthetic LOLA stand-in
    lr_pixel_size: float = 5.0
    starting_position: Tuple[float, float] = (0.0, 0.0)
    # clipmaps (geo_cm_* keys)
    geo_cm_num_lods: int = 4
    geo_cm_num_texels_per_level: int = 64
    # collider window
    terrain_collider_enabled: bool = True
    terrain_collider_resolution: float = 0.25
    terrain_collider_cache_size: int = 16
    terrain_collider_build_radius: float = 12.0
    # rocks
    rock_gen_cfgs: Tuple[RockDistConf, ...] = dataclasses.field(
        default_factory=_default_rock_cfgs)
    rock_block_span: int = 2
    profiling: bool = False
    # Defer collider-mesh builds to export time (ensure_colliders). The
    # reference must build them eagerly every update because PhysX consumes
    # them each tick; here the rover rides the heightfield directly and the
    # collider window is an export surface (collider.py module docstring) —
    # eager builds only buy ~2-5 height-query host round-trips per 2 m.
    # False restores the reference's eager cadence.
    collider_lazy: bool = True

    def __post_init__(self) -> None:
        assert self.update_every_n_meters > 0
        assert self.block_size > 0 and self.hr_dem_resolution > 0
        self.streamer_conf = StreamerConf(
            block_size=self.block_size,
            resolution=self.hr_dem_resolution,
            lr_resolution=self.lr_pixel_size,
            num_blocks=self.hr_dem_num_blocks,
            pad_size=self.crater_gen_padding,
            z_scale=self.z_scale,
            seed=self.crater_gen_seed,
            generate_craters=self.hr_dem_generate_craters,
            crater=CraterSamplerConf(
                densities=tuple(self.crater_gen_densities),
                radius_ranges=tuple(tuple(r) for r in self.crater_gen_radius),
                min_xy_ratio=self.crater_gen_min_xy_ratio,
                max_xy_ratio=self.crater_gen_max_xy_ratio,
                seed=self.crater_gen_seed,
            ),
        )
        self.map_conf = MapManagerConf(
            folder_path=self.lr_dem_folder,
            lr_pixel_size=self.lr_pixel_size,
            seed=self.seed,
            streamer=self.streamer_conf,
        )
        self.collider_conf = ColliderConf(
            resolution=self.terrain_collider_resolution,
            build_radius=self.terrain_collider_build_radius,
            drop_radius=2.0 * self.terrain_collider_build_radius,
            cache_size=self.terrain_collider_cache_size,
        )
        self.rock_gen_cfgs = tuple(
            c if isinstance(c, RockDistConf) else RockDistConf(**c)
            for c in self.rock_gen_cfgs
        )


class LargeScaleTerrainManager:
    """One conf-driven object composing streamer + nested clipmap + collider
    + rock sampling with the reference's update cascade
    (large_scale_terrain_manager.py:182-257)."""

    def __init__(self, settings: LargeScaleConf,
                 is_simulation_alive=lambda: True,
                 close_simulation=lambda: None):
        self.settings = settings
        self.is_simulation_alive = is_simulation_alive
        self.close_simulation = close_simulation
        self.last_update_coordinates: Optional[Tuple[float, float]] = None
        self.rocks_data: List[np.ndarray] = []
        # cascade sub-phase accumulators (bench.py detail)
        self.cascade_phase_acc = {"streamer_s": 0.0, "clipmap_s": 0.0,
                                  "rocks_s": 0.0, "collider_s": 0.0,
                                  "updates": 0}
        self.map_manager: Optional[MapManager] = None
        self.nested_clipmap: Optional[NestedClipmap] = None
        self.collider_manager: Optional[ColliderManager] = None
        self.rock_samplers: List[RockSampler] = []

    # -- build (large_scale_terrain_manager.py:182-186) ----------------------

    def build(self) -> None:
        import time as _time

        acc = {}
        t0 = _time.perf_counter()
        self._build_map_manager()
        acc["map_manager_s"] = _time.perf_counter() - t0
        t0 = _time.perf_counter()
        self._build_clipmaps()
        self._build_collider_manager()
        self._build_rock_samplers()
        acc["managers_s"] = _time.perf_counter() - t0
        t0 = _time.perf_counter()
        self.update_visual_mesh((0.0, 0.0))
        acc["first_update_s"] = _time.perf_counter() - t0
        # phase breakdown surfaced in bench.py detail
        self.build_phase_acc = {k: round(v, 2) for k, v in acc.items()}

    def _build_map_manager(self) -> None:
        self.map_manager = MapManager(self.settings.map_conf)
        self.map_manager.initialize_hr_dem(self.settings.starting_position)

    def _build_clipmaps(self) -> None:
        s = self.settings
        streamer = self.map_manager.streamer
        fine = Clipmap(
            ClipmapSpec(num_lods=s.geo_cm_num_lods,
                        ring_size=s.geo_cm_num_texels_per_level,
                        resolution=s.hr_dem_resolution),
            streamer.window,
            origin=streamer.window_origin(),
            source_resolution=s.hr_dem_resolution,
        )
        lr = self.map_manager.lr_dem
        h, w = lr.shape
        coarse = Clipmap(
            ClipmapSpec(num_lods=s.geo_cm_num_lods,
                        ring_size=s.geo_cm_num_texels_per_level,
                        resolution=s.lr_pixel_size),
            lr,
            origin=(-(h // 2) * s.lr_pixel_size, -(w // 2) * s.lr_pixel_size),
            source_resolution=s.lr_pixel_size,
        )
        self.nested_clipmap = NestedClipmap(fine, coarse)

    def _build_collider_manager(self) -> None:
        if not self.settings.terrain_collider_enabled:
            self.collider_manager = None
            return
        self.collider_manager = ColliderManager(
            self.settings.collider_conf, self.map_manager.streamer
        )

    def _build_rock_samplers(self) -> None:
        self.rock_samplers = [
            RockSampler(cfg, self.map_manager.streamer)
            for cfg in self.settings.rock_gen_cfgs
        ]

    # -- queries (large_scale_terrain_manager.py:95-170) ---------------------

    def _to_global(self, coordinates) -> Tuple[float, float]:
        sp = self.settings.starting_position
        return (coordinates[0] + sp[0], coordinates[1] + sp[1])

    def get_height_local(self, coordinates) -> float:
        return float(self.map_manager.get_height(*self._to_global(coordinates)))

    def get_height_global(self, coordinates) -> float:
        return float(self.map_manager.get_height(*coordinates))

    def get_normal_local(self, coordinates) -> np.ndarray:
        return np.asarray(self.map_manager.get_normal(*self._to_global(coordinates)))

    def get_normal_global(self, coordinates) -> np.ndarray:
        return np.asarray(self.map_manager.get_normal(*coordinates))

    def get_hr_map_current_block_coordinates(self) -> Tuple[float, float]:
        """World SW corner of the window's *center* block — what the
        full-stack demo reads to anchor the controller frame
        (map_manager.get_hr_map_current_block_coordinates,
        visual_terrain_stack_full_terrain.py:432)."""
        streamer = self.map_manager.streamer
        n = streamer.conf.num_blocks + 1
        bs = streamer.conf.block_size
        return ((streamer.anchor[0] + n) * bs, (streamer.anchor[1] + n) * bs)

    # -- update cascade (large_scale_terrain_manager.py:188-257) -------------

    def update_visual_mesh(self, local_coordinates):
        """The reference's per-sim-tick update: gate on
        ``update_every_n_meters`` of travel, then HR-DEM shift -> clipmap
        re-seat + update -> rock sample (rocks_data rebuild) -> collider
        shift. Returns ``(updated, corrected_coordinates)``."""
        s = self.settings
        if self.last_update_coordinates is None:
            dist = s.update_every_n_meters * 2
            self.last_update_coordinates = tuple(local_coordinates)
        else:
            dx = local_coordinates[0] - self.last_update_coordinates[0]
            dy = local_coordinates[1] - self.last_update_coordinates[1]
            dist = math.sqrt(dx * dx + dy * dy)
        if dist <= s.update_every_n_meters:
            return False, (0, 0)

        # cast to a multiple of the threshold (:204-206)
        q = s.update_every_n_meters
        corrected = ((local_coordinates[0] // q) * q,
                     (local_coordinates[1] // q) * q)
        self.last_update_coordinates = tuple(local_coordinates)
        global_corrected = self._to_global(corrected)
        streamer = self.map_manager.streamer
        import time as _time

        acc = self.cascade_phase_acc
        acc["updates"] += 1
        t0 = _time.perf_counter()

        # 1. HR-DEM shift (blocking in the reference; async device work here)
        shifted = self.map_manager.update(global_corrected)
        t1 = _time.perf_counter()

        # 2. clipmap DEM re-upload on shift + per-update clipmap sampling
        if shifted:
            self.nested_clipmap.fine.update_dem(
                streamer.window, streamer.window_origin()
            )
        self.nested_clipmap.sample(global_corrected)
        t2 = _time.perf_counter()

        # 3. rocks: rebuild rocks_data for the span around the rover
        #    (rocks_data is reset every update, :247-249). Built into a
        #    local list and swapped atomically: the streamed loop's main
        #    thread may read rocks_data (extract_rocks_data) while the
        #    cascade runs on the terrain worker thread.
        rocks_data = []
        for sampler in self.rock_samplers:
            block = sampler.sample_region(global_corrected,
                                          block_span=s.rock_block_span)
            rocks_data.append(block.coordinates)
            rocks_data.append(block.scale)
        self.rocks_data = rocks_data
        self._last_rocks_position = global_corrected  # checkpoint/resume
        t3 = _time.perf_counter()

        # 4. collider window shift (:250) — deferred to export time when
        #    collider_lazy (no PhysX consumer in this design)
        if self.collider_manager is not None:
            self._collider_position = global_corrected
            if not s.collider_lazy:
                self.collider_manager.update(global_corrected)
        t4 = _time.perf_counter()
        acc["streamer_s"] += t1 - t0
        acc["clipmap_s"] += t2 - t1
        acc["rocks_s"] += t3 - t2
        acc["collider_s"] += t4 - t3
        return True, corrected

    def ensure_colliders(self):
        """Bring the collider window up to date with the last cascade
        position (the deferred half of ``collider_lazy``) — call before
        exporting meshes. Returns the collider manager."""
        pos = getattr(self, "_collider_position", None)
        if self.collider_manager is not None and pos is not None:
            self.collider_manager.update(pos)
        return self.collider_manager

    def extract_rocks_data(self, min_radius: float = 0.0) -> np.ndarray:
        """``rocks_data`` -> MPPI obstacle list [x, y, radius]
        (extract_rocks_data, visual_terrain_stack_full_terrain.py:265-276:
        radius = max(scale_x, scale_y) per rock)."""
        obstacles = []
        for i in range(0, len(self.rocks_data), 2):
            positions = np.asarray(self.rocks_data[i]).reshape(-1, 2)
            scales = np.asarray(self.rocks_data[i + 1]).reshape(-1, 3)
            if positions.shape[0] == 0:
                continue
            radius = np.maximum(scales[:, 0], scales[:, 1])
            keep = radius >= min_radius
            obstacles.append(
                np.concatenate([positions[keep], radius[keep, None]], axis=-1)
            )
        if not obstacles:
            return np.zeros((0, 3), np.float32)
        return np.concatenate(obstacles, axis=0)

    def shutdown(self) -> None:
        """Reference parity (map_manager.hr_dem_gen.shutdown,
        visual_terrain_stack_full_terrain.py:581) — no worker processes to
        tear down in the device-native design."""
