"""LargeScaleTerrainManager orchestrator: the full update cascade
(large_scale_terrain_manager.py:182-257 parity) on a tiny streamed world."""

import numpy as np
import pytest

from husky_rover_mppi.terrain.orchestrator import (
    LargeScaleConf,
    LargeScaleTerrainManager,
)
from husky_rover_mppi.terrain.rocks import RockDistConf


def tiny_conf(**kw):
    """Small-but-real config: 10 m blocks @0.1 m/px, 5-block window (50 m)."""
    defaults = dict(
        block_size=10.0,
        hr_dem_resolution=0.1,
        lr_pixel_size=2.0,
        hr_dem_num_blocks=1,
        crater_gen_padding=2.0,
        crater_gen_densities=(0.02,),
        crater_gen_radius=((0.5, 1.5),),
        update_every_n_meters=2.0,
        geo_cm_num_texels_per_level=8,
        geo_cm_num_lods=3,
        terrain_collider_resolution=0.5,
        terrain_collider_build_radius=6.0,
        rock_gen_cfgs=(
            RockDistConf(parent_density=0.02, child_density=4.0, sigma=2.0,
                         scale_min=0.3, scale_max=0.6, block_size=10.0,
                         seed=67),
        ),
        rock_block_span=1,
        collider_lazy=False,  # reference-parity eager cadence under test
    )
    defaults.update(kw)
    return LargeScaleConf(**defaults)


@pytest.fixture(scope="module")
def lstm():
    mgr = LargeScaleTerrainManager(tiny_conf())
    mgr.build()
    return mgr


def test_build_composes_all_managers(lstm):
    assert lstm.map_manager is not None
    assert lstm.map_manager.streamer.window is not None
    assert lstm.nested_clipmap is not None
    assert lstm.collider_manager is not None and lstm.collider_manager.meshes
    assert lstm.rock_samplers
    # build() runs the first update_visual_mesh((0,0)) -> rocks_data populated
    assert len(lstm.rocks_data) == 2 * len(lstm.rock_samplers)


def test_update_gating(lstm):
    # Small move: below update_every_n_meters -> no cascade
    updated, corrected = lstm.update_visual_mesh((0.5, 0.0))
    assert not updated and corrected == (0, 0)
    # Larger move: cascade fires, coordinates cast to threshold multiples
    updated, corrected = lstm.update_visual_mesh((3.1, 0.4))
    assert updated
    assert corrected == (2.0, 0.0)


def test_update_cascade_fires_in_order():
    """All four managers observe one update_visual_mesh in the reference
    order: map -> clipmap -> rocks -> collider (:223-251)."""
    mgr = LargeScaleTerrainManager(tiny_conf())
    mgr.build()
    order = []

    map_update = mgr.map_manager.update
    clip_sample = mgr.nested_clipmap.sample
    rock_sample = mgr.rock_samplers[0].sample_region
    collider_update = mgr.collider_manager.update
    mgr.map_manager.update = lambda p: order.append("map") or map_update(p)
    mgr.nested_clipmap.sample = lambda c: order.append("clipmap") or clip_sample(c)
    mgr.rock_samplers[0].sample_region = (
        lambda p, block_span: order.append("rocks")
        or rock_sample(p, block_span=block_span)
    )
    mgr.collider_manager.update = (
        lambda p: order.append("collider") or collider_update(p)
    )

    updated, _ = mgr.update_visual_mesh((4.0, 0.0))
    assert updated
    assert order == ["map", "clipmap", "rocks", "collider"]


def test_height_normal_consistent_across_shift():
    """get_height/get_normal at a fixed world point are identical before and
    after a window shift (blocks are deterministic; the query point stays
    inside both windows)."""
    mgr = LargeScaleTerrainManager(tiny_conf())
    mgr.build()
    probe = (6.0, 3.0)
    h0 = mgr.get_height_global(probe)
    n0 = mgr.get_normal_global(probe)
    anchor0 = mgr.map_manager.streamer.anchor

    # Drive one block east in update_every_n_meters hops -> window shift
    x = 0.0
    while mgr.map_manager.streamer.anchor == anchor0:
        x += 2.0
        mgr.update_visual_mesh((x, 0.0))
        assert x < 60.0, "window never shifted"
    h1 = mgr.get_height_global(probe)
    n1 = mgr.get_normal_global(probe)
    np.testing.assert_allclose(h1, h0, rtol=0, atol=1e-5)
    np.testing.assert_allclose(n1, n0, rtol=0, atol=1e-5)


def test_rocks_data_and_extract(lstm):
    obstacles = lstm.extract_rocks_data()
    assert obstacles.ndim == 2 and obstacles.shape[1] == 3
    if obstacles.shape[0]:
        # radius = max(scale_x, scale_y) within the configured bounds
        assert (obstacles[:, 2] >= 0.3 - 1e-6).all()
        assert (obstacles[:, 2] <= 0.6 + 1e-6).all()
        # rocks lie within the sampled block span around the rover
        span_m = (lstm.settings.rock_block_span + 1) * 10.0 + 10.0
        assert (np.abs(obstacles[:, :2]) <= span_m + 10.0).all()


def test_current_block_coordinates(lstm):
    bx, by = lstm.get_hr_map_current_block_coordinates()
    bs = lstm.settings.block_size
    assert bx % bs == 0 and by % bs == 0
    # starting position (0,0) lives in the center block after build, but the
    # module-scope fixture has since been driven; re-check geometry only:
    streamer = lstm.map_manager.streamer
    n = streamer.conf.num_blocks + 1
    assert bx == (streamer.anchor[0] + n) * bs
    assert by == (streamer.anchor[1] + n) * bs


def test_collider_lazy_defers_builds_to_export():
    """collider_lazy (the default): the cascade skips collider
    mesh builds (no PhysX consumer; they cost height-query round-trips per
    2 m) and ensure_colliders() brings the window up to date on demand."""
    mgr = LargeScaleTerrainManager(tiny_conf(collider_lazy=True))
    mgr.build()
    assert mgr.collider_manager is not None
    assert not mgr.collider_manager.meshes  # nothing built eagerly
    cm = mgr.ensure_colliders()
    assert cm is mgr.collider_manager and cm.meshes  # built at export time
