"""Collider window: base grid, block meshing, near-rover cache
(terrain/collider.py)."""

import numpy as np
import pytest

from husky_rover_mppi.terrain.collider import (
    ColliderBuilder,
    ColliderConf,
    ColliderManager,
)


class FlatProvider:
    def get_height(self, x, y):
        return np.asarray(x) * 0.1 + np.asarray(y) * 0.2


def test_builder_grid_shape_and_triangles():
    conf = ColliderConf(block_size=2.0, resolution=0.5)
    b = ColliderBuilder(conf)
    n = conf.cells
    assert b.triangles.shape == (2 * n * n, 3)
    heights = np.zeros((n + 1, n + 1), np.float32)
    mesh = b.build(heights, (4.0, -2.0))
    assert mesh.points.shape == ((n + 1) ** 2, 3)
    assert mesh.points[:, 0].min() == pytest.approx(4.0)
    assert mesh.points[:, 0].max() == pytest.approx(6.0)
    assert mesh.points[:, 1].min() == pytest.approx(-2.0)
    # every triangle references valid vertices, all vertices used
    assert mesh.triangles.max() == mesh.points.shape[0] - 1
    assert len(np.unique(mesh.triangles)) == mesh.points.shape[0]


def test_builder_triangle_area_sums_to_block_area():
    conf = ColliderConf(block_size=4.0, resolution=0.5)
    b = ColliderBuilder(conf)
    n = conf.cells
    mesh = b.build(np.zeros((n + 1, n + 1), np.float32), (0.0, 0.0))
    p = mesh.points[mesh.triangles]
    cross = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    assert np.abs(cross[:, 2]).sum() / 2 == pytest.approx(16.0)


def test_manager_builds_near_and_drops_far():
    conf = ColliderConf(block_size=2.0, resolution=0.5, build_radius=3.0,
                        drop_radius=6.0, cache_size=64)
    mgr = ColliderManager(conf, FlatProvider())
    built, dropped = mgr.update((0.0, 0.0))
    assert built > 0 and dropped == 0
    keys0 = set(mgr.meshes)
    # heights stamped from the provider
    mesh = mgr.meshes[(0, 0)]
    np.testing.assert_allclose(
        mesh.points[:, 2],
        mesh.points[:, 0] * 0.1 + mesh.points[:, 1] * 0.2,
        atol=1e-5,
    )
    # move far: old blocks dropped, new built
    built, dropped = mgr.update((20.0, 20.0))
    assert built > 0 and dropped == len(keys0)
    assert not (set(mgr.meshes) & keys0)


def test_manager_cache_bound():
    conf = ColliderConf(block_size=2.0, resolution=1.0, build_radius=5.0,
                        drop_radius=100.0, cache_size=4)
    mgr = ColliderManager(conf, FlatProvider())
    mgr.update((0.0, 0.0))
    mgr.update((8.0, 0.0))
    assert len(mgr.meshes) <= 4
    # the kept blocks are the nearest to the last position
    for key in mgr.meshes:
        cx, cy = mgr._block_center(key)
        assert np.hypot(cx - 8.0, cy) < 12.0


def test_manager_merged_mesh():
    conf = ColliderConf(block_size=2.0, resolution=1.0, build_radius=2.0,
                        drop_radius=10.0)
    mgr = ColliderManager(conf, FlatProvider())
    assert mgr.merged_mesh() is None
    mgr.update((0.0, 0.0))
    merged = mgr.merged_mesh()
    total_pts = sum(m.points.shape[0] for m in mgr.meshes.values())
    assert merged.points.shape[0] == total_pts
    assert merged.triangles.max() == total_pts - 1


def test_manager_against_streamer():
    """Collider heights must match the streamer's bilinear surface."""
    from husky_rover_mppi.terrain.streaming import (
        StreamerConf, TerrainStreamer)

    sconf = StreamerConf(block_size=8.0, resolution=0.5, lr_resolution=2.0,
                         num_blocks=1, pad_size=2.0, generate_craters=False)
    rng = np.random.default_rng(0)
    streamer = TerrainStreamer(sconf, rng.normal(size=(64, 64)).astype(np.float32))
    streamer.update((0.0, 0.0))
    conf = ColliderConf(block_size=4.0, resolution=0.5, build_radius=4.0,
                        drop_radius=10.0)
    mgr = ColliderManager(conf, streamer)
    mgr.update((0.0, 0.0))
    mesh = mgr.meshes[(0, 0)]
    ref = np.asarray(streamer.get_height(mesh.points[:, 0], mesh.points[:, 1]))
    np.testing.assert_allclose(mesh.points[:, 2], ref, atol=1e-5)
