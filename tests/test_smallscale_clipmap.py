"""Small-scale terrain generator + geometry clipmaps."""

import jax
import jax.numpy as jnp
import numpy as np

from husky_rover_mppi.terrain.clipmap import (
    Clipmap,
    ClipmapSpec,
    NestedClipmap,
    build_lod_pyramid,
    build_ring_layout,
)
from husky_rover_mppi.terrain.smallscale import (
    BaseTerrainGeneratorConf,
    MoonyardConf,
    MoonyardGenerator,
    dem_to_mesh_grid,
    random_base_terrain,
)


def test_random_base_terrain_shapes_and_range():
    conf = BaseTerrainGeneratorConf(x_size=5.0, y_size=5.0, resolution=0.05,
                                    max_elevation=0.5, min_elevation=-0.25)
    dem = random_base_terrain(jax.random.key(0), conf)
    assert dem.shape == (100, 100)
    d = np.asarray(dem)
    assert d.min() > -0.5 and d.max() < 1.0
    # deterministic per key
    dem2 = random_base_terrain(jax.random.key(0), conf)
    np.testing.assert_array_equal(np.asarray(dem), np.asarray(dem2))


def test_yard_borders_low():
    conf = BaseTerrainGeneratorConf(x_size=5.0, y_size=5.0, resolution=0.05,
                                    max_elevation=0.5, min_elevation=0.2)
    dem = np.asarray(random_base_terrain(jax.random.key(1), conf, is_yard=True))
    # yard mode zeroes the border control points -> edges well below center
    assert abs(dem[0, :].mean()) < dem[40:60, 40:60].mean()


def test_moonyard_generator_craters():
    conf = MoonyardConf(
        base=BaseTerrainGeneratorConf(x_size=8.0, y_size=8.0, resolution=0.1,
                                      seed=3),
    )
    gen = MoonyardGenerator(conf)
    dem1 = np.asarray(gen.randomize())
    assert dem1.shape == (80, 80)
    dem2 = np.asarray(gen.randomize())
    assert not np.allclose(dem1, dem2)  # fresh randomization
    # craters add sub-zero bowls beyond the base noise floor
    assert dem1.min() < -0.05


def test_dem_to_mesh_grid():
    dem = np.arange(12, dtype=float).reshape(3, 4)
    verts, tris = dem_to_mesh_grid(dem, 0.5)
    assert verts.shape == (12, 3)
    assert tris.shape == (2 * 2 * 3, 3)
    np.testing.assert_allclose(verts[5], [0.5, 0.5, 5.0])
    assert tris.min() >= 0 and tris.max() < 12


def test_ring_layout_structure():
    spec = ClipmapSpec(num_lods=3, ring_size=8, resolution=0.1)
    layout = build_ring_layout(spec)
    assert layout.offsets.shape[0] == layout.lods.shape[0]
    assert layout.triangles.max() < layout.offsets.shape[0]
    # finer LODs pack the center; coarse rings exclude it
    lod0 = layout.offsets[layout.lods == 0]
    lod2 = layout.offsets[layout.lods == 2]
    assert np.abs(lod0).max() <= 0.8 + 1e-9
    assert np.abs(lod2).max() > np.abs(lod0).max()
    inner2 = np.maximum(np.abs(lod2[:, 0]), np.abs(lod2[:, 1])).min()
    assert inner2 >= 8 * 0.4 / 2 - 1e-9  # hole for the finer level


def test_lod_pyramid_and_clipmap_sampling(rng):
    z = jnp.asarray(rng.normal(size=(128, 128)).cumsum(axis=0) * 0.05)
    pyr = build_lod_pyramid(z, 3)
    assert [p.shape for p in pyr] == [(128, 128), (64, 64), (32, 32)]
    np.testing.assert_allclose(
        float(pyr[1][0, 0]),
        float((z[0, 0] + z[1, 0] + z[0, 1] + z[1, 1]) / 4), rtol=1e-6,
    )

    spec = ClipmapSpec(num_lods=3, ring_size=8, resolution=0.1)
    cm = Clipmap(spec, z, origin=(0.0, 0.0), source_resolution=0.1)
    pts = cm.sample((6.0, 6.0))
    assert pts.shape == (cm.layout.offsets.shape[0], 3)
    assert np.isfinite(np.asarray(pts)).all()
    # LOD-0 vertices reproduce the exact grid values at aligned points
    v = np.asarray(pts)
    on_grid = (cm.layout.lods == 0)
    px = np.round(v[on_grid, 0] / 0.1).astype(int)
    py = np.round(v[on_grid, 1] / 0.1).astype(int)
    np.testing.assert_allclose(
        v[on_grid, 2], np.asarray(z)[px, py], atol=1e-5
    )


def test_nested_clipmap_rock_query(rng):
    from husky_rover_mppi.core import HeightField

    z = jnp.asarray(rng.normal(size=(128, 128)) * 0.05)
    fine = Clipmap(ClipmapSpec(num_lods=2, ring_size=4, resolution=0.1), z,
                   source_resolution=0.1)
    coarse = Clipmap(ClipmapSpec(num_lods=2, ring_size=4, resolution=0.4), z,
                     source_resolution=0.1)
    nested = NestedClipmap(fine, coarse)
    f, c = nested.sample((5.0, 5.0))
    assert f.shape[1] == 3 and c.shape[1] == 3
    hf = HeightField.create(z, 6.4)
    h, q, n = nested.get_height_and_random_orientation(
        jnp.asarray([[1.0, 2.0], [0.5, 0.5]]), jax.random.key(0), hf
    )
    assert h.shape == (2,)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(q), axis=-1), 1.0,
                               atol=1e-6)


def test_moonyard_non_square_lab():
    # Regression: the 9.6 x 6.4 m lunalab (first non-square yard) must
    # compose base noise + square-rendered crater block without shape errors.
    from husky_rover_mppi.terrain.craters import CraterSamplerConf
    from husky_rover_mppi.terrain.smallscale import (
        BaseTerrainGeneratorConf,
        MoonyardConf,
        MoonyardGenerator,
    )

    conf = MoonyardConf(
        base=BaseTerrainGeneratorConf(x_size=9.6, y_size=6.4, resolution=0.05),
        crater=CraterSamplerConf(densities=(0.2,), radius_ranges=((0.2, 0.6),),
                                 num_profiles=8),
        is_lab=True, is_yard=False,
    )
    gen = MoonyardGenerator(conf)
    dem = np.asarray(gen.randomize())
    assert dem.shape == (gen.x_px, gen.y_px)
    assert dem.shape[0] != dem.shape[1]
    assert np.isfinite(dem).all()
