"""Heightfield ops vs the Warp-semantics NumPy oracle (float64 exactness)."""

import jax.numpy as jnp
import numpy as np

from husky_rover_mppi.compat import warp_oracle as wo
from husky_rover_mppi.core import (
    HeightField,
    bilinear,
    corner_cell,
    corners_at,
    height_at,
    nearest_height,
    normal_at,
    quad_normal,
    tangent_project,
)
from husky_rover_mppi.terrain import bump_surface


def _make_hf(grid=64, half_width=8.0, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(grid, grid)) * 0.3
    hf = HeightField.create(z.astype(np.float64), half_width, dtype=jnp.float64)
    return hf, z, half_width


def _random_points(rng, n, half_width, margin=1.0):
    return rng.uniform(-half_width + margin, half_width - margin, size=(2, n))


def test_corner_cell_matches_oracle(rng):
    hf, z, hw = _make_hf()
    xs, ys = _random_points(rng, 200, hw)
    i, j = corner_cell(hf, jnp.asarray(xs), jnp.asarray(ys))
    res = float(hf.resolution)
    for n in range(len(xs)):
        io, jo = wo.corner_cell(xs[n], ys[n], -hw, -hw, res)
        assert int(i[n]) == io
        assert int(j[n]) == jo


def test_corners_and_bilinear_match_oracle(rng):
    hf, z, hw = _make_hf()
    xs, ys = _random_points(rng, 200, hw)
    res = float(hf.resolution)
    q = corners_at(hf, jnp.asarray(xs), jnp.asarray(ys))
    h = bilinear(jnp.asarray(xs), jnp.asarray(ys), q, hf.resolution)
    for n in range(len(xs)):
        io, jo = wo.corner_cell(xs[n], ys[n], -hw, -hw, res)
        qo = wo.gather_corners(z, io, jo)
        np.testing.assert_array_equal(np.asarray(q[n]), qo)
        ho = wo.bilinear(xs[n], ys[n], qo, res)
        np.testing.assert_allclose(float(h[n]), ho, rtol=0, atol=1e-14)


def test_normal_matches_oracle_and_is_unit(rng):
    hf, z, hw = _make_hf()
    xs, ys = _random_points(rng, 100, hw)
    res = float(hf.resolution)
    n_jax = normal_at(hf, jnp.asarray(xs), jnp.asarray(ys))
    norms = np.linalg.norm(np.asarray(n_jax), axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-12)
    for n in range(len(xs)):
        io, jo = wo.corner_cell(xs[n], ys[n], -hw, -hw, res)
        qo = wo.gather_corners(z, io, jo)
        no = wo.quad_normal(qo, res)
        np.testing.assert_allclose(np.asarray(n_jax[n]), no, atol=1e-14)


def test_tangent_projection(rng):
    hf, z, hw = _make_hf()
    xs, ys = _random_points(rng, 50, hw)
    normal = normal_at(hf, jnp.asarray(xs), jnp.asarray(ys))
    heading = jnp.asarray(rng.normal(size=(50, 3)))
    t = tangent_project(normal, heading)
    # tangents are unit and orthogonal to the normal
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(t), axis=-1), 1.0, atol=1e-12
    )
    dots = np.sum(np.asarray(t) * np.asarray(normal), axis=-1)
    np.testing.assert_allclose(dots, 0.0, atol=1e-12)
    for n in range(20):
        to = wo.tangent_project(np.asarray(normal[n]), np.asarray(heading[n]))
        np.testing.assert_allclose(np.asarray(t[n]), to, atol=1e-14)


def test_nearest_height(rng):
    hf, z, hw = _make_hf()
    xs, ys = _random_points(rng, 100, hw)
    h = nearest_height(hf, jnp.asarray(xs), jnp.asarray(ys))
    res = float(hf.resolution)
    for n in range(len(xs)):
        io, jo = wo.corner_cell(xs[n], ys[n], -hw, -hw, res)
        assert float(h[n]) == z[jo, io]


def test_out_of_window_clamps():
    hf, z, hw = _make_hf()
    # far outside the window: gathers clamp instead of faulting
    h = height_at(hf, jnp.asarray([100.0]), jnp.asarray([-100.0]))
    assert np.isfinite(np.asarray(h)).all()


def test_bump_surface_matches_numpy_reference():
    from husky_rover_mppi.compat import numpy_oracle as no

    bumps = no.REFERENCE_BUMPS
    z_jax = np.asarray(bump_surface(128, 20.0, bumps, dtype=jnp.float64))
    _, _, z_np = no.create_surface(128, 20.0, bumps)
    np.testing.assert_allclose(z_jax, z_np, atol=1e-12)
