"""Costmap fixture regeneration + distance transforms."""

import jax.numpy as jnp
import numpy as np
import pytest

from husky_rover_mppi.ops.edt import (
    chamfer5,
    distance_costmap,
    edt_exact,
    normalize_minmax,
)
from husky_rover_mppi.terrain import (
    as_costmap,
    costmap_750,
    device_costmap,
    generate_obstacles,
    rasterize_obstacles,
    reference_costmap,
)


def test_obstacle_field_deterministic():
    """RandomState(99) draw order x, y, r (MPPI_OO_current.py:722-726)."""
    obs = generate_obstacles()
    assert obs.shape == (750, 3)
    rng = np.random.RandomState(99)
    expected_first = [rng.uniform(-50, 50), rng.uniform(-50, 50), rng.uniform(0, 0.4)]
    np.testing.assert_allclose(obs[0], expected_first)
    assert np.all(np.abs(obs[:, :2]) <= 50.0)
    assert np.all((obs[:, 2] >= 0) & (obs[:, 2] <= 0.4))
    # determinism
    np.testing.assert_array_equal(obs, generate_obstacles())


def test_rasterize_swapped_frame():
    """The reference swaps the local frame: an obstacle at (x=10, y=0) maps
    to local (0, 10) (MPPI_isaac.py:366-367)."""
    obs = np.array([[10.0, 0.0, 0.2]])
    img = rasterize_obstacles(obs, half_width=20.0, size=100, robot_radius=1.0)
    ys, xs = np.where(img == 0)
    lin = np.linspace(-20, 20, 100)
    cx = lin[xs].mean()
    cy = lin[ys].mean()
    assert abs(cx - 0.0) < 0.5   # X_costmap ~ x_local = y_global
    assert abs(cy - 10.0) < 0.5  # Y_costmap ~ y_local = x_global


def test_exact_edt_matches_scipy():
    from scipy.ndimage import distance_transform_edt

    rng = np.random.default_rng(3)
    occ = rng.random((96, 80)) < 0.03
    occ[0, 0] = True  # ensure non-empty
    d = np.asarray(edt_exact(jnp.asarray(occ)))
    d_ref = distance_transform_edt(~occ)
    np.testing.assert_allclose(d, d_ref, atol=1e-3)


def test_chamfer_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(4)
    free = (rng.random((64, 64)) > 0.05).astype(np.uint8) * 255
    free[10, 10] = 0
    ours = chamfer5(free)
    theirs = cv2.distanceTransform(free, cv2.DIST_L2, 5)
    np.testing.assert_allclose(ours, theirs, atol=1e-5)


def test_costmap_falloff_properties():
    occ = np.zeros((64, 64), bool)
    occ[32, 32] = True
    cm = np.asarray(distance_costmap(jnp.asarray(occ), falloff_power=20.0))
    assert cm[32, 32] == 1.0          # on the obstacle
    assert cm.min() >= 0.0
    assert cm[0, 0] < 1e-6            # far corner decays
    # monotone decay along a ray
    ray = cm[32, 32:48]
    assert np.all(np.diff(ray) <= 1e-9)


def test_costmap_750_pipeline():
    cm = costmap_750(size=188, falloff_power=20.0)  # small for test speed
    cost = np.asarray(cm.cost)
    assert cost.shape == (188, 188)
    assert 0.0 <= cost.min() and cost.max() == 1.0
    assert float(cm.resolution) == pytest.approx(150.0 / 188)
    # obstacles occupy a plausible fraction of the ±50 m interior
    assert 0.02 < (cost > 0.99).mean() < 0.5


def test_device_costmap_close_to_reference():
    """Exact EDT vs cv2 chamfer-5: same falloff to within the chamfer's
    documented ~2% distance error."""
    obs = generate_obstacles(num=60, seed=5, extent=20.0)
    binary = rasterize_obstacles(obs, half_width=30.0, size=150, robot_radius=1.0)
    ref = reference_costmap(binary, falloff_power=10.0)
    dev = np.asarray(device_costmap(binary, falloff_power=10.0))
    assert np.abs(ref - dev).max() < 0.12
    assert np.abs(ref - dev).mean() < 0.01


def test_chamfer_fallback_weights_match_cv2():
    """The non-cv2 fallbacks (NumPy raster scan + native C++) must use
    OpenCV's 5x5 DIST_L2 weights (1.0, 1.4, 2.1969) — the 3x3 set
    (0.955, 1.3693) once sat here and silently diverged ~4.5%."""
    cv2 = pytest.importorskip("cv2")
    from husky_rover_mppi.ops.edt import _chamfer5_numpy

    rng = np.random.default_rng(7)
    free = (rng.random((48, 48)) > 0.06).astype(np.uint8) * 255
    free[20, 20] = 0
    theirs = cv2.distanceTransform(free, cv2.DIST_L2, 5)
    ours = _chamfer5_numpy(free)
    np.testing.assert_allclose(ours, theirs, atol=1e-3)
    from husky_rover_mppi import native

    if native.available():
        np.testing.assert_allclose(native.chamfer5(free), theirs, atol=1e-3)
