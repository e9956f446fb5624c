"""The exact EDT against SciPy's, on shapes that are not multiples of the
row block."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import ndimage

from husky_rover_mppi.ops.edt import edt_exact_sq


@pytest.mark.parametrize("shape, density, block", [
    ((96, 80), 0.02, 32),
    ((50, 70), 0.05, 32),
    ((131, 67), 0.01, 64),
])
def test_edt_exact_sq_matches_scipy(rng, shape, density, block):
    occ = rng.random(shape) < density
    occ[0, 0] = True  # at least one obstacle
    ref = ndimage.distance_transform_edt(~occ) ** 2
    got = np.asarray(edt_exact_sq(jnp.asarray(occ), block=block))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
