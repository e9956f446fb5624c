"""Euclidean distance transforms for costmap construction.

The reference builds obstacle costmaps with OpenCV's chamfer-approximate
distance transform (``cv2.distanceTransform(…, cv2.DIST_L2, 5)``,
MPPI_isaac.py:374) on the host. Replacements here:

* :func:`edt_exact` — an **exact** L2 EDT as a fully-parallel two-stage
  reduction (1D row distances via ``cummin``, then a column lower-envelope
  evaluated as a chunked min-plus reduction). O(n^3) arithmetic but entirely
  vectorized — fractions of a millisecond for the reference's 187–875 px
  costmaps, and exact where cv2's 5x5 chamfer is ~2% off.
* :func:`chamfer5` (NumPy, host) — a cv2-compatible two-pass 5x5 chamfer,
  used only to regenerate the byte-identical reference costmap fixture when
  cv2 itself is unavailable.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

_BIG = 1e12


def _row_distances(occupied: Array) -> Array:
    """Per-row 1D distance (in pixels, along the last axis) to the nearest
    occupied cell. Vectorized two-pass min via cummin:
    ``fwd[j] = j + cummin(d0[k] - k)``; ``bwd`` symmetric."""
    width = occupied.shape[-1]
    axis = occupied.ndim - 1
    col = jnp.arange(width, dtype=jnp.float32)
    d0 = jnp.where(occupied, 0.0, _BIG)
    fwd = col + jax.lax.cummin(d0 - col, axis=axis)
    bwd = -col + jax.lax.cummin(d0 + col, axis=axis, reverse=True)
    return jnp.minimum(fwd, bwd)


@functools.partial(jax.jit, static_argnames=("block",))
def edt_exact_sq(occupied: Array, block: int = 64) -> Array:
    """Exact squared L2 EDT of a boolean occupancy grid (True = obstacle).

    Stage 1: exact 1D distances along rows. Stage 2: lower envelope along
    columns, ``D2[y, x] = min_y' g[y', x] + (y - y')^2``, evaluated in
    ``block``-row chunks to bound the (rows, rows, cols) broadcast.
    """
    rows = occupied.shape[-2]
    g = _row_distances(occupied)
    g2 = jnp.minimum(g * g, _BIG)
    ys = jnp.arange(rows, dtype=jnp.float32)

    pad = (-rows) % block
    y_blocks = jnp.pad(ys, (0, pad), constant_values=0).reshape(-1, block)

    def one_block(y_chunk):
        # (block, rows) offsets + (rows, cols) row distances -> (block, cols)
        off = (y_chunk[:, None] - ys[None, :]) ** 2
        return jnp.min(off[:, :, None] + g2[None, :, :], axis=1)

    out = jax.lax.map(one_block, y_blocks)
    return out.reshape(-1, occupied.shape[-1])[:rows]


def edt_exact(occupied: Array, block: int = 64) -> Array:
    """Exact L2 EDT (pixels)."""
    return jnp.sqrt(edt_exact_sq(occupied, block=block))


def normalize_minmax(d: Array) -> Array:
    """cv2.NORM_MINMAX over the full array (MPPI_isaac.py:375). A constant
    array (obstacle-free or all-obstacle map) normalizes to zeros — cv2's
    behavior — instead of 0/0 NaNs that would poison the critic stack."""
    lo = jnp.min(d)
    hi = jnp.max(d)
    rng = hi - lo
    return jnp.where(rng > 0, (d - lo) / jnp.where(rng > 0, rng, 1.0), 0.0)


def distance_costmap(occupied: Array, falloff_power: float = 20.0) -> Array:
    """Obstacle costmap: exact EDT, min-max normalize, ``(1 - d)^p`` falloff
    (MPPI_isaac.py:374-377; the offline recipe uses p=10,
    create_costmap.py:24)."""
    d = edt_exact(occupied)
    cost = (1.0 - normalize_minmax(d)) ** falloff_power
    # obstacle-free map: the EDT saturates at the _BIG sentinel everywhere,
    # min==max normalizes to 0 and cost would read 1.0 (all-colliding);
    # the meaningful free-space answer is a zero-cost map
    return jnp.where(jnp.any(occupied), cost, jnp.zeros_like(cost))


# --- host-side cv2-compatible chamfer (fixture regeneration only) -----------

def chamfer5(binary_free: np.ndarray) -> np.ndarray:
    """5x5 chamfer distance transform of a uint8 image (0 = obstacle,
    nonzero = free), matching ``cv2.distanceTransform(img, DIST_L2, 5)``.

    Uses cv2 when importable (bit-identical by construction); otherwise a
    NumPy two-pass raster scan with OpenCV's 5x5 DIST_L2 weights
    (a, b, c) = (1.0, 1.4, 2.1969). (0.955/1.3693 is the 3x3 mask's set —
    using it here once made the fallback diverge ~4.5% from cv2.)
    """
    try:
        import cv2

        return cv2.distanceTransform(
            binary_free.astype(np.uint8), cv2.DIST_L2, 5
        )
    except ImportError:
        pass

    from ..native import available as _native_available, chamfer5 as _native_chamfer5

    if _native_available():
        return _native_chamfer5(binary_free)

    return _chamfer5_numpy(binary_free)


def _chamfer5_numpy(binary_free: np.ndarray) -> np.ndarray:
    """Pure-NumPy two-pass raster scan (the last-resort fallback of
    :func:`chamfer5`), exposed for direct cv2-parity testing."""
    a, b, c = 1.0, 1.4, 2.1969
    h, w = binary_free.shape
    big = np.float32(1e9)
    d = np.where(binary_free == 0, np.float32(0), big).astype(np.float32)
    pad = 2
    dp = np.pad(d, pad, constant_values=big)
    # forward pass: neighbors strictly above / left in raster order
    fwd = [(-1, -1, b), (-1, 0, a), (-1, 1, b), (0, -1, a),
           (-2, -1, c), (-2, 1, c), (-1, -2, c), (-1, 2, c)]
    for y in range(pad, h + pad):
        for x in range(pad, w + pad):
            v = dp[y, x]
            for dy, dx, wgt in fwd:
                v = min(v, dp[y + dy, x + dx] + wgt)
            dp[y, x] = v
    bwd = [(dy * -1, dx * -1, wgt) for dy, dx, wgt in fwd]
    for y in range(h + pad - 1, pad - 1, -1):
        for x in range(w + pad - 1, pad - 1, -1):
            v = dp[y, x]
            for dy, dx, wgt in bwd:
                v = min(v, dp[y + dy, x + dx] + wgt)
            dp[y, x] = v
    return dp[pad:-pad, pad:-pad]
