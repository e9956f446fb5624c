"""Heightfield (2.5D DEM) geometry ops — the core of the framework.

These functions reproduce the *semantics* of the reference Warp device
functions in ``thesis_master/warp_implementation/projection_warp.py``:

- ``_get_corners_heights``   (projection_warp.py:8-48)   -> :func:`corner_cell` + :func:`gather_corners`
- ``_bilinear_interpolator`` (projection_warp.py:70-100) -> :func:`bilinear`
- ``_normal_on_grid``        (projection_warp.py:129-151)-> :func:`quad_normal`
- ``_get_heading_tangent_vector`` (projection_warp.py:168-190) -> :func:`tangent_project`

Design notes (not a port):

* The reference runs one CUDA thread per trajectory and does scalar loads from
  a flat ``Z`` array. Here every function is written on arbitrary batch shapes
  and jit/vmap-compatible, so a (rovers, samples) batch turns into a single
  vectorized XLA gather instead of 100k scalar loads.
* Out-of-window lookups: the Warp kernels perform unchecked loads (undefined
  behaviour off the grid). XLA gathers inside jit clamp indices to the array
  bounds, which yields a well-defined "edge extension" semantic. Trajectories
  that stay inside the window (the supported regime, matching the reference's
  75 m half-width with 9 m horizons) are bit-identical.
* Index convention is the Warp one: ``i = trunc((x - x_min)/res)``,
  ``j = -trunc((y + y_min)/res)`` — callers pass ``x_min = y_min = -half_width``
  so rows count *down* from +half_width (projection_warp.py:39-40).
* The fractional weights use truncation (``wp.trunc``), not floor
  (projection_warp.py:94-95); the two differ for negative coordinates and the
  truncation semantic is the production one.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array


class HeightField(NamedTuple):
    """A regular-grid 2.5D heightfield window.

    Attributes:
        z: ``(grid, grid)`` height samples. Row index ``j`` counts *down* from
           ``y = +half_width`` (Warp convention); column index ``i`` counts up
           from ``x = x_min``.
        x_min: west edge of the window in meters (traced; rebasing a streamed
           window does not recompile).
        y_min: the value the reference passes as ``y_min`` (``-half_width``);
           kept verbatim so the quirky ``j = -trunc((y + y_min)/res)`` formula
           is reproduced exactly.
        resolution: cell size in meters.
    """

    z: Array
    x_min: Array
    y_min: Array
    resolution: Array

    @property
    def grid_size(self) -> int:
        return self.z.shape[-1]

    @classmethod
    def create(cls, z, half_width, dtype=None) -> "HeightField":
        """Build a heightfield over ``[-half_width, half_width]^2``.

        Mirrors ``Surface.__init__`` (MPPI_isaac.py:259-277): resolution is
        ``2*half_width/grid_size`` and the kernels receive
        ``x_min = y_min = -half_width``.
        """
        z = jnp.asarray(z, dtype=dtype)
        dt = z.dtype
        grid = z.shape[-1]
        res = jnp.asarray(2.0 * half_width / grid, dtype=dt)
        hw = jnp.asarray(half_width, dtype=dt)
        return cls(z=z, x_min=-hw, y_min=-hw, resolution=res)


def corner_cell(hf: HeightField, x: Array, y: Array) -> tuple[Array, Array]:
    """Cell indices of the quad containing (x, y) (projection_warp.py:39-40)."""
    i = jnp.trunc((x - hf.x_min) / hf.resolution).astype(jnp.int32)
    j = (-jnp.trunc((y + hf.y_min) / hf.resolution)).astype(jnp.int32)
    return i, j


def gather_corners(hf: HeightField, i: Array, j: Array) -> Array:
    """Heights of the 4 quad corners, layout ``q[a, b] = z[j + a, i + b]``.

    Matches ``_get_corners_heights`` (projection_warp.py:43-46):
    ``q[0,0]=Z[j,i], q[0,1]=Z[j,i+1], q[1,0]=Z[j+1,i], q[1,1]=Z[j+1,i+1]``.
    Returns shape ``batch + (2, 2)``.
    """
    z = hf.z
    q00 = z[j, i]
    q01 = z[j, i + 1]
    q10 = z[j + 1, i]
    q11 = z[j + 1, i + 1]
    return jnp.stack(
        [jnp.stack([q00, q01], axis=-1), jnp.stack([q10, q11], axis=-1)], axis=-2
    )


def corners_at(hf: HeightField, x: Array, y: Array) -> Array:
    """Fused :func:`corner_cell` + :func:`gather_corners`."""
    i, j = corner_cell(hf, x, y)
    return gather_corners(hf, i, j)


def bilinear(x: Array, y: Array, q: Array, resolution: Array) -> Array:
    """Bilinear interpolation with the Warp truncation + transposed-weight
    semantics (projection_warp.py:89-98).

    Note the production quirk kept on purpose: the x-fraction weights
    ``q[1,0]`` (the +j neighbor) and the y-fraction weights ``q[0,1]`` — the
    same pairing the critics and rollouts were tuned against.
    """
    xn = x / resolution
    yn = y / resolution
    x2 = xn - jnp.trunc(xn)
    y2 = yn - jnp.trunc(yn)
    q00 = q[..., 0, 0]
    q01 = q[..., 0, 1]
    q10 = q[..., 1, 0]
    q11 = q[..., 1, 1]
    return (
        (1.0 - x2) * (1.0 - y2) * q00
        + x2 * (1.0 - y2) * q10
        + (1.0 - x2) * y2 * q01
        + x2 * y2 * q11
    )


def quad_normal(q: Array, resolution: Array) -> Array:
    """Unit normal of the quad (projection_warp.py:141-151). Shape ``batch+(3,)``."""
    q00 = q[..., 0, 0]
    q01 = q[..., 0, 1]
    q10 = q[..., 1, 0]
    q11 = q[..., 1, 1]
    vx = -resolution / 2.0 * (q01 - q00 - q10 + q11)
    vy = -resolution / 2.0 * (q10 - q00 - q01 + q11)
    vz = resolution * resolution * jnp.ones_like(vx)
    norm = jnp.sqrt(vx * vx + vy * vy + vz * vz)
    return jnp.stack([vx, vy, vz], axis=-1) / norm[..., None]


def tangent_project(normal: Array, heading: Array) -> Array:
    """Project ``heading`` onto the plane of ``normal`` and renormalize
    (projection_warp.py:181-190). Both are ``batch + (3,)``."""
    dot = jnp.sum(heading * normal, axis=-1, keepdims=True)
    proj = heading - dot * normal
    norm = jnp.sqrt(jnp.sum(proj * proj, axis=-1, keepdims=True))
    return proj / norm


def height_at(hf: HeightField, x: Array, y: Array) -> Array:
    """Bilinear height at (x, y) — the common composite query."""
    q = corners_at(hf, x, y)
    return bilinear(x, y, q, hf.resolution)


def nearest_height(hf: HeightField, x: Array, y: Array) -> Array:
    """Nearest-cell (truncated-index) height lookup, used for the wheel-track
    heights in the rollout kernel (projection_warp.py:338-347)."""
    i, j = corner_cell(hf, x, y)
    return hf.z[j, i]


def normal_at(hf: HeightField, x: Array, y: Array) -> Array:
    """Quad normal at (x, y)."""
    q = corners_at(hf, x, y)
    return quad_normal(q, hf.resolution)


def surface_frame(hf: HeightField, x: Array, y: Array, heading: Array):
    """(height, normal, tangent-projected heading) in one gather.

    The fused variant of the per-step sequence the reference launches as three
    separate device functions (projection_warp.py:306-310).
    """
    q = corners_at(hf, x, y)
    h = bilinear(x, y, q, hf.resolution)
    n = quad_normal(q, hf.resolution)
    t = tangent_project(n, heading)
    return h, n, t


def jacobian_slope(hf: HeightField, x: Array, y: Array) -> Array:
    """Slope magnitude (rad) at (x, y) from the quad normal — convenience for
    terrain analysis / costmap layers (not in the reference kernel set)."""
    n = normal_at(hf, x, y)
    return jnp.arccos(jnp.clip(n[..., 2], -1.0, 1.0))
