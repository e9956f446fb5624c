"""Geometry clipmaps: multi-LOD terrain sampling for visualization/export.

Re-design of ``src/terrain_management/large_scale_terrain/
geometry_clipmaps*.py``: the reference builds a numba-tessellated LOD ring
mesh once, then per update runs warp kernels mapping mesh vertices to DEM
pixel space and interpolating heights (hybrid CPU/GPU buffers). Here:

* the LOD ring layout is generated vectorized (:func:`build_ring_layout`,
  replacing ``geometry_clipmaps_numba.py:24-256``) and cached as arrays;
* per update, one jitted gather interpolates every vertex height from an
  LOD pyramid (:func:`sample_clipmap` — replacing ``_bilinear/_bicubic``
  warp kernels, geometry_clipmaps_warp.py:180-279);
* :class:`NestedClipmap` pairs a fine (HR window) and a coarse (LR DEM)
  clipmap like ``NestedGeometryClipmapManager`` and exposes the
  rock-placement query (height + random tangent orientation).

There is no USD stage to mutate; the sampled vertex buffer is the
product (exported for visualization, or consumed by the labeling renderer).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from .upsample import bicubic_point_sample, bilinear_point_sample


@dataclasses.dataclass
class ClipmapSpec:
    """GeometryClipmapConf essentials (geometry_clipmaps.py:31-60)."""

    num_lods: int = 4
    ring_size: int = 16        # vertices per ring side at each LOD
    resolution: float = 0.05   # finest-LOD vertex spacing (m)
    interpolation: str = "bilinear"  # "bilinear" | "bicubic"


class RingLayout(NamedTuple):
    """Static clipmap vertex layout: 2D offsets + LOD id per vertex and a
    triangle index buffer."""

    offsets: np.ndarray    # (V, 2) vertex offsets from the center (m)
    lods: np.ndarray       # (V,) LOD id
    triangles: np.ndarray  # (T, 3) indices


def build_ring_layout(spec: ClipmapSpec) -> RingLayout:
    """Concentric LOD rings: LOD 0 is a dense (2n+1)^2 grid; each coarser
    LOD covers double the extent at double the spacing, skipping the region
    covered by the finer LOD (the clipmap 'backbone' the numba builder
    tessellates, geometry_clipmaps_numba.py:24-256)."""
    n = spec.ring_size
    offsets, lods, triangles = [], [], []
    base = 0
    for lod in range(spec.num_lods):
        spacing = spec.resolution * (2**lod)
        coords = np.arange(-n, n + 1) * spacing
        xx, yy = np.meshgrid(coords, coords, indexing="ij")
        pts = np.stack([xx.ravel(), yy.ravel()], axis=-1)
        keep = np.ones(pts.shape[0], dtype=bool)
        if lod > 0:
            inner = n * spacing / 2
            keep = np.maximum(np.abs(pts[:, 0]), np.abs(pts[:, 1])) >= inner
        # triangles over the full grid, masked to kept vertices
        side = 2 * n + 1
        idx = np.arange(side * side).reshape(side, side)
        a = idx[:-1, :-1].ravel()
        b = idx[:-1, 1:].ravel()
        c = idx[1:, :-1].ravel()
        d = idx[1:, 1:].ravel()
        tris = np.concatenate(
            [np.stack([a, b, c], axis=-1), np.stack([b, d, c], axis=-1)],
            axis=0,
        )
        tri_keep = keep[tris].all(axis=-1)
        # remap to the compacted vertex list
        remap = -np.ones(side * side, np.int64)
        remap[np.flatnonzero(keep)] = np.arange(keep.sum())
        offsets.append(pts[keep])
        lods.append(np.full(int(keep.sum()), lod))
        triangles.append(remap[tris[tri_keep]] + base)
        base += int(keep.sum())
    return RingLayout(
        np.concatenate(offsets), np.concatenate(lods),
        np.concatenate(triangles),
    )


@functools.partial(jax.jit, static_argnames=("num_lods",))
def build_lod_pyramid(z: Array, num_lods: int) -> list[Array]:
    """2x average-pool pyramid of the source DEM. Jitted so the strided
    window reads never execute as eager ops against the big streamed array
    (see the terrain/streaming.py query note)."""
    levels = [jnp.asarray(z)]
    for _ in range(num_lods - 1):
        cur = levels[-1]
        h, w = cur.shape
        cur = cur[: h - h % 2, : w - w % 2]
        levels.append(
            (cur[0::2, 0::2] + cur[1::2, 0::2] + cur[0::2, 1::2] + cur[1::2, 1::2])
            / 4.0
        )
    return levels


class Clipmap:
    """One clipmap over a DEM array (GeoClipmap + GeoClipmapManager roles)."""

    def __init__(self, spec: ClipmapSpec, z: Array, origin=(0.0, 0.0),
                 source_resolution: float | None = None):
        self.spec = spec
        self.layout = build_ring_layout(spec)
        self.pyramid = build_lod_pyramid(z, spec.num_lods)
        self.origin = origin
        self.source_resolution = source_resolution or spec.resolution
        self._offsets = jnp.asarray(self.layout.offsets, jnp.float32)
        self._lods = jnp.asarray(self.layout.lods)

    def update_dem(self, z: Array, origin=None) -> None:
        """Re-seat the clipmap on new DEM contents (``update_DEM``,
        geometry_clipmaps.py:283-348 / nested_geometry_clipmaps_manager.py:
        update_DEM): rebuild the LOD pyramid from the new array and move the
        world origin when the window shifted. The layout (mesh backbone) is
        untouched — only the sampled pyramid changes, so nothing recompiles."""
        self.pyramid = build_lod_pyramid(z, self.spec.num_lods)
        if origin is not None:
            self.origin = origin

    def sample(self, center) -> Array:
        """Vertex positions (V, 3) of the clipmap centered at ``center`` —
        the ``update_geoclipmap`` equivalent (one jitted multi-LOD gather)."""
        cx, cy = center
        sampler = (
            bicubic_point_sample
            if self.spec.interpolation == "bicubic"
            else bilinear_point_sample
        )
        xs = self._offsets[:, 0] + cx
        ys = self._offsets[:, 1] + cy
        z = jnp.zeros(xs.shape[0], jnp.float32)
        for lod, level in enumerate(self.pyramid):
            scale = 2**lod
            res = self.source_resolution * scale
            # 2x average pooling puts level-L pixel p's center at source
            # pixel 2^L*p + (2^L-1)/2 — subtract that half-kernel shift or
            # every coarse ring reads systematically southwest of its
            # vertices (visible LOD-boundary steps on slopes)
            shift = (scale - 1) / 2.0 * self.source_resolution
            px = (xs - self.origin[0] - shift) / res
            py = (ys - self.origin[1] - shift) / res
            vals = sampler(level, px, py)
            z = jnp.where(self._lods == lod, vals, z)
        return jnp.stack([xs, ys, z], axis=-1)


class NestedClipmap:
    """Fine (HR window) + coarse (LR DEM) clipmap pair
    (NestedGeometryClipmapManager, nested_geometry_clipmaps_manager.py:71-265)."""

    def __init__(self, fine: Clipmap, coarse: Clipmap):
        self.fine = fine
        self.coarse = coarse

    def sample(self, center):
        return self.fine.sample(center), self.coarse.sample(center)

    def get_height_and_random_orientation(self, xy: Array, key: Array,
                                          hf) -> tuple:
        """Rock-placement query (get_height_and_random_scale,
        :220-237): height + surface-tangent random quaternion, delegated to
        the vectorized heightfield query."""
        from .rocks import surface_orientation

        return surface_orientation(hf, xy, key)
