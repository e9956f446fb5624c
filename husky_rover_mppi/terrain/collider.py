"""Collision-mesh window around the rover — a re-design of
``src/terrain_management/large_scale_terrain/collider_builder.py`` (:73-141)
and ``collider_manager.py`` (:51-243).

The reference builds physical collision meshes only near the robot: a base
vertex/triangle grid is precomputed once per block spec, each block's mesh
is stamped from the corresponding HR-DEM slice, a small cache keeps ~10
blocks, meshes are built ``build_ahead`` meters around the rover and far
ones are dropped. There is no PhysX here — the rover dynamics ride the
heightfield directly (env/rover_sim.py) — but the collider window remains
the export surface for external physics engines, visualization, and the
labeling renderer, so the API is kept: build near, cache, drop far.

Meshes are plain NumPy ``(points (V, 3), triangles (T, 3))`` pairs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

BlockKey = Tuple[int, int]


class ColliderMesh(NamedTuple):
    points: np.ndarray     # (V, 3) float32, world coordinates
    triangles: np.ndarray  # (T, 3) int32


@dataclasses.dataclass
class ColliderConf:
    """ColliderBuilder/Manager knobs (collider_builder.py:25-40,
    collider_manager.py:23-49)."""

    block_size: float = 8.0     # meters per collider block
    resolution: float = 0.25    # collider vertex spacing (>= DEM resolution)
    build_radius: float = 12.0  # build blocks within this range of the rover
    drop_radius: float = 24.0   # evict blocks farther than this
    cache_size: int = 16

    def __post_init__(self) -> None:
        n = self.block_size / self.resolution
        assert abs(n - round(n)) < 1e-9, (
            "block_size must be an integer number of collider cells"
        )
        assert self.drop_radius >= self.build_radius

    @property
    def cells(self) -> int:
        return int(round(self.block_size / self.resolution))


class ColliderBuilder:
    """Precomputed base grid + per-block mesh stamping
    (collider_builder.py:73-141: ``build_base_grid`` / ``create_collider``)."""

    def __init__(self, conf: ColliderConf):
        self.conf = conf
        n = conf.cells
        ii, jj = np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="ij")
        self._base_xy = np.stack(
            [ii.ravel() * conf.resolution, jj.ravel() * conf.resolution], -1
        ).astype(np.float32)
        idx = np.arange((n + 1) * (n + 1)).reshape(n + 1, n + 1)
        a = idx[:-1, :-1].ravel()
        b = idx[:-1, 1:].ravel()
        c = idx[1:, :-1].ravel()
        d = idx[1:, 1:].ravel()
        self.triangles = np.concatenate(
            [np.stack([a, b, c], -1), np.stack([b, d, c], -1)]
        ).astype(np.int32)

    def build(self, heights: np.ndarray, origin: Tuple[float, float]) -> ColliderMesh:
        """Mesh one block from its ``(cells+1, cells+1)`` height patch."""
        n = self.conf.cells
        assert heights.shape == (n + 1, n + 1), heights.shape
        pts = np.empty((self._base_xy.shape[0], 3), np.float32)
        pts[:, 0] = self._base_xy[:, 0] + origin[0]
        pts[:, 1] = self._base_xy[:, 1] + origin[1]
        pts[:, 2] = heights.ravel()
        return ColliderMesh(points=pts, triangles=self.triangles)


class ColliderManager:
    """Maintains the near-rover collision-mesh cache
    (collider_manager.py:51-243): build blocks within ``build_radius``,
    drop beyond ``drop_radius``, never exceed ``cache_size`` (farthest
    evicted first). Heights come from any provider exposing
    ``get_height(x, y)`` vectorized over arrays (TerrainStreamer or
    MapManager)."""

    def __init__(self, conf: ColliderConf, height_provider):
        self.conf = conf
        self.builder = ColliderBuilder(conf)
        self.provider = height_provider
        self.meshes: Dict[BlockKey, ColliderMesh] = {}

    def _block_center(self, key: BlockKey) -> Tuple[float, float]:
        bs = self.conf.block_size
        return ((key[0] + 0.5) * bs, (key[1] + 0.5) * bs)

    def _needed_blocks(self, position) -> list:
        bs = self.conf.block_size
        r = self.conf.build_radius
        bx0 = int(np.floor((position[0] - r) / bs))
        bx1 = int(np.floor((position[0] + r) / bs))
        by0 = int(np.floor((position[1] - r) / bs))
        by1 = int(np.floor((position[1] + r) / bs))
        keys = []
        for bx in range(bx0, bx1 + 1):
            for by in range(by0, by1 + 1):
                cx, cy = self._block_center((bx, by))
                if np.hypot(cx - position[0], cy - position[1]) <= r + bs:
                    keys.append((bx, by))
        return keys

    def _block_query(self, key: BlockKey):
        """Dispatch (not fetch) the height query for one block."""
        bs = self.conf.block_size
        n = self.conf.cells
        origin = (key[0] * bs, key[1] * bs)
        xs = origin[0] + np.arange(n + 1) * self.conf.resolution
        ys = origin[1] + np.arange(n + 1) * self.conf.resolution
        xx, yy = np.meshgrid(xs, ys, indexing="ij")
        return origin, self.provider.get_height(xx.ravel(), yy.ravel())

    def _build_block(self, key: BlockKey) -> ColliderMesh:
        n = self.conf.cells
        origin, z_dev = self._block_query(key)
        z = np.asarray(z_dev, np.float32).reshape(n + 1, n + 1)
        return self.builder.build(z, origin)

    def update(self, position) -> Tuple[int, int]:
        """Build/evict around ``position``; returns (built, dropped).

        All missing blocks' height queries dispatch asynchronously and
        fetch in ONE ``jax.device_get`` — one host round-trip per update
        instead of one per block."""
        import jax

        built = dropped = 0
        pos = (float(position[0]), float(position[1]))
        missing = [k for k in self._needed_blocks(pos)
                   if k not in self.meshes]
        if missing:
            queries = [self._block_query(k) for k in missing]
            zs = jax.device_get([q[1] for q in queries])
            n = self.conf.cells
            for key, (origin, _), z in zip(missing, queries, zs):
                self.meshes[key] = self.builder.build(
                    np.asarray(z, np.float32).reshape(n + 1, n + 1), origin)
                built += 1
        # drop far blocks
        for key in list(self.meshes):
            cx, cy = self._block_center(key)
            if np.hypot(cx - pos[0], cy - pos[1]) > self.conf.drop_radius:
                del self.meshes[key]
                dropped += 1
        # bound the cache: evict farthest first (collider_manager.py:197-224)
        while len(self.meshes) > self.conf.cache_size:
            far = max(
                self.meshes,
                key=lambda k: np.hypot(
                    self._block_center(k)[0] - pos[0],
                    self._block_center(k)[1] - pos[1],
                ),
            )
            del self.meshes[far]
            dropped += 1
        return built, dropped

    def merged_mesh(self) -> Optional[ColliderMesh]:
        """All cached blocks as one mesh (export convenience)."""
        if not self.meshes:
            return None
        pts, tris, base = [], [], 0
        for mesh in self.meshes.values():
            pts.append(mesh.points)
            tris.append(mesh.triangles + base)
            base += mesh.points.shape[0]
        return ColliderMesh(np.concatenate(pts), np.concatenate(tris))
