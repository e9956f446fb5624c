"""Procedural rock scatter + block databases — a re-design of
``src/terrain_management/large_scale_terrain/rock_distribution.py``,
``rock_database.py`` and the sampling half of ``rock_manager.py``.

The reference samples rock positions per 25 m block with Thomas/Poisson
point processes on the host, queries the clipmap for height + a random
surface-tangent quaternion per rock (geometry_clipmaps_warp.py:363-422), and
stores the blocks ZFP-compressed in RAM. Here:

* position sampling mirrors the reference on host (parity) with device
  fixed-capacity variants in :mod:`.point_process`;
* height + tangent-frame quaternions are one vectorized device query
  (:func:`surface_orientation`) instead of a warp launch per batch;
* blocks compress with ``zlib``-packed float16 (``zfpy`` is not in the
  image; tolerance comparable to the reference's 1e-3 ZFP setting);
* ``rocks_data`` accumulation feeds the MPPI costmap exactly as
  ``extract_rocks_data`` does (visual_terrain_stack_full_terrain.py:240-260:
  one obstacle per rock with radius = scale).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from ..core import geometry as geom
from ..core.heightfield import HeightField
from . import point_process as pp


@dataclasses.dataclass
class RockDistConf:
    """One rock size class (the RSCfg_* dicts,
    visual_terrain_stack_full_terrain.py:45-105)."""

    parent_density: float = 0.01
    child_density: float = 10.0
    sigma: float = 4.5
    scale_min: float = 0.05
    scale_max: float = 0.2
    block_size: float = 25.0
    num_assets: int = 16          # prototype id range (instancer variants)
    seed: int = 67


@dataclasses.dataclass
class RockBlock:
    """Struct-of-arrays rock block (utils.py:34-41 RockBlockData)."""

    coordinates: np.ndarray   # (N, 2)
    height: np.ndarray        # (N,)
    quaternion: np.ndarray    # (N, 4) xyzw
    scale: np.ndarray         # (N, 3)
    ids: np.ndarray           # (N,) int32 prototype ids


def sample_block_positions(rng: np.random.Generator, conf: RockDistConf,
                           bx: int, by: int) -> np.ndarray:
    """Thomas-process rock positions for one block (DynamicDistribute.run,
    rock_distribution.py:359-486)."""
    bs = conf.block_size
    region = pp.BoundingBox(bx * bs, (bx + 1) * bs, by * bs, (by + 1) * bs)
    return pp.thomas_point_process(
        rng, region, conf.parent_density, conf.child_density, conf.sigma
    )


def _quat_from_normal_and_rand(normal: Array, rand: Array) -> Array:
    """Tangent-frame quaternion math shared by every keying scheme:
    vx = normalize(cross(n, random)), vy = cross(n, vx), R = [vx, vy, n]
    (``_get_random_tangent_vector``, geometry_clipmaps_warp.py:363-422)."""
    vx = jnp.cross(normal, rand)
    vx = geom.normalize(vx)
    vy = jnp.cross(normal, vx)

    # rotation matrix with rows (vx, vy, n) -> quaternion (wp.quat_from_matrix
    # takes the matrix built from row vectors; columns = world axes images)
    m = jnp.stack([vx, vy, normal], axis=-1)  # (N, 3, 3), columns vx,vy,n
    w = jnp.sqrt(jnp.clip(1.0 + m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2], 1e-12)) / 2.0
    qx = (m[..., 2, 1] - m[..., 1, 2]) / (4.0 * w)
    qy = (m[..., 0, 2] - m[..., 2, 0]) / (4.0 * w)
    qz = (m[..., 1, 0] - m[..., 0, 1]) / (4.0 * w)
    quat = jnp.stack([qx, qy, qz, w], axis=-1)
    return quat / jnp.linalg.norm(quat, axis=-1, keepdims=True)


def orientation_from_normal(normal: Array, key: Array, dtype=None) -> Array:
    """Random surface-tangent quaternion (xyzw) per normal — the tangent-
    frame half of ``_bilinear_interpolation_and_random_orientation`` +
    ``_get_random_tangent_vector`` (geometry_clipmaps_warp.py:363-422).
    """
    dtype = dtype or normal.dtype
    rand = jax.random.uniform(key, normal.shape[:-1] + (3,), dtype, -1.0, 1.0)
    return _quat_from_normal_and_rand(normal, rand)


def _per_rock_rand(base_key: Array, blk: Array, idx: Array, dtype) -> Array:
    """(N, 3) uniform draws keyed per rock by (block, index-in-block):
    independent of batch composition and visit order, so one fused batched
    query over many blocks is bit-identical to per-block queries."""

    def one(b0, b1, i):
        k = jax.random.fold_in(base_key, b0)
        k = jax.random.fold_in(k, b1)
        k = jax.random.fold_in(k, i)
        return jax.random.uniform(k, (3,), dtype, -1.0, 1.0)

    return jax.vmap(one)(blk[:, 0], blk[:, 1], idx)


@jax.jit
def _rock_surface_hf(hf: HeightField, xy: Array, blk: Array, idx: Array,
                     base_key: Array):
    """Fused heights + tangent quats for a padded rock batch against a fixed
    :class:`HeightField` — one program regardless of how many blocks the
    batch spans (the per-block eager query path compiled per shape
    bucket)."""
    from ..core import heightfield as hfield

    x, y = xy[:, 0], xy[:, 1]
    q = hfield.corners_at(hf, x, y)
    h = hfield.bilinear(x, y, q, hf.resolution)
    normal = hfield.quad_normal(q, hf.resolution)
    rand = _per_rock_rand(base_key, blk, idx, xy.dtype)
    return h, _quat_from_normal_and_rand(normal, rand)


@jax.jit
def _rock_surface_window(window: Array, ox, oy, res, xy: Array, blk: Array,
                         idx: Array, base_key: Array):
    """Fused heights + tangent quats against a streamed window in world
    coordinates (the TerrainStreamer/MapManager provider surface —
    NestedGeometryClipmapManager.get_height_and_random_scale,
    nested_geometry_clipmaps_manager.py:220-237)."""
    from .streaming import _window_normal
    from .upsample import bilinear_point_sample

    px = (xy[:, 0] - ox) / res
    py = (xy[:, 1] - oy) / res
    h = bilinear_point_sample(window, px, py)
    normal = _window_normal(window, px, py, res)
    rand = _per_rock_rand(base_key, blk, idx, xy.dtype)
    return h, _quat_from_normal_and_rand(normal, rand)


def surface_orientation(hf: HeightField, xy: Array, key: Array):
    """Height + random surface-tangent quaternion per point over a fixed
    heightfield window. Returns (height (N,), quaternion xyzw (N, 4),
    normal (N, 3))."""
    from ..core import heightfield as hfield

    x, y = xy[:, 0], xy[:, 1]
    q = hfield.corners_at(hf, x, y)
    height = hfield.bilinear(x, y, q, hf.resolution)
    normal = hfield.quad_normal(q, hf.resolution)
    quat = orientation_from_normal(normal, key, xy.dtype)
    return height, quat, normal


def provider_orientation(provider, xy: np.ndarray, key: Array):
    """Height + tangent quaternion from any world-coordinate height provider
    exposing vectorized ``get_height(x, y)`` / ``get_normal(x, y)`` (the
    TerrainStreamer / MapManager surface) — the rock-placement query the
    reference routes through ``NestedGeometryClipmapManager.
    get_height_and_random_scale`` (nested_geometry_clipmaps_manager.py:220-237)."""
    x, y = jnp.asarray(xy[:, 0]), jnp.asarray(xy[:, 1])
    height = provider.get_height(x, y)
    normal = provider.get_normal(x, y)
    quat = orientation_from_normal(normal, key)
    return height, quat, normal


class RockDB:
    """Per-block rock storage with optional compression
    (rock_database.py:22-400). Float fields compress with the native
    fixed-accuracy codec at the reference's ZFP tolerance 1e-3
    (utils.py:43-53) when the C++ runtime is built, else zlib-packed
    float16."""

    TOLERANCE = 1e-3

    def __init__(self, compress: bool = True):
        self._blocks: Dict[Tuple[int, int], object] = {}
        self.compress = compress
        if compress:
            from ..native import available as _native_available

            self._native = _native_available()
        else:
            self._native = False

    def _pack(self, block: RockBlock) -> dict:
        if self._native:
            from ..native import compress as ncompress

            return {
                name: ((ncompress(arr, self.TOLERANCE), "n")
                       if arr.dtype.kind == "f"
                       else (zlib.compress(arr.astype(np.int32).tobytes()), "i"),
                       arr.shape)
                for name, arr in dataclasses.asdict(block).items()
            }
        return {
            name: ((zlib.compress(arr.astype(np.float16).tobytes()), "f")
                   if arr.dtype.kind == "f"
                   else (zlib.compress(arr.astype(np.int32).tobytes()), "i"),
                   arr.shape)
            for name, arr in dataclasses.asdict(block).items()
        }

    def _unpack(self, packed: dict) -> RockBlock:
        out = {}
        for name, ((buf, kind), shape) in packed.items():
            if kind == "n":
                from ..native import decompress as ndecompress

                out[name] = ndecompress(buf, shape, self.TOLERANCE)
            elif kind == "f":
                raw = zlib.decompress(buf)
                out[name] = np.frombuffer(raw, np.float16).reshape(shape).astype(np.float32)
            else:
                raw = zlib.decompress(buf)
                out[name] = np.frombuffer(raw, np.int32).reshape(shape)
        return RockBlock(**out)

    def __contains__(self, key) -> bool:
        return tuple(key) in self._blocks

    def add(self, key, block: RockBlock) -> None:
        self._blocks[tuple(key)] = self._pack(block) if self.compress else block

    def get(self, key) -> RockBlock:
        blk = self._blocks[tuple(key)]
        return self._unpack(blk) if self.compress else blk

    def keys(self):
        return self._blocks.keys()


class RockSampler:
    """Block-based rock sampling against a heightfield (RockSampler +
    RockGenerator.sample, rock_distribution.py:518-756 /
    rock_manager.py:702-737)."""

    def __init__(self, conf: RockDistConf, hf):
        """``hf`` is either a fixed :class:`HeightField` window or any world-
        coordinate provider with vectorized ``get_height``/``get_normal``
        (TerrainStreamer, MapManager) — the streamed-terrain path."""
        self.conf = conf
        self.hf = hf
        self.rng = np.random.default_rng(conf.seed)
        self.db = RockDB()
        self._key = jax.random.key(conf.seed)

    def _block_rng(self, bx: int, by: int) -> np.random.Generator:
        """Per-block generator keyed by (seed, block): block contents are
        deterministic regardless of visit order — the same build-order
        independence the crater metadata has (streaming.py _block_field),
        strictly stronger than the reference's shared visit-order RNG."""
        return np.random.default_rng(
            (self.conf.seed, 0x52C3, bx & 0xFFFFFFFF, by & 0xFFFFFFFF)
        )

    def _finalize_block(self, key, xy, scale_xyz, ids, h, quat) -> RockBlock:
        block = RockBlock(
            coordinates=xy.astype(np.float32),
            height=np.asarray(h).astype(np.float32),
            quaternion=np.asarray(quat).astype(np.float32),
            scale=scale_xyz.astype(np.float32),
            ids=ids,
        )
        self.db.add(key, block)
        return block

    def sample_block(self, bx: int, by: int) -> RockBlock:
        if (bx, by) in self.db:
            return self.db.get((bx, by))
        self.sample_blocks([(bx, by)])
        return self.db.get((bx, by))

    def sample_blocks(self, keys) -> None:
        """Sample every missing block with ONE fused surface query and ONE
        host<->device round-trip: host point-process metadata per block,
        then a single jitted heights+quats program over the concatenated
        rocks (padded to a shape bucket so the compile caches across
        updates). Per-rock randomness is keyed (seed, block, index), so the
        result is independent of which blocks share a batch — batched and
        one-at-a-time sampling are bit-identical. Replaces the per-block
        query path whose eager quaternion ops + per-bucket compiles made
        the first reference-scale sampling slow."""
        missing = [k for k in keys if k not in self.db]
        if not missing:
            return
        metas = []           # ((bx, by), xy, scale_xyz, ids)
        xs, blks, idxs = [], [], []
        for bx, by in missing:
            rng = self._block_rng(bx, by)
            xy = sample_block_positions(rng, self.conf, bx, by)
            n = xy.shape[0]
            scale_xyz = rng.uniform(
                self.conf.scale_min, self.conf.scale_max, (n, 1)
            ) * np.ones((1, 3))
            ids = rng.integers(0, self.conf.num_assets, n).astype(np.int32)
            metas.append(((bx, by), xy, scale_xyz, ids))
            if n:
                xs.append(np.asarray(xy, np.float64))
                blks.append(np.broadcast_to(
                    np.asarray([bx, by], np.int32), (n, 2)))
                idxs.append(np.arange(n, dtype=np.int32))
        if xs:
            xy_all = np.concatenate(xs).astype(np.float32)
            blk_all = np.concatenate(blks)
            idx_all = np.concatenate(idxs)
            h_all, q_all = jax.device_get(
                self._batched_query(xy_all, blk_all, idx_all))
        cursor = 0
        for key, xy, scale_xyz, ids in metas:
            n = xy.shape[0]
            if n == 0:
                h, quat = np.zeros((0,)), np.zeros((0, 4))
            else:
                h = h_all[cursor:cursor + n]
                quat = q_all[cursor:cursor + n]
                cursor += n
            self._finalize_block(key, xy, scale_xyz, ids, h, quat)

    def _batched_query(self, xy: np.ndarray, blk: np.ndarray,
                       idx: np.ndarray):
        """Dispatch ONE fused surface query for a rock batch (padded to a
        256 bucket for small batches, 512-multiples beyond; pad rows carry
        block (0,0)/index 0 and are sliced off, so padding never changes
        real rows)."""
        n = xy.shape[0]
        bucket = 256 if n <= 256 else -(-n // 512) * 512
        dtype = (self.hf.z.dtype if isinstance(self.hf, HeightField)
                 else np.float32)
        xy_p = np.zeros((bucket, 2), dtype)
        xy_p[:n] = xy
        blk_p = np.zeros((bucket, 2), np.int32)
        blk_p[:n] = blk
        idx_p = np.zeros((bucket,), np.int32)
        idx_p[:n] = idx
        if isinstance(self.hf, HeightField):
            h, q = _rock_surface_hf(self.hf, jnp.asarray(xy_p), blk_p, idx_p,
                                    self._key)
        else:
            streamer = getattr(self.hf, "streamer", self.hf)
            ox, oy = streamer.window_origin()
            h, q = _rock_surface_window(
                streamer.window,
                jnp.float32(ox), jnp.float32(oy),
                jnp.float32(streamer.conf.resolution),
                jnp.asarray(xy_p), blk_p, idx_p, self._key,
            )
        return h[:n], q[:n]

    def sample_region(self, position, block_span: int = 1):
        """Sample the (2*span+1)^2 blocks around a position; returns the
        concatenated blocks (RockGenerator.sample region logic,
        rock_manager.py:702-737)."""
        bs = self.conf.block_size
        bx = int(np.floor(position[0] / bs))
        by = int(np.floor(position[1] / bs))
        span = range(-block_span, block_span + 1)
        self.sample_blocks([(bx + dx, by + dy) for dx in span for dy in span])
        blocks = [
            self.sample_block(bx + dx, by + dy)
            for dx in span
            for dy in span
        ]
        return RockBlock(
            coordinates=np.concatenate([b.coordinates for b in blocks]),
            height=np.concatenate([b.height for b in blocks]),
            quaternion=np.concatenate([b.quaternion for b in blocks]),
            scale=np.concatenate([b.scale for b in blocks]),
            ids=np.concatenate([b.ids for b in blocks]),
        )


def rocks_to_obstacles(blocks: RockBlock, min_radius: float = 0.0) -> np.ndarray:
    """Rocks -> MPPI obstacle list [x, y, radius] — the rock->costmap bridge
    (extract_rocks_data, visual_terrain_stack_full_terrain.py:240-260:
    radius taken as the rock scale)."""
    radius = blocks.scale[:, 0]
    keep = radius >= min_radius
    return np.concatenate(
        [blocks.coordinates[keep], radius[keep, None]], axis=-1
    )
