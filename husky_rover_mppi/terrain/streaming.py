"""Streamed high-resolution terrain windows — the replacement for
``HighResDEMGen`` + its multiprocessing worker pools
(src/terrain_management/large_scale_terrain/high_resolution_DEM_generator.py,
high_resolution_DEM_workers.py).

The reference maintains a sliding (2N+3)^2 grid of 50 m blocks at 2.5-5 cm/px:
on every shift it memmoves the big DEM array, samples crater metadata for the
new region, and dispatches per-block jobs (crater rendering + PIL bicubic
upsampling) to 8+1 worker *processes*. Here each block is built by two jitted
device passes (bicubic upsample matmuls + the crater-stamp scan) and cached;
the window is composed from cached blocks on device. Async pipelining falls
out of JAX's async dispatch — block builds for a shift are all in flight
before the first is awaited, replacing the queue/worker machinery.

Crater metadata generation (hardcore Poisson, data-dependent shapes) stays on
host per SURVEY.md §7 — it is O(craters) and cheap; only rasterization runs
on device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from .craters import (
    CraterField,
    CraterProfiles,
    CraterSamplerConf,
    build_profiles,
    randomize_metadata,
    render_crater_block,
)
from .point_process import BoundingBox, hardcore_poisson
from .upsample import bilinear_point_sample, upsample_bicubic


@jax.jit
def _window_normal(window: Array, px: Array, py: Array, res) -> Array:
    """Quad normal at fractional window pixels (jitted — see the query
    section note in :class:`TerrainStreamer`)."""
    i = jnp.floor(px).astype(jnp.int32)
    j = jnp.floor(py).astype(jnp.int32)
    n = window.shape[0]
    i = jnp.clip(i, 0, n - 2)
    j = jnp.clip(j, 0, n - 2)
    q00 = window[i, j]
    q01 = window[i, j + 1]
    q10 = window[i + 1, j]
    q11 = window[i + 1, j + 1]
    # window layout is [row = x, col = y]: dz/dx differences run along i
    # (q10/q11 minus q00/q01), dz/dy along j — n ∝ (-dz/dx, -dz/dy, 1)
    vx = -res / 2.0 * (q10 - q00 - q01 + q11)
    vy = -res / 2.0 * (q01 - q00 - q10 + q11)
    vz = res * res * jnp.ones_like(vx)
    v = jnp.stack([vx, vy, vz], axis=-1)
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


@functools.partial(jax.jit, donate_argnums=(0,))
def _shift_window(window: Array, shift_px: Array, blocks: Array,
                  starts: Array) -> Array:
    """Roll the window by ``shift_px`` (traced) and write the entering
    blocks at ``starts`` (traced row/col pixel offsets) — ONE compiled
    program for every shift direction and block position. The previous
    eager roll + per-position ``dynamic_update_slice`` calls compiled a
    fresh XLA program per (direction, position) pair, so every shift paid
    compiles. ``blocks`` may
    contain idempotent duplicates (same block + same start) to keep the
    entering-count static. The window buffer is donated (in-place at
    reference scale)."""

    window = jnp.roll(window, (-shift_px[0], -shift_px[1]), (0, 1))

    def body(w, args):
        blk, st = args
        return jax.lax.dynamic_update_slice(w, blk, (st[0], st[1])), None

    window, _ = jax.lax.scan(body, window, (blocks, starts))
    return window


@jax.jit
def _shift_window_keep(window: Array, shift_px: Array, blocks: Array,
                       starts: Array) -> Array:
    """Non-donating :func:`_shift_window` — used by shift pre-staging,
    which must keep the source window alive until the crossing commits."""
    window = jnp.roll(window, (-shift_px[0], -shift_px[1]), (0, 1))

    def body(w, args):
        blk, st = args
        return jax.lax.dynamic_update_slice(w, blk, (st[0], st[1])), None

    window, _ = jax.lax.scan(body, window, (blocks, starts))
    return window


@dataclasses.dataclass
class StreamerConf:
    """Window geometry (HighResDEMConf semantics,
    high_resolution_DEM_generator.py:42-87)."""

    block_size: float = 50.0       # meters per block
    resolution: float = 0.05       # HR meters/px
    lr_resolution: float = 5.0     # LR meters/px (LOLA tiles)
    num_blocks: int = 2            # window side = 2*num_blocks + 3 blocks
    pad_size: float = 10.0         # crater-render padding (m)
    z_scale: float = 1.0
    seed: int = 42
    crater: CraterSamplerConf = dataclasses.field(default_factory=CraterSamplerConf)
    generate_craters: bool = True
    max_cached_blocks: int = 256
    prefetch: bool = True          # travel-direction block prefetch on shift
    # Route batched block bicubic upsamples through the native C++ TilePool
    # (husky_native.cpp thread pool — the worker-pool role of
    # high_resolution_DEM_workers.py:199-466). "auto": only on the CPU
    # backend (on an accelerator the device bicubic matmuls run there);
    # "always"/"never"
    # force it. The crater stamp stays on device either way.
    native_pool: str = "auto"      # "auto" | "always" | "never"
    native_pool_workers: int = 8   # the reference's 8 upsample workers

    def __post_init__(self) -> None:
        assert self.block_size > 0 and self.resolution > 0
        ratio = self.lr_resolution / self.resolution
        assert abs(ratio - round(ratio)) < 1e-9, (
            "lr_resolution must be an integer multiple of resolution"
        )
        lr_block = self.block_size / self.lr_resolution
        assert abs(lr_block - round(lr_block)) < 1e-9, (
            "block_size must be an integer number of LR pixels"
        )

    @property
    def blocks_per_side(self) -> int:
        return 2 * self.num_blocks + 3

    @property
    def block_px(self) -> int:
        return int(round(self.block_size / self.resolution))

    @property
    def window_px(self) -> int:
        return self.blocks_per_side * self.block_px

    @property
    def window_size(self) -> float:
        return self.blocks_per_side * self.block_size

    @property
    def upscale_factor(self) -> int:
        return int(round(self.lr_resolution / self.resolution))

    @property
    def pad_px(self) -> int:
        return int(round(self.pad_size / self.resolution))


class TerrainStreamer:
    """Sliding HR terrain window over a low-resolution source DEM.

    Axis convention matches the reference DEM layout (row = x, col = y,
    map_manager.py:88-90 after its flip/transpose), so the window can be
    handed directly to the MPPI surface with the rotated controller frame
    (env/frames.py).
    """

    def __init__(self, conf: StreamerConf, lr_dem: np.ndarray,
                 lr_center: Tuple[float, float] = (0.0, 0.0)):
        """Args:
            lr_dem: (H, W) low-resolution source DEM (meters), row = x.
            lr_center: world coordinate of the LR DEM center.
        """
        self.conf = conf
        self.lr_dem = jnp.asarray(lr_dem, jnp.float32)
        self.lr_center = lr_center
        self.rng = np.random.default_rng(conf.seed)
        self.profiles: CraterProfiles = build_profiles(
            conf.crater.num_profiles, conf.crater.seed
        )
        self.crater_blocks: Dict[Tuple[int, int], tuple] = {}
        self.block_cache: Dict[Tuple[int, int], Array] = {}
        self.anchor: Tuple[int, int] | None = None  # SW block index of window
        self.window: Array | None = None
        self.shift_count = 0
        # (new_anchor, shifted_window, source_window) — see prestage_shift.
        # The source array itself is stored (not its id()): holding the
        # reference both makes the validity check exact (``is``) and keeps
        # the snapshot alive, so a freed buffer's id can never be reused by
        # a different window and falsely validate a stale stage (ADVICE r04).
        self._staged_shift: tuple | None = None
        self.staged_shift_hits = 0
        # The unstaged shift path donates the old window buffer by default
        # (in-place roll at reference scale). The pipelined streamed loop
        # sets this False: its chunk programs keep the old window as a live
        # input while the shift composes on a background thread, and a
        # donated input would invalidate those dispatches.
        self.donate_shifts = True

    # --- coordinates --------------------------------------------------------

    def block_index(self, position) -> Tuple[int, int]:
        """Block containing a world position (cast_coordinates_to_block_space,
        high_resolution_DEM_generator.py:234-253)."""
        bs = self.conf.block_size
        return (int(np.floor(position[0] / bs)), int(np.floor(position[1] / bs)))

    def window_origin(self) -> Tuple[float, float]:
        """World coordinate of the window's [0, 0] pixel."""
        bs = self.conf.block_size
        return (self.anchor[0] * bs, self.anchor[1] * bs)

    # --- crater metadata ----------------------------------------------------

    def _block_region(self, bx: int, by: int) -> BoundingBox:
        bs = self.conf.block_size
        return BoundingBox(bx * bs, (bx + 1) * bs, by * bs, (by + 1) * bs)

    def _sample_block_craters(self, bx: int, by: int) -> None:
        """Sample crater metadata for one block with neighbor-aware hardcore
        rejection (CraterSampler.sample_craters_by_block,
        crater_distribution.py:503-583)."""
        if (bx, by) in self.crater_blocks:
            return
        prev_c, prev_r = [], []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                blk = self.crater_blocks.get((bx + dx, by + dy))
                if blk is not None:
                    prev_c.append(blk[0])
                    prev_r.append(blk[1])
        prev = None
        if prev_c:
            prev = (np.concatenate(prev_c), np.concatenate(prev_r))
        cc = self.conf.crater
        coords, radius = hardcore_poisson(
            self.rng, self._block_region(bx, by), cc.densities,
            cc.radius_ranges, prev, cc.num_repeat,
        )
        if coords.shape[0] > cc.capacity_per_block:
            coords = coords[: cc.capacity_per_block]
            radius = radius[: cc.capacity_per_block]
        self.crater_blocks[(bx, by)] = (coords, radius)

    def sample_craters_by_region(self, bx0: int, bx1: int, by0: int,
                                 by1: int) -> int:
        """Sample crater metadata for every missing block in the region with
        as few Poisson draws as possible: the missing set is decomposed into
        maximal empty rectangles (one hardcore-Poisson draw per rectangle,
        conditioned on neighboring existing craters), then split per block —
        ``CraterSampler.sample_craters_by_region``
        (crater_distribution.py:647-700) with the largest-empty-rectangle
        acceleration (:532-583). Returns the number of rectangles drawn."""
        from .database import decompose_empty_rectangles

        occ = np.ones((bx1 - bx0, by1 - by0), bool)
        for (bx, by) in self.crater_blocks:
            if bx0 <= bx < bx1 and by0 <= by < by1:
                occ[bx - bx0, by - by0] = False
        occ = ~occ  # True = block already sampled
        rects = decompose_empty_rectangles(occ)
        cc = self.conf.crater
        bs = self.conf.block_size
        for r, c, hh, ww in rects:
            rbx0, rby0 = bx0 + r, by0 + c
            region = BoundingBox(
                rbx0 * bs, (rbx0 + hh) * bs, rby0 * bs, (rby0 + ww) * bs
            )
            # condition on craters in blocks bordering the rectangle
            prev_c, prev_r = [], []
            for bx in range(rbx0 - 1, rbx0 + hh + 1):
                for by in range(rby0 - 1, rby0 + ww + 1):
                    inside = rbx0 <= bx < rbx0 + hh and rby0 <= by < rby0 + ww
                    blk = self.crater_blocks.get((bx, by))
                    if blk is not None and not inside:
                        prev_c.append(blk[0])
                        prev_r.append(blk[1])
            prev = None
            if prev_c:
                prev = (np.concatenate(prev_c), np.concatenate(prev_r))
            coords, radius = hardcore_poisson(
                self.rng, region, cc.densities, cc.radius_ranges, prev,
                cc.num_repeat,
            )
            # split the draw into per-block metadata lists
            bix = np.floor(coords[:, 0] / bs).astype(int)
            biy = np.floor(coords[:, 1] / bs).astype(int)
            for bx in range(rbx0, rbx0 + hh):
                for by in range(rby0, rby0 + ww):
                    sel = (bix == bx) & (biy == by)
                    c_blk = coords[sel][: cc.capacity_per_block]
                    r_blk = radius[sel][: cc.capacity_per_block]
                    self.crater_blocks[(bx, by)] = (c_blk, r_blk)
        return len(rects)

    def save_crater_db(self, folder: str) -> None:
        """Persist crater metadata blocks (CraterDB save_to_disk,
        crater_database.py:19-33)."""
        from .database import BlockDB, BlockDBConf

        db = BlockDB(BlockDBConf(block_size=self.conf.block_size,
                                 compress=False))
        for key, (coords, radius) in self.crater_blocks.items():
            db.add(key, {"coordinates": coords, "radius": radius})
        db.save_to_disk(folder)

    def load_crater_db(self, folder: str) -> None:
        from .database import BlockDB, BlockDBConf

        db = BlockDB(BlockDBConf(block_size=self.conf.block_size,
                                 compress=False))
        db.load_from_disk(folder)
        for key in db.keys():
            payload = db.get(key)
            self.crater_blocks[tuple(key)] = (
                payload["coordinates"], payload["radius"]
            )

    @property
    def _tier_specs(self):
        """Per radius tier ``(r_hi, capacity, patch_px)``, largest radius
        first. Rendering each density tier at ITS OWN patch size instead of
        the global maximum cuts the stamped pixel count ~5x at the shipped
        scale — the 0.5/m^2 small-crater tier (radii 0.25-0.5 m, ~87% of
        craters) otherwise renders 208^2-px patches for 44-px craters, and
        the crater stamp dominated the reference-scale window build.
        Capacities are conf-static (1.5x expected count + 64, rounded to
        64) so the compiled render programs never change shape."""
        conf = self.conf
        padded = conf.block_size + 2 * conf.pad_size
        area = padded * padded
        specs = []
        for d, (_lo, hi) in zip(conf.crater.densities,
                                conf.crater.radius_ranges):
            cap = int(area * d * 1.5) + 64
            cap = -(-cap // 64) * 64
            p = int(np.ceil(2 * hi / conf.resolution)) + 4
            specs.append((float(hi), cap, -(-p // 8) * 8))
        specs.sort(key=lambda s: -s[0])
        return specs

    def _block_fields(self, bx: int, by: int):
        """Metadata of a block and its 8 neighbors (craters bleed across
        block borders, CraterDB.get_block_data_with_neighbors), filtered to
        craters fully inside the padded raster — the reference's
        ``check_if_crater_is_in_block`` (crater_generation.py:169-181) —
        then split into radius tiers, one padded :class:`CraterField` per
        tier (see :attr:`_tier_specs`). Returns ``[(field, patch_px), ...]``.
        """
        cc = self.conf.crater
        conf = self.conf
        coords, radius = [], []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                self._sample_block_craters(bx + dx, by + dy)
                c, r = self.crater_blocks[(bx + dx, by + dy)]
                coords.append(c)
                radius.append(r)
        coords = np.concatenate(coords)
        radius = np.concatenate(radius)
        # keep craters whose patch lies inside the padded raster
        origin = np.array([bx * conf.block_size, by * conf.block_size])
        size_px = conf.block_px + 2 * conf.pad_px
        coord_px = (coords - origin) / conf.resolution + conf.pad_px
        c_half = radius / conf.resolution
        keep = (
            (coord_px[:, 0] - c_half >= 0)
            & (coord_px[:, 1] - c_half >= 0)
            & (coord_px[:, 0] + c_half < size_px)
            & (coord_px[:, 1] + c_half < size_px)
        )
        coords, radius = coords[keep], radius[keep]
        # Deterministic per-crater appearance: a dedicated generator keyed by
        # the block so metadata does not depend on build order. One draw for
        # the whole block BEFORE the tier split keeps the metadata stream
        # independent of the tier boundaries.
        meta_rng = np.random.default_rng(
            (self.conf.seed, 0x5EED, bx & 0xFFFF, by & 0xFFFF)
        )
        n = coords.shape[0]
        meta = randomize_metadata(
            meta_rng, coords, radius, cc.num_profiles, n,
            cc.min_xy_ratio, cc.max_xy_ratio, as_numpy=True,
        )
        specs = self._tier_specs
        # each crater renders in the smallest tier patch that covers it
        # (falls back to the largest tier when a radius exceeds every range)
        tier = np.zeros((n,), np.int32)
        for i, (r_hi, _cap, _p) in enumerate(specs):
            tier[radius <= r_hi + 1e-9] = i
        out = []
        for i, (_r_hi, cap, patch_px) in enumerate(specs):
            sel = np.flatnonzero(tier == i)[:cap]
            field = CraterField(
                *[np.zeros((cap,) + f.shape[1:], f.dtype) for f in meta]
            )
            for dst, src in zip(field, meta):
                dst[: sel.shape[0]] = src[sel]
            out.append((CraterField(*[jnp.asarray(f) for f in field]),
                        patch_px))
        return out

    # --- block building -----------------------------------------------------

    def _lr_patch(self, bx: int, by: int) -> Array:
        """LR source patch covering a block + 2 LR pixels of margin, clamped
        at the LR DEM edges (querry_low_res_dem semantics)."""
        lr_px = int(round(self.conf.block_size / self.conf.lr_resolution))
        margin = 2
        h, w = self.lr_dem.shape
        cx, cy = self.lr_center
        # LR pixel of the block's SW corner, relative to the LR DEM's
        # world-center anchor
        px = int(round((bx * self.conf.block_size - cx)
                       / self.conf.lr_resolution)) + h // 2
        py = int(round((by * self.conf.block_size - cy)
                       / self.conf.lr_resolution)) + w // 2
        xs = np.clip(np.arange(px - margin, px + lr_px + margin), 0, h - 1)
        ys = np.clip(np.arange(py - margin, py + lr_px + margin), 0, w - 1)
        return self.lr_dem[jnp.asarray(xs)][:, jnp.asarray(ys)]

    def _get_pool(self):
        """Lazily create the native TilePool when configured for this
        backend; None -> pure device path."""
        mode = self.conf.native_pool
        if mode == "never":
            return None
        if mode == "auto" and jax.default_backend() != "cpu":
            return None
        if getattr(self, "_pool", None) is None:
            from .. import native

            if not native.available():
                self._pool = False
            else:
                self._pool = native.TilePool(self.conf.native_pool_workers)
        return self._pool or None

    def bulk_build(self, keys) -> int:
        """Build many blocks at once. With the native pool enabled the
        bicubic upsamples of every missing block run concurrently on C++
        threads (shortest-queue dispatch — the 8-worker upsample pool of
        high_resolution_DEM_workers.py:107-196) while crater stamps follow
        on device; otherwise each block builds through
        :meth:`build_block`'s device path. Returns the number built."""
        missing = [k for k in keys if k not in self.block_cache]
        if not missing:
            return 0
        pool = self._get_pool()
        if pool is None:
            for k in missing:
                self.build_block(*k)
            return len(missing)
        from .. import native

        jobs = {}
        for k in missing:
            patch = np.asarray(self._lr_patch(*k), np.float32)
            jobs[pool.submit(native.BICUBIC, patch,
                             self.conf.upscale_factor)] = k
        results = pool.collect_all(timeout_s=300.0)
        m = 2 * self.conf.upscale_factor
        bpx = self.conf.block_px
        for jid, k in jobs.items():
            hr = jnp.asarray(results[jid][m:m + bpx, m:m + bpx])
            self._finish_block(k[0], k[1], hr)
        return len(missing)

    def build_block(self, bx: int, by: int) -> Array:
        """Build one HR block: bicubic upsample of the LR patch + crater
        stamp (the two worker jobs of generate_terrain_blocks,
        high_resolution_DEM_generator.py:760-784, fused on device)."""
        key = (bx, by)
        cached = self.block_cache.get(key)
        if cached is not None:
            return cached
        conf = self.conf
        margin_px = 2 * conf.upscale_factor
        hr = upsample_bicubic(self._lr_patch(bx, by), conf.upscale_factor)
        hr = jax.lax.dynamic_slice(
            hr, (margin_px, margin_px), (conf.block_px, conf.block_px)
        )
        return self._finish_block(bx, by, hr)

    def _finish_block(self, bx: int, by: int, hr: Array) -> Array:
        """Crater stamp + cache insert for an upsampled block base."""
        conf = self.conf
        if conf.generate_craters:
            origin = jnp.asarray(
                [bx * conf.block_size, by * conf.block_size], jnp.float32
            )
            for field, patch_px in self._block_fields(bx, by):
                craters = render_crater_block(
                    self.profiles, field, origin, conf.resolution,
                    conf.z_scale, conf.block_px, conf.pad_px,
                    patch_px=patch_px,
                    chunk=min(256, field.mask.shape[0]),
                )
                hr = hr + craters
        if len(self.block_cache) >= conf.max_cached_blocks:
            self.block_cache.pop(next(iter(self.block_cache)))
        self.block_cache[(bx, by)] = hr
        return hr

    # --- window management --------------------------------------------------

    def update(self, position) -> bool:
        """Re-anchor the window so ``position`` is in its center block;
        returns True when the window shifted (update_visual_mesh trigger
        semantics, large_scale_terrain_manager.py:202-257).

        Shifts roll the existing window with one ``jnp.roll`` + a
        ``dynamic_update_slice`` per newly-exposed block — static shapes, no
        recompiles, no O(window) host concat — the device equivalent of the
        reference's in-array memmove ``shift_dem``
        (high_resolution_DEM_generator.py:356-419). After each shift the next
        band of blocks in the travel direction is built speculatively
        (async device dispatch), replacing the reference's 8 worker
        processes hiding crater-render latency
        (high_resolution_DEM_workers.py:199-765)."""
        bx, by = self.block_index(position)
        n = self.conf.num_blocks + 1  # center block offset inside the window
        new_anchor = (bx - n, by - n)
        if new_anchor == self.anchor and self.window is not None:
            return False
        old_anchor = self.anchor
        self.anchor = new_anchor
        side = self.conf.blocks_per_side
        bpx = self.conf.block_px
        small_shift = (
            self.window is not None
            and old_anchor is not None
            and abs(new_anchor[0] - old_anchor[0]) < side
            and abs(new_anchor[1] - old_anchor[1]) < side
        )
        if not small_shift:
            self._staged_shift = None  # any staged roll is against a window
            # about to be discarded wholesale (ADVICE r04: the stale stage
            # must not survive into the rebuilt window's lifetime)
            self.bulk_build([
                (self.anchor[0] + i, self.anchor[1] + j)
                for i in range(side) for j in range(side)
            ])
            rows = []
            for i in range(side):
                row = [
                    self.build_block(self.anchor[0] + i, self.anchor[1] + j)
                    for j in range(side)
                ]
                rows.append(jnp.concatenate(row, axis=1))
            self.window = jnp.concatenate(rows, axis=0)
            # prewarm the one-and-only shift program during the build (a
            # zero shift writing the SW block over itself is a no-op):
            # the first real shift would otherwise stall the control loop
            # for the remote compile
            blk0 = self.build_block(*self.anchor)
            cap = 2 * side
            self.window = _shift_window(
                self.window,
                jnp.zeros((2,), jnp.int32),
                jnp.stack([blk0] * cap),
                jnp.zeros((cap, 2), jnp.int32),
            )
        else:
            di = new_anchor[0] - old_anchor[0]
            dj = new_anchor[1] - old_anchor[1]
            staged = self._staged_shift
            self._staged_shift = None
            if (staged is not None and staged[0] == new_anchor
                    and staged[2] is self.window):
                # pre-staged shifted window (prestage_shift): swap — the
                # shift already executed on device while the control loop
                # kept running
                self.window = staged[1]
                self.staged_shift_hits += 1
            else:
                self.window = self._compose_shift(
                    old_anchor, new_anchor, donate=self.donate_shifts)
            if self.conf.prefetch:
                self._prefetch(di, dj)
        self.shift_count += 1
        return True

    def _compose_shift(self, old_anchor, new_anchor, donate: bool,
                       source: Array | None = None) -> Array:
        """Shifted window for ``old_anchor -> new_anchor``: build the
        entering blocks, then one compiled roll+write program
        (:func:`_shift_window`). ``donate=False`` keeps the source window
        alive (pre-staging path; ``source`` pins the snapshot so a
        concurrent window swap cannot slip in mid-compose)."""
        side = self.conf.blocks_per_side
        bpx = self.conf.block_px
        di = new_anchor[0] - old_anchor[0]
        dj = new_anchor[1] - old_anchor[1]
        entering = [
            (i, j)
            for i in range(side) for j in range(side)
            if not (0 <= new_anchor[0] + i - old_anchor[0] < side
                    and 0 <= new_anchor[1] + j - old_anchor[1] < side)
        ]
        self.bulk_build([(new_anchor[0] + i, new_anchor[1] + j)
                         for i, j in entering])
        blocks = [self.build_block(new_anchor[0] + i, new_anchor[1] + j)
                  for i, j in entering]
        starts = [(i * bpx, j * bpx) for i, j in entering]
        # pad to a static entering-count (idempotent duplicates of the
        # last entry) so one compiled _shift_window serves every shift
        cap = 2 * side  # single-block shifts: side (axis) / 2side-1 (diag)
        while len(blocks) < cap:
            blocks.append(blocks[-1])
            starts.append(starts[-1])
        if len(blocks) > cap:  # multi-block jump: no padding benefit
            cap = len(blocks)
        fn = _shift_window if donate else _shift_window_keep
        return fn(
            self.window if source is None else source,
            jnp.asarray([di * bpx, dj * bpx], jnp.int32),
            jnp.stack(blocks[:cap]),
            jnp.asarray(starts[:cap], jnp.int32),
        )

    def prestage_shift(self, new_anchor: Tuple[int, int]) -> None:
        """Speculatively compute the shifted window for an anticipated
        anchor: the roll + entering-block writes execute on device NOW
        (overlapped with whatever the control loop is doing) so the actual
        crossing in :meth:`update` only swaps arrays. The stage is keyed on
        the identity of the source window — any mutation (deformation
        stamps replace ``self.window``) invalidates it automatically."""
        if self.window is None or self.anchor is None:
            return
        if new_anchor == self.anchor:
            return
        side = self.conf.blocks_per_side
        if (abs(new_anchor[0] - self.anchor[0]) >= side
                or abs(new_anchor[1] - self.anchor[1]) >= side):
            return  # full rebuild path — nothing to stage
        src = self.window  # snapshot: key the stage on THIS array identity
        if (self._staged_shift is not None
                and self._staged_shift[0] == new_anchor
                and self._staged_shift[2] is src):
            return
        win = self._compose_shift(self.anchor, new_anchor, donate=False,
                                  source=src)
        self._staged_shift = (new_anchor, win, src)

    def _prefetch(self, di: int, dj: int) -> None:
        """Speculatively build (and cache) the band of blocks one step
        further along the travel direction; device work is dispatched
        asynchronously so this does not block the control loop."""
        side = self.conf.blocks_per_side
        a = self.anchor
        band = []
        if di:
            row = a[0] + (side if di > 0 else -1)
            band += [(row, a[1] + j) for j in range(side)]
        if dj:
            col = a[1] + (side if dj > 0 else -1)
            band += [(a[0] + i, col) for i in range(side)]
        if di and dj:
            # diagonal travel also needs the corner block where the two
            # bands intersect, or the next diagonal crossing builds it
            # synchronously inside update()
            band.append((a[0] + (side if di > 0 else -1),
                         a[1] + (side if dj > 0 else -1)))
        self.bulk_build(band)

    # --- queries ------------------------------------------------------------
    # All window reads are jitted: an eagerly-indexed result fetched to the
    # host can pull the WHOLE parent buffer (196 MB for the reference-scale
    # window); jit outputs are standalone buffers, so a fetch transfers
    # only the queried values.

    def _to_window_px(self, x, y):
        ox, oy = self.window_origin()
        res = self.conf.resolution
        return (jnp.asarray(x) - ox) / res, (jnp.asarray(y) - oy) / res

    def get_height(self, x, y) -> Array:
        """Bilinear height query in world coordinates
        (get_height_global, large_scale_terrain_manager.py:96-150)."""
        px, py = self._to_window_px(x, y)
        return bilinear_point_sample(self.window, px, py)

    def get_normal(self, x, y) -> Array:
        """Quad normal in world coordinates (get_normal_local semantics,
        quad-normal formula of the projection kernels)."""
        px, py = self._to_window_px(x, y)
        return _window_normal(self.window, px, py, self.conf.resolution)
