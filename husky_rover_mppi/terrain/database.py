"""Block databases + region-sampling acceleration structures.

A re-design of the reference's DB layer:

* ``CraterDB`` / ``RockDB`` keep per-block payload dicts with neighbor-aware
  queries, occupancy matrices over query regions, and missing-block lists
  (crater_database.py:19-441, rock_database.py:22-400);
* region sampling is accelerated by repeatedly extracting the **largest
  empty rectangle** from the occupancy matrix so each Poisson draw covers a
  maximal axis-aligned region instead of one block at a time
  (crater_distribution.py:532-583, 647-700);
* both DBs expose ``save_to_disk`` / ``write_to_disk_interval`` knobs
  (crater_database.py:19-33, rock_database.py:22-36 — shipped disabled, but
  part of the API surface).

Here one generic :class:`BlockDB` provides the machinery; payloads are
dicts of NumPy arrays compressed with the native fixed-accuracy codec when
the C++ runtime is built (the reference's ZFP path, utils.py:33-81).
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

BlockKey = Tuple[int, int]


# --- largest-empty-rectangle --------------------------------------------------

def largest_empty_rectangle(occupied: np.ndarray) -> Tuple[int, int, int, int]:
    """Largest all-False axis-aligned rectangle of a boolean matrix.

    Returns ``(row0, col0, height, width)`` (height/width 0 when the matrix
    is fully occupied). Histogram-of-heights + monotonic stack — O(H*W),
    versus the reference's quadratic scan
    (crater_distribution.py:532-583 ``find_largest_rectangle``).
    """
    occ = np.asarray(occupied, bool)
    h, w = occ.shape
    best = (0, 0, 0, 0)
    best_area = 0
    heights = np.zeros(w + 1, np.int64)  # sentinel column
    for r in range(h):
        heights[:w] = np.where(occ[r], 0, heights[:w] + 1)
        stack: List[int] = []
        for c in range(w + 1):
            start = c
            while stack and heights[stack[-1]] >= heights[c]:
                top = stack.pop()
                height = int(heights[top])
                left = stack[-1] + 1 if stack else 0
                area = height * (c - left)
                if area > best_area:
                    best_area = area
                    best = (r - height + 1, left, height, c - left)
                start = left
            stack.append(c)
    return best


def decompose_empty_rectangles(
    occupied: np.ndarray, max_rects: int = 64
) -> List[Tuple[int, int, int, int]]:
    """Greedy cover of the empty cells by maximal rectangles: repeatedly
    take the largest empty rectangle and mark it occupied — the region
    decomposition the reference's samplers iterate
    (crater_distribution.py:647-700)."""
    occ = np.asarray(occupied, bool).copy()
    rects = []
    for _ in range(max_rects):
        r0, c0, hh, ww = largest_empty_rectangle(occ)
        if hh == 0 or ww == 0:
            break
        rects.append((r0, c0, hh, ww))
        occ[r0:r0 + hh, c0:c0 + ww] = True
    return rects


# --- generic block DB ----------------------------------------------------------

@dataclasses.dataclass
class BlockDBConf:
    """CraterDBConf/RockDBConf knobs (crater_database.py:19-33)."""

    block_size: float = 50.0
    max_blocks: int = 10_000           # LRU eviction bound
    save_to_disk: bool = False
    write_to_disk_interval: int = 100  # blocks between autosaves
    folder: Optional[str] = None
    compress: bool = True
    tolerance: float = 1e-3            # native-codec accuracy (ZFP setting)


class BlockDB:
    """Per-block storage of ``{field: np.ndarray}`` payloads with
    neighbor-aware queries, occupancy matrices, missing-block lists, LRU
    eviction, optional compression, and disk persistence — the shared core
    of the reference's CraterDB and RockDB."""

    def __init__(self, conf: BlockDBConf | None = None):
        self.conf = conf or BlockDBConf()
        self._blocks: Dict[BlockKey, object] = {}
        self._since_save = 0

    # -- payload (de)compression ------------------------------------------------

    def _pack(self, payload: Dict[str, np.ndarray]) -> object:
        if not self.conf.compress:
            return payload
        from ..native import available, compress

        packed = {}
        for name, arr in payload.items():
            arr = np.asarray(arr)
            if arr.dtype.kind == "f" and available():
                packed[name] = ("n", compress(arr, self.conf.tolerance),
                                arr.shape)
            elif arr.dtype.kind == "f":
                packed[name] = ("f", zlib.compress(
                    arr.astype(np.float16).tobytes()), arr.shape)
            else:
                packed[name] = ("i", zlib.compress(
                    arr.astype(np.int32).tobytes()), arr.shape)
        return packed

    def _unpack(self, packed: object) -> Dict[str, np.ndarray]:
        if not self.conf.compress:
            return dict(packed)  # type: ignore[arg-type]
        from ..native import decompress

        out = {}
        for name, (kind, buf, shape) in packed.items():  # type: ignore[union-attr]
            if kind == "n":
                out[name] = decompress(buf, shape, self.conf.tolerance)
            elif kind == "f":
                out[name] = np.frombuffer(
                    zlib.decompress(buf), np.float16
                ).reshape(shape).astype(np.float32)
            else:
                out[name] = np.frombuffer(
                    zlib.decompress(buf), np.int32
                ).reshape(shape)
        return out

    # -- core API -----------------------------------------------------------------

    def __contains__(self, key: BlockKey) -> bool:
        return tuple(key) in self._blocks

    def __len__(self) -> int:
        return len(self._blocks)

    def add(self, key: BlockKey, payload: Dict[str, np.ndarray]) -> None:
        key = tuple(key)
        if len(self._blocks) >= self.conf.max_blocks and key not in self._blocks:
            self._blocks.pop(next(iter(self._blocks)))
        self._blocks[key] = self._pack(payload)
        self._autosave()

    def get(self, key: BlockKey) -> Dict[str, np.ndarray]:
        key = tuple(key)
        packed = self._blocks.pop(key)  # LRU refresh: reinsert as newest
        self._blocks[key] = packed
        return self._unpack(packed)

    def keys(self) -> List[BlockKey]:
        # snapshot, not a view: get() reorders the dict for LRU recency,
        # which would fault `for k in db.keys(): db.get(k)` loops
        return list(self._blocks.keys())

    def get_with_neighbors(self, key: BlockKey) -> List[Dict[str, np.ndarray]]:
        """Payloads of a block and its 8 neighbors, present ones only
        (CraterDB.get_block_data_with_neighbors)."""
        bx, by = key
        out = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                k = (bx + dx, by + dy)
                if k in self._blocks:
                    out.append(self.get(k))
        return out

    # -- region queries -------------------------------------------------------------

    def occupancy(self, region: Tuple[int, int, int, int]) -> np.ndarray:
        """Boolean matrix over ``(bx0, bx1, by0, by1)`` (exclusive upper):
        True where a block exists (CraterDB occupancy matrices)."""
        bx0, bx1, by0, by1 = region
        occ = np.zeros((bx1 - bx0, by1 - by0), bool)
        for (bx, by) in self._blocks:
            if bx0 <= bx < bx1 and by0 <= by < by1:
                occ[bx - bx0, by - by0] = True
        return occ

    def missing_blocks(self, region: Tuple[int, int, int, int]) -> List[BlockKey]:
        bx0, bx1, by0, by1 = region
        return [
            (bx, by)
            for bx in range(bx0, bx1)
            for by in range(by0, by1)
            if (bx, by) not in self._blocks
        ]

    def missing_rectangles(
        self, region: Tuple[int, int, int, int]
    ) -> List[Tuple[int, int, int, int]]:
        """Missing area decomposed into maximal block rectangles
        ``(bx0, by0, n_bx, n_by)`` — one Poisson draw each."""
        bx0, _, by0, _ = region
        occ = self.occupancy(region)
        return [
            (bx0 + r, by0 + c, hh, ww)
            for r, c, hh, ww in decompose_empty_rectangles(occ)
        ]

    # -- persistence -----------------------------------------------------------------

    def _autosave(self) -> None:
        if getattr(self, "_loading", False):
            return
        if not self.conf.save_to_disk or self.conf.folder is None:
            return
        self._since_save += 1
        if self._since_save >= self.conf.write_to_disk_interval:
            self.save_to_disk(self.conf.folder)

    def save_to_disk(self, folder: str) -> None:
        """One npz of raw field arrays + a JSON index; compressed payloads
        are stored decompressed (portable across codec availability)."""
        os.makedirs(folder, exist_ok=True)
        arrays = {}
        index = []
        # list() copy: get() reorders the dict for LRU recency, which would
        # otherwise fault the live-dict iteration
        for i, key in enumerate(list(self._blocks)):
            payload = self.get(key)
            fields = {}
            for name, arr in payload.items():
                arr_key = f"b{i}_{name}"
                arrays[arr_key] = arr
                fields[name] = arr_key
            index.append({"key": list(key), "fields": fields})
        np.savez_compressed(os.path.join(folder, "blocks.npz"), **arrays)
        with open(os.path.join(folder, "index.json"), "w") as f:
            json.dump(
                {"block_size": self.conf.block_size, "blocks": index}, f
            )
        self._since_save = 0

    def load_from_disk(self, folder: str) -> None:
        with open(os.path.join(folder, "index.json")) as f:
            index = json.load(f)
        # materialize every array BEFORE inserting: add() can trigger an
        # autosave that rewrites blocks.npz while the lazy NpzFile handle
        # is still reading from it (truncating the source mid-load)
        with np.load(os.path.join(folder, "blocks.npz")) as arrays:
            loaded = [
                (tuple(entry["key"]),
                 {name: np.array(arrays[arr_key])
                  for name, arr_key in entry["fields"].items()})
                for entry in index["blocks"]
            ]
        self._loading = True  # no autosaves during the bulk insert
        try:
            for key, payload in loaded:
                self.add(key, payload)
        finally:
            self._loading = False
        self._since_save = 0
