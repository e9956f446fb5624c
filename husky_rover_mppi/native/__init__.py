"""ctypes bindings for the native host runtime (``husky_native.cpp``).

The compute path of this framework is JAX/XLA/Pallas on the GPU; this module is
the *host* runtime around it, replacing the reference's native dependencies:

========================  ==================================================
reference                 here
========================  ==================================================
cv2.distanceTransform     :func:`edt_l2` (exact Felzenszwalb) /
(MPPI_isaac.py:374)       :func:`chamfer5` (bit-comparable 5x5 chamfer)
PIL bicubic worker        :func:`bicubic_upsample`
(high_resolution_DEM_
workers.py:107-196)
zfpy block compression    :func:`compress` / :func:`decompress`
(utils.py:33-81)          (fixed-accuracy delta+varint codec)
multiprocessing worker    :class:`TilePool` (C++ threads, shortest-queue
pools (:199-766)          dispatch, poison-pill shutdown)
========================  ==================================================

The shared library builds on first use with ``g++ -O3`` and is cached next
to the source keyed by mtime. Every entry point degrades gracefully:
:func:`available` is False when no compiler exists, and callers fall back to
their pure-Python/JAX paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "husky_native.cpp")
_BUILD_DIR = os.path.join(_HERE, "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libhusky_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None

_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _compile() -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    cmd = [
        "g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
        _SRC, "-o", _LIB_PATH,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed:\n{proc.stderr}")


def _bind(lib: ctypes.CDLL) -> None:
    lib.hn_edt_l2.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, _f32p]
    lib.hn_edt_l2_sq.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, _f32p]
    lib.hn_chamfer5.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, _f32p]
    lib.hn_bicubic_upsample.argtypes = [
        _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _f32p,
    ]
    lib.hn_compress_f32.argtypes = [
        _f32p, ctypes.c_long, ctypes.c_float, _u8p, ctypes.c_long,
    ]
    lib.hn_compress_f32.restype = ctypes.c_long
    lib.hn_decompress_f32.argtypes = [
        _u8p, ctypes.c_long, ctypes.c_float, _f32p, ctypes.c_long,
    ]
    lib.hn_decompress_f32.restype = ctypes.c_long
    lib.hn_pool_create.argtypes = [ctypes.c_int]
    lib.hn_pool_create.restype = ctypes.c_void_p
    lib.hn_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.hn_pool_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_int, _f32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.hn_pool_submit.restype = ctypes.c_long
    lib.hn_pool_pending.argtypes = [ctypes.c_void_p]
    lib.hn_pool_pending.restype = ctypes.c_long
    lib.hn_pool_peek.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_long), ctypes.c_int,
    ]
    lib.hn_pool_peek.restype = ctypes.c_int
    lib.hn_pool_fetch.argtypes = [ctypes.c_void_p, _f32p, ctypes.c_long]
    lib.hn_pool_fetch.restype = ctypes.c_long


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            stale = (
                not os.path.exists(_LIB_PATH)
                or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)
            )
            if stale:
                _compile()
            lib = ctypes.CDLL(_LIB_PATH)
            _bind(lib)
            _lib = lib
        except Exception as exc:  # no compiler / bad toolchain
            _build_error = str(exc)
        return _lib


def available() -> bool:
    """True when the native library is built (or buildable) on this host."""
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def _as_f32(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype=np.float32)


# --- distance transforms -----------------------------------------------------

def edt_l2(occupied: np.ndarray, squared: bool = False) -> np.ndarray:
    """Exact L2 EDT (pixels) of a boolean occupancy grid (True = obstacle)."""
    lib = _load()
    assert lib is not None, _build_error
    occ = np.ascontiguousarray(occupied, dtype=np.uint8)
    h, w = occ.shape
    out = np.empty((h, w), np.float32)
    fn = lib.hn_edt_l2_sq if squared else lib.hn_edt_l2
    fn(occ.ctypes.data_as(_u8p), h, w, out.ctypes.data_as(_f32p))
    return out


def chamfer5(binary_free: np.ndarray) -> np.ndarray:
    """cv2-compatible 5x5 chamfer DT (0 = obstacle, nonzero = free)."""
    lib = _load()
    assert lib is not None, _build_error
    img = np.ascontiguousarray(binary_free, dtype=np.uint8)
    h, w = img.shape
    out = np.empty((h, w), np.float32)
    lib.hn_chamfer5(img.ctypes.data_as(_u8p), h, w, out.ctypes.data_as(_f32p))
    return out


# --- bicubic upsample --------------------------------------------------------

def bicubic_upsample(src: np.ndarray, factor: int) -> np.ndarray:
    """Catmull-Rom (a=-0.5) integer-factor upsample, PIL convention —
    the native twin of ``terrain.upsample.upsample_bicubic``."""
    lib = _load()
    assert lib is not None, _build_error
    src = _as_f32(src)
    h, w = src.shape
    out = np.empty((h * factor, w * factor), np.float32)
    lib.hn_bicubic_upsample(
        src.ctypes.data_as(_f32p), h, w, factor, out.ctypes.data_as(_f32p)
    )
    return out


# --- fixed-accuracy codec ----------------------------------------------------

def compress(arr: np.ndarray, tolerance: float = 1e-3) -> bytes:
    """Compress a float array with bounded error <= tolerance/2 per element
    (the zfpy fixed-accuracy mode the reference uses for rock blocks)."""
    lib = _load()
    assert lib is not None, _build_error
    flat = _as_f32(arr).ravel()
    cap = max(64, flat.size * 10)
    buf = np.empty(cap, np.uint8)
    n = lib.hn_compress_f32(
        flat.ctypes.data_as(_f32p), flat.size, ctypes.c_float(tolerance),
        buf.ctypes.data_as(_u8p), cap,
    )
    if n < 0:
        raise ValueError("compression failed (tolerance <= 0 or overflow)")
    return bytes(buf[:n])


def decompress(data: bytes, shape, tolerance: float = 1e-3) -> np.ndarray:
    lib = _load()
    assert lib is not None, _build_error
    src = np.frombuffer(data, np.uint8)
    cap = int(np.prod(shape)) if len(shape) else 1
    out = np.empty(cap, np.float32)
    n = lib.hn_decompress_f32(
        src.ctypes.data_as(_u8p), src.size, ctypes.c_float(tolerance),
        out.ctypes.data_as(_f32p), cap,
    )
    if n != cap:
        raise ValueError(f"decompressed {n} elements, expected {cap}")
    return out.reshape(shape)


# --- thread-pool tile runner --------------------------------------------------

BICUBIC = 0
EDT = 1
CHAMFER = 2


class TilePool:
    """C++ thread-pool tile runner with shortest-queue dispatch — the native
    re-design of ``BaseWorkerManager`` + its load-balancing dispatcher
    (high_resolution_DEM_workers.py:199-766). Submit returns a job id;
    results arrive on a completion queue drained by :meth:`collect` /
    :meth:`collect_all` (the ``collect_terrain_data`` pattern,
    high_resolution_DEM_generator.py:786-826).
    """

    def __init__(self, n_workers: int = 8):
        lib = _load()
        assert lib is not None, _build_error
        self._lib = lib
        self._pool = lib.hn_pool_create(n_workers)
        self.n_workers = n_workers

    def _handle(self):
        if self._pool is None:
            raise RuntimeError("TilePool is closed")  # not a NULL-deref
        return self._pool

    def submit(self, kind: int, src: np.ndarray, p0: int = 1) -> int:
        """Enqueue a job (BICUBIC: p0 = upscale factor; EDT/CHAMFER:
        src > 0.5 is the binary input)."""
        self._handle()
        src = _as_f32(src)
        h, w = src.shape
        return self._lib.hn_pool_submit(
            self._pool, kind, src.ctypes.data_as(_f32p), h, w, p0
        )

    def pending(self) -> int:
        return self._lib.hn_pool_pending(self._handle())

    def collect(self, wait_ms: int = 1000):
        """Pop one finished (job_id, array), or None on timeout."""
        self._handle()
        jid = ctypes.c_long()
        h = ctypes.c_int()
        w = ctypes.c_int()
        size = ctypes.c_long()
        ok = self._lib.hn_pool_peek(
            self._pool, ctypes.byref(jid), ctypes.byref(h), ctypes.byref(w),
            ctypes.byref(size), wait_ms,
        )
        if not ok:
            return None
        out = np.empty(size.value, np.float32)
        n = self._lib.hn_pool_fetch(
            self._pool, out.ctypes.data_as(_f32p), size.value
        )
        assert n == size.value
        factor = int(round((size.value / (h.value * w.value)) ** 0.5))
        if factor < 1 or factor * factor * h.value * w.value != size.value:
            raise RuntimeError(
                f"TilePool job {jid.value}: output size {size.value} is not "
                f"a square multiple of the {h.value}x{w.value} input")
        return jid.value, out.reshape(h.value * factor, w.value * factor)

    def collect_all(self, timeout_s: float = 60.0) -> dict:
        """Drain until no jobs are pending; {job_id: array}."""
        import time

        results = {}
        deadline = time.monotonic() + timeout_s
        while self.pending() > 0:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{self.pending()} tile jobs still pending")
            got = self.collect(wait_ms=200)
            if got is not None:
                results[got[0]] = got[1]
        return results

    def close(self) -> None:
        if self._pool is not None:
            self._lib.hn_pool_destroy(self._pool)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
