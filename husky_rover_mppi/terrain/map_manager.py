"""DEM ingestion + map orchestration — a re-design of
``src/terrain_management/large_scale_terrain/map_manager.py`` (MapManager,
DemInfo; :29-437) and the asset scripts ``scripts/preprocess_dem.py:13-26`` /
``scripts/get_dems.sh``.

The reference loads pre-generated LR DEM folders (``dem.npy`` + ``dem.yaml``
with size/pixel_size/center, map_manager.py:92-136), flips + transposes into
its row=x axis convention (:88-90), owns the HighResDEMGen, and exposes
LR/HR coordinate transforms (:259-351) plus a blocking ``initialize_hr_dem``
(:406-421). Here the HR generator is the device-resident
:class:`~.streaming.TerrainStreamer`; ingestion adds what a zero-egress
environment needs:

* :func:`synthetic_lola_dem` — spectrally synthesized lunar-like LR terrain
  standing in for the NASA LOLA tiles (``scripts/dems_list.txt``) so the
  full pipeline runs without downloads;
* :func:`read_geotiff` — a minimal uncompressed/strip GeoTIFF float reader
  replacing the GDAL dependency of ``preprocess_dem.py`` (falls back to
  rasterio/GDAL when importable, errors clearly otherwise);
* :func:`preprocess_dem` — ``.tif``/``.npy``/raw-float32 → DEM folder.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Optional, Tuple

import numpy as np

from .streaming import StreamerConf, TerrainStreamer


@dataclasses.dataclass
class DemInfo:
    """dem.yaml contents (map_manager.py:29-44): physical size (m), pixel
    size (m/px) and the world coordinate of the DEM center."""

    size: Tuple[float, float]
    pixel_size: Tuple[float, float]
    center: Tuple[float, float] = (0.0, 0.0)

    def to_dict(self) -> dict:
        return {
            "size": list(self.size),
            "pixel_size": list(self.pixel_size),
            "center": list(self.center),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DemInfo":
        return cls(
            size=tuple(float(v) for v in d["size"]),
            pixel_size=tuple(float(v) for v in d["pixel_size"]),
            center=tuple(float(v) for v in d.get("center", (0.0, 0.0))),
        )


# --- DEM folders (dem.npy + dem.yaml) ----------------------------------------

def save_dem_folder(path: str, dem: np.ndarray, pixel_size: float,
                    center: Tuple[float, float] = (0.0, 0.0)) -> None:
    """Write the reference's DEM folder layout (dem.npy + dem.yaml)."""
    from ..aux.config import dump_yaml

    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "dem.npy"), np.asarray(dem, np.float32))
    info = DemInfo(
        size=(dem.shape[0] * pixel_size, dem.shape[1] * pixel_size),
        pixel_size=(pixel_size, pixel_size),
        center=center,
    )
    with open(os.path.join(path, "dem.yaml"), "w") as f:
        f.write(dump_yaml(info.to_dict()))


def load_dem_folder(path: str) -> Tuple[np.ndarray, DemInfo]:
    """Load a DEM folder and apply the reference's axis normalization
    (``np.flip(dem, 0).T`` so row = x, map_manager.py:88-90)."""
    from ..aux.config import load_yaml

    dem = np.load(os.path.join(path, "dem.npy"))
    with open(os.path.join(path, "dem.yaml")) as f:
        info = DemInfo.from_dict(load_yaml(f.read()))
    return np.ascontiguousarray(np.flip(dem, 0).T), info


# --- synthetic LOLA-like terrain ---------------------------------------------

def synthetic_lola_dem(size_px: int = 2000, pixel_size: float = 5.0,
                       seed: int = 42, amplitude: float = 120.0,
                       spectral_slope: float = 2.0) -> np.ndarray:
    """Spectrally synthesized lunar-like LR DEM: isotropic 1/f^slope power
    spectrum (lunar highland PSDs are ~ -2), zero-mean, scaled to a peak
    amplitude comparable to the 5 m/px LOLA tiles the reference ships
    (scripts/dems_list.txt). Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    fx = np.fft.fftfreq(size_px)[:, None]
    fy = np.fft.rfftfreq(size_px)[None, :]
    f = np.sqrt(fx * fx + fy * fy)
    f[0, 0] = 1.0
    phase = rng.uniform(0.0, 2.0 * np.pi, f.shape)
    spec = (f ** (-spectral_slope)) * np.exp(1j * phase)
    spec[0, 0] = 0.0
    z = np.fft.irfft2(spec, s=(size_px, size_px))
    z = z / np.abs(z).max() * amplitude
    return z.astype(np.float32)


# --- GeoTIFF ingestion (GDAL replacement) ------------------------------------

def read_geotiff(path: str) -> np.ndarray:
    """Read a single-band float GeoTIFF.

    Tries rasterio / GDAL when available (full format coverage, as
    ``preprocess_dem.py`` assumes); otherwise parses classic little/big-
    endian TIFF with uncompressed strips, float32/int16 samples — enough for
    raw LOLA exports. Raises ValueError for layouts that need the real GDAL.
    """
    try:
        import rasterio  # type: ignore

        with rasterio.open(path) as src:
            return src.read(1)
    except ImportError:
        pass
    try:
        from osgeo import gdal  # type: ignore

        ds = gdal.Open(path)
        return ds.GetRasterBand(1).ReadAsArray()
    except ImportError:
        pass
    return _read_tiff_minimal(path)


_TIFF_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
                    10: 8, 11: 4, 12: 8, 16: 8, 17: 8}


def _read_tiff_minimal(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"II":
        end = "<"
    elif data[:2] == b"MM":
        end = ">"
    else:
        raise ValueError(f"{path}: not a TIFF")
    magic, ifd_off = struct.unpack(end + "HI", data[2:8])
    if magic != 42:
        raise ValueError(f"{path}: BigTIFF not supported without GDAL")
    (n_entries,) = struct.unpack(end + "H", data[ifd_off:ifd_off + 2])
    tags = {}
    for i in range(n_entries):
        off = ifd_off + 2 + 12 * i
        tag, typ, count = struct.unpack(end + "HHI", data[off:off + 8])
        size = _TIFF_TYPE_SIZES.get(typ, 1) * count
        if size <= 4:
            raw = data[off + 8:off + 8 + size]
        else:
            (ptr,) = struct.unpack(end + "I", data[off + 8:off + 12])
            raw = data[ptr:ptr + size]
        fmt = {3: "H", 4: "I", 1: "B", 12: "d", 11: "f", 16: "Q"}.get(typ)
        if fmt:
            tags[tag] = struct.unpack(end + fmt * count, raw)
    width = tags[256][0]
    height = tags[257][0]
    bits = tags.get(258, (32,))[0]
    compression = tags.get(259, (1,))[0]
    sample_format = tags.get(339, (1,))[0]
    if compression != 1:
        raise ValueError(
            f"{path}: compressed TIFF (scheme {compression}) needs GDAL/"
            "rasterio; run the reference's preprocess_dem.py path instead"
        )
    if 322 in tags:
        raise ValueError(f"{path}: tiled TIFF needs GDAL/rasterio")
    strip_offsets = tags[273]
    strip_counts = tags[279]
    dtype = {(3, 32): np.float32, (3, 64): np.float64,
             (2, 16): np.int16, (1, 16): np.uint16,
             (1, 8): np.uint8}.get((sample_format, bits))
    if dtype is None:
        raise ValueError(f"{path}: sample format {sample_format}/{bits} bits")
    buf = b"".join(
        data[o:o + c] for o, c in zip(strip_offsets, strip_counts)
    )
    arr = np.frombuffer(buf, dtype=np.dtype(dtype).newbyteorder(end))
    return arr[: width * height].reshape(height, width).astype(np.float32)


def preprocess_dem(src_path: str, out_folder: str, pixel_size: float = 5.0,
                   center: Tuple[float, float] = (0.0, 0.0)) -> DemInfo:
    """``scripts/preprocess_dem.py`` equivalent: GeoTIFF/.npy/raw-float32 →
    DEM folder (dem.npy + dem.yaml)."""
    if src_path.endswith(".npy"):
        dem = np.load(src_path)
    elif src_path.endswith((".tif", ".tiff")):
        dem = read_geotiff(src_path)
    else:
        raw = np.fromfile(src_path, np.float32)
        side = int(round(raw.size ** 0.5))
        if side * side != raw.size:
            raise ValueError(f"{src_path}: raw float32 file is not square")
        dem = raw.reshape(side, side)
    save_dem_folder(out_folder, dem, pixel_size, center)
    return DemInfo(
        size=(dem.shape[0] * pixel_size, dem.shape[1] * pixel_size),
        pixel_size=(pixel_size, pixel_size),
        center=center,
    )


# --- map manager --------------------------------------------------------------

@dataclasses.dataclass
class MapManagerConf:
    """MMConf essentials (map_manager.py:47-72): the LR source plus the HR
    streamer configuration."""

    folder_path: Optional[str] = None    # DEM folder; None -> synthetic
    lr_pixel_size: float = 5.0
    synthetic_size_px: int = 2000
    seed: int = 42
    streamer: StreamerConf = dataclasses.field(default_factory=StreamerConf)

    def __post_init__(self) -> None:
        assert self.lr_pixel_size > 0
        if self.streamer.lr_resolution != self.lr_pixel_size:
            self.streamer = dataclasses.replace(
                self.streamer, lr_resolution=self.lr_pixel_size
            )


class MapManager:
    """Owns the LR DEM and the HR streamer; converts coordinates and answers
    height/normal queries in world space (MapManager, map_manager.py:29-437).

    The reference's blocking ``initialize_hr_dem`` (worker processes +
    spin-wait, :406-421) is :meth:`initialize_hr_dem` here — one streamer
    update whose device work is async-dispatched and awaited on first use.
    """

    def __init__(self, conf: MapManagerConf):
        self.conf = conf
        if conf.folder_path is not None:
            self.lr_dem, self.info = load_dem_folder(conf.folder_path)
        else:
            self.lr_dem = synthetic_lola_dem(
                conf.synthetic_size_px, conf.lr_pixel_size, conf.seed
            )
            size = conf.synthetic_size_px * conf.lr_pixel_size
            self.info = DemInfo(
                size=(size, size),
                pixel_size=(conf.lr_pixel_size, conf.lr_pixel_size),
            )
        self.streamer = TerrainStreamer(conf.streamer, self.lr_dem)

    # -- coordinate transforms (map_manager.py:259-351) -----------------------

    def lr_meters_to_pixels(self, xy) -> Tuple[float, float]:
        px = self.info.pixel_size[0]
        h, w = self.lr_dem.shape
        return (xy[0] / px + h // 2, xy[1] / px + w // 2)

    def lr_pixels_to_meters(self, ij) -> Tuple[float, float]:
        px = self.info.pixel_size[0]
        h, w = self.lr_dem.shape
        return ((ij[0] - h // 2) * px, (ij[1] - w // 2) * px)

    def hr_meters_to_pixels(self, xy) -> Tuple[float, float]:
        ox, oy = self.streamer.window_origin()
        res = self.streamer.conf.resolution
        return ((xy[0] - ox) / res, (xy[1] - oy) / res)

    # -- lifecycle -------------------------------------------------------------

    def initialize_hr_dem(self, position=(0.0, 0.0)) -> None:
        """Build the first HR window around ``position``
        (initialize_hr_dem, map_manager.py:406-421)."""
        self.streamer.update(position)

    def update(self, position) -> bool:
        """Shift the HR window if ``position`` left the center block."""
        return self.streamer.update(position)

    def is_map_done(self) -> bool:
        """The reference's worker-pool completion poll
        (large_scale_terrain_manager.py:27-28); device dispatch is
        synchronous-on-await here, so the window is complete once built."""
        return self.streamer.window is not None

    # -- queries ---------------------------------------------------------------

    def get_height(self, x, y):
        return self.streamer.get_height(x, y)

    def get_normal(self, x, y):
        return self.streamer.get_normal(x, y)

    def get_lr_height(self, x, y) -> float:
        """Nearest-pixel LR height (coarse fallback outside the HR window)."""
        i, j = self.lr_meters_to_pixels((x, y))
        h, w = self.lr_dem.shape
        return float(self.lr_dem[int(np.clip(round(i), 0, h - 1)),
                                 int(np.clip(round(j), 0, w - 1))])

    def hr_window_heightfield(self, dtype=None):
        """The current HR window wrapped for the MPPI controller — the
        Surface-rebinding path of the full stack
        (visual_terrain_stack_full_terrain.py:423, 558-567)."""
        from ..core.heightfield import HeightField

        assert self.streamer.window is not None, "call initialize_hr_dem first"
        half = self.streamer.conf.window_size / 2.0
        return HeightField.create(self.streamer.window, half, dtype=dtype)
