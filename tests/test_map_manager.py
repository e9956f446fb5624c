"""DEM ingestion + MapManager (terrain/map_manager.py)."""

import struct

import numpy as np
import pytest

from husky_rover_mppi.terrain import map_manager as mm
from husky_rover_mppi.terrain.streaming import StreamerConf


def _write_minimal_tiff(path, arr):
    """Uncompressed single-strip float32 little-endian TIFF."""
    h, w = arr.shape
    data = arr.astype("<f4").tobytes()
    n_tags = 8
    ifd_off = 8
    data_off = ifd_off + 2 + 12 * n_tags + 4
    header = struct.pack("<2sHI", b"II", 42, ifd_off)
    tags = [
        (256, 3, 1, w),             # ImageWidth
        (257, 3, 1, h),             # ImageLength
        (258, 3, 1, 32),            # BitsPerSample
        (259, 3, 1, 1),             # Compression: none
        (273, 4, 1, data_off),      # StripOffsets
        (277, 3, 1, 1),             # SamplesPerPixel
        (279, 4, 1, len(data)),     # StripByteCounts
        (339, 3, 1, 3),             # SampleFormat: IEEE float
    ]
    body = struct.pack("<H", n_tags)
    for tag, typ, count, value in tags:
        body += struct.pack("<HHII", tag, typ, count, value)
    body += struct.pack("<I", 0)  # next IFD
    with open(path, "wb") as f:
        f.write(header + body + data)


def test_dem_folder_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    dem = rng.normal(size=(32, 20)).astype(np.float32)
    mm.save_dem_folder(str(tmp_path / "site"), dem, pixel_size=5.0,
                       center=(1.0, 2.0))
    loaded, info = mm.load_dem_folder(str(tmp_path / "site"))
    # reference normalization: np.flip(dem, 0).T (map_manager.py:88-90)
    np.testing.assert_array_equal(loaded, np.flip(dem, 0).T)
    assert info.size == (160.0, 100.0)
    assert info.pixel_size == (5.0, 5.0)
    assert info.center == (1.0, 2.0)


def test_synthetic_lola_dem_deterministic():
    a = mm.synthetic_lola_dem(128, seed=3)
    b = mm.synthetic_lola_dem(128, seed=3)
    c = mm.synthetic_lola_dem(128, seed=4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.shape == (128, 128)
    assert np.abs(a).max() == pytest.approx(120.0, rel=1e-5)
    assert abs(a.mean()) < 1.0  # zero-mean spectrum


def test_minimal_tiff_reader(tmp_path):
    rng = np.random.default_rng(1)
    arr = rng.normal(size=(13, 17)).astype(np.float32)
    path = str(tmp_path / "dem.tif")
    _write_minimal_tiff(path, arr)
    back = mm._read_tiff_minimal(path)
    np.testing.assert_array_equal(back, arr)


def test_tiff_reader_rejects_compressed(tmp_path):
    # same writer but lie about compression
    rng = np.random.default_rng(1)
    arr = rng.normal(size=(4, 4)).astype(np.float32)
    path = str(tmp_path / "dem.tif")
    _write_minimal_tiff(path, arr)
    raw = bytearray(open(path, "rb").read())
    # Compression tag (259) value lives at a fixed offset: tag index 3
    off = 8 + 2 + 12 * 3 + 8
    struct.pack_into("<I", raw, off, 5)  # LZW
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="compressed"):
        mm._read_tiff_minimal(path)


def test_preprocess_dem_from_npy_and_tif(tmp_path):
    rng = np.random.default_rng(2)
    arr = rng.normal(size=(16, 16)).astype(np.float32)
    np.save(tmp_path / "src.npy", arr)
    info = mm.preprocess_dem(str(tmp_path / "src.npy"),
                             str(tmp_path / "out"), pixel_size=5.0)
    assert info.size == (80.0, 80.0)
    loaded, _ = mm.load_dem_folder(str(tmp_path / "out"))
    np.testing.assert_array_equal(loaded, np.flip(arr, 0).T)

    _write_minimal_tiff(str(tmp_path / "src.tif"), arr)
    info2 = mm.preprocess_dem(str(tmp_path / "src.tif"),
                              str(tmp_path / "out2"), pixel_size=5.0)
    assert info2.size == (80.0, 80.0)


@pytest.fixture(scope="module")
def manager():
    conf = mm.MapManagerConf(
        lr_pixel_size=2.0,
        synthetic_size_px=128,
        streamer=StreamerConf(
            block_size=8.0, resolution=0.5, lr_resolution=2.0,
            num_blocks=1, pad_size=2.0, generate_craters=False,
        ),
    )
    m = mm.MapManager(conf)
    m.initialize_hr_dem((0.0, 0.0))
    return m


def test_map_manager_initialize_and_window(manager):
    assert manager.is_map_done()
    px = manager.streamer.conf.window_px
    assert manager.streamer.window.shape == (px, px)


def test_map_manager_coordinate_roundtrip(manager):
    ij = manager.lr_meters_to_pixels((10.0, -6.0))
    xy = manager.lr_pixels_to_meters(ij)
    assert xy == pytest.approx((10.0, -6.0))


def test_map_manager_height_matches_lr_source(manager):
    """Without craters the HR window is a bicubic upsample of the LR DEM:
    heights at LR pixel centers should be close to the LR values."""
    for xy in [(0.0, 0.0), (4.0, -4.0), (-6.0, 6.0)]:
        hr = float(manager.get_height(*xy))
        lr = manager.get_lr_height(*xy)
        # bicubic point value vs nearest LR pixel: off by up to half an LR
        # pixel of slope (the synthetic DEM has ~5 m/px gradients)
        assert hr == pytest.approx(lr, abs=6.0)


def test_map_manager_update_shifts(manager):
    before = manager.streamer.anchor
    shifted = manager.update((20.0, 20.0))
    assert shifted
    assert manager.streamer.anchor != before
    # idempotent when staying in the same block
    assert not manager.update((20.0, 20.0))
    manager.update((0.0, 0.0))


def test_map_manager_normals_unit(manager):
    n = np.asarray(manager.get_normal(1.0, 1.0))
    assert n.shape == (3,)
    assert np.linalg.norm(n) == pytest.approx(1.0, abs=1e-5)
    assert n[2] > 0


def test_hr_window_heightfield(manager):
    hf = manager.hr_window_heightfield()
    assert hf.z.shape == (manager.streamer.conf.window_px,) * 2
