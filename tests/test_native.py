"""Native C++ host runtime: EDT/chamfer oracles, bicubic twin, codec,
thread-pool tile runner (husky_rover_mppi/native)."""

import numpy as np
import pytest

from husky_rover_mppi import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason=f"native build unavailable: {native.build_error()}"
)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


def test_edt_exact_vs_bruteforce(rng):
    occ = rng.random((40, 56)) < 0.03
    occ[5, 7] = True  # ensure at least one obstacle
    d = native.edt_l2(occ)
    ys, xs = np.nonzero(occ)
    pts = np.stack([ys, xs], -1).astype(np.float64)
    yy, xx = np.meshgrid(np.arange(40), np.arange(56), indexing="ij")
    grid = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float64)
    brute = np.sqrt(
        ((grid[:, None, :] - pts[None, :, :]) ** 2).sum(-1).min(1)
    ).reshape(40, 56)
    np.testing.assert_allclose(d, brute, atol=1e-4)


def test_edt_matches_jax_ops(rng):
    from husky_rover_mppi.ops.edt import edt_exact

    occ = rng.random((96, 64)) < 0.02
    occ[0, 0] = True
    np.testing.assert_allclose(
        native.edt_l2(occ), np.asarray(edt_exact(occ)), atol=1e-3
    )


def test_edt_squared(rng):
    occ = rng.random((32, 32)) < 0.05
    occ[3, 3] = True
    np.testing.assert_allclose(
        native.edt_l2(occ, squared=True), native.edt_l2(occ) ** 2, rtol=1e-5
    )


def test_chamfer5_matches_python_reference(rng):
    """The C++ chamfer must agree with the (slow) NumPy raster-scan fallback
    in ops/edt.py — both implement cv2's DIST_L2 5x5 weights."""
    from husky_rover_mppi.ops import edt as edt_mod

    free = (rng.random((24, 30)) >= 0.05).astype(np.uint8)
    free[10, 12] = 0
    ours = native.chamfer5(free)

    # the pure-NumPy branch directly (bypass cv2/native dispatch) — shared
    # source of truth instead of a drift-prone inline copy of the weights
    ref = edt_mod._chamfer5_numpy(free)
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    # it feeds the ops-level fallback
    assert edt_mod.chamfer5 is not None


def test_bicubic_matches_jax_kernel(rng):
    from husky_rover_mppi.terrain.upsample import upsample_bicubic

    src = rng.normal(size=(12, 17)).astype(np.float32)
    for factor in (2, 4, 5):
        ours = native.bicubic_upsample(src, factor)
        ref = np.asarray(upsample_bicubic(src, factor))
        assert ours.shape == (12 * factor, 17 * factor)
        np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_codec_roundtrip_and_ratio(rng):
    smooth = np.cumsum(rng.normal(size=50_000).astype(np.float32)) * 0.01
    for tol in (1e-2, 1e-3, 1e-4):
        buf = native.compress(smooth, tol)
        back = native.decompress(buf, smooth.shape, tol)
        # tol/2 quantization + half-ulp of the float32 reconstruction cast
        assert np.abs(back - smooth).max() <= tol / 2 + 3e-7
    buf = native.compress(smooth, 1e-3)
    assert len(buf) < smooth.nbytes / 2  # beats raw f32 2x on smooth data


def test_codec_2d_shapes(rng):
    arr = rng.normal(size=(33, 47)).astype(np.float32)
    buf = native.compress(arr, 1e-3)
    back = native.decompress(buf, arr.shape, 1e-3)
    assert back.shape == arr.shape
    assert np.abs(back - arr).max() <= 5.1e-4


def test_codec_rejects_bad_tolerance():
    with pytest.raises(ValueError):
        native.compress(np.zeros(4, np.float32), 0.0)


def test_tile_pool_bicubic_batch(rng):
    from husky_rover_mppi.terrain.upsample import upsample_bicubic

    srcs = [rng.normal(size=(10, 10)).astype(np.float32) for _ in range(12)]
    refs = [np.asarray(upsample_bicubic(s, 3)) for s in srcs]
    with native.TilePool(4) as pool:
        ids = [pool.submit(native.BICUBIC, s, 3) for s in srcs]
        results = pool.collect_all(timeout_s=30)
    assert len(results) == 12
    for jid, ref in zip(ids, refs):
        np.testing.assert_allclose(results[jid], ref, atol=1e-5)


def test_tile_pool_edt_kind(rng):
    occ = (rng.random((48, 48)) < 0.04).astype(np.float32)
    occ[1, 1] = 1.0
    with native.TilePool(2) as pool:
        jid = pool.submit(native.EDT, occ)
        results = pool.collect_all(timeout_s=30)
    np.testing.assert_allclose(
        results[jid], native.edt_l2(occ > 0.5), atol=1e-6
    )


def test_tile_pool_clean_shutdown_with_pending_results(rng):
    pool = native.TilePool(2)
    for _ in range(4):
        pool.submit(native.BICUBIC, rng.normal(size=(8, 8)).astype(np.float32), 2)
    pool.collect_all(timeout_s=30)
    pool.close()
    pool.close()  # idempotent


def test_rockdb_uses_native_codec():
    from husky_rover_mppi.terrain.rocks import RockBlock, RockDB

    rng = np.random.default_rng(3)
    block = RockBlock(
        coordinates=rng.uniform(-10, 10, (100, 2)).astype(np.float32),
        height=rng.normal(size=100).astype(np.float32),
        quaternion=rng.normal(size=(100, 4)).astype(np.float32),
        scale=rng.uniform(0.05, 0.2, (100, 3)).astype(np.float32),
        ids=rng.integers(0, 16, 100).astype(np.int32),
    )
    db = RockDB(compress=True)
    assert db._native
    db.add((0, 0), block)
    back = db.get((0, 0))
    np.testing.assert_allclose(back.coordinates, block.coordinates, atol=6e-4)
    np.testing.assert_allclose(back.quaternion, block.quaternion, atol=6e-4)
    np.testing.assert_array_equal(back.ids, block.ids)


def test_streamer_consumes_tile_pool(rng):
    """The TilePool is a real pipeline component: on the CPU backend the
    streamer's batched block builds route bicubic upsamples through the C++
    pool, and the
    resulting window matches the pure-device path to bicubic parity
    (atol 1e-5/element)."""
    import jax.numpy as jnp

    from husky_rover_mppi.terrain.streaming import (
        StreamerConf,
        TerrainStreamer,
    )

    lr = rng.normal(size=(64, 64)).astype(np.float32)

    def make(native_pool):
        conf = StreamerConf(
            block_size=10.0, resolution=0.5, lr_resolution=2.0,
            num_blocks=1, pad_size=2.0, generate_craters=True,
            native_pool=native_pool,
        )
        s = TerrainStreamer(conf, lr)
        s.update((0.0, 0.0))
        return s

    s_pool = make("always")
    assert s_pool._get_pool() is not None, "pool not engaged"
    s_dev = make("never")
    np.testing.assert_allclose(
        np.asarray(s_pool.window), np.asarray(s_dev.window), atol=2e-5
    )
    # a shift's entering band also routes through the pool
    s_pool.update((12.0, 0.0))
    s_dev.update((12.0, 0.0))
    np.testing.assert_allclose(
        np.asarray(s_pool.window), np.asarray(s_dev.window), atol=2e-5
    )
