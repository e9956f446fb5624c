"""Block DB layer: largest-empty-rectangle, decomposition, BlockDB,
persistence, streamer region sampling (terrain/database.py)."""

import numpy as np
import pytest

from husky_rover_mppi.terrain.database import (
    BlockDB,
    BlockDBConf,
    decompose_empty_rectangles,
    largest_empty_rectangle,
)


def _brute_force_ler(occ):
    h, w = occ.shape
    best = 0
    for r0 in range(h):
        for c0 in range(w):
            for r1 in range(r0, h):
                for c1 in range(c0, w):
                    if not occ[r0:r1 + 1, c0:c1 + 1].any():
                        best = max(best, (r1 - r0 + 1) * (c1 - c0 + 1))
    return best


def test_largest_empty_rectangle_vs_bruteforce():
    rng = np.random.default_rng(5)
    for _ in range(20):
        occ = rng.random((7, 9)) < 0.3
        r0, c0, hh, ww = largest_empty_rectangle(occ)
        if hh:
            assert not occ[r0:r0 + hh, c0:c0 + ww].any()
        assert hh * ww == _brute_force_ler(occ)


def test_largest_empty_rectangle_edge_cases():
    assert largest_empty_rectangle(np.ones((3, 3), bool))[2:] == (0, 0)
    r0, c0, hh, ww = largest_empty_rectangle(np.zeros((3, 5), bool))
    assert (hh, ww) == (3, 5)


def test_decomposition_covers_all_empty_cells():
    rng = np.random.default_rng(6)
    occ = rng.random((10, 12)) < 0.4
    rects = decompose_empty_rectangles(occ)
    covered = occ.copy()
    for r0, c0, hh, ww in rects:
        assert not occ[r0:r0 + hh, c0:c0 + ww].any()  # disjoint from occupied
        assert not covered[r0:r0 + hh, c0:c0 + ww].all() or hh * ww == 0
        covered[r0:r0 + hh, c0:c0 + ww] = True
    assert covered.all()


def _payload(rng, n=20):
    return {
        "coordinates": rng.uniform(-10, 10, (n, 2)).astype(np.float32),
        "radius": rng.uniform(0.3, 2.0, n).astype(np.float32),
        "ids": rng.integers(0, 8, n).astype(np.int32),
    }


def test_blockdb_roundtrip_and_neighbors():
    rng = np.random.default_rng(7)
    db = BlockDB(BlockDBConf(compress=True))
    payloads = {}
    for bx in range(3):
        for by in range(3):
            payloads[(bx, by)] = _payload(rng)
            db.add((bx, by), payloads[(bx, by)])
    back = db.get((1, 1))
    np.testing.assert_allclose(
        back["coordinates"], payloads[(1, 1)]["coordinates"], atol=6e-4
    )
    np.testing.assert_array_equal(back["ids"], payloads[(1, 1)]["ids"])
    assert len(db.get_with_neighbors((1, 1))) == 9
    assert len(db.get_with_neighbors((0, 0))) == 4


def test_blockdb_occupancy_and_missing():
    db = BlockDB(BlockDBConf(compress=False))
    db.add((0, 0), {"a": np.zeros(1)})
    db.add((2, 1), {"a": np.zeros(1)})
    occ = db.occupancy((0, 3, 0, 2))
    assert occ[0, 0] and occ[2, 1]
    assert occ.sum() == 2
    missing = db.missing_blocks((0, 3, 0, 2))
    assert (1, 0) in missing and len(missing) == 4
    rects = db.missing_rectangles((0, 3, 0, 2))
    covered = set()
    for bx0, by0, nbx, nby in rects:
        for bx in range(bx0, bx0 + nbx):
            for by in range(by0, by0 + nby):
                covered.add((bx, by))
    assert covered == set(missing)


def test_blockdb_lru_eviction():
    db = BlockDB(BlockDBConf(compress=False, max_blocks=3))
    for i in range(5):
        db.add((i, 0), {"a": np.full(1, i)})
    assert len(db) == 3
    assert (0, 0) not in db and (4, 0) in db


def test_blockdb_persistence_roundtrip(tmp_path):
    rng = np.random.default_rng(8)
    db = BlockDB(BlockDBConf(compress=True))
    p = _payload(rng)
    db.add((3, -2), p)
    db.add((0, 0), _payload(rng, n=5))
    db.save_to_disk(str(tmp_path / "db"))

    db2 = BlockDB(BlockDBConf(compress=False))
    db2.load_from_disk(str(tmp_path / "db"))
    assert set(db2.keys()) == {(3, -2), (0, 0)}
    np.testing.assert_allclose(
        db2.get((3, -2))["coordinates"], p["coordinates"], atol=1.2e-3
    )


def test_blockdb_autosave_interval(tmp_path):
    conf = BlockDBConf(compress=False, save_to_disk=True,
                       write_to_disk_interval=3, folder=str(tmp_path / "auto"))
    db = BlockDB(conf)
    db.add((0, 0), {"a": np.zeros(2)})
    db.add((0, 1), {"a": np.zeros(2)})
    assert not (tmp_path / "auto" / "index.json").exists()
    db.add((0, 2), {"a": np.zeros(2)})
    assert (tmp_path / "auto" / "index.json").exists()


@pytest.fixture(scope="module")
def streamer():
    from husky_rover_mppi.terrain.streaming import (
        StreamerConf, TerrainStreamer)
    from husky_rover_mppi.terrain.craters import CraterSamplerConf

    conf = StreamerConf(
        block_size=8.0, resolution=0.5, lr_resolution=2.0, num_blocks=1,
        pad_size=2.0,
        crater=CraterSamplerConf(densities=[0.05], radius_ranges=[[0.5, 1.5]]),
    )
    lr = np.zeros((64, 64), np.float32)
    return TerrainStreamer(conf, lr)


def test_region_sampling_fills_missing_blocks(streamer):
    n_rects = streamer.sample_craters_by_region(-2, 2, -2, 2)
    assert n_rects >= 1
    for bx in range(-2, 2):
        for by in range(-2, 2):
            assert (bx, by) in streamer.crater_blocks
    # craters land inside their block
    bs = streamer.conf.block_size
    for (bx, by), (coords, radius) in streamer.crater_blocks.items():
        if coords.shape[0]:
            assert (coords[:, 0] >= bx * bs).all()
            assert (coords[:, 0] < (bx + 1) * bs).all()
    # re-sampling the same region is a no-op (all blocks exist)
    assert streamer.sample_craters_by_region(-2, 2, -2, 2) == 0


def test_region_sampling_hardcore_against_neighbors(streamer):
    """New rectangles must respect hardcore distance to craters in
    pre-existing neighbor blocks."""
    streamer.sample_craters_by_region(2, 3, -2, 2)  # extend east
    all_c = np.concatenate(
        [c for c, _ in streamer.crater_blocks.values() if c.shape[0]]
    )
    all_r = np.concatenate(
        [r for _, r in streamer.crater_blocks.values() if r.shape[0]]
    )
    if all_c.shape[0] > 1:
        d = np.linalg.norm(all_c[:, None] - all_c[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        # hardcore: no two crater centers closer than the smaller radius
        min_r = np.minimum(all_r[:, None], all_r[None, :])
        assert (d >= min_r * 0.999).all()


def test_streamer_crater_db_persistence(streamer, tmp_path):
    # crater blocks build lazily since the read-only-window change —
    # populate a span first so persistence has real payload to carry
    streamer.sample_craters_by_region(-2, 2, -2, 2)
    streamer.save_crater_db(str(tmp_path / "craters"))
    from husky_rover_mppi.terrain.streaming import (
        StreamerConf, TerrainStreamer)

    fresh = TerrainStreamer(streamer.conf, np.zeros((64, 64), np.float32))
    fresh.load_crater_db(str(tmp_path / "craters"))
    assert set(fresh.crater_blocks) == set(streamer.crater_blocks)
    key = next(iter(streamer.crater_blocks))
    np.testing.assert_allclose(
        fresh.crater_blocks[key][0], streamer.crater_blocks[key][0]
    )
