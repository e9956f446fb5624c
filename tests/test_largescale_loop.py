"""Streamed-terrain full-stack closed loop e2e
(visual_terrain_stack_full_terrain.py:293-582 parity): a rover drives across
multiple block shifts to its goal with the controller re-seated on the
shifting window, the costmap refreshed from streamed rocks, and robot/goal
coordinates rebased on every shift."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from husky_rover_mppi.core import heightfield as hfield
from husky_rover_mppi.env import frames
from husky_rover_mppi.env.closed_loop import ClosedLoopConfig
from husky_rover_mppi.env.largescale_loop import (
    LargeScaleClosedLoop,
    LargeScaleLoopConf,
)
from husky_rover_mppi.env.rover_sim import RoverParams
from husky_rover_mppi.mppi.controller import MPPIConfig
from husky_rover_mppi.physics.deformation import (
    DeformationEngineConf,
)
from husky_rover_mppi.terrain.orchestrator import LargeScaleConf
from husky_rover_mppi.terrain.rocks import RockDistConf


def tiny_terrain(**kw):
    """10 m blocks @0.1 m/px, 5-block (50 m) window; smooth LR surface so
    the traverse exercises streaming, not crater climbing."""
    defaults = dict(
        block_size=10.0,
        hr_dem_resolution=0.1,
        lr_pixel_size=2.0,
        hr_dem_num_blocks=1,
        hr_dem_generate_craters=False,
        crater_gen_padding=2.0,
        update_every_n_meters=2.0,
        geo_cm_num_texels_per_level=8,
        geo_cm_num_lods=3,
        terrain_collider_resolution=0.5,
        terrain_collider_build_radius=6.0,
        rock_gen_cfgs=(
            RockDistConf(parent_density=0.005, child_density=3.0, sigma=2.0,
                         scale_min=0.3, scale_max=0.5, block_size=10.0,
                         seed=67),
        ),
        rock_block_span=1,
    )
    defaults.update(kw)
    return LargeScaleConf(**defaults)


def loop_conf(**kw):
    # Reference horizon (H=100, config.yaml) at K=512 — inside the thesis's
    # validated K sweep (350/500/1000) and affordable on the CPU test mesh.
    mppi = MPPIConfig(num_samples=512, horizon=100)
    defaults = dict(
        terrain=tiny_terrain(),
        loop=ClosedLoopConfig(mppi=mppi, rover=RoverParams()),
        start=(0.0, 0.0),
        goal=(45.0, 8.0),
        max_steps=8000,
        seed=3,
    )
    defaults.update(kw)
    return LargeScaleLoopConf(**defaults)


@pytest.fixture(scope="module")
def run_result():
    loop = LargeScaleClosedLoop(loop_conf())
    result = loop.run()
    return loop, result


@pytest.mark.slow
def test_reaches_goal_across_block_shifts(run_result):
    loop, res = run_result
    assert res.block_shifts >= 4, f"only {res.block_shifts} shifts"
    assert res.reached, (
        f"never reached goal; final={res.final_position}, steps={res.steps}"
    )
    assert res.costmap_rebuilds == res.block_shifts
    # the traverse actually covered the distance
    assert res.distance_m > 40.0
    path = res.path_world
    seg = np.linalg.norm(np.diff(path, axis=0), axis=-1).sum()
    assert seg >= res.distance_m - 1.0
    # shift latency is measured and finite
    assert len(res.shift_latencies_s) == res.block_shifts
    assert all(t > 0 for t in res.shift_latencies_s)


@pytest.mark.slow
def test_costmap_refreshed_from_streamed_rocks(run_result):
    """Every rock in the live rocks_data rasterizes to saturated cost in the
    current costmap: a rock entering the window provably raises the cost the
    controller sees (the :546-576 rebuild path)."""
    loop, _ = run_result
    obstacles = loop.lstm.extract_rocks_data()
    assert obstacles.shape[0] > 0, "test world produced no rocks"
    cm = loop.costmap
    hw = float(cm.half_width)
    checked = 0
    for xg, yg, _r in obstacles:
        cx, cy = frames.world_to_controller(
            loop.frame, jnp.asarray(xg), jnp.asarray(yg)
        )
        if abs(float(cx)) > hw - 1 or abs(float(cy)) > hw - 1:
            continue  # outside the window
        ix = int(np.trunc((float(cx) + hw) / float(cm.resolution)))
        iy = int(np.trunc((-float(cy) + hw) / float(cm.resolution)))
        assert float(cm.cost[iy, ix]) >= 0.99
        checked += 1
    assert checked > 0


@pytest.mark.slow
def test_window_reseat_preserves_world_heights(run_result):
    """The heightfield the controller sees after N shifts agrees with the
    terrain manager's world-coordinate height query (window re-seat +
    frame rebase are mutually consistent)."""
    loop, res = run_result
    wx, wy = res.final_position
    h_world = loop.lstm.get_height_global((wx, wy))
    cx, cy = frames.world_to_controller(
        loop.frame, jnp.asarray(wx, jnp.float32), jnp.asarray(wy, jnp.float32)
    )
    h_ctrl = float(hfield.height_at(loop.hf, cx, cy))
    # tolerance: the controller uses the Warp trunc/transposed-weight
    # bilinear (heightfield.py), the streamer a standard floor bilinear —
    # they differ by O(resolution * local slope) within one cell
    assert abs(h_ctrl - h_world) < 2e-2


@pytest.mark.slow
def test_path_mostly_avoids_saturated_cost(run_result):
    """The driven path stays out of the saturated (inflated-obstacle) region
    of the final costmap for the overwhelming majority of points — the
    thesis collision criterion (evaluate_trajectory.py collision counting).
    A small fraction is tolerated because the costmap is only rebuilt on
    block shifts (matching :546-576): rocks sampled between shifts can
    saturate cells the rover already crossed."""
    loop, res = run_result
    cm = loop.costmap
    hw = float(cm.half_width)
    checked = saturated = 0
    for xg, yg in res.path_world:
        cx, cy = frames.world_to_controller(
            loop.frame, jnp.asarray(xg), jnp.asarray(yg)
        )
        if abs(float(cx)) > hw - 1 or abs(float(cy)) > hw - 1:
            continue
        ix = int(np.trunc((float(cx) + hw) / float(cm.resolution)))
        iy = int(np.trunc((-float(cy) + hw) / float(cm.resolution)))
        checked += 1
        saturated += float(cm.cost[iy, ix]) >= 0.999
    assert checked > 100
    assert saturated / checked < 0.05, f"{saturated}/{checked} saturated"


@pytest.mark.slow
def test_prestaged_costmap_matches_synchronous_rebuild():
    """Pre-staged shifts actually fire (the heading-lookahead predictor
    catches boundary crossings) and every staged costmap is bit-identical
    to the synchronous rebuild at the same anchor (asserted in-loop via
    verify_prestage) — the correctness contract of hiding the shift latency
    (high_resolution_DEM_workers.py:199-765 role)."""
    conf = loop_conf(
        loop=ClosedLoopConfig(mppi=MPPIConfig(num_samples=128, horizon=50)),
        goal=(32.0, 5.0),
        max_steps=6000,
        verify_prestage=True,
    )
    loop = LargeScaleClosedLoop(conf)
    res = loop.run()
    assert res.block_shifts >= 2
    assert res.prestage_hits >= 1, (
        f"prestage never hit: {res.prestage_hits}h/{res.prestage_misses}m "
        f"over {res.block_shifts} shifts"
    )


def test_deformation_lowers_terrain_under_track():
    """With the deformation engine enabled the rover's pass visibly lowers
    the DEM and subsequent rollouts see the new heights
    (simulation_manager_ros2.py:231-233 + deformation_engine.py:695-721)."""
    conf = loop_conf(
        loop=ClosedLoopConfig(mppi=MPPIConfig(num_samples=128, horizon=50)),
        goal=(8.0, 0.0),
        max_steps=1200,
        # fine-grained chunks keep this short traverse inside its starting
        # block (a transient boundary crossing would roll the window and
        # defeat the before/after locality comparison)
        terrain_check_every=3,
        deform=DeformationEngineConf(
            terrain_resolution=0.1,
        ),
    )
    loop = LargeScaleClosedLoop(conf)
    streamer = loop.lstm.map_manager.streamer
    before = np.asarray(streamer.window).copy()
    res = loop.run()
    after = np.asarray(streamer.window)
    assert res.reached
    diff = after - before
    assert diff.min() < -1e-4, "no visible deformation"
    # deformation is local: most of the window untouched
    assert (np.abs(diff) < 1e-9).mean() > 0.9
    # the controller's live heightfield is the deformed window
    np.testing.assert_array_equal(np.asarray(loop.hf.z), after)


def test_cli_largescale_mode(tmp_path, capsys):
    """mode=largescale end-to-end through the CLI: the environment config's
    largescale group drives the orchestrator (the reference's
    cfg/environment/largescale.yaml -> LargeScaleTerrainConf wiring)."""
    import json
    import yaml

    from husky_rover_mppi import cli

    cfg = {
        "mode": "largescale",
        "seed": 3,
        "max_steps": 1500,
        "environment": {
            "largescale": {
                "block_size": 10.0,
                "hr_dem_resolution": 0.1,
                "lr_pixel_size": 2.0,
                "hr_dem_num_blocks": 1,
                "hr_dem_generate_craters": False,
                "crater_gen_padding": 2.0,
                "update_every_n_meters": 2.0,
                "geo_cm_num_texels_per_level": 8,
                "geo_cm_num_lods": 3,
                "terrain_collider_resolution": 0.5,
                "terrain_collider_build_radius": 6.0,
                "rock_gen_cfgs": [
                    {"parent_density": 0.005, "child_density": 3.0,
                     "sigma": 2.0, "scale_min": 0.3, "scale_max": 0.5,
                     "block_size": 10.0, "seed": 67},
                ],
                "rock_block_span": 1,
            },
        },
        "mppi": {"num_samples": 128, "horizon": 50},
        "start": {"x": 0.0, "y": 0.0},
        "goal": {"x": 16.0, "y": 3.0},
    }
    path = tmp_path / "ls.yaml"
    path.write_text(yaml.safe_dump(cfg))
    rc = cli.main([f"--config={path}"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mode"] == "largescale"
    assert out["reached"]
    assert out["block_shifts"] >= 1
    assert out["shift_latency_ms"]["mean"] is not None


@pytest.mark.slow
def test_reference_scale_window_builds():
    """The shipped largescale defaults instantiate the reference demo's
    scale — 25 m blocks @2.5 cm/px, num_blocks=2 => a 7000^2-px window and
    an 875^2 costmap (visual_terrain_stack_full_terrain.py:424-426,
    151-203) — and the streamed window survives a full block shift."""
    from husky_rover_mppi.terrain.orchestrator import (
        LargeScaleTerrainManager,
    )

    conf = LargeScaleConf()
    assert conf.streamer_conf.window_px == 7000
    assert conf.streamer_conf.resolution == 0.025
    lstm = LargeScaleTerrainManager(conf)
    lstm.build()
    w = lstm.map_manager.streamer.window
    assert w.shape == (7000, 7000)
    sub = np.asarray(
        jax.jit(lambda z: z[::100, ::100])(w))
    assert np.isfinite(sub).all()
    assert sub.std() > 0.01, "window has no terrain relief"
    # costmap dimensions follow the window/8 rule
    loop_c = LargeScaleLoopConf(terrain=conf)
    assert loop_c.costmap_size == 875
    # height queries are consistent with the window contents
    h = float(lstm.get_height_global((3.0, 4.0)))
    assert np.isfinite(h)
    # one full block shift re-seats the window without breaking finiteness
    shifted, _ = lstm.update_visual_mesh((26.0, 0.0))
    assert shifted
    sub2 = np.asarray(jax.jit(lambda z: z[::100, ::100])(
        lstm.map_manager.streamer.window))
    assert np.isfinite(sub2).all()
    # carried-over content: the overlapping region of the old window moved
    # by exactly one block (1000 px) along x
    np.testing.assert_allclose(sub2[:-10, :], sub[10:, :], atol=1e-5)


def test_checkpoint_resume_continues(tmp_path):
    """A short traverse checkpoints mid-way and a resumed loop continues
    from the saved cursor (structure/cursor round-trip; the bit-identity
    contract is pinned by the slow test below)."""
    import dataclasses

    base = loop_conf(
        loop=ClosedLoopConfig(mppi=MPPIConfig(num_samples=64, horizon=30)),
        goal=(40.0, 6.0),
        max_steps=120,
        pipeline_depth=0,
    )
    ck = tmp_path / "ck.npz"
    part = LargeScaleClosedLoop(dataclasses.replace(
        base, checkpoint_path=str(ck), checkpoint_every_steps=60))
    part.run()
    assert ck.exists()

    loop2, info = LargeScaleClosedLoop.resume(
        dataclasses.replace(base, max_steps=240), str(ck))
    assert info["steps"] in (60, 72, 120)
    res = loop2.run(_resume=info)
    assert res.steps == 240
    # the resumed path includes the saved prefix
    assert res.path_world.shape[0] == 240 // base.terrain_check_every


@pytest.mark.slow
def test_checkpoint_resume_bit_identical(tmp_path):
    """Interrupt a traverse mid-way (after at least one block shift) and
    resume: the continuation is BIT-IDENTICAL to the uninterrupted run —
    same reached flag, same step count, same recorded world path, same
    final position (terrain blocks are seed-deterministic, the crater RNG
    stream is restored, and the no-deform window re-composes exactly from
    the restored metadata). Synchronous path (pipeline_depth=0): the
    pipelined path's terrain-update timing is coalescing-dependent."""
    import dataclasses

    base = loop_conf(
        loop=ClosedLoopConfig(mppi=MPPIConfig(num_samples=128, horizon=50)),
        goal=(32.0, 5.0),
        max_steps=8000,
        pipeline_depth=0,
    )
    full = LargeScaleClosedLoop(base)
    res_full = full.run()
    assert res_full.reached and res_full.block_shifts >= 1

    cut = 3000  # past the first block shift for this traverse
    ck = tmp_path / "ck.npz"
    part = LargeScaleClosedLoop(dataclasses.replace(
        base, max_steps=cut, checkpoint_path=str(ck),
        checkpoint_every_steps=cut))
    res_part = part.run()
    assert ck.exists()
    assert res_part.block_shifts >= 1, "checkpoint must span a shift"

    loop2, info = LargeScaleClosedLoop.resume(base, str(ck))
    res2 = loop2.run(_resume=info)
    assert res2.reached == res_full.reached
    assert res2.steps == res_full.steps
    np.testing.assert_array_equal(res2.path_world, res_full.path_world)
    assert res2.final_position == res_full.final_position


def test_roll_pass_counts_follows_window():
    """Deformation pass counts roll with the window on a shift: carried
    pixels keep their counts, the newly-exposed band resets (VERDICT r02
    weak #7 / deformation_engine.py:695-721 decay semantics)."""
    from husky_rover_mppi.env.largescale_loop import (
        _roll_pass_counts,
    )

    counts = jnp.arange(36, dtype=jnp.int32).reshape(6, 6)
    out = np.asarray(_roll_pass_counts(counts, 2, 0))
    ref = np.asarray(counts)
    np.testing.assert_array_equal(out[:4], ref[2:])   # carried rows
    assert (out[4:] == 0).all()                        # fresh band zeroed
    out2 = np.asarray(_roll_pass_counts(counts, 0, -3))
    np.testing.assert_array_equal(out2[:, 3:], ref[:, :3])
    assert (out2[:, :3] == 0).all()
    # a jump of >= one full window means the streamer full-rebuilt — nothing
    # carries over, counts reset wholesale instead of wrapping stale state
    # (ADVICE r03)
    assert (np.asarray(_roll_pass_counts(counts, 6, 0)) == 0).all()
    assert (np.asarray(_roll_pass_counts(counts, 0, -7)) == 0).all()
    assert (np.asarray(_roll_pass_counts(counts, 9, 9)) == 0).all()


def test_pipelined_worker_error_surfaces():
    """A failure inside the terrain worker thread (cascade/prestage) must
    surface as an exception from run(), not hang or pass silently."""
    conf = loop_conf(
        loop=ClosedLoopConfig(mppi=MPPIConfig(num_samples=32, horizon=16)),
        goal=(40.0, 5.0),
        max_steps=600,
        pipeline_depth=2,
    )
    loop = LargeScaleClosedLoop(conf)

    def boom(_local):
        raise RuntimeError("cascade exploded")

    loop.lstm.update_visual_mesh = boom
    with pytest.raises(RuntimeError, match="cascade exploded"):
        loop.run(record_path=False)


def test_sync_prestage_error_surfaces():
    """A failure inside the synchronous path's background staging thread is
    kept and raised at the next crossing, not swallowed."""
    conf = loop_conf(
        loop=ClosedLoopConfig(mppi=MPPIConfig(num_samples=32, horizon=16)),
        goal=(40.0, 5.0),
        max_steps=600,
        pipeline_depth=0,
    )
    loop = LargeScaleClosedLoop(conf)

    def boom(*_a):
        raise RuntimeError("staging exploded")

    loop._quantized_update_pos = boom
    with pytest.raises(RuntimeError, match="staging exploded"):
        loop.run(record_path=False)
