"""The fused rollout kernel (ops/rollout_pallas.py) must reproduce the XLA
rollout path: the same cells read, the same math op for op (differences
only where the compilers contract multiply-adds differently), and the
kernel-engine control step must make the same control decisions as the
direct engine.

The CPU tests run the kernel in the Pallas interpreter; the tests marked
``gpu`` compile it for the card (``python -m pytest tests/ -m gpu --gpu``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from husky_rover_mppi.core import HeightField
from husky_rover_mppi.mppi import (
    ControllerState,
    MPPIConfig,
    RobotState,
    mppi_step,
    sample_noise,
)
from husky_rover_mppi.mppi import rollout as ro
from husky_rover_mppi.mppi.controller import select_engine
from husky_rover_mppi.mppi.critics import Costmap
from husky_rover_mppi.ops import rollout_pallas as rp

F32 = jnp.float32


def _world(rng, grid=512, hw=25.0):
    z = jnp.asarray(rng.uniform(0.0, 5.0, (grid, grid)), F32)
    return HeightField.create(z, hw, dtype=F32)


def _inputs(rng, K, H, vmax=2.0):
    lin = jnp.asarray(rng.uniform(0, vmax, (K, H)), F32)
    ang = jnp.asarray(rng.uniform(-1, 1, (K, H)), F32)
    return lin, ang


def _assert_matches(got, ref, atol=5e-4, same_wheels=0.98):
    """Trajectory, headings and wheel-track positions agree to FMA-level
    drift; nearest-cell wheel heights are off by at most one cell where
    that drift crosses a cell boundary, so nearly all are bit-identical."""
    for name in ("trajectory", "headings"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)), np.asarray(getattr(ref, name)),
            rtol=0, atol=atol, err_msg=name)
    for name in ("left_wheel", "right_wheel"):
        g = np.asarray(getattr(got, name))
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(g[..., :2], r[..., :2], rtol=0, atol=atol,
                                   err_msg=name)
        assert (g[..., 2] == r[..., 2]).mean() > same_wheels, name


def _pallas(hf, pos, heading, lin, ang, wheels=True):
    return ro.rollout_25d_pallas(hf, pos, heading, lin, ang, 0.045,
                                 compute_wheels=wheels, interpret=True)


def test_kernel_matches_xla_rollout(rng):
    """Several full blocks (K=128) over a 60-step horizon, wheels on."""
    hf = _world(rng)
    pos = jnp.asarray([-3.0, 2.0], F32)
    heading = jnp.asarray([0.9, 0.43, 0.0], F32)
    lin, ang = _inputs(rng, 128, 60)
    ref = ro.rollout_25d(hf, pos, heading, lin, ang, 0.045)
    _assert_matches(_pallas(hf, pos, heading, lin, ang), ref)


def test_kernel_k1_block_matches_xla_rollout(rng):
    """The K=1 optimal rollout runs on one narrow block (padded to 16
    lanes); the padding lanes are sliced off."""
    hf = _world(rng)
    pos = jnp.asarray([4.0, -1.0], F32)
    heading = jnp.asarray([-0.3, 0.95, 0.0], F32)
    lin, ang = _inputs(rng, 1, 80)
    assert rp.block_width(1) == 16
    ref = ro.rollout_25d(hf, pos, heading, lin, ang, 0.045)
    got = _pallas(hf, pos, heading, lin, ang)
    assert got.trajectory.shape == (1, 80, 3)
    _assert_matches(got, ref, same_wheels=0.95)


@pytest.mark.parametrize("K", [37, 200])
def test_kernel_ragged_k_matches_xla_rollout(rng, K):
    """K that is not a multiple of the block width: the last block is
    padded with copies of the last sample."""
    hf = _world(rng)
    pos = jnp.asarray([1.5, -2.0], F32)
    heading = jnp.asarray([0.6, -0.8, 0.0], F32)
    lin, ang = _inputs(rng, K, 30)
    ref = ro.rollout_25d(hf, pos, heading, lin, ang, 0.045)
    got = _pallas(hf, pos, heading, lin, ang)
    assert got.trajectory.shape == (K, 30, 3)
    _assert_matches(got, ref)


def test_kernel_clamps_like_direct_off_the_window(rng):
    """Rollouts that leave the window read the clamped edge cells, exactly
    as the direct path's jit gathers do."""
    z = jnp.asarray(rng.uniform(0.0, 0.05, (64, 64)), F32)
    hf = HeightField.create(z, 4.0, dtype=F32)
    pos = jnp.asarray([3.0, 3.0], F32)
    heading = jnp.asarray([0.7, 0.7, 0.0], F32)
    lin = jnp.full((16, 40), 2.0, F32)
    ang = jnp.asarray(rng.uniform(-0.3, 0.3, (16, 40)), F32)
    ref = ro.rollout_25d(hf, pos, heading, lin, ang, 0.045)
    assert np.abs(np.asarray(ref.trajectory[..., :2])).max() > 4.0
    _assert_matches(_pallas(hf, pos, heading, lin, ang), ref)


def test_rollout_chunk_wheels_skip_matches_traj(rng):
    """wheels=False returns identical trajectory/headings (the wheel
    lookups are pure consumers of the carry — skipping them cannot change
    the rollout) with lw = rw = traj aliases."""
    hf = _world(rng, grid=256)
    K, H = 8, 20
    x = jnp.zeros((K,), F32)
    y = jnp.zeros((K,), F32)
    hd = jnp.broadcast_to(jnp.asarray([1.0, 0.2, 0.0], F32), (K, 3))
    hd = hd / jnp.linalg.norm(hd, axis=-1, keepdims=True)
    lin, ang = _inputs(rng, K, H)
    full = rp.rollout_chunk(hf, x, y, hd, lin, ang, 0.045, interpret=True)
    slim = rp.rollout_chunk(hf, x, y, hd, lin, ang, 0.045, interpret=True,
                            wheels=False)
    np.testing.assert_array_equal(np.asarray(full[0]), np.asarray(slim[0]))
    np.testing.assert_array_equal(np.asarray(full[1]), np.asarray(slim[1]))
    np.testing.assert_array_equal(np.asarray(slim[2]), np.asarray(slim[0]))
    np.testing.assert_array_equal(np.asarray(slim[3]), np.asarray(slim[0]))


@pytest.mark.parametrize("slope_critic", ["wheels", "body"])
def test_pallas_engine_full_step_decisions(rng, monkeypatch, slope_critic):
    """gather_engine='pallas' reaches the same control decisions as the
    direct engine: the same softmax weights up to tolerance and the same
    optimal command."""
    monkeypatch.setattr(ro, "rollout_25d_pallas", functools.partial(
        ro.rollout_25d_pallas, interpret=True))
    hf = _world(rng)
    cmap = jnp.asarray(
        np.clip(rng.uniform(-0.5, 1.0, (64, 64)), 0.0, 1.0), F32)
    cm = Costmap(cost=cmap, half_width=jnp.asarray(25.0, F32),
                 resolution=jnp.asarray(50.0 / 64, F32))
    goal = jnp.asarray([18.0, 15.0], F32)
    robot = RobotState.create(-10.0, -8.0, [1.0, 0.3, 0.0], dtype=F32)
    noise = sample_noise(jax.random.key(7), 128, 40, F32)
    base = dict(num_samples=128, horizon=40, exact=False,
                slope_critic=slope_critic)
    ctrl0 = ControllerState.create(MPPIConfig(**base), F32)

    _, ref = mppi_step(MPPIConfig(**base, gather_engine="direct"), hf, cm,
                       goal, robot, ctrl0, noise)
    _, got = mppi_step(MPPIConfig(**base, gather_engine="pallas"), hf, cm,
                       goal, robot, ctrl0, noise)

    np.testing.assert_allclose(
        np.asarray(got.weights), np.asarray(ref.weights), rtol=0, atol=1e-3)
    np.testing.assert_allclose(
        np.asarray(got.linear_velocity), np.asarray(ref.linear_velocity),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(got.angular_velocity), np.asarray(ref.angular_velocity),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(got.optimal_trajectory), np.asarray(ref.optimal_trajectory),
        rtol=0, atol=1e-3)


def test_pallas_requires_f32_field(rng):
    z = jnp.asarray(rng.uniform(0, 5, (256, 256)), jnp.float64)
    hf = HeightField.create(z, 25.0, dtype=jnp.float64)
    with pytest.raises(ValueError, match="float32"):
        rp.rollout_chunk(
            hf,
            jnp.zeros((4,), jnp.float64), jnp.zeros((4,), jnp.float64),
            jnp.tile(jnp.asarray([1.0, 0, 0], jnp.float64), (4, 1)),
            jnp.ones((4, 8), jnp.float64), jnp.zeros((4, 8), jnp.float64),
            0.045, interpret=True)


def test_kernel_refused_off_gpu(rng):
    """Asking for the compiled kernel anywhere but the GPU raises instead
    of quietly running the interpreter."""
    hf = _world(rng, grid=64)
    lin, ang = _inputs(rng, 4, 8)
    with pytest.raises(ValueError, match="only for the GPU"):
        ro.rollout_25d_pallas(hf, jnp.zeros((2,), F32),
                              jnp.asarray([1.0, 0.0, 0.0], F32), lin, ang,
                              0.045)


def test_auto_engine_selection():
    """"auto" takes the fused kernel on the GPU and XLA gathers elsewhere;
    an explicit engine always stands."""
    auto = MPPIConfig(num_samples=1000, horizon=100)
    assert auto.gather_engine == "auto"
    assert select_engine(auto, "gpu") == "pallas"
    assert select_engine(auto, "cpu") == "direct"
    assert select_engine(auto) == "direct"  # this test process is on the CPU
    for engine in ("direct", "onehot", "pallas"):
        cfg = MPPIConfig(gather_engine=engine)
        assert select_engine(cfg, "gpu") == engine
        assert select_engine(cfg, "cpu") == engine


def test_block_width():
    """Power-of-two blocks: the default width for large K, the smallest
    power of two (at least 16) that holds a smaller batch."""
    assert rp.block_width(16384) == rp.BLOCK_K
    assert rp.block_width(rp.BLOCK_K + 1) == rp.BLOCK_K
    assert rp.block_width(100, block_k=128) == 128
    assert rp.block_width(20, block_k=128) == 32
    assert rp.block_width(1) == 16
    assert rp.block_width(1000, block_k=64) == 64


# -- on the card -------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("K, H", [(1000, 100), (16384, 64)])
@pytest.mark.parametrize("wheels", [True, False])
def test_compiled_kernel_matches_direct_on_gpu(gpu, K, H, wheels):
    """The compiled kernel against XLA's direct path, both on the card, on
    the 150 m thesis map. Where the compilers' float32 drift moves a point
    across a cell boundary, the (discontinuous) reference bilinear height
    and the nearest-cell lookups jump and that sample diverges, so each
    output must agree within 1e-3 on >= 99.9% of its entries."""
    from husky_rover_mppi.terrain import STANDALONE_CRATER_BUMPS, crater_surface

    z = crater_surface(1500, 75.0, STANDALONE_CRATER_BUMPS, dtype=F32)
    hf = HeightField.create(z, 75.0, dtype=F32)
    rng = np.random.default_rng(3)
    lin, ang = _inputs(rng, K, H)
    pos = jnp.asarray([-60.0, -60.0], F32)
    heading = jnp.asarray([0.89, 0.45, 0.0], F32)
    ref = jax.jit(lambda l, a: ro.rollout_25d(hf, pos, heading, l, a,
                                              0.045))(lin, ang)
    got = jax.jit(lambda l, a: ro.rollout_25d_pallas(
        hf, pos, heading, l, a, 0.045, compute_wheels=wheels))(lin, ang)
    names = ("trajectory", "headings") + (
        ("left_wheel", "right_wheel") if wheels else ())
    for name in names:
        err = np.abs(np.asarray(getattr(got, name))
                     - np.asarray(getattr(ref, name)))
        assert np.mean(err <= 1e-3) >= 0.999, (name, float(err.max()))
