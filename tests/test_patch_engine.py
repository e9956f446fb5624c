"""The MXU one-hot gather engine (core/patch.py) must be bit-identical to
direct indexing: same corners, same wheel heights, same costmap cells, same
whole rollouts, same full MPPI steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from husky_rover_mppi.core import (
    HeightField,
    extract_grid_patch,
    extract_patch,
    grid_lookup,
)
from husky_rover_mppi.core import heightfield as hfield
from husky_rover_mppi.core import patch as patch_mod
from husky_rover_mppi.mppi import (
    ControllerState,
    MPPIConfig,
    RobotState,
    mppi_step,
    sample_noise,
)
from husky_rover_mppi.mppi.critics import (
    Costmap,
    avoid_obstacle_critic,
)
from husky_rover_mppi.mppi.rollout import rollout_25d, rollout_2d


def _world(rng, grid=512, hw=25.0, dtype=jnp.float32):
    z = jnp.asarray(rng.uniform(0.0, 8.0, (grid, grid)), dtype)
    return HeightField.create(z, hw, dtype=dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_corners_bit_identical(rng, dtype):
    hf = _world(rng, dtype=dtype)
    x = jnp.asarray(rng.uniform(-20, 20, (257,)), dtype)
    y = jnp.asarray(rng.uniform(-20, 20, (257,)), dtype)
    # patch centered mid-world covers +-12.8 m at 0.097 m/px -> use center 0
    pf = extract_patch(hf, jnp.asarray(0.0, dtype), jnp.asarray(0.0, dtype), 512)
    ref = jax.jit(hfield.corners_at)(hf, x, y)
    got = jax.jit(patch_mod.corners_at)(pf, x, y)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_wheel_and_bilinear_lookups_bit_identical(rng):
    dtype = jnp.float32
    hf = _world(rng, dtype=dtype)
    pf = extract_patch(hf, jnp.asarray(3.0, dtype), jnp.asarray(-2.0, dtype), 256)
    # stay within the patch's guaranteed +-(256/2)*res reach of its center
    # for both (x, y) and the swapped (y, x) lookups below
    x = jnp.asarray(rng.uniform(-6, 7, (300,)), dtype)
    y = jnp.asarray(rng.uniform(-6, 7, (300,)), dtype)
    np.testing.assert_array_equal(
        np.asarray(patch_mod.nearest_height(pf, x, y)),
        np.asarray(hfield.nearest_height(hf, x, y)),
    )
    np.testing.assert_array_equal(
        np.asarray(patch_mod.height_at(pf, x, y)),
        np.asarray(hfield.height_at(hf, x, y)),
    )
    lz, rz = patch_mod.nearest_height_pair(pf, x, y, y, x)
    np.testing.assert_array_equal(
        np.asarray(lz), np.asarray(hfield.nearest_height(hf, x, y)))
    np.testing.assert_array_equal(
        np.asarray(rz), np.asarray(hfield.nearest_height(hf, y, x)))


def test_patch_clamps_like_direct_at_window_edges(rng):
    """Robot near the window edge: the clamped (shifted) patch must
    reproduce the direct path for every in-window lookup, including the
    last-cell corner where the direct gather clamps i+1 to the grid edge.
    (Lookups *outside* the window are out of contract: the reference Warp
    kernel does unchecked loads there, projection_warp.py:43-46.)"""
    dtype = jnp.float32
    hf = _world(rng, grid=256, hw=12.0, dtype=dtype)
    # robot 0.1 m from the +x/+y corner; samples press against the edge
    pf = extract_patch(hf, jnp.asarray(11.9, dtype), jnp.asarray(11.9, dtype), 128)
    x = jnp.asarray(rng.uniform(6.0, 11.99, (200,)), dtype)
    y = jnp.asarray(rng.uniform(6.0, 11.99, (200,)), dtype)
    np.testing.assert_array_equal(
        np.asarray(patch_mod.corners_at(pf, x, y)),
        np.asarray(hfield.corners_at(hf, x, y)),
    )
    # same at the -x/-y corner (index 0 side)
    pf2 = extract_patch(hf, jnp.asarray(-11.9, dtype), jnp.asarray(-11.9, dtype), 128)
    x2, y2 = -x, -y
    np.testing.assert_array_equal(
        np.asarray(patch_mod.corners_at(pf2, x2, y2)),
        np.asarray(hfield.corners_at(hf, x2, y2)),
    )


def test_rollout_25d_bit_identical(rng):
    """Eager: bit-identical. Jitted: XLA fuses/contracts (FMA) each program
    differently — even two jit compilations of the *direct* path differ from
    eager by ~1e-5 after 50 f32 steps — so jit-vs-jit equality is asserted to
    that accumulation level, and exactly in float64."""
    for dtype, tol in ((jnp.float32, 5e-5), (jnp.float64, 1e-12)):
        hf = _world(rng, dtype=dtype)
        pos = jnp.asarray([1.5, -3.0], dtype)
        hv = jnp.asarray([1.0, 0.4, 0.0], dtype)
        hv = hv / jnp.linalg.norm(hv)
        noise = sample_noise(jax.random.key(3), 64, 50, dtype)
        lin = jnp.abs(noise[0])
        ang = noise[1]
        pf = extract_patch(hf, pos[0], pos[1], 256)
        ref = rollout_25d(hf, pos, hv, lin, ang, 0.045)
        got = rollout_25d(pf, pos, hv, lin, ang, 0.045)
        for a, b in zip(ref, got):  # eager: bit-identical
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        jref = jax.jit(lambda: rollout_25d(hf, pos, hv, lin, ang, 0.045))()
        jgot = jax.jit(lambda: rollout_25d(pf, pos, hv, lin, ang, 0.045))()
        for a, b in zip(jref, jgot):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def test_rollout_2d_bit_identical(rng):
    dtype = jnp.float32
    hf = _world(rng, dtype=dtype)
    pos = jnp.asarray([1.5, -3.0], dtype)
    hv = jnp.asarray([0.2, 1.0, 0.0], dtype)
    hv = hv / jnp.linalg.norm(hv)
    noise = sample_noise(jax.random.key(4), 64, 50, dtype)
    pf = extract_patch(hf, pos[0], pos[1], 256)
    ref = rollout_2d(hf, pos, hv, jnp.abs(noise[0]), noise[1], 0.045)
    got = rollout_2d(pf, pos, hv, jnp.abs(noise[0]), noise[1], 0.045)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_costmap_patch_lookup_bit_identical(rng):
    dtype = jnp.float32
    size = 200
    cost = jnp.asarray(rng.uniform(0.0, 1.0, (size, size)), dtype)
    cm = Costmap(
        cost=cost,
        half_width=jnp.asarray(20.0, dtype),
        resolution=jnp.asarray(0.2, dtype),
    )
    traj = jnp.asarray(rng.uniform(-6.0, 6.0, (37, 50, 3)), dtype)
    ic = jnp.asarray(100, jnp.int32)
    jc = jnp.asarray(100, jnp.int32)
    gp = extract_grid_patch(cm.cost, ic, jc, 128)
    ref = avoid_obstacle_critic(traj, cm)
    got = avoid_obstacle_critic(traj, cm, costmap_patch=gp)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    # raw lookup equality incl. out-of-grid clamping
    i = jnp.asarray(rng.integers(-10, size + 10, (500,)), jnp.int32)
    j = jnp.asarray(rng.integers(-10, size + 10, (500,)), jnp.int32)
    i_cl = jnp.clip(i, 0, size - 1)
    j_cl = jnp.clip(j, 0, size - 1)
    # out-of-patch cells clamp to the patch edge; restrict to in-patch ones
    inside = ((i_cl >= 36) & (i_cl < 164) & (j_cl >= 36) & (j_cl < 164))
    np.testing.assert_array_equal(
        np.asarray(grid_lookup(gp, i, j))[np.asarray(inside)],
        np.asarray(cost[j_cl, i_cl])[np.asarray(inside)],
    )


def test_full_mppi_step_bit_identical(rng):
    """The headline guarantee: gather_engine='onehot' reproduces the direct
    engine's whole control step bit-for-bit."""
    dtype = jnp.float32
    hf = _world(rng, grid=512, hw=25.0, dtype=dtype)
    cmap = jnp.asarray(
        np.clip(rng.uniform(-0.5, 1.0, (64, 64)), 0.0, 1.0), dtype)
    cm = Costmap(
        cost=cmap,
        half_width=jnp.asarray(25.0, dtype),
        resolution=jnp.asarray(50.0 / 64, dtype),
    )
    goal = jnp.asarray([18.0, 15.0], dtype)
    robot = RobotState.create(-10.0, -8.0, [1.0, 0.3, 0.0], dtype=dtype)
    noise = sample_noise(jax.random.key(7), 128, 40, dtype)

    base = dict(num_samples=128, horizon=40, exact=False)
    cfg_direct = MPPIConfig(**base)
    cfg_onehot = MPPIConfig(
        **base, gather_engine="onehot", patch_size=256, costmap_patch_size=32)

    ctrl0 = ControllerState.create(cfg_direct, dtype)
    # eager: bit-identical
    ref_ctrl, ref_out = mppi_step(cfg_direct, hf, cm, goal, robot, ctrl0, noise)
    got_ctrl, got_out = mppi_step(cfg_onehot, hf, cm, goal, robot, ctrl0, noise)
    for a, b in zip(jax.tree.leaves(ref_ctrl), jax.tree.leaves(got_ctrl)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(ref_out), jax.tree.leaves(got_out)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # jitted: per-program XLA FMA contraction noise only
    jref = jax.jit(mppi_step, static_argnums=0)(
        cfg_direct, hf, cm, goal, robot, ctrl0, noise)
    jgot = jax.jit(mppi_step, static_argnums=0)(
        cfg_onehot, hf, cm, goal, robot, ctrl0, noise)
    for a, b in zip(jax.tree.leaves(jref), jax.tree.leaves(jgot)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=5e-4, atol=5e-4)


def test_mppi_step_2d_projection_onehot(rng):
    dtype = jnp.float32
    hf = _world(rng, grid=512, hw=25.0, dtype=dtype)
    cm = Costmap(
        cost=jnp.zeros((64, 64), dtype),
        half_width=jnp.asarray(25.0, dtype),
        resolution=jnp.asarray(50.0 / 64, dtype),
    )
    goal = jnp.asarray([18.0, 15.0], dtype)
    robot = RobotState.create(-10.0, -8.0, [1.0, 0.3, 0.0], dtype=dtype)
    noise = sample_noise(jax.random.key(9), 64, 30, dtype)
    base = dict(num_samples=64, horizon=30, projection="2d")
    ctrl0 = ControllerState.create(MPPIConfig(**base), dtype)
    _, ref = mppi_step(MPPIConfig(**base), hf, cm, goal, robot, ctrl0, noise)
    _, got = mppi_step(
        MPPIConfig(**base, gather_engine="onehot", patch_size=256,
                   costmap_patch_size=32),
        hf, cm, goal, robot, ctrl0, noise)
    np.testing.assert_array_equal(
        np.asarray(got.optimal_trajectory), np.asarray(ref.optimal_trajectory))
    np.testing.assert_array_equal(np.asarray(got.costs), np.asarray(ref.costs))


def test_invalid_gather_engine_rejected():
    """A typo'd engine name must error, not silently fall back to the slow
    direct path (ADVICE r02)."""
    with pytest.raises(ValueError, match="gather_engine"):
        MPPIConfig(gather_engine="one-hot")
    with pytest.raises(ValueError, match="projection"):
        MPPIConfig(projection="3D")


def test_undersized_patch_raises_not_clamps(rng):
    """A patch that cannot cover the horizon reach must fail loudly at trace
    time — the one-hot engine clamps escaping lookups silently otherwise."""
    dtype = jnp.float32
    hf = _world(rng, grid=512, hw=25.0, dtype=dtype)
    cm = Costmap(
        cost=jnp.zeros((64, 64), dtype),
        half_width=jnp.asarray(25.0, dtype),
        resolution=jnp.asarray(50.0 / 64, dtype),
    )
    goal = jnp.asarray([18.0, 15.0], dtype)
    robot = RobotState.create(-10.0, -8.0, [1.0, 0.3, 0.0], dtype=dtype)
    noise = sample_noise(jax.random.key(0), 16, 100, dtype)
    # reach = 100 * 0.045 * 2 + 0.2 = 9.2 m; at ~0.098 m/px a 64-cell patch
    # covers ~3.1 m -> must raise
    cfg = MPPIConfig(num_samples=16, horizon=100, gather_engine="onehot",
                     patch_size=64, costmap_patch_size=32)
    ctrl0 = ControllerState.create(cfg, dtype)
    with pytest.raises(ValueError, match="patch_size"):
        mppi_step(cfg, hf, cm, goal, robot, ctrl0, noise)
    # a covering patch passes (the guard is not over-eager)
    ok = MPPIConfig(num_samples=16, horizon=100, gather_engine="onehot",
                    patch_size=256, costmap_patch_size=32)
    mppi_step(ok, hf, cm, goal, robot, ctrl0, noise)


def test_split3_reconstructs_bitwise(rng):
    """The 3-way bf16 split is an exact decomposition of float32."""
    from husky_rover_mppi.core.patch import split3

    z = jnp.asarray(
        rng.standard_normal((128, 128)).astype(np.float32) * 1e3)
    s = split3(z)
    back = (s[0].astype(jnp.float32) + s[1].astype(jnp.float32)
            ) + s[2].astype(jnp.float32)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(z))
    assert split3(z.astype(jnp.float64)) is None
