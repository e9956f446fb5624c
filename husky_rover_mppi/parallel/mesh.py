"""Device-mesh sharding of the MPPI workload.

The reference has no collective backend (SURVEY.md §2.6): its parallelism is
one CUDA thread per (trajectory[, step]). The scaling axes here are:

* ``samples`` — MPPI perturbation rollouts. The weighted-update reduction
  ``sum_k w_k u_k / sum_k w_k`` (critics_warp.py:363-376) is literally a
  weighted all-reduce: sharding samples turns it into one ``psum``.
* ``rovers`` — independent rover instances in lockstep (data parallel).

:func:`sharded_mppi_step` shards the noise batch over a mesh axis with
``shard_map``; per-sample math stays local and only the three scalarizing
reductions (min cost, sum of weights, weighted input sums) cross chips.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
from jax import Array
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.heightfield import HeightField
from ..dynamics.skid_steer import wheel_lag_matmul, wheel_lag_scan
from ..mppi import critics as crit
from ..mppi import rollout as ro
from ..mppi.controller import ControllerState, MPPIConfig, RobotState, StepOutput
from ..mppi.critics import Costmap
from ..mppi.sampling import perturb


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """Build a mesh over the available devices (e.g. ``((hosts, samples),
    ("rover", "sample"))``)."""
    return jax.make_mesh(tuple(axis_sizes), tuple(axis_names))


def replicate(mesh: Mesh, tree):
    """Place a pytree fully-replicated on the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)


def shard_samples(mesh: Mesh, noise: Array, axis: str = "sample") -> Array:
    """Shard the (2, K, H) noise bundle along K."""
    return jax.device_put(noise, NamedSharding(mesh, P(None, axis, None)))


def _local_step(config: MPPIConfig, hf, costmap, goal, robot, ctrl, noise, axis):
    """Per-shard MPPI body: local rollouts + critics, global softmax stats
    via psum. Runs under shard_map; ``noise`` is the local sample shard."""
    wheel_lag = wheel_lag_scan if config.exact else wheel_lag_matmul
    track = jnp.asarray(config.robot_radius, noise.dtype)
    horizon_m = jnp.asarray(config.horizon_m, noise.dtype)

    u1, u2 = perturb(
        ctrl.optimal_u1, ctrl.optimal_u2, noise, ctrl.std_u1, ctrl.std_u2,
        config.inputs,
    )
    k_r, a_r = config.rollout_lag
    lin, ang = wheel_lag(
        u1, u2, robot.left_wheel_speed, robot.right_wheel_speed, track,
        config.limits, k_r, a_r,
    )
    # Same projection / critic dispatch as mppi_step (controller.py:394-407)
    # — the sharded step must not silently diverge from the validated
    # single-device math for non-default configs.
    if config.projection == "2d":
        traj, _ = ro.rollout_2d(
            hf, robot.position, robot.heading, lin, ang, config.dt)
        lw = rw = traj
    else:
        r = ro.rollout_25d(
            hf, robot.position, robot.heading, lin, ang, config.dt)
        traj, lw, rw = r.trajectory, r.left_wheel, r.right_wheel
        if config.slope_critic == "body":
            lw = rw = traj
    costs = crit.evaluate_trajectories(
        robot.position[0], robot.position[1], goal, traj, lw, rw, lin,
        jnp.asarray(config.limits.v_max, noise.dtype), costmap, horizon_m,
        config.critic_weights,
    )

    # Global two-pass softmax across the sample shard: one pmin + one psum.
    global_min = jax.lax.pmin(jnp.min(costs), axis)
    weights = jnp.exp(-(costs - global_min) / config.temperature)
    total = jax.lax.psum(jnp.sum(weights), axis)
    hi = jax.lax.Precision.HIGHEST  # match weighted_update (no bf16 lowering)
    opt_u1 = jax.lax.psum(
        jnp.einsum("k,kh->h", weights, u1, precision=hi), axis) / total
    opt_u2 = jax.lax.psum(
        jnp.einsum("k,kh->h", weights, u2, precision=hi), axis) / total

    k_o, a_o = config.optimal_lag
    opt_lin, opt_ang = wheel_lag(
        opt_u1[None], opt_u2[None], robot.left_wheel_speed,
        robot.right_wheel_speed, track, config.limits, k_o, a_o,
    )
    opt_lin, opt_ang = opt_lin[0], opt_ang[0]
    opt = ro.rollout_25d(
        hf, robot.position, robot.heading, opt_lin[None], opt_ang[None],
        config.dt,
    )

    b = config.sigma_base
    new_ctrl = ControllerState(
        optimal_u1=opt_u1,
        optimal_u2=opt_u2,
        std_u1=jnp.maximum(b, b - opt_ang[0] * opt_ang[0]),
        std_u2=jnp.maximum(b, b + opt_ang[0] * opt_ang[0]),
    )
    out = StepOutput(
        linear_velocity=opt_lin[0],
        angular_velocity=opt_ang[0],
        optimal_trajectory=opt.trajectory[0],
        optimal_headings=opt.headings[0],
        optimal_linear=opt_lin,
        optimal_angular=opt_ang,
        costs=costs,
        weights=weights,
        rollouts=traj if config.return_rollouts else None,
    )
    return new_ctrl, out


def sharded_mppi_step(
    config: MPPIConfig,
    mesh: Mesh,
    hf: HeightField,
    costmap: Costmap,
    goal: Array,
    robot: RobotState,
    ctrl: ControllerState,
    noise: Array,
    axis: str = "sample",
):
    """MPPI step with the sample batch sharded over ``axis``.

    Identical math to :func:`..mppi.controller.mppi_step` (two-pass min,
    weighted sums) — tested to match the single-device path; float summation
    order differs across shard boundaries.
    """
    body = functools.partial(_local_step, config, axis=axis)
    spec_noise = P(None, axis, None)
    spec_rep = P()
    mapped = jax.shard_map(
        lambda hf_, cm_, goal_, robot_, ctrl_, noise_: body(
            hf_, cm_, goal_, robot_, ctrl_, noise_
        ),
        mesh=mesh,
        in_specs=(spec_rep, spec_rep, spec_rep, spec_rep, spec_rep, spec_noise),
        out_specs=(
            ControllerState(spec_rep, spec_rep, spec_rep, spec_rep),
            StepOutput(
                spec_rep, spec_rep, spec_rep, spec_rep, spec_rep, spec_rep,
                P(axis), P(axis),
                P(axis) if config.return_rollouts else None,
            ),
        ),
        check_vma=False,
    )
    return mapped(hf, costmap, goal, robot, ctrl, noise)
