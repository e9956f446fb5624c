"""MPPI critic stack and importance-weighted reduction.

Vectorized re-design of ``thesis_master/warp_implementation/critics_warp.py``.
Weights and constants are identical to the production kernel
(critics_warp.py:324-329):

    cost = 100.5 * path_follow
         +  50.5 * avoid_slope_wheels
         +   0.5 * maximise_speed
         +  25.0 * avoid_obstacle

The reduction cleans up a known reference race: ``_compute_weights`` reads
``min_cost`` in the same launch as the ``atomic_min`` (critics_warp.py:338-347)
so different GPU threads may normalize against different mins. Here the min is
a proper two-pass reduction — deterministic, and matching the NumPy-reference
semantics (SURVEY.md §5 "race detection").
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array


class CriticWeights(NamedTuple):
    """Critic mixing weights (critics_warp.py:324-329)."""

    path_follow: float = 100.5
    slope_wheels: float = 50.5
    speed: float = 0.5
    obstacle: float = 25.0


class Costmap(NamedTuple):
    """Obstacle costmap over the same window as the heightfield.

    ``cost`` is ``(size, size)`` row-major with row index
    ``iy = trunc((half_width - y) / resolution)`` and column
    ``ix = trunc((x + half_width) / resolution)`` (critics_warp.py:245-248).
    Resolution is DEM-grid/8 (MPPI_isaac.py:271-272).
    """

    cost: Array
    half_width: Array
    resolution: Array

    @property
    def size(self) -> int:
        return self.cost.shape[-1]


def path_follow_critic(
    x: Array, y: Array, goal: Array, trajectory: Array, horizon_m: Array
) -> Array:
    """Goal-progress critic (critics_warp.py:86-127).

    Far from the goal (dist > horizon_m): squared distance of the rollout's
    last waypoint to an intermediate goal placed ``horizon_m`` along the
    goal direction, scaled by ``1 + 2*horizon/dist``. Near the goal: 10x L1
    tracking of every waypoint but the last.

    Args:
        x, y: robot position (scalars — shared across samples).
        goal: ``(2,)``.
        trajectory: ``batch + (H, 3)``.
        horizon_m: lookahead distance ``dt * v_max * H`` (MPPI_isaac.py:440).
    Returns: cost ``batch``.
    """
    eps = 1e-6
    x_diff = goal[0] - x
    y_diff = goal[1] - y
    dist = jnp.sqrt(x_diff * x_diff + y_diff * y_diff)
    last = trajectory[..., -1, :]

    inter_x = x + x_diff * horizon_m / (dist + eps)
    inter_y = y + y_diff * horizon_m / (dist + eps)
    far = (last[..., 0] - inter_x) ** 2 + (last[..., 1] - inter_y) ** 2
    far = far * (1.0 + 2.0 * horizon_m / dist)

    near = jnp.sum(
        10.0
        * (
            jnp.abs(trajectory[..., :-1, 0] - goal[0])
            + jnp.abs(trajectory[..., :-1, 1] - goal[1])
        ),
        axis=-1,
    )
    return jnp.where(dist > horizon_m, far, near)


def _pair_slope(points: Array) -> Array:
    """(1 + 5*|dz/d|)^2 over strided waypoint pairs (i, i+2) for
    i = 0, 2, ..., < H-3 (critics_warp.py:151-164 loop bounds)."""
    eps = 1e-6
    horizon = points.shape[-2]
    idx = jnp.arange(0, horizon - 3, 2)
    p0 = points[..., idx, :]
    p1 = points[..., idx + 2, :]
    dz = p1[..., 2] - p0[..., 2]
    d = jnp.sqrt(
        (p1[..., 0] - p0[..., 0]) ** 2 + (p1[..., 1] - p0[..., 1]) ** 2
    )
    ratio = jnp.abs(dz / (d + eps))
    return (1.0 + 5.0 * ratio) ** 2


def avoid_slope_critic(trajectory: Array) -> Array:
    """Body-frame slope critic (critics_warp.py:130-166); kept for the
    2D-vs-3D comparison harness though the production sum uses the wheel
    variant."""
    return jnp.sum(_pair_slope(trajectory), axis=-1)


def avoid_slope_wheels_critic(left_wheel: Array, right_wheel: Array) -> Array:
    """Per-pair max of left/right wheel-track slopes (critics_warp.py:168-218)."""
    return jnp.sum(
        jnp.maximum(_pair_slope(left_wheel), _pair_slope(right_wheel)), axis=-1
    )


def costmap_cells(trajectory: Array, costmap: Costmap) -> tuple[Array, Array]:
    """Waypoint -> costmap cell indices (critics_warp.py:245-248)."""
    ix = jnp.trunc(
        (trajectory[..., 0] + costmap.half_width) / costmap.resolution
    ).astype(jnp.int32)
    iy = jnp.trunc(
        (-trajectory[..., 1] + costmap.half_width) / costmap.resolution
    ).astype(jnp.int32)
    return ix, iy


def avoid_obstacle_critic(
    trajectory: Array, costmap: Costmap, costmap_patch=None
) -> Array:
    """Costmap lookup per waypoint with collision penalty
    (critics_warp.py:220-267): nearest-cell (truncated) gather; cells with
    cost > 0.99 add 1e5 each. With ``costmap_patch`` (a ``core.patch
    .GridPatch`` over the same costmap) the lookup runs as one-hot matmul
    selection instead of a gather — bit-identical values."""
    ix, iy = costmap_cells(trajectory, costmap)
    if costmap_patch is not None:
        from ..core import patch as patch_mod

        cell = patch_mod.grid_lookup(costmap_patch, ix, iy)
    else:
        cell = costmap.cost[iy, ix]
    hit = jnp.where(cell > 0.99, 1e5, 0.0)
    return jnp.sum(hit + cell, axis=-1)


def goal_angle_critic(
    x: Array, y: Array, goal: Array, goal_orientation: Array,
    trajectory: Array,
) -> Array:
    """Terminal-orientation critic (``_goal_angle_critic``,
    critics_warp.py:4-40) — kept but **unused in the production sum**,
    exactly like the reference. Within 0.5 m of the goal: |atan(dy/dx) -
    goal_orientation| of the last trajectory segment (note ``atan``, not
    atan2 — the reference's quirk, kept)."""
    dist = jnp.sqrt((x - goal[0]) ** 2 + (y - goal[1]) ** 2)
    p0 = trajectory[..., -2, :]
    p1 = trajectory[..., -1, :]
    ang = jnp.arctan((p1[..., 1] - p0[..., 1]) / (p1[..., 0] - p0[..., 0]))
    return jnp.where(dist < 0.5, jnp.abs(ang - goal_orientation), 0.0)


def path_orientation_critic(
    x: Array, y: Array, goal: Array, trajectory: Array
) -> Array:
    """Progress-direction critic (``_path_orientation_critic``,
    critics_warp.py:43-82) — kept but **unused in the production sum**, like
    the reference: penalize rollouts whose last segment points away from the
    goal by the (negated) scalar product normalized by the L1 goal offset."""
    x_diff = goal[0] - x
    y_diff = goal[1] - y
    p0 = trajectory[..., -2, :]
    p1 = trajectory[..., -1, :]
    sp = x_diff * (p1[..., 0] - p0[..., 0]) + y_diff * (p1[..., 1] - p0[..., 1])
    return jnp.where(sp <= 0, -sp / (jnp.abs(x_diff) + jnp.abs(y_diff)), 0.0)


def maximise_speed_critic(
    x: Array,
    y: Array,
    goal: Array,
    linear_velocities: Array,
    target_speed: Array,
) -> Array:
    """Speed critic: sum of (v_max - v)/(v + 1e-4), disabled within 2 m of the
    goal (critics_warp.py:269-300)."""
    x_diff = goal[0] - x
    y_diff = goal[1] - y
    dist = jnp.sqrt(x_diff * x_diff + y_diff * y_diff)
    diff = jnp.sum(
        (target_speed - linear_velocities) / (linear_velocities + 1e-4), axis=-1
    )
    return jnp.where(dist < 2.0, 0.0, diff)


def evaluate_trajectories(
    x: Array,
    y: Array,
    goal: Array,
    trajectory: Array,
    left_wheel: Array,
    right_wheel: Array,
    linear_velocities: Array,
    target_speed: Array,
    costmap: Costmap,
    horizon_m: Array,
    weights: CriticWeights = CriticWeights(),
    costmap_patch=None,
) -> Array:
    """Total per-sample cost (``_evaluate_trajectories_kernel``,
    critics_warp.py:302-329)."""
    cost = weights.path_follow * path_follow_critic(x, y, goal, trajectory, horizon_m)
    cost = cost + weights.slope_wheels * avoid_slope_wheels_critic(
        left_wheel, right_wheel
    )
    cost = cost + weights.speed * maximise_speed_critic(
        x, y, goal, linear_velocities, target_speed
    )
    cost = cost + weights.obstacle * avoid_obstacle_critic(
        trajectory, costmap, costmap_patch
    )
    return cost


def softmax_weights(costs: Array, temperature: float) -> Array:
    """Importance weights ``exp(-(c - min c)/T)`` with a deterministic
    two-pass min (clean version of critics_warp.py:338-347)."""
    min_cost = jnp.min(costs, axis=-1, keepdims=True)
    return jnp.exp(-(costs - min_cost) / temperature)


def weighted_update(weights: Array, u1: Array, u2: Array) -> tuple[Array, Array]:
    """Optimal input sequence ``sum_k w_k u_k / sum_k w_k``
    (critics_warp.py:350-376): a (1,K)@(K,H) reduction — under a sharded
    sample axis it becomes a single ``psum``."""
    total = jnp.sum(weights, axis=-1)
    # precision=HIGHEST: a reduced-precision f32 matmul (bf16 passes or
    # TF32) would round weights/inputs, drifting opt_u from the oracle
    # every loop
    hi = jax.lax.Precision.HIGHEST
    opt1 = jnp.einsum("...k,...kh->...h", weights, u1,
                      precision=hi) / total[..., None]
    opt2 = jnp.einsum("...k,...kh->...h", weights, u2,
                      precision=hi) / total[..., None]
    return opt1, opt2
