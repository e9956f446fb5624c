"""Point processes for crater / rock distribution.

Host-side NumPy implementations mirror the reference's draw order exactly
(``DynamicDistribute``, src/terrain_management/large_scale_terrain/
crater_distribution.py:46-289 and rock_distribution.py:359-466) — block
metadata generation is cheap and stays on host (SURVEY.md §7 "data-dependent
control flow"). Device variants with fixed capacity + masks serve the jitted
SDG/randomization paths.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array


@dataclasses.dataclass
class BoundingBox:
    """Region in meters (utils.py:23-30)."""

    x_min: float = 0.0
    x_max: float = 0.0
    y_min: float = 0.0
    y_max: float = 0.0

    @property
    def area(self) -> float:
        return (self.x_max - self.x_min) * (self.y_max - self.y_min)


# --- host (parity) ----------------------------------------------------------

def sample_poisson(rng: np.random.Generator, region: BoundingBox, density: float,
                   r_minmax: Tuple[float, float]):
    """Poisson point count + uniform radii/coords, reference draw order
    (crater_distribution.py:63-86: count, radii, x, y)."""
    num = rng.poisson(region.area * density)
    radius = rng.uniform(r_minmax[0], r_minmax[1], num)
    x = rng.uniform(region.x_min, region.x_max, num)
    y = rng.uniform(region.y_min, region.y_max, num)
    return np.stack([x, y]).T, radius


def _cell_groups(coords: np.ndarray, cell: float):
    """Spatial binning: returns (sorted point order, group slices, lookup
    dict (gx, gy) -> (start, stop) into the sorted order)."""
    g = np.floor(coords / cell).astype(np.int64)
    # collision-free composite key via offsetting into a dense range
    gx, gy = g[:, 0], g[:, 1]
    span = gy.max() - gy.min() + 1 if gy.size else 1
    key = (gx - gx.min()) * span + (gy - gy.min())
    order = np.argsort(key, kind="stable")
    sorted_key = key[order]
    uniq, starts = np.unique(sorted_key, return_index=True)
    stops = np.append(starts[1:], sorted_key.size)
    lookup = {}
    base_x, base_y = gx.min(), gy.min()
    for u, s, e in zip(uniq, starts, stops):
        lookup[(u // span + base_x, u % span + base_y)] = (s, e)
    return order, list(zip(uniq, starts, stops)), lookup


def _neighbor_indices(lookup, order, cx: int, cy: int):
    """Point indices (original numbering) in the 3x3 cell neighborhood."""
    out = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            se = lookup.get((cx + dx, cy + dy))
            if se is not None:
                out.append(order[se[0]:se[1]])
    return np.concatenate(out) if out else np.empty(0, np.int64)


def hardcore_rejection(rng: np.random.Generator, coords: np.ndarray,
                       radius: np.ndarray):
    """Age-mark hardcore thinning (crater_distribution.py:87-110): a point
    survives if it is older (smaller mark) than every point inside its
    radius.

    Implemented with spatial grid binning (cell = max radius, 3x3
    neighborhood checks): O(N * local density) instead of the O(N^2) dense
    distance matrix, which at reference scale (25k+ craters per region
    draw) allocated gigabytes and dominated the initial window build.
    RNG draw order and the keep set are identical
    to the dense form (asserted in tests/test_terrain_gen.py)."""
    mark_age = rng.uniform(0, 1, coords.shape[0])
    n = coords.shape[0]
    if n == 0:
        return coords, radius
    if n <= 768:  # dense path is cheaper for small draws
        dist = np.linalg.norm(coords[:, None, :] - coords[None, :, :], axis=-1)
        in_disk = (dist < radius[:, None]) & (dist > 0)
        neighbor_min = np.where(in_disk, mark_age[None, :], np.inf).min(axis=1)
        keep = mark_age < neighbor_min
        return coords[keep], radius[keep]
    cell = float(max(radius.max(), 1e-6))
    order, groups, lookup = _cell_groups(coords, cell)
    keep = np.ones(n, dtype=bool)
    g = np.floor(coords / cell).astype(np.int64)
    span = g[:, 1].max() - g[:, 1].min() + 1
    base_x, base_y = g[:, 0].min(), g[:, 1].min()
    for u, s, e in groups:
        idx = order[s:e]                       # points of this cell
        cx, cy = u // span + base_x, u % span + base_y
        cand = _neighbor_indices(lookup, order, cx, cy)
        d = np.linalg.norm(
            coords[idx][:, None, :] - coords[cand][None, :, :], axis=-1)
        in_disk = (d < radius[idx][:, None]) & (d > 0)
        nmin = np.where(in_disk, mark_age[cand][None, :], np.inf).min(axis=1)
        keep[idx] = mark_age[idx] < nmin
    return coords[keep], radius[keep]


def reject_inside_previous(coords: np.ndarray, radius: np.ndarray,
                           prev: Tuple[np.ndarray, np.ndarray] | None):
    """Drop new points falling inside previously-placed disks
    (crater_distribution.py:112-135). Grid-binned over the previous disks
    (cell = max previous radius) — same result as the dense form."""
    if prev is None or prev[0].shape[0] == 0:
        return coords, radius
    n_prev, n_new = prev[0].shape[0], coords.shape[0]
    if n_prev * n_new <= 1 << 22:  # small products: dense is cheaper
        keep = np.ones(n_new, dtype=bool)
        chunk = 4096
        for s in range(0, n_prev, chunk):
            pc = prev[0][s:s + chunk]
            pr = prev[1][s:s + chunk]
            dist = np.linalg.norm(pc[:, None, :] - coords[None, :, :], axis=-1)
            keep &= ~np.any((dist < pr[:, None]) & (dist > 0), axis=0)
        return coords[keep], radius[keep]
    cell = float(max(prev[1].max(), 1e-6))
    order, _, lookup = _cell_groups(prev[0], cell)
    keep = np.ones(n_new, dtype=bool)
    gnew = np.floor(coords / cell).astype(np.int64)
    # group the new points by their cell so each 3x3 prev lookup is shared
    order_new, groups_new, _ = _cell_groups(coords, cell)
    span = gnew[:, 1].max() - gnew[:, 1].min() + 1 if n_new else 1
    base_x, base_y = gnew[:, 0].min(), gnew[:, 1].min()
    for u, s, e in groups_new:
        idx = order_new[s:e]
        cx, cy = u // span + base_x, u % span + base_y
        cand = _neighbor_indices(lookup, order, cx, cy)
        if cand.size == 0:
            continue
        d = np.linalg.norm(
            coords[idx][:, None, :] - prev[0][cand][None, :, :], axis=-1)
        hit = np.any((d < prev[1][cand][None, :]) & (d > 0), axis=1)
        keep[idx] &= ~hit
    return coords[keep], radius[keep]


def hardcore_poisson(
    rng: np.random.Generator,
    region: BoundingBox,
    densities,
    radius_ranges,
    prev: Tuple[np.ndarray, np.ndarray] | None = None,
    num_repeat: int = 1,
):
    """Tiered hardcore Poisson process (run_HC, crater_distribution.py:
    191-227): per density/radius tier, repeated sample + thin, then reject
    against all previously accepted points."""
    if prev is not None and prev[1].shape[0] == 0:
        prev = None
    if prev is not None:
        # only previous disks that can reach into the region matter
        px, py, pr = prev[0][:, 0], prev[0][:, 1], prev[1]
        near = (
            (px >= region.x_min - pr) & (px <= region.x_max + pr)
            & (py >= region.y_min - pr) & (py <= region.y_max + pr)
        )
        prev = (prev[0][near], prev[1][near])
        if prev[1].shape[0] == 0:
            prev = None
    all_coords, all_radius = [], []
    for density, r_minmax in zip(densities, radius_ranges):
        coords, radius = sample_poisson(rng, region, density, r_minmax)
        for _ in range(num_repeat):
            coords, radius = hardcore_rejection(rng, coords, radius)
            new_c, new_r = sample_poisson(rng, region, density, r_minmax)
            coords = np.concatenate([coords, new_c])
            radius = np.concatenate([radius, new_r])
        coords, radius = hardcore_rejection(rng, coords, radius)
        coords, radius = reject_inside_previous(coords, radius, prev)
        all_coords.append(coords)
        all_radius.append(radius)
        prev = (
            np.concatenate([prev[0], coords], axis=0) if prev is not None else coords,
            np.concatenate([prev[1], radius], axis=0) if prev is not None else radius,
        )
    return np.concatenate(all_coords, axis=0), np.concatenate(all_radius, axis=0)


def thomas_point_process(
    rng: np.random.Generator,
    region: BoundingBox,
    parent_density: float,
    child_density: float,
    sigma: float,
):
    """Thomas cluster process (rock_distribution.py Thomas semantics; also
    WorldBuilders/Samplers.py ThomasClusterSampler): Poisson parents on an
    extended region, Poisson-many N(parent, sigma) children, clipped to the
    region."""
    ext = BoundingBox(
        region.x_min - 4 * sigma, region.x_max + 4 * sigma,
        region.y_min - 4 * sigma, region.y_max + 4 * sigma,
    )
    num_parents = rng.poisson(ext.area * parent_density)
    px = rng.uniform(ext.x_min, ext.x_max, num_parents)
    py = rng.uniform(ext.y_min, ext.y_max, num_parents)
    num_children = rng.poisson(child_density, num_parents)
    total = int(num_children.sum())
    cx = np.repeat(px, num_children) + rng.normal(0, sigma, total)
    cy = np.repeat(py, num_children) + rng.normal(0, sigma, total)
    inside = (
        (cx >= region.x_min) & (cx <= region.x_max)
        & (cy >= region.y_min) & (cy <= region.y_max)
    )
    return np.stack([cx[inside], cy[inside]]).T


# --- device (fixed capacity, jit) -------------------------------------------

class MaskedPoints(NamedTuple):
    """Fixed-capacity point set: ``points`` (C, 2), ``radius`` (C,),
    ``mask`` (C,) validity."""

    points: Array
    radius: Array
    mask: Array

    @property
    def capacity(self) -> int:
        return self.points.shape[0]


def poisson_fixed(
    key: Array,
    region: tuple,
    density: float,
    r_minmax: tuple,
    capacity: int,
    dtype=jnp.float32,
) -> MaskedPoints:
    """Jit-able Poisson process: sample ``capacity`` candidates, mask the
    first ``Poisson(area * density)`` of them (fixed shapes, SURVEY.md §7)."""
    x_min, x_max, y_min, y_max = region
    area = (x_max - x_min) * (y_max - y_min)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    count = jnp.minimum(
        jax.random.poisson(k1, area * density), capacity
    )
    mask = jnp.arange(capacity) < count
    x = jax.random.uniform(k2, (capacity,), dtype, x_min, x_max)
    y = jax.random.uniform(k3, (capacity,), dtype, y_min, y_max)
    r = jax.random.uniform(k4, (capacity,), dtype, r_minmax[0], r_minmax[1])
    return MaskedPoints(jnp.stack([x, y], axis=-1), r, mask)


def hardcore_thin_fixed(key: Array, pts: MaskedPoints) -> MaskedPoints:
    """Device age-mark hardcore thinning on a fixed-capacity point set —
    the O(C^2) pairwise form vectorizes cleanly on the VPU."""
    marks = jax.random.uniform(key, (pts.capacity,), pts.points.dtype)
    diff = pts.points[:, None, :] - pts.points[None, :, :]
    dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
    in_disk = (dist < pts.radius[:, None]) & (dist > 0)
    in_disk = in_disk & pts.mask[None, :] & pts.mask[:, None]
    older = marks[:, None] < marks[None, :]
    keep = jnp.all(jnp.where(in_disk, older, True), axis=-1) & pts.mask
    return MaskedPoints(pts.points, pts.radius, keep)


def thomas_fixed(
    key: Array,
    region: tuple,
    parent_density: float,
    child_density: float,
    sigma: float,
    parent_capacity: int,
    children_per_parent: int,
    dtype=jnp.float32,
) -> MaskedPoints:
    """Jit-able Thomas process with fixed (parents x children) capacity."""
    x_min, x_max, y_min, y_max = region
    ext = (x_min - 4 * sigma, x_max + 4 * sigma,
           y_min - 4 * sigma, y_max + 4 * sigma)
    area = (ext[1] - ext[0]) * (ext[3] - ext[2])
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    n_parents = jnp.minimum(
        jax.random.poisson(k1, area * parent_density), parent_capacity
    )
    pmask = jnp.arange(parent_capacity) < n_parents
    px = jax.random.uniform(k2, (parent_capacity,), dtype, ext[0], ext[1])
    py = jax.random.uniform(k3, (parent_capacity,), dtype, ext[2], ext[3])
    n_children = jnp.minimum(
        jax.random.poisson(k4, child_density, (parent_capacity,)),
        children_per_parent,
    )
    cmask = (
        jnp.arange(children_per_parent)[None, :] < n_children[:, None]
    ) & pmask[:, None]
    noise = jax.random.normal(
        k5, (parent_capacity, children_per_parent, 2), dtype
    ) * sigma
    cx = px[:, None] + noise[..., 0]
    cy = py[:, None] + noise[..., 1]
    inside = (cx >= x_min) & (cx <= x_max) & (cy >= y_min) & (cy <= y_max)
    points = jnp.stack([cx, cy], axis=-1).reshape(-1, 2)
    mask = (cmask & inside).reshape(-1)
    return MaskedPoints(points, jnp.zeros(points.shape[0], dtype), mask)
