"""One-hot matmul gather engine over a reachable terrain patch.

Row selection is a matmul:

    z[j_k, :]  ==  onehot(j_k) @ Z            (one (K,P) @ (P,P) matmul)
    z[j_k,i_k] ==  sum(onehot(j_k) @ Z * onehot(i_k), axis=-1)

All rollout terrain reads (4 bilinear corners, the quad normal, and the two
wheel-track nearest-cell lookups) are row/column functionals of a patch, so
one horizon step of the whole K-sample batch becomes a handful of matmuls +
dense elementwise work instead of K-index gathers (`z[j, i]`, thesis
reference `_get_corners_heights`, projection_warp.py:8-48). The engine was
built for hardware whose gathers are slow and whose matrix unit is fast;
whether it pays on a given device is a measurement
(`MPPIConfig.gather_engine`).

Exactness: with ``precision=Precision.HIGHEST`` the 3-way bf16
decomposition reconstructs every selected float32 exactly (one operand is a
0/1 matrix, the other side's hi+mid+lo splits sum back bit-exactly), so the
engine returns **bit-identical** heights to direct indexing — verified in
tests/test_patch_engine.py. Everything downstream (bilinear weights,
normals, Rodrigues steps) is unchanged, so whole rollouts bit-match the
direct path and therefore the NumPy/Warp oracles.

The patch is valid because MPPI rollouts are *reach-limited*: every sample
starts at the robot pose and can travel at most ``H * dt * v_max`` meters
(9 m at the reference config, config.yaml + MPPI_isaac.py:440), so a patch of
``patch_size`` cells centered on the robot covers every lookup of the control
loop. Patch extraction is one ``dynamic_update_slice``-style window copy per
control loop; offsets are traced values, so nothing recompiles as the robot
moves. At very fine resolutions (the 2.5 cm streamed window) the required
patch grows and the selection cost ~P^2 grows with it.

Precondition — finite values: one-hot selection computes ``0 * cell`` for
every unselected cell, so a single NaN/Inf anywhere in the patch poisons
every output (``0 * inf = nan``), whereas direct indexing only returns the
non-finite value when that cell is selected. Terrain windows and costmaps in
this framework are finite by construction; callers feeding arbitrary grids
through :class:`GridPatch` must sanitize non-finite cells first
(``jnp.nan_to_num``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from .heightfield import HeightField

_HIGHEST = jax.lax.Precision.HIGHEST


class PatchField(NamedTuple):
    """A reach-covering square window of a parent :class:`HeightField`.

    Index semantics are the parent's (the quirky Warp formulas in
    ``heightfield.corner_cell``); ``i0/j0`` are the traced integer offsets of
    the patch inside the parent grid and ``parent_cols/parent_rows`` the
    parent's clamp bounds, so lookups reproduce the direct path's
    edge-extension clamping bit-for-bit.

    ``z3`` (float32 parents only) is the exact 3-way bfloat16 split of ``z``
    (hi/mid/lo, summing back bit-exactly): selection matmuls then run as
    three 1-pass bf16 products instead of a 6-pass ``Precision.HIGHEST``
    decomposition — same bits, half the passes, because the one-hot operand
    is already exact in bf16 and needs no split.
    """

    z: Array          # (P, P) patch heights
    z3: Array | None  # (3, P, P) bf16 exact split of z, or None for f64
    i0: Array         # int32 column offset of patch column 0 in the parent
    j0: Array         # int32 row offset of patch row 0 in the parent
    parent_rows: int  # static parent grid extents (clamp bounds)
    parent_cols: int
    x_min: Array      # parent window coordinate frame (unchanged!)
    y_min: Array
    resolution: Array

    @property
    def size(self) -> int:
        return self.z.shape[-1]


def split3(z: Array) -> Array | None:
    """Exact 3-way bf16 decomposition of a float32 array: ``hi + mid + lo``
    reconstructs every value bit-exactly (8+8+8 mantissa bits >= f32's 24;
    each residual subtraction is exact in f32). Returns None for dtypes where
    plain HIGHEST matmul selection is already exact)."""
    if z.dtype != jnp.float32:
        return None
    hi = z.astype(jnp.bfloat16)
    r1 = z - hi.astype(z.dtype)
    mid = r1.astype(jnp.bfloat16)
    r2 = r1 - mid.astype(z.dtype)
    lo = r2.astype(jnp.bfloat16)
    return jnp.stack([hi, mid, lo])


def extract_patch(hf: HeightField, x: Array, y: Array, size: int) -> PatchField:
    """Cut the ``size``^2 patch centered on (x, y) out of ``hf``.

    The patch start is clamped so the patch always lies inside the parent;
    near a window edge the patch therefore *contains* the edge cells whose
    values the direct path's clamped gathers would return.
    """
    rows, cols = hf.z.shape[-2], hf.z.shape[-1]
    if size > rows or size > cols:
        raise ValueError(f"patch size {size} exceeds window {rows}x{cols}")
    ic = jnp.trunc((x - hf.x_min) / hf.resolution).astype(jnp.int32)
    jc = (-jnp.trunc((y + hf.y_min) / hf.resolution)).astype(jnp.int32)
    i0 = jnp.clip(ic - size // 2, 0, cols - size)
    j0 = jnp.clip(jc - size // 2, 0, rows - size)
    z = jax.lax.dynamic_slice(hf.z, (j0, i0), (size, size))
    return PatchField(
        z=z, z3=split3(z), i0=i0, j0=j0, parent_rows=rows, parent_cols=cols,
        x_min=hf.x_min, y_min=hf.y_min, resolution=hf.resolution,
    )


def _onehot(idx: Array, size: int, dtype) -> Array:
    """Exact 0/1 selection matrix ``batch + (size,)``."""
    iota = jax.lax.broadcasted_iota(jnp.int32, idx.shape + (size,), idx.ndim)
    return (iota == idx[..., None]).astype(dtype)


def _select_rows(z: Array, z3: Array | None, size: int, j: Array) -> Array:
    """Row selection as a matmul, bit-exact two ways: for f32, three 1-pass
    bf16 products against the exact hi/mid/lo split summed in the
    reconstruction-exact order; otherwise a HIGHEST-precision matmul."""
    if z3 is None:
        oh = _onehot(j, size, z.dtype)
        return jnp.matmul(oh, z, precision=_HIGHEST)
    oh = _onehot(j, size, jnp.bfloat16)
    acc = jnp.matmul(oh, z3[0], preferred_element_type=jnp.float32)
    acc = acc + jnp.matmul(oh, z3[1], preferred_element_type=jnp.float32)
    acc = acc + jnp.matmul(oh, z3[2], preferred_element_type=jnp.float32)
    return acc


def _rows(pf: PatchField, j_patch: Array) -> Array:
    """Select rows ``j_patch`` of the patch by matmul: ``batch + (P,)``."""
    return _select_rows(pf.z, pf.z3, pf.size, j_patch)


def _col(select_rows: Array, i_patch: Array, size: int) -> Array:
    """Pick column ``i_patch`` out of per-sample rows via a one-hot dot —
    dense VPU multiply+reduce, no gather."""
    return jnp.sum(select_rows * _onehot(i_patch, size, select_rows.dtype),
                   axis=-1)


def _normalize_index(i: Array, n: int) -> Array:
    """jnp.__getitem__ semantics under jit: negative indices wrap once
    (NumPy), then XLA's CLIP gather clamps to [0, n-1] — verified against the
    direct path in tests/test_patch_engine.py."""
    return jnp.clip(jnp.where(i < 0, i + n, i), 0, n - 1)


def _patch_index(pf: PatchField, i: Array, j: Array) -> tuple[Array, Array]:
    """Map parent cell indices into patch indices with the direct path's
    wrap-then-clamp semantics applied first."""
    i_cl = _normalize_index(i, pf.parent_cols)
    j_cl = _normalize_index(j, pf.parent_rows)
    ip = jnp.clip(i_cl - pf.i0, 0, pf.size - 1)
    jp = jnp.clip(j_cl - pf.j0, 0, pf.size - 1)
    return ip, jp


def corner_cell(pf: PatchField, x: Array, y: Array) -> tuple[Array, Array]:
    """Parent-frame cell indices (identical formula to
    ``heightfield.corner_cell``, projection_warp.py:39-40)."""
    i = jnp.trunc((x - pf.x_min) / pf.resolution).astype(jnp.int32)
    j = (-jnp.trunc((y + pf.y_min) / pf.resolution)).astype(jnp.int32)
    return i, j


def corners_at(pf: PatchField, x: Array, y: Array) -> Array:
    """Quad corner heights ``batch + (2, 2)`` — drop-in for
    ``heightfield.corners_at`` with matmul selection."""
    i, j = corner_cell(pf, x, y)
    ip, jp = _patch_index(pf, i, j)
    ip1, jp1 = _patch_index(pf, i + 1, j + 1)
    # one matmul for both rows: stack (j, j+1) into the batch
    rows = _rows(pf, jnp.stack([jp, jp1], axis=0))
    a, b = rows[0], rows[1]
    q00 = _col(a, ip, pf.size)
    q01 = _col(a, ip1, pf.size)
    q10 = _col(b, ip, pf.size)
    q11 = _col(b, ip1, pf.size)
    return jnp.stack(
        [jnp.stack([q00, q01], axis=-1), jnp.stack([q10, q11], axis=-1)],
        axis=-2,
    )


def nearest_height(pf: PatchField, x: Array, y: Array) -> Array:
    """Truncated-index height lookup (wheel tracks,
    projection_warp.py:338-347) via matmul selection."""
    i, j = corner_cell(pf, x, y)
    ip, jp = _patch_index(pf, i, j)
    return _col(_rows(pf, jp), ip, pf.size)


def nearest_height_pair(
    pf: PatchField, xl: Array, yl: Array, xr: Array, yr: Array
) -> tuple[Array, Array]:
    """Both wheel-track lookups in one stacked matmul."""
    il, jl = corner_cell(pf, xl, yl)
    ir, jr = corner_cell(pf, xr, yr)
    ilp, jlp = _patch_index(pf, il, jl)
    irp, jrp = _patch_index(pf, ir, jr)
    rows = _rows(pf, jnp.stack([jlp, jrp], axis=0))
    return _col(rows[0], ilp, pf.size), _col(rows[1], irp, pf.size)


def height_at(pf: PatchField, x: Array, y: Array) -> Array:
    """Bilinear height (drop-in for ``heightfield.height_at``)."""
    from . import heightfield as hfield

    q = corners_at(pf, x, y)
    return hfield.bilinear(x, y, q, pf.resolution)


class GridPatch(NamedTuple):
    """Generic patch of any 2D grid (costmaps, masks) indexed by integer
    cells — the caller owns the meters→cell formula."""

    z: Array
    z3: Array | None
    i0: Array
    j0: Array
    parent_rows: int
    parent_cols: int

    @property
    def size(self) -> int:
        return self.z.shape[-1]


def extract_grid_patch(grid: Array, ic: Array, jc: Array, size: int) -> GridPatch:
    """Cut a ``size``^2 patch centered at integer cell (ic, jc), clamped to
    stay inside the grid."""
    rows, cols = grid.shape[-2], grid.shape[-1]
    if size > rows or size > cols:
        raise ValueError(f"patch size {size} exceeds grid {rows}x{cols}")
    i0 = jnp.clip(ic - size // 2, 0, cols - size)
    j0 = jnp.clip(jc - size // 2, 0, rows - size)
    z = jax.lax.dynamic_slice(grid, (j0, i0), (size, size))
    return GridPatch(z=z, z3=split3(z), i0=i0, j0=j0,
                     parent_rows=rows, parent_cols=cols)


def grid_lookup(gp: GridPatch, i: Array, j: Array) -> Array:
    """Nearest-cell values at integer parent indices (i, j) via one-hot
    selection, reproducing the direct path's wrap-then-clamp semantics."""
    i_cl = _normalize_index(i, gp.parent_cols)
    j_cl = _normalize_index(j, gp.parent_rows)
    ip = jnp.clip(i_cl - gp.i0, 0, gp.size - 1)
    jp = jnp.clip(j_cl - gp.j0, 0, gp.size - 1)
    rows = _select_rows(gp.z, gp.z3, gp.size, jp)
    return _col(rows, ip, gp.size)
