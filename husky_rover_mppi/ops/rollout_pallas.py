"""Fused 2.5D surface-riding rollout: a Pallas kernel through Triton.

The shape of the reference's Warp ``_generate_trajectories_kernel``
(projection_warp.py:284-350, launched with ``dim=K``): one GPU thread per
trajectory, the whole H-step horizon loop inside the thread, terrain read
straight from the heightfield in device memory. Here one Pallas program
advances a block of ``block_k`` samples (one lane per sample), so a control
loop's K rollouts are one kernel launch instead of H dependent steps of
small XLA kernels; the K=1 optimal rollout is the same kernel on one narrow
block.

Terrain reads are integer-array indexing of the full field ref
(``z_ref[j, i]``), which the Triton lowering turns into pointer-offset
loads. Indices are wrapped once and clamped before the load, reproducing the
direct path's jit gather semantics (``core/heightfield.py``), so the kernel
reads exactly the cells ``mppi/rollout.py::rollout_25d`` reads.

Math mirrors ``rollout_25d`` step for step: update_position -> corner gather
-> bilinear -> quad normal -> tangent project -> Rodrigues orientation ->
wheel-track offsets -> nearest-cell wheel heights. Compiled results differ
from the XLA path only where the two compilers contract multiply-adds
differently. float32 only.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import Array
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..core.heightfield import HeightField

WHEEL_OFFSET = 0.2  # projection_warp.py:333
# Samples per program (power of two). On an H100 (700 W) the control loop
# took the same time end to end at 32 and 128 lanes (K=1000 x H=100:
# 0.264-0.269 ms; K=16384 x H=64: 0.297-0.298 ms), and the rollout alone
# ranked 32/64/128/256 lanes differently in two calls: no width wins.
BLOCK_K = 128
_MIN_BLOCK = 16     # narrowest block, used for the K=1 optimal rollout


def _normalize3(x, y, z):
    n = jnp.sqrt(x * x + y * y + z * z)
    return x / n, y / n, z / n


def _cross(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _kernel(sf_ref, start_ref, lin_ref, ang_ref, z_ref, out_ref, *,
            KB: int, H: int, rows: int, cols: int, wheels: bool):
    lanes = pl.ds(pl.program_id(0) * KB, KB)
    dt = sf_ref[0]
    res = sf_ref[1]
    x_min = sf_ref[2]
    y_min = sf_ref[3]

    def cell(x, y):
        i = jnp.trunc((x - x_min) / res).astype(jnp.int32)
        j = (-jnp.trunc((y + y_min) / res)).astype(jnp.int32)
        return i, j

    def clamp(i, n):
        # jit gather semantics: negative indices wrap once, then clamp
        return jnp.clip(jnp.where(i < 0, i + n, i), 0, n - 1)

    def z_at(i, j):
        return z_ref[clamp(j, rows), clamp(i, cols)]

    def body(t, carry):
        x, y, hx, hy, hz = carry
        lin = lin_ref[t, lanes]
        ang = ang_ref[t, lanes]

        # update_position (projection_warp.py:207-223)
        ux, uy, _ = _normalize3(hx, hy, hz)
        x = x + ux * (lin * dt)
        y = y + uy * (lin * dt)

        # corner gather + bilinear + quad normal (projection_warp.py:8-151)
        i, j = cell(x, y)
        q00 = z_at(i, j)
        q01 = z_at(i + 1, j)
        q10 = z_at(i, j + 1)
        q11 = z_at(i + 1, j + 1)
        xn = x / res
        yn = y / res
        x2 = xn - jnp.trunc(xn)
        y2 = yn - jnp.trunc(yn)
        height = ((1.0 - x2) * (1.0 - y2) * q00 + x2 * (1.0 - y2) * q10
                  + (1.0 - x2) * y2 * q01 + x2 * y2 * q11)
        nx = -res / 2.0 * (q01 - q00 - q10 + q11)
        ny = -res / 2.0 * (q10 - q00 - q01 + q11)
        nz = res * res * jnp.ones_like(nx)
        nx, ny, nz = _normalize3(nx, ny, nz)

        # tangent_project (projection_warp.py:181-190)
        d = hx * nx + hy * ny + hz * nz
        px, py, pz = _normalize3(hx - d * nx, hy - d * ny, hz - d * nz)

        # update_orientation: normalize, Rodrigues about the normal,
        # normalize (projection_warp.py:225-248)
        ux, uy, uz = _normalize3(px, py, pz)
        ct = jnp.cos(ang * dt)
        st = jnp.sin(ang * dt)
        cx, cy, cz = _cross(nx, ny, nz, ux, uy, uz)
        ad = nx * ux + ny * uy + nz * uz
        hx, hy, hz = _normalize3(ux * ct + cx * st + nx * ad * (1.0 - ct),
                                 uy * ct + cy * st + ny * ad * (1.0 - ct),
                                 uz * ct + cz * st + nz * ad * (1.0 - ct))

        out_ref[0, t, lanes] = x
        out_ref[1, t, lanes] = y
        out_ref[2, t, lanes] = height
        out_ref[3, t, lanes] = hx
        out_ref[4, t, lanes] = hy
        out_ref[5, t, lanes] = hz
        if wheels:
            # wheel tracks (projection_warp.py:332-348); skipped in
            # body-slope-critic mode, where lw/rw are never read
            wx, wy, _ = _cross(nx, ny, nz, hx, hy, hz)
            lx = x + WHEEL_OFFSET * wx
            ly = y + WHEEL_OFFSET * wy
            rx = x - WHEEL_OFFSET * wx
            ry = y - WHEEL_OFFSET * wy
            out_ref[6, t, lanes] = lx
            out_ref[7, t, lanes] = ly
            out_ref[8, t, lanes] = z_at(*cell(lx, ly))
            out_ref[9, t, lanes] = rx
            out_ref[10, t, lanes] = ry
            out_ref[11, t, lanes] = z_at(*cell(rx, ry))
        return x, y, hx, hy, hz

    init = tuple(start_ref[c, lanes] for c in range(5))
    jax.lax.fori_loop(0, H, body, init)


def block_width(K: int, block_k: int = BLOCK_K) -> int:
    """Lanes per program: ``block_k``, or the smallest power of two that
    holds a smaller batch (at least ``_MIN_BLOCK``)."""
    return min(block_k, max(_MIN_BLOCK, pl.next_power_of_2(K)))


@functools.partial(jax.jit,
                   static_argnames=("block_k", "interpret", "wheels"))
def rollout_chunk(
    hf: HeightField,
    x: Array,          # (K,) start x per sample
    y: Array,          # (K,)
    heading: Array,    # (K, 3) tangent-projected start heading
    lin: Array,        # (K, H)
    ang: Array,        # (K, H)
    dt,
    block_k: int = BLOCK_K,
    interpret: bool = False,
    wheels: bool = True,
):
    """Run the horizon for all K samples through the fused kernel.

    Returns ``(traj, headings, lw, rw)``, each ``(K, H, 3)``, the contract of
    ``mppi/rollout.py::rollout_25d``. K is padded up to a multiple of the
    block width (padded lanes repeat the last sample and are sliced off). With
    ``wheels=False`` the wheel-track lookups are skipped and
    ``lw = rw = traj`` (the body-slope-critic configuration)."""
    if hf.z.dtype != jnp.float32 or lin.dtype != jnp.float32:
        raise ValueError("the fused rollout kernel is float32 only")
    K, H = lin.shape
    rows, cols = hf.z.shape
    KB = block_width(K, block_k)
    Kp = -(-K // KB) * KB

    def lanes(a):  # (K, ...) -> (..., Kp): samples along the last axis
        a = jnp.pad(a, ((0, Kp - K),) + ((0, 0),) * (a.ndim - 1), mode="edge")
        return jnp.moveaxis(a, 0, -1)

    start = lanes(jnp.concatenate([x[:, None], y[:, None], heading], axis=1))
    sf = jnp.stack([jnp.asarray(dt, jnp.float32), hf.resolution, hf.x_min,
                    hf.y_min]).astype(jnp.float32)
    nch = 12 if wheels else 6
    out = pl.pallas_call(
        functools.partial(_kernel, KB=KB, H=H, rows=rows, cols=cols,
                          wheels=wheels),
        out_shape=jax.ShapeDtypeStruct((nch, H, Kp), jnp.float32),
        grid=(Kp // KB,),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=max(1, KB // 32),
                                           num_stages=1),
        interpret=interpret,
        name="rollout_25d_fused",
    )(sf, start, lanes(lin), lanes(ang), hf.z)

    flat = jnp.moveaxis(out[..., :K], -1, 0)  # (K, nch, H)

    def comp(c):
        return jnp.moveaxis(flat[:, c:c + 3], 1, -1)

    traj, headings = comp(0), comp(3)
    if not wheels:
        return traj, headings, traj, traj
    return traj, headings, comp(6), comp(9)
