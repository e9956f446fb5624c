"""Bicubic LR -> HR DEM upsampling — the replacement for the reference's
PIL-worker interpolator (``CPUInterpolator_PIL``,
src/terrain_management/large_scale_terrain/high_resolution_DEM_workers.py:
107-196: PIL bicubic, a = -0.5, in a dedicated process).

Re-designed as a jitted separable Catmull-Rom (a = -0.5) pass: for an integer
upscale factor ``f`` each output row has a fixed 4-tap kernel, so the whole
upsample is two gather+contract passes that fuse on device — no worker
processes, no host round-trips.

Also provides the 2x2 bilinear / 4x4 bicubic *point* samplers used by the
geo-clipmap (``geometry_clipmaps_warp.py:180-279`` Catmull-Rom coefficients).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array


def cubic_kernel(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys' cubic convolution kernel (PIL/OpenCV bicubic, a = -0.5)."""
    x = np.abs(x)
    return np.where(
        x <= 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
    )


@functools.partial(jax.jit, static_argnames=("factor",))
def upsample_bicubic(lr: Array, factor: int) -> Array:
    """Upsample ``(H, W)`` by an integer factor with Catmull-Rom bicubic.

    Output pixel ``o`` samples source coordinate ``(o + 0.5)/f - 0.5``
    (PIL's convention); edges clamp. The separable pass is a 4-tap gather
    plus a per-row weight contraction on each axis; indices and weights are
    compile-time constants.
    """

    def axis_pass(img: Array) -> Array:  # upsample the leading axis
        n = img.shape[0]
        out_rows = np.arange(n * factor)
        src = (out_rows + 0.5) / factor - 0.5
        i0 = np.floor(src).astype(np.int32)
        frac = src - i0
        offs = np.arange(-1, 3)
        kw = cubic_kernel(offs[None, :] - frac[:, None])
        kw = kw / kw.sum(axis=1, keepdims=True)
        idx = np.clip(i0[:, None] + offs[None, :], 0, n - 1)
        taps = img[jnp.asarray(idx)]  # (n*f, 4, W)
        # HIGHEST: a float32 contraction may otherwise run in TF32 on the
        # GPU, which keeps ~3 decimal digits of every streamed height
        return jnp.einsum("nf,nfw->nw", jnp.asarray(kw, img.dtype), taps,
                          precision=jax.lax.Precision.HIGHEST)

    hr = axis_pass(lr)
    return axis_pass(hr.T).T


@jax.jit
def bicubic_point_sample(z: Array, x: Array, y: Array) -> Array:
    """Catmull-Rom bicubic sample at fractional pixel coordinates (the
    clipmap's 4x4 sampler, geometry_clipmaps_warp.py:211-279). ``x`` indexes
    rows, ``y`` columns (reference axis convention).

    Jitted: a host fetch of an eagerly-indexed result can pull the whole
    parent buffer (196 MB for the 7000^2 streamed window)."""
    a = -0.5
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    offs = jnp.arange(-1, 3)

    def weights(frac):
        t = jnp.abs(offs - frac)
        return jnp.where(
            t <= 1.0,
            ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0,
            jnp.where(t < 2.0, (((t - 5.0) * t + 8.0) * t - 4.0) * a, 0.0),
        )

    wx = weights(fx)  # (..., 4)
    wy = weights(fy)
    h, w_ = z.shape[-2], z.shape[-1]
    xi = jnp.clip(x0[..., None] + offs, 0, h - 1)  # (..., 4)
    yi = jnp.clip(y0[..., None] + offs, 0, w_ - 1)
    patch = z[xi[..., :, None], yi[..., None, :]]  # (..., 4, 4)
    return jnp.einsum("...i,...ij,...j->...", wx, patch, wy,
                      precision=jax.lax.Precision.HIGHEST)


@jax.jit
def bilinear_point_sample(z: Array, x: Array, y: Array) -> Array:
    """2x2 bilinear sample at fractional pixel coordinates (the clipmap's
    fast path, geometry_clipmaps_warp.py:180-208). Jitted — see
    :func:`bicubic_point_sample`."""
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    h, w_ = z.shape[-2], z.shape[-1]
    x1 = jnp.clip(x0 + 1, 0, h - 1)
    y1 = jnp.clip(y0 + 1, 0, w_ - 1)
    x0 = jnp.clip(x0, 0, h - 1)
    y0 = jnp.clip(y0, 0, w_ - 1)
    q00 = z[x0, y0]
    q01 = z[x0, y1]
    q10 = z[x1, y0]
    q11 = z[x1, y1]
    return (
        q00 * (1 - fx) * (1 - fy)
        + q01 * (1 - fx) * fy
        + q10 * fx * (1 - fy)
        + q11 * fx * fy
    )
