"""Camera post-processing effects — the replacement for the RTX
post pipeline the reference drives through carb settings
(``src/environments/rendering.py:21-340``).

The reference only *sets knobs* on Isaac's black-box renderer
(``/rtx/post/lensFlares/*``, ``/rtx/post/chromaticAberration/*``,
``/rtx/post/motionblur/*``). Here the renderer is the SDG hillshade pass
(:mod:`.labeling`), so the effects themselves are implemented as jitted
image ops with the same parameter surface:

* **lens flare** — bright-pass then convolution with an N-bladed starburst
  PSF built from the aperture parameters (blades, rotation, fNumber,
  focal length / sensor diagonal set the streak length);
* **chromatic aberration** — per-channel radial/barrel coordinate warp with
  per-channel strengths and model selection, bilinear (or Lanczos-flagged)
  resampling;
* **motion blur** — ``num_samples`` taps along the image-space velocity,
  scaled by ``exposure_fraction`` and capped at ``max_blur_diameter_fraction``
  of the image diagonal.

A :class:`RenderSettings` key-value store mirrors ``carb.settings`` so the
setter functions keep the reference's names and signatures
(set_flare_scale, enable_chromatic_aberrations, ...).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
from jax import Array


# -- configuration dataclasses (src/configurations/rendering_confs.py) ------


@dataclasses.dataclass
class FlaresConf:
    """Lens-flare knobs (rendering.py:64-177)."""

    enable: bool = False
    scale: float = 0.4
    blades: int = 9
    aperture_rotation: float = 0.0   # degrees
    sensor_diagonal: float = 28.0    # mm
    sensor_aspect_ratio: float = 1.5
    fstop: float = 2.8
    focal_length: float = 12.0       # mm


@dataclasses.dataclass
class ChromaticAberrationsConf:
    """Chromatic-aberration knobs (rendering.py:195-262)."""

    enable: bool = False
    strength: Tuple[float, float, float] = (-0.055, -0.075, 0.015)
    model: Tuple[str, str, str] = ("Radial", "Radial", "Radial")
    enable_lanczos: bool = False


@dataclasses.dataclass
class MotionBlurConf:
    """Motion-blur knobs (rendering.py:280-340)."""

    enable: bool = False
    max_blur_diameter_fraction: float = 0.02
    exposure_fraction: float = 1.0
    num_samples: int = 8


# -- carb.settings analogue --------------------------------------------------


class RenderSettings:
    """Flat key-value store with the reference's ``/rtx/post`` keys."""

    def __init__(self):
        self._kv: Dict[str, object] = {}
        apply_lens_flare(FlaresConf(), self)
        apply_chromatic_aberrations(ChromaticAberrationsConf(), self)
        apply_motion_blur(MotionBlurConf(), self)
        self._kv["/rtx/rendermode"] = "RayTracedLighting"

    def set(self, key: str, value) -> None:
        self._kv[key] = value

    def get(self, key: str):
        return self._kv[key]


_GLOBAL_SETTINGS: RenderSettings | None = None


def get_settings() -> RenderSettings:
    global _GLOBAL_SETTINGS
    if _GLOBAL_SETTINGS is None:
        _GLOBAL_SETTINGS = RenderSettings()
    return _GLOBAL_SETTINGS


# -- setter surface (same names as rendering.py) -----------------------------
#
# The reference exposes ~20 four-line carb-settings setters
# (rendering.py:21-340). Here that surface is one declarative
# knob -> settings-path table; the reference-named setters are generated
# thin aliases over it (same call surface, no hand-written pass-through
# boilerplate).

# setter name -> (conf field, settings path, cast)
_KNOBS: Dict[str, Tuple[str, str, type]] = {
    "enable_lens_flare": ("enable", "/rtx/post/lensFlares/enabled", bool),
    "set_flare_scale": ("scale", "/rtx/post/lensFlares/flareScale", float),
    "set_flare_num_blades": ("blades", "/rtx/post/lensFlares/blades", int),
    "set_flare_aperture_rotation":
        ("aperture_rotation", "/rtx/post/lensFlares/apertureRotation", float),
    "set_flare_sensor_diagonal":
        ("sensor_diagonal", "/rtx/post/lensFlares/sensorDiagonal", float),
    "set_flare_sensor_aspect_ratio":
        ("sensor_aspect_ratio", "/rtx/post/lensFlares/sensorAspectRatio",
         float),
    "set_flare_fstop": ("fstop", "/rtx/post/lensFlares/fNumber", float),
    "set_flare_focal_length":
        ("focal_length", "/rtx/post/lensFlares/focalLength", float),
    "enable_chromatic_aberrations":
        ("enable", "/rtx/post/chromaticAberration/enabled", bool),
    "set_chromatic_aberrations_lanczos":
        ("enable_lanczos", "/rtx/post/chromaticAberration/enableLanczos",
         bool),
    "enable_motion_blur": ("enable", "/rtx/post/motionblur/enabled", bool),
    "set_motion_blur_diameter_fraction":
        ("max_blur_diameter_fraction",
         "/rtx/post/motionblur/maxBlurDiameterFraction", float),
    "set_motion_blur_exposure_fraction":
        ("exposure_fraction", "/rtx/post/motionblur/exposureFraction", float),
    "set_motion_blur_num_samples":
        ("num_samples", "/rtx/post/motionblur/numSamples", int),
}

# per-channel fan-out knobs (strengthR/G/B, modelR/G/B)
_RGB_KNOBS: Dict[str, Tuple[str, str]] = {
    "set_chromatic_aberrations_strength":
        ("strength", "/rtx/post/chromaticAberration/strength"),
    "set_chromatic_aberrations_model":
        ("model", "/rtx/post/chromaticAberration/model"),
}


def _make_setter(path: str, cast):
    def setter(value, settings=None):
        (settings or get_settings()).set(path, cast(value))
    return setter


def _make_rgb_setter(prefix: str):
    def setter(value, settings=None):
        s = settings or get_settings()
        for ch, v in zip("RGB", value):
            s.set(prefix + ch, v)
    return setter


for _name, (_field, _path, _cast) in _KNOBS.items():
    globals()[_name] = _make_setter(_path, _cast)
for _name, (_field, _prefix) in _RGB_KNOBS.items():
    globals()[_name] = _make_rgb_setter(_prefix)


def _apply_conf(conf, prefix: str, settings=None) -> None:
    """Push every knob of ``conf`` whose setter name starts with the group's
    naming (the reference's apply_* functions, rendering.py:64-80)."""
    for name, (field, path, cast) in _KNOBS.items():
        if path.startswith(prefix) and hasattr(conf, field):
            globals()[name](getattr(conf, field), settings)
    for name, (field, pfx) in _RGB_KNOBS.items():
        if pfx.startswith(prefix) and hasattr(conf, field):
            globals()[name](getattr(conf, field), settings)


def enable_RTX_real_time(settings: RenderSettings | None = None, **kwargs) -> None:
    (settings or get_settings()).set("/rtx/rendermode", "RayTracedLighting")


def enable_RTX_interactive(settings: RenderSettings | None = None, **kwargs) -> None:
    (settings or get_settings()).set("/rtx/rendermode", "PathTracing")


def apply_lens_flare(conf: FlaresConf, settings=None) -> None:
    _apply_conf(conf, "/rtx/post/lensFlares/", settings)


def apply_chromatic_aberrations(conf: ChromaticAberrationsConf, settings=None) -> None:
    _apply_conf(conf, "/rtx/post/chromaticAberration/", settings)


def apply_motion_blur(conf: MotionBlurConf, settings=None) -> None:
    _apply_conf(conf, "/rtx/post/motionblur/", settings)


# -- the effects themselves (jitted) -----------------------------------------


def _resample_bilinear(img: Array, xs: Array, ys: Array) -> Array:
    """Gather ``img[ys, xs]`` with bilinear weights, edge-clamped."""
    h, w = img.shape
    x0 = jnp.clip(jnp.floor(xs).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(ys).astype(jnp.int32), 0, h - 2)
    fx = jnp.clip(xs - x0, 0.0, 1.0)
    fy = jnp.clip(ys - y0, 0.0, 1.0)
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


@functools.partial(jax.jit, static_argnames=("models",))
def chromatic_aberration(
    image: Array,
    strength: Array,
    models: Tuple[str, str, str] = ("Radial", "Radial", "Radial"),
) -> Array:
    """Per-channel radial/barrel warp (the RTX chromaticAberration model).

    ``Radial``: sample channel c at r' = r * (1 + k_c); ``Barrel``:
    r' = r * (1 + k_c * r_hat^2) (distortion growing with radius).
    """
    h, w, _ = image.shape
    yy, xx = jnp.mgrid[0:h, 0:w].astype(image.dtype)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    dx, dy = xx - cx, yy - cy
    r2 = (dx / cx) ** 2 + (dy / cy) ** 2  # normalized radius^2
    chans = []
    for c in range(3):
        k = strength[c]
        if models[c] == "Barrel":
            scale = 1.0 + k * r2
        else:  # Radial
            scale = 1.0 + k
        chans.append(
            _resample_bilinear(image[..., c], cx + dx * scale, cy + dy * scale)
        )
    return jnp.stack(chans, axis=-1)


def starburst_kernel(
    blades: int,
    rotation_deg: float,
    length_px: int,
    aspect: float = 1.5,
    dtype=jnp.float32,
) -> Array:
    """N-bladed diffraction-spike PSF: ``blades`` exponentially decaying
    streaks at equal angles (aperture-blade diffraction), normalized to
    unit mass. Even blade counts produce 'blades' spikes, odd counts 2x
    (physics of odd apertures) — matched by spreading over 2*blades rays."""
    size = 2 * length_px + 1
    yy, xx = jnp.mgrid[-length_px : length_px + 1, -length_px : length_px + 1]
    xx = xx.astype(dtype)
    yy = yy.astype(dtype) * aspect
    r = jnp.sqrt(xx**2 + yy**2)
    theta = jnp.arctan2(yy, xx)
    rot = jnp.deg2rad(rotation_deg)
    n_rays = blades if blades % 2 == 0 else 2 * blades
    k = jnp.zeros((size, size), dtype)
    for i in range(n_rays):
        ang = rot + 2.0 * jnp.pi * i / n_rays
        # angular falloff around the ray + radial exponential decay
        d_ang = jnp.arctan2(jnp.sin(theta - ang), jnp.cos(theta - ang))
        ray = jnp.exp(-(d_ang**2) / 0.002) * jnp.exp(-3.0 * r / length_px)
        k = k + ray
    k = k.at[length_px, length_px].set(k.max())
    return k / jnp.sum(k)


@functools.partial(jax.jit, static_argnames=("blades", "length_px"))
def lens_flare(
    image: Array,
    scale: Array,
    blades: int,
    rotation_deg: Array,
    length_px: int,
    aspect: float = 1.5,
    threshold: float = 0.85,
) -> Array:
    """Bright-pass + starburst convolution, added scaled by ``scale``."""
    lum = jnp.mean(image, axis=-1)
    bright = jnp.where(lum > threshold, lum - threshold, 0.0)
    kern = starburst_kernel(blades, rotation_deg, length_px, aspect, image.dtype)
    glow = jax.lax.conv_general_dilated(
        bright[None, None, :, :],
        kern[None, None, :, :],
        (1, 1),
        "SAME",
    )[0, 0]
    return image + scale * glow[..., None]


@functools.partial(jax.jit, static_argnames=("num_samples",))
def motion_blur(
    image: Array,
    velocity_px: Array,
    exposure_fraction: Array,
    max_diameter_fraction: Array,
    num_samples: int = 8,
) -> Array:
    """Average ``num_samples`` taps along the (global) image-space velocity
    — the camera-motion blur of the RTX post pass. ``velocity_px`` is the
    per-frame image translation in pixels."""
    h, w, _ = image.shape
    diag = jnp.sqrt(jnp.asarray(h * h + w * w, image.dtype))
    v = velocity_px * exposure_fraction
    norm = jnp.linalg.norm(v) + 1e-8
    v = v * jnp.minimum(1.0, max_diameter_fraction * diag / norm)
    yy, xx = jnp.mgrid[0:h, 0:w].astype(image.dtype)

    if num_samples < 2:
        return image  # a single tap is the identity (and 0/0 otherwise)

    def tap(i):
        t = (i / (num_samples - 1)) - 0.5
        xs = xx + t * v[0]
        ys = yy + t * v[1]
        return jax.vmap(
            lambda c: _resample_bilinear(image[..., c], xs, ys)
        )(jnp.arange(3)).transpose(1, 2, 0)

    taps = jax.vmap(tap)(jnp.arange(num_samples, dtype=image.dtype))
    return jnp.mean(taps, axis=0)


def apply_post_fx(
    image: Array,
    settings: RenderSettings | None = None,
    velocity_px=(0.0, 0.0),
) -> Array:
    """Run the enabled effects in the RTX order: chromatic aberration ->
    lens flare -> motion blur. ``image`` is (H, W, 3) in [0, 1]."""
    s = settings or get_settings()
    image = jnp.asarray(image)
    if s.get("/rtx/post/chromaticAberration/enabled"):
        strength = jnp.asarray(
            [
                s.get("/rtx/post/chromaticAberration/strengthR"),
                s.get("/rtx/post/chromaticAberration/strengthG"),
                s.get("/rtx/post/chromaticAberration/strengthB"),
            ],
            image.dtype,
        )
        models = tuple(
            s.get(f"/rtx/post/chromaticAberration/model{c}") for c in "RGB"
        )
        image = chromatic_aberration(image, strength, models)
    if s.get("/rtx/post/lensFlares/enabled"):
        # streak length from the optics: focal length over fstop, scaled by
        # sensor diagonal (an aperture ~f/N throws spikes ~ f/N-proportional)
        f = s.get("/rtx/post/lensFlares/focalLength")
        n = s.get("/rtx/post/lensFlares/fNumber")
        diag = s.get("/rtx/post/lensFlares/sensorDiagonal")
        length_px = max(4, int(round((f / max(n, 0.1)) * diag / 4.0)))
        image = lens_flare(
            image,
            jnp.asarray(s.get("/rtx/post/lensFlares/flareScale"), image.dtype),
            int(s.get("/rtx/post/lensFlares/blades")),
            jnp.asarray(
                s.get("/rtx/post/lensFlares/apertureRotation"), image.dtype
            ),
            length_px,
            float(s.get("/rtx/post/lensFlares/sensorAspectRatio")),
        )
    if s.get("/rtx/post/motionblur/enabled"):
        image = motion_blur(
            image,
            jnp.asarray(velocity_px, image.dtype),
            jnp.asarray(
                s.get("/rtx/post/motionblur/exposureFraction"), image.dtype
            ),
            jnp.asarray(
                s.get("/rtx/post/motionblur/maxBlurDiameterFraction"),
                image.dtype,
            ),
            int(s.get("/rtx/post/motionblur/numSamples")),
        )
    return jnp.clip(image, 0.0, 1.0)
