"""Synthetic data generation (SDG) — array-native replacement for the
replicator/annotator pipeline of ``src/labeling/`` (auto_label.py:174-239 +
rep_utils.py writers).

The reference records RGB / depth / semantic / instance annotations from
Isaac Sim render products. Without an external renderer, this framework
renders its labels directly from the simulation state, all under jit:

* ``hillshade``   — Lambertian sun-lit rendering of the DEM (RGB proxy);
* ``height_map``  — orthographic height (the "depth" modality of a
  top-down orthographic camera);
* ``semantic``    — class ids rasterized from rock/crater footprints;
* ``instance``    — per-rock instance ids;
* ``normals``     — surface normal map.

Writers mirror rep_utils: per-run hashed directories, PNG via PIL + raw
``.npy`` dumps, per-frame pose JSON.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array


@dataclasses.dataclass
class LabelingConf:
    """auto_label.py AutonomousLabelingConf essentials."""

    num_images: int = 100
    prim_path: str = "/World"
    save_rgb: bool = True
    save_depth: bool = True
    save_semantics: bool = True
    save_instances: bool = False
    save_normals: bool = False
    data_dir: str = "sdg_output"


def surface_normals(z: Array, resolution: float) -> Array:
    """(H, W, 3) unit normals from central differences."""
    dzdx = (jnp.roll(z, -1, 0) - jnp.roll(z, 1, 0)) / (2 * resolution)
    dzdy = (jnp.roll(z, -1, 1) - jnp.roll(z, 1, 1)) / (2 * resolution)
    n = jnp.stack([-dzdx, -dzdy, jnp.ones_like(z)], axis=-1)
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)


@jax.jit
def hillshade(z: Array, resolution: float, sun_direction: Array) -> Array:
    """Lambertian shaded relief of the DEM lit by ``sun_direction`` (3,)
    — the RGB-proxy render product."""
    n = surface_normals(z, resolution)
    sun = sun_direction / jnp.linalg.norm(sun_direction)
    shade = jnp.clip(jnp.einsum("hwc,c->hw", n, sun), 0.0, 1.0)
    return shade


@functools.partial(jax.jit, static_argnames=("steps",))
def cast_shadow_mask(z: Array, resolution, sun_direction: Array,
                     steps: int = 64) -> Array:
    """(H, W) soft shadow mask (1 = shadowed): march each DEM cell toward
    the sun in fixed world-space steps and test terrain occlusion — the
    cast-shadow half the Lambertian hillshade lacks (the reference's
    ray-traced renders darken crater floors at low sun elevation; this
    restores that photometric response so stellar-driven sun motion
    changes images the same way)."""
    from ..terrain.upsample import bilinear_point_sample

    h, w = z.shape
    sun = sun_direction / jnp.linalg.norm(sun_direction)
    # march length: enough to clear the window at grazing angles
    max_t = jnp.float32(max(h, w)) * resolution
    eps = resolution * 0.5

    rows = jnp.arange(h, dtype=z.dtype)[:, None]
    cols = jnp.arange(w, dtype=z.dtype)[None, :]

    ts = (jnp.arange(1, steps + 1, dtype=z.dtype) / steps) ** 2 * max_t

    def body(shadowed, t):
        px = rows + sun[0] * t / resolution
        py = cols + sun[1] * t / resolution
        ray_z = z + sun[2] * t + eps
        inside = ((px >= 0) & (px <= h - 1) & (py >= 0) & (py <= w - 1))
        occ = inside & (bilinear_point_sample(z, px, py) > ray_z)
        return jnp.logical_or(shadowed, occ), None

    shadowed, _ = jax.lax.scan(body, jnp.zeros_like(z, bool), ts)
    return shadowed.astype(z.dtype)


@functools.partial(jax.jit, static_argnames=("shadow_steps",))
def hillshade_shadowed(z: Array, resolution, sun_direction: Array,
                       shadow_steps: int = 64,
                       ambient: float = 0.15) -> Array:
    """:func:`hillshade` with cast shadows: shadowed cells fall to the
    ambient floor regardless of their local Lambertian term."""
    shade = hillshade(z, resolution, sun_direction)
    mask = cast_shadow_mask(z, resolution, sun_direction, steps=shadow_steps)
    return ambient + (1.0 - ambient) * shade * (1.0 - mask)


def semantic_mask(
    shape: tuple, resolution: float, origin, rock_xy: np.ndarray,
    rock_radius: np.ndarray, ground_id: int = 1, rock_id: int = 2,
) -> Array:
    """Class-id raster: ground everywhere, rocks stamped as disks
    (the 'ground'/rock semantic labels of the reference pipeline)."""
    h, w = shape
    ox, oy = origin
    rows = jnp.arange(h) * resolution + ox
    cols = jnp.arange(w) * resolution + oy
    seg = jnp.full(shape, ground_id, jnp.int32)
    if len(rock_xy) == 0:
        return seg
    _, hit_ids = _stamp_rocks(rows, cols, rock_xy, rock_radius)
    return jnp.where(hit_ids > 0, rock_id, seg)


def instance_mask(
    shape: tuple, resolution: float, origin, rock_xy: np.ndarray,
    rock_radius: np.ndarray,
) -> Array:
    """Per-rock instance ids (1-based; 0 = background)."""
    h, w = shape
    ox, oy = origin
    rows = jnp.arange(h) * resolution + ox
    cols = jnp.arange(w) * resolution + oy
    if len(rock_xy) == 0:
        return jnp.zeros(shape, jnp.int32)
    _, hit_ids = _stamp_rocks(rows, cols, rock_xy, rock_radius)
    return hit_ids


def _stamp_rocks(rows: Array, cols: Array, rock_xy, rock_radius):
    """Rock-disk rasterization as a ``lax.scan`` over rocks — O(H*W)
    memory instead of the dense (H, W, num_rocks) distance tensor (which
    is ~0.8 GB for an 800x800 yard at 300 rocks and OOMs at window
    scale). Returns ``(hit_any, ids)`` with 1-based ids, later rocks
    winning ties (matching the previous max-id semantics)."""
    rx = jnp.asarray(rock_xy)[:, 0]
    ry = jnp.asarray(rock_xy)[:, 1]
    rr = jnp.asarray(rock_radius)
    ids = jnp.arange(1, rx.shape[0] + 1, dtype=jnp.int32)

    def body(acc, rock):
        x, y, r, idx = rock
        d2 = (rows[:, None] - x) ** 2 + (cols[None, :] - y) ** 2
        inside = d2 <= r * r
        return jnp.where(inside, idx.astype(jnp.int32), acc), None

    stack = jnp.stack([rx, ry, rr, ids.astype(rx.dtype)], axis=1)
    init = jnp.zeros((rows.shape[0], cols.shape[0]), jnp.int32)
    out, _ = jax.lax.scan(body, init, stack)
    return out > 0, out


@dataclasses.dataclass
class CameraIntrinsics:
    """Pinhole intrinsics — the reference's camera surface (focal length +
    apertures, rep_utils.py:108-126 / auto_label.py camera products),
    reduced to fx/fy/cx/cy pixel form."""

    width: int = 640
    height: int = 480
    focal_length: float = 24.0          # mm
    horizontal_aperture: float = 20.955  # mm (USD default)
    vertical_aperture: float | None = None

    @property
    def fx(self) -> float:
        return self.width * self.focal_length / self.horizontal_aperture

    @property
    def fy(self) -> float:
        va = self.vertical_aperture
        if va is None:
            va = self.horizontal_aperture * self.height / self.width
        return self.height * self.focal_length / va

    @property
    def cx(self) -> float:
        return self.width / 2.0

    @property
    def cy(self) -> float:
        return self.height / 2.0

    def as_dict(self) -> dict:
        return {
            "width": self.width, "height": self.height,
            "focal_length": self.focal_length,
            "horizontal_aperture": self.horizontal_aperture,
            "fx": self.fx, "fy": self.fy, "cx": self.cx, "cy": self.cy,
        }


def camera_pose_from_rover(rover_xy, heading_xy, ground_z,
                           mount_height: float = 0.8,
                           pitch_deg: float = 15.0):
    """Robot-mounted camera pose: position above the rover, looking along
    the heading, pitched down. Returns ``(cam_pos (3,), R (3,3))`` with
    ``R``'s columns = camera (right, down, forward) axes in world frame
    (+z up). Matches the reference's robot-frame camera mounting
    (auto_label.py:174-230 render products follow the robot prim)."""
    hx, hy = float(heading_xy[0]), float(heading_xy[1])
    n = float(np.hypot(hx, hy))
    if n < 1e-9:  # degenerate heading: default to +x (a zero vector would
        hx, hy, n = 1.0, 0.0, 1.0  # NaN the whole rotation matrix)
    hx, hy = hx / n, hy / n
    p = np.deg2rad(pitch_deg)
    fwd = np.array([np.cos(p) * hx, np.cos(p) * hy, -np.sin(p)])
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)
    cam_pos = np.array([float(rover_xy[0]), float(rover_xy[1]),
                        float(ground_z) + mount_height])
    return cam_pos, R


@functools.partial(jax.jit, static_argnames=("width", "height", "steps"))
def camera_raycast(
    z: Array, resolution, origin, cam_pos: Array, cam_R: Array,
    fx, fy, cx, cy, *, width: int, height: int, steps: int = 192,
    max_range: float = 40.0,
):
    """Perspective heightfield raycast: per-pixel rays marched against the
    DEM (fixed-step with linear hit refinement — the jitted stand-in for
    the reference's RTX depth/semantic render products). ``z`` is indexed
    ``[row = x, col = y]`` with world position ``origin + index *
    resolution`` (the streamer window layout).

    Returns ``(depth, hit_x, hit_y, hit_mask)``, each ``(height, width)``;
    ``depth`` is distance-to-image-plane (the reference's
    ``distance_to_image_plane`` annotator semantics), ``inf`` where the ray
    escapes the window or exceeds ``max_range``."""
    from ..terrain.upsample import bilinear_point_sample

    h_px, w_px = z.shape
    dt = z.dtype
    resolution = jnp.asarray(resolution, dt)
    ox, oy = jnp.asarray(origin[0], dt), jnp.asarray(origin[1], dt)
    cam_pos = jnp.asarray(cam_pos, dt)
    cam_R = jnp.asarray(cam_R, dt)
    fx, fy = jnp.asarray(fx, dt), jnp.asarray(fy, dt)
    cx, cy = jnp.asarray(cx, dt), jnp.asarray(cy, dt)
    max_range = jnp.asarray(max_range, dt)

    def sample(px, py):
        return bilinear_point_sample(z, px, py)

    # rays scaled so the march parameter s IS the image-plane depth:
    # d_cam = ((u - cx)/fx, (v - cy)/fy, 1)
    u = (jnp.arange(width, dtype=z.dtype) - cx) / fx
    v = (jnp.arange(height, dtype=z.dtype) - cy) / fy
    d_cam = jnp.stack([
        jnp.broadcast_to(u[None, :], (height, width)),
        jnp.broadcast_to(v[:, None], (height, width)),
        jnp.ones((height, width), z.dtype),
    ], axis=-1)
    d_world = jnp.einsum("ij,hwj->hwi", cam_R.astype(z.dtype), d_cam)

    ss = jnp.linspace(0.05, max_range, steps).astype(z.dtype)

    def clearance(s):
        p = cam_pos[None, None, :] + d_world * s
        px = (p[..., 0] - ox) / resolution
        py = (p[..., 1] - oy) / resolution
        inside = ((px >= 0) & (px <= h_px - 1) & (py >= 0) & (py <= w_px - 1))
        c = p[..., 2] - sample(px, py)
        return jnp.where(inside, c, jnp.inf)

    def body(carry, s):
        prev_s, prev_c, hit_s, hit_mask = carry
        c = clearance(s)
        new_hit = jnp.logical_and(jnp.logical_not(hit_mask),
                                  jnp.isfinite(c) & (c <= 0.0))
        # linear refinement between the bracketing samples
        denom = prev_c - c
        frac = jnp.where(jnp.abs(denom) > 1e-12, prev_c / denom, 1.0)
        s_ref = jnp.where(jnp.isfinite(prev_c),
                          prev_s + jnp.clip(frac, 0.0, 1.0) * (s - prev_s),
                          s)
        hit_s = jnp.where(new_hit, s_ref, hit_s)
        hit_mask = jnp.logical_or(hit_mask, new_hit)
        return (s, c, hit_s, hit_mask), None

    c0 = clearance(ss[0])
    init = (ss[0], c0,
            jnp.full((height, width), jnp.inf, z.dtype),
            c0 <= 0.0)
    (_, _, hit_s, hit_mask), _ = jax.lax.scan(body, init, ss[1:])
    hit_s = jnp.where(hit_mask, hit_s, jnp.inf)
    p = cam_pos[None, None, :] + d_world * jnp.where(
        hit_mask, hit_s, 0.0)[..., None]
    return hit_s, p[..., 0], p[..., 1], hit_mask


def _rock_intersections(cam_pos, d_world, centers, radii, max_range):
    """Nearest ray-sphere hit against half-buried rock impostors (spheres
    centred on the ground surface — the camera pass's stand-in for the
    reference's instanced rock meshes). ``d_world`` is the UNSCALED ray
    direction from :func:`camera_raycast`, so the returned ``s`` is in the
    same image-plane-depth parameter as the terrain march.

    Returns ``(s, rock_id)`` per pixel — ``inf`` / ``0`` where no rock is
    hit. One ``lax.scan`` iteration per rock keeps memory at O(H*W)."""
    dt = d_world.dtype
    a = jnp.sum(d_world * d_world, axis=-1)  # (H, W), > 0
    ids = jnp.arange(1, radii.shape[0] + 1, dtype=dt)
    rocks = jnp.concatenate(
        [centers.astype(dt), radii[:, None].astype(dt), ids[:, None]],
        axis=1)

    def body(carry, rock):
        best_s, best_id = carry
        c, r, idx = rock[:3], rock[3], rock[4]
        oc = cam_pos - c
        b = 2.0 * jnp.einsum("hwi,i->hw", d_world, oc)
        c0 = jnp.dot(oc, oc) - r * r
        disc = b * b - 4.0 * a * c0
        s_hit = (-b - jnp.sqrt(jnp.maximum(disc, 0.0))) / (2.0 * a)
        valid = (disc > 0) & (s_hit > 0.05) & (s_hit <= max_range)
        s_hit = jnp.where(valid, s_hit, jnp.inf)
        better = s_hit < best_s
        return (jnp.where(better, s_hit, best_s),
                jnp.where(better, idx.astype(jnp.int32), best_id)), None

    init = (jnp.full(a.shape, jnp.inf, dt),
            jnp.zeros(a.shape, jnp.int32))
    (s, rock_id), _ = jax.lax.scan(body, init, rocks)
    return s, rock_id


def render_camera_frame(
    z, resolution: float, origin, cam_pos, cam_R,
    intrinsics: CameraIntrinsics, sun_direction=(0.4, 0.2, 0.9),
    rock_xy=None, rock_radius=None, steps: int = 192,
    max_range: float = 40.0, cast_shadows: bool = False,
) -> dict:
    """Camera-frame modality dict (depth / rgb / semantic / instance) from
    one raycast — the pose-consistent perspective render pass the top-down
    rasters lack (reference surface:
    rep_utils.py:108-126 + auto_label.py:174-230)."""
    z = jnp.asarray(z)
    depth, hx, hy, hit = camera_raycast(
        z, jnp.asarray(resolution, z.dtype),
        (jnp.asarray(origin[0], z.dtype), jnp.asarray(origin[1], z.dtype)),
        jnp.asarray(cam_pos, z.dtype), jnp.asarray(cam_R, z.dtype),
        intrinsics.fx, intrinsics.fy, intrinsics.cx, intrinsics.cy,
        width=intrinsics.width, height=intrinsics.height, steps=steps,
        max_range=max_range,
    )
    shade_fn = hillshade_shadowed if cast_shadows else hillshade
    shade = shade_fn(z, resolution, jnp.asarray(sun_direction, z.dtype))
    px = jnp.clip((hx - origin[0]) / resolution, 0, z.shape[0] - 1)
    py = jnp.clip((hy - origin[1]) / resolution, 0, z.shape[1] - 1)
    rgb = jnp.where(hit, shade[px.astype(jnp.int32), py.astype(jnp.int32)],
                    0.0)
    if rock_xy is not None and len(rock_xy):
        # rocks occlude: analytic sphere impostors centred on the ground
        # surface compete with the terrain march per ray, so depth / rgb /
        # semantic / instance are all pose-consistent (the reference's
        # instanced rock meshes occlude in its RTX renders)
        from ..terrain.upsample import bilinear_point_sample

        rx = jnp.asarray(rock_xy, z.dtype)[:, 0]
        ry = jnp.asarray(rock_xy, z.dtype)[:, 1]
        rr = jnp.asarray(rock_radius, z.dtype)
        gz = bilinear_point_sample(
            z, (rx - origin[0]) / resolution, (ry - origin[1]) / resolution)
        centers = jnp.stack([rx, ry, gz], axis=-1)
        # recompute the unscaled ray directions the raycast marched
        u = (jnp.arange(intrinsics.width, dtype=z.dtype) - intrinsics.cx) \
            / intrinsics.fx
        v = (jnp.arange(intrinsics.height, dtype=z.dtype) - intrinsics.cy) \
            / intrinsics.fy
        d_cam = jnp.stack([
            jnp.broadcast_to(u[None, :], (intrinsics.height,
                                          intrinsics.width)),
            jnp.broadcast_to(v[:, None], (intrinsics.height,
                                          intrinsics.width)),
            jnp.ones((intrinsics.height, intrinsics.width), z.dtype),
        ], axis=-1)
        d_world = jnp.einsum(
            "ij,hwj->hwi", jnp.asarray(cam_R, z.dtype), d_cam)
        cam_p = jnp.asarray(cam_pos, z.dtype)
        s_rock, rock_id = _rock_intersections(
            cam_p, d_world, centers, rr, jnp.asarray(max_range, z.dtype))
        rock_hit = s_rock < depth          # wins where nearer than terrain
        depth = jnp.where(rock_hit, s_rock, depth)
        hit = jnp.logical_or(hit, rock_hit)
        # Lambertian sphere shading from the surface normal at the hit
        p_hit = cam_p[None, None, :] + d_world * jnp.where(
            rock_hit, s_rock, 0.0)[..., None]
        idx = jnp.clip(rock_id - 1, 0, rr.shape[0] - 1)
        n = (p_hit - centers[idx]) / rr[idx][..., None]
        sun = jnp.asarray(sun_direction, z.dtype)
        sun = sun / jnp.linalg.norm(sun)
        rock_shade = jnp.clip(jnp.einsum("hwi,i->hw", n, sun), 0.0, 1.0)
        rgb = jnp.where(rock_hit, rock_shade, rgb)
        out = {"depth": depth, "rgb": rgb, "hit": hit}
        out["semantic"] = jnp.where(
            rock_hit, 2, jnp.where(hit, 1, 0)).astype(jnp.int32)
        out["instance"] = jnp.where(rock_hit, rock_id, 0).astype(jnp.int32)
    else:
        out = {"depth": depth, "rgb": rgb, "hit": hit}
        out["semantic"] = jnp.where(hit, 1, 0).astype(jnp.int32)
        out["instance"] = jnp.zeros_like(out["semantic"])
    return out


class AutonomousLabeling:
    """Frame recorder (auto_label.py:232-239 ``record`` loop semantics):
    each ``record`` call renders the enabled modalities from the current
    terrain/rocks state and writes them to the hashed run directory."""

    def __init__(self, conf: LabelingConf, render_settings=None):
        self.conf = conf
        # Optional RTX-style post pipeline applied to the RGB modality
        # (startSim applies lens flares / motion blur / chromatic
        # aberrations before SDG runs, environments_wrappers/__init__.py).
        self.render_settings = render_settings
        run_hash = hashlib.sha256(str(time.time()).encode()).hexdigest()[:10]
        self.run_dir = pathlib.Path(conf.data_dir) / run_hash
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.frame = 0

    def record(
        self, z, resolution: float, origin=(0.0, 0.0),
        sun_direction=(0.4, 0.2, 0.9), rock_xy=None, rock_radius=None,
        pose=None,
    ) -> dict:
        """Render + persist one frame; returns the modality dict."""
        z = jnp.asarray(z)
        out = {}
        if self.conf.save_rgb:
            rgb = hillshade(z, resolution, jnp.asarray(sun_direction, z.dtype))
            if self.render_settings is not None:
                from .render_fx import apply_post_fx

                rgb3 = jnp.repeat(rgb[..., None], 3, axis=-1)
                rgb = apply_post_fx(rgb3, self.render_settings)
            out["rgb"] = np.asarray(rgb)
        if self.conf.save_depth:
            out["depth"] = np.asarray(z)
        if self.conf.save_normals:
            out["normals"] = np.asarray(surface_normals(z, resolution))
        rocks = rock_xy if rock_xy is not None else np.zeros((0, 2))
        radii = rock_radius if rock_radius is not None else np.zeros((0,))
        if self.conf.save_semantics:
            out["semantic"] = np.asarray(
                semantic_mask(z.shape, resolution, origin, rocks, radii)
            )
        if self.conf.save_instances:
            out["instance"] = np.asarray(
                instance_mask(z.shape, resolution, origin, rocks, radii)
            )
        self._write(out, pose)
        self.frame += 1
        return out

    def record_camera(
        self, z, resolution: float, origin, rover_xy, heading_xy, ground_z,
        intrinsics: CameraIntrinsics | None = None,
        sun_direction=(0.4, 0.2, 0.9), rock_xy=None, rock_radius=None,
        mount_height: float = 0.8, pitch_deg: float = 15.0,
        steps: int = 192, max_range: float = 40.0,
        cast_shadows: bool = False, frame: int | None = None,
    ) -> dict:
        """Render + persist one robot-mounted perspective frame (depth /
        rgb / semantic / instance) with its camera intrinsics + pose JSON —
        the camera-frame SDG pass (auto_label.py:174-230 render products;
        intrinsics surface rep_utils.py:108-126).

        ``frame`` joins the camera products to an already-recorded capture
        (same frame id as the top-down pass, the reference's
        one-id-per-capture convention) without advancing the counter."""
        intrinsics = intrinsics or CameraIntrinsics()
        saved_frame = self.frame
        if frame is not None:
            self.frame = int(frame)
        cam_pos, cam_R = camera_pose_from_rover(
            rover_xy, heading_xy, ground_z, mount_height, pitch_deg)
        rendered = render_camera_frame(
            z, resolution, origin, cam_pos, cam_R, intrinsics,
            sun_direction=sun_direction, rock_xy=rock_xy,
            rock_radius=rock_radius, steps=steps, max_range=max_range,
            cast_shadows=cast_shadows,
        )
        out = {f"cam_{k}": np.asarray(v) for k, v in rendered.items()
               if k != "hit"}
        # finite PNG range: escaped rays render at max_range
        out["cam_depth"] = np.where(np.isfinite(out["cam_depth"]),
                                    out["cam_depth"], max_range)
        # joined captures: the top-down pass owns pose_{frame}.json (rover
        # pose) — the camera pose lives in camera_{frame}.json below
        self._write(out, pose=None if frame is not None else cam_pos)
        with open(self.run_dir / f"camera_{self.frame:05d}.json", "w") as fh:
            json.dump({
                "intrinsics": intrinsics.as_dict(),
                "position": cam_pos.tolist(),
                "rotation": cam_R.tolist(),
            }, fh)
        if frame is None:
            self.frame += 1
        else:
            self.frame = saved_frame
        return rendered

    def _write(self, modalities: dict, pose) -> None:
        """PNG + npy writers (rep_utils.py:17-476 equivalents)."""
        try:
            from PIL import Image
        except ImportError:
            Image = None
        for name, arr in modalities.items():
            np.save(self.run_dir / f"{name}_{self.frame:05d}.npy", arr)
            if Image is not None and arr.ndim == 2:
                img = arr.astype(np.float64)
                rng_ = img.max() - img.min()
                img8 = ((img - img.min()) / (rng_ + 1e-12) * 255).astype(np.uint8)
                Image.fromarray(img8).save(
                    self.run_dir / f"{name}_{self.frame:05d}.png"
                )
        if pose is not None:
            with open(self.run_dir / f"pose_{self.frame:05d}.json", "w") as fh:
                json.dump({"pose": np.asarray(pose).tolist()}, fh)
