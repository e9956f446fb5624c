"""Wheel-track terrain deformation engine.

Re-derivation of ``src/terrain_management/deformation_engine.py`` (:22-721):
a grid footprint of points per wheel, a separable depth model
``boundary(y) * (amplitude(F) * depth(x) - mean(F))`` with uniform /
sinusoidal / trapezoidal profiles, rotated into world frame by the link yaw
and stamped into the DEM with a per-pixel pass-count decay.

Differences from the reference:

* footprint profiles and distributions are precomputed arrays; the stamp is
  one jitted scatter over all (rover, wheel, point) at once instead of a
  Python loop per point (deformation_engine.py:710-720);
* the within-call sequential decay (two points hitting the same pixel in one
  call compound) is approximated by evaluating the decay against the
  pre-call pass counts — identical whenever each pixel is touched at most
  once per call, which holds when the footprint spacing matches the grid
  resolution (the reference's own configuration).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array


@dataclasses.dataclass
class FootprintConf:
    """deformation_engine.py FootprintConf: wheel contact patch (m)."""

    width: float = 0.25
    height: float = 0.1


@dataclasses.dataclass
class DeformConstrainConf:
    x_deform_offset: float = 0.0
    y_deform_offset: float = 0.0
    deform_decay_ratio: float = 0.01


@dataclasses.dataclass
class DepthDistributionConf:
    distribution: str = "sinusoidal"   # uniform | sinusoidal | trapezoidal
    wave_frequency: float = 4.14       # sinusoidal grouser frequency
    # trapezoidal parameters
    tail_size: float = 0.2


@dataclasses.dataclass
class BoundaryDistributionConf:
    distribution: str = "trapezoidal"  # uniform | parabolic | trapezoidal
    angle_of_repose: float = 1.047


@dataclasses.dataclass
class ForceDepthRegressionConf:
    """Linear force->depth regression (deformation_engine.py:666-680)."""

    amplitude_slope: float = 0.00006
    amplitude_intercept: float = 0.008
    mean_slope: float = -0.00046
    mean_intercept: float = -0.0013


@dataclasses.dataclass
class DeformationEngineConf:
    enable: bool = True
    render_deform_inv: int = 10
    terrain_resolution: float = 0.05
    terrain_width: float = 50.0
    terrain_height: float = 50.0
    footprint: FootprintConf = dataclasses.field(default_factory=FootprintConf)
    constrain: DeformConstrainConf = dataclasses.field(default_factory=DeformConstrainConf)
    depth: DepthDistributionConf = dataclasses.field(default_factory=DepthDistributionConf)
    boundary: BoundaryDistributionConf = dataclasses.field(default_factory=BoundaryDistributionConf)
    regression: ForceDepthRegressionConf = dataclasses.field(default_factory=ForceDepthRegressionConf)


def _trapezoid_wave(x: np.ndarray, period: float = 1.0) -> np.ndarray:
    """Unit trapezoid wave (deformation_engine.py:256-293 semantics)."""
    saw = (x / period) % 1.0
    return np.clip(np.minimum(saw, 1.0 - saw) * 4.0, 0.0, 1.0)


class DeformationEngine:
    """Vectorized deformation engine; state (DEM, pass counts) is functional."""

    def __init__(self, conf: DeformationEngineConf):
        self.conf = conf
        res = conf.terrain_resolution
        fp = conf.footprint
        # footprint grid in the link frame (FootprintProfileGenerator,
        # deformation_engine.py:40-66)
        x = (
            np.linspace(-fp.height / 2, fp.height / 2,
                        int(fp.height / res) + 1)
            + conf.constrain.x_deform_offset
        )
        y = (
            np.linspace(-fp.width / 2, fp.width / 2, int(fp.width / res) + 1)
            + conf.constrain.y_deform_offset
        )
        xx, yy = np.meshgrid(x, y)
        self.profile = np.column_stack([xx.flatten(), yy.flatten()])
        self.px_width = xx.shape[0]   # number of y rows
        self.px_height = yy.shape[1]  # number of x columns

        self.depth_dist = jnp.asarray(self._depth_distribution(), jnp.float32)
        self.boundary_dist = jnp.asarray(self._boundary_distribution(), jnp.float32)
        self.profile_jnp = jnp.asarray(self.profile, jnp.float32)
        self.sim_height = int(conf.terrain_height / res)

    # distributions (deformation_engine.py:125-542) -------------------------
    def _depth_distribution(self) -> np.ndarray:
        t = np.linspace(-1, 1, self.px_height)
        kind = self.conf.depth.distribution
        if kind == "uniform":
            slice_x = np.ones(self.px_height, np.float32)
        elif kind == "sinusoidal":
            slice_x = np.cos(self.conf.depth.wave_frequency * np.pi * t)
        elif kind == "trapezoidal":
            slice_x = _trapezoid_wave(t / self.conf.depth.tail_size)
        else:
            raise ValueError(kind)
        return np.repeat(slice_x[None, :], self.px_width, axis=0).reshape(-1)

    def _boundary_distribution(self) -> np.ndarray:
        y = np.linspace(-1, 1, self.px_width)
        kind = self.conf.boundary.distribution
        if kind == "uniform":
            slice_y = -np.ones(self.px_width, np.float32)
        elif kind == "parabolic":
            slice_y = y**2 - 1
        elif kind == "trapezoidal":
            tan = np.tan(self.conf.boundary.angle_of_repose)
            mask = (np.abs(y) >= 1 - (1 / tan)).astype(np.float32)
            slice_y = mask * (tan * np.abs(y) - tan + 1) - 1
        else:
            raise ValueError(kind)
        return np.repeat(slice_y[:, None], self.px_height, axis=1).reshape(-1)

    # force model (deformation_engine.py:666-694) ---------------------------
    def deformation_depth(self, normal_forces: Array) -> Array:
        """Per-(link, point) deformation depth."""
        reg = self.conf.regression
        amplitude = reg.amplitude_slope * normal_forces + reg.amplitude_intercept
        mean = reg.mean_slope * normal_forces + reg.mean_intercept
        return (
            self.boundary_dist[None, :]
            * (amplitude[:, None] * self.depth_dist[None, :] - mean[:, None])
        ).reshape(-1)

    def footprint_in_global(self, positions: Array, orientations: Array) -> Array:
        """Rotate the footprint into world frame by the link yaw
        (get_footprint_profile_in_global, deformation_engine.py:648-664;
        orientations are wxyz scalar-first quaternions — Isaac's
        get_world_poses layout, which the reference extraction
        ``hx = 2 w z``, ``hy = 1 - 2 z**2`` assumes)."""
        hx = 2.0 * orientations[:, 0] * orientations[:, 3]
        hy = 1.0 - 2.0 * orientations[:, 3] * orientations[:, 3]
        px = (
            self.profile_jnp[None, :, 0] * hy[:, None]
            - self.profile_jnp[None, :, 1] * hx[:, None]
            + positions[:, 0][:, None]
        )
        py = (
            self.profile_jnp[None, :, 0] * hx[:, None]
            + self.profile_jnp[None, :, 1] * hy[:, None]
            + positions[:, 1][:, None]
        )
        return jnp.stack([px, py], axis=-1).reshape(-1, 2)

    def deform(self, dem: Array, num_pass: Array, positions: Array,
               orientations: Array, normal_forces: Array):
        """Stamp all footprints (deform, deformation_engine.py:695-721).

        Args:
            dem: (H, W); num_pass: (H, W) int32; positions (n, 3);
            orientations (n, 4) wxyz (scalar-first); normal_forces (n,).
        Returns (dem', num_pass').
        """
        res = self.conf.terrain_resolution
        pts = self.footprint_in_global(positions, orientations)
        depth = self.deformation_depth(normal_forces)
        x = jnp.trunc(pts[:, 0] / res).astype(jnp.int32)
        y = (self.sim_height - jnp.trunc(pts[:, 1] / res)).astype(jnp.int32)
        x = jnp.clip(x, 0, dem.shape[1] - 1)
        y = jnp.clip(y, 0, dem.shape[0] - 1)
        decay = self.conf.constrain.deform_decay_ratio ** num_pass[y, x].astype(
            jnp.float32
        )
        dem = dem.at[y, x].add(depth * decay)
        num_pass = num_pass.at[y, x].add(1)
        return dem, num_pass

    def deform_window(self, window: Array, num_pass: Array, resolution: float,
                      origin, positions, yaws, normal_forces):
        """Stamp footprints into a *streamed world window* (row = world x,
        col = world y — the TerrainStreamer layout) instead of the fixed
        small-scale lab grid of :meth:`deform`.

        This is the streamed-terrain deformation path the reference applies
        from robot contacts each sim tick (simulation_manager_ros2.py:231-233
        -> deformation_engine.py:695-721), retargeted at the live HR window.

        Args:
            window: (H, W) heights, row = world x, col = world y.
            num_pass: (H, W) int32 per-pixel pass counts.
            resolution: window meters/px.
            origin: world coordinate of window pixel [0, 0].
            positions: (n, 2) world xy per link (wheel).
            yaws: (n,) world yaw per link (rad).
            normal_forces: (n,) contact normal force per link.
        Returns (window', num_pass').
        """
        positions = jnp.asarray(positions, jnp.float32)
        yaws = jnp.asarray(yaws, jnp.float32)
        # quaternion components that reproduce the reference's heading
        # extraction (hx = 2 q0 q3 = sin yaw, hy = 1 - 2 q3^2 = cos yaw)
        half = yaws / 2.0
        quats = jnp.stack(
            [jnp.cos(half), jnp.zeros_like(half), jnp.zeros_like(half),
             jnp.sin(half)], axis=-1
        )
        pts = self.footprint_in_global(positions, quats)
        depth = self.deformation_depth(jnp.asarray(normal_forces, jnp.float32))
        ox, oy = origin
        r = jnp.trunc((pts[:, 0] - ox) / resolution).astype(jnp.int32)
        c = jnp.trunc((pts[:, 1] - oy) / resolution).astype(jnp.int32)
        r = jnp.clip(r, 0, window.shape[0] - 1)
        c = jnp.clip(c, 0, window.shape[1] - 1)
        decay = self.conf.constrain.deform_decay_ratio ** num_pass[r, c].astype(
            jnp.float32
        )
        window = window.at[r, c].add(depth * decay)
        num_pass = num_pass.at[r, c].add(1)
        return window, num_pass
