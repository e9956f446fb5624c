"""Vectorized rover physics surrogate — the replacement for the
PhysX/Isaac Husky.

The reference drives a PhysX-articulated Husky via wheel velocity-drive
targets (visual_terrain_stack_full_terrain.py:330-335 HuskyController) and
reads back pose/velocity from USD attributes. This framework replaces that
external C++ engine with a batched, differentiable skid-steer simulator:
N rovers advance in lockstep under one jit:

* wheel velocity drives: first-order tracking of the commanded wheel speeds
  (PhysX velocity-drive behaviour; time constant configurable),
* skid-steer body kinematics v=(l+r)/2, w=(r-l)/track (the same diff-drive
  map as the controller's model, sampling_warp.py:123-124),
* surface riding on the DEM: tangent-projected heading + Rodrigues rotation
  about the local normal (the same 2.5D contact model as the rollouts) —
  the rover "lives" on the heightfield exactly as the controller assumes,
* optional actuator noise / slip for sim-to-controller mismatch studies.

All state is a flat pytree with a leading rover axis, so the environment
shards over a ``rover`` mesh axis with zero code changes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from ..core import geometry as geom
from ..core import heightfield as hfield
from ..core.heightfield import HeightField


class RoverParams(NamedTuple):
    """Physical parameters of the simulated Husky."""

    track: float = 1.2            # wheel track [m] (config.yaml robot_radius)
    wheel_tau: float = 0.05       # wheel-drive tracking time constant [s]
    physics_dt: float = 1.0 / 60  # physics step (cfg/environment largescale 60 Hz)
    slip_std: float = 0.0         # multiplicative wheel slip noise
    v_max: float = 5.0            # hard actuator limits
    w_max: float = 4.0
    mass: float = 46.0            # Husky body mass [kg] (for wrench/contact)
    yaw_inertia: float = 2.6      # body yaw inertia [kg m^2]
    gravity: float = 1.62         # lunar surface gravity [m/s^2]


class RoverState(NamedTuple):
    """Batched rover state, leading axis = rover."""

    position: Array     # (N, 2)
    z: Array            # (N,)
    heading: Array      # (N, 3) unit
    wheel_left: Array   # (N,) actual left wheel linear speed [m/s]
    wheel_right: Array  # (N,)
    yaw_rate: Array     # (N,) measured body yaw rate [rad/s]

    @classmethod
    def create(cls, positions, headings, hf: HeightField, dtype=None) -> "RoverState":
        positions = jnp.asarray(positions, dtype or hf.z.dtype)
        n = positions.shape[0]
        headings = jnp.broadcast_to(jnp.asarray(headings, positions.dtype), (n, 3))
        headings = geom.normalize(headings)
        z = hfield.height_at(hf, positions[:, 0], positions[:, 1])
        zero = jnp.zeros((n,), positions.dtype)
        return cls(positions, z, headings, zero, zero, zero)


def step(
    params: RoverParams,
    hf: HeightField,
    state: RoverState,
    cmd_left: Array,
    cmd_right: Array,
    key: Array | None = None,
    ext_force: Array | None = None,
    ext_torque: Array | None = None,
) -> RoverState:
    """Advance every rover one physics step under wheel-speed commands.

    Mirrors the contact semantics the controller models: the same corner
    gather / normal / tangent-projection / Rodrigues sequence as
    ``_generate_trajectories_kernel`` but at the physics rate.

    ``ext_force`` (N, 3) / ``ext_torque`` (N,) are the
    ``RobotRigidGroup.apply_force/apply_torque`` analogue
    (src/robots/robot.py:464-479): the in-plane force component accelerates
    the body along its heading and the z torque adds yaw rate, both for one
    step (the reference applies a one-step PhysX wrench).
    """
    dt = params.physics_dt
    # Wheel velocity drives: exponential approach to the target.
    alpha = 1.0 - jnp.exp(-dt / params.wheel_tau)
    wl = state.wheel_left + (cmd_left - state.wheel_left) * alpha
    wr = state.wheel_right + (cmd_right - state.wheel_right) * alpha
    if key is not None and params.slip_std > 0.0:
        k1, k2 = jax.random.split(key)
        wl = wl * (1.0 + params.slip_std * jax.random.normal(k1, wl.shape, wl.dtype))
        wr = wr * (1.0 + params.slip_std * jax.random.normal(k2, wr.shape, wr.dtype))

    lin = (wl + wr) / 2.0
    ang = (-wl + wr) / params.track
    if ext_force is not None:
        lin = lin + dt * jnp.sum(ext_force * state.heading, axis=-1) / params.mass
    if ext_torque is not None:
        ang = ang + dt * ext_torque / params.yaw_inertia
    lin = jnp.clip(lin, -params.v_max, params.v_max)
    ang = jnp.clip(ang, -params.w_max, params.w_max)

    x, y = geom.update_position(
        state.position[:, 0], state.position[:, 1], state.heading, lin, dt
    )
    q = hfield.corners_at(hf, x, y)
    z = hfield.bilinear(x, y, q, hf.resolution)
    normal = hfield.quad_normal(q, hf.resolution)
    heading = hfield.tangent_project(normal, state.heading)
    heading = geom.update_orientation(heading, ang, normal, dt)

    return RoverState(
        position=jnp.stack([x, y], axis=-1),
        z=z,
        heading=heading,
        wheel_left=wl,
        wheel_right=wr,
        yaw_rate=ang,
    )


def contact_forces(
    params: RoverParams, hf: HeightField, state: RoverState
) -> Array:
    """Per-rover ground contact force vector (N, 3) — the analogue of
    ``RobotRigidGroup.get_net_contact_forces`` (src/robots/robot.py:449-462).

    Quasi-static proxy: the terrain supports the body weight along the local
    surface normal, so F = m * g * cos(slope) * n where n is the quad normal
    under the rover.  (The reference reads the PhysX contact solver; the
    surrogate sim has no penetration, so the static normal load is the
    physically consistent readback.)
    """
    x, y = state.position[:, 0], state.position[:, 1]
    q = hfield.corners_at(hf, x, y)
    normal = hfield.quad_normal(q, hf.resolution)
    load = params.mass * params.gravity * normal[:, 2]
    return normal * load[:, None]


def wheel_contact_forces(
    params: RoverParams,
    hf: HeightField,
    state: RoverState,
    wheelbase: float,
    com_height: float = 0.2,
) -> Array:
    """Per-wheel contact normal loads (N, 4), order [FL, FR, RL, RR] — the
    per-link force readback the reference's deformation engine regresses
    from PhysX contacts (deformation_engine.py:666-680 via
    simulation_manager_ros2.py:231-233).

    Quasi-static rigid-body model on the local surface plane: the terrain
    carries ``m g n_z`` along the quad normal, redistributed by COM load
    transfer — gravity's in-plane components (lateral along the left axis,
    longitudinal along heading) acting at ``com_height`` shift load toward
    the downhill wheels: ``ΔN = m a h / (2 d)`` per wheel pair with d the
    track (lateral) or wheelbase (longitudinal). Negative loads clip to 0
    (wheel lift-off). On flat ground this reduces exactly to the old
    ``m g / 4`` constant.
    """
    x, y = state.position[:, 0], state.position[:, 1]
    q = hfield.corners_at(hf, x, y)
    n = hfield.quad_normal(q, hf.resolution)
    f = hfield.tangent_project(n, state.heading)      # unit fwd on surface
    left = jnp.cross(n, f)                            # unit left axis
    g = params.gravity
    total = params.mass * g * n[:, 2]
    a_lat = -g * left[:, 2]    # gravity accel along +left (left-side-low > 0)
    a_long = -g * f[:, 2]      # gravity accel along +fwd (downhill > 0)
    d_lat = params.mass * a_lat * com_height / (2.0 * params.track)
    d_long = params.mass * a_long * com_height / (2.0 * wheelbase)
    base = total / 4.0
    loads = jnp.stack(
        [
            base + d_lat + d_long,   # front-left
            base - d_lat + d_long,   # front-right
            base + d_lat - d_long,   # rear-left
            base - d_lat - d_long,   # rear-right
        ],
        axis=-1,
    )
    return jnp.maximum(loads, 0.0)


def teleport(
    state: RoverState, hf: HeightField, index: Array, position: Array,
    heading: Array,
) -> RoverState:
    """Teleport one rover (RobotManager.teleport_robot semantics,
    src/robots/robot.py:316-329): reset pose + zero the wheel state."""
    position = jnp.asarray(position, state.position.dtype)
    heading = geom.normalize(jnp.asarray(heading, state.heading.dtype))
    z = hfield.height_at(hf, position[0], position[1])
    zero = lambda arr: arr.at[index].set(jnp.zeros((), arr.dtype))
    return RoverState(
        position=state.position.at[index].set(position),
        z=state.z.at[index].set(z.astype(state.z.dtype)),
        heading=state.heading.at[index].set(heading),
        wheel_left=zero(state.wheel_left),
        wheel_right=zero(state.wheel_right),
        yaw_rate=zero(state.yaw_rate),
    )


def reset_mask(
    state: RoverState, hf: HeightField, mask: Array, positions: Array,
    headings: Array,
) -> RoverState:
    """Vectorized reset of the rovers selected by ``mask`` (the reset-all
    path of the robot manager, batched)."""
    positions = jnp.asarray(positions, state.position.dtype)
    headings = geom.normalize(jnp.asarray(headings, state.heading.dtype))
    z = hfield.height_at(hf, positions[:, 0], positions[:, 1])
    m1 = mask[:, None]
    zero = jnp.zeros_like(state.wheel_left)
    return RoverState(
        position=jnp.where(m1, positions, state.position),
        z=jnp.where(mask, z, state.z),
        heading=jnp.where(m1, headings, state.heading),
        wheel_left=jnp.where(mask, zero, state.wheel_left),
        wheel_right=jnp.where(mask, zero, state.wheel_right),
        yaw_rate=jnp.where(mask, zero, state.yaw_rate),
    )
