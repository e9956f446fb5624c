"""Named-robot management over the vectorized rover simulator.

A re-design of ``src/robots/robot.py`` (``RobotManager``: spawn / teleport
/ reset / reset_all with ``max_robots`` capacity and namespaced robot names,
:32-267) and of the deferred-modification semantics of the ROS wrappers
(``src/environments_wrappers/ros2/robot_manager_ros2.py:20-118``: every
request is queued in a ``modifications`` list and applied *between* physics
steps, never inside one — simulation_manager_ros2.py:216-233).

The reference mutates a USD stage; here the "stage" is a fixed-capacity
``RoverState`` pytree (static shapes — spawning activates a slot instead of
allocating), so every operation is a jit-compatible masked update and the
manager itself is a thin host-side registry:

* ``spawn(name, position, heading)``   — RobotManager.add_robot + preload at
  terrain height + drop height (simulation_manager_ros2.py:197-199 spawns at
  ``get_height(x, y) + 0.5``; here the surrogate sim rides the surface, so
  the slot starts *on* the surface).
* ``teleport(name, position, heading)`` — dynamic-control teleport
  (robot.py:316-329), zeroing wheel state.
* ``reset(name)`` / ``reset_all()``    — return to spawn pose.
* all of the above enqueue; ``apply_modifications(state, hf)`` executes the
  queue and returns the new device state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np
from jax import Array

from ..core.heightfield import HeightField
from . import rover_sim
from .rover_sim import RoverState


@dataclasses.dataclass
class RobotSpec:
    """Per-robot registration record (the Robot object's USD metadata slice
    that survives the port: name, namespace, spawn pose; robot.py:270-300)."""

    name: str
    slot: int
    spawn_position: Tuple[float, float]
    spawn_heading: Tuple[float, float, float]
    namespace: str = ""
    active: bool = True


class RobotManager:
    """Fixed-capacity registry of named rovers over one ``RoverState``.

    Mirrors the reference contract (robot.py:32-130): at most ``max_robots``
    robots; names are unique; spawn/teleport/reset/reset_all; requests are
    deferred until :meth:`apply_modifications`.
    """

    def __init__(self, max_robots: int = 5):
        self.max_robots = int(max_robots)
        self._robots: Dict[str, RobotSpec] = {}
        self._modifications: List[Callable[[RoverState, HeightField], RoverState]] = []

    # -- registry ---------------------------------------------------------

    @property
    def names(self) -> List[str]:
        return list(self._robots)

    def __contains__(self, name: str) -> bool:
        return name in self._robots

    def spec(self, name: str) -> RobotSpec:
        return self._robots[name]

    def slot(self, name: str) -> int:
        return self._robots[name].slot

    def active_mask(self) -> np.ndarray:
        mask = np.zeros((self.max_robots,), bool)
        for spec in self._robots.values():
            mask[spec.slot] = spec.active
        return mask

    def initial_state(self, hf: HeightField, dtype=None) -> RoverState:
        """Allocate the fixed-capacity state: every slot exists from step 0
        (static shapes); inactive slots park at the origin."""
        positions = np.zeros((self.max_robots, 2), np.float64)
        headings = np.tile(np.array([1.0, 0.0, 0.0]), (self.max_robots, 1))
        for spec in self._robots.values():
            positions[spec.slot] = spec.spawn_position
            headings[spec.slot] = spec.spawn_heading
        return RoverState.create(positions, headings, hf, dtype=dtype)

    # -- deferred request surface (robot_manager_ros2.py:20-118) ----------

    def spawn(
        self,
        name: str,
        position: Tuple[float, float],
        heading: Tuple[float, float, float] = (1.0, 0.0, 0.0),
        namespace: str = "",
    ) -> RobotSpec:
        """Register + enqueue activation of a robot (Spawn topic)."""
        if name in self._robots:
            raise ValueError(f"robot {name!r} already spawned")
        if len(self._robots) >= self.max_robots:
            raise RuntimeError(
                f"max_robots={self.max_robots} reached (robot.py:75-80 caps)"
            )
        used = {s.slot for s in self._robots.values()}
        slot = next(i for i in range(self.max_robots) if i not in used)
        spec = RobotSpec(name, slot, tuple(position), tuple(heading), namespace)
        self._robots[name] = spec
        self._modifications.append(
            lambda state, hf, s=spec: rover_sim.teleport(
                state, hf, s.slot,
                jnp.asarray(s.spawn_position),
                jnp.asarray(s.spawn_heading),
            )
        )
        return spec

    def teleport(
        self,
        name: str,
        position: Tuple[float, float],
        heading: Tuple[float, float, float] = (1.0, 0.0, 0.0),
    ) -> None:
        """Enqueue a teleport (Teleport topic -> robot.py:316-329)."""
        slot = self._robots[name].slot
        self._modifications.append(
            lambda state, hf: rover_sim.teleport(
                state, hf, slot, jnp.asarray(position), jnp.asarray(heading)
            )
        )

    def reset(self, name: str) -> None:
        """Enqueue a reset to the spawn pose (Reset topic)."""
        spec = self._robots[name]
        self.teleport(name, spec.spawn_position, spec.spawn_heading)

    def reset_all(self) -> None:
        """Enqueue reset of every registered robot (ResetAll topic)."""
        for name in list(self._robots):
            self.reset(name)

    def enqueue(
        self, fn: Callable[[RoverState, HeightField], RoverState]
    ) -> None:
        """Arbitrary deferred stage edit (base_wrapper_ros2.py:78-92)."""
        self._modifications.append(fn)

    @property
    def pending(self) -> int:
        return len(self._modifications)

    def apply_modifications(
        self, state: RoverState, hf: HeightField
    ) -> RoverState:
        """Run the queued edits, in order, between physics steps
        (simulation_manager_ros2.py:226-230)."""
        mods, self._modifications = self._modifications, []
        for fn in mods:
            state = fn(state, hf)
        return state

    # -- readbacks (RobotRigidGroup surface) -------------------------------

    def pose(self, state: RoverState, name: str):
        """(position xy, z, heading) of one robot (robot.py get_pose)."""
        slot = self._robots[name].slot
        return (
            np.asarray(state.position[slot]),
            float(state.z[slot]),
            np.asarray(state.heading[slot]),
        )

    def velocities(self, state: RoverState, name: str):
        """(linear speed, yaw rate) readback (RobotRigidGroup velocities)."""
        slot = self._robots[name].slot
        lin = float((state.wheel_left[slot] + state.wheel_right[slot]) / 2.0)
        return lin, float(state.yaw_rate[slot])

    def contact_forces(
        self, params: rover_sim.RoverParams, hf: HeightField, state: RoverState
    ) -> Array:
        """All-slot contact force readback (robot.py:449-462)."""
        return rover_sim.contact_forces(params, hf, state)
