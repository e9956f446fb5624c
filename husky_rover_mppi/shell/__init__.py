"""Host-side simulation shell.

The reference wraps its sim loop in ROS1/ROS2 node managers
(``src/environments_wrappers/``) whose only jobs are: expose a topic surface,
queue stage edits for application between physics steps, throttle to
realtime, and watch for shutdown. This framework keeps that shell — as a
dependency-free in-process pub/sub bus + monitor — while the compute core
stays pure-functional under jit (SURVEY.md §2.6 "keep a host-level pub/sub
shim").
"""

from .monitor import ThreadMonitor
from .pubsub import MessageBus, Topics
from .rate import Rate
from .sim_manager import SimulationManager, SimulationManagerConf

__all__ = [
    "MessageBus",
    "Topics",
    "Rate",
    "ThreadMonitor",
    "SimulationManager",
    "SimulationManagerConf",
]
