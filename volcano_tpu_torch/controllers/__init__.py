"""Controllers: job lifecycle, podgroup auto-gang, queue state, GC
(mirrors Volcano's pkg/controllers)."""

from .framework import Controller
from .garbage_collector import GarbageCollector
from .job_controller import JobController
from .podgroup_controller import PodGroupController
from .queue_controller import QueueController


def start_controllers(store, scheduler_name: str = "volcano"):
    """cmd/controller-manager analogue: initialize every controller against
    the store (server.go:113-130)."""
    controllers = [JobController(), PodGroupController(scheduler_name),
                   QueueController(), GarbageCollector()]
    for c in controllers:
        c.initialize(store)
    return controllers


__all__ = ["Controller", "GarbageCollector", "JobController",
           "PodGroupController", "QueueController", "start_controllers"]
