"""Reservation plugin: elects the target job and locks nodes for it.

Mirrors pkg/scheduler/plugins/reservation/reservation.go:44-141. The locked
nodes are recorded and read by nothing else: allocate places onto them, as
the JAX package's does.
"""

from __future__ import annotations

from ..utils.reservation import Reservation
from .base import Plugin


class ReservationPlugin(Plugin):
    NAME = "reservation"

    def on_session_open(self, ssn) -> None:
        def target_job_fn(jobs):
            """The highest priority, then the longest waiting by
            ScheduleStartTimestamp (reservation.go:66-117 getTargetJob); a
            tie keeps the earlier candidate in list order."""
            if not jobs:
                return None
            highest = max(j.priority for j in jobs)
            candidates = [j for j in jobs if j.priority == highest]
            return min(candidates,
                       key=lambda j: (j.schedule_start_timestamp
                                      if j.schedule_start_timestamp
                                      is not None else j.creation_timestamp))

        ssn.add_target_job_fn(self.NAME, target_job_fn)

        def reserved_nodes_fn():
            """Lock the unlocked node with the most idle resources
            (reservation.go:120-141)."""
            best = None
            for node in ssn.nodes.values():
                if node.name in Reservation.locked_nodes:
                    continue
                if best is None or best.idle.less_equal(node.idle):
                    best = node
            if best is not None:
                Reservation.locked_nodes[best.name] = best

        ssn.add_reserved_nodes_fn(self.NAME, reserved_nodes_fn)


def New(arguments):
    return ReservationPlugin(arguments)
