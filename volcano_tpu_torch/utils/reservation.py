"""The reservation state (util.Reservation of
pkg/scheduler/util/scheduler_helper.go:254-266): the elected target job and
the nodes locked for it, shared by the elect and reserve actions and the
reservation plugin. It is a module global, as upstream's is, so it outlives
a session and a scheduler: a caller that starts a new world resets it."""

from __future__ import annotations

from typing import Dict


class ResourceReservation:
    def __init__(self):
        self.target_job = None
        self.locked_nodes: Dict[str, object] = {}

    def reset(self) -> None:
        self.target_job = None
        self.locked_nodes.clear()


Reservation = ResourceReservation()
