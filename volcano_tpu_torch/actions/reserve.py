"""Reserve action: lock nodes for the elected target job until it is
ready.

Mirrors pkg/scheduler/actions/reserve/reserve.go:40-77.
"""

from __future__ import annotations

from ..obs import trace as obs_trace
from ..utils.reservation import Reservation
from .base import Action


class ReserveAction(Action):
    NAME = "reserve"

    def execute(self, ssn) -> None:
        if Reservation.target_job is None:
            return
        with obs_trace.span("reserve_nodes"):
            target = ssn.jobs.get(Reservation.target_job.uid)
            if target is None:
                Reservation.reset()
                return
            Reservation.target_job = target
            if not target.ready():
                ssn.reserved_nodes()
            else:
                Reservation.reset()
