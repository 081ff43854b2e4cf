"""Elect action: pick the reservation target job.

Mirrors pkg/scheduler/actions/elect/elect.go:28-51.
"""

from __future__ import annotations

from ..api import PodGroupPhase
from ..obs import trace as obs_trace
from ..utils.reservation import Reservation
from .base import Action


class ElectAction(Action):
    NAME = "elect"

    def execute(self, ssn) -> None:
        if Reservation.target_job is not None:
            return
        with obs_trace.span("elect_target"):
            pending = [job for job in ssn.jobs.values()
                       if job.podgroup.phase == PodGroupPhase.PENDING]
            Reservation.target_job = ssn.target_job(pending)
