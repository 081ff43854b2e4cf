"""Gang plugin: the all-or-nothing scheduling votes.

Mirrors pkg/scheduler/plugins/gang/gang.go:45-216.
The gang *math* (occupied >= MinAvailable at each job's last task) runs
inside the placement kernel (ops/place.py); this plugin provides the
host-side votes, job validation, ordering, and the session-close PodGroup
condition writeback.
"""

from __future__ import annotations

from ..api import PodGroupConditionType
from ..framework.session import PERMIT, REJECT, ValidateResult
from .base import Plugin

NOT_ENOUGH_PODS_OF_TASK = "NotEnoughPodsOfTask"
NOT_ENOUGH_PODS = "NotEnoughTasks"
NOT_ENOUGH_RESOURCES = "NotEnoughResources"


class GangPlugin(Plugin):
    NAME = "gang"

    def on_session_open(self, ssn) -> None:
        def job_valid(job) -> ValidateResult:
            if not job.check_task_min_available():
                return ValidateResult(
                    False, NOT_ENOUGH_PODS_OF_TASK,
                    "Not enough valid pods of each task for gang-scheduling")
            vtn = job.valid_task_num()
            if vtn < job.min_available:
                return ValidateResult(
                    False, NOT_ENOUGH_PODS,
                    f"Not enough valid tasks for gang-scheduling, valid: {vtn}, "
                    f"min: {job.min_available}")
            return None

        ssn.add_job_valid_fn(self.NAME, job_valid)

        def job_order(l, r) -> int:
            """Ready jobs sort last (gang.go:108-131)."""
            l_ready, r_ready = l.ready(), r.ready()
            if l_ready == r_ready:
                return 0
            return 1 if l_ready else -1

        ssn.add_job_order_fn(self.NAME, job_order)
        ssn.add_job_ready_fn(self.NAME, lambda job: job.ready())

        def pipelined(job) -> int:
            occupied = job.waiting_task_num() + job.ready_task_num()
            return PERMIT if occupied >= job.min_available else REJECT

        ssn.add_job_pipelined_fn(self.NAME, pipelined)

    def on_session_close(self, ssn) -> None:
        """Write PodGroup (Un)schedulable conditions (gang.go:158-216)."""
        for job in ssn.jobs.values():
            if not job.ready():
                unready = job.min_available - job.ready_task_num()
                msg = (f"{unready}/{len(job.tasks)} tasks in gang "
                       f"unschedulable: {job.fit_error()}")
                job.job_fit_errors = msg
                ssn.update_pod_group_condition(job, {
                    "type": PodGroupConditionType.UNSCHEDULABLE.value,
                    "status": "True",
                    "transitionID": ssn.uid,
                    "reason": NOT_ENOUGH_RESOURCES,
                    "message": msg,
                    "lastTransitionTime": ssn.now(),
                })
            else:
                ssn.update_pod_group_condition(job, {
                    "type": PodGroupConditionType.SCHEDULED.value,
                    "status": "True",
                    "transitionID": ssn.uid,
                    "reason": "tasks in gang are ready to be scheduled",
                    "message": "",
                    "lastTransitionTime": ssn.now(),
                })


def New(arguments):
    return GangPlugin(arguments)
