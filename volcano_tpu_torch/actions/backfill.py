"""Backfill action: place best-effort (zero-request) tasks on any node that
passes predicates.

Mirrors pkg/scheduler/actions/backfill/backfill.go:40-92.
"""

from __future__ import annotations

from ..api import FitErrors, PodGroupPhase, TaskStatus
from ..obs import trace as obs_trace
from .base import Action


class BackfillAction(Action):
    NAME = "backfill"

    def execute(self, ssn) -> None:
        with obs_trace.span("backfill_scan"):
            self._execute(ssn)

    def _execute(self, ssn) -> None:
        for job in list(ssn.jobs.values()):
            if job.podgroup.phase == PodGroupPhase.PENDING:
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.passed:
                continue
            pending = list(job.task_status_index.get(TaskStatus.PENDING,
                                                     {}).values())
            for task in pending:
                if not task.init_resreq.is_empty():
                    continue
                fe = FitErrors()
                allocated = False
                for node in ssn.nodes.values():
                    try:
                        ssn.predicate_fn(task, node)
                    except Exception as err:
                        fe.set_node_error(node.name,
                                          getattr(err, "fit_error", err))
                        continue
                    ssn.allocate(task, node)
                    allocated = True
                    break
                if not allocated:
                    job.nodes_fit_errors[task.uid] = fe
