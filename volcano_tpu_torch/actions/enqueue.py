"""Enqueue action: gates PodGroup Pending -> Inqueue on plugin votes.

Mirrors pkg/scheduler/actions/enqueue/enqueue.go:43-102.
"""

from __future__ import annotations

from ..api import PodGroupPhase
from ..obs import trace as obs_trace
from ..utils import PriorityQueue
from .base import Action


class EnqueueAction(Action):
    NAME = "enqueue"

    def execute(self, ssn) -> None:
        with obs_trace.span("enqueue_gate"):
            self._execute(ssn)

    def _execute(self, ssn) -> None:
        queues = PriorityQueue(ssn.queue_order_fn)
        queue_set = set()
        jobs_map = {}

        for job in ssn.jobs.values():
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            if queue.uid not in queue_set:
                queue_set.add(queue.uid)
                queues.push(queue)
            if job.podgroup.phase == PodGroupPhase.PENDING:
                jobs_map.setdefault(queue.uid, PriorityQueue(ssn.job_order_fn)
                                    ).push(job)

        while not queues.empty():
            queue = queues.pop()
            jobs = jobs_map.get(queue.uid)
            if jobs is None or jobs.empty():
                continue
            job = jobs.pop()
            if job.podgroup.min_resources is None or ssn.job_enqueueable(job):
                job.podgroup.phase = PodGroupPhase.INQUEUE
                ssn.job_enqueued(job)
                # write the phase through now, not just at session close:
                # allocate may bind this gang later in the same cycle
                ssn.cache.update_job_status(job)
            queues.push(queue)
