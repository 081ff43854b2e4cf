"""Priority plugin (mirrors
pkg/scheduler/plugins/priority/priority.go:44-117): task
and job order by priority, higher first; victims only from lower-priority
jobs."""

from __future__ import annotations

from ..framework.session import PERMIT
from .base import Plugin


def _by_priority(l, r) -> int:
    if l.priority == r.priority:
        return 0
    return -1 if l.priority > r.priority else 1


class PriorityPlugin(Plugin):
    NAME = "priority"

    def on_session_open(self, ssn) -> None:
        ssn.add_task_order_fn(self.NAME, _by_priority)
        ssn.add_job_order_fn(self.NAME, _by_priority)

        def preemptable(preemptor, preemptees):
            p_job = ssn.jobs[preemptor.job]
            victims = [t for t in preemptees
                       if ssn.jobs[t.job].priority < p_job.priority]
            return victims, PERMIT

        ssn.add_preemptable_fn(self.NAME, preemptable)


def New(arguments):
    return PriorityPlugin(arguments)
