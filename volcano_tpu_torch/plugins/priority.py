"""Priority plugin (mirrors
pkg/scheduler/plugins/priority/priority.go:44-117): task
and job order by priority, higher first."""

from __future__ import annotations

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


def New(arguments):
    return PriorityPlugin(arguments)
