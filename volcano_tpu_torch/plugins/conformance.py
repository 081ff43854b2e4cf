"""Conformance plugin: vetoes eviction of critical system pods (mirrors
pkg/scheduler/plugins/conformance/conformance.go:45-66)."""

from __future__ import annotations

from ..framework.session import PERMIT
from .base import Plugin

CRITICAL_PRIORITY_CLASSES = ("system-cluster-critical", "system-node-critical")


def _is_critical(task) -> bool:
    if task.namespace == "kube-system":
        return True
    pc = task.annotations.get("priorityClassName", "") or \
        getattr(task, "priority_class_name", "")
    return pc in CRITICAL_PRIORITY_CLASSES


class ConformancePlugin(Plugin):
    NAME = "conformance"

    def on_session_open(self, ssn) -> None:
        def evictable(evictor, evictees):
            victims = [t for t in evictees if not _is_critical(t)]
            return victims, PERMIT

        ssn.add_preemptable_fn(self.NAME, evictable)
        ssn.add_reclaimable_fn(self.NAME, evictable)


def New(arguments):
    return ConformancePlugin(arguments)
