"""Fit errors: why a task failed to place on nodes.

Mirrors pkg/scheduler/api/unschedule_info.go:1-101.
"""

from __future__ import annotations

from typing import Dict, List


class FitError:
    def __init__(self, task=None, node=None, reasons: List[str] = ()):
        self.task_name = getattr(task, "name", "")
        self.task_namespace = getattr(task, "namespace", "")
        self.node_name = getattr(node, "name", "")
        self.reasons = list(reasons)

    def error(self) -> str:
        return (f"task {self.task_namespace}/{self.task_name} on node "
                f"{self.node_name} fit failed: {', '.join(self.reasons)}")

    def __repr__(self) -> str:
        return self.error()


class FitErrors:
    """Aggregates per-node FitError for one task, with reason histogram."""

    def __init__(self):
        self.nodes: Dict[str, FitError] = {}
        self.err: str = ""

    def set_node_error(self, node_name: str, err: object) -> None:
        if isinstance(err, FitError):
            fe = err
        else:
            fe = FitError(reasons=[str(err)])
            fe.node_name = node_name
        self.nodes[node_name] = fe

    def set_error(self, err: str) -> None:
        self.err = err

    def error(self) -> str:
        if self.err:
            return self.err
        reasons: Dict[str, int] = {}
        for fe in self.nodes.values():
            for r in fe.reasons:
                reasons[r] = reasons.get(r, 0) + 1
        sorted_reasons = sorted(reasons.items(), key=lambda kv: (-kv[1], kv[0]))
        return "all nodes are unavailable: " + ", ".join(
            f"{n} {r}" for r, n in sorted_reasons) + "."
