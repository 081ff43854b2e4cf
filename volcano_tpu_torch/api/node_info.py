"""NodeInfo: per-node resource accounting.

Mirrors pkg/scheduler/api/node_info.go:29-400 — Idle/Used/
Releasing/Pipelined vectors, ``FutureIdle = Idle + Releasing - Pipelined``,
and the per-status AddTask/RemoveTask bookkeeping that the Statement undo log
relies on.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .job_info import TaskInfo
from .resource import Resource
from .types import TaskStatus


class NodeInfo:
    def __init__(self, name: str = "", allocatable: Optional[Resource] = None,
                 labels: Optional[Dict[str, str]] = None,
                 taints: Optional[List[dict]] = None):
        self.name = name
        self.allocatable = allocatable.clone() if allocatable else Resource()
        self.idle = self.allocatable.clone()
        self.used = Resource()
        self.releasing = Resource()
        self.pipelined = Resource()
        self.labels = dict(labels or {})
        self.taints = list(taints or [])
        self.tasks: Dict[str, TaskInfo] = {}
        # ready mirrors NodePhase; the snapshot skips nodes flagged not-ready
        # (cache.go:822-827)
        self.ready = True

    @property
    def max_task_num(self) -> int:
        return self.allocatable.max_task_num or 0

    def _allocate_idle(self, task: TaskInfo) -> None:
        if not task.resreq.less_equal(self.idle):
            raise ValueError(
                f"selected node NotReady: task {task.key()} resreq {task.resreq} "
                f"exceeds idle {self.idle} on node {self.name}")
        self.idle.sub(task.resreq)

    def add_task(self, task: TaskInfo) -> None:
        """Per-status accounting (node_info.go AddTask):

        - RELEASING: consumes idle, counted in both Releasing and Used;
        - PIPELINED: only reserves future resources (Pipelined);
        - otherwise (Allocated/Bound/...): consumes idle, counted in Used.
        """
        if task.node_name and self.name and task.node_name != self.name:
            raise ValueError(f"task {task.key()} already on node {task.node_name}")
        if task.uid in self.tasks:
            raise ValueError(f"task {task.key()} already on node {self.name}")

        ti = task.clone()
        if ti.status == TaskStatus.RELEASING:
            self._allocate_idle(ti)
            self.releasing.add(ti.resreq)
            self.used.add(ti.resreq)
        elif ti.status == TaskStatus.PIPELINED:
            self.pipelined.add(ti.resreq)
        else:
            self._allocate_idle(ti)
            self.used.add(ti.resreq)

        task.node_name = self.name
        ti.node_name = self.name
        self.tasks[ti.uid] = ti

    def remove_task(self, task: TaskInfo) -> None:
        own = self.tasks.get(task.uid)
        if own is None:
            return
        if own.status == TaskStatus.RELEASING:
            self.releasing.sub(own.resreq)
            self.idle.add(own.resreq)
            self.used.sub(own.resreq)
        elif own.status == TaskStatus.PIPELINED:
            self.pipelined.sub(own.resreq)
        else:
            self.idle.add(own.resreq)
            self.used.sub(own.resreq)
        task.node_name = ""
        del self.tasks[own.uid]

    def update_task(self, task: TaskInfo) -> None:
        self.remove_task(task)
        self.add_task(task)

    def clone(self) -> "NodeInfo":
        """Snapshot copy with direct state transfer: the aggregates are exact
        invariants of the task set, and allocatable/labels/taints are never
        mutated after construction, so clones share them."""
        n = NodeInfo.__new__(NodeInfo)
        n.name = self.name
        n.allocatable = self.allocatable
        n.idle = self.idle.clone()
        n.used = self.used.clone()
        n.releasing = self.releasing.clone()
        n.pipelined = self.pipelined.clone()
        n.labels = self.labels
        n.taints = self.taints
        n.ready = self.ready
        n.tasks = {}
        for uid, task in self.tasks.items():
            ti = task.clone()
            ti.node_name = self.name
            n.tasks[uid] = ti
        return n

    def __repr__(self) -> str:
        return f"Node({self.name} idle=<{self.idle}> used=<{self.used}>)"
