"""Statement: the all-or-nothing gang transaction.

Mirrors pkg/scheduler/framework/statement.go:46-395 — an
undo log of Allocate/Pipeline/Evict operations against session state;
``commit()`` flushes binds and evictions to the cache, ``discard()`` rolls
everything back in reverse order. The device solve's decisions are only a proposal until a
Statement commits them.
"""

from __future__ import annotations

from typing import List, NamedTuple

from ..api import TaskInfo, TaskStatus

ALLOCATE = "allocate"
PIPELINE = "pipeline"
EVICT = "evict"


class _Op(NamedTuple):
    name: str
    task: TaskInfo
    reason: str = ""


class Statement:
    def __init__(self, ssn):
        self.ssn = ssn
        self.operations: List[_Op] = []

    # -- speculative ops (recorded; session state mutated now) --------------

    def allocate(self, task: TaskInfo, node) -> None:
        """statement.go:229-289."""
        hostname = node.name
        job = self.ssn.jobs[task.job]
        job.update_task_status(task, TaskStatus.ALLOCATED)
        task.node_name = hostname
        self.ssn.nodes[hostname].add_task(task)
        self.ssn._fire_allocate(task)
        self.operations.append(_Op(ALLOCATE, task))

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        """statement.go:145-185."""
        job = self.ssn.jobs[task.job]
        job.update_task_status(task, TaskStatus.PIPELINED)
        task.node_name = hostname
        self.ssn.nodes[hostname].add_task(task)
        self.ssn._fire_allocate(task)
        self.operations.append(_Op(PIPELINE, task))

    def evict(self, reclaimee: TaskInfo, reason: str = "") -> None:
        """statement.go:59-96."""
        job = self.ssn.jobs[reclaimee.job]
        job.update_task_status(reclaimee, TaskStatus.RELEASING)
        node = self.ssn.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(job.tasks[reclaimee.uid])
        self.ssn._fire_deallocate(reclaimee)
        self.operations.append(_Op(EVICT, reclaimee, reason))

    # -- undo (statement.go:110-143,190-227,318-350) ------------------------

    def _undo(self, task: TaskInfo) -> None:
        """unallocate / unpipeline: both return the task to Pending and
        release what it held on its node."""
        job = self.ssn.jobs[task.job]
        job.update_task_status(task, TaskStatus.PENDING)
        node = self.ssn.nodes.get(task.node_name)
        if node is not None:
            node.remove_task(task)
        task.node_name = ""
        self.ssn._fire_deallocate(task)

    def _unevict(self, task: TaskInfo) -> None:
        job = self.ssn.jobs[task.job]
        job.update_task_status(task, TaskStatus.RUNNING)
        node = self.ssn.nodes.get(task.node_name)
        if node is not None:
            node.update_task(job.tasks[task.uid])
        self.ssn._fire_allocate(task)

    # -- terminal -----------------------------------------------------------

    def discard(self) -> None:
        """Roll back all recorded operations in reverse (statement.go:352-374)."""
        for op in reversed(self.operations):
            if op.name == EVICT:
                self._unevict(op.task)
            else:
                self._undo(op.task)
        self.operations.clear()

    def commit(self) -> None:
        """Flush side effects: binds for allocations, evictions to the cache;
        pipelines stay session-only (statement.go:377-395)."""
        for op in self.operations:
            if op.name == ALLOCATE:
                self.ssn.dispatch(op.task)
            elif op.name == EVICT:
                self.ssn._audit_event("evict", op.task, op.reason)
                self.ssn.cache.evict(op.task, op.reason)
        self.operations.clear()
