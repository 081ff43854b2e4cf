"""SchedulerCache: the live cluster model the scheduler snapshots each cycle
(mirrors pkg/scheduler/cache/cache.go). Holds nodes, queues
and jobs, clones them into a per-cycle ClusterInfo, and funnels binds to the
Binder."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ..api import (ClusterInfo, JobInfo, NodeInfo, QueueInfo,
                   Resource, TaskInfo, TaskStatus)
from .executors import (Binder, Evictor, FakeBinder, FakeEvictor,
                        StatusUpdater)


class SchedulerCache:
    def __init__(self, binder: Optional[Binder] = None,
                 evictor: Optional[Evictor] = None,
                 status_updater: Optional[StatusUpdater] = None,
                 default_queue: str = "default"):
        self._lock = threading.RLock()
        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}
        self.binder = binder or FakeBinder()
        self.evictor = evictor or FakeEvictor()
        self.status_updater = status_updater or StatusUpdater()
        if default_queue:
            self.queues[default_queue] = QueueInfo(name=default_queue)

    # -- ingestion (event_handlers.go analogues) ----------------------------

    def add_node(self, node: NodeInfo) -> None:
        with self._lock:
            self.nodes[node.name] = node

    def add_queue(self, queue: QueueInfo) -> None:
        with self._lock:
            self.queues[queue.uid] = queue

    def add_job(self, job: JobInfo) -> None:
        with self._lock:
            self.jobs[job.uid] = job

    # -- snapshot (cache.go:801-893) ----------------------------------------

    def snapshot(self) -> ClusterInfo:
        """A full clone of ready nodes, queues and jobs: the session
        mutates only this copy."""
        with self._lock:
            ci = ClusterInfo()
            for name, node in self.nodes.items():
                if node.ready:
                    ci.nodes[name] = node.clone()
            for uid, q in self.queues.items():
                ci.queues[uid] = q.clone()
            for uid, job in self.jobs.items():
                if job.podgroup is not None:
                    ci.jobs[uid] = job.clone()
        return ci

    # -- binds --------------------------------------------------------------

    def _mark_bound(self, task: TaskInfo) -> Tuple[Optional[TaskInfo], bool]:
        """Mark the cached copy of ``task`` BOUND. Returns ``(cached,
        newly_placed)``: a newly placed task still has to be added to its
        node's accounting by the caller; a re-bind of a placed task is
        re-accounted here; an unknown task gives ``(None, False)``. Caller
        holds the lock."""
        job = self.jobs.get(task.job)
        if job is None or task.uid not in job.tasks:
            return None, False
        cached = job.tasks[task.uid]
        if cached.node_name:
            job.update_task_status(cached, TaskStatus.BOUND)
            if cached.node_name in self.nodes:
                self.nodes[cached.node_name].update_task(cached)
            return cached, False
        cached.node_name = task.node_name
        job.update_task_status(cached, TaskStatus.BOUND)
        return cached, True

    def _unbind(self, task: TaskInfo) -> None:
        """Roll back what _mark_bound and the node accounting did for a
        newly placed task whose Binder call failed."""
        with self._lock:
            job = self.jobs.get(task.job)
            if job is not None and task.uid in job.tasks:
                cached = job.tasks[task.uid]
                node = self.nodes.get(cached.node_name)
                if node is not None:
                    node.remove_task(cached)
                job.update_task_status(cached, TaskStatus.PENDING)
                cached.node_name = ""

    def bind(self, task: TaskInfo) -> None:
        """Mark the optimistic Bound state FIRST, then execute the bind
        through the Binder (the reference's AddBindingTask-then-Bind order,
        cache.go:602-666). A Binder failure rolls the cache back and
        raises."""
        with self._lock:
            cached, newly = self._mark_bound(task)
            if newly and task.node_name in self.nodes:
                self.nodes[task.node_name].add_task(cached)
        if cached is None:
            return
        try:
            self.binder.bind(task, task.node_name)
        except Exception:
            if newly:
                self._unbind(task)
            raise

    def bind_batch(self, tasks: List[TaskInfo]) -> None:
        """Batched bind: one optimistic pass with per-node aggregated
        accounting, then the Binder calls. Semantics match bind() per task;
        the aggregation removes the per-task Resource arithmetic that
        dominates a 10k-bind cycle."""
        agg: Dict[str, Resource] = {}
        placed = []
        with self._lock:
            for task in tasks:
                cached, newly = self._mark_bound(task)
                if cached is None:
                    continue
                node = self.nodes.get(task.node_name)
                if newly and node is not None:
                    # the clone keeps status BOUND so a later
                    # remove_task/update_task re-accounts correctly
                    node.tasks[cached.uid] = cached.clone()
                    agg.setdefault(task.node_name, Resource()).add(
                        cached.resreq)
                placed.append((task, newly))
            for name, r in agg.items():
                node = self.nodes[name]
                node.idle.sub(r)
                node.used.add(r)
        for i, (task, _) in enumerate(placed):
            try:
                self.binder.bind(task, task.node_name)
            except Exception:
                for t, newly in placed[i:]:
                    if newly:
                        self._unbind(t)
                raise

    # -- evictions ----------------------------------------------------------

    def evict(self, task: TaskInfo, reason: str) -> None:
        """Execute an eviction through the Evictor, then mark the cached
        task RELEASING on its job and node (cache.go:549-599). An Evictor
        failure leaves the cache as it was and raises."""
        self.evictor.evict(task, reason)
        with self._lock:
            job = self.jobs.get(task.job)
            if job is not None and task.uid in job.tasks:
                cached = job.tasks[task.uid]
                job.update_task_status(cached, TaskStatus.RELEASING)
                if cached.node_name in self.nodes:
                    self.nodes[cached.node_name].update_task(cached)

    def update_job_status(self, job: JobInfo) -> None:
        self.status_updater.update_pod_group(job)
