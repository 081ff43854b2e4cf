"""Reclaim action: cross-queue eviction for non-overused queues.

Mirrors pkg/scheduler/actions/reclaim/reclaim.go:40-192 — victims come from
OTHER queues that are reclaimable, via the tiered Reclaimable dispatch;
eviction is direct (ssn.evict, no statement). Engine ``tpu`` runs this
rotation through evict_tpu._ReclaimScreener, a host-side node pre-filter
that changes no decision; engine ``callbacks`` runs it over every node.
"""

from __future__ import annotations

from typing import Optional

from ..api import PodGroupPhase, Resource, TaskStatus
from ..obs import trace as obs_trace
from ..utils import PriorityQueue
from .base import Action
from .preempt import action_engine


class ReclaimAction(Action):
    NAME = "reclaim"
    DEFAULT_ENGINE = "callbacks"

    def __init__(self, engine: Optional[str] = None):
        self.engine = engine or self.DEFAULT_ENGINE

    def check_conf(self, configurations) -> None:
        action_engine(configurations, self.NAME, self.engine)

    def execute(self, ssn) -> None:
        engine = action_engine(ssn.configurations, self.NAME, self.engine)
        if engine == "tpu":
            from .evict_tpu import execute_reclaim_tpu
            return execute_reclaim_tpu(ssn)
        with obs_trace.span("reclaim_rotation", engine=engine):
            return self._execute_callbacks(ssn)

    def _execute_callbacks(self, ssn, screener=None) -> None:
        """The reference rotation verbatim. ``screener`` (optional) is a
        conservative node pre-filter — it must return a SUPERSET of the
        nodes whose per-node body could succeed, in ssn.nodes order; the
        per-node logic below is what decides, so a screener can only skip
        work, never change a decision. note_evict/note_pipeline keep its
        totals live."""
        queues = PriorityQueue(ssn.queue_order_fn)
        queue_set = set()
        preemptors_map = {}
        preemptor_tasks = {}

        for job in ssn.jobs.values():
            if job.podgroup.phase == PodGroupPhase.PENDING:
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.passed:
                continue
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            if queue.uid not in queue_set:
                queue_set.add(queue.uid)
                queues.push(queue)
            pending = job.task_status_index.get(TaskStatus.PENDING, {})
            if pending:
                preemptors_map.setdefault(
                    job.queue, PriorityQueue(ssn.job_order_fn)).push(job)
                pq = PriorityQueue(ssn.task_order_fn)
                for task in pending.values():
                    pq.push(task)
                preemptor_tasks[job.uid] = pq

        while not queues.empty():
            queue = queues.pop()
            if ssn.overused(queue):
                continue
            jobs = preemptors_map.get(queue.uid)
            if jobs is None or jobs.empty():
                continue
            job = jobs.pop()
            tasks = preemptor_tasks.get(job.uid)
            if tasks is None or tasks.empty():
                continue
            task = tasks.pop()

            assigned = False
            node_iter = (screener.nodes_for(task) if screener is not None
                         else ssn.nodes.values())
            for node in node_iter:
                try:
                    ssn.predicate_fn(task, node)
                except ValueError:      # a predicate's fit error
                    continue

                reclaimees = []
                for t in node.tasks.values():
                    if t.status != TaskStatus.RUNNING:
                        continue
                    j = ssn.jobs.get(t.job)
                    if j is None or j.queue == job.queue:
                        continue
                    victim_queue = ssn.queues.get(j.queue)
                    if victim_queue is None or not victim_queue.reclaimable:
                        continue
                    reclaimees.append(t.clone())
                victims = ssn.reclaimable(task, reclaimees)
                if not victims:
                    continue
                future_idle = node.future_idle()
                for v in victims:
                    future_idle.add(v.resreq)
                if not task.init_resreq.less_equal(future_idle):
                    continue

                resreq = task.init_resreq.clone()
                reclaimed = Resource()
                for reclaimee in victims:
                    ssn.evict(ssn.jobs[reclaimee.job].tasks[reclaimee.uid],
                              "reclaim")
                    if screener is not None:
                        screener.note_evict(reclaimee)
                    reclaimed.add(reclaimee.resreq)
                    if resreq.less_equal(reclaimed):
                        break
                if task.init_resreq.less_equal(reclaimed):
                    ssn.pipeline(task, node.name)
                    if screener is not None:
                        screener.note_pipeline(task, node)
                    assigned = True
                    break

            if assigned:
                jobs.push(job)
            queues.push(queue)
