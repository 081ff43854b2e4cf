"""Preempt action: within-queue job-vs-job and within-job preemption for
starving jobs.

Mirrors pkg/scheduler/actions/preempt/preempt.go:41-284. Engine ``tpu``
(actions/evict_tpu.py) runs the victim search as the walk kernel, and
``tpu-sharded`` runs it node-sharded over the mesh of slots (the sharded
walk; a one-slot mesh runs the single walk, with the same decisions);
engine ``callbacks`` is the reference's per-(task, node) loop below, which
the device engines also take for shapes their dense layout cannot hold.
Any other engine is refused by name. Reclaim's ``tpu-sharded`` runs the
callbacks rotation, as the JAX package's does.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from .. import metrics
from ..api import PodGroupPhase, Resource, TaskInfo, TaskStatus
from ..obs import trace as obs_trace
from ..utils import PriorityQueue
from ..utils.scheduler_helper import (predicate_nodes, prioritize_nodes,
                                      sort_nodes)
from .base import Action

ENGINES = ("tpu", "tpu-sharded", "callbacks")


def validate_victims(preemptor: TaskInfo, node, victims: List[TaskInfo]) -> bool:
    """scheduler_helper.go ValidateVictims: enough future idle after
    evicting all victims."""
    if not victims:
        return False
    future_idle = node.future_idle()
    for v in victims:
        future_idle.add(v.resreq)
    return preemptor.init_resreq.less_equal(future_idle)


def action_engine(configurations, name: str, default: str) -> str:
    """The engine a preempt/reclaim configuration block names; refuses one
    this package does not have."""
    engine = default
    for conf in configurations:
        if conf.name == name:
            engine = conf.arguments.get("engine", engine)
    if engine not in ENGINES:
        raise ValueError(f"{name} engine {engine!r} is not in "
                         f"volcano_tpu_torch (has: {ENGINES})")
    return engine


class PreemptAction(Action):
    NAME = "preempt"
    DEFAULT_ENGINE = "callbacks"

    def __init__(self, engine: Optional[str] = None):
        self.engine = engine or self.DEFAULT_ENGINE
        # the last execute's walked phases in host wall seconds and their
        # evaluated tasks (evict_tpu.execute_preempt_tpu); empty when no
        # walk ran
        self.last_stats: Dict[str, float] = {}

    def check_conf(self, configurations) -> None:
        action_engine(configurations, self.NAME, self.engine)

    def execute(self, ssn) -> None:
        self.last_stats = {}
        engine = action_engine(ssn.configurations, self.NAME, self.engine)
        if engine in ("tpu", "tpu-sharded"):
            from .evict_tpu import execute_preempt_tpu
            self.last_stats = execute_preempt_tpu(
                ssn, sharded=engine == "tpu-sharded")
            return
        self._execute_callbacks(ssn)

    def _execute_callbacks(self, ssn) -> None:
        preemptors_map = {}
        preemptor_tasks = {}
        under_request = []
        queues = {}

        for job in ssn.jobs.values():
            if job.podgroup.phase == PodGroupPhase.PENDING:
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.passed:
                continue
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            queues[queue.uid] = queue

            if ssn.job_starving(job):
                preemptors_map.setdefault(
                    job.queue, PriorityQueue(ssn.job_order_fn)).push(job)
                under_request.append(job)
                pq = PriorityQueue(ssn.task_order_fn)
                for task in job.task_status_index.get(TaskStatus.PENDING,
                                                      {}).values():
                    pq.push(task)
                preemptor_tasks[job.uid] = pq

        # preemption between jobs within a queue (preempt.go:83-144)
        with obs_trace.span("preempt_inter_job"):
            self._inter_job_pass(ssn, queues, preemptors_map,
                                 preemptor_tasks)
        # preemption between tasks within one job — ONE pass after the
        # per-queue loop (preempt.go:146-183 sits outside it)
        with obs_trace.span("preempt_intra_job"):
            self._intra_job_pass(ssn, under_request, preemptor_tasks)
        with obs_trace.span("victim_tasks"):
            self._victim_tasks(ssn)

    def _inter_job_pass(self, ssn, queues, preemptors_map,
                        preemptor_tasks) -> None:
        for queue in queues.values():
            while True:
                preemptors = preemptors_map.get(queue.uid)
                if preemptors is None or preemptors.empty():
                    break
                preemptor_job = preemptors.pop()

                stmt = ssn.statement()
                assigned = False
                while True:
                    if not ssn.job_starving(preemptor_job):
                        break
                    if preemptor_tasks[preemptor_job.uid].empty():
                        break
                    preemptor = preemptor_tasks[preemptor_job.uid].pop()

                    def job_filter(task: TaskInfo) -> bool:
                        if task.status != TaskStatus.RUNNING:
                            return False
                        if task.resreq.is_empty():
                            return False
                        victim_job = ssn.jobs.get(task.job)
                        if victim_job is None:
                            return False
                        return (victim_job.queue == preemptor_job.queue
                                and preemptor.job != task.job)

                    if self._preempt(ssn, stmt, preemptor, job_filter):
                        assigned = True

                if ssn.job_pipelined(preemptor_job):
                    stmt.commit()
                else:
                    stmt.discard()
                    continue
                if assigned:
                    preemptors.push(preemptor_job)

    def _intra_job_pass(self, ssn, under_request, preemptor_tasks) -> None:
        for job in under_request:
            pq = PriorityQueue(ssn.task_order_fn)
            for task in job.task_status_index.get(TaskStatus.PENDING,
                                                  {}).values():
                pq.push(task)
            preemptor_tasks[job.uid] = pq
            while not preemptor_tasks[job.uid].empty():
                preemptor = preemptor_tasks[job.uid].pop()
                stmt = ssn.statement()
                assigned = self._preempt(
                    ssn, stmt, preemptor,
                    lambda task: (task.status == TaskStatus.RUNNING
                                  and not task.resreq.is_empty()
                                  and preemptor.job == task.job))
                stmt.commit()
                if not assigned:
                    break

    def _preempt(self, ssn, stmt, preemptor: TaskInfo,
                 task_filter: Callable[[TaskInfo], bool]) -> bool:
        """preempt.go:190-269: evict lowest-priority victims on the best
        node until FutureIdle fits, then Pipeline the preemptor."""
        nodes = list(ssn.nodes.values())
        feasible, _ = predicate_nodes(preemptor, nodes, ssn.predicate_fn)
        scores = prioritize_nodes(preemptor, feasible,
                                  ssn.batch_node_order_fn, ssn.node_order_fn)
        for node in sort_nodes(scores):
            preemptees = [t.clone() for t in node.tasks.values()
                          if task_filter(t)]
            victims = ssn.preemptable(preemptor, preemptees)
            metrics.update_preemption_victims(len(victims))
            if not validate_victims(preemptor, node, victims):
                continue

            # lowest priority first (reversed TaskOrderFn)
            vq = PriorityQueue(lambda l, r: not ssn.task_order_fn(l, r))
            for v in victims:
                vq.push(v)
            preempted = Resource()
            while not vq.empty():
                if preemptor.init_resreq.less_equal(node.future_idle()):
                    break
                preemptee = vq.pop()
                stmt.evict(ssn.jobs[preemptee.job].tasks[preemptee.uid],
                           "preempt")
                preempted.add(preemptee.resreq)
            metrics.register_preemption_attempt()

            if preemptor.init_resreq.less_equal(node.future_idle()):
                stmt.pipeline(preemptor, node.name)
                return True
        return False

    def _victim_tasks(self, ssn) -> None:
        """Plugin-driven eviction pass (VictimTasksFn, preempt.go:272-284)."""
        from .evict_tpu import _victim_tasks_host
        _victim_tasks_host(ssn)
