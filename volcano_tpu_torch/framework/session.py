"""The Session: one snapshot-scoped scheduling transaction.

Mirrors pkg/scheduler/framework/session.go:38-437 and the
tiered dispatch semantics of session_plugins.go:130-725 (intersection+veto
for victim selection, first-nonzero for order fns, vote semantics for
pipelined/enqueueable, sum for node order).

Besides the reference's per-object callbacks, plugins register *tensor
contributions* — static feasibility masks ``bool[T,N]``, static score
matrices ``f32[T,N]``, and weights for the in-kernel dynamic scorers — which
the allocate action assembles into one device solve on ``ssn.device``.
"""

from __future__ import annotations

import logging
import time
import uuid
from typing import Callable, Dict, List, Optional

import torch

from ..api import JobInfo, NodeInfo, QueueInfo, TaskInfo, TaskStatus
from ..obs.audit import AUDIT
from .conf import Configuration, Tier
from .statement import Statement

log = logging.getLogger(__name__)

# Vote values (plugins/util/util.go Permit/Abstain/Reject).
PERMIT = 1
ABSTAIN = 0
REJECT = -1


class ValidateResult:
    def __init__(self, passed: bool, reason: str = "", message: str = ""):
        self.passed = passed
        self.reason = reason
        self.message = message


class Event:
    def __init__(self, task: TaskInfo):
        self.task = task


class EventHandler:
    def __init__(self, allocate_func: Optional[Callable[[Event], None]] = None,
                 deallocate_func: Optional[Callable[[Event], None]] = None,
                 aggregatable: bool = False):
        """aggregatable=True declares the handler's effect is additive in
        ``event.task.resreq`` within a job: the fused allocate may then fire
        one aggregated event per job instead of one per task."""
        self.allocate_func = allocate_func
        self.deallocate_func = deallocate_func
        self.aggregatable = aggregatable


class Session:
    def __init__(self, cache, tiers: List[Tier],
                 configurations: List[Configuration],
                 device: torch.device,
                 time_fn: Optional[Callable[[], float]] = None,
                 snapshot=None):
        self.uid = str(uuid.uuid4())
        self.cache = cache
        self.tiers = tiers
        self.configurations = configurations
        # where the allocate solve's tensors live: the CUDA card unless the
        # caller asked for the CPU (framework.resolve_device)
        self.device = device
        # plugin decision callbacks (gang condition timestamps) read "now"
        # through ssn.now(), so a shell can pin it to its own clock
        self._time_fn: Callable[[], float] = time_fn or time.time

        # a speculative session (the pipelined cycle) opens on the cache's
        # staged snapshot; open_session sets speculative and spec_basis. It
        # either promotes to the cycle's session at the commit boundary or
        # is abandoned, its pinned tensor epoch retired with it.
        self.speculative = False
        self.spec_basis = None
        self._pinned_epoch = None
        if snapshot is None:
            snapshot = cache.snapshot()
        self.jobs: Dict[str, JobInfo] = snapshot.jobs
        self.nodes: Dict[str, NodeInfo] = snapshot.nodes
        # the snapshot generation this session opened on: the persistent
        # tensor refresh refuses a stale session's delta over a newer
        # snapshot's (cache.tensor_refresh)
        self.snap_epoch = getattr(snapshot, "snap_epoch", None)
        self.queues: Dict[str, QueueInfo] = snapshot.queues
        self.namespaces = snapshot.namespaces

        self.plugins: Dict[str, object] = {}
        self.event_handlers: List[EventHandler] = []

        # callback registries (session.go:58-80)
        self.job_order_fns: Dict[str, Callable] = {}
        self.queue_order_fns: Dict[str, Callable] = {}
        self.task_order_fns: Dict[str, Callable] = {}
        self.namespace_order_fns: Dict[str, Callable] = {}
        self.predicate_fns: Dict[str, Callable] = {}
        self.node_order_fns: Dict[str, Callable] = {}
        self.batch_node_order_fns: Dict[str, Callable] = {}
        self.best_node_fns: Dict[str, Callable] = {}
        self.preemptable_fns: Dict[str, Callable] = {}
        self.reclaimable_fns: Dict[str, Callable] = {}
        self.victim_tasks_fns: Dict[str, Callable] = {}
        self.job_starving_fns: Dict[str, Callable] = {}
        self.overused_fns: Dict[str, Callable] = {}
        self.job_ready_fns: Dict[str, Callable] = {}
        self.job_pipelined_fns: Dict[str, Callable] = {}
        self.job_valid_fns: Dict[str, Callable] = {}
        self.job_enqueueable_fns: Dict[str, Callable] = {}
        self.job_enqueued_fns: Dict[str, Callable] = {}

        # tensor-contribution registries: fns of (session, tasks, node
        # tensors) -> numpy arrays, assembled by cache/snapshot.py
        self.feasibility_fns: Dict[str, Callable] = {}
        self.static_score_fns: Dict[str, Callable] = {}
        self.dynamic_score_weights: Dict[str, dict] = {}
        # plugins whose predicate depends on state mutated during the cycle
        # (host ports): the batched engines re-validate device proposals
        # through predicate_fn at replay time
        self.stateful_predicates: set = set()
        # proportion publishes its per-queue deserved vectors here for the
        # reclaim screener's over-deserved gate
        self.queue_deserved: Dict[str, "Resource"] = {}
        # decision-audit feed (obs.audit): (kind, task_uid, job_uid, extra)
        # tuples appended by dispatch/evict/statement commits, harvested by
        # the scheduler shell after close_session
        self.audit_events: list = []

    def now(self) -> float:
        return self._time_fn()

    # -- registration helpers (AddXxxFn of session_plugins.go) --------------

    def add_job_order_fn(self, name, fn): self.job_order_fns[name] = fn
    def add_queue_order_fn(self, name, fn): self.queue_order_fns[name] = fn
    def add_task_order_fn(self, name, fn): self.task_order_fns[name] = fn
    def add_namespace_order_fn(self, name, fn): self.namespace_order_fns[name] = fn
    def add_predicate_fn(self, name, fn): self.predicate_fns[name] = fn
    def add_node_order_fn(self, name, fn): self.node_order_fns[name] = fn
    def add_batch_node_order_fn(self, name, fn): self.batch_node_order_fns[name] = fn
    def add_best_node_fn(self, name, fn): self.best_node_fns[name] = fn
    def add_preemptable_fn(self, name, fn): self.preemptable_fns[name] = fn
    def add_reclaimable_fn(self, name, fn): self.reclaimable_fns[name] = fn
    def add_victim_tasks_fn(self, name, fn): self.victim_tasks_fns[name] = fn
    def add_job_starving_fn(self, name, fn): self.job_starving_fns[name] = fn
    def add_overused_fn(self, name, fn): self.overused_fns[name] = fn
    def add_job_ready_fn(self, name, fn): self.job_ready_fns[name] = fn
    def add_job_pipelined_fn(self, name, fn): self.job_pipelined_fns[name] = fn
    def add_job_valid_fn(self, name, fn): self.job_valid_fns[name] = fn
    def add_job_enqueueable_fn(self, name, fn): self.job_enqueueable_fns[name] = fn
    def add_job_enqueued_fn(self, name, fn): self.job_enqueued_fns[name] = fn
    def add_event_handler(self, eh: EventHandler): self.event_handlers.append(eh)

    def add_feasibility_fn(self, name, fn): self.feasibility_fns[name] = fn
    def add_static_score_fn(self, name, fn): self.static_score_fns[name] = fn

    def set_dynamic_score_weights(self, name, **weights):
        self.dynamic_score_weights[name] = weights

    # -- tier iteration helper ----------------------------------------------

    def _enabled_fns(self, registry: Dict[str, Callable], flag: Optional[str]):
        """Yield each enabled registered plugin's fn, in tier order."""
        for tier in self.tiers:
            for opt in tier.plugins:
                if flag is not None and not opt.is_enabled(flag):
                    continue
                fn = registry.get(opt.name)
                if fn is not None:
                    yield fn

    # -- order fns: first non-zero comparison wins --------------------------

    def _order(self, registry, flag, l, r, fallback) -> bool:
        for fn in self._enabled_fns(registry, flag):
            j = fn(l, r)
            if j != 0:
                return j < 0
        return fallback(l, r)

    def job_order_fn(self, l: JobInfo, r: JobInfo) -> bool:
        return self._order(self.job_order_fns, "enabledJobOrder", l, r,
                           lambda a, b: (a.creation_timestamp, a.uid)
                           < (b.creation_timestamp, b.uid))

    def queue_order_fn(self, l: QueueInfo, r: QueueInfo) -> bool:
        return self._order(self.queue_order_fns, "enabledQueueOrder", l, r,
                           lambda a, b: a.uid < b.uid)

    def task_order_fn(self, l: TaskInfo, r: TaskInfo) -> bool:
        return self._order(self.task_order_fns, "enabledTaskOrder", l, r,
                           lambda a, b: (a.creation_timestamp, a.uid)
                           < (b.creation_timestamp, b.uid))

    def namespace_order_fn(self, l, r) -> bool:
        return self._order(self.namespace_order_fns, "enabledNamespaceOrder",
                           l, r, lambda a, b: str(a) < str(b))

    # -- predicates ---------------------------------------------------------

    def predicate_fn(self, task: TaskInfo, node: NodeInfo) -> None:
        """All enabled predicates must pass; a failing one raises
        (session_plugins.go PredicateFn)."""
        for fn in self._enabled_fns(self.predicate_fns, "enabledPredicate"):
            fn(task, node)

    def node_order_fn(self, task: TaskInfo, node: NodeInfo) -> float:
        score = 0.0
        for fn in self._enabled_fns(self.node_order_fns, "enabledNodeOrder"):
            score += fn(task, node)
        return score

    def batch_node_order_fn(self, task: TaskInfo,
                            nodes: List[NodeInfo]) -> Dict[str, float]:
        scores: Dict[str, float] = {n.name: 0.0 for n in nodes}
        for fn in self._enabled_fns(self.batch_node_order_fns,
                                    "enabledNodeOrder"):
            for name, s in fn(task, nodes).items():
                scores[name] = scores.get(name, 0.0) + s
        return scores

    def best_node_fn(self, task: TaskInfo,
                     node_scores) -> Optional[NodeInfo]:
        """The first enabled plugin's pick from the grouped node scores, or
        None (session_plugins.go BestNodeFn)."""
        for fn in self._enabled_fns(self.best_node_fns, "enabledBestNode"):
            best = fn(task, node_scores)
            if best is not None:
                return best
        return None

    # -- victim selection: per-tier intersection with veto ------------------

    def _tiered_victims(self, registry, flag, invoke) -> List[TaskInfo]:
        """session_plugins.go:187-236: every participating plugin's
        candidates intersect; an empty set from any of them vetoes the
        tier. A later tier rules only while no plugin has returned victims
        yet: ``init`` spans the tiers, as upstream's does, so a veto after
        one plugin's victims leaves none (the JAX package resets it each
        tier; ROADMAP §3)."""
        victims: List[TaskInfo] = []
        init = False
        for tier in self.tiers:
            for opt in tier.plugins:
                if flag is not None and not opt.is_enabled(flag):
                    continue
                fn = registry.get(opt.name)
                if fn is None:
                    continue
                result = invoke(fn)
                if result is None:      # abstain
                    continue
                candidates = result
                if not candidates:      # veto: this tier yields nothing
                    victims = []
                    break
                if not init:
                    victims = list(candidates)
                    init = True
                else:
                    cand_ids = {c.uid for c in candidates}
                    victims = [v for v in victims if v.uid in cand_ids]
            if init:
                return victims
        return []

    def preemptable(self, preemptor: TaskInfo,
                    preemptees: List[TaskInfo]) -> List[TaskInfo]:
        """Plugin fns return (candidates, vote); ABSTAIN abstains."""
        def invoke(fn):
            candidates, vote = fn(preemptor, preemptees)
            return None if vote == ABSTAIN else candidates
        return self._tiered_victims(self.preemptable_fns, "enabledPreemptable",
                                    invoke)

    def reclaimable(self, reclaimer: TaskInfo,
                    reclaimees: List[TaskInfo]) -> List[TaskInfo]:
        def invoke(fn):
            candidates, vote = fn(reclaimer, reclaimees)
            return None if vote == ABSTAIN else candidates
        return self._tiered_victims(self.reclaimable_fns, "enabledReclaimable",
                                    invoke)

    def victim_tasks(self) -> List[TaskInfo]:
        return self._tiered_victims(self.victim_tasks_fns, "enabledVictim",
                                    lambda fn: fn())

    # -- job votes ----------------------------------------------------------

    def overused(self, queue: QueueInfo) -> bool:
        for fn in self._enabled_fns(self.overused_fns, None):
            if fn(queue):
                return True
        return False

    def job_ready(self, job: JobInfo) -> bool:
        """All registered fns in the first tier that has any must agree
        (session_plugins.go JobReady)."""
        for tier in self.tiers:
            found = False
            for opt in tier.plugins:
                if not opt.is_enabled("enabledJobReady"):
                    continue
                fn = self.job_ready_fns.get(opt.name)
                if fn is None:
                    continue
                found = True
                if not fn(job):
                    return False
            if found:
                return True
        return True

    def _vote(self, registry, flag, obj) -> bool:
        """Permit/abstain/reject tier voting (JobPipelined/JobEnqueueable)."""
        for tier in self.tiers:
            has_permit = False
            for opt in tier.plugins:
                if not opt.is_enabled(flag):
                    continue
                fn = registry.get(opt.name)
                if fn is None:
                    continue
                res = fn(obj)
                if res < 0:
                    return False
                if res > 0:
                    has_permit = True
            if has_permit:
                return True
        return True

    def job_pipelined(self, job: JobInfo) -> bool:
        return self._vote(self.job_pipelined_fns, "enabledJobPipelined", job)

    def job_enqueueable(self, job: JobInfo) -> bool:
        return self._vote(self.job_enqueueable_fns, "enabledJobEnqueued", job)

    def job_enqueued(self, job: JobInfo) -> None:
        for fn in self._enabled_fns(self.job_enqueued_fns, "enabledJobEnqueued"):
            fn(job)

    def job_starving(self, job: JobInfo) -> bool:
        found = False
        for tier in self.tiers:
            for opt in tier.plugins:
                if not opt.is_enabled("enabledJobStarving"):
                    continue
                fn = self.job_starving_fns.get(opt.name)
                if fn is None:
                    continue
                found = True
                if not fn(job):
                    return False
            if found:
                return True
        return False

    def job_valid(self, job: JobInfo) -> Optional[ValidateResult]:
        for fn in self._enabled_fns(self.job_valid_fns, None):
            vr = fn(job)
            if vr is not None and not vr.passed:
                return vr
        return None

    # -- state mutation (session.go:224-397) --------------------------------

    def _fire_allocate(self, task: TaskInfo) -> None:
        for eh in self.event_handlers:
            if eh.allocate_func:
                eh.allocate_func(Event(task))

    def _fire_deallocate(self, task: TaskInfo) -> None:
        for eh in self.event_handlers:
            if eh.deallocate_func:
                eh.deallocate_func(Event(task))

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        job = self.jobs[task.job]
        job.update_task_status(task, TaskStatus.PIPELINED)
        task.node_name = hostname
        self.nodes[hostname].add_task(task)
        self._fire_allocate(task)

    def allocate(self, task: TaskInfo, node: NodeInfo) -> None:
        """Direct allocation (used by backfill): statusify, occupy node,
        fire events, and dispatch the bind immediately if the gang is ready
        (session.go:267-358)."""
        job = self.jobs[task.job]
        job.update_task_status(task, TaskStatus.ALLOCATED)
        task.node_name = node.name
        self.nodes[node.name].add_task(task)
        self._fire_allocate(task)
        if self.job_ready(job):
            self.dispatch(task)

    def _audit_event(self, kind: str, task: TaskInfo,
                     extra: str = "") -> None:
        """Feed the decision audit (obs.audit) — a no-op unless the audit
        ring is enabled."""
        if AUDIT.enabled:
            self.audit_events.append((kind, task.uid, task.job, extra))

    def dispatch(self, task: TaskInfo) -> None:
        self.jobs[task.job].update_task_status(task, TaskStatus.BINDING)
        self._audit_event("bind", task, task.node_name)
        self.cache.bind(task)

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        """Direct eviction (used by reclaim): session state + cache side
        effect (session.go:360-397)."""
        job = self.jobs[reclaimee.job]
        job.update_task_status(reclaimee, TaskStatus.RELEASING)
        node = self.nodes[reclaimee.node_name]
        node.update_task(job.tasks[reclaimee.uid])
        self._fire_deallocate(reclaimee)
        self._audit_event("evict", reclaimee, reason)
        self.cache.evict(reclaimee, reason)

    def bind_pod_group(self, job: JobInfo, cluster: str) -> None:
        """Forward a gang to a silo cluster (session.go:399-402 ->
        cache.BindPodGroup, the multi-cluster path)."""
        self.cache.bind_pod_group(job, cluster)

    def update_scheduler_numa_info(self, numa_sets) -> None:
        """session.go:435-437 — forward the numa-aware plugin's cpuset
        assignments to the cache."""
        update = getattr(self.cache, "update_scheduler_numa_info", None)
        if update is not None:
            update(numa_sets)

    def update_pod_group_condition(self, job: JobInfo, condition: dict) -> None:
        """Replace the same-type condition (one entry per type, like
        PodGroup status conditions on the CR); mark dirty only on a real
        transition so the close-time writeback can dedup."""
        conditions = job.podgroup.conditions
        for i, existing in enumerate(conditions):
            if existing.get("type") == condition.get("type"):
                changed = any(existing.get(k) != condition.get(k)
                              for k in ("status", "reason", "message"))
                conditions[i] = condition
                if changed:
                    job.podgroup.conditions_dirty = True
                return
        conditions.append(condition)
        job.podgroup.conditions_dirty = True

    def statement(self) -> Statement:
        return Statement(self)

    # -- persistent node tensors --------------------------------------------

    def snapshot_node_tensors(self, rnames):
        """The cache's persistent node tensors for this session's snapshot
        on the session's device (cache.tensor_refresh), or None. They mirror
        snapshot-time values, so they are valid only while no session
        mutation has touched node state: after the first statement replays
        (the ``_touched`` witness every NodeInfo mutation sets), mid-cycle
        consumers such as the stateful re-solve rounds marshal from the
        live session objects instead. None also when the kill switch is off
        or the epoch moved; the caller then builds a fresh NodeTensors.

        The refresh runs device ops, so a fault the card reports can
        surface here and not only in the solve. A classified device fault
        (``device_health.classify_device_fault``: an OOM, a CUDA error)
        opens the cool-down, drops the cache's device state and returns
        None, so the caller builds fresh on the same device, as the JAX
        package does. No CPU placement comes of it: the solve still runs
        on the card, and on a dead context the fresh build's own CUDA
        error fails the allocate action (``_with_fallback``). Any
        other error propagates (the cache drops its persistent tensors
        first, so a refresh applies in full or not at all): the JAX
        package catches every exception here and rebuilds, which would
        hide a broken refresh behind a fresh build every cycle."""
        if self.speculative:
            if self.spec_basis is None:
                return None
        if any(node._touched for node in self.nodes.values()):
            return None
        try:
            if self.speculative:
                # the staged refresh consumes nothing and pins its epoch,
                # held here for the shell to retire at commit or discard
                view = self.cache.tensor_refresh_speculative(
                    self.nodes, rnames, self.device, self.spec_basis)
                if view is not None:
                    self._pinned_epoch = view
                return view
            return self.cache.tensor_refresh(self.nodes, rnames,
                                             self.device, self.snap_epoch)
        except Exception as exc:
            from ..device_health import DEVICE_HEALTH, classify_device_fault
            kind = classify_device_fault(exc)
            if kind is None:
                raise
            DEVICE_HEALTH.record_fault(kind)
            self.cache.invalidate_device_state()
            log.error("device fault (%s) during persistent tensor refresh; "
                      "cooling down, rebuilding from host truth", kind)
            return None
