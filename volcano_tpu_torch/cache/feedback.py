"""FeedbackChannel: the normalizing funnel for cluster→cache acks.

Every kubelet/status ack — the RUNNING flip confirming a bind, the
delete-and-recreate confirming an eviction — enters the cache through
here, because the
feedback plane is HOSTILE (docs/robustness.md, feedback failure model):
acks arrive late, twice, out of order, or for placements that have since
died. The channel classifies each ack against the cache's CURRENT intent
before applying anything:

- ``applied``   — the ack matches the live intent (a BOUND task on that
                  node flips RUNNING; a RELEASING task requeues);
- ``duplicate`` — the ack's effect already happened (RUNNING already /
                  requeue already applied); re-applying is idempotent
                  for evictions and a no-op for binds;
- ``stale``     — the ack belongs to a superseded intent (a RUNNING ack
                  for a since-evicted or re-placed task must NOT
                  resurrect the dead placement; an evict ack for a task
                  a newer bind owns must not strip it);
- ``unknown``   — the task left the cache (gang completed); moot.

Applied acks also resolve the in-flight ledger (cache/inflight.py), so
ledger state and cache state settle together. The ledger's watchdog
feeds recovered acks back through this same normalizer
(``source="watchdog"``) — repair is never a raw mutation.

Store-wired deployments route the pod-status watch events here
(``pod_status_event``); with a seeded ``chaos.AckFaultInjector`` attached,
RUNNING acks on the watch path are also delayed, dropped or duplicated on
the injectable clock — the store-wired ack chaos, composing with the torn
watch streams.
"""

from __future__ import annotations

import heapq
import itertools
import logging
from typing import Callable, Dict, List, Optional, Tuple

from ..api import TaskStatus
from ..obs.lifecycle import TIMELINE
from ..obs.trace import TRACE as OBS_TRACE

log = logging.getLogger(__name__)


class FeedbackChannel:
    def __init__(self, cache):
        self.cache = cache
        # watch-path ack chaos (store-wired rigs): seeded per-ack faults
        # and a delayed-delivery heap on the injectable clock
        # (attach_injector)
        self.injector = None
        self.time_fn: Optional[Callable[[], float]] = None
        self._pending: List[Tuple[float, int, str, str, str]] = []
        self._seq = itertools.count()
        # watchdog-recovered evict acks hand the requeue to the harness
        # (the sim's controller-recreate analogue) when a hook is set;
        # cache-local state is already settled either way
        self.on_watchdog_evict: Optional[Callable[[str, str], None]] = None
        # (kind, verdict) -> count; deterministic (seeded chaos only)
        self.counts: Dict[Tuple[str, str], int] = {}

    def _count(self, kind: str, verdict: str) -> None:
        from .. import metrics
        with self.cache._lock:
            key = (kind, verdict)
            self.counts[key] = self.counts.get(key, 0) + 1
        metrics.register_feedback_ack(kind, verdict)

    # -- the normalizer -----------------------------------------------------

    def ack_running(self, jid: str, uid: str, node: Optional[str] = None,
                    source: str = "cluster",
                    ctx: Optional[dict] = None) -> str:
        """Consume one kubelet RUNNING ack for (task, node). ``node=None``
        skips the placement check (the HA convergence sweep, which swept
        cluster-confirmed binds before this funnel existed). An optional
        ``ctx`` (a correlation stamp carried by a replayed verdict) is
        ingested exactly-once instead of minting a fresh one. Returns the
        verdict."""
        cache = self.cache
        with cache._lock:
            job = cache.jobs.get(jid)
            cached = job.tasks.get(uid) if job is not None else None
            if cached is None:
                verdict = "unknown"
            elif node is not None and cached.node_name != node:
                # the placement this ack confirms is dead — the task was
                # evicted/requeued and possibly re-placed elsewhere; a
                # duplicate/late RUNNING ack must not resurrect it
                verdict = "stale"
            elif cached.status == TaskStatus.BOUND:
                verdict = "applied"
            elif cached.status == TaskStatus.RUNNING:
                verdict = "duplicate"
            else:
                verdict = "stale"
            if verdict == "applied":
                # resolve BEFORE the flip: update_task_status carries a
                # belt-and-braces resolve whose default "acked" label
                # would otherwise swallow the watchdog's "repaired"
                cache.inflight.resolve(
                    "bind", uid,
                    "acked" if source == "cluster" else "repaired")
                cache.update_task_status(cached, TaskStatus.RUNNING)
                cache.binding_tasks.pop(uid, None)
        if verdict == "applied":
            # lifecycle witness: the applied verdict is the RUNNING
            # milestone of the job's timeline, stamped with the owning
            # cache's partition, deduped on a carried ctx
            if ctx is None:
                ctx = TIMELINE.stamp(part=getattr(cache, "obs_part", None))
            TIMELINE.record(jid, "running", ctx=ctx,
                            node=node or None, source=source, task=uid)
            OBS_TRACE.flow_step("running_ack", f"job:{jid}", task=uid)
        if source != "converge" or verdict == "applied":
            # the HA convergence sweep probes every live bind each cycle;
            # only its applies are acks — the probes are sweep noise
            self._count("running", verdict)
        return verdict

    def ack_evicted(self, jid: str, uid: str,
                    source: str = "cluster",
                    ctx: Optional[dict] = None) -> str:
        """Consume one eviction confirmation (pod delete + controller
        recreate, collapsed): a RELEASING task requeues PENDING; a
        PENDING-unplaced task means the requeue already happened (a
        replayed confirmation — ``duplicate``, a no-op); anything else
        is a superseded intent's ack and is dropped. An optional ``ctx``
        dedupes like ``ack_running``'s. Returns the verdict."""
        cache = self.cache
        with cache._lock:
            job = cache.jobs.get(jid)
            cached = job.tasks.get(uid) if job is not None else None
            if cached is None:
                verdict = "unknown"
            elif cached.status == TaskStatus.RELEASING:
                verdict = "applied"
            elif cached.status == TaskStatus.PENDING \
                    and not cached.node_name:
                # the requeue already happened (a replayed confirmation,
                # or the watchdog repaired the drop first): a no-op
                verdict = "duplicate"
            else:
                # a newer bind owns the task (BOUND/RUNNING): the evict
                # ack is for a dead intent — settling to the LATER intent
                # is exactly the reorder contract
                verdict = "stale"
            if verdict == "applied":
                if cached.node_name:
                    cache.mark_node_dirty(cached.node_name)
                cache.mark_job_dirty(jid)
                node = cache.nodes.get(cached.node_name)
                if node is not None and uid in node.tasks:
                    node.remove_task(cached)
                cached.node_name = ""
                job.update_task_status(cached, TaskStatus.PENDING)
                cache.binding_tasks.pop(uid, None)
        if verdict == "applied":
            cache.inflight.resolve(
                "evict", uid, "acked" if source == "cluster" else "repaired")
            # lifecycle witness: the applied eviction IS the
            # evicted-and-requeued milestone of the timeline
            if ctx is None:
                ctx = TIMELINE.stamp(part=getattr(cache, "obs_part", None))
            TIMELINE.record(jid, "evicted", ctx=ctx, source=source,
                            task=uid)
            if source == "watchdog" and self.on_watchdog_evict is not None:
                self.on_watchdog_evict(jid, uid)
        self._count("evicted", verdict)
        return verdict

    # -- the watch path (store-wired deployments) ---------------------------

    def pod_status_event(self, cached, status: TaskStatus) -> None:
        """Route a pod-status watch event: RUNNING flips are kubelet acks
        and go through the normalizer (fault-injected when an injector is
        attached); every other transition is watch truth and applies
        directly."""
        if status != TaskStatus.RUNNING:
            self.cache.update_task_status(cached, status)
            return
        jid, uid, node = cached.job, cached.uid, cached.node_name
        fault = self.injector.roll("running") \
            if self.injector is not None else None
        if fault == "drop":
            return                       # the watchdog recovers it
        if fault in ("delay", "reorder"):
            self._push(self.injector.delay_s, jid, uid, node)
            return
        if fault == "duplicate":
            self._push(self.injector.delay_s, jid, uid, node)
        elif fault == "stale":
            self._push(self.injector.stale_delay_s, jid, uid, node)
        self.ack_running(jid, uid, node)

    def attach_injector(self, injector, time_fn) -> None:
        """Arm seeded watch-path ack chaos (store-wired rigs): ``roll``ed
        per RUNNING ack; delayed deliveries drain on ``deliver_due``
        (driven by the scheduler epilogue's watchdog step)."""
        self.injector = injector
        self.time_fn = time_fn

    def _push(self, delay_s: float, jid: str, uid: str, node: str) -> None:
        now = self.time_fn() if self.time_fn is not None else 0.0
        heapq.heappush(self._pending,
                       (now + delay_s, next(self._seq), jid, uid, node))

    def deliver_due(self, now: Optional[float] = None) -> int:
        """Apply delayed watch-path acks whose due time passed."""
        if not self._pending:
            return 0
        if now is None:
            now = self.time_fn() if self.time_fn is not None else 0.0
        n = 0
        while self._pending and self._pending[0][0] <= now + 1e-9:
            _, _, jid, uid, node = heapq.heappop(self._pending)
            self.ack_running(jid, uid, node)
            n += 1
        return n

    def pending(self) -> int:
        return len(self._pending)
