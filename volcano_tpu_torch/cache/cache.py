"""SchedulerCache: the live cluster model the scheduler snapshots each cycle
(mirrors pkg/scheduler/cache/cache.go:75-893).

Holds nodes, queues and jobs; clones them into a per-cycle ClusterInfo;
and executes bind/evict side effects through swappable executors. A
failed side effect rolls the optimistic cache state back and goes to a
rate-limited resync queue (the reference's errTasks, cache.go:777-799);
one that exhausts its retry budget parks in a bounded dead-letter set.
Every side effect is journaled before its executor runs (cache/journal.py)
and armed in the in-flight ledger until the cluster acks it
(cache/inflight.py, cache/feedback.py).

The snapshot is clone-on-dirty (the JAX package's default,
``volcano_tpu/cache/cache.py``): every mutator records the node, job or
queue keys it touched, and a snapshot re-clones only those (and what a
session mutated, by the ``_touched`` witness on NodeInfo and JobInfo),
sharing the rest with the previous snapshot. The cache also keeps the
persistent node tensors the allocate solves read
(``snapshot.PersistentNodeTensors``, refreshed from the dirty rows), and a
shadow verifier that re-derives both from scratch and repairs drift.
``VOLCANO_TPU_INCREMENTAL_SNAPSHOT=0`` turns both off: a full clone every
cycle and a fresh NodeTensors every solve.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..api import (ClusterInfo, JobInfo, NamespaceCollection,
                   NamespaceInfo, NodeInfo, QueueInfo, Resource, TaskInfo,
                   TaskStatus, allocated_status)
from ..obs.lifecycle import TIMELINE
from ..obs.trace import TRACE as OBS_TRACE
from .executors import (Binder, Evictor, FakeBinder, FakeEvictor,
                        StatusUpdater, VolumeBinder)
from .feedback import FeedbackChannel
from .inflight import InflightLedger
from .journal import IntentJournal, journal_enabled

log = logging.getLogger(__name__)


def incremental_snapshot_enabled() -> bool:
    """The kill switch of the incremental snapshot and the persistent node
    tensors. On by default; VOLCANO_TPU_INCREMENTAL_SNAPSHOT=0 forces a
    full clone every cycle and a fresh NodeTensors every solve."""
    return os.environ.get("VOLCANO_TPU_INCREMENTAL_SNAPSHOT", "1") \
        .lower() not in ("0", "false", "off")


class RateLimitedQueue:
    """workqueue.RateLimitingInterface analogue (the errTasks queue,
    cache.go:115,777-799): per-item exponential backoff — the k8s
    ItemExponentialFailureRateLimiter (base * 2^failures, capped) — plus a
    per-item retry budget: once an item has failed ``max_retries`` times,
    add_rate_limited refuses it (returns False) so a permanently failing
    side effect cannot spin in the queue forever. The caller dead-letters
    refused items (SchedulerCache.dead_letter)."""

    def __init__(self, base_delay: float = 0.005, max_delay: float = 10.0,
                 max_retries: Optional[int] = None,
                 time_fn=time.monotonic):
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.max_retries = max_retries
        # injectable time source: the sim pins this to its virtual clock
        # so retry backoff expires on deterministic virtual cycles
        self.time_fn = time_fn
        self._heap: List[Tuple[float, int, str, object]] = []
        self._failures: Dict[str, int] = {}
        self._seq = itertools.count()
        self._lock = threading.Lock()

    def add_rate_limited(self, key: str, item: object) -> bool:
        with self._lock:
            n = self._failures.get(key, 0)
            if self.max_retries is not None and n >= self.max_retries:
                # keep the failure count: a later add for the same key is
                # refused again instead of restarting a full retry burst —
                # only forget() (redrive) grants a fresh budget
                return False
            self._failures[key] = n + 1
            delay = min(self.base_delay * (2 ** n), self.max_delay)
            heapq.heappush(self._heap,
                           (self.time_fn() + delay, next(self._seq), key,
                            item))
            return True

    def failures(self, key: str) -> int:
        with self._lock:
            return self._failures.get(key, 0)

    def forget(self, key: str) -> None:
        with self._lock:
            self._failures.pop(key, None)

    def pop_ready(self, max_items: Optional[int] = None
                  ) -> List[Tuple[str, object]]:
        """Items whose backoff expired, oldest-deadline first.
        ``max_items`` bounds the per-call work: items past the cap stay
        queued, already ready, and drain on the next call."""
        now = self.time_fn()
        out = []
        with self._lock:
            while self._heap and self._heap[0][0] <= now:
                if max_items is not None and len(out) >= max_items:
                    break
                _, _, key, item = heapq.heappop(self._heap)
                out.append((key, item))
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)


# A bind/evict that fails this many RETRIES (after the initial attempt)
# dead-letters instead of re-queueing — with the default 5ms base delay
# the budget spans ~20s of exponential backoff.
DEFAULT_RESYNC_MAX_RETRIES = 12


def _dead_letter_max() -> int:
    """Cap on the dead-letter set: past it the OLDEST entry is evicted and
    counted (redrive can no longer recover it). <=0 disables the cap."""
    try:
        return int(os.environ.get("VOLCANO_TPU_DEAD_LETTER_MAX", 4096))
    except ValueError:
        return 4096


class SchedulerCache:
    def __init__(self, binder: Optional[Binder] = None,
                 evictor: Optional[Evictor] = None,
                 status_updater: Optional[StatusUpdater] = None,
                 default_queue: Optional[str] = "default",
                 resync_max_retries: Optional[int]
                 = DEFAULT_RESYNC_MAX_RETRIES,
                 journal: Optional[IntentJournal] = None,
                 time_fn=time.time,
                 volume_binder: Optional[VolumeBinder] = None):
        self._lock = threading.RLock()
        # injectable wall-clock source: stamps schedule_start_timestamp on
        # ingested jobs; the sim pins it to its virtual clock
        self.time_fn = time_fn
        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}
        self.namespace_collections: Dict[str, NamespaceCollection] = {}
        self.binder = binder or FakeBinder()
        self.evictor = evictor or FakeEvictor()
        self.status_updater = status_updater or StatusUpdater()
        self.volume_binder = volume_binder or VolumeBinder()
        self.default_queue = default_queue
        if default_queue:
            self.queues[default_queue] = QueueInfo(name=default_queue)
        self.err_tasks: List[TaskInfo] = []       # failure record (tests)
        self.resync_queue = RateLimitedQueue(     # errTasks (cache.go:777-799)
            max_retries=resync_max_retries)
        # side effects that exhausted their retry budget, key -> (op, task);
        # insertion-ordered so the cap evicts the oldest
        self.dead_letter: Dict[str, Tuple[str, TaskInfo]] = {}
        self.dead_letter_max = _dead_letter_max()
        self.dead_letter_evicted = 0
        # write-ahead intent journal; VOLCANO_TPU_JOURNAL=0 detaches it
        self.journal = journal if (journal is not None
                                   and journal_enabled()) else None
        self.last_reconcile: Optional[dict] = None
        # the issuing leadership's fencing epoch, stamped on every intent:
        # the shell points this at its elector's epoch
        # (Scheduler.attach_elector), and the fenced executor gates reject
        # stale-epoch operations. Standalone schedulers stamp 0
        self.fencing_epoch_fn: Callable[[], int] = lambda: 0
        # task uid -> node of binds in flight asynchronously; the snapshot
        # skips their nodes (cache.go:822-827). Binds are synchronous here,
        # so only recovery paths touch it.
        self.binding_tasks: Dict[str, str] = {}
        # the feedback plane: every executor-accepted bind/evict arms an
        # ack deadline in the in-flight ledger; the FeedbackChannel is the
        # one funnel cluster acks enter the cache through, and the
        # scheduler epilogue's watchdog (process_expired_inflight)
        # re-validates expired entries
        self.inflight = InflightLedger()
        self.feedback = FeedbackChannel(self)
        # cluster-truth probe for the watchdog: entry -> True / False /
        # None (unknown, presumed executed)
        self.inflight_oracle_fn: Optional[Callable] = None
        # a store-fed cache's resumable informers (cache/watches.py),
        # stepped by the scheduler epilogue; None in direct mode
        self.watch_manager = None
        # Incremental snapshot state: every mutator records the node, job
        # and queue keys it touched; snapshot() re-clones only those and
        # shares the rest with the previous snapshot. _dirty_all forces a
        # full rebuild (initial state, bulk external mutation, drift
        # repair, the kill switch).
        self._dirty_nodes: Set[str] = set()
        self._dirty_jobs: Set[str] = set()
        self._dirty_queues: Set[str] = set()
        self._dirty_all = True
        self._snap_nodes: Dict[str, NodeInfo] = {}
        self._snap_jobs: Dict[str, JobInfo] = {}
        self._snap_queues: Dict[str, QueueInfo] = {}
        self._snap_epoch = 0
        # node names whose snapshot row changed since the persistent
        # tensors last refreshed (snapshot.PersistentNodeTensors)
        self._tensor_dirty: Set[str] = set()
        self.tensor_cache = None
        # federation: a per-partition snapshot scope, ClusterInfo ->
        # ClusterInfo (PartitionMap.scope), applied AFTER the clone-on-dirty
        # build, so the clone maps and dirty sets stay whole-cluster while
        # the session sees only this partition's queues, jobs and node
        # shard. None: unscoped
        self.snapshot_scope: Optional[Callable] = None
        # host-clock breakdown and dirty ratio of the last snapshot()
        self.last_snapshot_stats: Dict[str, object] = {}
        # the pipelined cycle's outstanding speculative basis:
        # speculative_snapshot MOVES the dirty sets into it, so mutations
        # after the stage land in empty sets and the commit boundary's
        # delta is exact (a re-mutation of a key already dirty at stage
        # time included). The moved keys live here until adopt consumes
        # them, discard gives them back, or a real snapshot reabsorbs them.
        self._spec_dirt: Optional[dict] = None
        # the fast-admit arrival feed: with it on, add_job records each
        # arrival so Scheduler.fast_admit scans only what arrived since
        # its last drain. Off by default: an unconsumed feed would grow.
        self.fast_admit_feed = False
        self._new_job_uids: Set[str] = set()
        # lifecycle-timeline attribution (obs/lifecycle.py): the partition
        # id this cache's funnel events are stamped with, 0 for a single
        # scheduler. Observability only: nothing decision-plane reads it.
        self.obs_part = 0
        # federation: the partition this cache schedules for, set when the
        # control plane is built. Every journal intent carries it, and the
        # journal's reconcile leaves another partition's crash window to
        # that partition. None: a single scheduler
        self.partition: Optional[int] = None

    # -- intent journal (cache/journal.py) ----------------------------------

    def attach_journal(self, journal: Optional[IntentJournal]) -> None:
        """Swap the write-ahead journal in (or out with None); honours the
        VOLCANO_TPU_JOURNAL switch as the constructor does."""
        self.journal = journal if (journal is not None
                                   and journal_enabled()) else None

    def fencing_epoch(self) -> int:
        return self.fencing_epoch_fn()

    def _journal_intent(self, op: str, task: TaskInfo, node: str = "",
                        via: str = "", sync: bool = True,
                        fresh: bool = True) -> Optional[int]:
        """Record a side-effect intent, stamped with the fencing epoch.
        ``sync=True`` makes it durable before the caller runs the
        executor; batch funnels journal every intent first and flush once.
        ``fresh`` marks a NEW placement (vs a re-bind of a placed task),
        which decides whether a crash-window rollback may strip it."""
        epoch = self.fencing_epoch()
        # lifecycle stamp (obs/lifecycle.py): the intent's correlation ctx
        # both records the timeline event HERE and rides inside the
        # durable record, so a restart continues the same timeline
        # exactly-once (dedupe on the ctx's part+eid)
        ctx = TIMELINE.stamp(part=self.obs_part, epoch=epoch)
        if ctx is not None:
            TIMELINE.record(task.job, f"{op}_intent", ctx=ctx,
                            node=node or task.node_name or None,
                            via=via or None)
        if op == "bind":
            OBS_TRACE.flow_step("bind_intent", f"job:{task.job}",
                                task=task.uid)
        if self.journal is None:
            return None
        seq = self.journal.record_intent(op, task, node, via, fresh,
                                         epoch=epoch, ctx=ctx,
                                         part=self.partition)
        if sync:
            self.journal.flush()
        return seq

    def _journal_ack(self, seq: Optional[int], ok: bool) -> None:
        if seq is not None and self.journal is not None:
            self.journal.ack(seq, ok)

    def _register_inflight(self, op: str, task: TaskInfo, node: str = "",
                           seq: Optional[int] = None) -> None:
        """Arm the in-flight ledger's ack deadline for an intent about to
        execute; an executor failure aborts the entry, the cluster's ack
        (or the watchdog) resolves it otherwise."""
        self.inflight.register(op, task.uid, task.job,
                               node or task.node_name or "", seq)

    def reconcile_journal(self, cluster_binds=None, cluster_evicts=None):
        """Startup reconciliation: settle the journal's crash window
        against cache truth (journal.reconcile). None without a journal."""
        if self.journal is None:
            return None
        from .journal import reconcile
        return reconcile(self, self.journal, cluster_binds, cluster_evicts)

    # -- dirty marks (incremental snapshot) ---------------------------------

    def mark_node_dirty(self, name: str) -> None:
        """``name``'s live state changed outside the cache's own mutators
        (a drain, a test's direct mutation): the next snapshot re-clones
        it instead of reusing the cached clone."""
        self._dirty_nodes.add(name)

    def mark_job_dirty(self, uid: str) -> None:
        self._dirty_jobs.add(uid)

    def mark_queue_dirty(self, uid: str) -> None:
        self._dirty_queues.add(uid)

    def mark_all_dirty(self) -> None:
        """Invalidate every cached clone (bulk external mutation)."""
        self._dirty_all = True

    def _mark_task_dirty(self, task: TaskInfo) -> None:
        """One task moved: its job's gang state and (when placed) its
        node's accounting changed. Caller holds self._lock."""
        if task.job:
            self._dirty_jobs.add(task.job)
        if task.node_name:
            self._dirty_nodes.add(task.node_name)

    # -- ingestion (event_handlers.go analogues) ----------------------------

    def add_node(self, node: NodeInfo) -> None:
        with self._lock:
            self.nodes[node.name] = node
            self._dirty_nodes.add(node.name)

    def remove_node(self, name: str) -> None:
        with self._lock:
            self.nodes.pop(name, None)
            self._dirty_nodes.add(name)

    def add_queue(self, queue: QueueInfo) -> None:
        with self._lock:
            self.queues[queue.uid] = queue
            self._dirty_queues.add(queue.uid)

    def remove_queue(self, uid: str) -> None:
        with self._lock:
            self.queues.pop(uid, None)
            self._dirty_queues.add(uid)

    def add_job(self, job: JobInfo) -> None:
        with self._lock:
            if job.schedule_start_timestamp is None:
                job.schedule_start_timestamp = self.time_fn()
            self.jobs[job.uid] = job
            self._dirty_jobs.add(job.uid)
            if self.fast_admit_feed:
                self._new_job_uids.add(job.uid)

    def drain_new_jobs(self) -> List[str]:
        """Consume the fast-admit arrival feed, sorted; empty unless
        ``fast_admit_feed`` is on."""
        with self._lock:
            uids = sorted(self._new_job_uids)
            self._new_job_uids.clear()
        return uids

    def remove_job(self, uid: str) -> None:
        with self._lock:
            job = self.jobs.pop(uid, None)
            self._dirty_jobs.add(uid)
            if job is not None:
                for task_uid in job.tasks:
                    self._drop_retry_state(task_uid)
                    self.inflight.task_deleted(task_uid)
                    self.binding_tasks.pop(task_uid, None)
                # a parked podgroup-status flush for a removed job is moot
                key = f"pg_status/{uid}"
                if self.dead_letter.pop(key, None) is not None:
                    from .. import metrics
                    metrics.set_dead_letter_size(len(self.dead_letter))
                self.resync_queue.forget(key)

    def get_or_create_job(self, uid: str, **kwargs) -> JobInfo:
        with self._lock:
            if uid not in self.jobs:
                self.jobs[uid] = JobInfo(uid=uid, **kwargs)
                self._dirty_jobs.add(uid)
            return self.jobs[uid]

    def add_task(self, task: TaskInfo) -> None:
        """Pod added: index into its job and, if placed, its node
        (event_handlers.go addTask)."""
        with self._lock:
            job = self.get_or_create_job(task.job)
            job.add_task_info(task)
            if task.node_name and task.node_name in self.nodes:
                self.nodes[task.node_name].add_task(task)
            self._mark_task_dirty(task)

    def update_task_status(self, task: TaskInfo, status: TaskStatus) -> None:
        with self._lock:
            job = self.jobs.get(task.job)
            if job is None:
                return
            job.update_task_status(job.tasks[task.uid], status)
            if task.node_name and task.node_name in self.nodes:
                self.nodes[task.node_name].update_task(job.tasks[task.uid])
            self._mark_task_dirty(task)
        if status == TaskStatus.RUNNING:
            # however the RUNNING confirmation reached the cache, the bind
            # is no longer in flight
            self.inflight.resolve("bind", task.uid)

    def delete_task(self, task: TaskInfo) -> None:
        with self._lock:
            # mark BEFORE mutating: node.remove_task clears task.node_name
            self._mark_task_dirty(task)
            job = self.jobs.get(task.job)
            if job is not None:
                job.delete_task_info(task)
            if task.node_name and task.node_name in self.nodes:
                self.nodes[task.node_name].remove_task(task)
            self._drop_retry_state(task.uid)
            self.binding_tasks.pop(task.uid, None)
        # the pod left the cluster: a pending evict entry is thereby
        # CONFIRMED, a pending bind entry is moot (cache/inflight.py)
        self.inflight.task_deleted(task.uid)

    # -- snapshot (cache.go:801-893) ----------------------------------------

    def add_resource_quota(self, quota) -> None:
        """AddResourceQuota (event_handlers.go:740-770): the
        ``volcano.sh/namespace.weight`` key of ``spec.hard``, by quota, in
        its namespace's collection; the snapshot's NamespaceInfo takes the
        largest."""
        ns = quota.metadata.namespace
        col = self.namespace_collections.setdefault(
            ns, NamespaceCollection(ns))
        weight = int(quota.hard.get(NamespaceCollection.WEIGHT_KEY, 0))
        col.update(quota.metadata.name, weight)

    def delete_resource_quota(self, quota) -> None:
        """DeleteResourceQuota (event_handlers.go:790-812)."""
        col = self.namespace_collections.get(quota.metadata.namespace)
        if col is not None:
            col.delete(quota.metadata.name)

    def snapshot(self) -> ClusterInfo:
        """Clone-on-dirty snapshot of ready nodes, queues and jobs: a node
        or job whose key no mutator marked since the previous snapshot, and
        whose previous clone no session mutated (the ``_touched`` witness),
        is SHARED with the previous snapshot instead of cloned again. The
        shared clone equals what a fresh ``clone()`` would give, by the
        witness. Nodes with binds in flight are skipped (cache.go:822-827).
        A full clone of everything when VOLCANO_TPU_INCREMENTAL_SNAPSHOT=0
        or after mark_all_dirty()."""
        from ..obs import trace as obs_trace
        with obs_trace.span("snapshot_clone"):
            ci = self._snapshot_impl()
        if self.snapshot_scope is not None:
            ci = self.snapshot_scope(ci)
        return ci

    def _snapshot_impl(self, stage: bool = False):
        """One clone-on-dirty ClusterInfo. By default it consumes the
        bookkeeping: stores the clone maps, clears the dirty sets and bumps
        ``snap_epoch``. ``stage=True`` (speculative_snapshot) consumes
        nothing: it defers the witness resets and the tensor marks, moves
        the dirty sets into the returned basis and returns ``(ci,
        staged)``, what ``adopt_speculative_snapshot`` installs later.
        Either way an outstanding speculative basis is reabsorbed first."""
        t0 = time.perf_counter()
        touched_nodes: List[str] = []
        touched_jobs: List[str] = []
        tensor_rows: Set[str] = set()
        with self._lock:
            self._reabsorb_spec_dirt_locked()
            incremental = incremental_snapshot_enabled()
            full = self._dirty_all or not incremental
            ci = ClusterInfo()
            inflight_nodes = set(self.binding_tasks.values())
            reused_nodes = cloned_nodes = 0
            for name, node in self.nodes.items():
                if not node.ready or name in inflight_nodes:
                    continue
                prev = None if full else self._snap_nodes.get(name)
                if (prev is not None
                        and name not in self._dirty_nodes
                        and not prev._touched and not node._touched
                        and prev.unschedulable == node.unschedulable):
                    ci.nodes[name] = prev
                    reused_nodes += 1
                else:
                    ci.nodes[name] = node.clone()
                    if stage:
                        # reset at adopt time: a discarded speculation
                        # leaves the next real snapshot's re-clone
                        # decision as it was
                        touched_nodes.append(name)
                    else:
                        node._touched = False
                        self._tensor_dirty.add(name)
                    cloned_nodes += 1
                    tensor_rows.add(name)
            for uid, q in self.queues.items():
                prev = None if full else self._snap_queues.get(uid)
                if (prev is not None and uid not in self._dirty_queues
                        and prev.weight == q.weight
                        and prev.state == q.state
                        and prev.reclaimable == q.reclaimable
                        and prev.capability is q.capability):
                    ci.queues[uid] = prev
                else:
                    ci.queues[uid] = q.clone()
            reused_jobs = 0
            for uid, job in self.jobs.items():
                if job.podgroup is None:
                    continue
                prev = None if full else self._snap_jobs.get(uid)
                if (prev is not None
                        and uid not in self._dirty_jobs
                        and not prev._touched and not job._touched
                        and prev.podgroup is job.podgroup
                        and prev.priority == job.priority
                        and prev.min_available == job.min_available
                        and prev.queue == job.queue):
                    # per-cycle scratch a fresh clone would start without
                    if prev.nodes_fit_errors:
                        prev.nodes_fit_errors = {}
                    if prev.job_fit_errors:
                        prev.job_fit_errors = ""
                    ci.jobs[uid] = prev
                    reused_jobs += 1
                else:
                    ci.jobs[uid] = job.clone()
                    if stage:
                        touched_jobs.append(uid)
                    else:
                        job._touched = False
            for name, col in self.namespace_collections.items():
                ci.namespaces[name] = col.snapshot()
            for job in ci.jobs.values():
                ci.namespaces.setdefault(job.namespace,
                                         NamespaceInfo(job.namespace))
            n_nodes = len(ci.nodes)
            stats = {
                "full": full,
                "clone_s": time.perf_counter() - t0,
                "dirty_nodes": cloned_nodes,
                "reused_nodes": reused_nodes,
                "reused_jobs": reused_jobs,
                "dirty_ratio": (cloned_nodes / n_nodes) if n_nodes else 0.0,
            }
            if stage:
                # the clone maps and the epoch stay; the snapshot carries
                # the epoch it gets if adopted
                ci.snap_epoch = self._snap_epoch + 1
                staged = {
                    "epoch": self._snap_epoch,
                    "dirty_all": self._dirty_all,
                    "incremental": incremental,
                    "nodes": dict(ci.nodes),
                    "jobs": dict(ci.jobs),
                    "queues": dict(ci.queues),
                    "dirty_nodes": frozenset(self._dirty_nodes),
                    "dirty_jobs": frozenset(self._dirty_jobs),
                    "dirty_queues": frozenset(self._dirty_queues),
                    "touched_nodes": touched_nodes,
                    "touched_jobs": touched_jobs,
                    "tensor_rows": tensor_rows,
                    "stats": stats,
                }
                self._spec_dirt = staged
                self._dirty_nodes.clear()
                self._dirty_jobs.clear()
                self._dirty_queues.clear()
                return ci, staged
            if incremental:
                self._snap_nodes = dict(ci.nodes)
                self._snap_jobs = dict(ci.jobs)
                self._snap_queues = dict(ci.queues)
                self._dirty_all = False
            else:
                # keep nothing: a later re-enable must rebuild from scratch
                self._snap_nodes = {}
                self._snap_jobs = {}
                self._snap_queues = {}
                self._dirty_all = True
            self._dirty_nodes.clear()
            self._dirty_jobs.clear()
            self._dirty_queues.clear()
            self._snap_epoch += 1
            ci.snap_epoch = self._snap_epoch
            self.last_snapshot_stats = stats
        from .. import metrics
        metrics.update_snapshot_stats(stats["dirty_nodes"],
                                      stats["dirty_ratio"])
        if full:
            metrics.register_snapshot_full_rebuild("clone")
        return ci

    # -- the speculative snapshot (the pipelined cycle) ---------------------

    def speculative_snapshot(self):
        """The snapshot ``snapshot()`` would build now, for the pipelined
        shell's speculative session, consuming nothing: dirty sets (moved
        into the basis), clone maps, epoch and witnesses stay, so the next
        real snapshot is the same whether the speculation commits or is
        discarded. Returns ``(ci, staged)``."""
        from ..obs import trace as obs_trace
        with obs_trace.span("snapshot_clone", speculative=True):
            ci, staged = self._snapshot_impl(stage=True)
        if self.snapshot_scope is not None:
            ci = self.snapshot_scope(ci)
        return ci, staged

    def _reabsorb_spec_dirt_locked(self) -> None:
        """Merge an outstanding basis's moved dirty keys back into the live
        dirty sets (caller holds the lock): a snapshot built while a
        speculation is in flight, or after one was dropped, never reuses a
        stale clone."""
        sd = self._spec_dirt
        if sd is None:
            return
        self._spec_dirt = None
        self._dirty_nodes.update(sd["dirty_nodes"])
        self._dirty_jobs.update(sd["dirty_jobs"])
        self._dirty_queues.update(sd["dirty_queues"])

    def discard_speculative_snapshot(self, staged) -> None:
        """Give the basis's moved dirty keys back (a conflict, an abandoned
        speculation). A no-op if a real snapshot already reabsorbed them or
        a newer speculation staged since."""
        with self._lock:
            if self._spec_dirt is staged:
                self._reabsorb_spec_dirt_locked()

    def speculation_delta(self, staged) -> Dict[str, object]:
        """What mutated since ``staged`` was staged: the dirty keys marked
        since (re-mutations of keys dirty at stage time included), and
        whether the epoch moved (another snapshot ran, the device state was
        invalidated, or a mark_all_dirty such as a drift repair). The
        commit boundary's conflict check is a function of this."""
        with self._lock:
            stale = (self._spec_dirt is not staged
                     or self._dirty_all != staged["dirty_all"])
            return {
                "epoch_moved": stale or self._snap_epoch != staged["epoch"],
                "nodes": set(self._dirty_nodes),
                "jobs": set(self._dirty_jobs),
                "queues": set(self._dirty_queues),
            }

    def adopt_speculative_snapshot(self, staged) -> bool:
        """Make a staged snapshot THE snapshot, exactly what ``snapshot()``
        would have built had nothing mutated since the stage, which is the
        precondition: installs the clone maps, runs the deferred witness
        resets and tensor marks, consumes the moved dirt and bumps the
        epoch. Returns False, adopting nothing, on any mutation since."""
        with self._lock:
            if self._spec_dirt is not staged \
                    or self._snap_epoch != staged["epoch"] \
                    or self._dirty_all != staged["dirty_all"] \
                    or self._dirty_nodes or self._dirty_jobs \
                    or self._dirty_queues:
                return False
            self._spec_dirt = None
            if staged["incremental"]:
                self._snap_nodes = dict(staged["nodes"])
                self._snap_jobs = dict(staged["jobs"])
                self._snap_queues = dict(staged["queues"])
                self._dirty_all = False
            else:
                self._snap_nodes = {}
                self._snap_jobs = {}
                self._snap_queues = {}
                self._dirty_all = True
            for name in staged["touched_nodes"]:
                node = self.nodes.get(name)
                if node is not None:
                    node._touched = False
            for uid in staged["touched_jobs"]:
                job = self.jobs.get(uid)
                if job is not None:
                    job._touched = False
            self._tensor_dirty.update(staged["tensor_rows"])
            self._snap_epoch += 1
            stats = staged["stats"]
            self.last_snapshot_stats = stats
        from .. import metrics
        metrics.update_snapshot_stats(stats["dirty_nodes"],
                                      stats["dirty_ratio"])
        if stats["full"]:
            metrics.register_snapshot_full_rebuild("clone")
        return True

    # -- persistent node tensors --------------------------------------------

    def tensor_refresh(self, snapshot_nodes: Dict[str, NodeInfo], rnames,
                       device, snap_epoch: Optional[int] = None):
        """The persistent node tensors on ``device`` for the CURRENT
        snapshot: rewrites only the rows the dirty set named since the last
        refresh. ``snapshot_nodes`` must be the node dict the latest
        snapshot() returned, before any session mutation; ``snap_epoch``
        refuses a stale session's delta over a newer snapshot. Returns None
        when the incremental path is off (kill switch) or refused (epoch
        mismatch); callers then build a fresh NodeTensors. An error in the
        refresh, a device error in the scatter included, drops the
        persistent tensors and propagates: no rebuild in this cycle hides
        it, and the next refresh rebuilds every row."""
        if not incremental_snapshot_enabled():
            return None
        import torch
        from .snapshot import PersistentNodeTensors
        with self._lock:
            if snap_epoch is not None and snap_epoch != self._snap_epoch:
                return None
            tc = self.tensor_cache
            if (tc is None or tc.rnames.names != rnames.names
                    or tc.device != torch.device(device)):
                tc = PersistentNodeTensors(rnames, device)
                self.tensor_cache = tc
            dirty = self._tensor_dirty
            self._tensor_dirty = set()
            try:
                stats = tc.refresh(snapshot_nodes, dirty)
            except BaseException:
                # a refresh applies in full or not at all: rows half
                # written on the host and never scattered would be stale
                # on the device, so the next refresh rebuilds every row
                self.tensor_cache = None
                raise
        if stats["full"]:
            from .. import metrics
            metrics.register_snapshot_full_rebuild("tensor")
        return tc

    def tensor_refresh_speculative(self, snapshot_nodes: Dict[str, NodeInfo],
                                   rnames, device, staged):
        """The persistent node tensors for a SPECULATIVE snapshot: writes
        the union of the pending tensor-dirty rows and the staged clones'
        rows (a write of the same values the next real refresh writes
        again, since ``_tensor_dirty`` is deliberately not consumed), then
        pins the epoch, so the in-flight solve reads stable rows while the
        committing cycle's binds publish new ones. Returns the pinned
        ``TensorEpochView`` (release it with ``retire_epoch``), or None
        when the incremental path is off or the epoch moved. Like
        ``tensor_refresh``, a refresh error drops the tensors and
        propagates."""
        if not incremental_snapshot_enabled():
            return None
        import torch
        from .snapshot import PersistentNodeTensors
        with self._lock:
            if staged["epoch"] != self._snap_epoch:
                return None
            tc = self.tensor_cache
            if (tc is None or tc.rnames.names != rnames.names
                    or tc.device != torch.device(device)):
                tc = PersistentNodeTensors(rnames, device)
                self.tensor_cache = tc
            dirty = set(self._tensor_dirty) | set(staged["tensor_rows"])
            try:
                stats = tc.refresh(snapshot_nodes, dirty)
                view = tc.pin_epoch()
            except BaseException:
                self.tensor_cache = None
                raise
        if stats["full"]:
            from .. import metrics
            metrics.register_snapshot_full_rebuild("tensor")
        return view

    def invalidate_device_state(self) -> None:
        """Retire the device-resident state: bump the snapshot epoch (an
        open session's tensor_refresh then refuses its delta) and drop the
        persistent tensors, so the next device consumer rebuilds from host
        truth."""
        with self._lock:
            self._snap_epoch += 1
            self.tensor_cache = None
            self._tensor_dirty = set()

    # -- drift self-healing -------------------------------------------------

    def verify_state_integrity(self, repair: bool = True) -> dict:
        """Shadow verifier: re-derive what a from-scratch snapshot and
        tensor build would give and diff it against the incremental caches
        the NEXT cycle would reuse. A mismatch is state drift, a missed
        dirty mark or witness that clone-on-dirty would serve as a stale
        placement input; it is counted (``state_drift`` by layer) and, with
        ``repair``, repaired by the full-rebuild paths: mark_all_dirty()
        for the clone layer, dropping ``tensor_cache`` for the tensor
        layer. Entries the next snapshot re-clones anyway (dirty-marked,
        witnessed, or a guard field changed) are skipped. The scheduler
        shell runs it after the cycle's timed window, every
        ``drift_verify_every`` cycles. Ported as the JAX package writes it
        (``volcano_tpu/cache/cache.py``), including its tensor-row check,
        which compares each row with the previous snapshot's clone whether
        or not a session mutated that clone since (ROADMAP §3)."""
        t0 = time.perf_counter()
        drift = {"node": [], "job": [], "tensor": []}
        # phase 1 (lock): the candidate key/object pairs only
        with self._lock:
            node_cand = [] if self._dirty_all else [
                (name, prev, self.nodes.get(name))
                for name, prev in self._snap_nodes.items()]
            job_cand = [] if self._dirty_all else [
                (uid, prev, self.jobs.get(uid))
                for uid, prev in self._snap_jobs.items()]
            tc = self.tensor_cache
            tensor_cand = [] if tc is None else [
                (name, prev, tc.index.get(name))
                for name, prev in self._snap_nodes.items()]
            checked_nodes = len(self._snap_nodes)
            checked_jobs = len(self._snap_jobs)
        # phase 2 (no lock): the O(cluster) diff; an entry a concurrent
        # mutator races is skipped: that mutation dirty-marks it
        suspects = {"node": [], "job": [], "tensor": []}
        for name, prev, live in node_cand:
            try:
                if (live is not None and live.ready
                        and not prev._touched and not live._touched
                        and prev.unschedulable == live.unschedulable
                        and not self._node_matches(prev, live)):
                    suspects["node"].append(name)
            except Exception:
                continue
        for uid, prev, live in job_cand:
            try:
                if (live is not None and live.podgroup is not None
                        and not prev._touched and not live._touched
                        and prev.podgroup is live.podgroup
                        and prev.priority == live.priority
                        and prev.min_available == live.min_available
                        and prev.queue == live.queue
                        and not self._job_matches(prev, live)):
                    suspects["job"].append(uid)
            except Exception:
                continue
        rn = tc.rnames if tc is not None else None
        for name, prev, i in tensor_cand:
            try:
                if i is not None \
                        and not self._tensor_row_matches(tc, i, prev, rn):
                    suspects["tensor"].append(name)
            except Exception:
                continue
        # phase 3 (lock): confirm each suspect against the CURRENT skip
        # conditions, then repair
        with self._lock:
            if not self._dirty_all:
                for name in suspects["node"]:
                    live = self.nodes.get(name)
                    prev = self._snap_nodes.get(name)
                    if (prev is not None and live is not None and live.ready
                            and name not in self._dirty_nodes
                            and not prev._touched and not live._touched
                            and prev.unschedulable == live.unschedulable
                            and not self._node_matches(prev, live)):
                        drift["node"].append(name)
                for uid in suspects["job"]:
                    live = self.jobs.get(uid)
                    prev = self._snap_jobs.get(uid)
                    if (prev is not None and live is not None
                            and live.podgroup is not None
                            and uid not in self._dirty_jobs
                            and not prev._touched and not live._touched
                            and prev.podgroup is live.podgroup
                            and not self._job_matches(prev, live)):
                        drift["job"].append(uid)
            if self.tensor_cache is tc and tc is not None:
                for name in suspects["tensor"]:
                    i = tc.index.get(name)
                    prev = self._snap_nodes.get(name)
                    if (i is not None and prev is not None
                            and name not in self._tensor_dirty
                            and not self._tensor_row_matches(tc, i, prev,
                                                             rn)):
                        drift["tensor"].append(name)
            repaired = False
            if repair:
                if drift["node"] or drift["job"]:
                    self._dirty_all = True
                    repaired = True
                if drift["tensor"]:
                    self.tensor_cache = None
                    self._tensor_dirty = set()
                    repaired = True
            stats = {
                "drift": {k: sorted(v) for k, v in drift.items() if v},
                "drift_total": sum(len(v) for v in drift.values()),
                "repaired": repaired,
                "checked_nodes": checked_nodes,
                "checked_jobs": checked_jobs,
                "verify_s": time.perf_counter() - t0,
            }
        from .. import metrics
        for layer, names in drift.items():
            if names:
                metrics.register_state_drift(layer, len(names))
        metrics.set_drift_verify_stats(stats["drift_total"],
                                       stats["verify_s"])
        return stats

    @staticmethod
    def _node_matches(prev: NodeInfo, live: NodeInfo) -> bool:
        """Would reusing ``prev`` equal a fresh ``live.clone()``?"""
        if (prev.allocatable is not live.allocatable
                or prev.used_ports != live.used_ports):
            return False
        for field in ("idle", "used", "releasing", "pipelined"):
            if getattr(prev, field) != getattr(live, field):
                return False
        return ({u: (t.status, t.node_name) for u, t in prev.tasks.items()}
                == {u: (t.status, t.node_name)
                    for u, t in live.tasks.items()})

    @staticmethod
    def _job_matches(prev: JobInfo, live: JobInfo) -> bool:
        if prev.allocated != live.allocated:
            return False
        return ({u: t.status for u, t in prev.tasks.items()}
                == {u: t.status for u, t in live.tasks.items()})

    @staticmethod
    def _tensor_row_matches(tc, i: int, node: NodeInfo, rnames) -> bool:
        """Host row ``i`` of the persistent tensors against what a fresh
        build would derive from ``node`` today."""
        import numpy as np
        from .snapshot import BIG_MAX_TASKS, RES_FIELDS, zone_code
        for field in RES_FIELDS:
            if not np.array_equal(tc.host[field][i],
                                  getattr(node, field).to_vector(rnames)):
                return False
        want_max = node.max_task_num if node.max_task_num > 0 \
            else BIG_MAX_TASKS
        return (int(tc.host["max_tasks"][i]) == want_max
                and int(tc.host["ntasks"][i]) == len(node.tasks)
                and int(tc.host["zone_code"][i])
                == zone_code(node.topology_zone))

    # -- side effects (cache.go:549-666) ------------------------------------

    def bind(self, task: TaskInfo) -> None:
        """Mark the optimistic Bound state FIRST, then execute the bind
        through the Binder (the reference's AddBindingTask-then-Bind
        order, cache.go:602-666). A Binder failure rolls the cache back
        and queues the bind for a rate-limited retry."""
        newly_placed = False
        prev_status = None
        with self._lock:
            job = self.jobs.get(task.job)
            if job is not None and task.uid in job.tasks:
                self._dirty_jobs.add(task.job)
                if task.node_name:
                    self._dirty_nodes.add(task.node_name)
                cached = job.tasks[task.uid]
                prev_status = cached.status
                prev_node = cached.node_name
                if prev_node:
                    self._dirty_nodes.add(prev_node)
                if not prev_node:
                    newly_placed = True
                    cached.node_name = task.node_name
                    job.update_task_status(cached, TaskStatus.BOUND)
                    if task.node_name in self.nodes:
                        self.nodes[task.node_name].add_task(cached)
                else:
                    job.update_task_status(cached, TaskStatus.BOUND)
                    if prev_node in self.nodes:
                        self.nodes[prev_node].update_task(cached)
        seq = self._journal_intent("bind", task, task.node_name,
                                   fresh=newly_placed)
        self._register_inflight("bind", task, task.node_name, seq)
        try:
            self._bind_volumes(task)
            self.binder.bind(task, task.node_name)
            self._journal_ack(seq, True)
        except Exception:
            # roll back exactly what the optimistic phase did
            with self._lock:
                job = self.jobs.get(task.job)
                if job is not None and task.uid in job.tasks:
                    cached = job.tasks[task.uid]
                    if newly_placed:
                        if cached.node_name in self.nodes:
                            self.nodes[cached.node_name].remove_task(cached)
                        job.update_task_status(cached, TaskStatus.PENDING)
                        cached.node_name = ""
                    elif prev_status is not None:
                        job.update_task_status(cached, prev_status)
                        if cached.node_name in self.nodes:
                            self.nodes[cached.node_name].update_task(cached)
                self.err_tasks.append(task)
            self._journal_ack(seq, False)
            self.inflight.abort("bind", task.uid)
            self.resync_task(task)

    def bind_batch(self, tasks: List[TaskInfo]) -> None:
        """Batched bind: one optimistic pass with per-node aggregated
        accounting, then the Binder calls, with per-task rollback on a
        Binder failure. Semantics match bind() per task; the aggregation
        removes the per-task Resource arithmetic that dominates a 10k-bind
        cycle."""
        agg: Dict[str, Resource] = {}
        placed = []
        with self._lock:
            for task in tasks:
                job = self.jobs.get(task.job)
                if job is None or task.uid not in job.tasks:
                    continue
                self._dirty_jobs.add(task.job)
                if task.node_name:
                    self._dirty_nodes.add(task.node_name)
                cached = job.tasks[task.uid]
                if cached.node_name:
                    # re-bind of an already-placed task: rare; full path
                    self._dirty_nodes.add(cached.node_name)
                    job.update_task_status(cached, TaskStatus.BOUND)
                    if cached.node_name in self.nodes:
                        self.nodes[cached.node_name].update_task(cached)
                    placed.append((task, False))
                    continue
                cached.node_name = task.node_name
                job.update_task_status(cached, TaskStatus.BOUND)
                node = self.nodes.get(task.node_name)
                if node is not None:
                    # the clone keeps status BOUND so a later
                    # remove_task/update_task re-accounts correctly
                    node.tasks[cached.uid] = cached.clone()
                    agg.setdefault(task.node_name, Resource()).add(
                        cached.resreq)
                placed.append((task, True))
            for name, r in agg.items():
                node = self.nodes[name]
                node.idle.sub(r)
                node.used.add(r)
        # group commit: journal EVERY intent of the batch before the first
        # executor call
        seqs = [self._journal_intent("bind", task, task.node_name,
                                     sync=False, fresh=newly)
                for task, newly in placed]
        if self.journal is not None and placed:
            self.journal.flush()
        for (task, newly), seq in zip(placed, seqs):
            self._register_inflight("bind", task, task.node_name, seq)
        for (task, newly), seq in zip(placed, seqs):
            try:
                self._bind_volumes(task)
                self.binder.bind(task, task.node_name)
                self._journal_ack(seq, True)
            except Exception:
                with self._lock:
                    job = self.jobs.get(task.job)
                    if job is not None and task.uid in job.tasks:
                        cached = job.tasks[task.uid]
                        if newly:
                            node = self.nodes.get(cached.node_name)
                            if node is not None:
                                node.remove_task(cached)
                            job.update_task_status(cached,
                                                   TaskStatus.PENDING)
                            cached.node_name = ""
                    self.err_tasks.append(task)
                self._journal_ack(seq, False)
                self.inflight.abort("bind", task.uid)
                self.resync_task(task)

    def _bind_volumes(self, task: TaskInfo) -> None:
        """Volume allocate and bind at pod-bind time (the reference splits
        them across Statement.Allocate and Commit, statement.go:230-292;
        in-process PVC binding has no node constraint, so the whole
        sequence runs here with the same end state). The default
        VolumeBinder does nothing."""
        volumes = self.volume_binder.get_pod_volumes(
            task, self.nodes.get(task.node_name))
        self.volume_binder.allocate_volumes(task, task.node_name, volumes)
        self.volume_binder.bind_volumes(task, volumes)

    def evict(self, task: TaskInfo, reason: str) -> None:
        """Execute an eviction through the Evictor, then mark the cached
        task RELEASING on its job and node (cache.go:549-599). An Evictor
        failure leaves the cache as it was and queues a retry."""
        seq = self._journal_intent("evict", task)
        self._register_inflight("evict", task, seq=seq)
        try:
            self.evictor.evict(task, reason)
            self._journal_ack(seq, True)
        except Exception:
            with self._lock:
                self.err_tasks.append(task)
            self._journal_ack(seq, False)
            self.inflight.abort("evict", task.uid)
            self.resync_task(task, op="evict")
            return
        with self._lock:
            job = self.jobs.get(task.job)
            if job is not None and task.uid in job.tasks:
                self._mark_task_dirty(task)
                job.update_task_status(job.tasks[task.uid],
                                       TaskStatus.RELEASING)
                if task.node_name in self.nodes:
                    self.nodes[task.node_name].update_task(
                        job.tasks[task.uid])

    def requeue_lost_member(self, jid: str, uid: str,
                            lost_node: Optional[str] = None,
                            detach: bool = True) -> bool:
        """Validate-then-requeue for a gang member the cluster lost (its
        node died). Only a member the cache still places on ``lost_node``
        (or an unplaced one) requeues; its in-flight entry and binding
        marker resolve with it. ``detach=False`` skips the node-mirror
        detach when the node itself is about to leave the cache. Returns
        whether the member was requeued."""
        with self._lock:
            job = self.jobs.get(jid)
            cached = job.tasks.get(uid) if job is not None else None
            if cached is None:
                return False
            if lost_node is not None and cached.node_name \
                    and cached.node_name != lost_node:
                return False
            if cached.node_name:
                self._dirty_nodes.add(cached.node_name)
            self._dirty_jobs.add(jid)
            node = self.nodes.get(cached.node_name)
            if detach and node is not None and uid in node.tasks:
                node.remove_task(cached)
            cached.node_name = ""
            job.update_task_status(cached, TaskStatus.PENDING)
            self.binding_tasks.pop(uid, None)
        self.inflight.resolve(None, uid, "lost")
        return True

    def rearm_inflight_from_state(self) -> int:
        """Rebuild the (volatile) in-flight ledger from cache truth after a
        restart: BOUND tasks await their RUNNING ack, RELEASING ones their
        delete confirmation. Returns the number of entries armed."""
        pending: List[Tuple[str, str, str, str]] = []
        with self._lock:
            for jid, job in self.jobs.items():
                for uid, task in job.tasks.items():
                    if task.status == TaskStatus.BOUND and task.node_name:
                        pending.append(("bind", uid, jid, task.node_name))
                    elif task.status == TaskStatus.RELEASING:
                        pending.append(("evict", uid, jid,
                                        task.node_name or ""))
        for op, uid, jid, node in pending:
            self.inflight.register(op, uid, jid, node)
        return len(pending)

    # -- in-flight watchdog -------------------------------------------------

    def process_expired_inflight(self) -> Dict[str, int]:
        """The ack watchdog, driven from the scheduler epilogue: deliver
        the delayed watch-path acks that fell due, then re-validate every
        in-flight entry whose ack deadline passed and resolve it through
        the repair machinery. Returns {resolution: count}."""
        from .. import metrics
        self.feedback.deliver_due()
        ledger = self.inflight
        now = ledger.time_fn()
        out: Dict[str, int] = {}
        for entry in ledger.expired(now):
            try:
                resolution = self._resolve_expired_inflight(entry)
            except Exception:
                log.exception("resolving expired in-flight entry %r "
                              "failed; it stays armed", entry)
                continue
            if resolution:
                out[resolution] = out.get(resolution, 0) + 1
                metrics.register_inflight_expired(entry.op, resolution)
        metrics.set_inflight_stats(ledger.open_count(),
                                   ledger.oldest_age(now),
                                   ledger.detail(now))
        return out

    def _resolve_expired_inflight(self, entry) -> Optional[str]:
        """Settle ONE expired entry; returns its resolution label."""
        from .journal import _rollback_bind
        ledger = self.inflight
        with self._lock:
            job = self.jobs.get(entry.job)
            cached = job.tasks.get(entry.uid) if job is not None else None
            if cached is None:
                intended = False
            elif entry.op == "bind":
                intended = (cached.status == TaskStatus.BOUND
                            and cached.node_name == entry.node)
            else:
                intended = cached.status == TaskStatus.RELEASING
        if cached is None:
            ledger.resolve(entry.op, entry.uid, "gone")
            return "gone"
        if not intended:
            ledger.resolve(entry.op, entry.uid, "superseded")
            return "superseded"
        truth = None
        if self.inflight_oracle_fn is not None:
            truth = self.inflight_oracle_fn(entry)
        if entry.op == "bind":
            if truth is False:
                _rollback_bind(self, job, cached, entry.node, fresh=True)
                with self._lock:
                    self.binding_tasks.pop(entry.uid, None)
                ledger.resolve("bind", entry.uid, "rolled_back")
                return "rolled_back"
            self.feedback.ack_running(entry.job, entry.uid, entry.node,
                                      source="watchdog")
            ledger.resolve("bind", entry.uid, "repaired")
            return "repaired"
        if truth is False:
            ledger.resolve("evict", entry.uid, "reissued")
            self.resync_task(cached.clone(), op="evict")
            return "reissued"
        self.feedback.ack_evicted(entry.job, entry.uid, source="watchdog")
        ledger.resolve("evict", entry.uid, "repaired")
        return "repaired"

    # -- resync queue and dead letters (cache.go:777-799) -------------------

    def resync_task(self, task: TaskInfo, op: str = "bind") -> None:
        """Queue a failed side effect for rate-limited retry; a task past
        its retry budget moves to the dead-letter set instead."""
        self._resync_or_dead_letter(f"{op}/{task.uid}", op, task)

    def _resync_or_dead_letter(self, key: str, op: str,
                               task: TaskInfo) -> None:
        if self.resync_queue.add_rate_limited(key, (op, task)):
            return
        from .. import metrics
        evicted = 0
        with self._lock:
            fresh = key not in self.dead_letter
            # re-parking an existing key refreshes its age
            self.dead_letter.pop(key, None)
            self.dead_letter[key] = (op, task)
            while 0 < self.dead_letter_max < len(self.dead_letter):
                oldest = next(iter(self.dead_letter))
                self.dead_letter.pop(oldest)
                self.resync_queue.forget(oldest)
                self.dead_letter_evicted += 1
                evicted += 1
            size = len(self.dead_letter)
        metrics.set_dead_letter_size(size)
        if evicted:
            metrics.register_dead_letter_evicted(evicted)
            log.error("dead-letter set overflowed its cap (%d): evicted %d "
                      "oldest side effect(s)", self.dead_letter_max, evicted)
        if fresh:
            # count logical events, not cycles
            metrics.register_dead_letter(op)

    def _drop_retry_state(self, task_uid: str) -> None:
        """A deleted task's queued retries and dead-letter entry are moot.
        Caller holds self._lock."""
        dropped = False
        for key in (f"bind/{task_uid}", f"evict/{task_uid}"):
            dropped = (self.dead_letter.pop(key, None)
                       is not None) or dropped
            self.resync_queue.forget(key)
        if dropped:
            from .. import metrics
            metrics.set_dead_letter_size(len(self.dead_letter))

    def redrive_dead_letter(self) -> int:
        """Re-queue every dead-lettered side effect with a fresh retry
        budget (after the underlying fault is fixed). Returns how many
        moved."""
        with self._lock:
            items = list(self.dead_letter.items())
            self.dead_letter.clear()
        moved = 0
        for key, (op, task) in items:
            self.resync_queue.forget(key)
            if self.resync_queue.add_rate_limited(key, (op, task)):
                moved += 1
            else:
                with self._lock:
                    self.dead_letter[key] = (op, task)
        from .. import metrics
        metrics.set_dead_letter_size(len(self.dead_letter))
        return moved

    def _resync_stale(self, op: str, task: TaskInfo) -> bool:
        """A queued retry is STALE when the cluster moved on while it sat
        in backoff: the task was deleted, or (bind) a later cycle already
        re-placed the rolled-back task."""
        with self._lock:
            job = self.jobs.get(task.job)
            cached = job.tasks.get(task.uid) if job is not None else None
            if cached is None:
                return True
            if op == "bind" and (allocated_status(cached.status)
                                 or (cached.node_name
                                     and cached.node_name != task.node_name)):
                return True
        return False

    def _resync_bind_valid(self, task: TaskInfo) -> bool:
        """A queued bind retry is only re-executable while it is still a
        placement the scheduler would stand behind: the task is PENDING
        and unplaced (or still on the retry's target), and the target
        node is present, ready and can hold it now on idle and future
        idle."""
        with self._lock:
            job = self.jobs.get(task.job)
            cached = job.tasks.get(task.uid) if job is not None else None
            node = self.nodes.get(task.node_name)
            if (cached is None or node is None or not node.ready
                    or cached.status != TaskStatus.PENDING
                    or cached.node_name not in ("", task.node_name)):
                return False
            if cached.node_name == task.node_name \
                    and cached.uid in node.tasks:
                return True
            return (task.init_resreq.less_equal(node.idle)
                    and task.init_resreq.less_equal(node.future_idle()))

    def process_resync_tasks(self, max_items: Optional[int] = None) -> int:
        """Retry side effects whose backoff expired (processResyncTask,
        cache.go:781-799); the scheduler shell calls this every cycle.
        Stale or no-longer-valid retries are dropped. Returns the number
        of successful retries."""
        done = 0
        for key, (op, task) in self.resync_queue.pop_ready(max_items):
            if op == "pg_status":
                # a parked podgroup status flush: re-flush the job's
                # LATEST status; drop it when the job is gone
                with self._lock:
                    live = self.jobs.get(task.uid)
                if live is None or live.podgroup is None:
                    self.resync_queue.forget(key)
                    continue
                try:
                    self.status_updater.update_pod_group(live)
                    self.resync_queue.forget(key)
                    done += 1
                except Exception:
                    self._resync_or_dead_letter(key, op, live)
                continue
            if self._resync_stale(op, task):
                self.resync_queue.forget(key)
                continue
            if op == "bind" and not self._resync_bind_valid(task):
                # the allocate loop re-places pending tasks every cycle
                self.resync_queue.forget(key)
                continue
            seq = self._journal_intent(op, task, task.node_name,
                                       via="resync")
            self._register_inflight(op, task, task.node_name, seq)
            try:
                if op == "bind":
                    self._bind_volumes(task)
                    self.binder.bind(task, task.node_name)
                    with self._lock:
                        job = self.jobs.get(task.job)
                        if job is not None and task.uid in job.tasks:
                            self._mark_task_dirty(task)
                            cached = job.tasks[task.uid]
                            cached.node_name = task.node_name
                            job.update_task_status(cached, TaskStatus.BOUND)
                            node = self.nodes.get(task.node_name)
                            if node is not None \
                                    and cached.uid not in node.tasks:
                                node.add_task(cached)
                else:
                    self.evictor.evict(task, "resync")
                    with self._lock:
                        job = self.jobs.get(task.job)
                        if job is not None and task.uid in job.tasks:
                            self._mark_task_dirty(task)
                            cached = job.tasks[task.uid]
                            job.update_task_status(cached,
                                                   TaskStatus.RELEASING)
                            # the node mirror holds a CLONE: keep its
                            # accounting in step with the job's
                            if cached.node_name in self.nodes:
                                self.nodes[cached.node_name].update_task(
                                    cached)
                self._journal_ack(seq, True)
                self.resync_queue.forget(key)
                done += 1
            except Exception:
                self._journal_ack(seq, False)
                self.inflight.abort(op, task.uid)
                self._resync_or_dead_letter(key, op, task)
        return done

    FORWARD_CLUSTER_KEY = "volcano.sh/forward-cluster"

    def bind_pod_group(self, job: JobInfo, cluster: str) -> None:
        """Multi-cluster forwarding (podgroupBinder, cache.go:275-312):
        annotate every task's pod and the PodGroup with the silo cluster so
        the target cluster's control plane takes over the gang."""
        for task in job.tasks.values():
            task.annotations[self.FORWARD_CLUSTER_KEY] = cluster
            pod = getattr(task, "pod", None)
            if pod is not None:
                pod.metadata.annotations[self.FORWARD_CLUSTER_KEY] = cluster
        job.podgroup.annotations[self.FORWARD_CLUSTER_KEY] = cluster
        self._dirty_jobs.add(job.uid)
        self.status_updater.update_pod_group(job)

    def update_job_status(self, job: JobInfo) -> None:
        try:
            self.status_updater.update_pod_group(job)
        except Exception:
            # the cycle must not crash on a failed status write: park a
            # pg_status retry, which re-flushes the job's latest status
            log.exception("podgroup status write for %s failed; queued "
                          "for resync", job.uid)
            self._resync_or_dead_letter(f"pg_status/{job.uid}",
                                        "pg_status", job)
        with self._lock:
            cached = self.jobs.get(job.uid)
            if cached is not None and cached.podgroup is not job.podgroup:
                # the PodGroup is normally aliased between the live job
                # and its snapshot clones; only a replacement re-dirties
                cached.podgroup = job.podgroup
                self._dirty_jobs.add(job.uid)
