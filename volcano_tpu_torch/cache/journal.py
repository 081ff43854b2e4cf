"""Intent journal: write-ahead durability for bind/evict side effects.

The cache executes side effects (binder/evictor calls against the
cluster) and only then commits the outcome to its in-memory state. A
process crash between the two leaves the cluster and the next scheduler
incarnation disagreeing about where a task lives — the classic path to a
double-bind. The journal closes that window with the standard WAL
discipline (docs/robustness.md):

1. ``record_intent(op, task, node)`` appends one JSONL record BEFORE the
   executor call;
2. the executor runs;
3. ``ack(seq, ok)`` appends the outcome — ``ok=False`` for an executor
   failure the cache already rolled back (the resync queue owns the
   retry; nothing is outstanding).

An intent with no ack is exactly the crash window: the side effect may
or may not have reached the cluster. ``reconcile()`` replays those
against cache truth at startup — with a cluster oracle when one exists
(the sim's executor records; a store-wired deployment's pod state),
idempotent redo when none does — so a scheduler killed mid-cycle
restarts with zero double-binds and zero orphaned allocations.

Durability: an INTENT is flushed+fsynced before its executor runs —
single-op funnels sync per intent, ``bind_batch`` group-commits every
intent of the batch with ONE fsync before the first executor call —
because an executed side effect with no durable intent is exactly the
double-bind window the WAL exists to close. ACKS are fsync-BATCHED
(``fsync_batch`` records per fsync; the scheduler flushes the tail each
cycle): losing an ack to a crash merely makes reconciliation re-examine
a settled intent, which is idempotent. The file rotates by compaction
once it crosses ``max_bytes``: acked records are dropped, unacked
intents rewritten to a fresh file via write-tmp-then-rename.
``path=None`` keeps the journal in memory — the sim's restart harness
and tests use that; the sync calls become no-ops because the process
itself is the durability domain there.

Kill-switch: ``VOLCANO_TPU_JOURNAL=0`` detaches journaling wholesale
(SchedulerCache treats a configured journal as absent).
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Callable, Dict, List, Optional

log = logging.getLogger(__name__)

DEFAULT_FSYNC_BATCH = 64
DEFAULT_MAX_BYTES = 8 << 20


def journal_enabled() -> bool:
    """Kill-switch for intent journaling: set VOLCANO_TPU_JOURNAL=0 to
    run without the write-ahead log even when one is configured."""
    return os.environ.get("VOLCANO_TPU_JOURNAL", "1") \
        .lower() not in ("0", "false", "off")


class Intent:
    """One journaled side-effect intent (decoded view)."""

    __slots__ = ("seq", "op", "task", "job", "node", "via", "fresh",
                 "epoch")

    def __init__(self, seq: int, op: str, task: str, job: str, node: str,
                 via: str = "", fresh: bool = True, epoch: int = 0):
        self.seq = seq
        self.op = op                  # "bind" | "evict"
        self.task = task              # task uid
        self.job = job                # owning job uid
        self.node = node              # bind target / evictee's node
        self.via = via                # "" (scheduler cycle) | "resync"
        # fresh=True: a NEW placement (the optimistic phase moved the
        # task from unplaced to this node). False: a RE-bind of a task
        # already validly placed — rolling that back must not strip the
        # still-live previous placement.
        self.fresh = fresh
        # the leader's fencing epoch at intent time (docs/robustness.md
        # HA section): 0 for standalone schedulers. Recorded so the
        # journal totally orders side effects across leaderships and a
        # replayed record names the leadership that issued it.
        self.epoch = epoch

    def __repr__(self):
        return (f"Intent(seq={self.seq}, op={self.op}, task={self.task}, "
                f"node={self.node})")


class IntentJournal:
    """Append-only JSONL intent/ack log with batched fsync and
    compaction-based rotation. Thread-safe: the cache's bind/evict
    funnels may run from multiple threads."""

    def __init__(self, path: Optional[str] = None,
                 fsync_batch: int = DEFAULT_FSYNC_BATCH,
                 max_bytes: int = DEFAULT_MAX_BYTES):
        self.path = path
        self.fsync_batch = max(int(fsync_batch), 1)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._seq = 0
        self._unsynced = 0
        self._bytes = 0
        self.rotations = 0
        self.appended = 0
        self.fsyncs = 0
        # seq -> intent, dropped on ack; what reconcile() replays
        self._open: Dict[int, Intent] = {}
        self._fh = None
        if path is not None:
            self._recover_existing(path)
            self._fh = open(path, "a", encoding="utf-8")
            self._bytes = self._fh.tell()

    # -- durability ---------------------------------------------------------

    def _recover_existing(self, path: str) -> None:
        """Load an existing journal file: rebuild the open-intent set and
        continue the sequence after the highest seq seen. Truncated or
        garbled tail lines (a crash mid-append) are skipped — a torn
        intent was by definition never followed by its side effect's
        ack, and its executor call may not have begun either; dropping
        it is the conservative read."""
        if not os.path.exists(path):
            return
        with open(path, encoding="utf-8") as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                self._apply_record(rec)

    def _apply_record(self, rec: dict) -> None:
        seq = int(rec.get("seq", 0))
        self._seq = max(self._seq, seq)
        if rec.get("kind") == "intent":
            self._open[seq] = Intent(seq, rec["op"], rec["task"],
                                     rec.get("job", ""), rec.get("node", ""),
                                     rec.get("via", ""),
                                     bool(rec.get("fresh", True)),
                                     int(rec.get("epoch", 0)))
        elif rec.get("kind") == "ack":
            self._open.pop(seq, None)

    def _append(self, rec: dict, sync_now: bool = False) -> None:
        """Caller holds self._lock. In-memory mode (path=None) keeps no
        record stream at all — ``_open`` IS the recoverable state there,
        because the process itself is the durability domain."""
        self.appended += 1
        if self._fh is None:
            return
        line = json.dumps(rec, separators=(",", ":"))
        self._fh.write(line + "\n")
        self._bytes += len(line) + 1
        self._unsynced += 1
        if sync_now or self._unsynced >= self.fsync_batch:
            self._sync()
        if self._bytes > self.max_bytes:
            self._rotate()

    def _sync(self) -> None:
        self._fh.flush()
        try:
            os.fsync(self._fh.fileno())
        except OSError:                              # pragma: no cover
            pass
        self.fsyncs += 1
        self._unsynced = 0

    def _rotate(self) -> None:
        """Compact: rewrite only the open (unacked) intents — the only
        records a restart can act on — to a fresh file, atomically."""
        tmp = f"{self.path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for seq in sorted(self._open):
                it = self._open[seq]
                rec = {"kind": "intent", "seq": it.seq, "op": it.op,
                       "task": it.task, "job": it.job, "node": it.node,
                       "via": it.via, "fresh": it.fresh,
                       "epoch": it.epoch}
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._fh.close()
        os.replace(tmp, self.path)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._bytes = self._fh.tell()
        self._unsynced = 0
        self.rotations += 1

    # -- the WAL surface ----------------------------------------------------

    def record_intent(self, op: str, task, node: str = "",
                      via: str = "", fresh: bool = True,
                      epoch: int = 0) -> int:
        """Journal a side-effect intent BEFORE the executor runs, stamped
        with the issuing leader's fencing ``epoch``. Returns the seq to ack
        with."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            intent = Intent(seq, op, task.uid, task.job,
                            node or task.node_name or "", via, fresh,
                            epoch)
            self._open[seq] = intent
            rec = {"kind": "intent", "seq": seq, "op": op,
                   "task": intent.task, "job": intent.job,
                   "node": intent.node, "via": via, "fresh": fresh,
                   "epoch": epoch}
            self._append(rec)
        return seq

    def record_control(self, kind: str, fields: Optional[dict] = None
                       ) -> int:
        """Journal a control record (an elastic gang's command, grow or
        shrink): durable and synced at once, in the intents' seq space, but
        it opens no crash window: it never enters the open set, compaction
        drops it, and recovery and ``reconcile()`` read only its seq.
        Returns the seq."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            rec = {"kind": kind, "seq": seq}
            if fields:
                rec.update(fields)
            self._append(rec, sync_now=True)
        return seq

    def ack(self, seq: int, ok: bool = True) -> None:
        """Journal the executor outcome. ``ok=False`` records a failure
        whose cache rollback already ran — the intent is settled either
        way (the resync queue owns any retry)."""
        with self._lock:
            self._open.pop(seq, None)
            rec = {"kind": "ack", "seq": seq, "ok": bool(ok)}
            self._append(rec)

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None and self._unsynced:
                self._sync()

    def unacked(self) -> List[Intent]:
        """Open intents in append order — the crash window a restart
        must reconcile."""
        with self._lock:
            return [self._open[s] for s in sorted(self._open)]

    def compact(self) -> None:
        """Force a compaction rotation (reconcile() calls this after
        settling the open set so the next recovery starts clean). A
        no-op in memory mode: ``_open`` is already exactly the open
        set."""
        with self._lock:
            if self._fh is not None:
                self._rotate()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                if self._unsynced:
                    self._sync()
                self._fh.close()
                self._fh = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._open)


class ReconcileReport:
    """What the startup reconciler did with the journal's crash window."""

    def __init__(self):
        self.replayed = 0          # unacked intents examined
        self.repaired_binds = 0    # cluster had the bind; cache re-asserted
        self.rolled_back = 0       # cluster lacked it; optimistic state undone
        self.redone = 0            # no oracle: side effect re-issued
        self.repaired_evicts = 0   # cluster executed the evict; cache caught up
        self.stale = 0             # task/job gone; intent moot
        self.failed = 0            # redo raised; handed to the resync queue

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in
                ("replayed", "repaired_binds", "rolled_back", "redone",
                 "repaired_evicts", "stale", "failed")}

    def __repr__(self):
        return f"ReconcileReport({self.as_dict()})"


def reconcile(cache, journal: IntentJournal,
              cluster_binds: Optional[Dict[str, str]] = None,
              cluster_evicts: Optional[Callable[[str], bool]] = None
              ) -> ReconcileReport:
    """Replay the journal's unacked intents against cache truth — the
    restart half of the WAL (call before the first scheduling cycle).

    ``cluster_binds`` (task uid -> node of every bind the CLUSTER
    executed) and ``cluster_evicts`` (uid -> bool) are the truth oracle:
    when present, each open bind intent resolves to either *repair*
    (the cluster has the bind; re-assert it onto cache state so the next
    cycle cannot re-place the task elsewhere) or *rollback* (the cluster
    never saw it; undo the optimistic BOUND so the task re-enters the
    pending pool). Without an oracle the intent is *redone* through the
    executor — safe because redoing a bind onto its JOURNALED node is
    idempotent cluster-side, and the journal never lets a restart invent
    a different node. Either way: zero double-binds.

    Every examined intent is acked (settled) and the journal compacted.
    """
    from .. import metrics

    report = ReconcileReport()
    for intent in journal.unacked():
        report.replayed += 1
        try:
            _reconcile_one(cache, journal, intent, report,
                           cluster_binds, cluster_evicts)
        except Exception:
            # isolated like run_once isolates actions: one intent whose
            # repair blows up (e.g. the rebuilt cache can no longer hold
            # the journaled task) must not leave the REST of the crash
            # window unsettled
            log.exception("reconciling %r failed; settling it as failed",
                          intent)
            report.failed += 1
            journal.ack(intent.seq, ok=False)
    journal.compact()
    journal.flush()
    for result, n in (("repaired", report.repaired_binds
                       + report.repaired_evicts),
                      ("rolled_back", report.rolled_back),
                      ("redone", report.redone),
                      ("stale", report.stale),
                      ("failed", report.failed)):
        if n:
            metrics.register_journal_replay(result, n)
    cache.last_reconcile = report.as_dict()
    return report


def _reconcile_one(cache, journal, intent, report: ReconcileReport,
                   cluster_binds, cluster_evicts) -> None:
    from ..api import TaskStatus, allocated_status
    with cache._lock:
        job = cache.jobs.get(intent.job)
        task = job.tasks.get(intent.task) if job is not None else None
    if task is None:
        report.stale += 1
        journal.ack(intent.seq, ok=False)
        return
    if intent.op == "bind":
        if cluster_binds is not None:
            if cluster_binds.get(intent.task) == intent.node:
                _assert_bound(cache, job, task, intent.node)
                report.repaired_binds += 1
                journal.ack(intent.seq, ok=True)
            else:
                _rollback_bind(cache, job, task, intent.node,
                               intent.fresh)
                report.rolled_back += 1
                journal.ack(intent.seq, ok=False)
            return
        # no oracle: redo onto the journaled node. A task some LATER
        # settled intent/cycle already re-placed is final — the same
        # staleness rule the resync queue applies.
        with cache._lock:
            placed = allocated_status(task.status) \
                and task.node_name and task.node_name != intent.node
        if placed:
            report.stale += 1
            journal.ack(intent.seq, ok=False)
            return
        try:
            redo = task.clone()
            redo.node_name = intent.node
            cache.binder.bind(redo, intent.node)
            _assert_bound(cache, job, task, intent.node)
            report.redone += 1
            journal.ack(intent.seq, ok=True)
        except Exception:
            log.exception("journal redo bind %s -> %s failed; handing "
                          "to the resync queue", intent.task, intent.node)
            _rollback_bind(cache, job, task, intent.node, intent.fresh)
            report.failed += 1
            journal.ack(intent.seq, ok=False)
            retry = task.clone()
            retry.node_name = intent.node
            cache.resync_task(retry)
        return
    # evict
    if cluster_evicts is not None:
        if cluster_evicts(intent.task):
            _repair_releasing(cache, job, task)
            report.repaired_evicts += 1
            journal.ack(intent.seq, ok=True)
        else:
            # the evict never reached the cluster: the decision died
            # with the old process; the next cycle re-decides
            report.rolled_back += 1
            journal.ack(intent.seq, ok=False)
        return
    try:
        cache.evictor.evict(task, "journal-reconcile")
        _repair_releasing(cache, job, task)
        report.redone += 1
        journal.ack(intent.seq, ok=True)
    except Exception:
        log.exception("journal redo evict %s failed; handing to the "
                      "resync queue", intent.task)
        report.failed += 1
        journal.ack(intent.seq, ok=False)
        cache.resync_task(task.clone(), op="evict")


def _repair_releasing(cache, job, task) -> None:
    """Reflect a cluster-executed evict into cache state: job status AND
    the node's task mirror — the node stores a CLONE, so skipping
    update_task would leave a phantom pre-evict entry occupying idle."""
    from ..api import TaskStatus
    with cache._lock:
        cache._mark_task_dirty(task)
        job.update_task_status(task, TaskStatus.RELEASING)
        node = cache.nodes.get(task.node_name)
        if node is not None and task.uid in node.tasks:
            node.update_task(task)


def _assert_bound(cache, job, task, node_name: str) -> None:
    """Make cache state reflect a bind the cluster definitely executed:
    the task is BOUND on ``node_name`` and accounted there exactly once."""
    from ..api import TaskStatus, allocated_status
    with cache._lock:
        cache._mark_task_dirty(task)
        if allocated_status(task.status) and task.node_name == node_name:
            return                       # cache already agrees
        prev_node = cache.nodes.get(task.node_name) \
            if task.node_name and task.node_name != node_name else None
        if prev_node is not None and task.uid in prev_node.tasks:
            cache.mark_node_dirty(prev_node.name)
            prev_node.remove_task(task)
        task.node_name = node_name
        job.update_task_status(task, TaskStatus.BOUND)
        cache.mark_node_dirty(node_name)
        node = cache.nodes.get(node_name)
        if node is not None and task.uid not in node.tasks:
            node.add_task(task)


def _rollback_bind(cache, job, task, node_name: str,
                   fresh: bool = True) -> None:
    """Undo optimistic bind state the cluster never saw: a FRESH
    placement returns to the pending pool (the next cycle re-places
    it). A non-fresh intent was a RE-bind of a task the cluster still
    validly runs on its previous node — stripping that placement would
    set up the next cycle to re-place a task that is still live
    elsewhere (a double-bind), so the cache state is left standing."""
    from ..api import TaskStatus
    if not fresh:
        return
    with cache._lock:
        if task.status == TaskStatus.PENDING and not task.node_name:
            return                       # rollback already ran pre-crash
        cache._mark_task_dirty(task)
        node = cache.nodes.get(task.node_name or node_name)
        if node is not None and task.uid in node.tasks:
            cache.mark_node_dirty(node.name)
            node.remove_task(task)
        job.update_task_status(task, TaskStatus.PENDING)
        task.node_name = ""
