"""In-flight side-effect ledger: the liveness half of the feedback plane.

A bind/evict that the executor ACCEPTED is not DONE — the cluster still
owes the scheduler a feedback ack (the kubelet flipping the pod Running,
the delete confirmation for an eviction). Every prior robustness layer
assumed that ack arrives promptly and exactly once; this ledger drops
that assumption (docs/robustness.md, feedback failure model): every
journaled bind/evict the executor accepted registers an intent with an
ACK DEADLINE here, the FeedbackChannel (cache/feedback.py) resolves
entries as acks are consumed, and the scheduler epilogue's watchdog
(``SchedulerCache.process_expired_inflight``) re-validates expired
entries against cluster truth and resolves them through the existing
journaled repair/rollback/resync ladder — so a delayed, dropped,
duplicated or reordered ack can never wedge in-flight state forever.

One entry per task uid: registering a NEW intent for a uid supersedes
the older one — the newest executor-accepted operation owns the task,
and a late ack for the superseded intent is exactly what the
FeedbackChannel's normalizer classifies stale.

All timing runs on an injectable ``time_fn``; the sim pins
it to the virtual clock so watchdog expiry is deterministic.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

# A cluster ack outstanding longer than this is presumed lost and the
# watchdog re-validates the side effect against cluster truth. Wall
# deployments keep the generous default (a busy kubelet can be slow);
# the sim pins a few virtual periods so soaks exercise expiry.
DEFAULT_ACK_TIMEOUT_S = 60.0


class InflightEntry:
    """One executor-accepted side effect awaiting its cluster ack."""

    __slots__ = ("op", "uid", "job", "node", "seq", "registered_at",
                 "deadline")

    def __init__(self, op: str, uid: str, job: str, node: str,
                 seq: Optional[int], registered_at: float,
                 deadline: float):
        self.op = op                    # "bind" | "evict"
        self.uid = uid
        self.job = job
        self.node = node                # bind target / evictee's node
        self.seq = seq                  # journal seq of the intent (or None)
        self.registered_at = registered_at
        self.deadline = deadline

    def __repr__(self):
        return (f"InflightEntry(op={self.op}, uid={self.uid}, "
                f"node={self.node}, deadline={self.deadline})")


class InflightLedger:
    """Open in-flight entries keyed by task uid, with resolution
    counters. Thread-safe (the cache funnels and watch threads race)."""

    def __init__(self, time_fn=time.monotonic,
                 ack_timeout_s: float = DEFAULT_ACK_TIMEOUT_S):
        self.time_fn = time_fn
        self.ack_timeout_s = ack_timeout_s
        self._lock = threading.Lock()
        self._open: Dict[str, InflightEntry] = {}
        self.registered = 0
        # resolution -> count (all-time for this ledger): acked (the
        # normal path), superseded (a newer intent took the task, or the
        # expired entry no longer matched cache intent), repaired (the
        # watchdog recovered a lost ack), rolled_back (cluster truth
        # lacked the bind), reissued (cluster truth lacked the evict;
        # re-queued through resync), aborted (executor failed — nothing
        # was in flight), lost (node death requeued the member), gone
        # (the task left the cache)
        self.resolved: Dict[str, int] = {}

    def register(self, op: str, uid: str, job: str, node: str = "",
                 seq: Optional[int] = None) -> InflightEntry:
        """Arm the ack deadline for an intent about to execute; any older
        open entry for the uid is superseded (the newest intent owns the
        task)."""
        now = self.time_fn()
        entry = InflightEntry(op, uid, job, node, seq, now,
                              now + self.ack_timeout_s)
        with self._lock:
            if uid in self._open:
                self.resolved["superseded"] = \
                    self.resolved.get("superseded", 0) + 1
            self._open[uid] = entry
            self.registered += 1
        return entry

    def resolve(self, op: Optional[str], uid: str,
                how: str = "acked") -> bool:
        """Close the open entry for ``uid`` (``op=None`` matches either
        op). Returns whether an entry was closed; idempotent."""
        with self._lock:
            entry = self._open.get(uid)
            if entry is None or (op is not None and entry.op != op):
                return False
            del self._open[uid]
            self.resolved[how] = self.resolved.get(how, 0) + 1
        return True

    def abort(self, op: str, uid: str) -> bool:
        """The executor failed and the funnel rolled back: nothing is in
        flight."""
        return self.resolve(op, uid, "aborted")

    def task_deleted(self, uid: str) -> None:
        """The task left the cache (gang completed / pod deleted). A
        pending EVICT entry resolves as acked — the delete IS the evict
        confirmation; a pending bind entry is moot."""
        with self._lock:
            entry = self._open.pop(uid, None)
            if entry is None:
                return
            how = "acked" if entry.op == "evict" else "gone"
            self.resolved[how] = self.resolved.get(how, 0) + 1

    def expired(self, now: Optional[float] = None) -> List[InflightEntry]:
        """Entries past their ack deadline, registration order. NOT
        removed — the watchdog resolves each with its verdict."""
        now = self.time_fn() if now is None else now
        with self._lock:
            return [e for e in self._open.values() if e.deadline <= now]

    def entries(self) -> List[InflightEntry]:
        with self._lock:
            return list(self._open.values())

    def open_count(self) -> int:
        with self._lock:
            return len(self._open)

    def oldest_age(self, now: Optional[float] = None) -> float:
        now = self.time_fn() if now is None else now
        with self._lock:
            if not self._open:
                return 0.0
            return max(now - e.registered_at for e in self._open.values())

    def clear(self) -> None:
        """Process death: the ledger is volatile (the journal, not this,
        is the durable record — startup reconciliation re-derives what
        matters)."""
        with self._lock:
            self._open.clear()

    def detail(self, now: Optional[float] = None) -> dict:
        """The /healthz?detail "inflight" fragment / vcctl payload."""
        now = self.time_fn() if now is None else now
        with self._lock:
            return {
                "open": len(self._open),
                "oldest_age_s": round(
                    max((now - e.registered_at
                         for e in self._open.values()), default=0.0), 3),
                "ack_timeout_s": self.ack_timeout_s,
                "registered": self.registered,
                "resolved": dict(sorted(self.resolved.items())),
            }
