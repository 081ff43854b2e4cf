"""Decision audit: the "why" layer of the cycle flight recorder.

Every scheduling cycle the shell harvests one structured record per job
that had a decision this cycle — gang admitted, denied (with the dominant
reason from ``FitError``/``job_fit_errors``/gang plugin state), pipelined
awaiting resources, or preempted/reclaimed/evicted — into a bounded ring
buffer of the last N cycles. ``why(job)`` answers "why is this gang still
pending" from a live process.

Records are plain dicts::

    {"job", "queue", "verdict", "reason", "cycle", "t", "detail"}

``verdict`` is one of ``admitted | denied | pipelined | preempted |
reclaimed | evicted``. Denial reasons come from the state the plugins
already maintain — ``job.job_fit_errors`` (the gang plugin's session-close
writeback), falling back to the aggregated per-node ``FitErrors``
histogram (``job.fit_error()``) — so the audit layer adds no new
bookkeeping to the hot path, only a harvest walk after ``close_session``.

Memory bound: one current-state record per LIVE job plus ``max_cycles``
buckets of per-cycle CHANGES (default 32, ``VOLCANO_TPU_AUDIT_CYCLES``
overrides; 0 or negative disables the audit entirely) — a steady pending
backlog records each gang once, not once per cycle.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Dict, List, Optional

_VERDICT_BY_REASON = {"preempt": "preempted", "reclaim": "reclaimed"}


def _default_cycles() -> int:
    try:
        # clamped at 0: a negative value (a plausible guess for
        # "disable"/"unlimited") must disable the audit, not crash
        # deque(maxlen<0) at import time
        return max(0, int(os.environ.get("VOLCANO_TPU_AUDIT_CYCLES", 32)))
    except ValueError:
        return 32


def _default_jobs() -> int:
    """Cap on the per-LIVE-job record map: live-set pruning bounds
    ``_latest`` by the number of live jobs, which under pathological
    churn/overload is itself unbounded. Past the cap the
    LEAST-RECENTLY-UPDATED record is evicted (the ``audit_latest_evicted``
    counter; ``metrics.health_detail()`` warns) — a why() miss on a stale
    job beats unbounded audit memory. <=0 disables the cap."""
    try:
        return int(os.environ.get("VOLCANO_TPU_AUDIT_JOBS", 8192))
    except ValueError:
        return 8192


class AuditLog:
    """Memory contract: ``_latest`` holds at most ONE record per LIVE job
    (pruned against the live-job set every harvest), and the cycle ring
    holds only records that CHANGED that cycle (verdict or reason differs
    from the job's previous state). A steady 10k-gang pending backlog
    therefore costs 10k records once, not 10k per retained cycle."""

    def __init__(self, max_cycles: Optional[int] = None,
                 max_jobs: Optional[int] = None):
        if max_cycles is None:
            max_cycles = _default_cycles()
        max_cycles = max(0, max_cycles)      # negative == disabled
        self._lock = threading.Lock()
        self.max_cycles = max_cycles
        # bounded (see _default_jobs): the live-set prune alone grows
        # with live-job cardinality under churn/overload
        self.max_jobs = _default_jobs() if max_jobs is None else max_jobs
        self.jobs_evicted = 0
        # ring of (cycle, t, {job: [changed record, ...]})
        self._cycles: collections.deque = collections.deque(
            maxlen=max_cycles or 1)
        # job -> its newest record (the current decision state); ordered
        # by last update so the bound evicts least-recently-updated
        self._latest: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self.enabled = max_cycles > 0

    def clear(self) -> None:
        with self._lock:
            self._cycles.clear()
            self._latest.clear()

    def configure(self, max_cycles: int) -> None:
        """Re-size the cycle ring as ``VOLCANO_TPU_AUDIT_CYCLES`` sizes it
        at construction (0 or negative disables the audit); clears the
        log. The process-wide ``AUDIT`` is built at import, so this is how
        a process that is already running changes its ring."""
        max_cycles = max(0, int(max_cycles))
        with self._lock:
            self.max_cycles = max_cycles
            self._cycles = collections.deque(maxlen=max_cycles or 1)
            self._latest.clear()
            self.enabled = max_cycles > 0

    # -- feed ---------------------------------------------------------------

    def record_cycle(self, cycle: int, t: float,
                     records: Dict[str, List[dict]],
                     live_jobs=None) -> Dict[str, List[dict]]:
        """Absorb one cycle's records. Unchanged repeats (same
        verdict+reason as the job's current state — the steady "still
        denied for the same reason" case) refresh nothing and are dropped
        from the ring; ``live_jobs`` (the cycle's job-uid set) prunes
        ``_latest`` entries of completed/deleted jobs. Returns the
        CHANGED records (what entered the ring) so the harvest can tee
        them into the lifecycle timelines without re-deriving the
        change-only filter."""
        if not self.enabled:
            return {}
        with self._lock:
            changed: Dict[str, List[dict]] = {}
            for job, recs in records.items():
                if not recs:
                    continue
                prev = self._latest.get(job)
                new = [r for r in recs if prev is None
                       or (r["verdict"], r["reason"])
                       != (prev["verdict"], prev["reason"])]
                last = recs[-1]
                # an unchanged repeat keeps the PREVIOUS record so why()'s
                # ``cycle`` stays "when this state was first recorded" — a
                # gang stuck denied since cycle 10 must not read as a
                # fresh cycle-500 decision
                if prev is None or (last["verdict"], last["reason"]) \
                        != (prev["verdict"], prev["reason"]):
                    self._latest[job] = last
                    self._latest.move_to_end(job)
                if new:
                    changed[job] = new
            if changed:
                self._cycles.append((cycle, t, changed))
            if live_jobs is not None:
                for job in [j for j in self._latest
                            if j not in live_jobs]:
                    del self._latest[job]
            evicted = 0
            while 0 < self.max_jobs < len(self._latest):
                # bound against pathological live-job cardinality
                # (overload/churn): drop the least-recently-updated
                # record — its job's state hasn't changed in the
                # longest, so it is the cheapest why() answer to lose
                self._latest.popitem(last=False)
                self.jobs_evicted += 1
                evicted += 1
        if evicted:
            from .. import metrics
            metrics.register_audit_evicted(evicted)
        return changed

    # -- query --------------------------------------------------------------

    def why(self, job: str) -> Optional[dict]:
        """The current decision state for ``job`` (its newest record —
        ``cycle`` says when that state was first recorded), falling back
        to the retained change ring for jobs that since completed. Jobs
        are keyed by uid (``namespace/name`` in the full system); a
        bare-name query matches the name component, so ``why("train")``
        finds ``default/train``."""
        with self._lock:
            rec = self._latest.get(job)
            if rec is not None:
                return dict(rec)
            for uid, rec in self._latest.items():
                if uid.rsplit("/", 1)[-1] == job:
                    return dict(rec)
            for cycle, t, records in reversed(self._cycles):
                for uid, recs in records.items():
                    if recs and (uid == job
                                 or uid.rsplit("/", 1)[-1] == job):
                        return dict(recs[-1])
        return None

    def records(self, job: Optional[str] = None,
                last_cycles: Optional[int] = None) -> List[dict]:
        """Flat CHANGE list, oldest cycle first (cycles where a job's
        verdict/reason stayed the same are deduplicated away); filter by
        job and/or the last N retained cycles."""
        out: List[dict] = []
        with self._lock:
            buckets = list(self._cycles)
        if last_cycles is not None:
            buckets = buckets[-last_cycles:]
        for cycle, t, records in buckets:
            if job is not None:
                out.extend(dict(r) for r in records.get(job, ()))
            else:
                for recs in records.values():
                    out.extend(dict(r) for r in recs)
        return out

    def cycles_retained(self) -> int:
        with self._lock:
            return len(self._cycles)


def harvest_cycle(ssn, cycle: int, t: float,
                  log: Optional["AuditLog"] = None) -> int:
    """Build the cycle's decision records from the closed session and feed
    the ring. Called by ``Scheduler.run_once`` AFTER ``close_session`` (so
    the gang plugin's ``job_fit_errors`` writeback has run), outside the
    e2e-timed window. Returns the number of jobs recorded.

    Verdict sources:

    - session audit events (``Session.audit_events``, appended by
      ``dispatch``/``evict``/statement commits): binds → ``admitted``,
      evictions → ``preempted``/``reclaimed``/``evicted`` by reason;
    - the post-close job state: a job with pending work that is not ready
      is ``denied`` (reason harvested from gang/fit-error state) or
      ``pipelined`` when the gang holds pipelined placements."""
    log = log if log is not None else AUDIT
    if not log.enabled:
        return 0
    from ..api import TaskStatus

    records: Dict[str, List[dict]] = {}

    def add(job_uid: str, queue: str, verdict: str, reason: str,
            detail=None) -> None:
        rec = {"job": job_uid, "queue": queue, "verdict": verdict,
               "reason": reason, "cycle": cycle, "t": t}
        if detail:
            rec["detail"] = detail
        records.setdefault(job_uid, []).append(rec)

    bound: Dict[str, int] = {}
    evicted: Dict[str, List[tuple]] = {}
    for kind, task_uid, job_uid, extra in getattr(ssn, "audit_events", ()):
        if kind == "bind":
            bound[job_uid] = bound.get(job_uid, 0) + 1
        elif kind == "evict":
            evicted.setdefault(job_uid, []).append((task_uid, extra))

    for job_uid, victims in evicted.items():
        job = ssn.jobs.get(job_uid)
        reason = victims[0][1] or "evict"
        add(job_uid, getattr(job, "queue", ""),
            _VERDICT_BY_REASON.get(reason, "evicted"),
            f"{len(victims)} task(s) evicted ({reason})",
            detail=[uid for uid, _ in victims])

    for job in ssn.jobs.values():
        pending = job.task_status_index.get(TaskStatus.PENDING, {})
        pipelined = job.task_status_index.get(TaskStatus.PIPELINED, {})
        ready = job.ready()
        if job.uid in bound and ready:
            add(job.uid, job.queue, "admitted",
                f"gang ready: {job.ready_task_num()}/{job.min_available} "
                f"tasks placed ({bound[job.uid]} bound this cycle)")
        elif pipelined and not ready:
            add(job.uid, job.queue, "pipelined",
                f"gang pipelined onto future idle resources "
                f"({len(pipelined)} task(s) awaiting victims/completions)")
        elif pending and not ready:
            reason = job.job_fit_errors or job.fit_error() \
                or "pending: no fit attempt recorded this cycle"
            # the dominant per-node fit reason, when the cycle's placer
            # recorded one (callbacks/backfill populate FitErrors per
            # task): "all nodes are unavailable: 120 Insufficient cpu."
            for fe in job.nodes_fit_errors.values():
                detail = fe.error()
                if detail and detail not in reason:
                    reason = f"{reason} — {detail}"
                break
            add(job.uid, job.queue, "denied", reason)
    changed = log.record_cycle(cycle, t, records, live_jobs=set(ssn.jobs))
    # tee the change-only decisions into the lifecycle timelines
    # (obs/lifecycle.py): the "solve" event is what lets why()
    # answer for a gang whose denial aged out of this ring
    from .lifecycle import TIMELINE
    for job_uid, recs in changed.items():
        for rec in recs:
            TIMELINE.record(job_uid, "solve", t=rec["t"],
                            verdict=rec["verdict"], reason=rec["reason"])
    return len(records)


# Process-wide audit log; VOLCANO_TPU_AUDIT_CYCLES=0 disables.
AUDIT = AuditLog()
