"""Per-job lifecycle timelines: the cluster-causal layer of the flight
recorder.

The span tracer and the decision audit see ONE process. The system moves
a job's story across processes — queue moves between partitions, leader
failovers, split/merge membership changes — and this module is what lets
that story survive the hop: every funnel-level mutation records a
timeline event stamped with a correlation context

    ctx = {"cycle": int, "part": int, "epoch": int, "eid": int}

where ``eid`` is a logical (deterministic) event counter, ``part`` the
originating partition and ``epoch`` the issuing leadership's fencing
epoch. The SAME ctx rides inside the durable records (journal intents,
reserve/move/elastic control records, feedback verdicts), so a newborn
or receiving process re-ingests the events it did not witness — and the
``(part, eid)`` pair is the exactly-once key: a torn-stream replay or a
journal re-read of an event already held is a no-op.

Timelines OBSERVE, never influence: nothing in the scheduling decision
plane reads this store, and fault-free scenario reports stay
byte-identical (the sim emits the derived ``latency``/``slo`` report
sections only under an explicit flag).

Bounds: an LRU of the last ``VOLCANO_TPU_TIMELINE_JOBS`` jobs (default
8192), each keeping its last ``VOLCANO_TPU_TIMELINE_EVENTS`` events
(default 256). ``VOLCANO_TPU_TIMELINE=0`` disables recording entirely.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Dict, List, Optional

DEFAULT_MAX_JOBS = 8192
DEFAULT_MAX_EVENTS = 256


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_enabled() -> bool:
    return os.environ.get("VOLCANO_TPU_TIMELINE", "") not in ("0", "false")


class JobTimeline:
    """One job's causal event list plus its exactly-once witness set."""

    __slots__ = ("job", "events", "seen")

    def __init__(self, job: str, max_events: int):
        self.job = job
        self.events: collections.deque = collections.deque(
            maxlen=max_events or None)
        # (part, eid) pairs already ingested — the dedupe key that makes
        # journal replay / torn-stream re-delivery exactly-once
        self.seen: set = set()


class TimelineStore:
    """Bounded, LRU-capped store of per-job lifecycle timelines."""

    def __init__(self, max_jobs: int = None, max_events: int = None):
        self._lock = threading.Lock()
        self.enabled = _env_enabled()
        self.max_jobs = _env_int("VOLCANO_TPU_TIMELINE_JOBS",
                                 DEFAULT_MAX_JOBS) \
            if max_jobs is None else max_jobs
        self.max_events = _env_int("VOLCANO_TPU_TIMELINE_EVENTS",
                                   DEFAULT_MAX_EVENTS) \
            if max_events is None else max_events
        self._jobs: "collections.OrderedDict[str, JobTimeline]" = \
            collections.OrderedDict()
        # ambient context, set by the scheduler shell at each cycle
        # boundary (and by the sim around its feedback pass): what a
        # funnel-level stamp inherits when it doesn't know better
        self._cycle = 0
        self._part = 0
        self._epoch = 0
        self._t = 0.0
        self._eid = 0
        self.evicted = 0          # LRU evictions (bounded-store witness)
        self.duplicates = 0       # exactly-once drops (replay witness)

    # -- ambient context ----------------------------------------------------

    def set_context(self, cycle: Optional[int] = None,
                    part: Optional[int] = None,
                    epoch: Optional[int] = None,
                    t: Optional[float] = None) -> None:
        """Pin the ambient (cycle, part, epoch, virtual time) every
        subsequent ``stamp``/``record`` inherits. The scheduler shell
        calls this at the top of every run_once; the sim also re-pins
        ``t`` around its between-cycle feedback pass."""
        with self._lock:
            if cycle is not None:
                self._cycle = int(cycle)
            if part is not None:
                self._part = int(part)
            if epoch is not None:
                self._epoch = int(epoch)
            if t is not None:
                self._t = float(t)

    def now(self) -> float:
        """The ambient virtual time of the last pinned context — what an
        SLO evaluation of a live process measures burn windows against."""
        with self._lock:
            return self._t

    def stamp(self, part: Optional[int] = None,
              epoch: Optional[int] = None,
              cycle: Optional[int] = None) -> Optional[dict]:
        """Mint a correlation ctx from the ambient context (overridable
        per field) with a fresh logical event id. This is the ctx that
        rides inside durable records; ``None`` while disabled so record
        shapes stay byte-identical with the timeline off."""
        if not self.enabled:
            return None
        with self._lock:
            self._eid += 1
            return {"cycle": self._cycle if cycle is None else int(cycle),
                    "part": self._part if part is None else int(part),
                    "epoch": self._epoch if epoch is None else int(epoch),
                    "eid": self._eid}

    # -- recording ----------------------------------------------------------

    def record(self, job: str, ev: str, ctx: Optional[dict] = None,
               t: Optional[float] = None, **extra) -> bool:
        """Append one lifecycle event to ``job``'s timeline. With ``ctx``
        (an event re-ingested from a durable record) the ``(part, eid)``
        pair dedupes — replaying a journal tail or a torn watch stream
        cannot double-record. Without, a fresh ctx is minted from the
        ambient context. Returns True when the event was appended."""
        if not self.enabled or not job:
            return False
        fresh = ctx is None
        if fresh:
            ctx = self.stamp()
            if ctx is None:
                return False
        with self._lock:
            tl = self._jobs.get(job)
            if tl is None:
                tl = JobTimeline(job, self.max_events)
                self._jobs[job] = tl
                while len(self._jobs) > self.max_jobs:
                    self._jobs.popitem(last=False)
                    self.evicted += 1
            else:
                self._jobs.move_to_end(job)
            key = (int(ctx.get("part", 0)), int(ctx.get("eid", 0)))
            if key in tl.seen:
                self.duplicates += 1
                return False
            tl.seen.add(key)
            event = {"ev": ev,
                     "cycle": int(ctx.get("cycle", 0)),
                     "part": key[0],
                     "epoch": int(ctx.get("epoch", 0)),
                     "eid": key[1],
                     "t": round(self._t if t is None else float(t), 6)}
            for k in sorted(extra):
                if extra[k] is not None:
                    event[k] = extra[k]
            tl.events.append(event)
            return True

    def ingest(self, job: str, ev: str, ctx: dict, t: Optional[float] = None,
               **extra) -> bool:
        """Re-ingest an event carried by a durable record (journal
        replay, a receiving partition, a newborn's backfill) — the
        exactly-once path a process that did NOT originate the event
        uses to continue the timeline."""
        if not isinstance(ctx, dict):
            return False
        return self.record(job, ev, ctx=ctx, t=t, **extra)

    # -- queries ------------------------------------------------------------

    def _resolve_locked(self, job: str) -> Optional[JobTimeline]:
        tl = self._jobs.get(job)
        if tl is not None:
            return tl
        # bare-name fallback, mirroring AUDIT.why: store-wired jobs are
        # namespace-qualified but operators ask by name
        suffix = "/" + job
        for uid in reversed(self._jobs):
            if uid.endswith(suffix):
                return self._jobs[uid]
        return None

    def events(self, job: str) -> List[dict]:
        with self._lock:
            tl = self._resolve_locked(job)
            return [dict(ev) for ev in tl.events] if tl is not None else []

    def timeline(self, job: str) -> Optional[dict]:
        """The export payload of one job's timeline: its full retained
        event list."""
        with self._lock:
            tl = self._resolve_locked(job)
            if tl is None:
                return None
            return {"job": tl.job, "events": [dict(ev) for ev in tl.events]}

    def first(self, job: str, *kinds: str) -> Optional[dict]:
        for ev in self.events(job):
            if ev["ev"] in kinds:
                return ev
        return None

    def latest(self, job: str, *kinds: str) -> Optional[dict]:
        out = None
        for ev in self.events(job):
            if ev["ev"] in kinds:
                out = ev
        return out

    def jobs(self) -> List[str]:
        with self._lock:
            return list(self._jobs)

    def job_count(self) -> int:
        with self._lock:
            return len(self._jobs)

    def stats(self) -> dict:
        with self._lock:
            return {"jobs": len(self._jobs), "evicted": self.evicted,
                    "duplicates_dropped": self.duplicates,
                    "events": sum(len(tl.events)
                                  for tl in self._jobs.values())}

    def clear(self) -> None:
        with self._lock:
            self._jobs.clear()
            self._cycle = self._part = self._epoch = 0
            self._t = 0.0
            self._eid = 0
            self.evicted = 0
            self.duplicates = 0


# -- derived views -----------------------------------------------------------


def why(job: str) -> Optional[dict]:
    """The timeline-backed why payload: the newest audit verdict
    (when the audit ring still holds one) EXTENDED with the causal
    history the ring ages out of — the first-denied cycle and the
    timeline's own latest solve verdict, so a gang denied 200 cycles ago
    still explains itself."""
    from .audit import AUDIT
    rec = AUDIT.why(job)
    events = TIMELINE.events(job)
    solves = [ev for ev in events if ev["ev"] == "solve"]
    if rec is None and not solves:
        return None
    out = dict(rec) if rec is not None else {}
    if solves:
        denied = [ev for ev in solves if ev.get("verdict") == "denied"]
        if denied:
            out["first_denied_cycle"] = denied[0]["cycle"]
        last = solves[-1]
        out.setdefault("job", TIMELINE.timeline(job)["job"])
        out.setdefault("verdict", last.get("verdict"))
        out.setdefault("reason", last.get("reason", ""))
        out.setdefault("cycle", last["cycle"])
        out.setdefault("t", last["t"])
        out["timeline_events"] = len(events)
    return out


def job_latency(events: List[dict]) -> Dict[str, float]:
    """Per-job latency attribution from one timeline: time-to-first-bind
    (first harvested bind - arrival), admission wait (gang admission -
    arrival), ack latency (first RUNNING ack - first bind intent) and
    JCT (completion - arrival). Only the spans whose endpoints exist are
    emitted."""
    first: Dict[str, float] = {}
    for ev in events:
        first.setdefault(ev["ev"], ev["t"])
    out: Dict[str, float] = {}
    arrival = first.get("arrival")
    if arrival is None:
        return out
    if "bind" in first:
        out["ttfb_s"] = round(first["bind"] - arrival, 6)
    if "admitted" in first:
        out["admission_wait_s"] = round(first["admitted"] - arrival, 6)
    if "running" in first and "bind_intent" in first:
        out["ack_latency_s"] = round(
            first["running"] - first["bind_intent"], 6)
    if "complete" in first:
        out["jct_s"] = round(first["complete"] - arrival, 6)
    return out


def latency_classes(store: "TimelineStore") -> Dict[str, Dict[str, List[float]]]:
    """The sim report's raw material: per queue class (stamped on the
    arrival event), the lists of each latency kind across every job the
    store retains."""
    out: Dict[str, Dict[str, List[float]]] = {}
    for job in store.jobs():
        events = store.events(job)
        arrival = next((ev for ev in events if ev["ev"] == "arrival"), None)
        if arrival is None:
            continue
        cls = arrival.get("queue", "")
        lat = job_latency(events)
        bucket = out.setdefault(cls, {})
        for kind, v in lat.items():
            bucket.setdefault(kind, []).append(v)
    return out


# The process-wide store every wiring point uses (the TRACE / AUDIT
# precedent). VOLCANO_TPU_TIMELINE=0 disables at import.
TIMELINE = TimelineStore()
