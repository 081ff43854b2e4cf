"""Workload trace schema: the JSONL event log a simulation replays.

One event per line, ordered by non-decreasing virtual time ``t`` (seconds
from simulation start). Kinds and their payloads:

- ``queue_add``   {name, weight} — queue created (must precede arrivals
  into it; generators emit all queues at t=0).
- ``node_add``    {name, cpu_milli, mem, pods, gpus} — node joins.
- ``node_drain``  {name} — cordon: the node stops receiving placements
  (dropped from snapshots) but its running tasks run to completion.
- ``node_restore`` {name} — a drained node rejoins scheduling.
- ``node_fail``   {name} — the node dies: it leaves the cluster and every
  task on it is lost; lost tasks re-queue PENDING and their gang must
  re-admit (the job restarts, per gang semantics).
- ``job_arrival`` {name, queue, priority, tasks, min_available, cpu_milli,
  mem, gpus, duration} — a gang of ``tasks`` identical members arrives;
  it runs for ``duration`` virtual seconds once admitted
  (``min_available`` members placed), then completes.
- ``job_complete`` {name} — explicit completion (recorded traces); jobs
  without one complete ``duration`` seconds after admission.
- ``job_command`` {name, verb[, value]} — an elastic-gang lifecycle verb
  (``suspend`` / ``resume`` / ``scale``; ``scale`` carries the new
  desired member count in ``value``) submitted through the journaled
  Command funnel and consumed at the next cycle boundary.

Two payload keys are optional: ``job_arrival`` may carry ``desired``
(elastic gang: grow toward this member count; default = rigid gang) and
``node_add`` may carry ``zone`` (the node's ``volcano.sh/topology-zone``
label; default = unzoned).

The schema is flat and uniform-per-gang on purpose: it round-trips
losslessly through JSONL (`load_trace(write_trace(t)) == t`), and the
determinism tests treat the byte identity of a re-serialized trace as the
replay contract's precondition.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List

KINDS = ("queue_add", "node_add", "node_drain", "node_restore", "node_fail",
         "job_arrival", "job_complete", "job_command")

# required payload keys per kind (beyond t/kind); extra keys are rejected
# so schema drift fails at load time, not as a silently ignored field
_REQUIRED: Dict[str, tuple] = {
    "queue_add": ("name", "weight"),
    "node_add": ("name", "cpu_milli", "mem", "pods", "gpus"),
    "node_drain": ("name",),
    "node_restore": ("name",),
    "node_fail": ("name",),
    "job_arrival": ("name", "queue", "priority", "tasks", "min_available",
                    "cpu_milli", "mem", "gpus", "duration"),
    "job_complete": ("name",),
    "job_command": ("name", "verb"),
}

# optional payload keys per kind — absent in every pre-elastic trace, so
# old traces round-trip byte-identically
_OPTIONAL: Dict[str, tuple] = {
    "node_add": ("zone",),
    "job_arrival": ("desired",),
    "job_command": ("value",),
}


@dataclass(frozen=True)
class TraceEvent:
    """One trace line: virtual time, kind, and the kind's payload."""

    t: float
    kind: str
    data: Dict = field(default_factory=dict)

    def to_line(self) -> str:
        return json.dumps({"t": self.t, "kind": self.kind, **self.data},
                          sort_keys=True)

    @staticmethod
    def from_line(line: str) -> "TraceEvent":
        raw = json.loads(line)
        t = raw.pop("t")
        kind = raw.pop("kind")
        return TraceEvent(t=float(t), kind=kind, data=raw)

    def __post_init__(self):
        if self.kind not in _REQUIRED:
            raise ValueError(f"unknown trace event kind {self.kind!r} "
                             f"(known: {KINDS})")
        want = set(_REQUIRED[self.kind])
        got = set(self.data)
        extra = got - want - set(_OPTIONAL.get(self.kind, ()))
        if (want - got) or extra:
            raise ValueError(
                f"{self.kind} event payload mismatch at t={self.t}: "
                f"missing {sorted(want - got)}, unexpected {sorted(extra)}")
        if self.t < 0:
            raise ValueError(f"negative event time {self.t}")


def validate_trace(events: Iterable[TraceEvent]) -> List[TraceEvent]:
    """Check time ordering and referential integrity (arrivals name known
    queues, node/job lifecycle events name previously-added objects).
    Returns the events as a list."""
    out: List[TraceEvent] = []
    last_t = 0.0
    queues, nodes, jobs = set(), set(), set()
    for ev in events:
        if ev.t < last_t:
            raise ValueError(f"trace not time-ordered: {ev.kind} at {ev.t} "
                             f"after {last_t}")
        last_t = ev.t
        name = ev.data.get("name")
        if ev.kind == "queue_add":
            queues.add(name)
        elif ev.kind == "node_add":
            if name in nodes:
                raise ValueError(f"duplicate node_add {name!r}")
            nodes.add(name)
        elif ev.kind in ("node_drain", "node_restore", "node_fail"):
            if name not in nodes:
                raise ValueError(f"{ev.kind} for unknown node {name!r}")
            if ev.kind == "node_fail":
                nodes.discard(name)
        elif ev.kind == "job_arrival":
            if ev.data["queue"] not in queues:
                raise ValueError(f"job {name!r} arrives into unknown queue "
                                 f"{ev.data['queue']!r}")
            if name in jobs:
                raise ValueError(f"duplicate job_arrival {name!r}")
            if ev.data["tasks"] < 1 or not (
                    1 <= ev.data["min_available"] <= ev.data["tasks"]):
                raise ValueError(f"job {name!r}: bad gang shape "
                                 f"{ev.data['tasks']}/{ev.data['min_available']}")
            jobs.add(name)
        elif ev.kind == "job_complete":
            if name not in jobs:
                raise ValueError(f"job_complete for unknown job {name!r}")
        elif ev.kind == "job_command":
            if name not in jobs:
                raise ValueError(f"job_command for unknown job {name!r}")
            verb = ev.data["verb"]
            if verb not in ("suspend", "resume", "scale"):
                raise ValueError(f"job_command {name!r}: unknown verb "
                                 f"{verb!r}")
            if verb == "scale" and "value" not in ev.data:
                raise ValueError(f"job_command {name!r}: scale needs a "
                                 f"value")
        out.append(ev)
    return out


def write_trace(path: str, events: Iterable[TraceEvent]) -> int:
    """Write one JSONL line per event; returns the event count."""
    n = 0
    with open(path, "w") as f:
        for ev in events:
            f.write(ev.to_line() + "\n")
            n += 1
    return n


def load_trace(path: str) -> List[TraceEvent]:
    """Load and validate a JSONL trace file."""
    events = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                events.append(TraceEvent.from_line(line))
            except (KeyError, ValueError, json.JSONDecodeError) as exc:
                raise ValueError(f"{path}:{i}: bad trace line: {exc}") from exc
    return validate_trace(events)
