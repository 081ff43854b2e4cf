"""The scheduler's metrics, in process: duration series, counters, gauges
and the health verdict, under the JAX package's function names.

This is the subset the serial cycle, the cache and the sim read and
write: the end-to-end and per-action duration series (fed from the
shell's spans), the mark/since API the sim's wall-clock plane reads,
action failures, the dead-letter gauge, the crash-loop guard's health
verdict, the feedback-plane and journal counters, and the incremental
snapshot's (full rebuilds by layer, state drift by layer), the
elastic gangs' grows, shrinks, below-min witness and gauges, and the
flight recorder's (the SLO compliance and burn-rate gauges, the audit's
bounded-map evictions), device containment's (solver fallbacks, device
faults by kind, degraded cycles, the cool-down state), and the store
boundary's (retries, injected faults, watch resumes, ack faults), and
the HA control plane's (the leader gauge, fencing rejections by
operation, failovers), the overload plane's (admission backpressure by
reason, the pending depth), and the federated control plane's (the
per-partition leader gauge, cross-partition reserves, the rebalancer's
decisions, the partition count, elastic membership's splits and merges)
and the batched admission front door's batch sizes, with
``health_detail()``'s sections for them. There is no Prometheus
exposition yet.

``solver_trace`` marks a device solve as a named range in a
``torch.profiler`` trace, behind the JAX package's own switch
(``VOLCANO_TPU_JAX_PROFILE``, which there hooks ``jax.profiler``).
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
from typing import Dict, Optional, Tuple

# Each duration series is RING-BOUNDED (a long-running scheduler must not
# grow a list forever at one observation per cycle): the deque keeps the
# newest ``cap`` observations while ``count``/``total`` keep the all-time
# view the mark/since API needs. VOLCANO_TPU_METRICS_RING overrides the cap.
DEFAULT_DURATION_CAP = 4096


def _duration_cap() -> int:
    try:
        return max(1, int(os.environ.get("VOLCANO_TPU_METRICS_RING",
                                         DEFAULT_DURATION_CAP)))
    except ValueError:
        return DEFAULT_DURATION_CAP


class _Series:
    __slots__ = ("data", "count", "total")

    def __init__(self):
        self.data = collections.deque(maxlen=_duration_cap())
        self.count = 0              # all-time observations (never truncated)
        self.total = 0.0

    def observe(self, v: float) -> None:
        self.data.append(v)
        self.count += 1
        self.total += v


_lock = threading.Lock()
_durations: Dict[Tuple[str, ...], _Series] = collections.defaultdict(_Series)
_gauges: Dict[Tuple[str, ...], float] = {}
_counters: Dict[Tuple[str, ...], float] = collections.defaultdict(float)

# scheduler health: "healthy" | "degraded", plus the consecutive failed
# cycle count the crash-loop guard (Scheduler.run) publishes
HEALTHY = "healthy"
DEGRADED = "degraded"
_health = {"state": HEALTHY, "consecutive_failures": 0}
# structured sections published by their owners (the SLO engine's last
# evaluation) for health_detail()
_health_detail: Dict[str, object] = {}


def _count(key: Tuple[str, ...], n: float = 1) -> None:
    with _lock:
        _counters[key] += n


# -- durations ---------------------------------------------------------------

def update_e2e_duration(seconds: float) -> None:
    """One cycle's schedule span (open_session to close_session), in ms."""
    with _lock:
        _durations[("e2e",)].observe(seconds * 1e3)


def update_action_duration(action: str, seconds: float) -> None:
    """One action's span, in µs."""
    with _lock:
        _durations[("action", action)].observe(seconds * 1e6)


def local_durations() -> Dict[Tuple[str, ...], list]:
    """The retained window of every duration series."""
    with _lock:
        return {k: list(v.data) for k, v in _durations.items()}


def local_counters() -> Dict[Tuple[str, ...], float]:
    with _lock:
        return dict(_counters)


def durations_mark() -> Dict[Tuple[str, ...], int]:
    """The ALL-TIME observation count of every duration series. Pair with
    durations_since to read only what was recorded after the mark (how the
    sim attributes per-action latency to one run). Marks are counts, not
    list indices, so ring truncation cannot misattribute old samples."""
    with _lock:
        return {k: v.count for k, v in _durations.items()}


def durations_since(mark: Dict[Tuple[str, ...], int]
                    ) -> Dict[Tuple[str, ...], list]:
    """Every series' observations recorded after ``mark`` (series born
    since are returned whole): ms for ("e2e",), µs for ("action", name).
    If more arrived than the ring keeps, the newest survivors are
    returned — never pre-mark samples."""
    with _lock:
        out: Dict[Tuple[str, ...], list] = {}
        for k, v in _durations.items():
            new = v.count - mark.get(k, 0)
            if new <= 0:
                out[k] = []
            else:
                data = list(v.data)
                out[k] = data[-new:] if new < len(data) else data
        return out


def reset_local() -> None:
    with _lock:
        _durations.clear()
        _gauges.clear()
        _counters.clear()
        _health_detail.clear()
        _health["state"] = HEALTHY
        _health["consecutive_failures"] = 0


# -- health and failures -----------------------------------------------------

def set_health(state: str, consecutive_failures: int = 0) -> None:
    with _lock:
        _health["state"] = state
        _health["consecutive_failures"] = consecutive_failures
        _gauges[("scheduler_healthy",)] = 1.0 if state == HEALTHY else 0.0


def health() -> Tuple[str, int]:
    with _lock:
        return _health["state"], _health["consecutive_failures"]


def health_detail() -> dict:
    """The structured health payload, the JAX package's sections that
    this package feeds: the shell's verdict, the device cool-down's state
    (DeviceHealth publishes it on every transition), the store boundary's,
    the HA role (this replica's role, its fencing epoch, the stale-epoch
    writes the fencing gate stopped and the failovers), the federated
    control plane's
    (per-partition leadership, cross-partition reserves, the partition
    count), the overload plane's (budget exhaustion, backpressure, the
    bounded sets' evictions, the rebalancer) and the SLO engine's last
    published evaluation."""
    with _lock:
        fenced = {k[1]: v for k, v in _counters.items()
                  if k[0] == "fencing_rejections"}
        return {
            "state": _health["state"],
            "consecutive_failures": _health["consecutive_failures"],
            "device": dict(_health_detail.get("device",
                                              {"available": True})),
            # the store boundary: the retry funnel's and the watch
            # streams' state pushed by the store world, and the totals
            "store": dict(_health_detail.get("store", {"wired": False})),
            "store_faults_total": {
                "/".join(k[1:]): v for k, v in _counters.items()
                if k[0] == "store_faults"},
            "store_retries_total": {
                "/".join(k[1:]): v for k, v in _counters.items()
                if k[0] == "store_retries"},
            # the HA role: which role this replica is in, its fencing
            # epoch, and the stale-epoch writes the fencing gate stopped
            "leader": dict(_health_detail.get("leader",
                                              {"leading": False,
                                               "role": "standalone",
                                               "epoch": 0})),
            "fencing_rejections_total": fenced,
            "failovers_total": _counters.get(("failovers",), 0),
            # federation: the per-partition leadership and ownership
            # entries PartitionMember publishes, the cross-partition
            # reserve counters and the live partition count
            "federation": dict(_health_detail.get("federation",
                                                  {"enabled": False})),
            "cross_partition_reserves_total": {
                k[1]: v for k, v in _counters.items()
                if k[0] == "cross_partition_reserves"},
            "partition_count": int(_gauges.get(("partition_count",), 0)),
            # elastic membership: the split and merge outcomes; each
            # partition's own state lives under federation.elastic
            "partition_splits_total": {
                k[1]: v for k, v in _counters.items()
                if k[0] == "partition_splits"},
            "partition_merges_total": {
                k[1]: v for k, v in _counters.items()
                if k[0] == "partition_merges"},
            "overload": _overload_detail_locked(),
            # the SLO plane: the engine's last published evaluation
            # (compliance + per-window burn rates)
            "slo": [dict(obj) for obj in _health_detail.get("slo", [])],
        }


def _overload_detail_locked() -> dict:
    """Caller holds _lock: health_detail()'s ``overload`` section — cycle
    budget exhaustion, admission backpressure, the bounded sets' evictions
    (each a warning: state was dropped to stay bounded) and the
    rebalancer's state."""
    exhausted = {k[1]: v for k, v in _counters.items()
                 if k[0] == "cycle_budget_exhausted"}
    dl_evicted = int(_counters.get(("dead_letter_evicted",), 0))
    audit_evicted = int(_counters.get(("audit_latest_evicted",), 0))
    warnings = []
    if dl_evicted:
        warnings.append(
            f"dead_letter_evicted={dl_evicted}: the bounded dead-letter "
            f"set overflowed and dropped its oldest side effects — "
            f"redrive cannot recover them; investigate the failing path")
    if audit_evicted:
        warnings.append(
            f"audit_latest_evicted={audit_evicted}: decision-audit "
            f"records were evicted under job-churn pressure; why() may "
            f"miss old jobs")
    return {
        "cycle_budget_exhausted_total": exhausted,
        "deferred_actions_total": int(
            _counters.get(("deferred_actions",), 0)),
        "backpressure_total": {k[1]: v for k, v in _counters.items()
                               if k[0] == "admission_backpressure"},
        "admission_pending_depth": int(
            _gauges.get(("admission_pending_depth",), 0)),
        "dead_letter_evicted_total": dl_evicted,
        "audit_latest_evicted_total": audit_evicted,
        "rebalance": dict(_health_detail.get("rebalance", {})),
        "warnings": warnings,
    }


def register_solver_fallback(action: str) -> None:
    """A batched device solve failed on a fault the containment contract
    admits and the cycle completed through the sequential placer."""
    _count(("solver_fallback", action))


def register_device_degraded_cycle() -> None:
    """An allocate cycle ran on the sequential placer because the device
    cool-down window was open."""
    _count(("device_degraded_cycles",))


def register_device_fault(kind: str) -> None:
    """A device fault (oom|device_lost|xla|slow_solve|...) was classified
    and fed into the cool-down state machine."""
    _count(("device_faults", kind))


def set_device_health(available: bool, detail: Optional[dict] = None
                      ) -> None:
    """Publish the device cool-down state (DeviceHealth pushes it on every
    transition); ``detail`` is health_detail()'s ``device`` section."""
    with _lock:
        _gauges[("device_healthy",)] = 1.0 if available else 0.0
        _health_detail["device"] = dict(detail) if detail else {
            "available": available}


def containment_counts() -> Dict[str, float]:
    """The containment counters, flat: ``solver_fallback/<action>``,
    ``device_faults/<kind>`` and ``device_degraded_cycles``."""
    with _lock:
        return {"/".join(k): v for k, v in _counters.items()
                if k[0] in ("solver_fallback", "device_faults",
                            "device_degraded_cycles")}


# -- the store boundary ------------------------------------------------------

def register_store_retry(verb: str, result: str) -> None:
    """One store verb attempt through the retrying transport settled with
    ``result`` (ok|retry|exhausted)."""
    _count(("store_retries", verb, result))


def register_store_fault(verb: str, kind: str) -> None:
    """A fault (transient|conflict|latency|torn) was injected or observed
    at the store boundary on ``verb``."""
    _count(("store_faults", verb, kind))


def register_watch_resume(outcome: str) -> None:
    """A torn watch stream recovered: ``resume`` (backlog replay) or
    ``relist`` (410 Gone)."""
    _count(("store_watch_resumes", outcome))


def set_store_watch_staleness(lag: int) -> None:
    with _lock:
        _gauges[("store_watch_staleness",)] = float(lag)


def set_store_detail(detail: dict) -> None:
    """Publish health_detail()'s ``store`` section."""
    with _lock:
        _health_detail["store"] = dict(detail)


def store_counts() -> Dict[str, Dict[str, float]]:
    """The store-boundary counters, grouped."""
    with _lock:
        return {
            "retries": {"/".join(k[1:]): v for k, v in _counters.items()
                        if k[0] == "store_retries"},
            "faults": {"/".join(k[1:]): v for k, v in _counters.items()
                       if k[0] == "store_faults"},
            "watch_resumes": {k[1]: v for k, v in _counters.items()
                              if k[0] == "store_watch_resumes"},
        }


def register_ack_fault(kind: str) -> None:
    """The seeded ack chaos harness injected one feedback-plane fault
    (delay|drop|duplicate|reorder|stale)."""
    _count(("ack_faults", kind))


def set_leader(leading: bool, role: str = "", epoch: int = 0) -> None:
    """Publish this replica's leadership state (the shell's HA gate calls
    it on every role transition and each gated cycle); role and epoch
    land in health_detail() under ``leader``."""
    with _lock:
        _gauges[("leader",)] = 1.0 if leading else 0.0
        _health_detail["leader"] = {"leading": bool(leading),
                                    "role": role, "epoch": int(epoch)}


def register_fencing_rejection(op: str) -> None:
    """The fencing gate rejected a stale-epoch executor operation: a
    deposed leader tried to mutate cluster state and was stopped."""
    _count(("fencing_rejections", op))


def register_failover() -> None:
    """A replica took over a foreign or lost lease and resumed
    scheduling."""
    _count(("failovers",))


def set_partition_leader(partition: int, leading: bool, epoch: int = 0,
                         detail: Optional[dict] = None) -> None:
    """Publish a federation partition's leadership state: the per-partition
    gauge and that partition's entry of health_detail()'s ``federation``
    section. Each partition member publishes its own entry; entries merge
    by partition id."""
    with _lock:
        _gauges[("partition_leader", str(partition))] = \
            1.0 if leading else 0.0
        fed = _health_detail.setdefault("federation", {"enabled": True})
        fed["enabled"] = True
        entry = {"leading": bool(leading), "epoch": int(epoch)}
        if detail:
            entry.update(detail)
        fed[str(partition)] = entry


def register_cross_partition_reserve(result: str, n: int = 1) -> None:
    """A cross-partition reserve/transfer protocol step settled with the
    given result (requested|granted|rejected|expired|...)."""
    _count(("cross_partition_reserves", result), n)


def register_rebalance_move(result: str) -> None:
    """One load-driven rebalancer decision settled
    (result=moved|refused|abstained)."""
    _count(("rebalance_moves", result))


def set_rebalance_detail(partition: int, detail: dict) -> None:
    """Publish one partition's rebalancer state into health_detail()'s
    ``overload.rebalance`` section."""
    with _lock:
        _health_detail.setdefault("rebalance", {})[str(partition)] = \
            dict(detail)


def set_partition_count(n: int) -> None:
    """Publish the live federation partition count."""
    with _lock:
        _gauges[("partition_count",)] = float(n)
        fed = _health_detail.setdefault("federation", {"enabled": True})
        fed["partition_count"] = int(n)


def register_partition_split(result: str) -> None:
    """One elastic split decision settled (result=executed|refused)."""
    _count(("partition_splits", result))


def register_partition_merge(result: str) -> None:
    """One elastic merge step settled (result=begun|completed|refused)."""
    _count(("partition_merges", result))


def set_elastic_detail(partition: int, detail: dict) -> None:
    """Publish one partition's elastic-membership state into
    health_detail()'s ``federation.elastic`` section, which ``vcctl
    federation elastic-status`` reads."""
    with _lock:
        fed = _health_detail.setdefault("federation", {"enabled": True})
        fed.setdefault("elastic", {})[str(partition)] = dict(detail)


def observe_admission_batch(size: int) -> None:
    """One batched admission submit of ``size`` jobs went through the
    validate-then-single-store-write path
    (``webhooks/admission.py::submit_job_batch``)."""
    with _lock:
        _durations[("admission_batch",)].observe(float(size))


def register_action_failure(action: str) -> None:
    """An action (or the resync pass) raised inside run_once and was
    isolated."""
    _count(("action_failures", action))


def register_cycle_budget_exhausted(action: str) -> None:
    _count(("cycle_budget_exhausted", action))


def register_deferred_actions(n: int) -> None:
    _count(("deferred_actions",), n)


def register_backpressure(reason: str, n: int = 1) -> None:
    """The admission front door refused work under its bounded
    pending-work budget (reason=queue_depth|bytes|priority_shed)."""
    _count(("admission_backpressure", reason), n)


def set_admission_pending(depth: int, nbytes: float) -> None:
    """Published by the admission budget on every charge and credit: the
    accepted-but-unscheduled work the front door carries."""
    with _lock:
        _gauges[("admission_pending_depth",)] = float(depth)
        _gauges[("admission_pending_bytes",)] = float(nbytes)


# -- resync queue, journal, feedback plane -----------------------------------

def set_dead_letter_size(size: int) -> None:
    with _lock:
        _gauges[("resync_dead_letter_size",)] = float(size)


def dead_letter_size() -> int:
    with _lock:
        return int(_gauges.get(("resync_dead_letter_size",), 0))


def register_dead_letter(op: str) -> None:
    _count(("resync_dead_letter", op))


def register_dead_letter_evicted(n: int = 1) -> None:
    _count(("dead_letter_evicted",), n)


def register_journal_replay(result: str, n: int = 1) -> None:
    _count(("journal_replayed", result), n)


def register_inflight_expired(op: str, resolution: str) -> None:
    _count(("inflight_expired", op, resolution))


def set_inflight_stats(open_count: int, oldest_s: float,
                       detail=None) -> None:
    with _lock:
        _gauges[("inflight_open",)] = float(open_count)
        _gauges[("inflight_oldest_seconds",)] = float(oldest_s)


def register_feedback_ack(kind: str, verdict: str) -> None:
    _count(("feedback_acks", kind, verdict))


# -- incremental snapshot and persistent tensors ------------------------------

def register_snapshot_full_rebuild(layer: str) -> None:
    """A snapshot (layer "clone") or a persistent-tensor refresh (layer
    "tensor") rebuilt everything: expected at start-up and after bulk
    mutation; a steady stream of these is a fallback storm."""
    _count(("snapshot_full_rebuilds", layer))


def register_state_drift(layer: str, n: int = 1) -> None:
    """The shadow verifier found ``n`` drifted entries in ``layer``
    (node, job or tensor) and repaired them."""
    _count(("state_drift", layer), n)


# -- the pipelined cycle and fast admit -------------------------------------

def register_speculation(outcome: str) -> None:
    """One commit-boundary verdict of the pipelined cycle: ``hit`` (the
    speculative session promoted), ``partial`` (the speculative solve
    replayed onto a fresh session) or ``conflict`` (speculation discarded,
    the cycle re-solved serially). The sim's report reads these."""
    _count(("speculation", outcome))


def speculation_counts() -> Dict[str, float]:
    """The speculation verdicts so far, {outcome: n}; take a before/after
    delta for one run's."""
    with _lock:
        return {k[1]: v for k, v in _counters.items()
                if k[0] == "speculation"}


def register_fast_admit(gangs: int, binds: int) -> None:
    with _lock:
        _counters[("fast_admit_gangs",)] += gangs
        _counters[("fast_admit_binds",)] += binds


def fast_admit_counts() -> Dict[str, float]:
    with _lock:
        return {"gangs": _counters.get(("fast_admit_gangs",), 0.0),
                "binds": _counters.get(("fast_admit_binds",), 0.0)}


# -- elastic gangs ------------------------------------------------------------

def set_elastic_members(n: int) -> None:
    """The bound above-min members across elastic gangs, as the
    grow-shrink stage left them."""
    with _lock:
        _gauges[("elastic_members",)] = float(n)


def register_gang_growth(n: int = 1) -> None:
    """The grow-shrink stage placed ``n`` elastic members beyond
    admission (toward desired)."""
    _count(("gang_growths",), n)


def register_gang_shrink(reason: str, n: int = 1) -> None:
    """An elastic decision evicted ``n`` gang members
    (reason=scale|pressure|suspend)."""
    _count(("gang_shrinks", reason), n)


def set_topology_spread(n: int) -> None:
    """The multi-member gangs spanning more than one topology zone."""
    with _lock:
        _gauges[("topology_spread",)] = float(n)


def register_below_min_eviction(n: int = 1) -> None:
    """An eviction took an elastic gang below min outside a full-gang
    decision: the never-below-min witness, expected 0."""
    _count(("elastic_below_min_evictions",), n)


def elastic_counts() -> Dict[str, float]:
    """The elastic-gang outcomes so far: ``grows``, ``shrink/<reason>``
    and ``below_min``; the sim takes a before/after delta for one run's."""
    with _lock:
        out: Dict[str, float] = {}
        for k, v in _counters.items():
            if k[0] == "gang_growths":
                out["grows"] = out.get("grows", 0.0) + v
            elif k[0] == "gang_shrinks":
                out[f"shrink/{k[1]}"] = v
            elif k[0] == "elastic_below_min_evictions":
                out["below_min"] = v
        return out


# -- the flight recorder ------------------------------------------------------

def set_slo_status(status) -> None:
    """Publish one SLO-engine evaluation (obs/slo.py): the
    ``slo_compliance{slo}`` / ``slo_burn_rate{slo,window}`` gauges plus
    the ``slo`` section of health_detail(). Replaces the previous
    evaluation wholesale — objectives that disappeared (a per-class
    expansion whose class drained away) must not linger as stale
    samples."""
    with _lock:
        for k in [k for k in _gauges
                  if k[0] in ("slo_compliance", "slo_burn_rate")]:
            del _gauges[k]
        for obj in status:
            name = str(obj.get("slo", ""))
            _gauges[("slo_compliance", name)] = float(
                obj.get("compliance", 1.0))
            for window, rate in (obj.get("burn_rate") or {}).items():
                _gauges[("slo_burn_rate", name, str(window))] = float(rate)
        _health_detail["slo"] = [dict(obj) for obj in status]


def local_gauges() -> Dict[Tuple[str, ...], float]:
    with _lock:
        return dict(_gauges)


def register_audit_evicted(n: int = 1) -> None:
    """The decision audit's per-live-job map evicted its oldest records
    to stay bounded under pathological job-churn cardinality."""
    _count(("audit_latest_evicted",), n)


# -- device profiling --------------------------------------------------------

_profile_lock = threading.Lock()
_profiler = None


def solver_trace(name: str):
    """A ``torch.profiler`` range around a device solve, so the solve
    shows up by name in a trace. Enabled by VOLCANO_TPU_JAX_PROFILE=1 (the
    switch the JAX package reads for the same hook); with
    VOLCANO_TPU_JAX_PROFILE_DIR set, the first annotated solve also starts
    a profiler capture that is exported there as a Chrome trace at
    interpreter exit."""
    if not os.environ.get("VOLCANO_TPU_JAX_PROFILE"):
        return contextlib.nullcontext()
    import torch
    trace_dir = os.environ.get("VOLCANO_TPU_JAX_PROFILE_DIR")
    global _profiler
    start = False
    with _profile_lock:
        if trace_dir and _profiler is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            _profiler = torch.profiler.profile(activities=acts)
            start = True
    if start:
        import atexit
        _profiler.start()

        def _stop(prof=_profiler, out=trace_dir):
            prof.stop()
            os.makedirs(out, exist_ok=True)
            prof.export_chrome_trace(os.path.join(out, "solve_trace.json"))
        atexit.register(_stop)
    return torch.profiler.record_function(name)
