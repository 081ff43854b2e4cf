"""The scheduler's metrics, in process: duration series, counters, gauges
and the health verdict, under the JAX package's function names, and the
HTTP endpoint that serves them.

The series: the end-to-end, per-action and per-plugin duration series
(fed from the shell's and the framework's spans), the mark/since API the
sim's wall-clock plane reads, the queue gauges proportion publishes, the
gang plugin's unschedulable tasks and jobs, preempt's victims and
attempts, the snapshot's dirty share, the drift verifier's last pass, the
pinned tensor epochs, action failures, the dead-letter gauge, the crash-loop guard's health
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
and the batched admission front door's batch sizes, and
the node mesh's (per-device quarantines and readmissions, mid-cycle mesh
heals, the healthy-device and degradation-rung gauges), with
``health_detail()``'s sections for them.

``start_metrics_server`` serves ``/metrics`` (the Prometheus text
exposition, version 0.0.4, rendered from the in-process mirror by
``fallback_exposition``: the JAX package's path without
``prometheus_client``, and this package's only one), ``/healthz`` (200
"ok" while the shell is healthy, 503 once the crash-loop guard trips;
``?detail`` gives ``health_detail()`` as JSON), ``/debug/traces``,
``/debug/why?job=`` and ``/debug/timeline?job=``.

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
            "dead_letter_size": int(
                _gauges.get(("resync_dead_letter_size",), 0)),
            "device": dict(_health_detail.get("device",
                                              {"available": True})),
            "state_drift_total": {k[1]: v for k, v in _counters.items()
                                  if k[0] == "state_drift"},
            "journal_replayed_total": {
                k[1]: v for k, v in _counters.items()
                if k[0] == "journal_replayed"},
            # the feedback plane: the in-flight ledger's open set and the
            # watchdog's resolutions
            "inflight": dict(_health_detail.get("inflight", {"open": 0})),
            "inflight_expired_total": {
                "/".join(k[1:]): v for k, v in _counters.items()
                if k[0] == "inflight_expired"},
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


def register_device_quarantine(kind: str) -> None:
    """An attributed device fault quarantined one slot: the mesh heals
    around it."""
    _count(("device_quarantines", kind))


def register_device_readmission() -> None:
    """A quarantined slot's probe solve succeeded and it rejoined the
    mesh (the caller retires the tensor epoch)."""
    _count(("device_readmissions",))


def register_mesh_heal(trigger: str) -> None:
    """A mid-cycle mesh heal: the failing slot was quarantined and the same
    solve re-dispatched over the survivors."""
    _count(("mesh_heals", trigger))


def set_mesh_devices_healthy(healthy: int, known: int) -> None:
    """The lattice's healthy (known minus quarantined) and known slots."""
    with _lock:
        _gauges[("mesh_devices_healthy",)] = float(healthy)
        _gauges[("mesh_devices_known",)] = float(known)


def set_degradation_rung(rung: int) -> None:
    """The sharded engine's degradation-ladder rung: 0 full mesh, 1
    shrunken mesh, 2 single slot, 3 CPU placer."""
    with _lock:
        _gauges[("degradation_rung",)] = float(rung)


def mesh_counts() -> Dict[str, float]:
    """The mesh-containment counters for delta-based reporting (the sim
    report's ``mesh`` section): ``heals/<trigger>``,
    ``quarantines/<kind>``, readmissions, degraded cycles and the current
    rung and healthy-slot gauges."""
    with _lock:
        out: Dict[str, float] = {}
        for key, v in _counters.items():
            if key[0] == "mesh_heals":
                out[f"heals/{key[1]}"] = v
            elif key[0] == "device_quarantines":
                out[f"quarantines/{key[1]}"] = v
        out["readmissions"] = _counters.get(("device_readmissions",), 0)
        out["degraded_cycles"] = _counters.get(("device_degraded_cycles",),
                                               0)
        out["rung"] = _gauges.get(("degradation_rung",), 0.0)
        out["devices_healthy"] = _gauges.get(("mesh_devices_healthy",), 0.0)
        return out


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
        if detail is not None:
            _health_detail["inflight"] = dict(detail)


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


# -- the scheduling series: plugins, queues, gangs, preempt, snapshot -------

def update_plugin_duration(plugin: str, event: str, seconds: float) -> None:
    """One plugin's OnSessionOpen or OnSessionClose span, in µs."""
    with _lock:
        _durations[("plugin", plugin, event)].observe(seconds * 1e6)


def update_preemption_victims(count: int) -> None:
    """The victims of the last preemption attempt (last write wins)."""
    with _lock:
        _gauges[("preemption_victims",)] = count


def register_preemption_attempt(n: int = 1) -> None:
    _count(("preemption_attempts",), n)


def update_unschedule_task_count(job_id: str, count: int) -> None:
    """The gang plugin's close: a job's tasks short of its minimum."""
    with _lock:
        _gauges[("unschedule_tasks", job_id)] = count


def retain_unschedule_jobs(job_ids) -> None:
    """Drop the unschedule_tasks gauge of every job not in ``job_ids``:
    the gang plugin's close passes the session's jobs, so a long-lived
    process (the snapshot sidecar) keeps no gauge of a job that is gone."""
    keep = set(job_ids)
    with _lock:
        for key in [k for k in _gauges
                    if k[0] == "unschedule_tasks" and k[1] not in keep]:
            del _gauges[key]


def register_unschedule_job() -> None:
    _count(("unschedule_jobs",))


def update_queue_metrics(name: str, allocated_mcpu: float,
                         share: float = 0.0) -> None:
    """Proportion's queue gauges: the allocated CPU and the share, the
    values the JAX package's mirror keeps."""
    with _lock:
        _gauges[("queue_allocated", name)] = allocated_mcpu
        _gauges[("queue_share", name)] = share


def update_snapshot_stats(dirty_nodes: int, dirty_ratio: float) -> None:
    """Published by every snapshot: the nodes the incremental snapshot
    re-cloned and their share of the snapshot (1.0 is a full rebuild)."""
    with _lock:
        _gauges[("snapshot_dirty_nodes",)] = float(dirty_nodes)
        _gauges[("snapshot_dirty_ratio",)] = float(dirty_ratio)


def set_drift_verify_stats(drift_total: int, verify_s: float) -> None:
    """The drift verifier's last pass: entries repaired and its seconds."""
    with _lock:
        _gauges[("drift_last_verify_total",)] = float(drift_total)
        _gauges[("drift_last_verify_s",)] = float(verify_s)


def set_tensor_epochs_live(n: int) -> None:
    """Pinned persistent-tensor epochs live (a speculation's; more than
    one for long is a retire leak)."""
    with _lock:
        _gauges[("tensor_epochs_live",)] = float(n)


# -- the Prometheus text exposition -------------------------------------------

_SUBSYSTEM = "volcano"

# In-process mirror key -> Prometheus family: the key's first element maps
# to (family name, label name or a tuple of them). Keys absent here expose
# as volcano_<key0> with a generic "key" label, so no series disappears
# from a scrape.
_EXPO_GAUGES = {
    "scheduler_healthy": (f"{_SUBSYSTEM}_scheduler_healthy", None),
    "preemption_victims": (f"{_SUBSYSTEM}_pod_preemption_victims", None),
    "unschedule_tasks": (f"{_SUBSYSTEM}_unschedule_task_count", "job_id"),
    "queue_allocated": (f"{_SUBSYSTEM}_queue_allocated_milli_cpu",
                        "queue_name"),
    "queue_share": (f"{_SUBSYSTEM}_queue_share", "queue_name"),
    "snapshot_dirty_nodes": (f"{_SUBSYSTEM}_snapshot_dirty_nodes", None),
    "snapshot_dirty_ratio": (f"{_SUBSYSTEM}_snapshot_dirty_ratio", None),
    "resync_dead_letter_size": (f"{_SUBSYSTEM}_resync_dead_letter_size",
                                None),
    "device_healthy": (f"{_SUBSYSTEM}_device_healthy", None),
    "mesh_devices_healthy": (f"{_SUBSYSTEM}_mesh_devices_healthy", None),
    "mesh_devices_known": (f"{_SUBSYSTEM}_mesh_devices_known", None),
    "degradation_rung": (f"{_SUBSYSTEM}_degradation_rung", None),
    "leader": (f"{_SUBSYSTEM}_leader", None),
    "partition_leader": (f"{_SUBSYSTEM}_partition_leader", "partition"),
    "partition_count": (f"{_SUBSYSTEM}_partition_count", None),
    "tensor_epochs_live": (f"{_SUBSYSTEM}_tensor_epochs_live", None),
    "elastic_members": (f"{_SUBSYSTEM}_elastic_members", None),
    "topology_spread": (f"{_SUBSYSTEM}_topology_spread", None),
    "store_watch_staleness": (f"{_SUBSYSTEM}_store_watch_staleness", None),
    "inflight_open": (f"{_SUBSYSTEM}_inflight_open", None),
    "inflight_oldest_seconds": (f"{_SUBSYSTEM}_inflight_oldest_seconds",
                                None),
    "admission_pending_depth": (f"{_SUBSYSTEM}_admission_pending_depth",
                                None),
    "admission_pending_bytes": (f"{_SUBSYSTEM}_admission_pending_bytes",
                                None),
    "slo_compliance": (f"{_SUBSYSTEM}_slo_compliance", "slo"),
    "slo_burn_rate": (f"{_SUBSYSTEM}_slo_burn_rate", ("slo", "window")),
}
_EXPO_COUNTERS = {
    "preemption_attempts": (f"{_SUBSYSTEM}_total_preemption_attempts",
                            None),
    "unschedule_jobs": (f"{_SUBSYSTEM}_unschedule_job_count", None),
    "action_failures": (f"{_SUBSYSTEM}_action_failures_total", "action"),
    "solver_fallback": (f"{_SUBSYSTEM}_solver_fallback_total", "action"),
    "resync_dead_letter": (f"{_SUBSYSTEM}_resync_dead_letter_total", "op"),
    "snapshot_full_rebuilds": (
        f"{_SUBSYSTEM}_snapshot_full_rebuilds_total", "layer"),
    "state_drift": (f"{_SUBSYSTEM}_state_drift_total", "layer"),
    "journal_replayed": (f"{_SUBSYSTEM}_journal_replayed_total", "result"),
    "device_faults": (f"{_SUBSYSTEM}_device_faults_total", "kind"),
    "device_degraded_cycles": (
        f"{_SUBSYSTEM}_device_degraded_cycles_total", None),
    "device_quarantines": (f"{_SUBSYSTEM}_device_quarantines_total",
                           "kind"),
    "device_readmissions": (f"{_SUBSYSTEM}_device_readmissions_total",
                            None),
    "mesh_heals": (f"{_SUBSYSTEM}_mesh_heals_total", "trigger"),
    "gang_growths": (f"{_SUBSYSTEM}_gang_growths_total", None),
    "gang_shrinks": (f"{_SUBSYSTEM}_gang_shrinks_total", "reason"),
    "elastic_below_min_evictions": (
        f"{_SUBSYSTEM}_elastic_below_min_evictions_total", None),
    "fencing_rejections": (f"{_SUBSYSTEM}_fencing_rejections_total", "op"),
    "failovers": (f"{_SUBSYSTEM}_failovers_total", None),
    "cross_partition_reserves": (
        f"{_SUBSYSTEM}_cross_partition_reserves_total", "result"),
    "speculation": (f"{_SUBSYSTEM}_speculation_total", "outcome"),
    "fast_admit_gangs": (f"{_SUBSYSTEM}_fast_admit_gangs_total", None),
    "fast_admit_binds": (f"{_SUBSYSTEM}_fast_admit_binds_total", None),
    "store_retries": (f"{_SUBSYSTEM}_store_retries_total",
                      ("verb", "result")),
    "store_faults": (f"{_SUBSYSTEM}_store_faults_total", ("verb", "kind")),
    "store_watch_resumes": (f"{_SUBSYSTEM}_store_watch_resumes_total",
                            "outcome"),
    "inflight_expired": (f"{_SUBSYSTEM}_inflight_expired_total",
                         ("op", "resolution")),
    "ack_faults": (f"{_SUBSYSTEM}_ack_faults_total", "kind"),
    "feedback_acks": (f"{_SUBSYSTEM}_feedback_acks_total",
                      ("kind", "verdict")),
    "cycle_budget_exhausted": (
        f"{_SUBSYSTEM}_cycle_budget_exhausted_total", "action"),
    "deferred_actions": (f"{_SUBSYSTEM}_deferred_actions_total", None),
    "admission_backpressure": (
        f"{_SUBSYSTEM}_admission_backpressure_total", "reason"),
    "dead_letter_evicted": (f"{_SUBSYSTEM}_dead_letter_evicted_total",
                            None),
    "audit_latest_evicted": (f"{_SUBSYSTEM}_audit_latest_evicted_total",
                             None),
    "rebalance_moves": (f"{_SUBSYSTEM}_rebalance_moves_total", "result"),
    "partition_splits": (f"{_SUBSYSTEM}_partition_splits_total", "result"),
    "partition_merges": (f"{_SUBSYSTEM}_partition_merges_total", "result"),
}
# duration-series key -> (family, label name); the unit is in the name
_EXPO_DURATIONS = {
    "e2e": (f"{_SUBSYSTEM}_e2e_scheduling_latency_milliseconds", None),
    "action": (f"{_SUBSYSTEM}_action_scheduling_latency_microseconds",
               "action"),
    "plugin": (f"{_SUBSYSTEM}_plugin_scheduling_latency_microseconds",
               "plugin"),
    "admission_batch": (f"{_SUBSYSTEM}_admission_batch_size", None),
}


def _expo_escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _expo_name(raw: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in str(raw))
    return out if not out[:1].isdigit() else "_" + out


def _expo_family(spec, key: Tuple[str, ...], generic: str):
    """(family name, label spec, label values) of one mirror key."""
    if spec is None:
        label, labelv = ("key", ":".join(key[1:])) if len(key) > 1 \
            else (None, None)
        return generic, label, labelv
    name, label = spec
    if isinstance(label, tuple):
        return name, label, tuple(key[1:]) if len(key) > 1 else None
    return name, label, (key[1] if label is not None and len(key) > 1
                         else None)


def fallback_exposition() -> bytes:
    """The Prometheus text exposition (version 0.0.4) of the in-process
    mirror: gauges and counters a sample a label set, duration series as
    summary ``_count``/``_sum`` pairs (all-time, so the ring's truncation
    does not show). Named after the JAX package's function, whose bytes
    it gives on the same mirror."""
    families: Dict[str, list] = {}

    def add(name: str, mtype: str, label, labelv, value: float,
            suffix: str = "") -> None:
        fam = families.setdefault(name, [mtype])
        if isinstance(label, tuple) and labelv is not None:
            # one label a key component, padded with "" when short
            vals = list(labelv) + [""] * (len(label) - len(labelv))
            pairs = ",".join(f'{ln}="{_expo_escape(lv)}"'
                             for ln, lv in zip(label, vals))
            fam.append(f"{name}{suffix}{{{pairs}}} {float(value)}")
        elif label is not None and labelv is not None:
            fam.append(f'{name}{suffix}{{{label}="{_expo_escape(labelv)}"}}'
                       f" {float(value)}")
        else:
            fam.append(f"{name}{suffix} {float(value)}")

    with _lock:
        for key, value in sorted(_gauges.items(), key=str):
            name, label, labelv = _expo_family(
                _EXPO_GAUGES.get(key[0]), key,
                f"{_SUBSYSTEM}_{_expo_name(key[0])}")
            add(name, "gauge", label, labelv, value)
        for key, value in sorted(_counters.items(), key=str):
            name, label, labelv = _expo_family(
                _EXPO_COUNTERS.get(key[0]), key,
                f"{_SUBSYSTEM}_{_expo_name(key[0])}_total")
            add(name, "counter", label, labelv, value)
        for key, series in sorted(_durations.items(), key=str):
            spec = _EXPO_DURATIONS.get(key[0])
            if spec is None:
                name = f"{_SUBSYSTEM}_{_expo_name(key[0])}_duration"
                label = "key" if len(key) > 1 else None
            else:
                name, label = spec
            labelv = ":".join(key[1:]) if label is not None and len(key) > 1 \
                else None
            add(name, "summary", label, labelv, series.count,
                suffix="_count")
            add(name, "summary", label, labelv, series.total, suffix="_sum")

    lines = []
    for name, fam in families.items():
        lines.append(f"# HELP {name} volcano_tpu in-process mirror")
        lines.append(f"# TYPE {name} {fam[0]}")
        lines.extend(fam[1:])
    return ("\n".join(lines) + "\n").encode()


def _job_query(path: str) -> Optional[str]:
    from urllib.parse import parse_qs, urlparse
    return (parse_qs(urlparse(path).query).get("job") or [None])[0]


def _debug_body(path: str) -> Tuple[int, bytes]:
    """/debug/traces, /debug/timeline?job= and /debug/why?job=: (status,
    JSON body)."""
    import json
    from ..obs import AUDIT, TIMELINE, TRACE
    if path.startswith("/debug/traces"):
        return 200, TRACE.dump().encode()
    job = _job_query(path)
    if not job:
        return 400, json.dumps(
            {"error": "missing ?job= query parameter"}).encode()
    if path.startswith("/debug/timeline"):
        tl = TIMELINE.timeline(job)
        if tl is None:
            return 404, json.dumps(
                {"error": f"no timeline retained for job {job!r}",
                 "jobs_retained": TIMELINE.job_count()}).encode()
        return 200, json.dumps(tl, sort_keys=True).encode()
    # the timeline-backed verdict: the audit ring's, with the causal
    # history the ring ages out of
    from ..obs.lifecycle import why as timeline_why
    rec = timeline_why(job)
    if rec is None:
        return 404, json.dumps(
            {"error": f"no decision recorded for job {job!r} in the "
                      f"retained window",
             "cycles_retained": AUDIT.cycles_retained()}).encode()
    return 200, json.dumps(rec, sort_keys=True).encode()


def start_metrics_server(port: int = 8080, host: str = ""):
    """Serve /metrics, /healthz and the flight recorder's /debug endpoints
    on a daemon thread (the scheduler's --listen-address,
    cmd/scheduler/app/options.go:32,94). Returns the http.server instance;
    ``server_address[1]`` is the bound port (``port=0`` picks one)."""
    import http.server
    import json

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            status = 200
            if self.path.startswith("/healthz"):
                state, fails = health()
                if state != HEALTHY:
                    status = 503
                if "detail" in self.path:
                    body = json.dumps(health_detail(),
                                      sort_keys=True).encode()
                    ctype = "application/json"
                else:
                    body = (b"ok" if state == HEALTHY else
                            f"degraded ({fails} consecutive failed "
                            f"cycles)".encode())
                    ctype = "text/plain"
            elif self.path.startswith("/metrics"):
                body = fallback_exposition()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif self.path.startswith(("/debug/traces", "/debug/timeline",
                                       "/debug/why")):
                status, body = _debug_body(self.path)
                ctype = "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="vc-metrics").start()
    return server


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
