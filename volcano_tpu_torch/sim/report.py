"""Per-run simulation reports: latency percentiles, utilization, and the
DRF fairness gap, split into a DECISION plane (a pure function of
trace + seed + conf — the determinism contract) and a WALL-CLOCK plane
(``pipeline_e2e_ms``, per-action latency — properties of the host the sim
ran on). ``deterministic_json`` strips the wall-clock plane so two runs
of the same trace compare byte-for-byte, and so that this package's run
compares byte-for-byte with the JAX package's: the schema, the keys and
the rounding are the same.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, Iterable, List

from ..api import TaskStatus

SCHEMA = "volcano-tpu-sim-report/v1"
_ND = 6                                     # float rounding in report JSON


def percentiles(values: Iterable[float],
                ps: Iterable[int] = (50, 95, 99)) -> Dict[str, float]:
    """Nearest-rank percentiles plus mean/max; {} when empty."""
    vs = sorted(values)
    if not vs:
        return {}
    out = {}
    for p in ps:
        ix = min(len(vs) - 1, max(0, int(round(p / 100.0 * len(vs))) - 1))
        out[f"p{p}"] = round(vs[ix], _ND)
    out["mean"] = round(sum(vs) / len(vs), _ND)
    out["max"] = round(vs[-1], _ND)
    return out


def _utilization_all(caches, field: str) -> float:
    """Aggregate utilization over one or more caches holding DISJOINT
    slices of the same cluster (federated partitions: every cache
    mirrors every node, but each accounts only its own partition's
    tasks). Capacity counts each node once (from the first cache that
    has it); usage sums across all caches. A single-cache list degrades
    to the classic per-cache reading."""
    used = total = 0.0
    seen = set()
    for cache in caches:
        for name, node in cache.nodes.items():
            if not node.ready:
                continue
            used += getattr(node.used, field)
            if name not in seen:
                seen.add(name)
                total += getattr(node.allocatable, field)
    return used / total if total else 0.0


def cpu_utilization_all(caches) -> float:
    return _utilization_all(caches, "cpu")


def mem_utilization_all(caches) -> float:
    return _utilization_all(caches, "memory")


def drf_fairness_gap_all(caches) -> float:
    """Spread of weight-normalized dominant shares across ACTIVE queues
    (queues holding allocations or pending demand): 0 is perfectly fair
    by DRF-with-weights; the gap is max - min of share_q / weight_q where
    share_q is the queue's dominant resource share of cluster capacity
    (drf.go calculate_share semantics). Inactive queues abstain — an
    empty queue's zero share is idleness, not unfairness. Accepts the
    disjoint partition caches of a federated run (jobs are homed in
    exactly one cache; capacity counts each node once), degrading to the
    classic single-cache reading for a one-element list."""
    total_cpu = total_mem = 0.0
    seen = set()
    for cache in caches:
        for name, node in cache.nodes.items():
            if not node.ready or name in seen:
                continue
            seen.add(name)
            total_cpu += node.allocatable.cpu
            total_mem += node.allocatable.memory
    if not total_cpu:
        return 0.0
    alloc: Dict[str, List[float]] = {}
    active: Dict[str, bool] = {}
    for cache in caches:
        for job in cache.jobs.values():
            cpu = mem = 0.0
            pending = False
            for t in job.tasks.values():
                if t.status in (TaskStatus.BOUND, TaskStatus.BINDING,
                                TaskStatus.RUNNING, TaskStatus.ALLOCATED):
                    cpu += t.resreq.cpu
                    mem += t.resreq.memory
                elif t.status == TaskStatus.PENDING:
                    pending = True
            q = alloc.setdefault(job.queue, [0.0, 0.0])
            q[0] += cpu
            q[1] += mem
            active[job.queue] = active.get(job.queue, False) or pending \
                or cpu > 0 or mem > 0
    shares = []
    for quid, (cpu, mem) in alloc.items():
        if not active.get(quid):
            continue
        queue = None
        for cache in caches:
            queue = cache.queues.get(quid)
            if queue is not None:
                break
        weight = max(getattr(queue, "weight", 1) or 1, 1)
        dom = max(cpu / total_cpu, mem / total_mem if total_mem else 0.0)
        shares.append(dom / weight)
    if len(shares) < 2:
        return 0.0
    return max(shares) - min(shares)


def build_report(runner, actions_ms: Dict[tuple, list],
                 wall_s: float, actions_truncated=()) -> dict:
    """Assemble the report dict from a finished SimRunner.

    ``actions_truncated`` names duration series whose observations
    outgrew the bounded in-process metrics ring during the run — their
    percentiles below cover only the newest retained window, not every
    cycle."""
    conf = runner.sched.conf
    acts = {}
    for key, vals in actions_ms.items():
        if len(key) == 2 and key[0] == "action" and vals:
            acts[key[1]] = percentiles(v / 1e3 for v in vals)  # us -> ms
    report = {
        "schema": SCHEMA,
        "scenario": runner.scenario or "trace",
        "seed": runner.seed,
        "conf_actions": list(conf.actions),
        "period_s": runner.period,
        "cycles": runner.cycles,
        "virtual_time_s": round(runner.clock.time(), _ND),
        "trace_events": len(runner.trace),
        "jobs": {
            "arrived": runner.arrived,
            "admitted": len(runner.gang_admission),
            "completed": runner.completed,
            "unfinished": runner.unfinished_jobs(),
        },
        "binds": len(runner.binder.sequence),
        "evicts": len(runner.evictor.sequence),
        "requeues": runner.requeues,
        "dead_letter": runner.dead_letter_total(),
        "action_failures": len(runner.action_failures),
        # crash/restart plane (zero on unkilled runs; deterministic from
        # kill_cycles + kill_seed, so still part of the decision plane)
        "restarts": getattr(runner, "restarts", 0),
        "double_binds": getattr(runner, "double_binds", 0),
        "journal_replayed": dict(getattr(runner, "_journal_replayed", {})),
        # HA plane: leadership transitions and the fencing gate's
        # stale-epoch rejections, deterministic from (trace, seed, kill and
        # lease-loss config); 0 for a single scheduler
        "failovers": runner.failovers,
        "fenced_rejections": runner.fencing_rejections(),
        # cross-partition reserve/transfer counters: part of EVERY report
        # ({} for a run without partitions, and for a non-contended
        # federated one: what the federated-equivalence diff checks)
        "cross_partition_reserves": runner.reserve_counts(),
        "jct_s": percentiles(runner.jct),
        "queueing_delay_s": percentiles(runner.queueing_delay),
        # time-to-first-bind in CYCLE PERIODS (the fast-admit acceptance
        # metric: < 1.0 means gangs bound between full cycles)
        "ttfb_p99_cycles": round(
            percentiles(runner.queueing_delay).get("p99", 0.0)
            / runner.period, _ND) if runner.period else 0.0,
        "gang_admission_s": percentiles(runner.gang_admission),
        "utilization": {
            "cpu_mean": round(_mean(runner.util_cpu), _ND),
            "cpu_peak": round(max(runner.util_cpu, default=0.0), _ND),
            "mem_mean": round(_mean(runner.util_mem), _ND),
        },
        "fairness": {
            "drf_gap_mean": round(_mean(runner.drf_gap), _ND),
            "drf_gap_max": round(max(runner.drf_gap, default=0.0), _ND),
        },
        # the wall-clock plane: host-dependent, excluded from the
        # determinism contract (deterministic_json strips it)
        "wallclock": {
            "pipeline_e2e_ms": percentiles(runner.pipeline_e2e_ms),
            "actions_ms": acts,
            "total_s": round(wall_s, 3),
        },
    }
    if actions_truncated:
        report["wallclock"]["actions_ms_truncated"] = \
            list(actions_truncated)
    if getattr(runner, "store_wired", False):
        # the hostile-store plane: all seeded (faults injected, the retry
        # funnel's absorption, torn-stream recoveries), so decision-plane
        # material and byte-reproducible
        report["store"] = runner.store_detail()
    if getattr(runner, "ack_chaos", False):
        # the hostile feedback plane: seeded and timed on the virtual
        # clock, so decision-plane material; only on ack-chaos runs, so a
        # fault-free report keeps its bytes
        report["feedback"] = runner.feedback_stats()
    if getattr(runner, "overload", False):
        # the overload plane: cycle-budget exhaustion and deferral, priced
        # on the deterministic cost model, so decision-plane material —
        # and only emitted on overload runs
        report["overload"] = runner.overload_stats()
    if getattr(runner, "mesh_chaos", False):
        # the mesh ladder's mechanism (seeded injector, virtual-clock
        # windows: byte-reproducible); only under --mesh-chaos, so every
        # fault-free run keeps its bytes
        report["mesh"] = runner.mesh_stats()
    if getattr(runner, "pipelined_mode", False):
        # the pipeline's mechanism, not its decisions:
        # pipelined_oracle_part strips it for the serial-oracle diff
        report["speculation"] = runner.speculation_stats()
    if getattr(runner, "fast_admit_mode", False):
        report["fast_admit"] = runner.fast_admit_stats()
    if getattr(runner, "lifecycle", False):
        # the cluster-causal plane (obs/lifecycle.py + obs/slo.py): per-class
        # latency from the job timelines and the SLO engine's burn rates at
        # the run's end. Both are pure functions of the virtual-time event
        # stream, so decision-plane material — and only emitted under
        # --lifecycle, so every run without it keeps its bytes.
        report["latency"] = runner.lifecycle_stats()
        report["slo"] = runner.slo_status()
    if getattr(runner, "elastic_gangs", False) \
            or getattr(runner, "_command_funnel", None) is not None:
        # only when the mode (or a job_command trace) is live
        report["elastic_gangs"] = runner.elastic_gang_stats()
    if runner.federated:
        totals = runner.federation_totals()
        report["federation"] = {
            "partitions": runner.federated,
            "map": runner.pmap.counts(),
            "map_version": runner.pmap.version,
            "reserves": report["cross_partition_reserves"],
            "node_transfers": totals["node_transfers"],
            "queue_moves": totals["queue_moves"],
            "failover_cycles": list(runner.failover_cycles),
            "failover_cycles_max": max(runner.failover_cycles, default=0),
        }
        if runner.store_wired:
            report["federation"]["store_backed"] = True
        if runner.rebalance:
            # load-driven queue moves, deterministic from the published
            # load signals and the virtual clock: the fed-hotspot
            # convergence witness
            report["federation"]["rebalance"] = runner.rebalance_stats()
        if runner.elastic:
            # load-driven membership: splits, merges, the partition-count
            # trajectory and the bounded per-queue depth witness, a
            # function of the published load and the virtual clock
            report["federation"]["elastic"] = runner.elastic_stats()
    elif runner.replicas:
        report["ha"] = {
            "replicas": runner.ha_replicas,
            "failover_cycles": list(runner.failover_cycles),
            "failover_cycles_max": max(runner.failover_cycles, default=0),
            "lease_losses": len(runner.lease_loss_cycles),
        }
    return report


def _mean(vals: List[float]) -> float:
    return sum(vals) / len(vals) if vals else 0.0


def terminal_accounting(report: dict) -> dict:
    """The restart-equivalence contract: the subset
    of the decision plane a killed-and-recovered run must share with an
    unkilled run of the same trace. Kills legitimately reshuffle the
    bind/evict SEQUENCE and stretch latencies; what recovery must
    preserve is the terminal accounting — every arrived gang completes,
    nothing is left behind, and no task was ever double-bound."""
    return {
        "arrived": report["jobs"]["arrived"],
        "completed": report["jobs"]["completed"],
        "unfinished": report["jobs"]["unfinished"],
        "double_binds": report.get("double_binds", 0),
    }


def oracle_part(report: dict) -> dict:
    """The decision plane minus the topology's own section: what an
    ``--ha N`` (or ``--federated N``) run of a non-contended trace must
    reproduce byte for byte
    against the single-scheduler oracle. ``failovers``,
    ``fenced_rejections`` and ``cross_partition_reserves`` stay in: a
    non-contended run reports 0, 0 and {} for them, as the oracle does."""
    part = deterministic_part(report)
    part.pop("ha", None)
    part.pop("federation", None)
    part.pop("mesh", None)
    return part


def pipelined_oracle_part(report: dict) -> dict:
    """The decision plane a ``--pipelined`` run of a conflict-free trace
    must reproduce byte for byte against the serial oracle: everything but
    the speculation and fast-admit counters, which the oracle has not."""
    part = oracle_part(report)
    part.pop("speculation", None)
    part.pop("fast_admit", None)
    return part


def deterministic_part(report: dict) -> dict:
    """The decision plane only: everything byte-reproducible from
    (trace, seed, conf)."""
    return {k: v for k, v in report.items() if k != "wallclock"}


def to_json(report: dict) -> str:
    return json.dumps(report, sort_keys=True, indent=1)


def deterministic_json(report: dict) -> str:
    """Canonical JSON of the decision plane — the byte-identity witness
    the determinism tests (and the acceptance criterion) compare."""
    return json.dumps(deterministic_part(report), sort_keys=True,
                      separators=(",", ":"))


def decision_sequence(runner) -> bytes:
    """Canonical JSON of the run's side effects in the order they reached
    the cluster: each bind as [task uid, node], each eviction's task uid.
    The decision plane counts binds and evictions; this names them, so two
    runs that bind as many pods on different nodes differ here."""
    return json.dumps({"binds": [list(b) for b in runner.binder.sequence],
                       "evicts": list(runner.evictor.sequence)},
                      separators=(",", ":")).encode()


def sequence_digest(runner) -> Dict[str, object]:
    """SHA-256 of ``decision_sequence`` with the bind and eviction
    counts."""
    return {"sha256": hashlib.sha256(decision_sequence(runner)).hexdigest(),
            "binds": len(runner.binder.sequence),
            "evicts": len(runner.evictor.sequence)}
