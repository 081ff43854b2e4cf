"""Seeded synthetic workload generators and the named scenario catalog.

Every generator is a pure function of its parameters and ``seed`` — the
same call produces the byte-identical trace, which is what makes
"same trace + seed => identical report" a testable contract (sim/runner).

The cluster-trace literature these mirror: Poisson arrivals with
heavy-tailed (bounded-Pareto) service times and mixed gang sizes are the
standard shape for scheduler evaluation (Gavel replays policy decisions
over such traces, arxiv 2008.09213; Tesserae evaluates placement the same
way, arxiv 2508.04953). ``trace_from_cache`` emits any synthetic BASELINE
world (cache/synthetic.py) as the degenerate all-at-t0 case.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import TraceEvent, validate_trace

GI = 1 << 30


def _round(x: float, nd: int = 3) -> float:
    return round(float(x), nd)


def _pareto(rng: random.Random, mean: float, alpha: float,
            cap: float) -> float:
    """Bounded Pareto service time with the given mean: heavy-tailed
    durations (a few long jobs dominate machine-time) capped so a single
    sample cannot stretch the simulated horizon unboundedly."""
    xm = mean * (alpha - 1.0) / alpha        # Pareto mean = alpha*xm/(alpha-1)
    u = rng.random()
    return min(xm / ((1.0 - u) ** (1.0 / alpha)), cap)


def synthetic_trace(
        n_jobs: int = 200,
        n_nodes: int = 24,
        *,
        seed: int = 0,
        arrival_rate: float = 4.0,
        duration_mean: float = 6.0,
        duration_cap: float = 60.0,
        tail_alpha: float = 1.8,
        gang_sizes: Sequence[Tuple[int, float]] = ((1, 0.5), (2, 0.3),
                                                   (4, 0.15), (8, 0.05)),
        queues: Sequence[Tuple[str, int]] = (("q1", 3), ("q2", 2),
                                             ("q3", 1)),
        queue_demand: Optional[Sequence[float]] = None,
        cpu_choices: Sequence[int] = (500, 1000, 1500, 2000),
        mem_choices: Sequence[int] = (GI, 3 * GI // 2, 2 * GI),
        priority_choices: Sequence[int] = tuple(range(11)),
        node_cpu_milli: int = 32000,
        node_mem: int = 128 * GI,
        node_pods: int = 110,
        gpus_per_node: int = 0,
        gpus_per_task: int = 0,
        burst_every: float = 0.0,
        burst_size: int = 0,
        extra_events: Sequence[TraceEvent] = (),
) -> List[TraceEvent]:
    """Poisson arrivals, bounded-Pareto durations, mixed gang sizes,
    multi-queue skew.

    ``queue_demand`` weights which queue each arrival lands in (defaults
    to the queue weights themselves — demand proportional to entitlement;
    pass the REVERSE to put the most load on the least-deserving queue,
    which is what drives reclaim). ``burst_every``/``burst_size`` overlay
    synchronized arrival bursts on the Poisson process. ``extra_events``
    splices pre-built events (node drain/fail/restore, hand-built
    arrival waves) into the timeline."""
    rng = random.Random(seed)
    events: List[TraceEvent] = []
    for name, weight in queues:
        events.append(TraceEvent(0.0, "queue_add",
                                 {"name": name, "weight": int(weight)}))
    for i in range(n_nodes):
        events.append(TraceEvent(0.0, "node_add", {
            "name": f"node-{i:05d}", "cpu_milli": int(node_cpu_milli),
            "mem": int(node_mem), "pods": int(node_pods),
            "gpus": int(gpus_per_node)}))

    sizes = [s for s, _ in gang_sizes]
    size_w = [w for _, w in gang_sizes]
    qnames = [n for n, _ in queues]
    demand = list(queue_demand) if queue_demand is not None \
        else [w for _, w in queues]

    arrivals: List[TraceEvent] = []
    t = 0.0
    next_burst = burst_every if burst_every > 0 else float("inf")

    def arrive(j: int, at: float) -> TraceEvent:
        size = rng.choices(sizes, size_w)[0]
        return TraceEvent(_round(at), "job_arrival", {
            "name": f"job-{j:06d}",
            "queue": rng.choices(qnames, demand)[0],
            "priority": rng.choice(list(priority_choices)),
            "tasks": size,
            "min_available": size,
            "cpu_milli": rng.choice(list(cpu_choices)),
            "mem": rng.choice(list(mem_choices)),
            "gpus": int(gpus_per_task),
            "duration": _round(_pareto(rng, duration_mean, tail_alpha,
                                       duration_cap))})

    j = 0
    while j < n_jobs:
        t += rng.expovariate(arrival_rate)
        if t >= next_burst:
            # a synchronized burst lands at the burst tick, then the
            # Poisson stream resumes from it
            for _ in range(min(burst_size, n_jobs - j)):
                arrivals.append(arrive(j, next_burst))
                j += 1
            t = next_burst
            next_burst += burst_every
            continue
        arrivals.append(arrive(j, t))
        j += 1

    merged = sorted(arrivals + list(extra_events),
                    key=lambda ev: (ev.t, ev.kind, ev.data.get("name", "")))
    return validate_trace(events + merged)


def trace_from_cache(cache, duration: float = 30.0) -> List[TraceEvent]:
    """Emit a synthetic cache world (cache/synthetic.baseline_config) as
    the degenerate trace: every queue/node/gang materializes at t=0 and
    every gang runs ``duration`` once admitted. Only all-pending worlds
    convert — pre-placed running tasks have no arrival-event analogue."""
    events: List[TraceEvent] = []
    for q in cache.queues.values():
        events.append(TraceEvent(0.0, "queue_add",
                                 {"name": q.name, "weight": int(q.weight)}))
    for n in cache.nodes.values():
        events.append(TraceEvent(0.0, "node_add", {
            "name": n.name, "cpu_milli": int(n.allocatable.cpu),
            "mem": int(n.allocatable.memory),
            "pods": int(n.allocatable.max_task_num or 0),
            "gpus": int(n.allocatable.get("nvidia.com/gpu"))}))
    for job in cache.jobs.values():
        tasks = list(job.tasks.values())
        if any(t.node_name for t in tasks):
            raise ValueError(f"job {job.uid!r} has pre-placed tasks; only "
                             f"all-pending worlds convert to a trace")
        req = tasks[0].resreq
        events.append(TraceEvent(0.0, "job_arrival", {
            "name": job.uid, "queue": job.queue,
            "priority": int(job.priority), "tasks": len(tasks),
            "min_available": int(job.min_available),
            "cpu_milli": int(req.cpu), "mem": int(req.memory),
            "gpus": int(req.get("nvidia.com/gpu")),
            "duration": _round(duration)}))
    return validate_trace(events)


def baseline_trace(name: str, seed: int = 0,
                   duration: float = 30.0) -> List[TraceEvent]:
    """A BASELINE.md config (cache/synthetic.baseline_config) as a trace."""
    from ..cache.synthetic import baseline_config
    cache, _, _ = baseline_config(name, seed=seed)
    return trace_from_cache(cache, duration=duration)


def _flap_events(nodes: Sequence[int], drain_at: float, restore_at: float,
                 fail: Sequence[int] = (), fail_at: float = 0.0):
    out = []
    for i in nodes:
        out.append(TraceEvent(_round(drain_at), "node_drain",
                              {"name": f"node-{i:05d}"}))
        out.append(TraceEvent(_round(restore_at), "node_restore",
                              {"name": f"node-{i:05d}"}))
    for i in fail:
        out.append(TraceEvent(_round(fail_at), "node_fail",
                              {"name": f"node-{i:05d}"}))
    return tuple(out)


def _priority_wave(seed: int, at: float, n: int, queue: str, priority: int,
                   cpu_milli: int, duration: float,
                   sizes: Sequence[Tuple[int, float]] = ((1, 0.6), (2, 0.4)),
                   ) -> Tuple[TraceEvent, ...]:
    """A synchronized wave of high-priority gangs at one instant — the
    preemption driver (names prefixed ``hi-`` to stay disjoint from the
    Poisson stream's)."""
    rng = random.Random(seed ^ 0x9E3779B9)
    out = []
    for i in range(n):
        size = rng.choices([s for s, _ in sizes], [w for _, w in sizes])[0]
        out.append(TraceEvent(_round(at), "job_arrival", {
            "name": f"hi-{i:04d}", "queue": queue, "priority": priority,
            "tasks": size, "min_available": size, "cpu_milli": cpu_milli,
            "mem": GI, "gpus": 0, "duration": _round(duration)}))
    return tuple(out)


def _flash_crowd(seed: int, at: float, n: int,
                 queues: Sequence[str],
                 duration_mean: float = 6.0) -> Tuple[TraceEvent, ...]:
    """The diurnal flash crowd: ``n`` gangs landing in one tight burst
    window, spread round-robin over the queues (names prefixed ``fc-``
    to stay disjoint from the Poisson stream's) — the daytime peak that
    must drive a partition split under ``sim --elastic``."""
    rng = random.Random(seed ^ 0x5EED)
    out = []
    for i in range(n):
        size = rng.choices([1, 2], [0.6, 0.4])[0]
        out.append(TraceEvent(_round(at + 0.01 * i), "job_arrival", {
            "name": f"fc-{i:04d}", "queue": queues[i % len(queues)],
            "priority": 0,
            "tasks": size, "min_available": size,
            "cpu_milli": rng.choice((1000, 2000)), "mem": GI,
            "gpus": 0,
            "duration": _round(rng.uniform(0.5, 2.0) * duration_mean)}))
    return tuple(out)


def _elastic_churn_trace(seed: int) -> List[TraceEvent]:
    """The elastic-gangs acceptance world (docs/design/elastic-gangs.md):
    zoned nodes, min/desired gangs that must flex min -> desired -> min,
    lifecycle commands through the funnel, and node churn.

    Shape: 12 nodes in 3 zones. Eight elastic gangs (6 tasks, min 2,
    desired 6) arrive into a cluster pre-loaded with a rigid filler wave,
    so they admit at min; the filler drains and the grow stage expands
    them toward desired; a second, larger filler wave lands at t=20 and
    starves, driving pressure shrinks back toward min. Two gangs ride
    the Command funnel (a suspend/resume pair and a scale-down/scale-up
    pair) and the cluster churns underneath (two drains + restores, one
    node death). Run under `--elastic-gangs`; the acceptance gate
    asserts every gang completes at >= min, zero double-binds, zero
    below-min evictions outside full-gang decisions, and byte-identical
    reports across repeated runs."""
    rng = random.Random(seed ^ 0xE1A5)
    events: List[TraceEvent] = [
        TraceEvent(0.0, "queue_add", {"name": "q1", "weight": 2}),
        TraceEvent(0.0, "queue_add", {"name": "q2", "weight": 1}),
    ]
    for i in range(12):
        events.append(TraceEvent(0.0, "node_add", {
            "name": f"node-{i:05d}", "cpu_milli": 8000, "mem": 64 * GI,
            "pods": 40, "gpus": 0, "zone": f"z{i // 4}"}))
    rest: List[TraceEvent] = []
    # rigid filler wave 1: saturates enough capacity that the elastic
    # gangs arriving behind it admit at MIN, not desired
    for i in range(10):
        rest.append(TraceEvent(0.5, "job_arrival", {
            "name": f"rf-{i:04d}", "queue": "q2", "priority": 0,
            "tasks": 2, "min_available": 2, "cpu_milli": 2000, "mem": GI,
            "gpus": 0, "duration": _round(rng.uniform(6.0, 10.0))}))
    # the elastic gangs: 6 tasks, min 2, desired 6
    for i in range(8):
        rest.append(TraceEvent(_round(1.0 + 1.5 * i), "job_arrival", {
            "name": f"eg-{i:04d}", "queue": "q1" if i % 2 == 0 else "q2",
            "priority": 0, "tasks": 6, "min_available": 2, "desired": 6,
            "cpu_milli": 1000, "mem": GI, "gpus": 0,
            "duration": _round(rng.uniform(18.0, 30.0))}))
    # rigid filler wave 2: bigger than the free capacity left once the
    # elastic gangs have grown — the starvation that triggers pressure
    # shrinks back toward min
    for i in range(14):
        rest.append(TraceEvent(_round(20.0 + 0.01 * i), "job_arrival", {
            "name": f"rg-{i:04d}", "queue": "q2", "priority": 0,
            "tasks": 2, "min_available": 2, "cpu_milli": 2000, "mem": GI,
            "gpus": 0, "duration": _round(rng.uniform(5.0, 8.0))}))
    # lifecycle verbs through the Command funnel: a suspend/resume pair
    # (the full-gang drain, where below-min is legal) and a scale
    # round-trip (desired 6 -> 2 -> 6)
    rest += [
        TraceEvent(12.0, "job_command",
                   {"name": "eg-0000", "verb": "suspend"}),
        TraceEvent(14.0, "job_command",
                   {"name": "eg-0001", "verb": "scale", "value": 2}),
        TraceEvent(24.0, "job_command",
                   {"name": "eg-0000", "verb": "resume"}),
        TraceEvent(26.0, "job_command",
                   {"name": "eg-0001", "verb": "scale", "value": 6}),
    ]
    # churn: two drains that restore, one node death mid-run
    rest += list(_flap_events((10, 11), drain_at=10.0, restore_at=22.0,
                              fail=(9,), fail_at=16.0))
    rest.sort(key=lambda ev: (ev.t, ev.kind, ev.data.get("name", "")))
    return validate_trace(events + rest)


# The named scenario catalog (docs/simulation.md records each scenario's
# expected report ranges). Each entry is a factory(seed) -> trace plus a
# one-line description; `python -m volcano_tpu.sim --scenario NAME` runs
# one, and policy/perf PRs are judged on these standing worlds.
SCENARIOS: Dict[str, dict] = {
    "smoke": dict(
        description="60 gangs over ~25 virtual seconds on 10 nodes — the "
                    "fast tier-1 determinism world",
        factory=lambda seed: synthetic_trace(
            60, 10, seed=seed, arrival_rate=2.5, duration_mean=4.0,
            duration_cap=20.0),
    ),
    "steady": dict(
        description="2k gangs at 10 jobs/s on 100 nodes — steady-state "
                    "mixed-gang churn",
        factory=lambda seed: synthetic_trace(
            2000, 100, seed=seed, arrival_rate=10.0, duration_mean=8.0),
    ),
    "steady-10k": dict(
        description="10,500 gangs at ~20 jobs/s on 300 nodes, >=500 "
                    "virtual cycles — the acceptance-scale replay",
        factory=lambda seed: synthetic_trace(
            10500, 300, seed=seed, arrival_rate=20.0, duration_mean=8.0,
            duration_cap=60.0),
    ),
    "burst": dict(
        description="Poisson base load with a 40-gang synchronized burst "
                    "every 30 s — queueing-delay tail under bursts",
        factory=lambda seed: synthetic_trace(
            1200, 80, seed=seed, arrival_rate=5.0, duration_mean=8.0,
            burst_every=30.0, burst_size=40),
    ),
    "skew": dict(
        description="a saturated 6-node cluster, 3 queues weighted 9/3/1 "
                    "with demand reversed 1/3/9, uniform job priority — "
                    "overload is reclaim-shaped: the over-share queue's "
                    "gangs get reclaimed and re-queued behind the "
                    "deserving queues (DRF fairness gap under contention)",
        factory=lambda seed: synthetic_trace(
            150, 6, seed=seed, arrival_rate=6.0, duration_mean=15.0,
            duration_cap=40.0, cpu_choices=(2000, 3000, 4000),
            priority_choices=(0,),
            queues=(("q1", 9), ("q2", 3), ("q3", 1)),
            queue_demand=(1, 3, 9)),
    ),
    "preempt-burst": dict(
        description="low-priority gangs saturate one queue, then a "
                    "high-priority wave lands mid-run: bounded priority "
                    "preemption — the wave evicts, runs, leaves, and the "
                    "preempted gangs re-admit and finish",
        factory=lambda seed: synthetic_trace(
            150, 6, seed=seed, arrival_rate=3.5, duration_mean=10.0,
            duration_cap=30.0, cpu_choices=(2000, 3000),
            priority_choices=(0,), queues=(("q1", 1),),
            extra_events=_priority_wave(seed, at=25.0, n=10, queue="q1",
                                        priority=10, cpu_milli=6000,
                                        duration=4.0)),
    ),
    "node-flap": dict(
        description="steady load while 1/4 of the nodes drain and "
                    "restore, and two nodes fail outright mid-run — "
                    "requeue and re-admission behavior",
        factory=lambda seed: synthetic_trace(
            800, 32, seed=seed, arrival_rate=6.0, duration_mean=8.0,
            extra_events=_flap_events(range(0, 8), drain_at=40.0,
                                     restore_at=80.0, fail=(30, 31),
                                     fail_at=60.0)),
    ),
    "ack-chaos": dict(
        description="120 gangs over 4 skew-weighted queues on a "
                    "saturated 8-node cluster (reclaim-shaped "
                    "evictions), with node drains/restores and one "
                    "node death mid-run — the feedback-plane soak "
                    "world: seeded ack delay/drop/dup/reorder/stale "
                    "plus kills must converge to the no-fault terminal "
                    "accounting with bind AND evict acks in flight "
                    "(docs/robustness.md feedback failure model); the "
                    "4 queues shard under --federated 4",
        factory=lambda seed: synthetic_trace(
            120, 8, seed=seed, arrival_rate=5.0, duration_mean=12.0,
            duration_cap=30.0, cpu_choices=(2000, 3000),
            priority_choices=(0,),
            queues=(("q1", 4), ("q2", 2), ("q3", 1), ("q4", 1)),
            queue_demand=(1, 1, 2, 4),
            extra_events=_flap_events(range(0, 2), drain_at=10.0,
                                      restore_at=20.0, fail=(7,),
                                      fail_at=14.0)),
    ),
    "overload-burst": dict(
        description="240 gangs arriving at ~5x the 8-node cluster's "
                    "drain rate over 4 queues with the full priority "
                    "spread — the sustained-overload world for "
                    "--overload-chaos: the cycle budget must defer "
                    "(not collapse), the admission budget must shed "
                    "lowest-priority work first with retry-after "
                    "hints, and EVERY admitted gang must still "
                    "complete once the wave passes "
                    "(docs/robustness.md overload failure model); the "
                    "4 queues shard under --federated 4",
        factory=lambda seed: synthetic_trace(
            240, 8, seed=seed, arrival_rate=40.0, duration_mean=6.0,
            duration_cap=20.0, cpu_choices=(2000, 3000),
            mem_choices=(GI,),
            gang_sizes=((1, 0.5), (2, 0.35), (4, 0.15)),
            queues=(("q1", 2), ("q2", 2), ("q3", 1), ("q4", 1))),
    ),
    "diurnal-flash-crowd": dict(
        description="a quiet Poisson trickle over 6 queues on 8 small "
                    "nodes, then a ~150-gang flash crowd lands at t=15 "
                    "across every queue and the trickle dies back down "
                    "— the elastic-membership world for `sim "
                    "--federated 1 --elastic` with --overload-chaos: "
                    "chronic cycle-budget exhaustion must SPLIT the "
                    "single partition (bounded per-queue depth while "
                    "the crowd drains through admission backpressure "
                    "and starvation reserves), and the emptied spawned "
                    "partitions must MERGE back to one before the run "
                    "ends (docs/federation.md membership protocol)",
        factory=lambda seed: synthetic_trace(
            40, 8, seed=seed, arrival_rate=1.2, duration_mean=5.0,
            duration_cap=12.0,
            gang_sizes=((1, 0.55), (2, 0.35), (4, 0.10)),
            queues=(("q1", 1), ("q2", 1), ("q3", 1), ("q4", 1),
                    ("q5", 1), ("q6", 1)),
            cpu_choices=(1000, 2000), mem_choices=(GI,),
            priority_choices=(0,),
            node_cpu_milli=8000, node_mem=64 * GI, node_pods=40,
            extra_events=_flash_crowd(
                seed, at=15.0, n=150,
                queues=("q1", "q2", "q3", "q4", "q5", "q6"))),
    ),
    "fed-hotspot": dict(
        description="8 queues round-robined over 4 partitions with "
                    "~80% of the demand pinned to the two queues "
                    "partition 0 owns (q1+q5) — globally under "
                    "capacity but a ~2x hot shard: the load-driven "
                    "rebalancer must move a hot queue off partition 0 "
                    "through the journaled move funnel and CONVERGE "
                    "(no operator move_queue, no ping-pong; "
                    "docs/federation.md)",
        factory=lambda seed: synthetic_trace(
            160, 16, seed=seed, arrival_rate=4.5, duration_mean=12.0,
            duration_cap=30.0, gang_sizes=((2, 0.6), (4, 0.4)),
            queues=(("q1", 1), ("q2", 1), ("q3", 1), ("q4", 1),
                    ("q5", 1), ("q6", 1), ("q7", 1), ("q8", 1)),
            queue_demand=(40, 1, 1, 1, 40, 1, 1, 1),
            cpu_choices=(2000,), mem_choices=(GI,),
            priority_choices=(0,)),
    ),
    "fed-smoke": dict(
        description="60 gangs over 4 equal queues on 16 nodes, light "
                    "load — the federated non-contended oracle world: "
                    "sharded 4 ways every partition places its gangs the "
                    "cycle they arrive, so the aggregate decision plane "
                    "must be byte-identical to the single scheduler's",
        factory=lambda seed: synthetic_trace(
            60, 16, seed=seed, arrival_rate=2.0, duration_mean=4.0,
            duration_cap=12.0,
            gang_sizes=((1, 0.5), (2, 0.35), (4, 0.15)),
            queues=(("q1", 1), ("q2", 1), ("q3", 1), ("q4", 1)),
            cpu_choices=(500, 1000), mem_choices=(GI,),
            priority_choices=(0,)),
    ),
    "fed-starve": dict(
        description="4 queues / 8 nodes sharded 4 ways with demand "
                    "pinned to one queue — its 2-node shard saturates "
                    "while the other shards idle, driving the "
                    "cross-partition reserve/transfer protocol "
                    "(docs/federation.md)",
        factory=lambda seed: synthetic_trace(
            80, 8, seed=seed, arrival_rate=3.0, duration_mean=12.0,
            duration_cap=30.0, gang_sizes=((2, 0.6), (4, 0.4)),
            queues=(("q1", 1), ("q2", 1), ("q3", 1), ("q4", 1)),
            queue_demand=(40, 1, 1, 1),
            cpu_choices=(4000, 8000), mem_choices=(GI,),
            priority_choices=(0,)),
    ),
    "federated-1m": dict(
        description="1,000,000 single-task jobs at 2000 jobs/s over 4 "
                    "queues on 16 fat nodes — the sustained "
                    "millions-of-users intake world for `sim "
                    "--federated 4` (slow; ~500 virtual seconds, jobs "
                    "complete within ~2 s so the live set stays small "
                    "while the cumulative count reaches 1M)",
        factory=lambda seed: synthetic_trace(
            1_000_000, 16, seed=seed, arrival_rate=2000.0,
            duration_mean=1.0, duration_cap=2.0,
            gang_sizes=((1, 1.0),),
            queues=(("q1", 1), ("q2", 1), ("q3", 1), ("q4", 1)),
            cpu_choices=(500,), mem_choices=(GI // 4,),
            priority_choices=(0,),
            node_cpu_milli=1_024_000, node_mem=4096 * GI,
            node_pods=70_000),
    ),
    "pipelined-steady": dict(
        description="48 gangs land at ~t0 on 6 small nodes and drain "
                    "over many cycles with durations long enough that "
                    "nothing completes mid-drain — the pipelined shell's "
                    "no-conflict world: every speculation commits and "
                    "--verify-pipelined-equivalence proves the decision "
                    "plane byte-identical to the serial oracle",
        factory=lambda seed: synthetic_trace(
            48, 6, seed=seed, arrival_rate=1000.0, duration_mean=30.0,
            duration_cap=45.0, tail_alpha=4.0,
            gang_sizes=((1, 0.5), (2, 0.35), (4, 0.15)),
            queues=(("q1", 1),), cpu_choices=(1000, 2000),
            mem_choices=(GI,), priority_choices=(0,),
            node_cpu_milli=4000, node_mem=64 * GI, node_pods=50),
    ),
    "pipelined-conflict": dict(
        description="continuous churn on a 3-node sliver — arrivals and "
                    "completions land between almost every pair of "
                    "cycles, so speculation misses often: the "
                    "conflict-heavy world where the pipelined shell must "
                    "stay terminal-equivalent to the serial oracle with "
                    "zero double-binds",
        factory=lambda seed: synthetic_trace(
            120, 3, seed=seed, arrival_rate=4.0, duration_mean=3.0,
            duration_cap=8.0,
            gang_sizes=((1, 0.6), (2, 0.3), (4, 0.1)),
            queues=(("q1", 2), ("q2", 1)), cpu_choices=(1000, 2000),
            mem_choices=(GI,), priority_choices=(0,),
            node_cpu_milli=6000, node_mem=64 * GI, node_pods=40),
    ),
    "elastic-churn": dict(
        description="8 min-2/desired-6 elastic gangs on 12 zoned nodes "
                    "between two rigid filler waves, with suspend/resume "
                    "+ scale commands and node churn — the elastic-gangs "
                    "acceptance world for `sim --elastic-gangs`: gangs "
                    "flex min -> desired -> min, every gang completes at "
                    ">= min, zero double-binds, zero below-min evictions "
                    "outside full-gang decisions, byte-deterministic",
        factory=_elastic_churn_trace,
    ),
    "baseline-tiny": dict(
        description="BASELINE config 1 (1 gang of 3, 10 nodes) as the "
                    "degenerate all-at-t0 trace",
        factory=lambda seed: baseline_trace("tiny", seed=seed),
    ),
    "baseline-1k": dict(
        description="BASELINE config 2 (1k pods / 200 nodes) as the "
                    "degenerate all-at-t0 trace",
        factory=lambda seed: baseline_trace("1k", seed=seed),
    ),
    "baseline-10k": dict(
        description="BASELINE config 3 (10k pods / 2k nodes, 3 queues) as "
                    "the degenerate all-at-t0 trace",
        factory=lambda seed: baseline_trace("10k", seed=seed),
    ),
    "steady-100k": dict(
        description="100,000 pods / 20,000 nodes (BASELINE config '100k') "
                    "as the all-at-t0 trace — the unified sharded solver's "
                    "scale world (slow; run with --sharded, and "
                    "--verify-sharded-equivalence diffs the full-mesh "
                    "decision plane against the sharded-devices:1 "
                    "single-device oracle byte-for-byte)",
        factory=lambda seed: baseline_trace("100k", seed=seed),
    ),
    "mesh-chaos": dict(
        description="140 gangs over ~45 virtual seconds on 16 nodes, "
                    "long enough past the last arrival that every "
                    "quarantine window expires — the mesh fault soak "
                    "world for `sim --mesh-chaos` on the 8-device "
                    "dryrun mesh: seeded per-shard faults quarantine "
                    "chips mid-solve, the mesh heals over the "
                    "survivors, expired windows probe + readmit, and "
                    "--verify-mesh-equivalence proves the decision "
                    "plane byte-identical to the fault-free 1-device "
                    "oracle (docs/robustness.md mesh failure model)",
        factory=lambda seed: synthetic_trace(
            140, 16, seed=seed, arrival_rate=3.5, duration_mean=6.0,
            duration_cap=18.0,
            gang_sizes=((1, 0.5), (2, 0.35), (4, 0.15)),
            queues=(("q1", 2), ("q2", 1)), cpu_choices=(1000, 2000),
            mem_choices=(GI,), priority_choices=(0,),
            node_cpu_milli=6000, node_mem=64 * GI, node_pods=40),
    ),
}


def make_scenario(name: str, seed: int = 0) -> List[TraceEvent]:
    try:
        return SCENARIOS[name]["factory"](seed)
    except KeyError:
        raise ValueError(f"unknown scenario {name!r} "
                         f"(known: {sorted(SCENARIOS)})") from None
