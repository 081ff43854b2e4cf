"""CLI: run a trace file or a named scenario through the simulator: the
JAX package's direct mode (one scheduler over one cache), its HA control
plane (``--ha N`` replicas over one cluster), or its federated control
plane (``--federated N`` partitions of one cluster).

Examples::

    python -m volcano_tpu_torch.sim --list
    python -m volcano_tpu_torch.sim --scenario smoke --deterministic
    python -m volcano_tpu_torch.sim --device cpu --scenario smoke \\
        --conf deploy/scheduler.conf --deterministic

Crash-recovery soak::

    python -m volcano_tpu_torch.sim --scenario smoke --chaos-rate 0.2 \\
        --kill-cycles 3,7,12 --verify-restart-equivalence

The pipelined cycle against its serial oracle::

    python -m volcano_tpu_torch.sim --device cpu --scenario \\
        pipelined-steady --seed 3 --pipelined \\
        --verify-pipelined-equivalence --deterministic

The flight recorder: every cycle's span tree as a Chrome trace
(Perfetto-loadable; the logical clock under ``--deterministic``, so the
file is byte-reproducible) and the per-class latency and SLO sections::

    python -m volcano_tpu_torch.sim --device cpu --scenario smoke \
        --deterministic --lifecycle --trace-out trace.json
    python -m volcano_tpu_torch.obs.validate trace.json

The object store and the feedback watch path: informer-fed, with seeded
store faults and torn watch streams, or seeded ack faults::

    python -m volcano_tpu_torch.sim --device cpu --scenario smoke \
        --conf deploy/scheduler.conf --store-chaos --deterministic
    python -m volcano_tpu_torch.sim --device cpu --scenario smoke \
        --store-wired --ack-chaos --verify-ack-equivalence

The HA control plane: three replicas, seeded leader kills and a
mid-cycle lease loss, held to the single-scheduler oracle (terminal
accounting, no double bind; a run without kills or lease losses must
equal it byte for byte)::

    python -m volcano_tpu_torch.sim --device cpu --scenario smoke \
        --seed 3 --ha 3 --kill-cycles 2,5,9,13 --kill-seed 2 \
        --lease-loss-cycles 7 --verify-ha-equivalence --deterministic

Overload: cycle budgets, bounded admission with priority-aware shedding
and seeded bursts, with the overload contract checked; with ``--federated``
the preset adds the load-driven queue rebalancer::

    python -m volcano_tpu_torch.sim --device cpu --scenario overload-burst \
        --seed 3 --overload-chaos --kill-cycles 2,5,9,13 --kill-seed 1 \
        --verify-overload-equivalence --deterministic
    python -m volcano_tpu_torch.sim --device cpu --scenario fed-hotspot \
        --seed 3 --federated 4 --overload-chaos \
        --verify-overload-equivalence --deterministic

The federated control plane: four partitions with seeded partition kills,
held to the single-scheduler oracle (terminal accounting; a non-contended
run equals it byte for byte)::

    python -m volcano_tpu_torch.sim --device cpu --scenario smoke --seed 3 \
        --federated 4 --kill-cycles 2,5,9,13 --kill-seed 2 \
        --verify-federated-equivalence --deterministic

Elastic partition membership: one partition splits under a flash crowd and
the newborns merge back once it passes, with the elastic contract checked::

    python -m volcano_tpu_torch.sim --device cpu --scenario \\
        diurnal-flash-crowd --seed 3 --federated 1 --elastic \\
        --overload-chaos --verify-elastic-equivalence --deterministic

Elastic gangs, with the elastic-gang contract checked::

    python -m volcano_tpu_torch.sim --device cpu --scenario elastic-churn \\
        --elastic-gangs --deterministic --verify-elastic-gang-equivalence

The run goes to the CUDA card unless ``--device cpu`` asks for the CPU;
with no card and no such request it exits non-zero. With the same
arguments, ``--deterministic`` prints the same bytes as ``python -m
volcano_tpu.sim``. Every other flag of that CLI is accepted by name and
refused: it names a mode this package does not have yet.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import torch

from .report import deterministic_json, terminal_accounting, to_json
from .runner import SimRunner
from .trace import load_trace, write_trace
from .workload import SCENARIOS, make_scenario

# the JAX package's sim flags that name modes this package lacks:
# flag -> (takes a value, what it needs)
REFUSED_FLAGS = {
    "--sharded": (False, "the node-sharded engine (ROADMAP item 10)"),
    "--sharded-devices": (True, "the node-sharded engine "
                                "(ROADMAP item 10)"),
    "--verify-sharded-equivalence": (
        False, "the node-sharded engine (ROADMAP item 10)"),
    "--mesh-chaos": (False, "the mesh ladder (ROADMAP item 10)"),
    "--mesh-fault-rate": (True, "the mesh ladder (ROADMAP item 10)"),
    "--mesh-fault-seed": (True, "the mesh ladder (ROADMAP item 10)"),
    "--verify-mesh-equivalence": (False,
                                  "the mesh ladder (ROADMAP item 10)"),
}


class _Refused(argparse.Action):
    """Records that a refused flag was given; main() refuses it after
    parsing, so no flag is parsed and then ignored."""

    def __call__(self, parser, namespace, values, option_string=None):
        namespace.refused.append(option_string)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m volcano_tpu_torch.sim",
        description="Trace-driven cluster simulation: direct mode, the "
                    "HA control plane or the federated control plane")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--scenario", help="named scenario (see --list)")
    src.add_argument("--trace", help="JSONL trace file to replay")
    src.add_argument("--list", action="store_true",
                     help="list named scenarios and exit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--period", type=float, default=1.0,
                    help="virtual schedule period per cycle (default 1.0)")
    ap.add_argument("--conf", help="scheduler conf YAML file (default: the "
                                   "sim pipeline conf, runner.SIM_CONF)")
    ap.add_argument("--max-cycles", type=int, default=100000)
    ap.add_argument("--out", help="also write the report JSON to this file")
    ap.add_argument("--write-trace",
                    help="write the (generated) trace to this JSONL file")
    ap.add_argument("--deterministic", action="store_true",
                    help="print ONLY the decision plane as canonical JSON "
                         "(byte-comparable across runs and with the JAX "
                         "package's sim)")
    ap.add_argument("--trace-out",
                    help="record the flight recorder for the whole run and "
                         "write the merged Chrome trace-event JSON "
                         "(Perfetto-loadable) to this file; with "
                         "--deterministic the recorder uses its logical "
                         "clock, so the artifact is byte-reproducible")
    ap.add_argument("--lifecycle", action="store_true",
                    help="derive the latency and slo report sections from "
                         "the per-job lifecycle timelines (obs/lifecycle.py):"
                         " per-class ttfb/admission/ack/jct percentiles and "
                         "the SLO burn-rate evaluation; off by default so "
                         "decision planes without it keep their bytes")
    ap.add_argument("--chaos-rate", type=float, default=0.0,
                    help="seeded bind/evict failure rate (chaos wrappers; "
                         "0 = off)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="chaos RNG seed (default: --seed)")
    ap.add_argument("--kill-cycles", default="",
                    help="comma-separated virtual cycles on which to "
                         "crash+restart the scheduler mid-trace "
                         "(intent journal + startup reconciliation)")
    ap.add_argument("--kill-seed", type=int, default=None,
                    help="kill-point RNG seed (default: --seed)")
    ap.add_argument("--verify-restart-equivalence", action="store_true",
                    help="also run the SAME trace unkilled and assert the "
                         "killed run converged to the same terminal "
                         "accounting with zero double-binds (exit 1 "
                         "otherwise)")
    ap.add_argument("--ha", type=int, default=1, metavar="N",
                    help="run N replica schedulers over one virtual "
                         "cluster (lease-based leadership, fencing epochs, "
                         "warm journal-tail standbys); --kill-cycles then "
                         "kills the LEADER at seeded points")
    ap.add_argument("--federated", type=int, default=0, metavar="N",
                    help="run N PARTITION schedulers over one virtual "
                         "cluster (disjoint queue subsets and node shards, "
                         "a fenced leader a partition, cross-partition "
                         "reserve/transfer through the shared journal); "
                         "--kill-cycles then kills a partition's leader at "
                         "seeded points. N = 1 is the single scheduler")
    ap.add_argument("--verify-federated-equivalence", action="store_true",
                    help="also run the SAME trace single-scheduler and "
                         "assert: a byte-identical aggregate decision plane "
                         "when the federated run is non-contended (no "
                         "kills, lease losses, ack or lease faults, no "
                         "cross-partition reserve), else equal terminal "
                         "accounting; no double bind and every arrived "
                         "job completed (exit 1 otherwise)")
    ap.add_argument("--rebalance", action="store_true",
                    help="the load-driven partition rebalancer (requires "
                         "--federated N)")
    ap.add_argument("--elastic", action="store_true",
                    help="elastic partition membership: chronic cycle-"
                         "budget exhaustion SPLITS a partition (journaled "
                         "partition_spawn, queues moved through the drain "
                         "funnel), chronic idleness MERGES it back (drain "
                         "and partition_retire); requires --federated N "
                         "(N may be 1: the 1 -> N -> 1 diurnal case)")
    ap.add_argument("--verify-elastic-equivalence", action="store_true",
                    help="check the elastic contract: at least one split "
                         "and one merge fired, the membership returned to "
                         "the initial partition count, per-queue depth "
                         "stayed bounded, every admitted gang completed "
                         "with no double bind, the report byte-identical "
                         "on a second run (exit 1 otherwise)")
    ap.add_argument("--lease-loss-cycles", default="",
                    help="comma-separated virtual cycles on which the "
                         "leader LOSES ITS LEASE mid-cycle (no process "
                         "death): it must abandon the open session, demote "
                         "to fenced, and a standby takes over")
    ap.add_argument("--verify-ha-equivalence", action="store_true",
                    help="also run the SAME trace single-replica and "
                         "assert: a byte-identical decision plane when the "
                         "HA run is non-contended (no kills, lease losses "
                         "or lease faults), else equal terminal accounting; "
                         "zero double binds (exit 1 otherwise)")
    ap.add_argument("--lease-fault-rate", type=float, default=None,
                    help="seeded store-fault rate on the HA lease CAS path "
                         "(acquire and renew ride the retrying transport; "
                         "--ha and --federated only)")
    ap.add_argument("--lease-fault-seed", type=int, default=None,
                    help="lease fault RNG seed (default: --seed)")
    ap.add_argument("--overload-chaos", action="store_true",
                    help="the overload preset: a cycle budget of 0.5 "
                         "periods with the deterministic per-pending-task "
                         "cost model, bounded admission (depth 48 a "
                         "queue) with priority-aware shedding and "
                         "retry-after re-offers, seeded arrival bursts "
                         "and, with --federated, the load-driven queue "
                         "rebalancer; --cycle-budget, --admission-depth, "
                         "--burst-rate and --rebalance override it")
    ap.add_argument("--cycle-budget", type=float, default=None,
                    help="per-cycle deadline budget in virtual seconds "
                         "(0 = unbounded); actions defer past it with "
                         "carry-over ordering")
    ap.add_argument("--admission-depth", type=int, default=None,
                    help="per-queue accepted-work task cap at the "
                         "admission front door (0 = unbounded)")
    ap.add_argument("--burst-rate", type=float, default=None,
                    help="seeded OverloadInjector burst probability a "
                         "cycle (0 = off)")
    ap.add_argument("--verify-overload-equivalence", action="store_true",
                    help="check the overload contract: bounded per-queue "
                         "pending depth, max cycle spend within 2x the "
                         "budget, every admitted gang completed (shed and "
                         "retried ones included), no double bind, the "
                         "report byte-identical on a second run; with "
                         "--federated --rebalance also that queue "
                         "ownership converged (exit 1 otherwise)")
    ap.add_argument("--pipelined", action="store_true",
                    help="run the pipelined scheduler shell (the next "
                         "cycle's solve dispatched while the host commits "
                         "this one)")
    ap.add_argument("--fast-admit", action="store_true",
                    help="bind trivially fitting gangs between full "
                         "cycles through the journaled funnel")
    ap.add_argument("--verify-pipelined-equivalence", action="store_true",
                    help="also run the serial oracle and assert: a "
                         "byte-identical decision plane when nothing could "
                         "diverge (no kills, no fast admit, no conflicted "
                         "or partial commit), else equal terminal "
                         "accounting; zero double binds and every arrived "
                         "job completed (exit 1 otherwise)")
    ap.add_argument("--elastic-gangs", action="store_true",
                    help="elastic gang membership: gangs with a desired "
                         "count admit at min, grow-shrink expands them "
                         "toward desired as capacity frees and shrinks "
                         "them first under pressure, and suspend/resume/"
                         "scale verbs go through the journaled command "
                         "funnel (not with --pipelined or --fast-admit)")
    ap.add_argument("--topology-weight", type=float, default=10.0,
                    metavar="W",
                    help="zone-compactness weight of --elastic-gangs (the "
                         "allocate anchor term and the plugin's node-order "
                         "bonus); 0 is the topology-unaware baseline "
                         "(default 10.0)")
    ap.add_argument("--verify-elastic-gang-equivalence",
                    action="store_true",
                    help="check the elastic-gang contract: grows and "
                         "shrinks fired, no below-min eviction outside a "
                         "full-gang decision, no rejected command, every "
                         "arrived gang completed with no double bind, the "
                         "report byte-identical on a second run (exit 1 "
                         "otherwise)")
    ap.add_argument("--store-wired", action="store_true",
                    help="cluster truth in an object store behind a "
                         "retrying transport: informer-fed cache, every "
                         "pod, podgroup and queue a store object")
    ap.add_argument("--store-chaos", action="store_true",
                    help="the store-chaos preset: --store-wired with 20%% "
                         "seeded verb faults and 2 torn watch streams; "
                         "individual --store-* flags override it")
    ap.add_argument("--store-fault-rate", type=float, default=None,
                    help="seeded per-verb store fault rate (latency, "
                         "transient, 409; implies --store-wired)")
    ap.add_argument("--store-fault-seed", type=int, default=None,
                    help="store fault RNG seed (default: --seed)")
    ap.add_argument("--torn-watches", type=int, default=None,
                    help="seeded whole-stream watch tears the resumable "
                         "informers must recover by backlog replay or "
                         "410-relist (implies --store-wired)")
    ap.add_argument("--verify-store-equivalence", action="store_true",
                    help="also run the SAME trace store-wired with no "
                         "faults and no kills and assert equal terminal "
                         "accounting, zero double binds and every arrived "
                         "job completed (exit 1 otherwise)")
    ap.add_argument("--ack-chaos", action="store_true",
                    help="the feedback-plane preset: seeded kubelet/status "
                         "ack faults at rate 0.3 (delay, drop, duplicate, "
                         "reorder, stale); direct mode faults the ack "
                         "wire, --store-wired the watch-path RUNNING acks")
    ap.add_argument("--ack-fault-rate", type=float, default=None,
                    help="seeded per-ack fault rate (overrides the "
                         "--ack-chaos preset)")
    ap.add_argument("--ack-fault-seed", type=int, default=None,
                    help="ack fault RNG seed (default: --seed)")
    ap.add_argument("--verify-ack-equivalence", action="store_true",
                    help="also run the SAME trace with a clean feedback "
                         "plane (no ack faults, no kills) and assert equal "
                         "terminal accounting, no double binds and nothing "
                         "stuck in flight (exit 1 otherwise)")
    ap.add_argument("--device", default="cuda",
                    help="where sessions solve: cuda (default) or cpu")
    ap.set_defaults(refused=[])
    for flag, (takes_value, _) in REFUSED_FLAGS.items():
        ap.add_argument(flag, action=_Refused, nargs=1 if takes_value else 0,
                        help=argparse.SUPPRESS)
    return ap


def main(argv=None, runners: Optional[List[SimRunner]] = None) -> int:
    """The CLI. ``runners``, when given, receives every SimRunner the run
    builds, in order: the first is the reported run."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.refused:
        for flag in args.refused:
            print(f"{ap.prog}: {flag} is not in volcano_tpu_torch yet: it "
                  f"needs {REFUSED_FLAGS[flag][1]}", file=sys.stderr)
        return 2

    if args.list:
        for name in sorted(SCENARIOS):
            print(f"{name:14s} {SCENARIOS[name]['description']}")
        return 0
    if args.scenario:
        trace = make_scenario(args.scenario, seed=args.seed)
    elif args.trace:
        trace = load_trace(args.trace)
    else:
        ap.error("one of --scenario/--trace/--list is required")
    if args.write_trace:
        write_trace(args.write_trace, trace)
    # the store-chaos preset: 20% verb faults and 2 torn watch streams
    # over the store-wired world
    store_fault_rate = args.store_fault_rate
    torn_watches = args.torn_watches
    if args.store_chaos:
        if store_fault_rate is None:
            store_fault_rate = 0.2
        if torn_watches is None:
            torn_watches = 2
    # asking for the store-equivalence verdict implies the store-wired
    # world, or the baseline would be a second direct run
    store_wired = (args.store_wired or args.store_chaos
                   or args.verify_store_equivalence
                   or store_fault_rate is not None
                   or torn_watches is not None)
    store_fault_rate = store_fault_rate or 0.0
    torn_watches = torn_watches or 0
    # the feedback-plane preset: 30% seeded ack faults
    ack_fault_rate = args.ack_fault_rate
    if args.ack_chaos and ack_fault_rate is None:
        ack_fault_rate = 0.3
    ack_fault_rate = ack_fault_rate or 0.0
    lease_fault_rate = args.lease_fault_rate or 0.0
    if args.elastic_gangs and (args.federated or args.ha > 1 or args.pipelined
                               or args.fast_admit or store_wired):
        ap.error("--elastic-gangs is a direct single-scheduler mode (not "
                 "--federated / --ha / --store-wired / --pipelined / "
                 "--fast-admit)")
    if args.verify_ack_equivalence and not ack_fault_rate:
        # without faults the report has no feedback section and every
        # stuck-state assertion would pass vacuously
        ap.error("--verify-ack-equivalence requires ack faults "
                 "(--ack-chaos, or --ack-fault-rate > 0)")
    if args.verify_elastic_gang_equivalence and not args.elastic_gangs:
        ap.error("--verify-elastic-gang-equivalence requires "
                 "--elastic-gangs")

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"{ap.prog}: no CUDA device is available; pass --device cpu "
              f"to simulate on the CPU", file=sys.stderr)
        return 2

    conf_text = None
    if args.conf:
        with open(args.conf) as f:
            conf_text = f.read()
    elif args.pipelined or args.fast_admit:
        # pinned, so the serial oracle of --verify-pipelined-equivalence
        # runs the same actions and engine: the diff isolates the pipeline
        from .runner import PIPELINED_SIM_CONF
        conf_text = PIPELINED_SIM_CONF

    chaos_seed = args.seed if args.chaos_seed is None else args.chaos_seed
    kill_seed = args.seed if args.kill_seed is None else args.kill_seed
    kill_cycles = [int(c) for c in args.kill_cycles.split(",") if c.strip()]
    lease_loss = [int(c) for c in args.lease_loss_cycles.split(",")
                  if c.strip()]
    # the overload preset: budget, bounded admission and seeded bursts
    # (and the rebalancer when federated); explicit flags override it
    cycle_budget = args.cycle_budget
    admission_depth = args.admission_depth
    burst_rate = args.burst_rate
    rebalance = args.rebalance
    if args.overload_chaos:
        if cycle_budget is None:
            cycle_budget = 0.5 * args.period
        if admission_depth is None:
            admission_depth = 48
        if burst_rate is None:
            burst_rate = 0.2
        if args.federated:
            rebalance = True
    cycle_budget = cycle_budget or 0.0
    admission_depth = admission_depth or 0
    burst_rate = burst_rate or 0.0
    # the deterministic cost model prices one pending task an action at
    # 2 ms of budget, scaled by the period like the budget itself: with the
    # preset's 48-task admission cap the worst single action charges ~0.38
    # periods, under the 0.5 budget, while a saturated 4-queue backlog
    # walked by a 5-action pipeline charges ~1.5, so exhaustion and
    # deferral fire in the overload runs
    budget_cost = 0.002 * args.period if cycle_budget else 0.0
    if rebalance and not args.federated:
        ap.error("--rebalance requires --federated N")
    if args.elastic and not args.federated:
        ap.error("--elastic requires --federated N (N may be 1)")
    if args.verify_elastic_equivalence and not args.elastic:
        ap.error("--verify-elastic-equivalence requires --elastic")

    def wraps():
        if not args.chaos_rate:
            return None, None
        from ..chaos import ChaosBinder, ChaosEvictor
        return (lambda b: ChaosBinder(b, failure_rate=args.chaos_rate,
                                      seed=chaos_seed),
                lambda e: ChaosEvictor(e, failure_rate=args.chaos_rate,
                                       seed=chaos_seed))

    def run(kills, replicas=None, losses=None, federated=None,
            pipelined=None, fast_admit=None, fault_rate=None, torn=None,
            ack_rate=None, lease_rate=None):
        partitions = args.federated if federated is None else federated
        bw, ew = wraps()
        runner = SimRunner(trace, conf_text=conf_text, period=args.period,
                           seed=args.seed, max_cycles=args.max_cycles,
                           scenario=args.scenario, binder_wrap=bw,
                           evictor_wrap=ew, kill_cycles=kills,
                           kill_seed=kill_seed,
                           cycle_budget_s=cycle_budget,
                           budget_cost_per_task=budget_cost,
                           admission_depth=admission_depth,
                           overload_burst_rate=burst_rate, device=device,
                           pipelined=args.pipelined if pipelined is None
                           else pipelined,
                           fast_admit=args.fast_admit if fast_admit is None
                           else fast_admit,
                           elastic_gangs=args.elastic_gangs,
                           topology_weight=args.topology_weight,
                           lifecycle=args.lifecycle,
                           store_wired=store_wired,
                           store_fault_rate=store_fault_rate
                           if fault_rate is None else fault_rate,
                           store_fault_seed=args.store_fault_seed,
                           torn_watches=torn_watches if torn is None
                           else torn,
                           ack_fault_rate=ack_fault_rate
                           if ack_rate is None else ack_rate,
                           ack_fault_seed=args.ack_fault_seed,
                           ha_replicas=args.ha if replicas is None
                           else replicas,
                           lease_loss_cycles=lease_loss if losses is None
                           else losses,
                           lease_fault_rate=lease_fault_rate
                           if lease_rate is None else lease_rate,
                           lease_fault_seed=args.lease_fault_seed,
                           federated_partitions=partitions,
                           rebalance=rebalance and bool(partitions),
                           elastic=args.elastic and bool(partitions))
        if runners is not None:
            runners.append(runner)
        return runner.run()

    if args.trace_out:
        from ..obs import TRACE
        # an unbounded ring for the run: --trace-out merges EVERY cycle
        # into one artifact instead of keeping only the live tail
        TRACE.configure(max_cycles=0, logical=args.deterministic)
        TRACE.enable()
    report = run(kill_cycles)
    if args.trace_out:
        TRACE.disable()
        TRACE.dump(args.trace_out)
        print(f"trace: {TRACE.cycles_recorded()} cycles -> "
              f"{args.trace_out}", file=sys.stderr)
    text = deterministic_json(report) if args.deterministic \
        else to_json(report)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    if args.verify_restart_equivalence:
        baseline = run([])
        got = terminal_accounting(report)
        want = terminal_accounting(baseline)
        problems = []
        if got != want:
            problems.append(f"terminal accounting diverged: "
                            f"killed={got} unkilled={want}")
        if got.get("double_binds"):
            problems.append(f"double-binds in killed run: "
                            f"{got['double_binds']}")
        if got.get("unfinished"):
            problems.append(f"killed run left {got['unfinished']} jobs "
                            f"unfinished")
        if report["jobs"]["completed"] != report["jobs"]["arrived"]:
            problems.append("killed run did not complete every arrived job")
        if problems:
            for p in problems:
                print(f"restart-equivalence FAILED: {p}", file=sys.stderr)
            return 1
        print(f"restart-equivalence OK: {report['restarts']} restarts, "
              f"journal={report['journal_replayed']}, "
              f"accounting={got}", file=sys.stderr)
    if args.verify_store_equivalence:
        baseline = run([], fault_rate=0.0, torn=0)
        got = terminal_accounting(report)
        want = terminal_accounting(baseline)
        problems = []
        if got != want:
            problems.append(f"terminal accounting diverged: "
                            f"chaotic={got} clean={want}")
        if got.get("double_binds"):
            problems.append(f"double-binds under store chaos: "
                            f"{got['double_binds']}")
        if report["jobs"]["completed"] != report["jobs"]["arrived"]:
            problems.append("store-chaos run did not complete every "
                            "arrived job")
        if problems:
            for p in problems:
                print(f"store-equivalence FAILED: {p}", file=sys.stderr)
            return 1
        st = report.get("store", {})
        print(f"store-equivalence OK: faults={st.get('faults', {})}, "
              f"retry_funnel={st.get('retry_funnel', {})}, "
              f"torn={st.get('torn_watch_events', 0)}, "
              f"resumes={st.get('watch_resumes', 0)}, "
              f"relists={st.get('watch_relists', 0)}, "
              f"restarts={report.get('restarts', 0)}, "
              f"accounting={got}", file=sys.stderr)
    if args.verify_ack_equivalence:
        baseline = run([], ack_rate=0.0)
        got = terminal_accounting(report)
        want = terminal_accounting(baseline)
        fb = report.get("feedback", {})
        problems = []
        if got != want:
            problems.append(f"terminal accounting diverged: "
                            f"ack-chaotic={got} clean={want}")
        if got.get("double_binds"):
            problems.append(f"double-binds under ack chaos: "
                            f"{got['double_binds']}")
        if report["jobs"]["completed"] != report["jobs"]["arrived"]:
            problems.append("ack-chaos run did not complete every "
                            "arrived job")
        if fb.get("inflight_open") or fb.get("wire_pending"):
            problems.append(
                f"stuck feedback state at run end: "
                f"inflight_open={fb.get('inflight_open')} "
                f"wire_pending={fb.get('wire_pending')}")
        if problems:
            for p in problems:
                print(f"ack-equivalence FAILED: {p}", file=sys.stderr)
            return 1
        print(f"ack-equivalence OK: faults={fb.get('faults', {})}, "
              f"acks={fb.get('acks', {})}, "
              f"watchdog_fired={fb.get('watchdog_fired', 0)}, "
              f"restarts={report.get('restarts', 0)}, "
              f"accounting={got}", file=sys.stderr)
    if args.verify_pipelined_equivalence:
        import json
        from .report import pipelined_oracle_part
        baseline = run([], pipelined=False, fast_admit=False)
        problems = []
        spec = report.get("speculation", {})
        mode = "byte-identical"
        # a conflicted speculation re-solves serially on the true
        # snapshot, so the whole plane usually matches; it must whenever
        # nothing could legitimately diverge
        got_json = json.dumps(pipelined_oracle_part(report),
                              sort_keys=True, separators=(",", ":"))
        want_json = json.dumps(pipelined_oracle_part(baseline),
                               sort_keys=True, separators=(",", ":"))
        if got_json != want_json:
            diverger = bool(kill_cycles or args.fast_admit
                            or spec.get("conflicts", 0)
                            or spec.get("partial", 0))
            if not diverger:
                problems.append("conflict-free pipelined decision plane "
                                "differs from the serial oracle")
            mode = "terminal"
            got = terminal_accounting(report)
            want = terminal_accounting(baseline)
            if got != want:
                problems.append(f"terminal accounting diverged: "
                                f"pipelined={got} serial={want}")
        if report.get("double_binds"):
            problems.append(f"double-binds in pipelined run: "
                            f"{report['double_binds']}")
        if report["jobs"]["completed"] != report["jobs"]["arrived"]:
            problems.append("pipelined run did not complete every arrived "
                            "job")
        if problems:
            for p in problems:
                print(f"pipelined-equivalence FAILED: {p}", file=sys.stderr)
            return 1
        print(f"pipelined-equivalence OK: speculation={spec}, "
              f"fast_admit={report.get('fast_admit', {})}, "
              f"restarts={report.get('restarts', 0)}, "
              f"ttfb_p99_cycles={report.get('ttfb_p99_cycles')}, "
              f"mode={mode}", file=sys.stderr)
    if args.verify_overload_equivalence:
        ov = report.get("overload")
        problems = []
        if ov is None:
            problems.append("no overload section in the report: enable "
                            "--overload-chaos (or individual overload "
                            "flags)")
            ov = {}
        # the overload machinery (cost model, shed and retry stream,
        # bursts, rebalancer) is seeded and priced on the virtual clock, so
        # an identical second run reproduces the report byte for byte
        rerun = run(kill_cycles)
        if deterministic_json(report) != deterministic_json(rerun):
            problems.append("overload run not byte-deterministic x2")
        budget = ov.get("cycle_budget", {})
        if budget.get("budget_s"):
            if budget.get("max_cycle_spend_s", 0.0) \
                    > 2.0 * budget["budget_s"]:
                problems.append(
                    f"cycle spend exceeded 2x the budget: "
                    f"{budget['max_cycle_spend_s']} vs "
                    f"{budget['budget_s']}")
        adm = ov.get("admission", {})
        if adm:
            over = {q: d for q, d in adm.get("high_water", {}).items()
                    if d > adm["max_queue_depth"]}
            if over:
                problems.append(f"admission depth bound violated: "
                                f"{over} > {adm['max_queue_depth']}")
        if ov.get("retries_pending"):
            problems.append(f"{ov['retries_pending']} shed arrivals "
                            f"never re-admitted")
        if report["jobs"]["completed"] != report["jobs"]["arrived"] \
                or report["jobs"]["unfinished"]:
            problems.append("not every admitted gang completed: "
                            f"{report['jobs']}")
        if report.get("double_binds"):
            problems.append(f"double-binds under overload: "
                            f"{report['double_binds']}")
        reb = report.get("federation", {}).get("rebalance")
        if reb is not None and reb.get("enabled"):
            # a balanced world never moves (hysteresis abstains); the
            # contract is convergence: whatever moved settled well before
            # the run ended
            if reb.get("move_count") and reb["last_move_t"] \
                    > report["virtual_time_s"] - 10 * args.period:
                problems.append(
                    f"rebalancer still moving at run end (last move "
                    f"t={reb['last_move_t']}): ownership did not "
                    f"converge")
        if problems:
            for p in problems:
                print(f"overload-equivalence FAILED: {p}",
                      file=sys.stderr)
            return 1
        print(f"overload-equivalence OK: budget={budget}, "
              f"shed={ov.get('shed', {})}, "
              f"readmits={ov.get('readmit_attempts', 0)}, "
              f"bursts={ov.get('burst_jobs', 0)}, "
              f"rebalance_moves="
              f"{(reb or {}).get('move_count', 0)}, "
              f"restarts={report.get('restarts', 0)}, "
              f"accounting={terminal_accounting(report)}",
              file=sys.stderr)
    if args.verify_elastic_equivalence:
        el = report.get("federation", {}).get("elastic") or {}
        problems = []
        if not el.get("enabled"):
            problems.append("no elastic section in the report: the "
                            "controller never attached")
        if not el.get("splits"):
            problems.append("no partition split fired: the scenario "
                            "never sustained cycle-budget exhaustion long "
                            "enough")
        if not el.get("merges"):
            problems.append("no partition merge fired: spawned partitions "
                            "never drained back")
        if el.get("partitions_final") != el.get("partitions_initial"):
            problems.append(
                f"membership did not return to the initial count: "
                f"final={el.get('partitions_final')} "
                f"initial={el.get('partitions_initial')}")
        if report["jobs"]["completed"] != report["jobs"]["arrived"] \
                or report["jobs"]["unfinished"]:
            problems.append("not every admitted gang completed across "
                            f"membership changes: {report['jobs']}")
        if report.get("double_binds"):
            problems.append(f"double-binds across membership changes: "
                            f"{report['double_binds']}")
        adm = report.get("overload", {}).get("admission", {})
        if adm and adm.get("max_queue_depth"):
            over = {q: d for q, d in adm.get("high_water", {}).items()
                    if d > adm["max_queue_depth"]}
            if over:
                problems.append(f"per-queue depth bound violated across "
                                f"split/merge: {over} > "
                                f"{adm['max_queue_depth']}")
        # byte-determinism x2: the split and merge triggers are virtual-
        # clock hysteresis over seeded load, so a second run must print
        # the same bytes
        rerun = run(kill_cycles)
        if deterministic_json(report) != deterministic_json(rerun):
            problems.append("elastic run not byte-deterministic x2")
        if problems:
            for p in problems:
                print(f"elastic-equivalence FAILED: {p}", file=sys.stderr)
            return 1
        print(f"elastic-equivalence OK: splits={el.get('splits')}, "
              f"merges={el.get('merges')}, "
              f"peak={el.get('partitions_peak')}, "
              f"final={el.get('partitions_final')}, "
              f"max_queue_depth={el.get('max_queue_depth')}, "
              f"abstentions={el.get('abstentions')}, "
              f"restarts={report.get('restarts', 0)}, "
              f"accounting={terminal_accounting(report)}",
              file=sys.stderr)
    if args.verify_elastic_gang_equivalence:
        eg = report.get("elastic_gangs") or {}
        cmds = eg.get("commands") or {}
        problems = []
        if not eg.get("enabled"):
            problems.append("no elastic_gangs section in the report: the "
                            "mode never engaged")
        if not eg.get("grows"):
            problems.append("no elastic grow fired")
        if not eg.get("shrinks"):
            problems.append("no elastic shrink fired")
        if eg.get("below_min_evictions"):
            problems.append(f"{eg['below_min_evictions']} eviction(s) took "
                            f"a gang below min outside a full-gang "
                            f"decision")
        if cmds.get("rejected"):
            problems.append(f"{cmds['rejected']} lifecycle command(s) "
                            f"rejected by the funnel")
        if cmds.get("submitted", 0) != cmds.get("applied", 0) \
                + cmds.get("dropped", 0):
            problems.append(f"command ledger does not balance: {cmds}")
        if report["jobs"]["completed"] != report["jobs"]["arrived"] \
                or report["jobs"]["unfinished"]:
            problems.append(f"not every arrived gang completed: "
                            f"{report['jobs']}")
        if report.get("double_binds"):
            problems.append(f"double-binds under elastic churn: "
                            f"{report['double_binds']}")
        rerun = run(kill_cycles)
        if deterministic_json(report) != deterministic_json(rerun):
            problems.append("elastic-gang run not byte-deterministic x2")
        if problems:
            for p in problems:
                print(f"elastic-gang-equivalence FAILED: {p}",
                      file=sys.stderr)
            return 1
        print(f"elastic-gang-equivalence OK: grows={eg.get('grows')}, "
              f"shrinks={eg.get('shrinks')}, "
              f"continues={eg.get('elastic_continues')}, "
              f"colocation_rate={eg.get('colocation_rate')}, "
              f"commands={cmds}, "
              f"restarts={report.get('restarts', 0)}, "
              f"accounting={terminal_accounting(report)}",
              file=sys.stderr)
    if args.verify_federated_equivalence:
        import json
        from .report import oracle_part
        baseline = run([], replicas=1, losses=[], federated=0)
        problems = []
        # contended: anything that can legitimately move the aggregate
        # plane off the oracle's (seeded kills and lease losses, ack and
        # lease chaos, or the run itself moving capacity between partitions
        # through cross-partition reserves)
        contended = bool(kill_cycles or lease_loss
                         or ack_fault_rate or lease_fault_rate
                         or report.get("cross_partition_reserves"))
        if not contended:
            got_json = json.dumps(oracle_part(report), sort_keys=True,
                                  separators=(",", ":"))
            want_json = json.dumps(oracle_part(baseline), sort_keys=True,
                                   separators=(",", ":"))
            if got_json != want_json:
                problems.append("non-contended federated aggregate "
                                "decision plane differs from the "
                                "single-scheduler oracle")
        else:
            got = terminal_accounting(report)
            want = terminal_accounting(baseline)
            if got != want:
                problems.append(f"terminal accounting diverged: "
                                f"federated={got} oracle={want}")
        if report.get("double_binds"):
            problems.append(f"cross-partition double-binds in federated "
                            f"run: {report['double_binds']}")
        if report["jobs"]["completed"] != report["jobs"]["arrived"]:
            problems.append("federated run did not complete every "
                            "arrived job")
        if problems:
            for p in problems:
                print(f"federated-equivalence FAILED: {p}", file=sys.stderr)
            return 1
        fed = report.get("federation", {})
        print(f"federated-equivalence OK: partitions={args.federated}, "
              f"restarts={report.get('restarts', 0)}, "
              f"failovers={report.get('failovers', 0)}, "
              f"reserves={report.get('cross_partition_reserves', {})}, "
              f"node_transfers={fed.get('node_transfers', 0)}",
              file=sys.stderr)
    if args.verify_ha_equivalence:
        import json
        from .report import oracle_part
        baseline = run([], replicas=1, losses=[], lease_rate=0.0)
        problems = []
        contended = bool(kill_cycles or lease_loss or lease_fault_rate)
        if not contended:
            got_json = json.dumps(oracle_part(report), sort_keys=True,
                                  separators=(",", ":"))
            want_json = json.dumps(oracle_part(baseline), sort_keys=True,
                                   separators=(",", ":"))
            if got_json != want_json:
                problems.append("non-contended HA decision plane differs "
                                "from the single-scheduler oracle")
        else:
            got = terminal_accounting(report)
            want = terminal_accounting(baseline)
            if got != want:
                problems.append(f"terminal accounting diverged: "
                                f"ha={got} oracle={want}")
        if report.get("double_binds"):
            problems.append(f"double-binds in HA run: "
                            f"{report['double_binds']}")
        if report["jobs"]["completed"] != report["jobs"]["arrived"]:
            problems.append("HA run did not complete every arrived job")
        if problems:
            for p in problems:
                print(f"ha-equivalence FAILED: {p}", file=sys.stderr)
            return 1
        print(f"ha-equivalence OK: replicas={args.ha}, "
              f"failovers={report.get('failovers', 0)}, "
              f"fenced_rejections={report.get('fenced_rejections', 0)}, "
              f"failover_cycles_max="
              f"{report.get('ha', {}).get('failover_cycles_max', 0)}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
