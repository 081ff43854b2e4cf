"""CLI: run a trace file or a named scenario through the simulator, in the
JAX package's direct mode (one scheduler over one cache).

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
    "--trace-out": (True, "the trace export (ROADMAP item 9)"),
    "--ha": (True, "the HA control plane (ROADMAP item 9)"),
    "--lease-loss-cycles": (True, "the HA control plane (ROADMAP item 9)"),
    "--verify-ha-equivalence": (False,
                                "the HA control plane (ROADMAP item 9)"),
    "--lease-fault-rate": (True, "the HA control plane (ROADMAP item 9)"),
    "--lease-fault-seed": (True, "the HA control plane (ROADMAP item 9)"),
    "--federated": (True, "the federated control plane (ROADMAP item 9)"),
    "--verify-federated-equivalence": (
        False, "the federated control plane (ROADMAP item 9)"),
    "--rebalance": (False, "the federated control plane (ROADMAP item 9)"),
    "--elastic": (False, "the federated control plane (ROADMAP item 9)"),
    "--verify-elastic-equivalence": (
        False, "the federated control plane (ROADMAP item 9)"),
    "--store-wired": (False, "the object store (ROADMAP item 9)"),
    "--store-chaos": (False, "the object store (ROADMAP item 9)"),
    "--store-fault-rate": (True, "the object store (ROADMAP item 9)"),
    "--store-fault-seed": (True, "the object store (ROADMAP item 9)"),
    "--torn-watches": (True, "the object store (ROADMAP item 9)"),
    "--verify-store-equivalence": (False,
                                   "the object store (ROADMAP item 9)"),
    "--ack-chaos": (False, "ack-wire chaos (ROADMAP item 9)"),
    "--ack-fault-rate": (True, "ack-wire chaos (ROADMAP item 9)"),
    "--ack-fault-seed": (True, "ack-wire chaos (ROADMAP item 9)"),
    "--verify-ack-equivalence": (False, "ack-wire chaos (ROADMAP item 9)"),
    "--overload-chaos": (False, "admission backpressure and overload "
                                "bursts (ROADMAP item 9)"),
    "--admission-depth": (True, "admission backpressure (ROADMAP item 9)"),
    "--burst-rate": (True, "overload bursts (ROADMAP item 9)"),
    "--verify-overload-equivalence": (
        False, "admission backpressure and overload bursts "
               "(ROADMAP item 9)"),
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
    "--lifecycle": (False, "the lifecycle latency export "
                           "(ROADMAP item 9)"),
}


class _Refused(argparse.Action):
    """Records that a refused flag was given; main() refuses it after
    parsing, so no flag is parsed and then ignored."""

    def __call__(self, parser, namespace, values, option_string=None):
        namespace.refused.append(option_string)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m volcano_tpu_torch.sim",
        description="Trace-driven cluster simulation, direct mode")
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
    ap.add_argument("--cycle-budget", type=float, default=None,
                    help="per-cycle deadline budget in virtual seconds "
                         "(0 = unbounded); actions defer past it with "
                         "carry-over ordering")
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
    if args.elastic_gangs and (args.pipelined or args.fast_admit):
        ap.error("--elastic-gangs is a serial-cycle mode (not --pipelined "
                 "/ --fast-admit)")
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
    cycle_budget = args.cycle_budget or 0.0
    # the deterministic cost model prices one pending task an action at
    # 2 ms of budget, scaled by the period like the budget itself
    budget_cost = 0.002 * args.period if cycle_budget else 0.0

    def wraps():
        if not args.chaos_rate:
            return None, None
        from ..chaos import ChaosBinder, ChaosEvictor
        return (lambda b: ChaosBinder(b, failure_rate=args.chaos_rate,
                                      seed=chaos_seed),
                lambda e: ChaosEvictor(e, failure_rate=args.chaos_rate,
                                       seed=chaos_seed))

    def run(kills, pipelined=None, fast_admit=None):
        bw, ew = wraps()
        runner = SimRunner(trace, conf_text=conf_text, period=args.period,
                           seed=args.seed, max_cycles=args.max_cycles,
                           scenario=args.scenario, binder_wrap=bw,
                           evictor_wrap=ew, kill_cycles=kills,
                           kill_seed=kill_seed,
                           cycle_budget_s=cycle_budget,
                           budget_cost_per_task=budget_cost, device=device,
                           pipelined=args.pipelined if pipelined is None
                           else pipelined,
                           fast_admit=args.fast_admit if fast_admit is None
                           else fast_admit,
                           elastic_gangs=args.elastic_gangs,
                           topology_weight=args.topology_weight)
        if runners is not None:
            runners.append(runner)
        return runner.run()

    report = run(kill_cycles)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
