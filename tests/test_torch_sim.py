"""The port's sim in direct mode (volcano_tpu_torch/sim) on the CPU: the
port's versions of tests/test_sim.py's direct-mode cases, and the
whole-cycle oracle — ``python -m volcano_tpu_torch.sim --deterministic``
prints the bytes ``python -m volcano_tpu.sim --deterministic`` prints, and
its side effects (every bind's node, every eviction, in order) are the
JAX run's.

The JAX sim runs in child processes at XLA optimization level 0
(tools/sim_reference.py; compiled at its default level XLA:CPU contracts
fused multiply-adds and flips near-ties). The smoke runs are computed live
here; the long runs under deploy/scheduler.conf (skew, preempt-burst,
baseline-10k: minutes of JAX compiles) are held to the digests in
tests/sim_reference_digests.json, which the live smoke runs hold to the
JAX package in turn. Those digests, like the live runs, come from the JAX
preempt walk's per-task formulation: its default closed-form fill differs
from it on preempt-burst and skew, a fault of the reference recorded by
``test_walk_fill_schedule_fault_recorded`` and witnessed by the callbacks
engine (ROADMAP §3)."""

import contextlib
import hashlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from volcano_tpu_torch.actions import allocate as torch_allocate
from volcano_tpu_torch.cache import SchedulerCache
from volcano_tpu_torch.chaos import ChaosBinder
from volcano_tpu_torch.sim import (SimRunner, TraceEvent, baseline_trace,
                                   deterministic_json, load_trace,
                                   make_scenario, synthetic_trace,
                                   write_trace)
from volcano_tpu_torch.sim.__main__ import main as sim_main
from volcano_tpu_torch.sim.report import sequence_digest

from torch_parity import (FAULT_WALK_WORLDS, jax_reference,  # noqa: F401
                          port_gc_windows)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
from sim_traces import TensorPathRecorder  # noqa: E402

SEED = 20260803
DEPLOYED = "deploy/scheduler.conf"
CHAOS = ("--chaos-rate", "0.2", "--kill-cycles", "5,12")
# the runs computed live from the JAX package here, and the runs held to
# the committed digests
LIVE_RUNS = [("smoke", ()), ("smoke", ("--conf", DEPLOYED)),
             ("smoke", CHAOS), ("smoke", ("--conf", DEPLOYED) + CHAOS)]
# the shell's cycle budget, spent by the deterministic cost model
BUDGET_RUN = ("smoke", ("--cycle-budget", "0.01"))
DIGEST_RUNS = [("skew", ("--conf", DEPLOYED)),
               ("preempt-burst", ("--conf", DEPLOYED)),
               ("baseline-10k", ("--conf", DEPLOYED))]


# preempt-burst with preempt and reclaim on the callbacks engine, run live
# from the JAX package too (test_walk_fault_witnessed_by_the_callbacks_engine)
CALLBACKS_KEY = "preempt-burst callbacks"


def _callbacks_conf() -> str:
    text = (REPO / DEPLOYED).read_text()
    assert text.count("    engine: tpu\n") == 2
    return text.replace("    engine: tpu\n", "    engine: callbacks\n")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "sim_reference", REPO / "tools" / "sim_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _key(scenario, args):
    return " ".join(("--scenario", scenario) + tuple(args))


def port_run(scenario, args):
    """What ``python -m volcano_tpu_torch.sim --device cpu --scenario S
    --deterministic ARGS`` prints, the run's sequence digest (every bind's
    node and every eviction, in order: sim/report.py) and the summary of
    its allocate solves' node-tensor paths (tools/sim_traces.py)."""
    out = io.StringIO()
    runners = []
    paths = TensorPathRecorder(torch_allocate, SchedulerCache)
    try:
        with contextlib.redirect_stdout(out):
            rc = sim_main(["--device", "cpu", "--scenario", scenario,
                           "--deterministic", *args], runners=runners)
    finally:
        paths.close()
    assert rc == 0
    return out.getvalue().encode(), sequence_digest(runners[0]), \
        paths.summary()


def _jax_result(finished):
    text, record = finished
    paths = record.pop("tensor_paths")
    return text, record, paths


@pytest.fixture(scope="module")
def jax_live(tmp_path_factory):
    """The JAX sim's bytes, sequence digest and node-tensor paths for
    LIVE_RUNS, the children started at once."""
    tool = _tool()
    conf = tmp_path_factory.mktemp("conf") / "callbacks.conf"
    conf.write_text(_callbacks_conf())
    procs = {_key(s, a): tool.start(s, a)
             for s, a in LIVE_RUNS + [BUDGET_RUN]}
    procs[CALLBACKS_KEY] = tool.start("preempt-burst", ("--conf", str(conf)))
    return {key: _jax_result(tool.finish_record(proc, timeout=900))
            for key, proc in procs.items()}


@pytest.fixture(scope="module")
def digests():
    doc = json.loads((REPO / "tests" / "sim_reference_digests.json")
                     .read_text())
    return {run["key"]: run for run in doc["runs"]}


# -- trace schema ----------------------------------------------------------

def test_trace_roundtrip(tmp_path):
    trace = synthetic_trace(40, 6, seed=SEED, arrival_rate=3.0)
    path = tmp_path / "t.jsonl"
    assert write_trace(path, trace) == len(trace)
    loaded = load_trace(path)
    assert loaded == trace
    assert [ev.to_line() for ev in loaded] == [ev.to_line() for ev in trace]


def test_trace_validation_rejects_garbage(tmp_path):
    with pytest.raises(ValueError, match="unknown trace event kind"):
        TraceEvent(0.0, "job_arrivel", {})
    with pytest.raises(ValueError, match="payload mismatch"):
        TraceEvent(0.0, "node_add", {"name": "n0"})
    bad = [TraceEvent(0.0, "node_add", {"name": "n0", "cpu_milli": 1000,
                                        "mem": 1 << 30, "pods": 10,
                                        "gpus": 0}),
           TraceEvent(1.0, "job_arrival", {
               "name": "j0", "queue": "nope", "priority": 0, "tasks": 1,
               "min_available": 1, "cpu_milli": 100, "mem": 1 << 20,
               "gpus": 0, "duration": 1.0})]
    path = tmp_path / "bad.jsonl"
    with open(path, "w") as f:
        for ev in bad:
            f.write(ev.to_line() + "\n")
    with pytest.raises(ValueError, match="unknown queue"):
        load_trace(path)


def test_generator_deterministic():
    a = synthetic_trace(100, 8, seed=7)
    b = synthetic_trace(100, 8, seed=7)
    assert a == b
    assert a != synthetic_trace(100, 8, seed=8)


@pytest.mark.parametrize("name", [
    "smoke", "steady", "steady-10k", "burst", "skew", "preempt-burst",
    "node-flap", "ack-chaos", "overload-burst", "diurnal-flash-crowd",
    "fed-hotspot", "fed-smoke", "fed-starve", "pipelined-steady",
    "pipelined-conflict", "elastic-churn", "baseline-tiny", "baseline-1k",
    "baseline-10k", "mesh-chaos"])
def test_scenario_matches_jax(name):
    """Every scenario the CPU can generate quickly is the JAX package's
    trace, line for line (baseline-* through the port's own
    cache/synthetic.py)."""
    from volcano_tpu.sim.workload import make_scenario as jax_scenario
    ours = [ev.to_line() for ev in make_scenario(name, seed=SEED % 7)]
    theirs = [ev.to_line() for ev in jax_scenario(name, seed=SEED % 7)]
    assert ours == theirs


def test_scenario_catalog_matches_jax():
    from volcano_tpu.sim.workload import SCENARIOS as JAX_SCENARIOS
    from volcano_tpu_torch.sim.workload import SCENARIOS
    assert sorted(SCENARIOS) == sorted(JAX_SCENARIOS)


# -- replay determinism ----------------------------------------------------

def test_sim_deterministic_replay(tmp_path):
    """Same trace + seed => identical bind sequence, JCTs and
    byte-identical decision-plane JSON, through the JSONL file format
    too."""
    trace = make_scenario("smoke", seed=SEED)
    path = tmp_path / "smoke.jsonl"
    write_trace(path, trace)
    r1 = SimRunner(trace, seed=SEED, scenario="smoke", device="cpu")
    rep1 = r1.run()
    r2 = SimRunner(load_trace(path), seed=SEED, scenario="smoke",
                   device="cpu")
    rep2 = r2.run()
    assert r1.binder.sequence == r2.binder.sequence
    assert r1.evictor.sequence == r2.evictor.sequence
    assert r1.jct == r2.jct
    assert deterministic_json(rep1) == deterministic_json(rep2)
    assert rep1["jobs"]["arrived"] == rep1["jobs"]["completed"] == 60
    assert rep1["jobs"]["unfinished"] == 0
    assert rep1["binds"] >= 60
    for key in ("jct_s", "queueing_delay_s", "gang_admission_s"):
        assert {"p50", "p95", "p99", "mean", "max"} <= set(rep1[key])
    assert rep1["utilization"]["cpu_mean"] > 0
    assert rep1["wallclock"]["pipeline_e2e_ms"]["p50"] > 0
    assert {"enqueue", "allocate", "preempt", "reclaim", "backfill"} \
        <= set(rep1["wallclock"]["actions_ms"])


def test_sim_deterministic_with_tpu_engine():
    """The sim drives the device engine's plain path too: a small trace
    through allocate-tpu replays deterministically, with no failure."""
    conf = (
        'actions: "enqueue, allocate-tpu, backfill"\n'
        "tiers:\n"
        "- plugins:\n"
        "  - name: priority\n"
        "  - name: gang\n"
        "- plugins:\n"
        "  - name: drf\n"
        "  - name: predicates\n"
        "  - name: proportion\n"
        "  - name: nodeorder\n")
    trace = synthetic_trace(6, 4, seed=SEED, arrival_rate=3.0,
                            duration_mean=2.0, duration_cap=6.0,
                            gang_sizes=((1, 0.6), (2, 0.4)))
    rep1 = SimRunner(trace, conf_text=conf, seed=SEED, device="cpu").run()
    rep2 = SimRunner(trace, conf_text=conf, seed=SEED, device="cpu").run()
    assert deterministic_json(rep1) == deterministic_json(rep2)
    assert rep1["jobs"]["completed"] == 6
    assert rep1["action_failures"] == 0


# -- chaos composition -----------------------------------------------------

def test_sim_chaos_bind_faults_converge():
    """20% seeded bind faults over >= 50 virtual cycles: every gang still
    admits and completes through the virtual-time resync queue, each task
    binds exactly once, and the drained cluster's accounting is exact."""
    trace = synthetic_trace(80, 8, seed=SEED, arrival_rate=1.6,
                            duration_mean=5.0, duration_cap=20.0)
    runner = SimRunner(trace, seed=SEED, device="cpu",
                       binder_wrap=lambda b: ChaosBinder(
                           b, failure_rate=0.2, seed=SEED))
    report = runner.run()
    assert runner.cache.binder.failures > 0, f"seed={SEED}"
    assert report["cycles"] >= 50
    assert report["jobs"]["completed"] == 80, report["jobs"]
    assert report["dead_letter"] == 0
    uids = [uid for uid, _ in runner.binder.sequence]
    assert len(uids) == len(set(uids)), f"seed={SEED}: double-bind"
    for node in runner.cache.nodes.values():
        assert not node.tasks
        assert node.used.is_empty()
        assert node.idle.less_equal(node.allocatable) \
            and node.allocatable.less_equal(node.idle)


def test_sim_chaos_deterministic():
    def run():
        trace = synthetic_trace(30, 6, seed=SEED, arrival_rate=2.0,
                                duration_mean=4.0, duration_cap=12.0)
        runner = SimRunner(trace, seed=SEED, device="cpu",
                           binder_wrap=lambda b: ChaosBinder(
                               b, failure_rate=0.25, seed=SEED + 1))
        rep = runner.run()
        return runner.binder.sequence, deterministic_json(rep)

    assert run() == run()


# -- node lifecycle and preemption -----------------------------------------

def test_sim_node_drain_and_fail():
    """A drained node stops receiving placements but its tasks finish; a
    failed node's tasks re-queue and their gangs re-admit elsewhere."""
    events = [TraceEvent(10.0, "node_drain", {"name": "node-00000"}),
              TraceEvent(12.0, "node_fail", {"name": "node-00001"}),
              TraceEvent(30.0, "node_restore", {"name": "node-00000"})]
    trace = synthetic_trace(50, 5, seed=SEED, arrival_rate=1.5,
                            duration_mean=6.0, duration_cap=20.0,
                            extra_events=events)
    runner = SimRunner(trace, seed=SEED, device="cpu")
    report = runner.run()
    assert "node-00001" not in runner.cache.nodes
    assert report["jobs"]["completed"] == 50, report["jobs"]
    assert report["requeues"] > 0
    assert runner.cache.nodes["node-00000"].ready
    assert report["jobs"]["admitted"] >= report["jobs"]["arrived"]


def test_sim_preemption_requeues_and_completes():
    trace = make_scenario("preempt-burst", seed=0)
    runner = SimRunner(trace, seed=0, scenario="preempt-burst",
                       max_cycles=3000, device="cpu")
    report = runner.run()
    assert report["evicts"] > 0, "the wave preempted nothing"
    assert report["requeues"] == report["evicts"]
    assert report["jobs"]["completed"] == report["jobs"]["arrived"]


def test_baseline_degenerate_trace():
    trace = baseline_trace("tiny", seed=0, duration=3.0)
    report = SimRunner(trace, seed=0, scenario="baseline-tiny",
                       device="cpu").run()
    assert report["jobs"] == {"arrived": 1, "admitted": 1, "completed": 1,
                              "unfinished": 0}
    assert report["binds"] == 3
    assert report["gang_admission_s"]["max"] == 0.0
    assert report["jct_s"]["max"] >= 3.0


# -- the CLI ---------------------------------------------------------------

def test_sim_cli_needs_the_card_unless_asked(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    assert sim_main(["--scenario", "smoke", "--deterministic"]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "--device cpu" in captured.err


def test_sim_cli_list_and_restart_equivalence(capsys):
    assert sim_main(["--list"]) == 0
    assert "preempt-burst" in capsys.readouterr().out
    assert sim_main(["--device", "cpu", "--scenario", "smoke",
                     "--chaos-rate", "0.2", "--kill-cycles", "3,7,12",
                     "--verify-restart-equivalence"]) == 0
    assert "restart-equivalence OK" in capsys.readouterr().err


# -- byte identity with the JAX package ------------------------------------

@pytest.mark.parametrize("scenario, args", LIVE_RUNS,
                         ids=[_key(s, a) for s, a in LIVE_RUNS])
def test_sim_bytes_match_jax(jax_live, scenario, args):
    """The port's decision plane is the JAX package's, byte for byte, and
    so is every bind's node and every eviction, in order, and every
    allocate solve's node-tensor path (a kill and restart starts a cold
    tensor cache in both)."""
    want, want_sequence, want_paths = jax_live[_key(scenario, args)]
    text, sequence, paths = port_run(scenario, args)
    assert text == want
    assert sequence == want_sequence
    assert paths == want_paths


def test_sim_cycle_budget_bytes_match_jax(jax_live):
    """--cycle-budget reaches the shell's budget: actions defer with
    carry-over exactly as in the JAX package."""
    text, sequence, paths = port_run(*BUDGET_RUN)
    assert (text, sequence, paths) == jax_live[_key(*BUDGET_RUN)]
    budget = json.loads(text)["overload"]["cycle_budget"]
    assert budget["exhausted"] > 0 and budget["deferred_actions"] > 0


@pytest.mark.parametrize("scenario, args", LIVE_RUNS,
                         ids=[_key(s, a) for s, a in LIVE_RUNS])
def test_digest_file_holds_the_jax_package(jax_live, digests, scenario,
                                           args):
    """The committed digests cannot drift from the JAX package: the
    smoke entries are recomputed from it here."""
    run = digests[_key(scenario, args)]
    text, sequence, paths = jax_live[_key(scenario, args)]
    assert run["sha256"] == hashlib.sha256(text).hexdigest()
    assert run["tensor_paths"] == paths
    assert run["bytes"] == len(text)
    assert (run["sequence_sha256"], run["sequence_binds"],
            run["sequence_evicts"]) == (sequence["sha256"],
                                        sequence["binds"],
                                        sequence["evicts"])
    # smoke evicts nothing, so the JAX walk's two modes agree there
    assert run["default_walk_sha256"] == run["sha256"]
    assert run["default_walk_sequence_sha256"] == run["sequence_sha256"]


@pytest.mark.parametrize("scenario, args", DIGEST_RUNS,
                         ids=[_key(s, a) for s, a in DIGEST_RUNS])
def test_sim_bytes_match_committed_digest(digests, scenario, args):
    """skew (reclaim), preempt-burst (the preempt walk, B3's plain
    version here) and baseline-10k (BASELINE config 3) under
    deploy/scheduler.conf, held to the JAX package's digests, node-tensor
    paths included."""
    text, sequence, paths = port_run(scenario, args)
    run = digests[_key(scenario, args)]
    assert hashlib.sha256(text).hexdigest() == run["sha256"]
    assert len(text) == run["bytes"]
    assert (sequence["sha256"], sequence["binds"], sequence["evicts"]) \
        == (run["sequence_sha256"], run["sequence_binds"],
            run["sequence_evicts"])
    assert paths == run["tensor_paths"]
    report = json.loads(text)
    assert report["action_failures"] == 0 and report["double_binds"] == 0
    if scenario == "baseline-10k":
        assert report["binds"] == 10000


def test_walk_fill_schedule_fault_recorded(tmp_path):
    """The JAX walk's default closed-form fill is not its per-task
    formulation: on fill-rank-shrink (preempt-burst's cycle 47 in
    miniature) it places a gang the per-task walk rolls back. The port
    follows the per-task walk (and the callbacks engine); the digests
    record both modes, and the default differs exactly on the runs that
    preempt."""
    from volcano_tpu_torch.ops.evict import to_device, walk_plain
    default, exact = jax_reference("walk-modes", ["fill-rank-shrink"],
                                   tmp_path / "walk.pkl")["fill-rank-shrink"]
    inputs, kinds, sizes, gang = FAULT_WALK_WORLDS["fill-rank-shrink"]()
    out = walk_plain(to_device(inputs, "cpu"), kinds, sizes, gang)
    np.testing.assert_array_equal(default[0], [0, 0])
    np.testing.assert_array_equal(exact[0], [-1, -1])
    np.testing.assert_array_equal(out.task_node.numpy(), exact[0])
    np.testing.assert_array_equal(out.owner.numpy(), exact[1])
    np.testing.assert_array_equal(out.job_done.numpy(), exact[2])
    doc = json.loads((REPO / "tests" / "sim_reference_digests.json")
                     .read_text())
    differs = sorted(run["key"] for run in doc["runs"]
                     if run["default_walk_sha256"] != run["sha256"])
    # preempt-burst four times: with the incremental snapshot on and
    # off, under the flight recorder's flags and store-wired under store
    # chaos
    off = "VOLCANO_TPU_INCREMENTAL_SNAPSHOT=0 "
    recorded = "VOLCANO_TPU_AUDIT_CYCLES=100000 "
    assert differs == sorted([_key(s, ("--conf", DEPLOYED))
                              for s in ("preempt-burst", "skew")]
                             + [off + _key("preempt-burst",
                                           ("--conf", DEPLOYED))]
                             + [recorded + _key(
                                 "preempt-burst",
                                 ("--conf", DEPLOYED, "--lifecycle",
                                  "--trace-out"))]
                             + [_key("preempt-burst",
                                     ("--conf", DEPLOYED,
                                      "--store-chaos"))])


def test_walk_fault_witnessed_by_the_callbacks_engine(tmp_path, digests,
                                                      jax_live):
    """A witness outside the walk's two formulations: preempt-burst under
    deploy/scheduler.conf with preempt and reclaim on the host callbacks
    engine, which never reaches a walk. Its decision plane is the per-task
    walk's digest, not the default fill's: the gang of cycle 47 is rolled
    back. (It evicts another victim of the same job at that cycle, so its
    side-effect sequence is its own.) The port's callbacks engine decides
    as the JAX package's on the whole run, holding the witness to the
    reference."""
    conf = tmp_path / "callbacks.conf"
    conf.write_text(_callbacks_conf())
    text, sequence, paths = port_run("preempt-burst",
                                     ("--conf", str(conf)))
    run = digests[_key("preempt-burst", ("--conf", DEPLOYED))]
    assert hashlib.sha256(text).hexdigest() == run["sha256"]
    assert hashlib.sha256(text).hexdigest() != run["default_walk_sha256"]
    assert (text, sequence, paths) == jax_live[CALLBACKS_KEY]
    assert sequence["evicts"] > 0
