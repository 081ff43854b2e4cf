"""The object store and the feedback watch path through the port's sim on
the CPU: ``--store-wired`` (every pod, podgroup and queue a store object,
the cache fed by resumable informers, the executors writing through the
retrying transport), ``--store-chaos`` (seeded verb faults and torn watch
streams) and ``--ack-chaos`` (seeded ack faults on the ack wire, or
store-wired on the watch path). Each run of tools/sim_reference.py's
STORE_RUNS that the CPU holds is compared with the JAX package's digests
in tests/sim_reference_digests.json: the report with its store and
feedback sections, the side-effect sequence and the node-tensor paths.
preempt-burst and the full-width baseline-10k run on the card
(chip_smoke.py's ``store`` phase). Under the sim's default conf, whose
engines are the host's, the JAX package also runs live in this process,
with kills and other seeds."""

import contextlib
import hashlib
import importlib.util
import io
import json
import logging
import sys
import time
from pathlib import Path

import pytest

from volcano_tpu_torch.actions import allocate as torch_allocate
from volcano_tpu_torch.cache import SchedulerCache
from volcano_tpu_torch.device_health import DEVICE_HEALTH
from volcano_tpu_torch.sim.__main__ import REFUSED_FLAGS
from volcano_tpu_torch.sim.__main__ import main as sim_main
from volcano_tpu_torch.sim.report import (deterministic_json,
                                          sequence_digest,
                                          terminal_accounting)
from volcano_tpu_torch.sim.runner import SimRunner
from volcano_tpu_torch.sim.workload import make_scenario

from torch_parity import port_gc_windows  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
from sim_traces import TensorPathRecorder  # noqa: E402


def _tool():
    spec = importlib.util.spec_from_file_location(
        "sim_reference", REPO / "tools" / "sim_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()
# the store runs the CPU holds here (preempt-burst and baseline-10k: the
# card)
RUNS = [r for r in TOOL.STORE_RUNS
        if r[0] not in ("preempt-burst", "baseline-10k")]
IDS = [TOOL.run_key(*r) for r in RUNS]


@pytest.fixture(scope="module")
def digests():
    doc = json.loads((REPO / "tests" / "sim_reference_digests.json")
                     .read_text())
    return {run["key"]: run for run in doc["runs"]}


def port_run(source, args, extra=()):
    """One port sim run on the CPU: the printed report, the sequence
    digest, the node-tensor paths, the report and the exit code."""
    out = io.StringIO()
    runners = []
    paths = TensorPathRecorder(torch_allocate, SchedulerCache)
    try:
        with contextlib.redirect_stdout(out):
            rc = sim_main(["--device", "cpu", "--scenario", source,
                           "--deterministic", *args, *extra],
                          runners=runners)
    finally:
        paths.close()
    text = out.getvalue().encode()
    return {"rc": rc, "text": text, "sequence": sequence_digest(runners[0]),
            "paths": paths.summary(), "report": json.loads(text)}


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(run):
        key = TOOL.run_key(*run)
        if key not in cache:
            cache[key] = port_run(run[0], run[1])
        return cache[key]
    return get


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_store_run_matches_jax(digests, runs, run):
    """Report (store and feedback sections included), sequence and
    node-tensor paths: the JAX package's."""
    got, want = runs(run), digests[TOOL.run_key(*run)]
    assert got["rc"] == 0
    assert hashlib.sha256(got["text"]).hexdigest() == want["sha256"]
    assert len(got["text"]) == want["bytes"]
    assert (got["sequence"]["sha256"], got["sequence"]["binds"],
            got["sequence"]["evicts"]) == (want["sequence_sha256"],
                                           want["sequence_binds"],
                                           want["sequence_evicts"])
    assert got["paths"] == want["tensor_paths"]


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_store_run_sections(runs, run):
    """What each mode adds to the report, and the zero-stuck witnesses."""
    source, args, _ = run
    report = runs(run)["report"]
    wired = "--store-wired" in args or "--store-chaos" in args
    assert ("store" in report) == wired
    assert ("feedback" in report) == ("--ack-chaos" in args)
    assert report["action_failures"] == 0 and report["double_binds"] == 0
    assert report["jobs"]["completed"] == report["jobs"]["arrived"]
    if wired:
        assert report["store"]["pending_submissions"] == 0
    if "--store-chaos" in args:
        st = report["store"]
        assert sum(st["faults"].values()) > 0
        assert st["torn_watch_events"] == 2
        assert st["watch_resumes"] + st["watch_relists"] > 0
    if "--ack-chaos" in args:
        fb = report["feedback"]
        assert sum(fb["faults"].values()) > 0
        assert fb["inflight_open"] == 0 and fb["wire_pending"] == 0


def test_store_wired_decides_as_direct_mode(runs, digests):
    """The informer path changes how the cache learns the world, not what
    the scheduler decides: smoke store-wired binds as the direct run does
    under the same conf."""
    wired = runs(RUNS[0])
    direct = digests["--scenario smoke --conf deploy/scheduler.conf"]
    assert wired["sequence"]["sha256"] == direct["sequence_sha256"]


@pytest.mark.parametrize("flag", ["--verify-store-equivalence",
                                  "--verify-ack-equivalence"])
def test_verify_flags_pass(flag):
    extra = ["--store-chaos"] if flag == "--verify-store-equivalence" \
        else ["--ack-chaos", "--store-wired"]
    got = port_run("smoke", [*extra, flag])
    assert got["rc"] == 0


def test_store_chaos_logs_conflicts_and_fails_no_action(caplog):
    """A 409 at the store boundary is logged and retried through the
    resync machinery, never an action failure."""
    with caplog.at_level(logging.ERROR):
        got = port_run("smoke", ["--conf", "deploy/scheduler.conf",
                                 "--store-chaos"])
    assert got["report"]["action_failures"] == 0
    conflicts = [r for r in caplog.records if r.exc_info
                 and type(r.exc_info[1]).__name__ == "ConflictError"]
    assert conflicts, "no 409 was logged"
    assert got["report"]["store"]["faults"].get("conflict", 0) > 0


@pytest.mark.parametrize("extra, message", [
    (["--store-wired", "--pipelined"],
     "store_wired and pipelined/fast_admit are separate modes"),
    (["--store-wired", "--fast-admit"],
     "store_wired and pipelined/fast_admit are separate modes"),
])
def test_store_wired_refuses_the_pipelined_shell(extra, message):
    """The JAX runner's ValueError, with its message."""
    with pytest.raises(ValueError, match=message):
        port_run("smoke", extra)


def test_cli_errors(capsys):
    for argv in (["--store-wired", "--elastic-gangs"],
                 ["--verify-ack-equivalence"]):
        with pytest.raises(SystemExit) as exc:
            sim_main(["--device", "cpu", "--scenario", "smoke", *argv])
        assert exc.value.code == 2
    capsys.readouterr()
    for flag in ("--store-wired", "--store-chaos", "--ack-chaos",
                 "--torn-watches"):
        assert flag not in REFUSED_FLAGS


# the JAX package live, in this process: the sim's default conf runs host
# engines only, so no XLA program decides anything here
LIVE = [
    ("smoke", 3, {"store_wired": True}),
    ("smoke", 3, {"store_wired": True, "ack_fault_rate": 0.4}),
    ("smoke", 3, {"ack_fault_rate": 0.3}),
    ("smoke", 5, {"store_wired": True, "store_fault_rate": 0.2,
                  "torn_watches": 2, "kill_cycles": [5, 12]}),
    ("preempt-burst", 1, {"store_wired": True, "store_fault_rate": 0.2,
                          "torn_watches": 2}),
]


def _jax_runner():
    from volcano_tpu.sim.runner import SimRunner as JaxRunner
    from volcano_tpu.sim.workload import make_scenario as jax_scenario
    return JaxRunner, jax_scenario


@pytest.mark.parametrize("scenario, seed, kw", LIVE,
                         ids=[f"{s}-{seed}-{'-'.join(sorted(kw))}"
                              for s, seed, kw in LIVE])
def test_live_runs_equal_jax(scenario, seed, kw):
    JaxRunner, jax_scenario = _jax_runner()
    jr = JaxRunner(jax_scenario(scenario, seed=seed), seed=seed,
                   scenario=scenario, **kw)
    want = jr.run()
    pr = SimRunner(make_scenario(scenario, seed=seed), seed=seed,
                   scenario=scenario, device="cpu", **kw)
    got = pr.run()
    assert deterministic_json(got) == deterministic_json(want)
    assert [list(b) for b in pr.binder.sequence] \
        == [list(b) for b in jr.binder.sequence]
    assert list(pr.evictor.sequence) == list(jr.evictor.sequence)
    assert terminal_accounting(got)["double_binds"] == 0
    if kw.get("kill_cycles"):
        assert got["restarts"] == len(kw["kill_cycles"])


def test_the_cool_down_clock_goes_back_to_wall_time():
    """The sim runs the device cool-down on its virtual clock and hands it
    back to wall time at the end, so no window leaks into the next run."""
    SimRunner(make_scenario("smoke", seed=3), seed=3, scenario="smoke",
              device="cpu", store_wired=True).run()
    assert DEVICE_HEALTH.time_fn is time.monotonic
    assert DEVICE_HEALTH.available()
