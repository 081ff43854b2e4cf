"""The flight recorder through the port's sim on the CPU: ``python -m
volcano_tpu_torch.sim --lifecycle --trace-out F`` on smoke, preempt-burst
under deploy/scheduler.conf (B3's walk), elastic-churn under the deployed
elastic conf at topology weight 10 (B6) and pipelined-conflict with fast
admit, each held to the JAX package's records in
tests/sim_reference_digests.json (tools/sim_reference.py's OBS_RUNS): the
report with its latency and slo sections, the side-effect sequence, the
node-tensor paths, and the recorder's own output — the Chrome trace (each
``solve`` span's ``kernel`` attribute, which names the solve's route,
replaced by one placeholder), every decision-audit record and every job's
timeline events. The same runs must keep the decision plane, sequence and
node-tensor paths of the run without the flags: observing decides nothing.
baseline-10k at full width runs on the card (chip_smoke.py's ``obs``
phase)."""

import contextlib
import hashlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import pytest

from volcano_tpu_torch import obs as pt_obs
from volcano_tpu_torch.actions import allocate as torch_allocate
from volcano_tpu_torch.cache import SchedulerCache
from volcano_tpu_torch.obs import audit as pt_audit
from volcano_tpu_torch.obs import trace as pt_trace
from volcano_tpu_torch.obs import validate as pt_validate
from volcano_tpu_torch.sim.__main__ import REFUSED_FLAGS
from volcano_tpu_torch.sim.__main__ import main as sim_main
from volcano_tpu_torch.sim.report import sequence_digest

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
# the flight-recorder runs the CPU holds here (baseline-10k: the card)
RUNS = [r for r in TOOL.OBS_RUNS if r[0] != "baseline-10k"]
IDS = [TOOL.run_key(*r) for r in RUNS]


def plain_key(source, args, env) -> str:
    """The key of the same run without the flight-recorder flags."""
    return TOOL.run_key(source, tuple(a for a in args if a not in TOOL.OBS))


@pytest.fixture(scope="module")
def digests():
    doc = json.loads((REPO / "tests" / "sim_reference_digests.json")
                     .read_text())
    return {run["key"]: run for run in doc["runs"]}


@pytest.fixture(scope="module")
def trace_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sim-traces"))


@contextlib.contextmanager
def audit_ring(cycles: int):
    """The process-wide audit ring at ``cycles`` (what
    VOLCANO_TPU_AUDIT_CYCLES sets at import), back at the default after."""
    pt_obs.AUDIT.configure(cycles)
    try:
        yield
    finally:
        pt_obs.AUDIT.configure(pt_audit._default_cycles())


def port_run(source, args, env, trace_dir, out_dir):
    """One port sim run on the CPU with the environment's audit ring: the
    printed plane, the sequence digest, the node-tensor paths, the trace
    object, the recorder's state and the report."""
    env = dict(env)
    argv = TOOL.conf_args(args, trace_dir)
    path = None
    if argv[-1:] == ["--trace-out"]:
        path = str(out_dir / "trace.json")
        argv.append(path)
    out = io.StringIO()
    runners = []
    paths = TensorPathRecorder(torch_allocate, SchedulerCache)
    try:
        with audit_ring(int(env.get("VOLCANO_TPU_AUDIT_CYCLES",
                                    pt_audit._default_cycles()))):
            with contextlib.redirect_stdout(out):
                rc = sim_main(["--device", "cpu",
                               *TOOL.sim_argv(source, trace_dir),
                               "--deterministic", *argv], runners=runners)
            state = TOOL.recorder_state(pt_obs)
    finally:
        paths.close()
        # the sim leaves the recorder off; back to the default ring and
        # clock
        pt_obs.TRACE.configure(max_cycles=pt_trace.DEFAULT_MAX_CYCLES,
                               logical=False)
    assert rc == 0
    trace = json.loads(Path(path).read_text()) if path else None
    text = out.getvalue().encode()
    return {"text": text, "sequence": sequence_digest(runners[0]),
            "paths": paths.summary(), "trace": trace, "trace_path": path,
            "state": state, "report": json.loads(text),
            "runner": runners[0]}


@pytest.fixture(scope="module")
def runs(trace_dir, tmp_path_factory):
    """Each flight-recorder run, once for the module."""
    cache = {}

    def get(run):
        key = TOOL.run_key(*run)
        if key not in cache:
            cache[key] = port_run(*run, trace_dir,
                                  tmp_path_factory.mktemp("obs"))
        return cache[key]
    return get


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_obs_run_matches_jax(digests, runs, run):
    """Report (latency and slo included), sequence, node-tensor paths,
    trace, audit records and timelines: the JAX package's."""
    got, want = runs(run), digests[TOOL.run_key(*run)]
    assert hashlib.sha256(got["text"]).hexdigest() == want["sha256"]
    assert len(got["text"]) == want["bytes"]
    assert (got["sequence"]["sha256"], got["sequence"]["binds"],
            got["sequence"]["evicts"]) == (want["sequence_sha256"],
                                           want["sequence_binds"],
                                           want["sequence_evicts"])
    assert got["paths"] == want["tensor_paths"]
    assert TOOL.obs_digests(got["trace"], *got["state"]) == want["obs"]
    assert {"latency", "slo"} <= set(got["report"])


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_flags_leave_the_decision_plane(digests, runs, run):
    """Without its latency and slo sections the report is the run's
    without the flags, byte for byte; so are its side effects and its
    solves' node-tensor paths (on the card: each kernel's launches)."""
    got, plain = runs(run), digests[plain_key(*run)]
    report = dict(got["report"])
    report.pop("latency")
    report.pop("slo")
    text = (json.dumps(report, sort_keys=True, separators=(",", ":"))
            + "\n").encode()
    assert hashlib.sha256(text).hexdigest() == plain["sha256"]
    assert got["sequence"]["sha256"] == plain["sequence_sha256"]
    assert got["paths"] == plain["tensor_paths"]


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_trace_validates(runs, run, capsys):
    got = runs(run)
    assert pt_obs.validate_chrome_trace(got["trace"]) > 0
    assert pt_validate.main([got["trace_path"]]) == 0
    names = {ev["name"] for ev in got["trace"]["traceEvents"]}
    assert {"cycle", "schedule", "open_session", "snapshot", "audit",
            "job_updater", "enqueue_gate", "backfill_scan"} <= names
    # one thread: the side stream of the pipelined cycle is CUDA's, not a
    # thread's
    assert {ev["tid"] for ev in got["trace"]["traceEvents"]} == {1}
    capsys.readouterr()


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_latency_agrees_with_the_report(runs, run):
    """The timeline-derived ttfb and jct sample the instants the report's
    queueing delay and JCT do, job for job."""
    from volcano_tpu_torch.obs.lifecycle import job_latency
    got = runs(run)
    lat = [job_latency(events) for _, events in got["state"][1]]
    ttfb = sorted(x["ttfb_s"] for x in lat if "ttfb_s" in x)
    jct = sorted(x["jct_s"] for x in lat if "jct_s" in x)
    runner = got["runner"]
    assert ttfb == sorted(round(v, 6) for v in runner.queueing_delay)
    assert jct == sorted(round(v, 6) for v in runner.jct)
    assert got["report"]["latency"]["timeline"]["jobs"] == runner.arrived


def test_smoke_matches_jax_live(runs):
    """The smoke run against the JAX package computed here, not only
    against the committed digests."""
    run = RUNS[0]
    assert run[0] == "smoke"
    proc = TOOL.start(*run[:2], "exact", run[2])
    text, record = TOOL.finish_record(proc, timeout=900)
    got = runs(run)
    assert got["text"] == text
    assert TOOL.obs_digests(got["trace"], *got["state"]) == record["obs"]


def test_recording_off_keeps_the_plane(digests, trace_dir, tmp_path):
    """VOLCANO_TPU_TIMELINE=0 and VOLCANO_TPU_AUDIT_CYCLES=0: nothing is
    recorded, and the run decides as with recording on."""
    pt_obs.TIMELINE.enabled = False
    try:
        got = port_run("smoke", (), (("VOLCANO_TPU_AUDIT_CYCLES", "0"),),
                       trace_dir, tmp_path)
        assert pt_obs.TIMELINE.jobs() == []
        assert got["state"] == ([], [])
    finally:
        pt_obs.TIMELINE.enabled = True
    want = digests["--scenario smoke"]
    assert hashlib.sha256(got["text"]).hexdigest() == want["sha256"]
    assert got["sequence"]["sha256"] == want["sequence_sha256"]


@pytest.mark.parametrize("index, cycles", [(0, 4), (1, None)],
                         ids=["smoke-4", "preempt-burst-default"])
def test_audit_ring_keeps_the_last_cycles(runs, trace_dir, tmp_path, index,
                                          cycles):
    """With a ring of N cycles (the default 32 when unset) the audit keeps
    the records of the last N cycles that changed something, those of the
    whole run's audit: preempt-burst changes something in more cycles than
    the default ring holds."""
    source, args, _ = RUNS[index]
    full = runs(RUNS[index])["state"][0]
    env = () if cycles is None else (("VOLCANO_TPU_AUDIT_CYCLES",
                                      str(cycles)),)
    got = port_run(source, tuple(a for a in args if a not in TOOL.OBS), env,
                   trace_dir, tmp_path)
    n = pt_audit._default_cycles() if cycles is None else cycles
    changed = sorted({r["cycle"] for r in full})
    assert len(changed) > n
    kept = set(changed[-n:])
    assert got["state"][0] == [r for r in full if r["cycle"] in kept]


def test_trace_out_and_lifecycle_are_not_refused():
    assert "--trace-out" not in REFUSED_FLAGS
    assert "--lifecycle" not in REFUSED_FLAGS
