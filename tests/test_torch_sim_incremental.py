"""The port's sim with the incremental snapshot and the persistent node
tensors on (the default) and off (VOLCANO_TPU_INCREMENTAL_SNAPSHOT=0),
held to the JAX package run for run under deploy/scheduler.conf: the
decision plane's bytes, every bind's node and every eviction in order, and
the node-tensor path of every allocate solve (persistent rows or a fresh
build; a full rebuild or a scatter, and its rows) with each drift the
shadow verifier repaired (tools/sim_traces.py::TensorPathRecorder).

The runs are the traces of tools/sim_traces.py (``churn``: node-flap with
two node deaths and two fresh nodes; ``hole-10k``: BASELINE config 3 with
spare nodes, a node death and a fresh node that takes its row) and
scenario runs with the switch off. Their JAX references are the committed
entries of tests/sim_reference_digests.json (tools/sim_reference.py);
smoke with the switch off is recomputed here from the JAX package, so the
file's off entries cannot drift from it.
"""

import contextlib
import hashlib
import importlib.util
import io
import json
import os
import sys
from pathlib import Path

import pytest

from volcano_tpu_torch.actions import allocate as torch_allocate
from volcano_tpu_torch.cache import SchedulerCache
from volcano_tpu_torch.sim.__main__ import main as sim_main
from volcano_tpu_torch.sim.report import sequence_digest

from torch_parity import port_gc_windows  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
from sim_traces import TensorPathRecorder  # noqa: E402

DEPLOYED = ("--conf", "deploy/scheduler.conf")
OFF = (("VOLCANO_TPU_INCREMENTAL_SNAPSHOT", "0"),)
# (source, args, env) of tools/sim_reference.py's RUNS held on the CPU
RUNS = [("trace:churn", DEPLOYED, ()),
        ("trace:hole-10k", DEPLOYED, ()),
        ("smoke", DEPLOYED, OFF),
        ("preempt-burst", DEPLOYED, OFF),
        ("baseline-10k", DEPLOYED, OFF),
        ("trace:churn", DEPLOYED, OFF),
        ("trace:hole-10k", DEPLOYED, OFF)]
LIVE = ("smoke", DEPLOYED, OFF)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "sim_reference", REPO / "tools" / "sim_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()


@pytest.fixture(scope="module")
def digests():
    doc = json.loads((REPO / "tests" / "sim_reference_digests.json")
                     .read_text())
    return {run["key"]: run for run in doc["runs"]}


@pytest.fixture(scope="module")
def trace_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("traces"))


def port_run(source, args, env, trace_dir, monkeypatch):
    """What ``python -m volcano_tpu_torch.sim --device cpu
    --deterministic`` prints for one run, its sequence digest and the
    summary of its solves' node-tensor paths."""
    for k, v in env:
        monkeypatch.setenv(k, v)
    out = io.StringIO()
    runners = []
    paths = TensorPathRecorder(torch_allocate, SchedulerCache)
    try:
        with contextlib.redirect_stdout(out):
            rc = sim_main(["--device", "cpu",
                           *TOOL.sim_argv(source, trace_dir),
                           "--deterministic", *args], runners=runners)
    finally:
        paths.close()
    assert rc == 0
    return (out.getvalue().encode(), sequence_digest(runners[0]),
            paths.summary())


@pytest.fixture(scope="module")
def jax_live():
    """The JAX sim's bytes and record for LIVE, computed here."""
    source, args, env = LIVE
    return TOOL.finish_record(TOOL.start(source, args, "exact", env),
                              timeout=900)


@pytest.mark.parametrize("source, args, env", RUNS,
                         ids=[TOOL.run_key(*r) for r in RUNS])
def test_sim_matches_jax_digest(digests, trace_dir, monkeypatch, source,
                                args, env):
    """Bytes, side-effect sequence, node-tensor paths solve by solve, and
    drift repairs: the JAX package's, with the switch on and off."""
    text, sequence, paths = port_run(source, args, env, trace_dir,
                                     monkeypatch)
    run = digests[TOOL.run_key(source, args, env)]
    assert hashlib.sha256(text).hexdigest() == run["sha256"]
    assert len(text) == run["bytes"]
    assert (sequence["sha256"], sequence["binds"], sequence["evicts"]) \
        == (run["sequence_sha256"], run["sequence_binds"],
            run["sequence_evicts"])
    assert paths == run["tensor_paths"]
    report = json.loads(text)
    assert report["action_failures"] == 0 and report["double_binds"] == 0
    if env == OFF:
        assert paths["persistent"] == 0 and paths["fresh"] > 0
    else:
        assert paths["scatter"] > 0
    if source == "trace:hole-10k":
        assert report["binds"] == 10004


def test_hole_10k_takes_the_scatter_path_in_cycle_3(digests):
    """The full-width hole world's third cycle scatters (both packages
    record it): the spare node's hole is refilled, not rebuilt."""
    on = digests[TOOL.run_key("trace:hole-10k", DEPLOYED, ())]
    off = digests[TOOL.run_key("trace:hole-10k", DEPLOYED, OFF)]
    assert on["tensor_paths"]["scatter"] >= 1
    assert on["tensor_paths"]["full"] == 2
    # rows follow the hole with the switch on, snapshot order off
    assert on["sequence_sha256"] != off["sequence_sha256"]


def test_off_digest_holds_the_jax_package(digests, trace_dir, monkeypatch,
                                          jax_live):
    """The committed switch-off smoke entry is the JAX package's, and the
    port's run equals it live."""
    text, record = jax_live
    run = digests[TOOL.run_key(*LIVE)]
    assert run["sha256"] == hashlib.sha256(text).hexdigest()
    assert run["tensor_paths"] == record["tensor_paths"]
    got_text, sequence, paths = port_run(*LIVE, trace_dir, monkeypatch)
    assert got_text == text
    assert sequence["sha256"] == record["sha256"]
    assert paths == record["tensor_paths"]


def test_steady_10k_matches_jax_digest(digests, trace_dir, monkeypatch):
    """steady-10k (10,500 gangs on 300 nodes, 582 cycles) with the switch
    on: its persistent rows scatter hundreds of times, and the shadow
    verifier repairs (false) tensor drift eight times, as in the JAX
    package."""
    args = DEPLOYED
    text, sequence, paths = port_run("steady-10k", args, (), trace_dir,
                                     monkeypatch)
    run = digests[TOOL.run_key("steady-10k", args)]
    assert hashlib.sha256(text).hexdigest() == run["sha256"]
    assert sequence["sha256"] == run["sequence_sha256"]
    assert paths == run["tensor_paths"]
    assert paths["scatter"] > 0 and len(paths["drift"]) == 8


def test_trace_files_are_reproducible(tmp_path):
    """The traces of tools/sim_traces.py are a function of the code: two
    writes give the same bytes, and the churn trace is node-flap plus its
    four node events."""
    from sim_traces import churn_trace, write_trace_file
    from volcano_tpu_torch.sim.workload import make_scenario
    a = write_trace_file("hole-10k", str(tmp_path / "a.jsonl"))
    b = write_trace_file("hole-10k", str(tmp_path / "b.jsonl"))
    assert Path(a).read_bytes() == Path(b).read_bytes()
    churn = churn_trace()
    base = make_scenario("node-flap", seed=0)
    extra = [ev for ev in churn if ev not in base]
    assert len(churn) == len(base) + 4
    assert [(ev.t, ev.kind, ev.data["name"]) for ev in extra] == [
        (20.0, "node_fail", "node-00012"), (20.0, "node_fail", "node-00013"),
        (22.0, "node_add", "node-x0"), (22.0, "node_add", "node-x1")]
    assert os.path.getsize(a) > 0
