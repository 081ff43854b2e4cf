"""The port's sim with elastic gangs (``--elastic-gangs``) on the CPU, held
to the JAX package run for run: the decision plane's bytes, every bind's
node and every eviction in order, and each allocate solve's node-tensor
path (tools/sim_traces.py::TensorPathRecorder).

The runs are tools/sim_reference.py's elastic entries: ``elastic-churn``
(12 nodes in 3 zones, eight min/desired gangs, rigid filler waves, the
command funnel's suspend/resume/scale verbs, node churn) under the JAX
sim's own elastic conf (runner.elastic_sim_conf) and under
deploy/scheduler.conf with elastic gangs (tools/sim_traces.py::
elastic_deployed_conf, where a positive weight makes tpu-fused's solve the
zone-anchor mode, B6), each at topology weight 10 and 0, and the
full-width ``elastic-10k`` trace under the latter. The elastic-churn runs
are recomputed here from the JAX package; every run is also held to its
committed entry in tests/sim_reference_digests.json.

The JAX package's persistent node tensors lack the zone codes its
positive-weight solve reads, so under its default incremental snapshot
that solve raises and falls back to the sequential placer (ROADMAP §3).
The reference runs mend the class; ``test_jax_default_falls_back_without
_zone_codes`` records the fault, and the switch-off run, which needs no
mend, is held too. Then the port's versions of tests/test_elastic_gang.py's
sim contracts.
"""

import contextlib
import hashlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from volcano_tpu_torch.actions import allocate as torch_allocate
from volcano_tpu_torch.cache import SchedulerCache
from volcano_tpu_torch.sim import SimRunner, TraceEvent
from volcano_tpu_torch.sim.__main__ import main as sim_main
from volcano_tpu_torch.sim.report import sequence_digest

from torch_parity import NO_FMA_XLA_FLAGS, port_gc_windows  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
from sim_traces import TensorPathRecorder  # noqa: E402

OFF = (("VOLCANO_TPU_INCREMENTAL_SNAPSHOT", "0"),)
EG = ("--elastic-gangs",)
W0 = ("--topology-weight", "0")
CONF10 = ("--conf", "conf:elastic-deployed-10")
CONF0 = ("--conf", "conf:elastic-deployed-0")
# (source, args, env): the runs computed live from the JAX package here,
# and the one held to its committed entry only
LIVE_RUNS = [("elastic-churn", EG, ()),
             ("elastic-churn", EG + W0, ()),
             ("elastic-churn", EG + CONF10, ()),
             ("elastic-churn", EG + W0 + CONF0, ()),
             ("elastic-churn", EG + CONF10, OFF)]
DIGEST_RUNS = LIVE_RUNS + [("trace:elastic-10k", EG + CONF10, ())]
SEED = 20260806


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
def work_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("elastic"))


@pytest.fixture(scope="module")
def jax_live():
    """The JAX sim's bytes and record for LIVE_RUNS, the children started
    at once."""
    procs = {TOOL.run_key(*r): TOOL.start(r[0], r[1], "exact", r[2])
             for r in LIVE_RUNS}
    return {key: TOOL.finish_record(proc, timeout=900)
            for key, proc in procs.items()}


def port_run(source, args, env, work_dir, monkeypatch):
    """What ``python -m volcano_tpu_torch.sim --device cpu
    --deterministic`` prints for one run, its sequence digest, the summary
    of its solves' node-tensor paths and the zone-anchor solves it ran."""
    for k, v in env:
        monkeypatch.setenv(k, v)
    topo = []
    real_solve = torch_allocate.place

    def place(*a, **kw):
        topo.append(len(a) > 14 and a[14] > 0.0)
        return real_solve(*a, **kw)

    monkeypatch.setattr(torch_allocate, "place", place)
    out = io.StringIO()
    runners = []
    paths = TensorPathRecorder(torch_allocate, SchedulerCache)
    try:
        with contextlib.redirect_stdout(out):
            rc = sim_main(["--device", "cpu",
                           *TOOL.sim_argv(source, work_dir),
                           "--deterministic",
                           *TOOL.conf_args(args, work_dir)],
                          runners=runners)
    finally:
        paths.close()
    assert rc == 0
    return (out.getvalue().encode(), sequence_digest(runners[0]),
            paths.summary(), sum(topo))


def _assert_entry(run, text, sequence, paths):
    assert hashlib.sha256(text).hexdigest() == run["sha256"]
    assert len(text) == run["bytes"]
    assert (sequence["sha256"], sequence["binds"], sequence["evicts"]) \
        == (run["sequence_sha256"], run["sequence_binds"],
            run["sequence_evicts"])
    assert paths == run["tensor_paths"]


@pytest.mark.parametrize("source, args, env", DIGEST_RUNS,
                         ids=[TOOL.run_key(*r) for r in DIGEST_RUNS])
def test_elastic_sim_matches_jax(digests, jax_live, work_dir, monkeypatch,
                                 source, args, env):
    """Bytes, side-effect sequence and node-tensor paths: the JAX
    package's, live for elastic-churn and by the committed digests for
    every run. Under the deployed elastic conf at weight 10 every fused
    solve is a zone-anchor solve; at weight 0 none is. No below-min
    eviction, no action failure, no double bind."""
    text, sequence, paths, topo = port_run(source, args, env, work_dir,
                                           monkeypatch)
    key = TOOL.run_key(source, args, env)
    _assert_entry(digests[key], text, sequence, paths)
    if key in jax_live:
        want, record = jax_live[key]
        assert text == want
        assert (sequence["sha256"], paths) == (record["sha256"],
                                                record["tensor_paths"])
    report = json.loads(text)
    assert report["action_failures"] == 0 and report["double_binds"] == 0
    eg = report["elastic_gangs"]
    assert eg["below_min_evictions"] == 0 and eg["grows"] > 0
    assert report["jobs"]["completed"] == report["jobs"]["arrived"]
    if CONF10[1] in args:
        assert topo == paths["solves"] > 0
    else:
        assert topo == 0
    if source == "trace:elastic-10k":
        assert report["binds"] == 10000 and eg["grows"] == 400


def test_jax_default_falls_back_without_zone_codes(digests, work_dir):
    """The fault the reference runs mend: the JAX package's own sim, under
    the deployed elastic conf at weight 10 with its incremental snapshot on,
    raises AttributeError in every fused solve and places through the
    sequential placer, so its plane is not the zone-anchor solve's."""
    conf = TOOL.conf_args(CONF10, work_dir)[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=NO_FMA_XLA_FLAGS,
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "volcano_tpu.sim", "--scenario",
         "elastic-churn", "--elastic-gangs", "--conf", conf,
         "--deterministic"], cwd=REPO, env=env, capture_output=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    err = proc.stderr.decode()
    assert "device_zone_code" in err and "sequential placer" in err
    mended = digests[TOOL.run_key("elastic-churn", EG + CONF10)]
    assert hashlib.sha256(proc.stdout).hexdigest() != mended["sha256"]


def test_digest_keys_name_every_elastic_run(digests):
    for run in DIGEST_RUNS:
        assert TOOL.run_key(*run) in digests
        assert run in TOOL.RUNS


# -- the port's versions of test_elastic_gang.py's sim contracts ---------------

def _node(t, name, cpu, pods=40, zone=None, mem=64 << 30):
    d = {"name": name, "cpu_milli": cpu, "mem": mem, "pods": pods, "gpus": 0}
    if zone is not None:
        d["zone"] = zone
    return TraceEvent(t, "node_add", d)


def _job(t, name, tasks, min_available, cpu, duration, desired=None,
         queue="q1", priority=0):
    d = {"name": name, "queue": queue, "priority": priority, "tasks": tasks,
         "min_available": min_available, "cpu_milli": cpu, "mem": 1 << 28,
         "gpus": 0, "duration": duration}
    if desired is not None:
        d["desired"] = desired
    return TraceEvent(t, "job_arrival", d)


def _trace(events):
    out = [TraceEvent(0.0, "queue_add", {"name": "q1", "weight": 1})]
    out.extend(events)
    out.sort(key=lambda ev: (ev.t, ev.kind, ev.data.get("name", "")))
    return out


def _run(trace, **kw):
    kw.setdefault("seed", SEED)
    kw.setdefault("elastic_gangs", True)
    kw.setdefault("device", "cpu")
    r = SimRunner(trace, **kw)
    return r, r.run()


def test_elastic_gang_admits_at_min():
    """Capacity for 3 members never runs a rigid 8-gang, but an elastic
    8-gang with min 2 admits, grows into the third slot and completes."""
    events = [_node(0.0, "n0", 3000, pods=8),
              _job(1.0, "eg", tasks=8, min_available=2, cpu=1000,
                   duration=10.0, desired=8)]
    _, rep = _run(_trace(events))
    assert rep["jobs"]["completed"] == 1
    assert rep["jobs"]["unfinished"] == 0
    assert rep["double_binds"] == 0
    eg = rep["elastic_gangs"]
    assert eg["enabled"] and eg["grows"] >= 1
    assert eg["below_min_evictions"] == 0


def test_rigid_gang_control_stalls_where_elastic_runs():
    events = [_node(0.0, "n0", 3000, pods=8),
              _job(1.0, "rigid", tasks=8, min_available=8, cpu=1000,
                   duration=10.0)]
    _, rep = _run(_trace(events), stall_limit=25)
    assert rep["jobs"]["completed"] == 0
    assert rep["jobs"]["unfinished"] == 1


def test_pressure_shrinks_never_go_below_min():
    events = [_node(0.0, f"n{i}", 4000, pods=16) for i in range(4)]
    events.append(_job(1.0, "eg", tasks=12, min_available=2, cpu=1000,
                       duration=30.0, desired=12))
    events.extend(_job(8.0 + 0.1 * i, f"rg-{i}", tasks=2, min_available=2,
                       cpu=2000, duration=5.0) for i in range(4))
    _, rep = _run(_trace(events))
    assert rep["jobs"]["completed"] == rep["jobs"]["arrived"] == 5
    assert rep["double_binds"] == 0
    eg = rep["elastic_gangs"]
    assert eg["grows"] > 0
    assert sum(eg["shrinks"].values()) > 0
    assert eg["below_min_evictions"] == 0


def test_member_loss_above_min_is_elastic_continue():
    events = [_node(0.0, "n0", 4000, pods=2),
              _node(0.0, "n1", 4000, pods=2),
              _job(1.0, "eg", tasks=4, min_available=2, cpu=1000,
                   duration=20.0, desired=4),
              TraceEvent(8.0, "node_fail", {"name": "n1"})]
    r, rep = _run(_trace(events))
    assert rep["jobs"]["completed"] == 1
    assert rep["elastic_gangs"]["elastic_continues"] >= 1
    assert r.jct[0] < 26.0, r.jct


def test_member_loss_below_min_is_duration_restart():
    events = [_node(0.0, "n0", 4000, pods=8),
              _job(1.0, "eg", tasks=4, min_available=2, cpu=1000,
                   duration=20.0, desired=4),
              TraceEvent(8.0, "node_fail", {"name": "n0"}),
              _node(9.0, "n1", 4000, pods=8)]
    r, rep = _run(_trace(events))
    assert rep["jobs"]["completed"] == 1
    assert r.jct[0] > 26.0, r.jct


def test_topology_colocates_gangs_when_capacity_permits():
    events = [_node(0.0, f"n{i}", 8000, pods=16, zone=f"z{i // 2}")
              for i in range(6)]
    events.extend(_job(1.0 + 0.5 * i, f"eg-{i}", tasks=4, min_available=2,
                       cpu=1000, duration=12.0, desired=4)
                  for i in range(6))
    _, aware = _run(_trace(events), topology_weight=10.0)
    _, blind = _run(_trace(events), topology_weight=0.0)
    assert aware["jobs"]["completed"] == blind["jobs"]["completed"] == 6
    rate_aware = aware["elastic_gangs"]["colocation_rate"]
    rate_blind = blind["elastic_gangs"]["colocation_rate"]
    assert rate_aware >= 0.9, (rate_aware, rate_blind)
    assert rate_aware >= rate_blind


def test_elastic_flags_run_and_exclude_the_pipelined_modes(capsys):
    """--elastic-gangs, --topology-weight and
    --verify-elastic-gang-equivalence run (the last on elastic-churn, exit
    0); --elastic-gangs refuses the pipelined modes, and the verifier
    needs the mode."""
    from volcano_tpu_torch.sim.__main__ import REFUSED_FLAGS
    for flag in ("--elastic-gangs", "--topology-weight",
                 "--verify-elastic-gang-equivalence"):
        assert flag not in REFUSED_FLAGS
    # the federation's elastic membership is in too (slice 15)
    for flag in ("--elastic", "--verify-elastic-equivalence"):
        assert flag not in REFUSED_FLAGS
    assert sim_main(["--device", "cpu", "--scenario", "elastic-churn",
                     "--elastic-gangs", "--deterministic",
                     "--verify-elastic-gang-equivalence"]) == 0
    assert "elastic-gang-equivalence OK" in capsys.readouterr().err
    for bad in (["--elastic-gangs", "--pipelined"],
                ["--elastic-gangs", "--fast-admit"],
                ["--verify-elastic-gang-equivalence"]):
        with pytest.raises(SystemExit) as exc:
            sim_main(["--device", "cpu", "--scenario", "smoke", *bad])
        assert exc.value.code == 2
