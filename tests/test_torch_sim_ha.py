"""The HA control plane through the port's sim on the CPU: ``--ha 3``
(three replicas over one cluster, fenced leader election, warm standbys
tailing the journal), with seeded leader kills, a mid-cycle lease loss and
faulted lease writes. Each run of tools/sim_reference.py's HA_RUNS that the
CPU holds is compared with the JAX package's digests in
tests/sim_reference_digests.json: the report with its ``ha`` section, the
side-effect sequence and the solve-by-solve node-tensor path. preempt-burst
and the full-width baseline-10k run on the card (chip_smoke.py's ``ha``
phase)."""

import contextlib
import hashlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import pytest

from volcano_tpu_torch import metrics
from volcano_tpu_torch.actions import allocate as torch_allocate
from volcano_tpu_torch.cache import SchedulerCache
from volcano_tpu_torch.sim.__main__ import REFUSED_FLAGS
from volcano_tpu_torch.sim.__main__ import main as sim_main
from volcano_tpu_torch.sim.report import sequence_digest

from torch_parity import port_gc_windows  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
from sim_traces import TensorPathRecorder  # noqa: E402

HA_FLAGS = ("--ha", "--lease-loss-cycles", "--verify-ha-equivalence",
            "--lease-fault-rate", "--lease-fault-seed")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "sim_reference", REPO / "tools" / "sim_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()
# the HA runs the CPU holds here (preempt-burst and baseline-10k: the card)
RUNS = [r for r in TOOL.HA_RUNS
        if r[0] not in ("preempt-burst", "baseline-10k")]
IDS = [TOOL.run_key(*r) for r in RUNS]


@pytest.fixture(scope="module")
def digests():
    doc = json.loads((REPO / "tests" / "sim_reference_digests.json")
                     .read_text())
    return {run["key"]: run for run in doc["runs"]}


def port_run(source, args, extra=()):
    """One port sim run on the CPU: the printed report, the sequence
    digest, the node-tensor paths, the report, stderr and the exit
    code."""
    out, err = io.StringIO(), io.StringIO()
    runners = []
    paths = TensorPathRecorder(torch_allocate, SchedulerCache)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = sim_main(["--device", "cpu", "--scenario", source,
                           "--deterministic", *args, *extra],
                          runners=runners)
    finally:
        paths.close()
    text = out.getvalue().encode()
    return {"rc": rc, "text": text, "sequence": sequence_digest(runners[0]),
            "paths": paths.summary(), "report": json.loads(text),
            "stderr": err.getvalue(), "runners": len(runners)}


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(run):
        key = TOOL.run_key(*run)
        if key not in cache:
            cache[key] = port_run(run[0], run[1])
        return cache[key]
    return get


def test_every_ha_run_has_a_digest(digests):
    for run in TOOL.HA_RUNS:
        assert TOOL.run_key(*run) in digests


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_ha_run_matches_jax(digests, runs, run):
    """Report (the ha section included), sequence and node-tensor paths:
    the JAX package's."""
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
def test_ha_run_contract(runs, run):
    """No double bind, no action failure, every job completed, failover
    bounded to three cycles; the verifier passed where it ran."""
    _, args, _ = run
    got = runs(run)
    report = got["report"]
    assert report["double_binds"] == 0 and report["action_failures"] == 0
    assert report["jobs"]["completed"] == report["jobs"]["arrived"]
    assert report["ha"]["replicas"] == 3
    assert report["ha"]["failover_cycles_max"] <= 3
    assert len(report["ha"]["failover_cycles"]) == report["failovers"]
    if "--verify-ha-equivalence" in args:
        assert "ha-equivalence OK" in got["stderr"]
        assert got["runners"] == 2            # the run and its oracle
    if "--kill-cycles" in args:
        assert report["restarts"] == 4 and report["failovers"] == 4
        assert report["ha"]["lease_losses"] == 1
    elif "--lease-fault-rate" in args:
        assert report["failovers"] > 0 and report["restarts"] == 0
    else:
        assert report["failovers"] == 0 and report["fenced_rejections"] == 0


def test_deployed_smoke_takes_the_kernel_path(runs):
    """Under deploy/scheduler.conf each leader cycle solves through B1's
    wrapper (its plain version on the CPU) over the leader's persistent
    node tensors, and each new leader builds them whole."""
    run = [r for r in RUNS if "deploy/scheduler.conf" in r[1]][0]
    paths = runs(run)["paths"]
    assert paths["solves"] > 0 and paths["fresh"] == 0
    assert paths["full"] >= runs(run)["report"]["failovers"]


def test_ha_flags_run():
    for flag in HA_FLAGS:
        assert flag not in REFUSED_FLAGS


@pytest.mark.parametrize("extra, message", [
    (["--pipelined"], "pipelined/fast_admit are single-scheduler modes"),
    (["--fast-admit"], "pipelined/fast_admit are single-scheduler modes"),
    (["--store-wired"], "store_wired supports single-scheduler and "
                        "federated topologies"),
    (["--ack-chaos"], "ack chaos supports single-scheduler and federated"),
])
def test_ha_refuses_the_single_scheduler_modes(extra, message):
    """The JAX runner's ValueError, with its message."""
    with pytest.raises(ValueError, match=message):
        port_run("smoke", ["--ha", "3", *extra])


def test_ha_cli_errors(capsys):
    """--elastic-gangs with --ha is the parser's error (exit 2), as in the
    JAX package; --federated with --ha raises the JAX runner's ValueError:
    the two topologies are mutually exclusive."""
    with pytest.raises(SystemExit) as exc:
        sim_main(["--device", "cpu", "--scenario", "smoke", "--ha", "3",
                  "--elastic-gangs"])
    assert exc.value.code == 2
    assert "--elastic-gangs is a direct single-scheduler mode" \
        in capsys.readouterr().err
    with pytest.raises(ValueError, match="ha_replicas and "
                                         "federated_partitions are "
                                         "mutually exclusive"):
        sim_main(["--device", "cpu", "--scenario", "smoke", "--ha", "3",
                  "--federated", "2"])


def test_ha_sets_the_leader_metrics():
    """After an HA run the process's health detail names a role (the
    replicas share this process, so the last replica to step publishes its
    own), and the run's failovers are counted."""
    before = metrics.health_detail()["failovers_total"]
    got = port_run("smoke", ["--seed", "3", "--ha", "3", "--kill-cycles",
                             "2,5", "--kill-seed", "2"])
    detail = metrics.health_detail()
    assert detail["failovers_total"] - before \
        == got["report"]["failovers"] > 0
    assert detail["leader"]["role"] in ("leader", "follower")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_preempt_burst_walk_count_is_the_cards_check(digests, monkeypatch):
    """chip_smoke.py's ``ha`` phase holds B3's launches on the card to the
    CPU path's count of preempt walks (``HA_CPU_WALKS``) and B1's to the
    solves of the JAX digest: count both here, on the CPU path."""
    from volcano_tpu_torch.actions import allocate, evict_tpu
    counts = {"walk": 0, "place": 0}
    real_walk, real_place = evict_tpu.walk, allocate.place

    def walk(*a, **kw):
        counts["walk"] += 1
        return real_walk(*a, **kw)

    def place(*a, **kw):
        counts["place"] += 1
        return real_place(*a, **kw)

    monkeypatch.setattr(evict_tpu, "walk", walk)
    monkeypatch.setattr(allocate, "place", place)
    run = [r for r in TOOL.HA_RUNS if r[0] == "preempt-burst"][0]
    key = TOOL.run_key(*run)
    got = port_run(run[0], run[1])
    want = digests[key]
    assert got["rc"] == 0
    assert hashlib.sha256(got["text"]).hexdigest() == want["sha256"]
    assert got["sequence"]["sha256"] == want["sequence_sha256"]
    assert counts["walk"] == _chip_smoke().HA_CPU_WALKS[key] > 0
    assert counts["place"] == want["tensor_paths"]["solves"]
