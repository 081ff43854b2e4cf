"""The federated control plane through the port's sim on the CPU:
``--federated N`` (N partition schedulers over one cluster: disjoint queue
subsets and node shards, a fenced leader a partition, cross-partition
reserves and queue moves through the shared journal), ``--rebalance`` and
``--verify-federated-equivalence``. Each run of tools/sim_reference.py's
FEDERATED_RUNS that the CPU holds is compared with the JAX package's
digests in tests/sim_reference_digests.json: the report with its
``federation`` section, the side-effect sequence, the node-tensor path
solve by solve and partition by partition, and for the merged trace the
recorder's output. The reserve-driving fed-starve and the full-width
baseline-10k under deploy/scheduler.conf are the card's (chip_smoke.py's
``federated`` phase). Where one of two faults of the JAX package fired in
a run (its refresh of a node changed and then removed, and a partition's
first handoff settling another partition's crash window), the port, which
fixes both, is held to the package with that fault mended
(tools/sim_reference.py::held_to); baseline-tiny killed in cycle 0 shows
the second on the CPU. The ports of the reference's TestFederatedSim cases
close the file."""

import hashlib
import json

import pytest

from volcano_tpu_torch import metrics
from volcano_tpu_torch.obs import validate as pt_validate
from volcano_tpu_torch.sim.__main__ import REFUSED_FLAGS
from volcano_tpu_torch.sim.__main__ import main as sim_main
from volcano_tpu_torch.sim.report import deterministic_json, oracle_part
from volcano_tpu_torch.sim.runner import SimRunner
from volcano_tpu_torch.sim.workload import make_scenario

from torch_parity import port_gc_windows, sim_port_run  # noqa: F401

FEDERATED_FLAGS = ("--federated", "--rebalance",
                   "--verify-federated-equivalence")


def _load_tool():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "sim_reference", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "tools", "sim_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _load_tool()
# the runs the CPU holds here: the sim's default conf, and the store-backed
# smoke under deploy/scheduler.conf (B1's plain version, four seconds); the
# other deploy/scheduler.conf runs are the card's
RUNS = [r for r in TOOL.FEDERATED_RUNS
        if TOOL.DEPLOYED not in r[1] or r[0] == "smoke"]
IDS = [TOOL.run_key(*r) for r in RUNS]
KILLS = (2, 5, 9, 13)


@pytest.fixture(scope="module")
def digests():
    with open(TOOL.DIGESTS) as f:
        return {run["key"]: run for run in json.load(f)["runs"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(run):
        key = TOOL.run_key(*run)
        if key not in cache:
            cache[key] = sim_port_run(*run,
                                      out_dir=tmp_path_factory.mktemp("fed"))
        return cache[key]
    return get


def _run(run):
    return next(r for r in RUNS if r[0] == run[0] and r[1] == run[1])


def test_every_federated_run_has_a_digest(digests):
    for run in TOOL.FEDERATED_RUNS + TOOL.MENDED_RUNS + TOOL.RECONCILE_RUNS:
        assert TOOL.run_key(*run) in digests
    for run in TOOL.OVERLOAD_RUNS + TOOL.FEDERATED_RUNS:
        TOOL.held_to(run, digests)           # the record it is held to


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_federated_run_matches_jax(digests, runs, run):
    """Report (the federation section included), sequence, node-tensor
    paths (each partition's too) and, for the merged trace, the trace,
    audit records and timelines: the JAX package's, with each of its
    faults that the port fixes mended where it fired."""
    got, (want, _) = runs(run), TOOL.held_to(run, digests)
    assert got["rc"] == 0
    assert hashlib.sha256(got["text"]).hexdigest() == want["sha256"]
    assert len(got["text"]) == want["bytes"]
    assert (got["sequence"]["sha256"], got["sequence"]["binds"],
            got["sequence"]["evicts"]) == (want["sequence_sha256"],
                                           want["sequence_binds"],
                                           want["sequence_evicts"])
    assert got["paths"] == want["tensor_paths"]
    if "obs" in want:
        assert TOOL.obs_digests(got["trace"], *got["state"]) == want["obs"]


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_federated_run_contract(runs, run):
    """No double bind and no action failure, every arrived job completed,
    partition failover bounded to three cycles; the verifier passed where
    it ran."""
    _, args, _ = run
    got = runs(run)
    report = got["report"]
    fed = report["federation"]
    assert report["double_binds"] == 0 and report["action_failures"] == 0
    assert report["jobs"]["completed"] == report["jobs"]["arrived"]
    assert report["jobs"]["unfinished"] == 0
    assert fed["partitions"] == int(args[args.index("--federated") + 1])
    assert fed["failover_cycles_max"] <= 3
    assert len(fed["failover_cycles"]) == report["failovers"]
    if "--kill-cycles" in args:
        kills = args[args.index("--kill-cycles") + 1].split(",")
        assert report["restarts"] == len(kills)
    for flag, ok in (("--verify-federated-equivalence",
                      "federated-equivalence OK"),
                     ("--verify-overload-equivalence",
                      "overload-equivalence OK")):
        if flag in args:
            assert ok in got["stderr"]
            assert len(got["runners"]) == 2


def test_store_backed_smoke_takes_the_kernel_path(runs):
    """Under deploy/scheduler.conf each partition's allocate solves through
    B1's wrapper (its plain version on the CPU) over its own persistent
    node tensors, and the record splits by partition."""
    run = _run(("smoke", ("--seed", "3", "--conf", TOOL.DEPLOYED,
                          "--store-chaos", "--federated", "4")
                + TOOL.FED_KILLS))
    got = runs(run)
    paths = got["paths"]
    assert paths["solves"] > 0 and paths["fresh"] == 0
    parts = paths["partitions"]
    assert sum(p["solves"] for p in parts.values()) == paths["solves"]
    assert len(parts) >= 2
    assert got["report"]["federation"]["store_backed"] is True


def test_fed_starve_reclaims_through_reserve_transfer(runs):
    """tests/test_federation.py's starved world: capacity follows demand
    through granted reserves and node transfers, with no double bind."""
    report = runs(_run(("fed-starve", ("--seed", "3", "--federated", "4",
                                       "--verify-federated-equivalence"))))[
        "report"]
    reserves = report["cross_partition_reserves"]
    assert reserves.get("granted", 0) > 0, reserves
    assert report["federation"]["node_transfers"] > 0
    hot = report["federation"]["map"]
    total = sum(p["nodes"] for p in hot.values())
    assert total == 8 and max(p["nodes"] for p in hot.values()) > 2


def test_fed_hotspot_rebalancer_moves_and_converges(runs):
    """CI's overload soak on fed-hotspot: the rebalancer moved a queue and
    went quiet ten periods before the run ended."""
    report = runs(_run(("fed-hotspot", ("--seed", "3", "--federated", "4",
                                        "--overload-chaos",
                                        "--verify-overload-equivalence"))))[
        "report"]
    reb = report["federation"]["rebalance"]
    assert reb["enabled"] and reb["move_count"] > 0
    assert reb["last_move_t"] <= report["virtual_time_s"] - 10
    assert report["federation"]["queue_moves"] >= reb["move_count"]


def test_merged_trace_validates_with_flows(runs, capsys):
    """CI's merged federated trace: a lane a partition, flow arcs that
    validate."""
    got = runs(_run(("fed-hotspot", ("--seed", "3", "--federated", "2",
                                     "--trace-out"))))
    assert pt_validate.main(["--flows", got["trace_path"]]) == 0
    pids = {ev["pid"] for ev in got["trace"]["traceEvents"]}
    assert {1, 2} <= pids
    capsys.readouterr()


def test_runs_are_held_to_the_mended_reference(digests):
    """Two faults of the JAX package that the port fixes can fire in these
    runs: its refresh of a node changed and then removed raises
    (volcano_tpu/cache/snapshot.py::PersistentNodeTensors.refresh), and a
    partition's first handoff settles another partition's crash window as
    stale (volcano_tpu/cache/journal.py::reconcile). The digests count
    where each fired; a run where neither did is the same mended as not."""
    for run in TOOL.MENDED_RUNS + TOOL.RECONCILE_RUNS:
        source, args, env = run
        mended = digests[TOOL.run_key(*run)]
        plain = digests[TOOL.run_key(source, args, ())]
        assert "refresh_faults" not in mended or TOOL.MEND[0] not in env
        if not plain.get("refresh_faults") \
                and not plain.get("reconcile_faults"):
            assert (plain["sha256"], plain["sequence_sha256"],
                    plain["tensor_paths"]) == (
                mended["sha256"], mended["sequence_sha256"],
                mended["tensor_paths"])


def test_foreign_crash_window_is_left_to_its_partition(digests, runs):
    """baseline-tiny over four partitions, killed after partition 0's third
    bind in cycle 0: the JAX package's partitions 1-3, taking their first
    leadership in the same cycle, settle partition 0's open intent as
    stale, so partition 0's own handoff finds nothing to repair. The port
    leaves it to partition 0, which repairs it: equal to the JAX package
    with its reconcile mended, not to the package as is."""
    run = _run(("baseline-tiny", ("--federated", "4", "--kill-cycles", "0",
                                  "--kill-seed", "4")))
    got = runs(run)
    plain = digests[TOOL.run_key(*run)]
    mended = digests[TOOL.run_key(run[0], run[1], TOOL.MEND_RECONCILE)]
    assert plain["reconcile_faults"] == 1
    assert "reconcile_faults" not in mended
    text = hashlib.sha256(got["text"]).hexdigest()
    assert text == mended["sha256"] != plain["sha256"]
    assert got["report"]["journal_replayed"] == {"repaired_binds": 1,
                                                 "replayed": 1}


def test_foreign_crash_window_left_with_the_timeline_off(digests, runs):
    """The same run with the lifecycle timeline off
    (``VOLCANO_TPU_TIMELINE=0``, so no intent carries a timeline stamp):
    partition 0's intent still carries its partition, partition 0's
    handoff repairs it, and every gang completes, with the same decisions
    as with the timeline on."""
    from volcano_tpu_torch.obs import TIMELINE
    run = _run(("baseline-tiny", ("--federated", "4", "--kill-cycles", "0",
                                  "--kill-seed", "4")))
    enabled, TIMELINE.enabled = TIMELINE.enabled, False
    try:
        got = sim_port_run(*run)
    finally:
        TIMELINE.enabled = enabled
    assert got["rc"] == 0
    report = got["report"]
    assert report["jobs"]["completed"] == report["jobs"]["arrived"] > 0
    assert not report["jobs"]["unfinished"]
    assert report["double_binds"] == 0
    assert report["journal_replayed"] == {"repaired_binds": 1,
                                          "replayed": 1}
    on = runs(run)
    assert got["text"] == on["text"]
    assert got["sequence"] == on["sequence"]


def test_federated_flags_run():
    for flag in FEDERATED_FLAGS:
        assert flag not in REFUSED_FLAGS


@pytest.mark.parametrize("flag", ["--elastic",
                                  "--verify-elastic-equivalence"])
def test_elastic_membership_is_refused_by_name(flag, capsys):
    """Elastic membership (ROADMAP item 9e′) is ported, so neither flag is
    refused by name any more: ``--elastic`` runs over the partitions, and
    ``--verify-elastic-equivalence`` without it is a usage error (exit 2)
    that names the flag it needs."""
    argv = ["--device", "cpu", "--scenario", "smoke", "--federated", "2",
            "--deterministic", flag]
    if flag == "--elastic":
        assert sim_main(argv) == 0
        report = json.loads(capsys.readouterr().out)
        assert report["federation"]["elastic"]["enabled"] is True
        return
    with pytest.raises(SystemExit) as exc:
        sim_main(argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "requires --elastic" in err and "not in volcano_tpu_torch" \
        not in err


def test_one_partition_is_the_single_scheduler(digests):
    """``--federated 1`` runs the single scheduler: the plain run's plane."""
    got = sim_port_run("smoke", ("--federated", "1"))
    assert "federation" not in got["report"]
    assert hashlib.sha256(got["text"]).hexdigest() == \
        digests["--scenario smoke"]["sha256"]


@pytest.mark.parametrize("extra, message", [
    (["--ha", "3"], "ha_replicas and federated_partitions are mutually "
                    "exclusive"),
    (["--pipelined"], "pipelined/fast_admit are single-scheduler modes"),
])
def test_federated_refuses_the_other_topologies(extra, message):
    """The JAX runner's ValueError, with its message."""
    with pytest.raises(ValueError, match=message):
        sim_port_run("smoke", ["--federated", "2", *extra])


@pytest.mark.parametrize("argv, message", [
    (["--rebalance"], "--rebalance requires --federated N"),
    (["--federated", "2", "--elastic-gangs"],
     "--elastic-gangs is a direct single-scheduler mode"),
])
def test_federated_cli_errors(argv, message, capsys):
    with pytest.raises(SystemExit) as exc:
        sim_main(["--device", "cpu", "--scenario", "smoke", *argv])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


# ---------------------------------------------------------------------------
# tests/test_federation.py's TestFederatedSim through the port's runner
# ---------------------------------------------------------------------------

def _sim(scenario="smoke", **kw):
    return SimRunner(make_scenario(scenario, seed=3), seed=3, device="cpu",
                     **kw).run()


def test_partition_kills_zero_double_binds_every_gang_completes():
    report = _sim(federated_partitions=4, kill_cycles=KILLS, kill_seed=2)
    assert report["double_binds"] == 0
    assert report["restarts"] == len(KILLS)
    assert report["jobs"]["completed"] == report["jobs"]["arrived"]
    assert report["jobs"]["unfinished"] == 0
    assert report["failovers"] == len(KILLS)
    assert report["federation"]["failover_cycles_max"] <= 3
    # byte-deterministic across two runs
    again = _sim(federated_partitions=4, kill_cycles=KILLS, kill_seed=2)
    assert deterministic_json(report) == deterministic_json(again)


def test_non_contended_aggregate_equals_single_scheduler_oracle():
    fed = _sim("fed-smoke", federated_partitions=4)
    single = _sim("fed-smoke")
    assert json.dumps(oracle_part(fed), sort_keys=True) \
        == json.dumps(oracle_part(single), sort_keys=True)
    assert fed["failovers"] == 0 and fed["fenced_rejections"] == 0
    assert fed["cross_partition_reserves"] == {}


def test_federated_run_publishes_partition_metrics():
    """After a federated run the health detail carries every partition's
    leadership entry and the partition count."""
    metrics.reset_local()
    try:
        _sim("fed-smoke", federated_partitions=4)
        detail = metrics.health_detail()
        fed = detail["federation"]
        assert fed["enabled"] is True and detail["partition_count"] == 4
        assert {str(p) for p in range(4)} <= set(fed)
        assert all(fed[str(p)]["leading"] for p in range(4))
    finally:
        metrics.reset_local()


def test_store_backed_smoke_walk_count_is_the_cards_check(runs,
                                                         monkeypatch):
    """chip_smoke.py's ``federated`` phase holds B3's launches on the card
    to the CPU path's count of preempt walks (PARTITIONED_CPU_WALKS, none
    where a run is not listed) and B1's to the solves: count both here for
    the store-backed smoke under deploy/scheduler.conf."""
    import importlib.util
    import os
    from volcano_tpu_torch.actions import allocate, evict_tpu
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(TOOL.DIGESTS), "..",
                                   "chip_smoke.py"))
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)
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
    run = _run(("smoke", ("--seed", "3", "--conf", TOOL.DEPLOYED,
                          "--store-chaos", "--federated", "4")
                + TOOL.FED_KILLS))
    got = sim_port_run(*run)
    assert got["rc"] == 0
    assert counts["walk"] == chip.PARTITIONED_CPU_WALKS.get(
        TOOL.run_key(*run), 0)
    assert counts["place"] == got["paths"]["solves"] > 0


def test_federated_overload_sim_runs_without_jax():
    """A subprocess (this test process imported JAX already): the
    federated control plane under the overload preset, store-backed, loads
    neither JAX nor the JAX package."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(TOOL.DIGESTS))
    code = (
        "import sys\n"
        "from volcano_tpu_torch.sim.__main__ import main\n"
        "rc = main(['--device', 'cpu', '--scenario', 'fed-hotspot',\n"
        "           '--seed', '3', '--federated', '2', '--overload-chaos',\n"
        "           '--store-wired', '--deterministic'])\n"
        "assert rc == 0, rc\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "                                    'volcano_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'volcano_tpu_torch.federation.store_backed' in sys.modules\n"
        "assert 'volcano_tpu_torch.webhooks.backpressure' in sys.modules\n"
        "print('ok', file=sys.stderr)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stderr.strip().endswith("ok")
    report = json.loads(proc.stdout)
    assert report["federation"]["store_backed"] is True
    assert report["jobs"]["completed"] == report["jobs"]["arrived"]
