"""The overload plane through the port's sim on the CPU: ``--overload-chaos``
(a cycle budget priced by the deterministic cost model, bounded admission
with priority-aware shedding and retry-after re-offers, seeded arrival
bursts), ``--admission-depth``, ``--burst-rate`` and
``--verify-overload-equivalence``. Each run of tools/sim_reference.py's
OVERLOAD_RUNS that the CPU holds is compared with the JAX package's
digests in tests/sim_reference_digests.json: the report with its
``overload`` section, the side-effect sequence and the solve-by-solve
node-tensor path; and each is held to CI's overload contract
(ci/check.sh's overload soak and SLO run). The run under
deploy/scheduler.conf is the card's (chip_smoke.py's ``overload``
phase)."""

import hashlib
import json

import pytest

from volcano_tpu_torch.sim.__main__ import REFUSED_FLAGS
from volcano_tpu_torch.sim.report import deterministic_json

from torch_parity import port_gc_windows, sim_port_run  # noqa: F401

OVERLOAD_FLAGS = ("--overload-chaos", "--admission-depth", "--burst-rate",
                  "--verify-overload-equivalence")


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
# the runs the CPU holds here (deploy/scheduler.conf: the card)
RUNS = [r for r in TOOL.OVERLOAD_RUNS if TOOL.DEPLOYED not in r[1]]
IDS = [TOOL.run_key(*r) for r in RUNS]


@pytest.fixture(scope="module")
def digests():
    with open(TOOL.DIGESTS) as f:
        return {run["key"]: run for run in json.load(f)["runs"]}


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(run):
        key = TOOL.run_key(*run)
        if key not in cache:
            cache[key] = sim_port_run(*run)
        return cache[key]
    return get


def test_every_overload_run_has_a_digest(digests):
    for run in TOOL.OVERLOAD_RUNS:
        assert TOOL.run_key(*run) in digests
    deployed = [r for r in TOOL.MENDED_RUNS if r[0] == "overload-burst"]
    assert deployed and all(TOOL.run_key(*r) in digests for r in deployed)


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_overload_run_matches_jax(digests, runs, run):
    """Report (the overload section included), sequence and node-tensor
    paths: the JAX package's."""
    got, want = runs(run), digests[TOOL.run_key(*run)]
    assert got["rc"] == 0
    assert hashlib.sha256(got["text"]).hexdigest() == want["sha256"]
    assert len(got["text"]) == want["bytes"]
    assert (got["sequence"]["sha256"], got["sequence"]["binds"],
            got["sequence"]["evicts"]) == (want["sequence_sha256"],
                                           want["sequence_binds"],
                                           want["sequence_evicts"])
    assert got["paths"] == want["tensor_paths"]


def test_overload_soak_contract(runs):
    """CI's overload soak: the budget exhausted and deferred, the spend
    within twice the budget, the priority-aware shed fired, every shed
    arrival re-admitted, the depth bound held, kills restarted the shell,
    no double bind and every gang completed; the verifier ran its second
    run and passed."""
    got = runs(RUNS[0])
    report = got["report"]
    o = report["overload"]
    assert o["cycle_budget"]["exhausted"] > 0
    assert o["cycle_budget"]["deferred_actions"] > 0
    assert o["cycle_budget"]["max_cycle_spend_s"] <= \
        2 * o["cycle_budget"]["budget_s"]
    assert o["shed_total"] > 0 and o["shed"].get("priority_shed", 0) > 0
    assert o["retries_pending"] == 0 and o["burst_jobs"] > 0
    adm = o["admission"]
    assert all(d <= adm["max_queue_depth"]
               for d in adm["high_water"].values())
    assert report["double_binds"] == 0 and report["restarts"] == 4
    assert report["action_failures"] == 0
    assert report["jobs"]["completed"] == report["jobs"]["arrived"]
    assert "overload-equivalence OK" in got["stderr"]
    assert len(got["runners"]) == 2           # the run and its rerun


def test_slo_run_contract(runs):
    """CI's SLO run: the timelines keep every job (no LRU pressure at a
    4096-event ring), the SLO engine evaluated the per-class JCT
    objectives over every completion, the per-class means recombine to the
    report's JCT, and every objective has burn windows."""
    report = runs(RUNS[1])["report"]
    lat, slo = report["latency"], report["slo"]
    assert lat["timeline"]["jobs"] == report["jobs"]["arrived"]
    assert lat["timeline"]["lru_evicted"] == 0
    names = {s["slo"] for s in slo}
    assert any(n.startswith("jct_by_class/") for n in names)
    counts = {s["slo"].split("/", 1)[1]: s["samples"] for s in slo
              if s["slo"].startswith("jct_by_class/")}
    assert sum(counts.values()) == report["jobs"]["completed"]
    num = sum(lat["classes"][c]["jct_s"]["mean"] * n
              for c, n in counts.items() if n)
    den = sum(counts.values())
    assert den and abs(num / den - report["jct_s"]["mean"]) < 1e-4
    assert any(s["samples"] > 0 for s in slo)
    for s in slo:
        assert s["burn_rate"] and 0.0 <= s["compliance"] <= 1.0


def test_overload_flags_run():
    for flag in OVERLOAD_FLAGS:
        assert flag not in REFUSED_FLAGS


def test_sim_overload_smoke_bounded_and_convergent():
    """tests/test_overload.py's small overload world through the port's
    SimRunner: bounded, convergent, byte-deterministic, and equal to the
    JAX package's runner on the same world."""
    from volcano_tpu.sim.runner import SimRunner as JaxRunner
    from volcano_tpu.sim.report import deterministic_json as jax_json
    from volcano_tpu_torch.sim.runner import SimRunner
    from volcano_tpu_torch.sim.workload import make_scenario

    kw = dict(seed=3, cycle_budget_s=0.5, budget_cost_per_task=0.002,
              admission_depth=12, overload_burst_rate=0.3)

    def run():
        return SimRunner(make_scenario("smoke", seed=3), device="cpu",
                         **kw).run()

    report = run()
    ov = report["overload"]
    assert report["jobs"]["completed"] == report["jobs"]["arrived"]
    assert report["jobs"]["unfinished"] == 0
    assert report["double_binds"] == 0
    assert ov["retries_pending"] == 0
    assert ov["shed_total"] > 0, "the 12-task depth cap never shed"
    adm = ov["admission"]
    assert all(d <= adm["max_queue_depth"]
               for d in adm["high_water"].values())
    budget = ov["cycle_budget"]
    assert budget["max_cycle_spend_s"] <= 2.0 * budget["budget_s"]
    assert deterministic_json(report) == deterministic_json(run()), \
        "the overload machinery broke byte determinism"
    from volcano_tpu.sim.workload import make_scenario as jax_scenario
    want = JaxRunner(jax_scenario("smoke", seed=3), **kw).run()
    assert deterministic_json(report) == jax_json(want)


@pytest.mark.parametrize("flags", [
    ("--admission-depth", "12"),
    ("--burst-rate", "0.3", "--cycle-budget", "0.5"),
], ids=["admission-depth", "burst-rate"])
def test_single_overload_flags_match_jax_live(flags):
    """One overload flag at a time, against the JAX package computed here
    (a child at XLA level 0): the admission gate without bursts, and the
    bursts without a gate."""
    args = ("--seed", "3") + flags
    proc = TOOL.start("smoke", args)
    text, record = TOOL.finish(proc, timeout=900)
    got = sim_port_run("smoke", args)
    assert got["rc"] == 0 and got["text"] == text
    assert got["sequence"]["sha256"] == record["sha256"]
    assert "overload" in got["report"]


def test_overload_report_section_only_on_overload_runs(digests):
    """A run without the overload flags has no overload section and keeps
    its digest: the plane is byte-identical to before the flags existed."""
    got = sim_port_run("smoke", ())
    assert "overload" not in got["report"]
    assert hashlib.sha256(got["text"]).hexdigest() == \
        digests["--scenario smoke"]["sha256"]
