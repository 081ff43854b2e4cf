"""The port's sim under ``--pipelined`` and ``--fast-admit`` on the CPU,
held to the JAX package: ``pipelined-steady`` (the no-conflict world) live
against the JAX sim's bytes, and the runs of tools/sim_reference.py's
pipelined RUNS (pipelined-steady; pipelined-conflict with fast admit, and
with kills, two of them between a speculative dispatch and its commit)
against the committed digests in tests/sim_reference_digests.json, each by
its decision plane (which carries the speculation verdicts), its
side-effect sequence and its solves' node-tensor paths (the speculative
solves' included). ``trace:backlog-16k`` has a file of its own
(tests/test_torch_sim_backlog.py).

Under deploy/scheduler.conf the JAX package's CPU run cannot give a
reference (ROADMAP §3), so that run is held to the port's own serial run:
equal terminal accounting and no double bind.
"""

import contextlib
import hashlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import pytest

from volcano_tpu_torch import chaos
from volcano_tpu_torch.actions import allocate as torch_allocate
from volcano_tpu_torch.cache import SchedulerCache
from volcano_tpu_torch.sim import runner as sim_runner
from volcano_tpu_torch.sim.__main__ import main as sim_main
from volcano_tpu_torch.sim.report import (pipelined_oracle_part,
                                          sequence_digest,
                                          terminal_accounting)

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
STEADY = ("pipelined-steady", ("--seed", "3", "--pipelined"), ())
KILLS = ("--kill-cycles", "3,8,14", "--kill-seed", "5")
# the pipelined RUNS of tools/sim_reference.py held here (backlog-16k has
# its own file)
RUNS = [r for r in TOOL.RUNS
        if "--pipelined" in r[1] and r[0] != "trace:backlog-16k"]


@pytest.fixture(scope="module")
def digests():
    doc = json.loads((REPO / "tests" / "sim_reference_digests.json")
                     .read_text())
    return {run["key"]: run for run in doc["runs"]}


@pytest.fixture(scope="module")
def jax_steady():
    source, args, env = STEADY
    return TOOL.finish_record(TOOL.start(source, args, "exact", env),
                              timeout=900)


def port_run(source, args, extra=()):
    """The port's run: what ``--deterministic`` prints, the report, the
    sequence digest and the node-tensor path summary; with ``extra``
    arguments (``--verify-pipelined-equivalence``) too."""
    out = io.StringIO()
    err = io.StringIO()
    runners = []
    paths = TensorPathRecorder(torch_allocate, SchedulerCache)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = sim_main(["--device", "cpu", *TOOL.sim_argv(source, ""),
                           "--deterministic", *args, *extra],
                          runners=runners)
    finally:
        paths.close()
    assert rc == 0, err.getvalue()[-2000:]
    text = out.getvalue().encode()
    return (text, json.loads(text), sequence_digest(runners[0]),
            paths.summary(), err.getvalue())


def test_pipelined_steady_matches_the_jax_sim_live(jax_steady):
    """The acceptance run: byte-identical to the JAX package and to the
    serial oracle, with speculation {hits 89, partial 26, conflicts 24}."""
    text, record = jax_steady
    got, report, sequence, paths, _ = port_run(STEADY[0], STEADY[1])
    assert got == text
    assert sequence["sha256"] == record["sha256"]
    assert paths == record["tensor_paths"]
    assert report["speculation"] == {"hits": 89, "partial": 26,
                                     "conflicts": 24, "hit_rate": 0.8273}
    verified, _, _, _, err = port_run(
        STEADY[0], STEADY[1], ("--verify-pipelined-equivalence",))
    assert verified == text
    assert "pipelined-equivalence OK" in err and "byte-identical" in err


@pytest.mark.parametrize("source, args, env", RUNS,
                         ids=[TOOL.run_key(*r) for r in RUNS])
def test_pipelined_sim_matches_jax_digest(digests, source, args, env):
    text, report, sequence, paths, _ = port_run(source, args)
    run = digests[TOOL.run_key(source, args, env)]
    assert hashlib.sha256(text).hexdigest() == run["sha256"]
    assert len(text) == run["bytes"]
    assert (sequence["sha256"], sequence["binds"], sequence["evicts"]) \
        == (run["sequence_sha256"], run["sequence_binds"],
            run["sequence_evicts"])
    assert paths == run["tensor_paths"]
    assert report["action_failures"] == 0 and report["double_binds"] == 0
    assert report["jobs"]["completed"] == report["jobs"]["arrived"]
    spec = report["speculation"]
    assert spec["hits"] + spec["partial"] + spec["conflicts"] > 0
    if "--fast-admit" in args:
        assert report["fast_admit"] == {"gangs": 80, "binds": 105}


def test_kills_land_between_dispatch_and_commit(monkeypatch):
    """The kill run's seed arms the speculate kill point twice, and both
    fire after a dispatch: the crash window the pipeline journals nothing
    in. The killed run ends with every job complete and no double bind."""
    fired = []
    arm = chaos.arm_speculation_kill

    def counting_arm(sched):
        arm(sched)
        hook = sched.spec_fault_hook

        def fire(spec):
            fired.append(spec.pending is not None)
            hook(spec)

        sched.spec_fault_hook = fire

    monkeypatch.setattr(sim_runner, "arm_speculation_kill", counting_arm)
    _, report, _, _, err = port_run(
        "pipelined-conflict", ("--pipelined", *KILLS),
        ("--verify-pipelined-equivalence",))
    assert fired == [True, True]
    assert report["restarts"] == 3 and report["double_binds"] == 0
    assert "pipelined-equivalence OK" in err
    # no speculation, killed or left in flight at the end, keeps a GC
    # window open
    from volcano_tpu_torch.framework import framework as fw
    assert not fw._GC_OPEN_WINDOWS


def test_pipelined_deployed_conf_is_terminal_equivalent_to_serial():
    """pipelined-conflict under deploy/scheduler.conf (every action,
    preempt and reclaim through the card's kernels' plain versions here):
    the port's pipelined shell against its serial shell, with no JAX
    reference (ROADMAP §3)."""
    args = ("--conf", "deploy/scheduler.conf")
    _, piped, _, _, err = port_run(
        "pipelined-conflict", (*args, "--pipelined"),
        ("--verify-pipelined-equivalence",))
    _, serial, _, _, _ = port_run("pipelined-conflict", args)
    assert terminal_accounting(piped) == terminal_accounting(serial)
    assert piped["double_binds"] == 0 and serial["double_binds"] == 0
    assert piped["jobs"]["completed"] == piped["jobs"]["arrived"]
    spec = piped["speculation"]
    assert spec["hits"] + spec["partial"] + spec["conflicts"] > 0
    assert "pipelined-equivalence OK" in err


def test_oracle_part_strips_only_the_mechanism():
    report = {"binds": 3, "speculation": {"hits": 1}, "fast_admit": {},
              "wallclock": {"pipeline_e2e_ms": {}}}
    assert pipelined_oracle_part(report) == {"binds": 3}


def test_pipelined_flags_are_not_refused():
    from volcano_tpu_torch.sim.__main__ import REFUSED_FLAGS
    for flag in ("--pipelined", "--fast-admit",
                 "--verify-pipelined-equivalence"):
        assert flag not in REFUSED_FLAGS
