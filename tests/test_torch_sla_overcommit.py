"""The sla and overcommit plugins in the port against the JAX package, on
the CPU.

The pure parts (Go durations, overcommit's factor, the enqueue votes, sla's
job order and its permit on the session clock) are called in both packages
in process. The worlds are tools/plugin_reference.py's sla-overcommit-1k
(sla-overcommit-10k at a tenth: pending PodGroups whose minimums sum to
about 1.5x the cluster's idle CPU, the gangs enqueue reaches last waiting
1.5 s or 2.5 s under sla) under the host engines, and overcommit alone at
factor 1.2 and at 0.5 (clamped to 1.2) under both engines: each digest
equals the JAX package's, run in a child at XLA level 0 with its duration
units mended as Go's (ROADMAP §3: it reads "1500ms" as 1,500 minutes).
sla-overcommit-1k under tpu-fused is tests/test_torch_plugin_worlds.py's.
"""

import os
import sys
import types

import pytest

from volcano_tpu.api import JobInfo as JaxJob
from volcano_tpu.api import NodeInfo as JaxNode
from volcano_tpu.api import PodGroup as JaxPodGroup
from volcano_tpu.api import PodGroupPhase as JaxPhase
from volcano_tpu.api import Resource as JaxResource
from volcano_tpu.framework.arguments import Arguments as JaxArgs
from volcano_tpu.plugins import overcommit as jax_overcommit
from volcano_tpu.plugins import sla as jax_sla
from volcano_tpu_torch.api import (JobInfo, NodeInfo, PodGroup,
                                   PodGroupPhase, Resource)
from volcano_tpu_torch.framework.arguments import Arguments
from volcano_tpu_torch.framework.session import ABSTAIN, PERMIT, REJECT
from volcano_tpu_torch.plugins import overcommit, sla

from torch_parity import port_gc_windows  # noqa: F401 (autouse)
from torch_parity import jax_reference

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import plugin_reference  # noqa: E402

GI = 1 << 30
WORLDS = ("sla-overcommit-1k@callbacks", "overcommit-1k",
          "overcommit-1k@callbacks", "overcommit-1k-clamped",
          "overcommit-1k-clamped@callbacks")
PORT = types.SimpleNamespace(job=JobInfo, pg=PodGroup, phase=PodGroupPhase,
                             res=Resource, node=NodeInfo, args=Arguments,
                             sla=sla, overcommit=overcommit)
JAX = types.SimpleNamespace(job=JaxJob, pg=JaxPodGroup, phase=JaxPhase,
                            res=JaxResource, node=JaxNode, args=JaxArgs,
                            sla=jax_sla, overcommit=jax_overcommit)


# -- Go durations -------------------------------------------------------------

@pytest.mark.parametrize("text, seconds", [
    ("1500ms", 1.5), ("2500ms", 2.5), ("1h", 3600.0), ("90s", 90.0),
    ("1.5h", 5400.0), ("1m30s", 90.0), ("250us", 250e-6), ("", None),
    ("soon", None)])
def test_parse_duration_reads_go_units(text, seconds):
    """Go's time.ParseDuration: the units are read longest first."""
    got = sla.parse_duration(text)
    assert got == pytest.approx(seconds) if seconds else got is None


@pytest.mark.parametrize("text", ["1h", "90s", "1.5h", "1m30s", "", "soon"])
def test_parse_duration_equals_jax_without_ms(text):
    assert sla.parse_duration(text) == jax_sla.parse_duration(text)


def test_jax_reads_milliseconds_as_minutes():
    """The fault of the JAX package the port fixes (ROADMAP §3): its
    alternation tries "m" before "ms"."""
    assert jax_sla.parse_duration("1500ms") == 1500 * 60.0
    assert sla.parse_duration("1500ms") == 1.5


# -- overcommit ----------------------------------------------------------------

@pytest.mark.parametrize("factor, want", [
    (None, 1.2), ("0.5", 1.2), ("0.99", 1.2), ("1.0", 1.0), ("2", 2.0),
    ("many", 0.0)])
def test_overcommit_factor_equals_jax(factor, want):
    """A factor below 1.0 is clamped to the default 1.2 (one that does not
    parse reads as 0.0, and is clamped too)."""
    args = {} if factor is None else {"overcommit-factor": factor}
    got = overcommit.OvercommitPlugin(Arguments(args)).factor
    assert got == jax_overcommit.OvercommitPlugin(JaxArgs(args)).factor
    assert got == (1.2 if want < 1.0 else want)


def _vote_session(pk, votes):
    """Two nodes of 8 CPU (3 used), a running gang, and gangs asking for
    3, 4, 5 and 2 CPU, then one without minResources."""
    nodes = {}
    for i in range(2):
        node = pk.node(name=f"n{i}", allocatable=pk.res(8000, 8 * GI))
        nodes[node.name] = node
    nodes["n0"].used = pk.res(3000, GI)
    jobs = {}
    for j, cpu in enumerate((3000, 4000, 5000, 2000, None)):
        pg = pk.pg(name=f"j{j}", phase=pk.phase.PENDING,
                   min_resources=None if cpu is None else pk.res(cpu, GI))
        jobs[f"j{j}"] = pk.job(uid=f"j{j}", name=f"j{j}", podgroup=pg)
    pg = pk.pg(name="q", phase=pk.phase.INQUEUE,
               min_resources=pk.res(4000, GI))
    jobs["q"] = pk.job(uid="q", name="q", podgroup=pg)
    ssn = types.SimpleNamespace(nodes=nodes, jobs=jobs, now=lambda: 10.0)
    ssn.add_job_enqueueable_fn = lambda name, fn: votes.append(fn)
    ssn.add_job_pipelined_fn = lambda name, fn: None
    ssn.add_job_order_fn = lambda name, fn: None
    return ssn


@pytest.mark.parametrize("factor", ["1.2", "1.0", "2"])
def test_overcommit_votes_equal_jax(factor):
    """Enqueue admits a gang while the inqueue minimums with it fit idle
    x factor, 16 x factor - 3 CPU; the Inqueue gang's 4 count from the
    start, a refused gang's not at all."""
    got = []
    for pk in (PORT, JAX):
        votes = []
        ssn = _vote_session(pk, votes)
        plugin = pk.overcommit.OvercommitPlugin(
            pk.args({"overcommit-factor": factor}))
        plugin.on_session_open(ssn)
        got.append([votes[0](ssn.jobs[f"j{j}"]) for j in range(5)])
    assert got[0] == got[1]
    want = {"1.2": [PERMIT, PERMIT, PERMIT, REJECT, PERMIT],
            "1.0": [PERMIT, PERMIT, REJECT, PERMIT, PERMIT],
            "2": [PERMIT, PERMIT, PERMIT, PERMIT, PERMIT]}[factor]
    assert got[0] == want


# -- sla -----------------------------------------------------------------------

def _sla_jobs(pk):
    """Jobs created at 0, 1 and 2 s, waiting 3 s (annotation), 1 s (the
    job's own) and the plugin's argument."""
    jobs = []
    for j, (ann, own) in enumerate((("3s", None), (None, 1.0), (None, None))):
        pg = pk.pg(name=f"j{j}", annotations={"sla-waiting-time": ann}
                   if ann else {})
        job = pk.job(uid=f"j{j}", name=f"j{j}", podgroup=pg,
                     creation_timestamp=float(j))
        job.waiting_time = own
        jobs.append(job)
    return jobs


@pytest.mark.parametrize("arg", [None, "10s"])
def test_sla_votes_and_order_equal_jax(arg):
    """A job's waiting time: its own, then its annotation, then the
    argument. Job order by deadline (creation + waiting time), jobs with
    none last; enqueue and pipelining are permitted once the session clock
    passes the deadline, else abstained."""
    args = {} if arg is None else {"sla-waiting-time": arg}
    got = []
    for pk in (PORT, JAX):
        out = []
        for now in (2.5, 3.5, 12.5):
            fns = {}
            ssn = types.SimpleNamespace(now=lambda t=now: t)
            ssn.add_job_order_fn = lambda n, fn: fns.__setitem__("order", fn)
            ssn.add_job_enqueueable_fn = \
                lambda n, fn: fns.__setitem__("enq", fn)
            ssn.add_job_pipelined_fn = lambda n, fn: fns.__setitem__("pip", fn)
            pk.sla.SLAPlugin(pk.args(args)).on_session_open(ssn)
            jobs = _sla_jobs(pk)
            out.append([[fns["order"](a, b) for b in jobs] for a in jobs]
                       + [[fns["enq"](j) for j in jobs],
                          [fns["pip"](j) for j in jobs]])
        got.append(out)
    assert got[0] == got[1]
    enq = [row[3] for row in got[0]]
    third = ABSTAIN if arg is None else PERMIT
    assert enq == [[ABSTAIN, PERMIT, ABSTAIN], [PERMIT, PERMIT, ABSTAIN],
                   [PERMIT, PERMIT, third]]
    assert got[0][0][1][0] == -1 if arg else got[0][0][0][2] == -1


# -- the worlds ----------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_reference("plugin-world", list(WORLDS),
                         tmp_path_factory.mktemp("jax") / "sla.pkl")


_PORT: dict = {}


def _port(world):
    if world not in _PORT:
        _PORT[world] = plugin_reference.run_world("volcano_tpu_torch", world,
                                                  "cpu")["digest"]
    return _PORT[world]


@pytest.mark.parametrize("world", WORLDS)
def test_world_equals_jax(world, reference):
    got = _port(world)
    assert got == reference[world]
    assert got["action_failures"] == [] and got["binds"] > 0


def test_sla_permits_what_overcommit_holds_back():
    """Overcommit keeps the last gangs Pending in the first cycle; sla lets
    those waiting 1.5 s enqueue in the second and those waiting 2.5 s in the
    third. Without sla they stay Pending."""
    pending = [c["podgroup_phases"].get("Pending", 0)
               for c in _port("sla-overcommit-1k@callbacks")["per_cycle"]]
    assert pending[0] > pending[1] > pending[2] == 0
    alone = [c["podgroup_phases"].get("Pending", 0)
             for c in _port("overcommit-1k@callbacks")["per_cycle"]]
    assert alone == [pending[0]] * 3


@pytest.mark.parametrize("engine", ["", "@callbacks"])
def test_clamped_factor_decides_as_the_default(engine):
    """overcommit-factor 0.5 is clamped to 1.2: the same decisions."""
    assert _port("overcommit-1k-clamped" + engine) == \
        _port("overcommit-1k" + engine)
