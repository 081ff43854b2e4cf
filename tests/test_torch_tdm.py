"""The tdm plugin in the port against the JAX package, on the CPU.

The plugin's pure parts (the zone windows on the session clock, the
disruption budget, the predicate's mask, the preempt vote) are called in
both packages in process on the same inputs. Its worlds are
tools/plugin_reference.py's tdm-1k (tdm-10k at a tenth: zones rz-open,
active at the logical clock's start, and rz-closed, inactive; preemptable
gangs with disruption budgets running on plain and rz-closed nodes) under
the host engines, and its variants with both zones closed and with a drain
period of one second, under both engines: each digest (binds and
evictions in order, PodGroup phases, node-tensor paths, each cycle's
evictions by zone) equals the JAX package's, run in a child at XLA level 0
with its tier dispatch mended as upstream's (ROADMAP §3: the fault fires
here, tdm shares the first tier with priority). tdm-1k under tpu-fused is
tests/test_torch_plugin_worlds.py's.
"""

import os
import sys
import types
from datetime import datetime, timezone

import pytest

from volcano_tpu.api import DisruptionBudget as JaxBudget
from volcano_tpu.api import JobInfo as JaxJob
from volcano_tpu.api import NodeInfo as JaxNode
from volcano_tpu.api import TaskInfo as JaxTask
from volcano_tpu.api import TaskStatus as JaxStatus
from volcano_tpu.plugins import tdm as jax_tdm
from volcano_tpu_torch.api import (DisruptionBudget, JobInfo, NodeInfo,
                                   TaskInfo, TaskStatus)
from volcano_tpu_torch.framework.session import PERMIT, REJECT
from volcano_tpu_torch.plugins import tdm

from torch_parity import port_gc_windows  # noqa: F401 (autouse)
from torch_parity import jax_reference

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import plugin_reference  # noqa: E402

ZONES = {"tdm.revocable-zone.rz-open": plugin_reference.OPEN_WINDOW,
         "tdm.revocable-zone.rz-closed": plugin_reference.CLOSED_WINDOW}
START = plugin_reference.CLOCK_START

WORLDS = ("tdm-1k@callbacks", "tdm-1k-closed", "tdm-1k-closed@callbacks",
          "tdm-1k-period", "tdm-1k-period@callbacks")


def _plugins(args=ZONES):
    from volcano_tpu.framework.arguments import Arguments as JaxArgs
    from volcano_tpu_torch.framework.arguments import Arguments
    return tdm.TDMPlugin(Arguments(args)), jax_tdm.TDMPlugin(JaxArgs(args))


def _utc(ts):
    return datetime.fromtimestamp(ts, tz=timezone.utc)


# -- the zone windows --------------------------------------------------------

@pytest.mark.parametrize("raw, ts", [
    ("13:00-14:00", START), ("00:00-12:00", START),
    ("22:00-02:00", START + 9 * 3600.0), ("10:00-21:00", 0.0),
    ("09:30-09:30", 5000.0), ("13:46-13:47", START)])
def test_parse_revocable_zone_equals_jax(raw, ts):
    """(start, end) on the clock's UTC day; the end rolls to the next day
    when it is not after the start."""
    got = tdm.parse_revocable_zone(raw, _utc(ts))
    assert got == jax_tdm.parse_revocable_zone(raw, _utc(ts))
    assert got[0] < got[1]


@pytest.mark.parametrize("zone, ts, active", [
    ("rz-open", START, True), ("rz-closed", START, False),
    ("rz-open", START + 3600.0, False), ("rz-closed", START + 11 * 3600.0,
                                         True),
    ("rz-unknown", START, False)])
def test_zone_active_on_the_session_clock(zone, ts, active):
    """The logical clock's start, 1970-01-12 13:46:40 UTC, lies in
    rz-open's 13:00-14:00 and outside rz-closed's 00:00-12:00; a zone the
    arguments do not name is never active."""
    port, ref = _plugins()
    got = port._zone_active(zone, _utc(ts))
    assert got == ref._zone_active(zone, _utc(ts))
    assert (got is None) == active


def test_malformed_window_is_reported_alike():
    port, ref = _plugins({"tdm.revocable-zone.rz": "13-14"})
    got = port._zone_active("rz", _utc(START))
    assert got == ref._zone_active("rz", _utc(START))
    assert "format error" in got


# -- the disruption budget ---------------------------------------------------

def _budget_job(api_job, api_task, status, budget_cls, budget):
    """Ten tasks: six running, two pending, one succeeded, one failed."""
    job = api_job(uid="j", name="j", queue="default", min_available=1)
    states = [status.RUNNING] * 6 + [status.PENDING] * 2 + \
        [status.SUCCEEDED, status.FAILED]
    for i, st in enumerate(states):
        job.add_task_info(api_task(uid=f"j-{i}", name=f"j-{i}", job="j",
                                   status=st))
    job.budget = None if budget is None else budget_cls(**budget)
    return job


@pytest.mark.parametrize("budget, want", [
    (None, 1), ({"min_available": "50%"}, 1), ({"min_available": 2}, 4),
    ({"max_unavailable": "5"}, 3), ({"max_unavailable": "20%"}, 0),
    ({"max_unavailable": 0}, 0)])
def test_max_evict_num_equals_jax(budget, want):
    """tdm.go:306-333: maxUnavailable counts the tasks neither running nor
    finished against it, minAvailable the running ones above it, and no
    budget allows one eviction."""
    port, ref = _plugins()
    got = port._max_evict_num(_budget_job(JobInfo, TaskInfo, TaskStatus,
                                          DisruptionBudget, budget))
    assert got == ref._max_evict_num(_budget_job(
        JaxJob, JaxTask, JaxStatus, JaxBudget, budget)) == want


# -- the predicate's mask, the node order and the preempt vote --------------

def _nodes(node_cls):
    return {name: node_cls(name=name, labels=(
        {plugin_reference.REVOCABLE_ZONE: zone} if zone else {}))
        for name, zone in (("plain", ""), ("open", "rz-open"),
                           ("closed", "rz-closed"))}


def _session(plugin, node_cls, ts):
    ssn = types.SimpleNamespace(
        nodes=_nodes(node_cls), jobs={}, cache=_Cache(), now=lambda: ts,
        fns={})
    for kind in ("predicate", "feasibility", "node_order", "preemptable",
                 "victim_tasks", "job_order", "job_pipelined",
                 "job_starving"):
        setattr(ssn, f"add_{kind}_fn",
                lambda name, fn, k=kind: ssn.fns.__setitem__(k, fn))
    plugin.on_session_open(ssn)
    return ssn


@pytest.mark.parametrize("ts", [START, START + 3600.0])
def test_mask_and_scores_equal_jax(ts):
    """B1's mask reads the predicate: a revocable node's column holds the
    tasks that name a zone while its zone is active, none otherwise; a
    plain node takes every task. The node score (callbacks engine only)
    is 100 on an active zone's node for such a task."""
    import numpy as np
    tasks = [TaskInfo(uid="a", revocable_zone="rz-open"), TaskInfo(uid="b")]
    jtasks = [JaxTask(uid="a", revocable_zone="rz-open"), JaxTask(uid="b")]
    port, ref = _plugins()
    ps, js = _session(port, NodeInfo, ts), _session(ref, JaxNode, ts)
    node_t = types.SimpleNamespace(names=["plain", "open", "closed"])
    got = ps.fns["feasibility"](ps, tasks, node_t)
    want = js.fns["feasibility"](js, jtasks, node_t)
    assert got.dtype == want.dtype and (got == want).all()
    open_now = ts == START
    assert (got == np.array([[True, open_now, False],
                             [True, False, False]])).all()
    for t, jt in zip(tasks, jtasks):
        for name in node_t.names:
            assert ps.fns["node_order"](t, ps.nodes[name]) == \
                js.fns["node_order"](jt, js.nodes[name])
            raised = []
            for fns, task, nodes in ((ps.fns, t, ps.nodes),
                                     (js.fns, jt, js.nodes)):
                try:
                    fns["predicate"](task, nodes[name])
                    raised.append(None)
                except ValueError as err:
                    raised.append(str(err))
            assert raised[0] == raised[1]
            assert (raised[0] is None) == bool(got[tasks.index(t),
                                                   node_t.names.index(name)])


def test_preempt_vote_equals_jax():
    """A preemptable or revocable preemptor is refused; another takes
    preemptable running tasks on plain nodes only, one a job without a
    budget."""
    port, ref = _plugins()
    out = []
    for plugin, job_cls, task_cls, node_cls, status in (
            (port, JobInfo, TaskInfo, NodeInfo, TaskStatus),
            (ref, JaxJob, JaxTask, JaxNode, JaxStatus)):
        ssn = _session(plugin, node_cls, START)
        victims = []
        for j, node in enumerate(("plain", "plain", "closed")):
            job = job_cls(uid=f"v{j}", name=f"v{j}", queue="default")
            for k in range(2):
                t = task_cls(uid=f"v{j}-{k}", job=f"v{j}",
                             status=status.RUNNING, preemptable=j != 1,
                             node_name=node)
                job.add_task_info(t)
                victims.append(t)
            ssn.jobs[job.uid] = job
        vote = ssn.fns["preemptable"]
        out.append([
            vote(task_cls(uid="p", preemptable=True), victims),
            vote(task_cls(uid="p", revocable_zone="rz-open"), victims),
            [(v.uid if hasattr(v, "uid") else v)
             for v in vote(task_cls(uid="p"), victims)[0]],
            vote(task_cls(uid="p"), victims)[1]])
    assert out[0] == out[1]
    assert out[0][0] == (None, REJECT) and out[0][1] == (None, REJECT)
    assert out[0][2] == ["v0-0"] and out[0][3] == PERMIT


def test_job_votes_equal_jax():
    """Job order puts non-preemptable jobs first; a job pipelines once its
    waiting and ready tasks reach its minimum; only a non-preemptable job
    with pending tasks starves."""
    from volcano_tpu.api import Resource as JaxResource
    from volcano_tpu_torch.api import Resource
    port, ref = _plugins()
    got = []
    for plugin, job_cls, task_cls, node_cls, status, res in (
            (port, JobInfo, TaskInfo, NodeInfo, TaskStatus, Resource),
            (ref, JaxJob, JaxTask, JaxNode, JaxStatus, JaxResource)):
        ssn = _session(plugin, node_cls, START)
        jobs = []
        for j, (pre, st) in enumerate(((False, status.PENDING),
                                       (True, status.PENDING),
                                       (False, status.RUNNING))):
            job = job_cls(uid=f"j{j}", name=f"j{j}", min_available=2)
            job.preemptable = pre
            for k in range(2):
                job.add_task_info(task_cls(uid=f"j{j}-{k}", status=st,
                                           resreq=res(1000, 1 << 30)))
            jobs.append(job)
        got.append([[ssn.fns["job_order"](a, b) for b in jobs] for a in jobs]
                   + [[ssn.fns["job_pipelined"](j) for j in jobs],
                      [ssn.fns["job_starving"](j) for j in jobs]])
    assert got[0] == got[1]
    assert got[0][3] == [REJECT, REJECT, PERMIT]
    assert got[0][4] == [True, False, False]


class _Cache:
    """A scheduler cache's stand-in: the drain's time is keyed by it."""


def test_drain_time_lives_on_the_class():
    """Plugins are built anew at each session: the drain's last time is
    kept on the class, by cache, so a second session within the period
    drains nothing and another cache drains on its own."""
    from volcano_tpu_torch.framework.arguments import Arguments
    cache = _Cache()
    drained = []
    for ts in (START, START + 1.0):
        plugin = tdm.TDMPlugin(Arguments(ZONES))
        ssn = _session(plugin, NodeInfo, ts)
        ssn.cache = cache
        drained.append(ssn.fns["victim_tasks"]())
    assert drained == [[], None]
    assert tdm.TDMPlugin._last_evict_at[cache] == START
    other = _session(tdm.TDMPlugin(Arguments(ZONES)), NodeInfo, START + 1.0)
    other.cache = _Cache()
    assert other.fns["victim_tasks"]() == []


# -- the worlds --------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_reference("plugin-world", list(WORLDS),
                         tmp_path_factory.mktemp("jax") / "tdm.pkl")


_PORT: dict = {}


def _port(world):
    if world not in _PORT:
        keep = []
        out = plugin_reference.run_world("volcano_tpu_torch", world, "cpu",
                                         keep=keep)
        _PORT[world] = out["digest"], keep[0]
    return _PORT[world]


@pytest.mark.parametrize("world", WORLDS)
def test_world_equals_jax(world, reference):
    got, _ = _port(world)
    assert got == reference[world]
    assert got["action_failures"] == [] and got["binds"] > 0


@pytest.mark.parametrize("default, period", [
    ("tdm-1k-closed", "tdm-1k-period"),
    ("tdm-1k@callbacks", "tdm-1k-period@callbacks")])
def test_drain_runs_once_a_period(default, period):
    """The drain evicts preemptable pods from rz-closed's nodes in the
    first cycle only at the default period (60 s, a cycle a second), and
    in every cycle that finds one at a period of one second."""
    first = [c["evicts_by_zone"].get("rz-closed", 0)
             for c in _port(default)[0]["per_cycle"]]
    assert first[0] > 0 and first[1:] == [0] * (len(first) - 1)
    every = [c["evicts_by_zone"].get("rz-closed", 0)
             for c in _port(period)[0]["per_cycle"]]
    assert every[0] > 0 and every[1] > 0


@pytest.mark.parametrize("world, open_binds", [
    ("tdm-1k-closed", False), ("tdm-1k-period@callbacks", True)])
def test_closed_zone_takes_no_pod(world, open_binds):
    """No pod is bound to a node of an inactive zone; rz-open's nodes take
    preemptable pods while its window holds."""
    _, cache = _port(world)
    zones = {n.name: n.revocable_zone for n in cache.nodes.values()}
    bound = [zones[node] for node in cache.binder.binds.values()]
    assert "rz-closed" not in bound
    assert ("rz-open" in bound) == open_binds
