"""The port's host model against the JAX package's on the same seeded
inputs: Resource comparisons and arithmetic, the priority queue's order,
and a Statement's commit and discard."""

import random

import numpy as np
import pytest

import volcano_tpu.api as jax_api
import volcano_tpu_torch.api as torch_api
from volcano_tpu.utils import PriorityQueue as JaxPQ
from volcano_tpu_torch.utils import PriorityQueue as TorchPQ

from torch_parity import port_gc_windows  # noqa: F401 (autouse)
from torch_parity import SLICE_CONF

# values straddling the 0.1 epsilon of resource_info.go
_VALUES = [0.0, 0.04, 0.05, 0.0999, 0.1, 0.15, 1000.0, 1000.05, 1000.1,
           999.95, 999.9]


def _pairs(seed, n=200):
    rng = random.Random(seed)
    for _ in range(n):
        a = [rng.choice(_VALUES) for _ in range(3)]
        b = [rng.choice(_VALUES) for _ in range(3)]
        yield a, b


def _res(api, v, scalar):
    return api.Resource(v[0], v[1], {"nvidia.com/gpu": v[2]} if scalar else None)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("scalar", [False, True])
def test_resource_matches_jax(seed, scalar):
    for a, b in _pairs(seed):
        ja, jb = _res(jax_api, a, scalar), _res(jax_api, b, scalar)
        ta, tb = _res(torch_api, a, scalar), _res(torch_api, b, scalar)
        for default in (jax_api.ZERO, jax_api.INFINITY):
            assert ta.less_equal(tb, default) == ja.less_equal(jb, default)
        assert ta.is_empty() == ja.is_empty()
        s_t, s_j = ta.clone().add(tb), ja.clone().add(jb)
        assert (s_t.cpu, s_t.memory, s_t.scalars) == \
            (s_j.cpu, s_j.memory, s_j.scalars)
        if jb.less_equal(ja):
            d_t, d_j = ta.clone().sub(tb), ja.clone().sub(jb)
            assert (d_t.cpu, d_t.memory, d_t.scalars) == \
                (d_j.cpu, d_j.memory, d_j.scalars)
        else:
            with pytest.raises(AssertionError):
                ja.clone().sub(jb)
            with pytest.raises(ValueError):
                ta.clone().sub(tb)


@pytest.mark.parametrize("seed", range(3))
def test_priority_queue_order_matches_jax(seed):
    """Equal keys pop in insertion order in both."""
    rng = random.Random(seed)
    items = [(rng.randint(0, 5), i) for i in range(100)]
    less = lambda a, b: a[0] < b[0]          # noqa: E731
    jq, tq = JaxPQ(less), TorchPQ(less)
    for it in items:
        jq.push(it)
        tq.push(it)
    assert [tq.pop() for _ in items] == [jq.pop() for _ in items]
    assert tq.empty() and tq.pop() is None


def _session(pkg):
    """A session over two 2-slot nodes and a 3-task gang (min 3)."""
    api = jax_api if pkg == "jax" else torch_api
    if pkg == "jax":
        import volcano_tpu.plugins  # noqa: F401
        from volcano_tpu.cache import SchedulerCache
        from volcano_tpu.framework import open_session, parse_scheduler_conf
        kw = {}
    else:
        import volcano_tpu_torch.plugins  # noqa: F401
        from volcano_tpu_torch.cache import SchedulerCache
        from volcano_tpu_torch.framework import (open_session,
                                                 parse_scheduler_conf)
        kw = {"device": "cpu"}
    cache = SchedulerCache()
    for i in range(2):
        alloc = api.Resource(2000, 4 << 30)
        alloc.max_task_num = 10
        cache.add_node(api.NodeInfo(name=f"n{i}", allocatable=alloc))
    pg = api.PodGroup(name="j", queue="default", min_member=3,
                      phase=api.PodGroupPhase.INQUEUE)
    job = api.JobInfo(uid="j", name="j", queue="default", min_available=3,
                      podgroup=pg, creation_timestamp=0.0)
    for t in range(3):
        job.add_task_info(api.TaskInfo(uid=f"j-{t}", name=f"j-{t}", job="j",
                                       resreq=api.Resource(1000, 1 << 30),
                                       creation_timestamp=float(t)))
    cache.add_job(job)
    conf = parse_scheduler_conf(SLICE_CONF)
    return open_session(cache, conf.tiers, conf.configurations, **kw), cache


def _state(ssn, cache):
    job = ssn.jobs["j"]
    return ({u: (int(t.status), t.node_name) for u, t in job.tasks.items()},
            {n: (node.idle.cpu, node.idle.memory, node.used.cpu,
                 sorted(node.tasks)) for n, node in ssn.nodes.items()},
            dict(cache.binder.binds), job.ready(),
            (job.allocated.cpu, job.allocated.memory))


@pytest.mark.parametrize("commit", [True, False])
def test_statement_matches_jax(commit):
    states = {}
    for pkg in ("jax", "torch"):
        ssn, cache = _session(pkg)
        stmt = ssn.statement()
        tasks = list(ssn.jobs["j"].tasks.values())
        stmt.allocate(tasks[0], ssn.nodes["n0"])
        stmt.allocate(tasks[1], ssn.nodes["n0"])
        stmt.pipeline(tasks[2], "n1")
        mid = _state(ssn, cache)
        stmt.commit() if commit else stmt.discard()
        states[pkg] = (mid, _state(ssn, cache))
    assert states["torch"] == states["jax"]
    if commit:
        assert states["torch"][1][2] == {"default/j-0": "n0",
                                         "default/j-1": "n0"}
    else:
        assert all(s == (1, "") for s in states["torch"][1][0].values())
    assert np.isfinite(states["torch"][1][4]).all()


def _running_session(pkg):
    """_session's world plus a running single-task job on n1."""
    api = jax_api if pkg == "jax" else torch_api
    ssn, cache = _session(pkg)
    close = (__import__("volcano_tpu.framework", fromlist=["x"])
             if pkg == "jax" else
             __import__("volcano_tpu_torch.framework", fromlist=["x"]))
    close.close_session(ssn)
    pg = api.PodGroup(name="r", queue="default", min_member=1,
                      phase=api.PodGroupPhase.RUNNING)
    job = api.JobInfo(uid="r", name="r", queue="default", min_available=1,
                      podgroup=pg, creation_timestamp=0.0)
    task = api.TaskInfo(uid="r-0", name="r-0", job="r",
                        resreq=api.Resource(1500, 1 << 30),
                        status=api.TaskStatus.RUNNING)
    job.add_task_info(task)
    cache.nodes["n1"].add_task(job.tasks["r-0"])
    cache.add_job(job)
    conf = close.parse_scheduler_conf(SLICE_CONF)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return close.open_session(cache, conf.tiers, conf.configurations,
                              **kw), cache


@pytest.mark.parametrize("commit", [True, False])
def test_statement_evict_matches_jax(commit):
    """Evict and unevict: session state, node releasing accounting, and the
    eviction the cache records on commit."""
    states = {}
    for pkg in ("jax", "torch"):
        ssn, cache = _running_session(pkg)
        stmt = ssn.statement()
        victim = ssn.jobs["r"].tasks["r-0"]
        stmt.evict(victim, "preempt")
        stmt.pipeline(ssn.jobs["j"].tasks["j-0"], "n1")
        node = ssn.nodes["n1"]
        mid = (int(victim.status), node.releasing.cpu,
               node.future_idle().cpu, int(node.tasks["r-0"].status))
        stmt.commit() if commit else stmt.discard()
        live = cache.jobs["r"].tasks["r-0"]
        states[pkg] = (mid, int(victim.status), node.releasing.cpu,
                       node.future_idle().cpu, list(cache.evictor.evicts),
                       int(live.status), cache.nodes["n1"].releasing.cpu)
    assert states["torch"] == states["jax"]
    assert states["torch"][4] == (["default/r-0"] if commit else [])


def test_gc_window():
    """open_session suspends automatic collection until close_session or
    abandon_session; windows nest, and each closes once."""
    import gc

    assert gc.isenabled()
    ssn, _ = _session("torch")
    assert not gc.isenabled()
    inner, _ = _session("torch")
    from volcano_tpu_torch.framework import close_session
    close_session(inner)
    assert not gc.isenabled()          # the outer window is still open
    close_session(ssn)
    assert gc.isenabled()
    close_session(ssn)                 # closing twice changes nothing
    assert gc.isenabled()
    from volcano_tpu_torch.framework import abandon_session
    failed, _ = _session("torch")
    assert not gc.isenabled()
    abandon_session(failed)
    assert gc.isenabled()


def test_failed_cycle_releases_the_gc_window():
    """A cycle whose action raises re-enables automatic collection. The
    shell isolates the failure (run_once returns it, the session still
    closes, the rest of the pipeline runs), and the close releases the
    window. (The JAX package's guard, a finalizer on the session, never
    fires while collection is off: plugin callbacks hold the session in a
    cycle.)"""
    import gc

    from volcano_tpu_torch import Scheduler
    from volcano_tpu_torch.cache.synthetic import baseline_config

    class Boom(RuntimeError):
        pass

    sched = Scheduler(baseline_config("tiny")[0], SLICE_CONF, device="cpu")
    action = sched.actions[1]

    def explode(ssn):
        raise Boom("action failed")

    action.execute, real = explode, action.execute
    try:
        errors = sched.run_once()
    finally:
        action.execute = real
    assert [(name, type(exc)) for name, exc in errors] == \
        [(action.name(), Boom)]
    assert set(sched.last_cycle_s) >= {"enqueue", action.name(), "backfill",
                                       "close_session"}
    assert gc.isenabled()


@pytest.mark.parametrize("seed", range(3))
def test_scheduler_helper_matches_jax(seed):
    """sort_nodes / select_best_node / prioritize_nodes: highest score
    first, node order within a score, as the JAX package's helpers."""
    from volcano_tpu.actions.preempt import sort_nodes as jax_sort
    from volcano_tpu.utils import scheduler_helper as jax_helper
    from volcano_tpu_torch.utils import scheduler_helper as torch_helper
    rng = random.Random(seed)
    names = [f"n{i}" for i in range(30)]
    score = {n: float(rng.randint(0, 5)) for n in names}
    out = {}

    def predicate(task, node):
        if not score[node.name]:
            raise ValueError("fit failed")

    for pkg, api, helper, sort in (
            ("jax", jax_api, jax_helper, jax_sort),
            ("torch", torch_api, torch_helper, torch_helper.sort_nodes)):
        nodes = [api.NodeInfo(name=n) for n in names]
        grouped = helper.prioritize_nodes(
            None, nodes, lambda t, ns: {n.name: 0.5 for n in ns[::3]},
            lambda t, n: score[n.name])
        feasible, _ = helper.predicate_nodes(None, nodes, predicate)
        out[pkg] = ([n.name for n in sort(grouped)],
                    helper.select_best_node(grouped).name,
                    [n.name for n in feasible])
    assert out["torch"] == out["jax"]
