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
