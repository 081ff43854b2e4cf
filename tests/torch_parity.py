"""Shared helpers of the tests/test_torch_*.py files: the slice conf, the
worlds both packages schedule, the plain-data form that carries a cluster
from one package to the other, and the JAX package's results as the
reference.

The JAX reference runs in a child process (``jax_reference``) with
XLA_FLAGS=--xla_backend_optimization_level=0. Compiled at its default
level, XLA:CPU contracts each multiply feeding an add into one fused
multiply-add, which moves a node score by an ulp and can flip a near-tie
between two nodes; PyTorch's ops and the CUDA kernel (built with
-fmad=false) round every operation on its own. With LLVM's optimizations
off the JAX programs do too, so the two packages must decide alike bit for
bit. The flag cannot change in the test process itself: XLA reads it once.

Run as a script, this file computes the references:
``python tests/torch_parity.py
{slice|deployed|evict|walk|walk-modes|plugins|place|blocks|engines|incremental|
pipelined|topo|topo-dispatch} OUT NAME...``, or
``mixed OUT KIND:NAME...``.
"""

from __future__ import annotations

import functools
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

SLICE_CONF = """
actions: "enqueue, allocate-tpu, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: nodeorder
  - name: binpack
configurations:
- name: allocate-tpu
  arguments:
    engine: tpu-fused
"""

_TESTS = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_TESTS)
# deploy/scheduler.conf as written: enqueue, allocate-tpu, preempt, reclaim,
# backfill with priority, gang | drf, predicates, proportion, nodeorder,
# binpack
with open(os.path.join(_REPO, "deploy", "scheduler.conf")) as _f:
    DEPLOYED_CONF = _f.read()
NO_FMA_XLA_FLAGS = "--xla_backend_optimization_level=0"


@pytest.fixture(autouse=True)
def port_gc_windows():
    """The port's sessions suspend automatic garbage collection until they
    close (volcano_tpu_torch/framework/framework.py). Tests that leave a
    session open to inspect it would keep collection off for every later
    test in the process, the JAX package's GC tests included: close the
    windows a test leaked. Test modules that open port sessions import this
    fixture, which makes it autouse there."""
    yield
    from volcano_tpu_torch.framework import framework as fw
    for window in list(fw._GC_OPEN_WINDOWS):
        fw._gc_resume(window)


# ---------------------------------------------------------------------------
# the slice's worlds, built as JAX SchedulerCaches
# ---------------------------------------------------------------------------

def _jax_cache(nodes, jobs, queues):
    from volcano_tpu.cache import FakeBinder, FakeEvictor, SchedulerCache
    cache = SchedulerCache(binder=FakeBinder(), evictor=FakeEvictor())
    for q in queues:
        cache.add_queue(q)
    for n in nodes:
        cache.add_node(n)
    for j in jobs:
        cache.add_job(j)
    return cache


def _nodes(n, labels=lambda i: {}, taints=lambda i: [], gpus=0,
           cards=lambda i: 0, numa=lambda i: None, api=None):
    """make_cluster's nodes (32 cores, 128 GiB, 110 pods), with labels and
    taints; ``cards(i)`` shared GPU cards of 24,576 MiB (the
    volcano.sh/gpu-number and gpu-memory capacity, milli-scaled as
    Resource.from_dict scales them) and ``numa(i)`` a topology policy for
    2 NUMA nodes x 16 CPUs under the static CPU manager. ``api`` is the
    package's api module (the JAX package's by default)."""
    if api is None:
        import volcano_tpu.api as api
    from volcano_tpu.cache.synthetic import GI
    out = []
    for i in range(n):
        scalars = {"nvidia.com/gpu": float(gpus)} if gpus else {}
        if cards(i):
            scalars["volcano.sh/gpu-number"] = cards(i) * 1000.0
            scalars["volcano.sh/gpu-memory"] = cards(i) * 24576 * 1000.0
        alloc = api.Resource(32000, 128 * GI, scalars or None)
        alloc.max_task_num = 110
        node = api.NodeInfo(name=f"node-{i:05d}", allocatable=alloc,
                            labels=labels(i), taints=taints(i))
        if numa(i):
            from importlib import import_module
            numa_info = import_module(
                api.__name__.replace(".api", ".api.numa_info"))
            node.numa_info = numa_info.NumatopoInfo.uniform(
                node.name, 2, 16, topology_policy=numa(i))
        out.append(node)
    return out


def _queues(*weights):
    from volcano_tpu.api import QueueInfo
    return [QueueInfo(name=f"q{k + 1}", weight=w) for k, w in enumerate(weights)]


def _baseline(name):
    from volcano_tpu.cache.synthetic import baseline_config
    return baseline_config(name)[0]


def _three_queue():
    """The 10k world's shape at a tenth: 1k pods in 20 gangs, 200 nodes,
    3 queues."""
    from volcano_tpu.cache.synthetic import make_jobs
    return _jax_cache(_nodes(200), make_jobs(1000, 20, ["q1", "q2", "q3"],
                                             seed=1), _queues(3, 2, 1))


def _tight():
    """Demand ~3.5x capacity: most gangs cannot all fit and roll back."""
    from volcano_tpu.cache.synthetic import make_jobs
    return _jax_cache(_nodes(12), make_jobs(600, 30, ["q1", "q2"], seed=2),
                      _queues(3, 2))


def _releasing():
    """A departing job's RELEASING tasks hold 24 of each node's 32 cores:
    pending gangs fit future idle, not idle, so they pipeline."""
    from volcano_tpu.api import (JobInfo, PodGroup, PodGroupPhase, QueueInfo,
                                 Resource, TaskInfo, TaskStatus)
    from volcano_tpu.cache.synthetic import GI, make_jobs
    nodes = _nodes(20)
    old = JobInfo(uid="old", name="old", queue="default", min_available=20,
                  podgroup=PodGroup(name="old", queue="default", min_member=20,
                                    phase=PodGroupPhase.RUNNING),
                  creation_timestamp=-1.0)
    for i, node in enumerate(nodes):
        task = TaskInfo(uid=f"old-{i}", name=f"old-{i}", job="old",
                        resreq=Resource(24000, 64 * GI),
                        status=TaskStatus.RELEASING, creation_timestamp=0.0)
        old.add_task_info(task)
        node.add_task(old.tasks[task.uid])
    jobs = [old] + make_jobs(240, 12, ["default"], seed=3)
    return _jax_cache(nodes, jobs, [QueueInfo(name="default", weight=1)])


def _taints():
    """PreferNoSchedule taints on 10% of nodes, tolerated by every third
    gang, and preferred node affinity on two gangs: nodeorder's static
    score matrix is on the solve."""
    from volcano_tpu.cache.synthetic import make_jobs
    taint = {"key": "dedicated", "value": "batch", "effect": "PreferNoSchedule"}
    nodes = _nodes(100, labels=lambda i: {"zone": "a" if i % 5 == 0 else "b"},
                   taints=lambda i: [taint] if i % 10 == 3 else [])
    jobs = make_jobs(800, 40, ["q1", "q2", "q3"], seed=4)
    pref = {"nodeAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [
        {"weight": 30, "preference": {"matchExpressions": [
            {"key": "zone", "operator": "In", "values": ["a"]}]}}]}}
    for j, job in enumerate(jobs):
        for task in job.tasks.values():
            if j % 3 == 0:
                task.tolerations = [dict(taint)]
            if j in (5, 17):
                task.affinity = pref
    return _jax_cache(nodes, jobs, _queues(3, 2, 1))


def _gpu():
    """A third resource column (nvidia.com/gpu): R = 3."""
    from volcano_tpu.api import QueueInfo
    from volcano_tpu.cache.synthetic import make_jobs
    return _jax_cache(_nodes(40, gpus=8),
                      make_jobs(300, 10, ["default"], gpus_per_task=1, seed=5),
                      [QueueInfo(name="default", weight=1)])


def _labelled_tasks(jobs, namespace=lambda j: "default",
                    labels=lambda j: {}, affinity=lambda j: {},
                    annotations=lambda j: {}, policy=lambda j: "",
                    api=None):
    """``jobs`` (pending, as make_jobs gives them) built anew with each
    job j's tasks in ``namespace(j)`` with ``labels(j)``,
    ``affinity(j)``, ``annotations(j)`` and topology ``policy(j)``."""
    if api is None:
        import volcano_tpu.api as api
    out = []
    for j, job in enumerate(jobs):
        new = api.JobInfo(uid=job.uid, name=job.name,
                          namespace=job.namespace, queue=job.queue,
                          min_available=job.min_available,
                          podgroup=job.podgroup, priority=job.priority,
                          creation_timestamp=job.creation_timestamp)
        for t in job.tasks.values():
            new.add_task_info(api.TaskInfo(
                uid=t.uid, name=t.name, namespace=namespace(j), job=t.job,
                resreq=t.resreq, status=t.status, priority=t.priority,
                creation_timestamp=t.creation_timestamp, labels=labels(j),
                affinity=affinity(j), annotations=annotations(j),
                topology_policy=policy(j)))
        out.append(new)
    return out


def plugin_slice_world(api, synthetic, cache_mod):
    """Every plugin-slice field on one small world, built with either
    package's modules: node labels (hostname, zone), GPU cards on every
    fourth node, a NUMA topology on every third, and gangs with pod
    labels, pod affinity, namespaces, priority-class annotations, topology
    policies and card-memory requests."""
    zone = "topology.kubernetes.io/zone"
    nodes = _nodes(24, labels=lambda i: {
        "kubernetes.io/hostname": f"node-{i:05d}", zone: f"zone-{i % 3}"},
        cards=lambda i: 4 if i % 4 == 0 else 0,
        numa=lambda i: ("single-numa-node", "best-effort")[i % 2]
        if i % 3 == 0 else None, api=api)
    jobs = synthetic.make_jobs(240, 12, ["default"], seed=7)

    def affinity(j):
        term = {"labelSelector": {"matchLabels": {"app": f"app-{j}"}},
                "topologyKey": zone}
        kind = ("podAffinity", "podAntiAffinity")[j % 2]
        return {kind: {"requiredDuringSchedulingIgnoredDuringExecution":
                       [term]}} if j % 3 == 0 else {}

    jobs = _labelled_tasks(
        jobs, namespace=lambda j: "kube-system" if j == 5 else "default",
        labels=lambda j: {"app": f"app-{j}"}, affinity=affinity,
        annotations=lambda j: {"priorityClassName": "system-node-critical"}
        if j == 6 else {},
        policy=lambda j: "single-numa-node" if j == 8 else "", api=api)
    cache = cache_mod.SchedulerCache(binder=cache_mod.FakeBinder(),
                                     evictor=cache_mod.FakeEvictor())
    cache.add_queue(api.QueueInfo(name="default", weight=1))
    for n in nodes:
        cache.add_node(n)
    for j in jobs:
        cache.add_job(j)
    return cache


SLICE_WORLDS = {
    "tiny": lambda: _baseline("tiny"),
    "1k": lambda: _baseline("1k"),
    "three-queue": _three_queue,
    "tight": _tight,
    "releasing": _releasing,
    "taints": _taints,
    "gpu": _gpu,
    "10k": lambda: _baseline("10k"),
}


# ---------------------------------------------------------------------------
# the placement solve's worlds: (idle, releasing, used, ntasks, cap,
# max_tasks, req, job_ix, feas, static, min_avail), as
# tests/test_pallas_place.py::_random_instance gives them
# ---------------------------------------------------------------------------

def _random(seed, T=40, N=12, J=6, R=3, tight=False):
    """tests/test_pallas_place.py::_random_instance, draw for draw: the
    same seed gives the same world. A copy, because that module imports
    JAX and the card's machine, where test_torch_cuda.py runs these worlds,
    has none."""
    rng = np.random.RandomState(seed)
    cap = rng.choice([2000.0, 4000.0, 8000.0], size=(N, R)).astype(np.float32)
    used = (cap * rng.uniform(0, 0.5 if not tight else 0.8, size=(N, R))
            ).astype(np.float32)
    idle = cap - used
    releasing = (cap * rng.uniform(0, 0.1, size=(N, R))).astype(np.float32)
    req = rng.choice([250.0, 500.0, 1000.0, 2000.0],
                     size=(T, R)).astype(np.float32)
    job_ix = np.sort(rng.randint(0, J, size=T)).astype(np.int32)
    feas = rng.rand(T, N) > (0.2 if not tight else 0.5)
    static = rng.randint(0, 50, size=(T, N)).astype(np.float32)
    min_avail = rng.randint(1, 6, size=J).astype(np.int32)
    max_tasks = rng.randint(2, 30, size=N).astype(np.int32)
    ntasks = rng.randint(0, 3, size=N).astype(np.int32)
    return (idle, releasing, used, ntasks, cap, max_tasks, req, job_ix,
            feas, static, min_avail)


def _integer(inst):
    """The instance with whole-number state, where the Pallas kernel's fit
    rule (req <= idle) and the scan's (req < idle + 0.1) agree."""
    idle, releasing, used, *rest = inst
    cap = rest[1]
    used = np.round(used).astype(np.float32)
    return (cap - used, np.round(releasing).astype(np.float32), used, *rest)


def _ties():
    """Identical empty nodes and identical tasks: every pick is a tie."""
    N, T, R = 16, 50, 2
    cap = np.full((N, R), 8000.0, np.float32)
    z = np.zeros((N, R), np.float32)
    job_ix = np.repeat(np.arange(5), 10).astype(np.int32)
    return (cap.copy(), z, z.copy(), np.zeros(N, np.int32), cap,
            np.full(N, 30, np.int32), np.full((T, R), 1000.0, np.float32),
            job_ix, np.ones((T, N), bool), np.zeros((T, N), np.float32),
            np.array([10, 4, 10, 10, 10], np.int32))


def _sub_epsilon():
    """Idle within 0.1 below the request on half the nodes (those fit by
    the reference's epsilon) and 0.2 below on the rest (those do not)."""
    N, R = 8, 2
    cap = np.full((N, R), 4000.0, np.float32)
    idle = np.where(np.arange(N)[:, None] % 2 == 0, 999.95, 999.8).astype(
        np.float32) * np.ones((N, R), np.float32)
    used = cap - idle
    T = 12
    job_ix = np.repeat(np.arange(4), 3).astype(np.int32)
    return (idle, np.zeros((N, R), np.float32), used,
            np.zeros(N, np.int32), cap, np.full(N, 30, np.int32),
            np.full((T, R), 1000.0, np.float32), job_ix,
            np.ones((T, N), bool), np.zeros((T, N), np.float32),
            np.array([3, 3, 3, 1], np.int32))


def _rollback():
    """Six 4-slot nodes, two of them with releasing capacity: gangs of
    10, 6 and 6 fit, the next 6 and 8 roll back, the last 2 fits again."""
    N, R = 6, 2
    cap = np.full((N, R), 4000.0, np.float32)
    used = np.zeros((N, R), np.float32)
    used[:2] = 2000.0
    releasing = np.zeros((N, R), np.float32)
    releasing[:2] = 2000.0
    sizes = [10, 6, 6, 6, 8, 2]
    job_ix = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    T = len(job_ix)
    static = (np.arange(T)[:, None] * 7 + np.arange(N)[None, :] * 3) % 11
    return (cap - used, releasing, used, np.zeros(N, np.int32), cap,
            np.full(N, 30, np.int32), np.full((T, R), 1000.0, np.float32),
            job_ix, np.ones((T, N), bool), static.astype(np.float32),
            np.array(sizes, np.int32))


def _runs():
    """Gangs of 20-50 tasks, each gang one request and one static row (with
    its own infeasible nodes), the requests differing across gangs: the
    kernel's cache re-scores one node a task inside a gang."""
    rng = np.random.RandomState(11)
    N, R = 40, 3
    sizes = [20, 35, 50, 28, 44, 31]
    cap = rng.choice([8000.0, 16000.0, 32000.0], size=(N, R)).astype(np.float32)
    used = (cap * rng.uniform(0, 0.3, size=(N, R))).astype(np.float32)
    releasing = (cap * rng.uniform(0, 0.05, size=(N, R))).astype(np.float32)
    job_ix = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    gang_req = np.array([[500, 1000, 250], [1000, 500, 500], [250, 250, 1000],
                         [2000, 1000, 250], [500, 2000, 500],
                         [1000, 1000, 1000]], np.float32)
    gang_feas = rng.rand(len(sizes), N) > 0.2
    gang_static = rng.randint(0, 50, size=(len(sizes), N)).astype(np.float32)
    return (cap - used, releasing, used, np.zeros(N, np.int32), cap,
            np.full(N, 40, np.int32), gang_req[job_ix], job_ix,
            gang_feas[job_ix], gang_static[job_ix],
            np.array([20, 30, 50, 28, 40, 31], np.int32))


def _static_one_node():
    """One request throughout; each task's static row differs from the one
    before on a single node (a new score, or that node masked out)."""
    rng = np.random.RandomState(12)
    N, R, T = 24, 2, 60
    cap = np.full((N, R), 16000.0, np.float32)
    used = (cap * rng.uniform(0, 0.4, size=(N, R))).astype(np.float32)
    static = np.empty((T, N), np.float32)
    feas = np.empty((T, N), bool)
    row = rng.randint(0, 50, size=N).astype(np.float32)
    ok = np.ones(N, bool)
    for t in range(T):
        n = rng.randint(N)
        if rng.rand() < 0.3:
            ok[n] = not ok[n]
        else:
            row[n] = rng.randint(0, 50)
        static[t], feas[t] = row, ok
    job_ix = np.repeat(np.arange(6), 10).astype(np.int32)
    return (cap - used, np.zeros((N, R), np.float32), used,
            np.zeros(N, np.int32), cap, np.full(N, 30, np.int32),
            np.full((T, R), 1000.0, np.float32), job_ix, feas, static,
            np.array([10, 5, 10, 10, 3, 10], np.int32))


def _rollback_then_same():
    """A gang of 30 on twelve 4-slot nodes rolls back, and the next gangs
    ask the same request: every node the first gang touched was restored,
    so its cached entries are stale."""
    N, R = 12, 2
    cap = np.full((N, R), 4000.0, np.float32)
    used = np.zeros((N, R), np.float32)
    used[::3] = 1000.0
    sizes = [30, 8, 8, 30, 4]
    job_ix = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    T = len(job_ix)
    static = ((np.arange(T)[:, None] // 40) * 5
              + np.arange(N)[None, :] * 2) % 7
    return (cap - used, np.zeros((N, R), np.float32), used,
            np.zeros(N, np.int32), cap, np.full(N, 30, np.int32),
            np.full((T, R), 1000.0, np.float32), job_ix,
            np.ones((T, N), bool), static.astype(np.float32),
            np.array([30, 8, 8, 30, 4], np.int32))


def _wide_ties():
    """Identical nodes at N = 3 * 64 + 5 = 197 and identical tasks, three to
    a node: the picks walk up the node axis through ties, across the node
    slices of every cluster size, and the lowest index must win."""
    N, R, T = 197, 2, 480
    cap = np.full((N, R), 8000.0, np.float32)
    z = np.zeros((N, R), np.float32)
    job_ix = np.repeat(np.arange(24), 20).astype(np.int32)
    return (cap.copy(), z, z.copy(), np.zeros(N, np.int32), cap,
            np.full(N, 3, np.int32), np.full((T, R), 1000.0, np.float32),
            job_ix, np.ones((T, N), bool), np.zeros((T, N), np.float32),
            np.full(24, 20, np.int32))


PLACE_WORLDS = {
    **{f"random-{s}": (lambda s=s: _random(s)) for s in range(6)},
    **{f"tight-{s}": (lambda s=s: _random(100 + s, T=60, N=8, J=10,
                                          tight=True)) for s in range(3)},
    "multi-chunk": lambda: _random(7, T=300, N=16, J=5),
    "integer-0": lambda: _integer(_random(0)),
    "integer-tight": lambda: _integer(_random(101, T=60, N=8, J=10,
                                              tight=True)),
    "ties": _ties,
    "sub-epsilon": _sub_epsilon,
    "rollback": _rollback,
    "runs": _runs,
    "static-one-node": _static_one_node,
    "rollback-then-same": _rollback_then_same,
    "wide-ties": _wide_ties,
}
# where the Pallas kernel (interpret mode) must agree with the scan too
INTEGER_PLACE_WORLDS = ("integer-0", "integer-tight", "ties", "rollback")
_place_scan_jit = None


def jax_place(inst, pallas: bool):
    """place_scan (and, with ``pallas``, place_pallas in interpret mode) on
    one instance: each a tuple (task_node, pipelined, job_ready, job_kept,
    idle, future_idle, used, ntasks) of numpy arrays."""
    import jax
    import jax.numpy as jnp

    from volcano_tpu.ops.pallas_place import NEG, place_pallas
    from volcano_tpu.ops.place import (JobMeta, NodeState, PlacementTasks,
                                       place_scan)
    from volcano_tpu.ops.scores import default_weights
    (idle, releasing, used, ntasks, cap, max_tasks, req, job_ix,
     feas, static, min_avail) = inst
    T, R = req.shape
    J = len(min_avail)
    future_idle = idle + releasing
    w = default_weights(R)
    first = np.ones(T, bool)
    first[1:] = job_ix[1:] != job_ix[:-1]
    last = np.ones(T, bool)
    last[:-1] = job_ix[1:] != job_ix[:-1]
    global _place_scan_jit
    if _place_scan_jit is None:
        # one compile per shape, not per call; unrolling changes the loop's
        # speed, not its steps, and un-unrolled compiles faster
        _place_scan_jit = jax.jit(functools.partial(place_scan, unroll=1))
    res = _place_scan_jit(
        NodeState(idle=jnp.asarray(idle), future_idle=jnp.asarray(future_idle),
                  used=jnp.asarray(used), ntasks=jnp.asarray(ntasks)),
        PlacementTasks(req=jnp.asarray(req), job_ix=jnp.asarray(job_ix),
                       valid=jnp.ones(T, bool), feas=jnp.asarray(feas),
                       static_score=jnp.asarray(static),
                       first_of_job=jnp.asarray(first),
                       last_of_job=jnp.asarray(last)),
        JobMeta(min_available=jnp.asarray(min_avail),
                base_ready=jnp.zeros(J, jnp.int32),
                base_pipelined=jnp.zeros(J, jnp.int32)),
        w, jnp.asarray(cap), jnp.asarray(max_tasks))
    out = {"scan": tuple(np.asarray(a) for a in (
        res.task_node, res.task_pipelined, res.job_ready, res.job_kept,
        res.nodes.idle, res.nodes.future_idle, res.nodes.used,
        res.nodes.ntasks))}
    if pallas:
        got = place_pallas(
            idle, future_idle, used, ntasks.astype(np.float32), cap,
            max_tasks.astype(np.float32), req, job_ix,
            np.where(feas, static, NEG).astype(np.float32), min_avail,
            np.zeros(J, np.int32), np.zeros(J, np.int32),
            np.asarray(w.binpack_res))
        out["pallas"] = (got.task_node, got.task_pipelined, got.job_ready,
                         got.job_kept, got.idle, got.future_idle, got.used,
                         got.ntasks.astype(np.int32))
    return out


# ---------------------------------------------------------------------------
# the zone-anchor solve's worlds (B6): dicts of NumPy arrays — node state
# with a zone code a node, tasks, gangs, a feasibility mask and static
# scores (None: every pair feasible, no static score) — and the weights
# each world runs at
# ---------------------------------------------------------------------------

def topo_small_world(seed, N=5, T=7, J=3, R=2):
    """tests/test_elastic_gang.py::_small_world, draw for draw, as NumPy
    (the card's machine has no JAX)."""
    rng = np.random.RandomState(seed)
    used = rng.uniform(0.0, 3.0, (N, R)).astype(np.float32)
    idle = rng.uniform(2.0, 8.0, (N, R)).astype(np.float32)
    releasing = rng.uniform(0.0, 1.0, (N, R)).astype(np.float32)
    ntasks = rng.randint(0, 2, N).astype(np.int32)
    allocatable = used + idle + releasing
    max_tasks = rng.randint(3, 6, N).astype(np.int32)
    zone_code = rng.randint(0, 3, N).astype(np.int32)
    cuts = np.sort(rng.choice(np.arange(1, T), J - 1, replace=False))
    job_ix = np.zeros(T, np.int32)
    for c in cuts:
        job_ix[c:] += 1
    sizes = np.bincount(job_ix, minlength=J)
    req = rng.uniform(0.5, 3.0, (T, R)).astype(np.float32)
    feas = rng.random((T, N)) < 0.85
    static = rng.uniform(0.0, 5.0, (T, N)).astype(np.float32)
    return {"idle": idle, "future_idle": idle + releasing, "used": used,
            "ntasks": ntasks, "allocatable": allocatable,
            "max_tasks": max_tasks, "zone_code": zone_code, "req": req,
            "job_ix": job_ix, "feas": feas, "static": static,
            "min_available": np.maximum(1, sizes - 1).astype(np.int32)}


def _topo_nodes(zones, cpu, used=None, max_tasks=30):
    """Nodes of ``cpu`` milli-CPU and 4x as much memory, in the given zone
    codes, ``used`` of each taken."""
    N = len(zones)
    cap = np.stack([np.full(N, cpu, np.float32),
                    np.full(N, 4.0 * cpu, np.float32)], axis=1)
    used = np.zeros((N, 2), np.float32) if used is None else \
        np.asarray(used, np.float32)
    return {"idle": cap - used, "future_idle": cap - used, "used": used,
            "ntasks": np.zeros(N, np.int32), "allocatable": cap,
            "max_tasks": np.full(N, max_tasks, np.int32),
            "zone_code": np.asarray(zones, np.int32)}


def _topo_gangs(world, sizes, cpu, min_available=None, static=None):
    job_ix = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    T = len(job_ix)
    world.update(
        req=np.tile(np.asarray([cpu, 4.0 * cpu], np.float32), (T, 1)),
        job_ix=job_ix, feas=None if static is None else
        np.ones((T, len(world["zone_code"])), bool),
        static=static, min_available=np.asarray(
            sizes if min_available is None else min_available, np.int32))
    return world


def _topo_unzoned_first():
    """The emptiest nodes are unzoned, so a gang's first pick leaves the
    anchor at 0 and a later pick on a zoned node anchors it."""
    used = [[0, 0], [0, 0], [1000, 4000], [1000, 4000], [1500, 6000],
            [1500, 6000], [500, 2000], [2000, 8000]]
    w = _topo_nodes([0, 0, 11, 11, 22, 22, 33, 33], 4000, used,
                    max_tasks=3)
    return _topo_gangs(w, [5, 4, 6, 3], 1000)


def _topo_rollback():
    """Gangs that roll back between gangs that fit: the anchor resets at
    each gang's first task whatever the last one left."""
    used = [[0, 0]] * 3 + [[2000, 8000]] * 3
    w = _topo_nodes([7, 7, 8, 8, 9, 9], 4000, used, max_tasks=4)
    sizes = [4, 9, 3, 12, 2]
    static = ((np.arange(sum(sizes))[:, None] * 7
               + np.arange(6)[None, :] * 3) % 11).astype(np.float32)
    return _topo_gangs(w, sizes, 1000, static=static)


def _topo_single_zone():
    """One zone: once a gang anchors, every node gets the bonus."""
    used = [[i * 300, i * 1200] for i in range(6)]
    w = _topo_nodes([5] * 6, 8000, used)
    return _topo_gangs(w, [3, 5, 2, 6], 1500)


def _topo_wide_ties():
    """Identical nodes at N = 197 in 13 zones taken in turn (node i in zone
    1 + i % 13), identical tasks three to a node: ties across zones and
    across every cluster size's CTA slices. Without the term each gang
    fills nodes in index order, so across zones; with it a gang stays in
    its first node's zone while the zone has room."""
    N = 197
    w = _topo_nodes(1 + np.arange(N) % 13, 8000, max_tasks=3)
    return _topo_gangs(w, [20] * 24, 1000)


def _topo_holes():
    """Hole rows of the persistent tensors (an all-zero row: pod limit 0,
    zone 0) between zoned nodes, never placed on."""
    w = _topo_nodes([3, 0, 3, 4, 0, 4, 5, 5], 4000, max_tasks=4)
    for k in ("idle", "future_idle", "used", "allocatable"):
        w[k][[1, 4]] = 0.0
    w["max_tasks"][[1, 4]] = 0
    return _topo_gangs(w, [4, 6, 4, 3], 1000)


TOPO_WORLDS = {
    **{f"small-{s}": (lambda s=s: topo_small_world(s)) for s in (11, 12, 13)},
    "unzoned-first": _topo_unzoned_first,
    "rollback": _topo_rollback,
    "single-zone": _topo_single_zone,
    "wide-ties": _topo_wide_ties,
    "holes": _topo_holes,
}
# the weights each world runs at: the small worlds at test_elastic_gang.py's
# 0 and 3, the hand-built ones at the sim's 10 (and 0 where it matters)
TOPO_CASES = [(w, tw) for w in TOPO_WORLDS
              for tw in ((0.0, 3.0) if w.startswith("small-")
                         else (0.0, 10.0) if w == "wide-ties" else (10.0,))]


def jax_topo(world, topo_weight):
    """place_scan_topo_packed on one world: (packed wire i32[2T+2J], idle,
    future_idle, used, ntasks) as NumPy arrays."""
    import jax.numpy as jnp

    from volcano_tpu.ops.place import (JobMeta, NodeState, PlacementTasks,
                                       place_scan_topo_packed)
    from volcano_tpu.ops.scores import default_weights
    req, job_ix = world["req"], world["job_ix"]
    T, R = req.shape
    N = len(world["zone_code"])
    J = len(world["min_available"])
    first = np.ones(T, bool)
    first[1:] = job_ix[1:] != job_ix[:-1]
    last = np.ones(T, bool)
    last[:-1] = job_ix[1:] != job_ix[:-1]
    feas = np.ones((T, N), bool) if world["feas"] is None else world["feas"]
    static = (np.zeros((T, N), np.float32) if world["static"] is None
              else world["static"])
    packed, nodes = place_scan_topo_packed(
        NodeState(idle=jnp.asarray(world["idle"]),
                  future_idle=jnp.asarray(world["future_idle"]),
                  used=jnp.asarray(world["used"]),
                  ntasks=jnp.asarray(world["ntasks"])),
        PlacementTasks(req=jnp.asarray(req), job_ix=jnp.asarray(job_ix),
                       valid=jnp.ones(T, bool), feas=jnp.asarray(feas),
                       static_score=jnp.asarray(static),
                       first_of_job=jnp.asarray(first),
                       last_of_job=jnp.asarray(last)),
        JobMeta(min_available=jnp.asarray(world["min_available"]),
                base_ready=jnp.zeros(J, jnp.int32),
                base_pipelined=jnp.zeros(J, jnp.int32)),
        default_weights(R), jnp.asarray(world["allocatable"]),
        jnp.asarray(world["max_tasks"]), jnp.asarray(world["zone_code"]),
        jnp.float32(topo_weight))
    return tuple(np.asarray(a) for a in (packed, *nodes))


def topo_args(world, device):
    """place_topo_plain/place_topo_cuda's arguments for a world on
    ``device``, without the weight: the masked static matrix is None when
    the world has no mask and no static score."""
    import torch

    from volcano_tpu_torch.ops.place import task_flags
    from volcano_tpu_torch.ops.scores import default_weights
    J = len(world["min_available"])
    zeros = np.zeros(J, np.int32)
    flags, ready_need, keep_need = task_flags(
        world["job_ix"], world["min_available"], zeros, zeros)
    ms = None
    if world["feas"] is not None or world["static"] is not None:
        T, N = len(world["job_ix"]), len(world["zone_code"])
        f = np.ones((T, N), bool) if world["feas"] is None else world["feas"]
        st = (np.zeros((T, N), np.float32) if world["static"] is None
              else world["static"])
        ms = np.where(f, st, NEG_MASK).astype(np.float32)

    def t(a):
        return None if a is None else torch.tensor(a, device=device)

    return (t(world["idle"]), t(world["future_idle"]), t(world["used"]),
            t(world["ntasks"]), t(world["allocatable"]),
            t(world["max_tasks"]), t(world["req"]), t(flags), t(ready_need),
            t(keep_need), t(ms), default_weights(world["req"].shape[1]),
            t(world["zone_code"]))


# volcano_tpu_torch.ops.place.NEG, without importing torch at module load
NEG_MASK = -1e30


def mend_jax_zone_codes():
    """Give the JAX package's PersistentNodeTensors the ``device_zone_code``
    its positive-weight solve calls and lacks (ROADMAP §3;
    tools/sim_reference.py mends its children alike): the zone-code row its
    device rows already hold."""
    from volcano_tpu.cache.snapshot import PersistentNodeTensors
    if not hasattr(PersistentNodeTensors, "device_zone_code"):
        PersistentNodeTensors.device_zone_code = \
            lambda self: self._device["zone_code"]


def mend_jax_tier_scope():
    """Carry the tiered victim dispatch's ``init`` across tiers in the JAX
    package (in this process only), as upstream's session_plugins.go does
    and the port does (ROADMAP §3): once a plugin has returned victims, a
    later veto leaves none instead of letting the next tier rule. Both the
    session's dispatch and the walk's tier replay
    (``volcano_tpu/ops/evict.py::_tier_eval``, looked up when a walk is
    traced) are replaced. The JAX tier stack does not keep drf's place in
    its tier, so its walk takes drf after the tier's static plugins (the
    port's plain ``drf`` kind). Idempotent; returns nothing."""
    import jax.numpy as jnp

    from volcano_tpu.framework import session as jax_session
    from volcano_tpu.ops import evict as jax_evict
    if getattr(jax_evict, "_tier_scope_mended", False):
        return

    def tiered_victims(self, registry, flag, invoke):
        victims, init = [], False
        for tier in self.tiers:
            for opt in tier.plugins:
                if flag is not None and not opt.is_enabled(flag):
                    continue
                fn = registry.get(opt.name)
                if fn is None:
                    continue
                candidates = invoke(fn)
                if candidates is None:
                    continue
                if not candidates:
                    victims = []
                    break
                if not init:
                    victims, init = list(candidates), True
                else:
                    ids = {c.uid for c in candidates}
                    victims = [v for v in victims if v.uid in ids]
            if init:
                return victims
        return []

    def tier_eval(tier_kinds, masks_g, cand, dynamic_fn):
        n = cand.shape[0]
        decided = jnp.zeros(n, bool)
        dyn_decided = jnp.zeros(n, bool)
        dyn_extra = None
        elig = jnp.zeros_like(cand)
        for kind, (m_nw, part) in zip(tier_kinds, masks_g):
            if m_nw.shape[0]:
                tset = cand & jnp.all(m_nw | ~part[:, None, None], axis=0)
                cnt = jnp.sum(cand[None] & m_nw, axis=-1)          # [Mt, n]
                ok_n = jnp.all((cnt > 0) | ~part[:, None], axis=0)
                participated = jnp.any(part)
                lead = cnt[jnp.argmax(part)] > 0    # first participant
            else:
                tset = cand
                ok_n = jnp.ones(n, bool)
                participated = jnp.zeros((), bool)
                lead = jnp.zeros(n, bool)
            if kind != "static":
                dset, dyn_extra = dynamic_fn(cand)
                tset = tset & dset
                some = jnp.sum(dset, axis=-1) > 0
                ok_n = ok_n & some
                lead = jnp.where(participated, lead, some)
                participated = jnp.ones((), bool)
            ok_n = ok_n & participated
            take = ok_n & ~decided
            elig = elig | (tset & take[:, None])
            if kind != "static":
                dyn_decided = dyn_decided | take
            decided = decided | (lead & participated)
        return elig, dyn_decided, dyn_extra

    jax_session.Session._tiered_victims = tiered_victims
    jax_evict._tier_eval = tier_eval
    jax_evict._tier_scope_mended = True


def mend_jax_duration():
    """Read a Go duration's units longest first in the JAX package's
    ``plugins/sla.py::parse_duration`` (in this process only), as Go's
    time.ParseDuration and the port do (ROADMAP §3): its alternation tries
    "m" before "ms", so "1500ms" reads as 1,500 minutes. sla's waiting
    times and tdm's drain period read through it. Idempotent."""
    import re

    from volcano_tpu.plugins import sla
    sla._DUR_RE = re.compile(r"(\d+(?:\.\d+)?)(ms|us|µs|ns|h|m|s)")


def mend_jax():
    """Every mend of a fault of the JAX package that the port fixes and
    the tests hold it to: the tier scope and the duration units."""
    mend_jax_tier_scope()
    mend_jax_duration()


TOPO_CONF = """
actions: "enqueue, allocate-tpu, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
configurations:
- name: allocate-tpu
  arguments:
    engine: tpu-fused
    topology-weight: 10.0
"""


def topo_dispatch(torch_port: bool) -> dict:
    """One speculative zone-anchor dispatch (``dispatch_speculative_solve``
    then ``finalize_speculative_dispatch``) on a zoned drive world: 12
    nodes of 4 CPU in 3 zones, one cycle of TOPO_CONF over 8 gangs of 3
    pods (1 CPU each), then 10 more gangs, and the speculative session's
    solve. Returns the solution's task uids, node names, pipelined flags
    and each job's ready and kept verdicts."""
    gi = 1 << 30
    if torch_port:
        from volcano_tpu_torch import Scheduler
        from volcano_tpu_torch.actions import allocate as alloc
        from volcano_tpu_torch.api import (JobInfo, NodeInfo, PodGroup,
                                           PodGroupPhase, QueueInfo,
                                           Resource, TaskInfo)
        from volcano_tpu_torch.cache import SchedulerCache
        from volcano_tpu_torch.framework import abandon_session, open_session
        kw = {"device": "cpu"}
    else:
        from volcano_tpu.actions import allocate as alloc
        from volcano_tpu.api import (JobInfo, NodeInfo, PodGroup,
                                     PodGroupPhase, QueueInfo, Resource,
                                     TaskInfo)
        from volcano_tpu.cache import SchedulerCache
        from volcano_tpu.framework import abandon_session, open_session
        from volcano_tpu.scheduler import Scheduler
        kw = {}
        mend_jax_zone_codes()

    def mkjob(uid, ts, phase=PodGroupPhase.PENDING):
        pg = PodGroup(name=uid, queue="q1", min_member=3, phase=phase)
        job = JobInfo(uid=uid, name=uid, queue="q1", min_available=3,
                      podgroup=pg, creation_timestamp=ts)
        for t in range(3):
            job.add_task_info(TaskInfo(
                uid=f"{uid}-{t}", name=f"{uid}-{t}", job=uid,
                resreq=Resource(1000, gi), creation_timestamp=ts + t * 1e-6))
        return job

    cache = SchedulerCache(default_queue=None)
    cache.add_queue(QueueInfo(name="q1", weight=1))
    for i in range(12):
        r = Resource(4000, 16 * gi)
        r.max_task_num = 40
        cache.add_node(NodeInfo(name=f"n{i:02d}", allocatable=r,
                                labels={"volcano.sh/topology-zone":
                                        f"z{i // 4}"}))
    for j in range(8):
        cache.add_job(mkjob(f"a{j}", float(j)))
    sched = Scheduler(cache, conf_text=TOPO_CONF, **kw)
    assert sched.run_once() == []
    for j in range(10):
        # admitted by an enqueue the drive does not run
        cache.add_job(mkjob(f"b{j}", 100.0 + j, PodGroupPhase.INQUEUE))
    ssn = open_session(cache, sched.conf.tiers, sched.conf.configurations,
                       speculative=True, **kw)
    try:
        pending = alloc.dispatch_speculative_solve(ssn, "tpu-fused")
        sol = alloc.finalize_speculative_dispatch(pending)
        names = list(sol.node_t.names)
        return {"tasks": [t.uid for t in sol.tasks],
                "nodes": [names[int(n)] if int(n) >= 0 else None
                          for n in sol.task_node],
                "pipelined": [bool(p) for p in sol.pipelined],
                # the JAX solution pads the job axis to a power of two
                "ready": [bool(r) for r in sol.job_ready[:len(sol.jobs_list)]],
                "kept": [bool(k) for k in sol.job_kept[:len(sol.jobs_list)]]}
    finally:
        abandon_session(ssn)


# ---------------------------------------------------------------------------
# the block auction's worlds (B4): dicts of NumPy arrays — node state,
# tasks, gangs, an optional masked static matrix — and the solve's chunk
# and budgets
# ---------------------------------------------------------------------------

GI = float(1 << 30)
NEG_F32 = np.float32(-1e30)


def _blocks_world(alloc, req, job_ix, min_avail, *, ms=None, used=None,
                  releasing=None, ntasks=None, max_tasks=None, chunk=256,
                  sweeps=3, passes=3):
    alloc = np.asarray(alloc, np.float32)
    req = np.asarray(req, np.float32)
    N, R = alloc.shape
    used = np.zeros((N, R), np.float32) if used is None else used
    releasing = (np.zeros((N, R), np.float32) if releasing is None
                 else releasing)
    J = len(min_avail)
    return {
        "idle": (alloc - used).astype(np.float32),
        "future_idle": (alloc - used + releasing).astype(np.float32),
        "used": np.asarray(used, np.float32),
        "ntasks": (np.zeros(N, np.int32) if ntasks is None
                   else np.asarray(ntasks, np.int32)),
        "allocatable": alloc,
        "max_tasks": (np.full(N, 100, np.int32) if max_tasks is None
                      else np.asarray(max_tasks, np.int32)),
        "req": req, "valid": np.ones(len(req), bool),
        "job_ix": np.asarray(job_ix, np.int32),
        "min_available": np.asarray(min_avail, np.int32),
        "base_ready": np.zeros(J, np.int32),
        "base_pipelined": np.zeros(J, np.int32),
        "ms": None if ms is None else np.asarray(ms, np.float32),
        "chunk": chunk, "sweeps": sweeps, "passes": passes,
    }


def _unified(seed, with_ms, sweeps, passes):
    """tests/test_unified.py's build(seed) world (96 tasks in 8 gangs, 16
    nodes, chunks of 16) and, with ``with_ms``, its masked_static_for
    matrix: copies, draw for draw, since that module imports JAX."""
    T, N, J, R = 96, 16, 8, 2
    rng = np.random.RandomState(seed)
    alloc = rng.choice([4000.0, 8000.0], size=(N, R)).astype(np.float32)
    req = rng.choice([500.0, 1000.0, 2000.0], size=(T, R)).astype(np.float32)
    job_ix = np.sort(rng.randint(0, J, size=T)).astype(np.int32)
    min_avail = [max(1, (job_ix == j).sum() // 2) for j in range(J)]
    ms = None
    if with_ms:
        rng = np.random.RandomState(seed + 1000)
        feas = rng.rand(T, N) < 0.85
        feas[:, 0] = True
        static = rng.rand(T, N).astype(np.float32) * 0.5
        ms = np.where(feas, static, NEG_F32)
    return _blocks_world(alloc, req, job_ix, min_avail, ms=ms, chunk=16,
                         sweeps=sweeps, passes=passes)


def _zero_static(world):
    """The world with an all-zero static matrix and every pair feasible:
    what the JAX package's non-sharded blocks engine always builds."""
    world["ms"] = np.zeros((len(world["req"]), len(world["idle"])),
                           np.float32)
    return world


def _ops_place_blocks(case):
    """The three blocks cases of tests/test_ops_place.py (place_blocks: an
    all-true mask and a zero static matrix)."""
    if case == "capacity":
        alloc, req, jx, mina = ([[2000.0, 4000.0], [1000.0, 2000.0]],
                                [[1000, 2000]] * 3, [0, 0, 0], [3])
        kw = dict(chunk=4)
    elif case == "rollback-refill":
        alloc, req, jx, mina = ([[1000.0, 1000.0]], [[1000, 1000]] * 3,
                                [0, 0, 1], [2, 1])
        kw = dict(chunk=2)
    else:
        alloc, req, jx, mina = ([[2500.0, 2500.0]], [[1000, 1000]] * 4,
                                [0, 1, 2, 3], [1] * 4)
        kw = dict(chunk=4, sweeps=1)
    ms = np.zeros((len(req), len(alloc)), np.float32)
    return _blocks_world(alloc, req, jx, mina, ms=ms, **kw)


def _blocks_identical():
    """40 identical empty nodes, 600 identical tasks in 12 gangs of 50:
    every candidate list is a run of ties."""
    alloc = np.tile([[32000.0, 128 * GI]], (40, 1))
    req = np.tile([[1000.0, 2 * GI]], (600, 1))
    jx = np.repeat(np.arange(12), 50)
    return _blocks_world(alloc, req, jx, [50] * 12,
                         max_tasks=np.full(40, 110))


def _blocks_random(seed, T, N, J, R=2, chunk=256, tight=False, ms=False,
                   fractional=False):
    rng = np.random.RandomState(seed)
    if fractional:
        alloc = rng.uniform(3.0, 9.0, size=(N, R)).astype(np.float32)
        req = rng.uniform(0.1, 2.3, size=(T, R)).astype(np.float32)
    else:
        alloc = rng.choice([4000.0, 8000.0, 16000.0],
                           size=(N, R)).astype(np.float32)
        req = rng.choice([250.0, 500.0, 1000.0, 2000.0],
                         size=(T, R)).astype(np.float32)
    used = (alloc * rng.uniform(0, 0.8 if tight else 0.3, (N, R))
            ).astype(np.float32)
    releasing = (alloc * rng.uniform(0, 0.1, (N, R))).astype(np.float32)
    jx = np.sort(rng.randint(0, J, size=T))
    mina = [max(1, int((jx == j).sum() * 3 // 4)) for j in range(J)]
    m = None
    if ms:
        m = np.where(rng.rand(T, N) > 0.2,
                     rng.randint(0, 30, (T, N)), NEG_F32)
    return _blocks_world(alloc, req, jx, mina, ms=m, used=used,
                         releasing=releasing,
                         ntasks=rng.randint(0, 3, N),
                         max_tasks=rng.randint(8, 60, N), chunk=chunk)


def _blocks_gangs(T, N, J, seed=17):
    """T tasks in J equal gangs, one request a gang (as the synthetic
    baselines have it), on N nodes of 32 CPU / 128 GiB / 110 pods, a third
    of them partly used."""
    rng = np.random.RandomState(seed)
    alloc = np.tile([[32000.0, 128 * GI]], (N, 1)).astype(np.float32)
    used = np.where(rng.rand(N, 1) < 1 / 3,
                    alloc * rng.choice([0.25, 0.5], size=(N, 1)), 0.0
                    ).astype(np.float32)
    reqs = np.stack([rng.choice([500.0, 1000.0, 2000.0], J),
                     rng.choice([1.0, 2.0, 4.0], J) * GI], axis=1)
    jx = np.repeat(np.arange(J), T // J)
    return _blocks_world(alloc, reqs[jx].astype(np.float32), jx,
                         [T // J] * J, used=used, max_tasks=np.full(N, 110))


def _blocks_one_node():
    """40 single-task jobs in one chunk, all of whose best node is node 2
    (half used: binpack prefers it), which holds ten of them."""
    alloc = np.tile([[8000.0, 8000.0]], (6, 1))
    used = np.zeros((6, 2), np.float32)
    used[2] = 4000.0
    req = np.tile([[400.0, 400.0]], (40, 1))
    return _blocks_world(alloc, req, np.arange(40), [1] * 40, used=used,
                         chunk=64)


def _blocks_idle_chunks():
    """1,024 tasks in chunks of 256 on 64 nodes, a static matrix that makes
    nodes 0-31 the best: the first three chunks place in pass 1, the last
    chunk's large tasks fill nodes 0-31 and the rest wait for pass 2, in
    which the first three chunks have no work."""
    N = 64
    alloc = np.tile([[8000.0, 8000.0]], (N, 1))
    req = np.concatenate([np.tile([[100.0, 100.0]], (768, 1)),
                          np.tile([[2000.0, 2000.0]], (256, 1))])
    jx = np.concatenate([np.repeat(np.arange(24), 32),
                         24 + np.arange(256)])
    ms = np.zeros((1024, N), np.float32)
    ms[:, :32] = 100.0
    return _blocks_world(alloc, req, jx, [32] * 24 + [1] * 256, ms=ms,
                         max_tasks=np.full(N, 110))


def _lane_boundary():
    """Four requests whose [C,C]-product sum (four lanes, (l0 + l1) + (l2 +
    l3)) is an ulp above their sum in order, a fifth request r, and a node
    value A at which r + lanes >= A + EPS > r + in-order sum: the order of
    the sum decides whether the fifth task fits."""
    f32 = np.float32
    rng = np.random.RandomState(0)
    while True:
        v = rng.uniform(0.5, 2.0, 4).astype(f32)
        lanes = f32(f32(v[0] + v[1]) + f32(v[2] + v[3]))
        seq = f32(f32(f32(v[0] + v[1]) + v[2]) + v[3])
        if lanes > seq:
            break
    r = f32(1.0)
    lo, hi = f32(r + seq), f32(r + lanes)
    a = f32(hi - f32(0.1))
    while not lo < f32(a + f32(0.1)) <= hi:
        up = f32(a + f32(0.1)) <= lo
        a = np.nextafter(a, f32(np.inf) if up else f32(-np.inf), dtype=f32)
    return np.append(v, r).astype(f32), a


def _blocks_lanes(split, chunk=8):
    """Five single-task jobs on one node (tasks 0-3 the requests of
    _lane_boundary, task 4 the fifth): with ``split`` False the node's
    FutureIdle is A, and the bidding wave rejects task 4; with ``split`` its
    Idle is A and FutureIdle 10 more, and the alloc/pipe split pipelines
    it. A sum in another order keeps it in both."""
    v, a = _lane_boundary()
    req = np.stack([v, np.ones(5, np.float32)], axis=1)
    alloc = np.array([[a, 100.0]], np.float32)
    rel = np.array([[10.0 if split else 0.0, 0.0]], np.float32)
    return _blocks_world(alloc, req, np.arange(5), [1] * 5, releasing=rel,
                         chunk=chunk, sweeps=1, passes=1)


def _blocks_fractional_frees(T=1024):
    """T fractional requests in 8 gangs on 4 nodes; every other gang asks
    for one task more than it has, so the sweep frees its tasks, which span
    blocks of 256 on every node: the frees' order shows in the final node
    state."""
    rng = np.random.RandomState(15)
    req = rng.uniform(0.1, 2.3, size=(T, 2)).astype(np.float32)
    alloc = np.full((4, 2), 1e4, np.float32)
    size = T // 8
    mina = [size + 1 if j % 2 else size for j in range(8)]
    return _blocks_world(alloc, req, np.repeat(np.arange(8), size), mina,
                         max_tasks=np.full(4, 1000))


def _blocks_static_classes():
    """96 tasks with one request in 3 gangs on 20 nodes, chunks of 32: each
    task's static row favours its own node (task mod 20), so rows with
    equal requests but different static rows must not share candidates;
    every fourth task repeats its predecessor's row, which may."""
    T, N = 96, 20
    ms = np.zeros((T, N), np.float32)
    for t in range(T):
        src = t - 1 if t % 4 == 3 else t
        ms[t, src % N] = 50.0
    ms[5, 7] = -0.0                      # -0 and +0: other bits, one score
    alloc = np.tile([[4000.0, 16 * GI]], (N, 1))
    req = np.tile([[1000.0, 2 * GI]], (T, 1))
    return _blocks_world(alloc, req, np.repeat(np.arange(3), 32), [32] * 3,
                         ms=ms, chunk=32)


def _blocks_max_tasks():
    """40 single-task jobs in one chunk of 256, all of whose best node is
    node 2 (half used: binpack prefers it), which has room for all of
    them but holds 2 of its 7 pods: it takes exactly its last 5."""
    alloc = np.tile([[64000.0, 64000.0]], (6, 1))
    used = np.zeros((6, 2), np.float32)
    used[2] = 32000.0
    ntasks = np.zeros(6, np.int32)
    ntasks[2] = 2
    max_tasks = np.full(6, 100, np.int32)
    max_tasks[2] = 7
    req = np.tile([[400.0, 400.0]], (40, 1))
    return _blocks_world(alloc, req, np.arange(40), [1] * 40, used=used,
                         ntasks=ntasks, max_tasks=max_tasks)


def _blocks_mixed_exact():
    """Two chunks of 64 in one solve on 8 nodes: every request a multiple
    of 2^-20 (the solve's unit). Chunk 0's requests (1/8 each) total 8 a
    column, below 2^24 units (16), so its sums are exact; chunk 1's (up to
    2) total more, so its sums keep the reference's order."""
    rng = np.random.RandomState(21)
    small = np.full((64, 2), 0.125, np.float32)
    big = (rng.randint(1, 1 << 21, size=(64, 2)) / float(1 << 20)
           ).astype(np.float32)
    req = np.concatenate([small, big])
    alloc = rng.uniform(3.0, 9.0, size=(8, 2)).astype(np.float32)
    used = (alloc * rng.uniform(0, 0.5, (8, 2))).astype(np.float32)
    jx = np.concatenate([np.repeat(np.arange(8), 8),
                         8 + np.repeat(np.arange(16), 4)])
    return _blocks_world(alloc, req, jx, [8] * 8 + [3] * 16, used=used,
                         max_tasks=np.full(8, 60), chunk=64)


BLOCK_WORLDS = {
    **{f"unified-{s}-{'ms' if m else 'plain'}-{sw}{pa}":
       (lambda s=s, m=m, sw=sw, pa=pa: _unified(s, m, sw, pa))
       for s in (0, 1, 3) for m in (False, True)
       for sw, pa in ((3, 3), (5, 4))},
    "unified-1-caps-98": lambda: _unified(1, False, 9, 8),
    "unified-0-zeros-33": lambda: _zero_static(_unified(0, False, 3, 3)),
    **{f"ops-place-{c}": (lambda c=c: _ops_place_blocks(c))
       for c in ("capacity", "rollback-refill", "contention-exact")},
    "identical": _blocks_identical,
    "n-lt-32": lambda: _blocks_random(11, T=120, N=10, J=8, chunk=64,
                                      tight=True),
    "t300-padding": lambda: _blocks_random(12, T=300, N=50, J=20, ms=True),
    "one-node-40": _blocks_one_node,
    "fractional": lambda: _blocks_random(13, T=700, N=24, J=30, R=3,
                                         chunk=64, tight=True,
                                         fractional=True),
    "fractional-ms": lambda: _blocks_random(14, T=500, N=40, J=25, R=3,
                                            chunk=128, tight=True, ms=True,
                                            fractional=True),
    "idle-chunks": _blocks_idle_chunks,
    "lanes-wave": lambda: _blocks_lanes(False),
    "lanes-wave-256": lambda: _blocks_lanes(False, 256),
    "lanes-split-256": lambda: _blocks_lanes(True, 256),
    "fractional-frees": _blocks_fractional_frees,
    "static-classes": _blocks_static_classes,
    "max-tasks-exact": _blocks_max_tasks,
    "mixed-exact": _blocks_mixed_exact,
}

def _blocks_past_2_23():
    """256 tasks in 8 gangs of one request each, in chunks of 32, on 2^23 +
    64 nodes: more than the round kernel's 32-bit grouping keys can number
    (2^23 - 1), so it sorts 64-bit keys. Only nodes 0-7 (three quarters
    used, room for about 64 of the tasks), node 2^23 - 1 and the 64 nodes
    from 2^23 on have pod room, so most bids land on nodes a 23-bit node
    field cannot hold."""
    N = (1 << 23) + 64
    alloc = np.tile(np.array([[32000.0, 128 * GI]], np.float32), (N, 1))
    used = np.zeros((N, 2), np.float32)
    used[:8] = alloc[:8] * 0.75
    max_tasks = np.zeros(N, np.int32)
    max_tasks[:8] = 110
    max_tasks[(1 << 23) - 1:] = 110
    rng = np.random.RandomState(23)
    reqs = np.stack([rng.choice([500.0, 1000.0, 2000.0], 8),
                     rng.choice([1.0, 2.0, 4.0], 8) * GI], axis=1)
    jx = np.repeat(np.arange(8), 32)
    return _blocks_world(alloc, reqs[jx].astype(np.float32), jx, [32] * 8,
                         used=used, max_tasks=max_tasks, chunk=32)


# Worlds for the card only (blocks_plain on the CPU would take minutes):
# 20,000 nodes and 2,048 tasks in 8 gangs of one request each, few classes a
# chunk, so the candidate kernel splits the node axis; a fractional world
# at the 20k engine cycle's size (20,000 tasks, 5,000 nodes), whose chunks
# all sum in the reference's order; and 2^23 + 64 nodes, where the round
# kernel groups by node on 64-bit keys.
CARD_BLOCK_WORLDS = {
    "n20000-few-classes": lambda: _blocks_gangs(2048, 20000, 8),
    "fractional-20k": lambda: _blocks_random(16, T=20000, N=5000, J=400,
                                             fractional=True),
    "n-past-2^23": _blocks_past_2_23,
}


def blocks_args(world, device):
    """blocks_plain/blocks_cuda's arguments for a blocks world on
    ``device``: the task axis padded, then the chunk and budgets as
    keywords."""
    import torch

    from volcano_tpu_torch.ops.blocks import JobMeta, pad_tasks
    from volcano_tpu_torch.ops.scores import default_weights

    def t(k):
        return torch.tensor(world[k], device=device)

    req, valid, job_ix, ms = pad_tasks(
        t("req"), t("valid"), t("job_ix"),
        None if world["ms"] is None else t("ms"), world["chunk"])
    args = (t("idle"), t("future_idle"), t("used"), t("ntasks"),
            t("allocatable"), t("max_tasks"), req, valid, job_ix,
            JobMeta(t("min_available"), t("base_ready"), t("base_pipelined")),
            ms, default_weights(world["req"].shape[1]))
    return args, {k: world[k] for k in ("chunk", "sweeps", "passes")}


def jax_blocks(world):
    """place_blocks_unified(None, ...) on a blocks world: the packed row and
    the final node state, as NumPy arrays."""
    import jax.numpy as jnp

    from volcano_tpu.ops.place import JobMeta, NodeState
    from volcano_tpu.ops.scores import default_weights
    from volcano_tpu.ops.unified import place_blocks_unified
    w = world
    packed, nodes = place_blocks_unified(
        None, NodeState(*(jnp.asarray(w[k]) for k in
                          ("idle", "future_idle", "used", "ntasks"))),
        jnp.asarray(w["req"]), jnp.asarray(w["valid"]),
        jnp.asarray(w["job_ix"]),
        JobMeta(*(jnp.asarray(w[k]) for k in
                  ("min_available", "base_ready", "base_pipelined"))),
        default_weights(w["req"].shape[1]), jnp.asarray(w["allocatable"]),
        jnp.asarray(w["max_tasks"]), chunk=w["chunk"], sweeps=w["sweeps"],
        passes=w["passes"],
        masked_static=None if w["ms"] is None else jnp.asarray(w["ms"]))
    return (np.asarray(packed), *(np.asarray(a) for a in nodes))


# ---------------------------------------------------------------------------
# the preempt walk's worlds: seeded WalkInputs in NumPy (no JAX), each with
# its tier structure and phase
# ---------------------------------------------------------------------------

WALK_BIG = 1 << 30


def walk_world(seed, N=12, W=4, R=2, PJ=4, tasks=(2, 6), kinds=("static",),
               sizes=(1,), gang=True, fidle_max=5, tight=False, total_extra=20):
    """Random walk inputs with the invariants the host guarantees: victims
    in node-major slots, small integer quantities, job allocations that
    cover each job's victims, one score row per same-request run (ties and
    infeasible nodes included). ``gang`` True is phase 1 (preemptors are
    jobs of their own, with a pipeline quota), False phase 2 (each
    preemptor job preempts its own running tasks)."""
    from volcano_tpu_torch.ops.evict import EvictNW, WalkInputs
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, W + 1, size=N)
    counts[rng.randint(N)] = W
    V = int(counts.sum())
    vnode = np.repeat(np.arange(N), counts)
    n_vjobs = max(PJ + 1, V // 3)
    vjob = rng.randint(0, n_vjobs, size=V)
    vreq = rng.randint(1, 5, size=(V, R)).astype(np.float32)
    vslot = np.full((N, W), V, np.int32)
    col = np.arange(V) - np.r_[0, np.cumsum(counts)[:-1]][vnode]
    vslot[vnode, col] = np.arange(V)
    valid = vslot < V
    rank = np.full((N, W), WALK_BIG, np.int32)
    rank[vnode, col] = rng.permutation(V)
    if gang:
        pgroups = n_vjobs + np.arange(PJ)
        AJ = n_vjobs + PJ
    else:
        pgroups = rng.choice(n_vjobs, size=PJ, replace=False)
        AJ = n_vjobs
    vgroup = np.full((N, W), AJ, np.int32)
    vgroup[vnode, col] = vjob
    jalloc0 = np.zeros((AJ + 1, R), np.float32)
    np.add.at(jalloc0, vjob, vreq)
    jalloc0[:AJ] += rng.randint(0, 4, size=(AJ, R))
    total = (jalloc0.sum(0) + rng.randint(5, total_extra + 5, R)).astype(
        np.float32)
    if gang:
        cand = rng.rand(PJ, V) < 0.8
    else:
        cand = vjob[None, :] == pgroups[:, None]
    cand_mask = np.pad(cand, ((0, 0), (0, 1)))
    M = int(sum(sizes))
    tier_masks = np.pad(rng.rand(M, PJ, V) < 0.7, ((0, 0), (0, 0), (0, 1)))
    tier_part = rng.rand(M, PJ) < 0.85
    preq, pjob, first, run_id, score_rows = [], [], [], [], []
    needed = np.zeros(AJ + 1, np.float32)
    for j in range(PJ):
        n_t = rng.randint(tasks[0], tasks[1] + 1)
        needed[pgroups[j]] = (WALK_BIG if not gang else
                              n_t if tight else rng.randint(0, n_t + 1))
        cuts = np.sort(rng.choice(np.arange(1, n_t), size=min(
            n_t - 1, rng.randint(0, 3)), replace=False)) if n_t > 1 else []
        bounds = [0, *cuts, n_t]
        for a, b in zip(bounds[:-1], bounds[1:]):
            req = rng.randint(1, 6, size=R).astype(np.float32)
            row = rng.randint(0, 10, size=N).astype(np.float32)
            row[rng.rand(N) < 0.15] = -np.inf
            score_rows.append(row)
            for k in range(a, b):
                preq.append(req)
                pjob.append(j)
                first.append(k == 0)
                run_id.append(len(score_rows) - 1)
    P = len(preq)
    pjob = np.asarray(pjob, np.int32)
    first = np.asarray(first, bool)
    run_id = np.asarray(run_id, np.int32)

    def ends(is_last):
        e = np.flatnonzero(is_last)
        return e[np.searchsorted(e, np.arange(P))].astype(np.int32)

    run_end = ends(np.r_[run_id[1:] != run_id[:-1], True])
    job_end = ends(np.r_[first[1:], True])
    inputs = WalkInputs(
        fidle0=rng.randint(0, fidle_max + 1, size=(N, R)).astype(np.float32),
        nw=EvictNW(vslot=vslot, valid=valid,
                   vreq=np.vstack([vreq, np.zeros((1, R), np.float32)])[vslot],
                   vgroup=vgroup, rank=rank),
        cand_mask=cand_mask, tier_masks=tier_masks, tier_part=tier_part,
        preq=np.asarray(preq, np.float32), pjob=pjob,
        pjg=pgroups.astype(np.int32)[pjob], first=first, run_id=run_id,
        run_end=run_end, job_end=job_end,
        score_g=np.asarray(score_rows, np.float32), needed=needed,
        jalloc0=jalloc0, total=total)
    return inputs, tuple(kinds), tuple(int(x) for x in sizes), gang


def two_dynamic_tiers_world():
    """tests/test_preempt_reclaim.py::
    test_walk_two_dynamic_tiers_accumulates_co_masks, input for input: two
    drf tiers, each with a static co-mask; only node 1 can serve the
    preemptor, though node 0 outscores it."""
    from volcano_tpu_torch.ops.evict import EvictNW, WalkInputs
    V = 3
    vslot = np.array([[0, 1], [2, V]], np.int32)
    inputs = WalkInputs(
        fidle0=np.zeros((2, 1), np.float32),
        nw=EvictNW(vslot=vslot, valid=vslot < V,
                   vreq=np.array([[[1.0], [4.0]], [[4.0], [0.0]]], np.float32),
                   vgroup=np.array([[1, 2], [3, 4]], np.int32),
                   rank=np.array([[0, 1], [2, WALK_BIG]], np.int32)),
        cand_mask=np.array([[True, True, True, False]]),
        tier_masks=np.array([[[True, False, True, False]],
                             [[True, True, True, False]]]),
        tier_part=np.ones((2, 1), bool),
        preq=np.array([[4.0]], np.float32), pjob=np.zeros(1, np.int32),
        pjg=np.zeros(1, np.int32), first=np.array([True]),
        run_id=np.zeros(1, np.int32), run_end=np.zeros(1, np.int32),
        job_end=np.zeros(1, np.int32),
        score_g=np.array([[10.0, 5.0]], np.float32),
        needed=np.array([WALK_BIG, 0, 0, 0, 0], np.float32),
        jalloc0=np.array([[0.0], [50.0], [50.0], [50.0], [0.0]], np.float32),
        total=np.array([100.0], np.float32))
    return inputs, ("drf", "drf"), (1, 1), False


def hand_walk(fidle, slots, jalloc, total, jobs, gang, cand=None,
              static=None, kinds=("static", "drf"), sizes=(1, 0)):
    """Walk inputs written out by hand. ``fidle`` [N][R]; ``slots[n]`` the
    victims on node n in row order, each (group, request); ``jalloc``
    [AJ][R] (a zeroed pad row is added); ``jobs`` the preemptor jobs in
    order, each (group, needed or None for BIG, runs) with runs [(tasks,
    request, score row)]. ``cand(job, group)`` says whether job j's tasks
    may evict a victim of ``group`` (default: another group's in phase 1,
    its own in phase 2); ``static(mask, job, group)`` gives each static
    mask's verdict and its participation (default: every victim, every
    plugin participating). A victim's rank is its index in node order."""
    from volcano_tpu_torch.ops.evict import EvictNW, WalkInputs
    N, R = len(fidle), len(total)
    W = max(len(s) for s in slots)
    V = sum(len(s) for s in slots)
    AJ = len(jalloc)
    vslot = np.full((N, W), V, np.int32)
    vgroup = np.full((N, W), AJ, np.int32)
    rank = np.full((N, W), WALK_BIG, np.int32)
    vreq_v = np.zeros((V + 1, R), np.float32)
    vgroup_v = np.full(V, AJ, np.int32)
    v = 0
    for n, node in enumerate(slots):
        for w, (grp, req) in enumerate(node):
            vslot[n, w], vgroup[n, w], rank[n, w] = v, grp, v
            vreq_v[v], vgroup_v[v] = req, grp
            v += 1
    if cand is None:
        def cand(j, grp):
            return (grp != jobs[j][0]) if gang else (grp == jobs[j][0])
    M = int(sum(sizes))
    PJ = len(jobs)
    cand_mask = np.zeros((PJ, V + 1), bool)
    tier_masks = np.zeros((M, PJ, V + 1), bool)
    tier_part = np.ones((M, PJ), bool)
    for j in range(PJ):
        for u in range(V):
            cand_mask[j, u] = cand(j, int(vgroup_v[u]))
            for k in range(M):
                tier_masks[k, j, u], tier_part[k, j] = (
                    (True, True) if static is None
                    else static(k, j, int(vgroup_v[u])))
    preq, pjob, pjg, first, run_id, rows = [], [], [], [], [], []
    needed = np.zeros(AJ + 1, np.float32)
    for j, (grp, need, runs) in enumerate(jobs):
        needed[grp] = WALK_BIG if need is None else need
        k = 0
        for count, req, row in runs:
            rows.append(np.asarray(row, np.float32))
            for _ in range(count):
                preq.append(req)
                pjob.append(j)
                pjg.append(grp)
                first.append(k == 0)
                run_id.append(len(rows) - 1)
                k += 1
    P = len(preq)
    first = np.asarray(first, bool)
    run_id = np.asarray(run_id, np.int32)

    def ends(is_last):
        e = np.flatnonzero(is_last)
        return e[np.searchsorted(e, np.arange(P))].astype(np.int32)

    inputs = WalkInputs(
        fidle0=np.asarray(fidle, np.float32),
        nw=EvictNW(vslot=vslot, valid=vslot < V, vreq=vreq_v[vslot],
                   vgroup=vgroup, rank=rank),
        cand_mask=cand_mask, tier_masks=tier_masks, tier_part=tier_part,
        preq=np.asarray(preq, np.float32), pjob=np.asarray(pjob, np.int32),
        pjg=np.asarray(pjg, np.int32), first=first, run_id=run_id,
        run_end=ends(np.r_[run_id[1:] != run_id[:-1], True]),
        job_end=ends(np.r_[first[1:], True]),
        score_g=np.asarray(rows, np.float32), needed=needed,
        jalloc0=np.vstack([np.asarray(jalloc, np.float32),
                           np.zeros((1, R), np.float32)]),
        total=np.asarray(total, np.float32))
    return inputs, tuple(kinds), tuple(sizes), gang


def _drf_decides(k, j, grp):
    """A static tier that never participates: drf rules every node."""
    return True, False


def drf_threshold_cross_world():
    """Phase 1 under drf alone (total 100, requests of 10, so the preemptor's
    share ls is 0.1, 0.2, ... task by task). Nodes 0-3 (score 9) each take
    one task without evicting; node 4 (score 5) holds a victim of share 0.4
    after the eviction, node 5 (score 1) one of share 0.7. Tasks 1-4 fill
    nodes 0-3 (node 4's victim kept up to ls = 0.4, equality included); at
    task 5 ls = 0.5 passes node 4's share in the middle of the job, which
    drops its victim: the task goes to node 5. A cache that kept node 4's
    verdict would take node 4."""
    high = [(2, [1.0])]
    slots = [high] * 4 + [[(1, [10.0])], high, [(2, [1.0])]]
    fidle = [[10.0]] * 4 + [[10.0], [20.0], [0.0]]
    scores = [9, 9, 9, 9, 5, 1, 0]
    return hand_walk(fidle, slots, jalloc=[[0.0], [50.0], [90.0]],
                     total=[100.0], jobs=[(0, 6, [(6, [10.0], scores)])],
                     gang=True, static=_drf_decides)


def group_stale_elsewhere_world():
    """Phase 1 under drf alone. Group 1 (allocation 45) has a victim of 10
    on node 0 (score 9) and on node 2 (score 5). Task 1 evicts it on node 0,
    which lowers the share of group 1's victim on node 2 from 0.35 to 0.25;
    task 2 (ls 0.2) takes node 1 (score 8); at task 3 (ls 0.3) node 2's
    victim is no longer kept, so the task goes to node 3 (score 1). Node 2
    was never picked: a cache that re-dispatched only picked nodes would
    still take it."""
    x = [(2, [1.0])]
    slots = [[(1, [10.0])], x, [(1, [10.0])], x]
    fidle = [[0.0], [10.0], [10.0], [20.0]]
    return hand_walk(fidle, slots, jalloc=[[0.0], [45.0], [90.0]],
                     total=[100.0],
                     jobs=[(0, 4, [(4, [10.0], [9, 8, 5, 1])])],
                     gang=True, static=_drf_decides)


def intra_ls_falls_world():
    """Phase 2 (no gang statement). Job group 0 (allocation 60) runs a task
    of 30 on node 0 (score 9), which a static tier makes eligible there;
    elsewhere that tier abstains and drf rules. Node 1 (score 5) holds a
    victim of group 1 at share 0.65. Task 1 (ls 0.7) cannot take node 1 and
    evicts its own task on node 0; the job's allocation falls to 40, so task
    2's ls falls to 0.5, node 1's victim is kept again and task 2 takes node
    1. A cache that assumed ls only rises would find no node and stop the
    job."""
    def static(k, j, grp):
        return grp == 0, True
    return hand_walk([[0.0], [10.0], [0.0]],
                     [[(0, [30.0])], [(1, [10.0])], [(1, [1.0])]],
                     jalloc=[[60.0], [75.0]], total=[100.0],
                     jobs=[(0, None, [(3, [10.0], [9, 5, 1])])], gang=False,
                     cand=lambda j, grp: True, static=static)


def rollback_after_lazy_save_world():
    """Phase 1 under drf alone. Job 1 (4 tasks, quota 4) evicts group 1's
    victim on nodes 0, 1 and 2 (scores 9, 8, 7), finds no node for its
    fourth task and misses its quota: its three nodes and both groups it
    changed (1, and its own) roll back. Job 2 (ls 0.6) then needs group 1's
    allocation restored (share 0.75 on node 0, not 0.45) and node 0's victim
    alive again: it evicts that victim. Nodes 3-5 hold victims too large to
    make room."""
    v1 = [(1, [10.0])]
    big = [(3, [1.0])]
    return hand_walk([[0.0]] * 6, [v1, v1, v1, big, big, big],
                     jalloc=[[0.0], [85.0], [50.0], [90.0]], total=[100.0],
                     jobs=[(0, 4, [(4, [10.0], [9, 8, 7, 6, 5, 4])]),
                           (2, 1, [(1, [10.0], [9, 8, 7, 6, 5, 4])])],
                     gang=True, static=_drf_decides)


def rollback_quota_3_world():
    """rollback-after-lazy-save with job 1's quota lowered to 3: the job
    commits its three evictions on nodes 0, 1 and 2, the nodes the rollback
    restores there."""
    inputs, kinds, sizes, gang = rollback_after_lazy_save_world()
    needed = inputs.needed.copy()
    needed[0] = 3
    return inputs._replace(needed=needed), kinds, sizes, gang


def ties_across_warps_world():
    """65 nodes (node 64 needs them); nodes 31, 32, 63 and 64 tie at the top
    score and each fits one task after evicting its victim; the other nodes
    score lower or do not fit. Four tasks take 31, 32, 63 and 64 in that
    order: the lowest index wins each tie, across 32-node groups (each a
    warp's in the kernel)."""
    N = 65
    slots = [[(1, [5.0])] for _ in range(N)]
    fidle = [[0.0] for _ in range(N)]
    scores = [3.0] * N
    for n in (31, 32, 63, 64):
        slots[n] = [(1, [10.0])]
        scores[n] = 7.0
    for n in (0, 30, 33, 62):
        scores[n] = 7.0            # tie too, but 5 + 0 cannot hold 10
    return hand_walk(fidle, slots, jalloc=[[0.0], [400.0]], total=[1000.0],
                     jobs=[(0, 4, [(5, [10.0], scores)])], gang=True,
                     kinds=("static",), sizes=(1,))


def tier_veto_world(kinds=("static", "drf"), sizes=(2, 0)):
    """One node, one victim (group 1, 3 CPU, its job at 8 of 10 CPU) and
    one preemptor task (2 CPU, its job at 0): drf keeps the victim (share
    0.5 against 0.2). Under the default kinds the first tier's first mask
    offers the victim and its second refuses it: upstream's dispatch stops
    there and nothing is placed, where the JAX package's own would let
    drf's tier evict it. ``("drf@0", "static")``, sizes (1, 1): drf leads
    the first tier and its one mask refuses, so nothing is placed;
    ``("drf", "static")`` puts that mask first, its veto leaves the second
    tier to rule, and the task is placed on node 0."""
    first_tier = sizes[0]

    def static(k, j, grp):
        if kinds[0] == "static":
            return k == 0, True
        return k >= first_tier, True
    return hand_walk(fidle=[[0.0]], slots=[[(1, [3.0])]],
                     jalloc=[[0.0], [8.0]], total=[10.0],
                     jobs=[(0, 1, [(1, [2.0], [1.0])])], gang=True,
                     static=static, kinds=kinds, sizes=sizes)


WALK_WORLDS = {
    # phase 1, static tiers only, every gang needs all its tasks: rollbacks
    "gang-rollback": lambda: walk_world(1, N=10, W=3, PJ=5, tasks=(2, 5),
                                        kinds=("static",), sizes=(2,),
                                        tight=True, fidle_max=3),
    # phase 2: each job preempts its own tasks, stops at its first failure
    "intra-job": lambda: walk_world(2, N=10, W=4, PJ=3, tasks=(3, 7),
                                    kinds=("static", "drf"), sizes=(1, 0),
                                    gang=False, fidle_max=2),
    # phase 1 under the deployed tiers: priority/gang, then drf
    "drf": lambda: walk_world(3, N=14, W=5, PJ=5, tasks=(2, 6),
                              kinds=("static", "drf"), sizes=(1, 0),
                              fidle_max=3, total_extra=4),
    "drf-co-mask": lambda: walk_world(4, N=14, W=5, PJ=5, tasks=(2, 6),
                                      kinds=("static", "drf"), sizes=(1, 1),
                                      fidle_max=3, total_extra=6),
    "two-dynamic-tiers": two_dynamic_tiers_world,
    "two-dynamic-random": lambda: walk_world(5, N=10, W=4, PJ=3,
                                             kinds=("drf", "drf"),
                                             sizes=(1, 1), gang=False,
                                             fidle_max=2, total_extra=4),
    "w64": lambda: walk_world(6, N=4, W=64, PJ=4, tasks=(4, 12),
                              kinds=("static", "drf"), sizes=(1, 0),
                              fidle_max=2, total_extra=40),
    "w60-static": lambda: walk_world(7, N=5, W=60, PJ=3, tasks=(4, 10),
                                     kinds=("static",), sizes=(2,)),
    # no victim set covers any request: nothing is placed or evicted
    "no-fit": lambda: walk_world(8, N=6, W=3, PJ=3, R=3, fidle_max=0,
                                 kinds=("static",), sizes=(1,)) ,
    **{f"random-{s}": (lambda s=s: walk_world(
        100 + s, N=9, W=4, PJ=4, kinds=("static", "drf"), sizes=(1, 1),
        gang=bool(s % 2), fidle_max=3)) for s in range(2)},
    # a first tier of two masks before drf's: a veto after the first
    # mask's victims leaves the node with none (upstream's dispatch)
    "tier-veto": lambda: walk_world(11, N=10, W=3, PJ=4, tasks=(2, 5),
                                    kinds=("static", "drf"), sizes=(2, 0),
                                    fidle_max=3, total_extra=6),
    "tier-veto-hand": tier_veto_world,
}


def _no_fit(world):
    inputs, kinds, sizes, gang = world
    return inputs._replace(preq=inputs.preq + 1000.0), kinds, sizes, gang


WALK_WORLDS["no-fit"] = (lambda f=WALK_WORLDS["no-fit"]: _no_fit(f()))
# hand-built worlds that break a wrong verdict cache (csrc/evict.cu)
WALK_WORLDS.update({
    "drf-threshold-cross": drf_threshold_cross_world,
    "group-stale-elsewhere": group_stale_elsewhere_world,
    "intra-ls-falls": intra_ls_falls_world,
    "rollback-after-lazy-save": rollback_after_lazy_save_world,
    "rollback-after-lazy-save-quota-3": rollback_quota_3_world,
    "ties-across-warps": ties_across_warps_world,
})

# walk worlds whose tier kinds only the port's walk takes (drf ahead of a
# static mask in its tier), held to walk_plain on the card and to their
# derived outcomes on the CPU
PORT_WALK_WORLDS = {
    "drf-leads": lambda: tier_veto_world(("drf@0", "static"), (1, 1)),
    "drf-follows": lambda: tier_veto_world(("drf", "static"), (1, 1)),
}

# walk worlds for the card only (walk_plain is too slow for them on the CPU):
# more nodes than the kernel's 512 threads; W = 64 at 400 nodes, whose
# victim tables do not fit shared memory; 8,192 nodes, whose node state and
# group allocations do not either
CARD_WALK_WORLDS = {
    "n2500": lambda: walk_world(21, N=2500, W=6, PJ=40, tasks=(10, 40),
                                kinds=("static", "drf"), sizes=(1, 0),
                                fidle_max=3, total_extra=400),
    "w64-n400": lambda: walk_world(22, N=400, W=64, PJ=12, tasks=(8, 30),
                                   kinds=("static", "drf"), sizes=(1, 1),
                                   fidle_max=2, total_extra=400),
    "n8192": lambda: walk_world(23, N=8192, W=8, PJ=20, tasks=(10, 30),
                                kinds=("static", "drf"), sizes=(1, 0),
                                fidle_max=3, total_extra=1200),
}


def fill_rank_shrink_world():
    """Phase 1 under drf alone, one node (total 192 cpu, future idle 1).
    The preemptor gang (allocation 4, two tasks of 2, quota 2) may evict
    two victims of group 1 (allocation 12, 3 each); the victim in row 0
    comes AFTER the one in row 1 in the candidate list (ranks 1 and 0).
    Task 1 (share 6/192) keeps both (shares 6/192, tied, and 9/192) and
    evicts row 0. That eviction lowers row 1's share to 6/192, and task 2
    (share 8/192) drops it: no victim is eligible, the gang misses its
    quota and rolls back. The JAX walk's closed-form fill keeps row 1's
    share from the start of the fill and places both tasks (ROADMAP §3)."""
    inputs, kinds, sizes, gang = hand_walk(
        fidle=[[1.0]], slots=[[(1, [3.0]), (1, [3.0])]],
        jalloc=[[4.0], [12.0]], total=[192.0],
        jobs=[(0, 2, [(2, [2.0], [1.0])])], gang=True,
        kinds=("drf",), sizes=(0,))
    rank = np.array([[1, 0]], np.int32)
    return (inputs._replace(nw=inputs.nw._replace(rank=rank)), kinds, sizes,
            gang)


# walk worlds on which the JAX walk's two modes disagree (a fault of the
# reference): held by tests/test_torch_sim.py, not by the walk parity tests
FAULT_WALK_WORLDS = {"fill-rank-shrink": fill_rank_shrink_world}


def jax_walk(world, exact: bool = False):
    """build_preempt_walk on a walk world: (task_node, owner, job_done) as
    NumPy arrays. allow_cheap follows the JAX host's rule, unless
    ``exact`` asks for the per-task formulation (allow_cheap=False)."""
    import jax.numpy as jnp

    from volcano_tpu.ops.evict import EvictNW, build_preempt_walk
    inputs, kinds, sizes, gang = world
    allow_cheap = (all(k == "static" for k in kinds[:-1])
                   and (gang or "drf" not in kinds)) and not exact
    masks, off = [], 0
    for size in sizes:
        masks.append((jnp.asarray(inputs.tier_masks[off:off + size]),
                      jnp.asarray(inputs.tier_part[off:off + size])))
        off += size
    nw = EvictNW(*(jnp.asarray(a) for a in inputs.nw))
    fn = build_preempt_walk(kinds, sizes, gang, allow_cheap)
    a = jnp.asarray
    task_node, owner, job_done, _ = fn(
        a(inputs.fidle0), nw, a(inputs.cand_mask), tuple(masks),
        a(inputs.preq), a(inputs.pjob), a(inputs.pjg), a(inputs.first),
        a(inputs.run_id), a(inputs.run_end), a(inputs.job_end),
        a(inputs.score_g), a(inputs.needed), a(inputs.jalloc0),
        a(inputs.total))
    return (np.asarray(task_node), np.asarray(owner),
            np.asarray(job_done))


# ---------------------------------------------------------------------------
# preempt and reclaim worlds (tests/test_preempt_reclaim.py's), and the
# deployed cycle's
# ---------------------------------------------------------------------------

def _evict_job(name, queue, min_avail, tasks, priority=0):
    """tests/test_preempt_reclaim.py::build_job: tasks are (cpu, mem,
    status, node or None)."""
    from volcano_tpu.api import (JobInfo, PodGroup, PodGroupPhase, Resource,
                                 TaskInfo)
    pg = PodGroup(name=name, queue=queue, min_member=min_avail,
                  phase=PodGroupPhase.INQUEUE)
    job = JobInfo(uid=name, name=name, queue=queue, min_available=min_avail,
                  podgroup=pg, priority=priority)
    for i, (cpu, mem, status, node) in enumerate(tasks):
        job.add_task_info(TaskInfo(uid=f"{name}-{i}", name=f"{name}-{i}",
                                   job=name, resreq=Resource(cpu, mem),
                                   status=status, creation_timestamp=float(i)))
        job.tasks[f"{name}-{i}"]._target_node = node
    return job


def _evict_wire(jobs, nodes, queues):
    cache = _jax_cache(nodes, [], queues)
    node_map = {n.name: n for n in nodes}
    for j in jobs:
        cache.add_job(j)
        for t in j.tasks.values():
            if t._target_node:
                node_map[t._target_node].add_task(t)
    return cache


def _random_preempt_world(seed):
    """tests/test_preempt_reclaim.py::_random_preempt_world: running
    low-priority fillers and starving high-priority gangs on 6 nodes."""
    from volcano_tpu.api import NodeInfo, QueueInfo, Resource, TaskStatus
    rng = np.random.RandomState(seed)
    nodes = [NodeInfo(name=f"n{i}", allocatable=Resource(8000, 8000))
             for i in range(6)]
    jobs = []
    perm = rng.permutation(6)
    for i in range(6):
        node = f"n{perm[i]}"
        jobs.append(_evict_job(
            f"run{i}", "default", 1,
            [(2000, 2000, TaskStatus.RUNNING, node) for _ in range(2)],
            priority=int(rng.randint(1, 4))))
    for i in range(4):
        jobs.append(_evict_job(
            f"hot{i}", "default", 2,
            [(3000, 3000, TaskStatus.PENDING, None) for _ in range(2)],
            priority=int(rng.randint(5, 9))))
    return _evict_wire(jobs, nodes, [QueueInfo(name="default", weight=1)])


def _reclaim_world(reclaimable=True):
    """TestReclaim's worlds: q2 holds the whole node, q1's pending job
    reclaims (or, with q2 unreclaimable, cannot)."""
    from volcano_tpu.api import NodeInfo, QueueInfo, Resource, TaskStatus
    hog = _evict_job("hog", "q2", 1, [(4000, 4000, TaskStatus.RUNNING, "n1")])
    needy = _evict_job("needy", "q1", 1,
                       [(3000, 3000, TaskStatus.PENDING, None)])
    return _evict_wire([hog, needy],
                       [NodeInfo(name="n1", allocatable=Resource(4000, 4000))],
                       [QueueInfo(name="q1", weight=1),
                        QueueInfo(name="q2", weight=1,
                                  reclaimable=reclaimable)])


def _reclaim_parity_world():
    """test_reclaim_engine_parity's world: q2 hogs 4 nodes, q1 has 3
    pending reclaimers."""
    from volcano_tpu.api import NodeInfo, QueueInfo, Resource, TaskStatus
    nodes = [NodeInfo(name=f"n{i}", allocatable=Resource(8000, 8000))
             for i in range(4)]
    jobs = [_evict_job(f"hog{i}", "q2", 1,
                       [(3000, 3000, TaskStatus.RUNNING, f"n{i}")] * 2)
            for i in range(4)]
    jobs += [_evict_job(f"needy{i}", "q1", 1,
                        [(3000, 3000, TaskStatus.PENDING, None)])
             for i in range(3)]
    return _evict_wire(jobs, nodes, [QueueInfo(name="q1", weight=1),
                                     QueueInfo(name="q2", weight=1)])


def _preempt_mix(seed):
    from volcano_tpu.cache.synthetic import preempt_mix_cache
    return preempt_mix_cache(seed=seed)[0]


def intra_variant(cache):
    """A preempt world where every fourth running gang has lost the last
    third of its tasks back to Pending: those gangs starve while holding
    running tasks, so preempt's intra-job phase has work. Works on either
    package's cache."""
    for k, job in enumerate(cache.jobs.values()):
        if job.podgroup.phase.value != "Running" or k % 4:
            continue
        running = [t for t in job.tasks.values() if int(t.status) == 6]
        for t in running[-max(1, len(running) // 3):]:
            cache.nodes[t.node_name].remove_task(t)
            job.update_task_status(t, type(t.status)(1))      # Pending
    return cache


def taint_variant(cache):
    """A PreferNoSchedule taint on every tenth node: nodeorder's static
    score matrix joins the walk's scores (the f32 score path)."""
    taint = {"key": "dedicated", "value": "batch",
             "effect": "PreferNoSchedule"}
    for i, node in enumerate(cache.nodes.values()):
        if i % 10 == 3:
            node.taints = [taint]
    return cache


def ports_variant(cache):
    """Every third gang claims host port 8080, running or pending:
    predicates turns stateful, so preempt replays through Statements with
    the live predicate chain."""
    for k, job in enumerate(cache.jobs.values()):
        if k % 3:
            continue
        for task in job.tasks.values():
            if task.node_name:
                node = cache.nodes[task.node_name]
                node.remove_task(task)
                task.host_ports = [("0.0.0.0", "TCP", 8080)]
                node.add_task(task)
            else:
                task.host_ports = [("0.0.0.0", "TCP", 8080)]
    return cache


def _pipeline_tenth():
    """bench.py's pipeline world at a tenth: 200 nodes, 1,000 pods in 20
    gangs over 3 queues, half the gangs running."""
    from volcano_tpu.cache.synthetic import make_cluster, make_jobs
    nodes = make_cluster(200)
    jobs = make_jobs(1000, 20, ["q1", "q2", "q3"], running_fraction=0.5,
                     nodes=nodes, seed=0)
    return _jax_cache(nodes, jobs, _queues(3, 2, 1))


# name -> (world builder, the action to run alone under the deployed tiers)
EVICT_WORLDS = {
    **{f"random-preempt-{s}": (lambda s=s: _random_preempt_world(s),
                               "preempt") for s in range(4)},
    "reclaim-starved": (_reclaim_world, "reclaim"),
    "reclaim-protected": (lambda: _reclaim_world(False), "reclaim"),
    "reclaim-parity": (_reclaim_parity_world, "reclaim"),
    "preempt-small": (lambda: _baseline("preempt-small"), "preempt"),
    "preempt-mix-3": (lambda: _preempt_mix(3), "preempt"),
    "preempt-small-intra": (lambda: intra_variant(_baseline("preempt-small")),
                            "preempt"),
    "preempt-small-taints": (lambda: taint_variant(_baseline("preempt-small")),
                             "preempt"),
    "preempt-small-ports": (lambda: ports_variant(_baseline("preempt-small")),
                            "preempt"),
}

# worlds of one deployed cycle (deploy/scheduler.conf as written)
DEPLOYED_WORLDS = {
    "pipeline-tenth": _pipeline_tenth,
    "preempt-small": lambda: _baseline("preempt-small"),
    "three-queue": _three_queue,
}


def evict_outcome(ssn, cache) -> dict:
    """What preempt or reclaim decided: evictions and pipelined tasks."""
    return {"evicts": sorted(cache.evictor.evicts),
            "pipelined": sorted(t.uid for j in ssn.jobs.values()
                                for t in j.tasks.values()
                                if int(t.status) == 3)}


def run_jax_action(cache, action):
    """One preempt or reclaim action, engine tpu, alone in a session with
    the deployed conf's tiers, through the JAX package."""
    import volcano_tpu.plugins  # noqa: F401
    from volcano_tpu.actions import PreemptAction, ReclaimAction
    from volcano_tpu.framework import open_session, parse_scheduler_conf
    conf = parse_scheduler_conf(DEPLOYED_CONF)
    ssn = open_session(cache, conf.tiers, conf.configurations)
    cls = PreemptAction if action == "preempt" else ReclaimAction
    cls(engine="tpu").execute(ssn)
    return ssn


def run_torch_action(cache, action):
    """The same action through the port on the CPU."""
    import volcano_tpu_torch.plugins  # noqa: F401
    from volcano_tpu_torch.actions import PreemptAction, ReclaimAction
    from volcano_tpu_torch.framework import open_session, parse_scheduler_conf
    conf = parse_scheduler_conf(DEPLOYED_CONF)
    ssn = open_session(cache, conf.tiers, conf.configurations, device="cpu")
    cls = PreemptAction if action == "preempt" else ReclaimAction
    cls(engine="tpu").execute(ssn)
    return ssn


def _tight_mix():
    """The running+pending preempt mix on 40 nodes: allocate cannot place
    every pending gang, so preempt and reclaim act in the deployed cycle."""
    from volcano_tpu.cache.synthetic import preempt_mix_cache
    return preempt_mix_cache(n_nodes=40, n_tasks=1000, n_jobs=40, seed=2)[0]


def _predicates_world():
    """What predicates filters: NoSchedule taints tolerated by some gangs,
    node selectors and required node affinity, an unschedulable node, and
    gangs claiming host port 8080 (one per node: the stateful re-check and
    the re-solve rounds)."""
    from volcano_tpu.cache.synthetic import make_jobs
    taint = {"key": "gpu", "value": "true", "effect": "NoSchedule"}
    nodes = _nodes(24, labels=lambda i: {"zone": "a" if i % 3 == 0 else "b",
                                         "disk": "ssd" if i % 2 else "hdd"},
                   taints=lambda i: [taint] if i % 4 == 1 else [])
    nodes[5].unschedulable = True
    jobs = make_jobs(240, 12, ["q1", "q2"], seed=6)
    required = {"nodeAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": {
            "nodeSelectorTerms": [{"matchExpressions": [
                {"key": "zone", "operator": "In", "values": ["a"]}]}]}}}
    for j, job in enumerate(jobs):
        for task in job.tasks.values():
            if j % 3 == 0:
                task.node_selector = {"disk": "ssd"}
            if j % 4 == 0:
                task.tolerations = [{"key": "gpu", "operator": "Exists",
                                     "effect": "NoSchedule"}]
            if j % 5 == 1:
                task.host_ports = [("0.0.0.0", "TCP", 8080)]
            if j == 7:
                task.affinity = required
    return _jax_cache(nodes, jobs, _queues(1, 1))


def _affinity_world():
    """Pod affinity on the solve: 48 nodes in 4 zones, 480 pods in 16
    gangs labelled with their job; gang j by j % 4 spreads one pod a node
    (required anti-affinity to itself on hostname), keeps to one zone
    (required affinity to itself on zone), prefers its zone (preferred
    affinity, weight 100) or carries none. The stateful re-check and the
    re-solve rounds are on the path."""
    from volcano_tpu.cache.synthetic import make_jobs
    nodes = _nodes(48, labels=lambda i: {PA_HOST: f"node-{i:05d}",
                                         PA_ZONE: f"zone-{i % 4}"})

    def affinity(j):
        term = {"labelSelector": {"matchLabels": {"app": f"job-{j:05d}"}},
                "topologyKey": PA_HOST if j % 4 == 0 else PA_ZONE}
        if j % 4 == 2:
            return {"podAffinity": {PA_PREFERRED: [
                {"weight": 100, "podAffinityTerm": term}]}}
        if j % 4 == 3:
            return {}
        kind = ("podAntiAffinity", "podAffinity")[j % 4]
        return {kind: {PA_REQUIRED: [term]}}

    jobs = _labelled_tasks(make_jobs(480, 16, ["q1", "q2"], seed=9),
                           labels=lambda j: {"app": f"job-{j:05d}"},
                           affinity=affinity)
    return _jax_cache(nodes, jobs, _queues(1, 1))


DEPLOYED_WORLDS.update({"tight-mix": _tight_mix,
                        "predicates": _predicates_world,
                        "affinity": lambda: _affinity_world()})

# ---------------------------------------------------------------------------
# plugin cases: drf (hierarchy, namespace order), proportion's deserved
# shares, predicates' mask
# ---------------------------------------------------------------------------

HDRF_CONF = """
actions: "allocate-tpu"
tiers:
- plugins:
  - name: drf
    enableHierarchy: true
  - name: gang
configurations:
- name: allocate-tpu
  arguments:
    engine: tpu-fused
"""

NAMESPACE_CONF = """
actions: "enqueue, allocate-tpu, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
    enableNamespaceOrder: true
  - name: proportion
  - name: nodeorder
configurations:
- name: allocate-tpu
  arguments:
    engine: tpu-fused
"""

_G = 1_000_000_000        # hdrf_test.go's decimal giga


def _hdrf_world(queues, jobs, node_res):
    """tests/test_hdrf.py::run_case's world: one node, hierarchical queues,
    jobs of min 1 whose tasks share one request."""
    from volcano_tpu.api import (JobInfo, NodeInfo, PodGroup, PodGroupPhase,
                                 QueueInfo, Resource, TaskInfo)
    from volcano_tpu.api.queue_info import (
        KUBE_HIERARCHY_ANNOTATION_KEY, KUBE_HIERARCHY_WEIGHT_ANNOTATION_KEY)
    qs = [QueueInfo(name=n, weight=1, annotations={
        KUBE_HIERARCHY_ANNOTATION_KEY: h,
        KUBE_HIERARCHY_WEIGHT_ANNOTATION_KEY: w}) for n, h, w in queues]
    js = []
    for pg, queue, num, cpu, mem in jobs:
        job = JobInfo(uid=pg, name=pg, queue=queue, min_available=1,
                      podgroup=PodGroup(name=pg, queue=queue, min_member=1,
                                        phase=PodGroupPhase.INQUEUE))
        for i in range(num):
            job.add_task_info(TaskInfo(uid=f"{pg}-p{i}", name=f"{pg}-p{i}",
                                       job=pg, resreq=Resource(cpu, mem),
                                       creation_timestamp=float(i)))
        js.append(job)
    alloc = Resource(*node_res)
    alloc.max_task_num = 1000
    return _jax_cache([NodeInfo(name="n", allocatable=alloc)], js, qs)


def _hdrf_rescaling():
    return _hdrf_world(
        [("root-sci", "root/sci", "100/50"),
         ("root-eng-dev", "root/eng/dev", "100/50/50"),
         ("root-eng-prod", "root/eng/prod", "100/50/50")],
        [("pg1", "root-sci", 10, 1000, 1 * _G),
         ("pg21", "root-eng-dev", 10, 1000, 0),
         ("pg22", "root-eng-prod", 10, 0, 1 * _G)], (10_000, 10 * _G))


def _hdrf_blocking():
    return _hdrf_world(
        [("root-pg1", "root/pg1", "100/25"), ("root-pg2", "root/pg2", "100/25"),
         ("root-pg3-pg31", "root/pg3/pg31", "100/25/50"),
         ("root-pg3-pg32", "root/pg3/pg32", "100/25/50"),
         ("root-pg4", "root/pg4", "100/25")],
        [("pg1", "root-pg1", 30, 1000, 0), ("pg2", "root-pg2", 30, 1000, 0),
         ("pg31", "root-pg3-pg31", 30, 1000, 0),
         ("pg32", "root-pg3-pg32", 30, 0, 1 * _G),
         ("pg4", "root-pg4", 30, 0, 1 * _G)], (30_000, 30 * _G))


def _namespaces():
    """Jobs of two namespaces over two queues on a tight cluster: drf's
    namespace order decides which namespace's gangs go first."""
    from volcano_tpu.cache.synthetic import make_jobs
    jobs = make_jobs(400, 20, ["q1", "q2"], seed=8)
    for j, job in enumerate(jobs):
        ns = "ns-a" if j % 3 else "ns-b"
        job.namespace = ns
        job.podgroup.namespace = ns
        for task in job.tasks.values():
            task.namespace = ns
    return _jax_cache(_nodes(16), jobs, _queues(2, 1))


# name -> (world builder, conf text) for one cycle in both packages
PLUGIN_WORLDS = {
    "hdrf-rescaling": (_hdrf_rescaling, HDRF_CONF),
    "hdrf-blocking": (_hdrf_blocking, HDRF_CONF),
    "drf-namespaces": (_namespaces, NAMESPACE_CONF),
}


def proportion_inputs(Q, seed):
    """Seeded water-filling inputs: total f32[R], weight f32[Q],
    request/capability/allocated f32[Q,R] (capability +inf where
    unlimited)."""
    rng = np.random.RandomState(seed)
    R = 3
    total = rng.randint(1000, 5000, size=R).astype(np.float32) * 10
    weight = rng.randint(1, 6, size=Q).astype(np.float32)
    request = (rng.rand(Q, R) * total / Q * 3).astype(np.float32)
    cap = np.where(rng.rand(Q, R) < 0.3,
                   (rng.rand(Q, R) * total / Q * 2).astype(np.float32),
                   np.float32(np.inf)).astype(np.float32)
    allocated = (request * rng.rand(Q, R)).astype(np.float32)
    return total, weight, request, cap, allocated


def _proportion_case(Q, seed):
    import jax.numpy as jnp

    from volcano_tpu.ops.fairness import (proportion_deserved,
                                          proportion_deserved_numpy)
    args = proportion_inputs(Q, seed)
    num = proportion_deserved_numpy(*args)
    dev = proportion_deserved(*(jnp.asarray(a) for a in args))
    return {"numpy": (np.asarray(num.deserved), np.asarray(num.share)),
            "jax": (np.asarray(dev.deserved), np.asarray(dev.share))}


def _predicates_mask():
    """predicates' feasibility mask over every pending task of the
    predicates world, under the deployed tiers."""
    import volcano_tpu.plugins  # noqa: F401
    from volcano_tpu.api import TaskStatus
    from volcano_tpu.cache.snapshot import (NodeTensors,
                                            discover_resource_names)
    from volcano_tpu.framework import (close_session, open_session,
                                       parse_scheduler_conf)
    cache = _predicates_world()
    world = world_from_cache(cache)
    conf = parse_scheduler_conf(DEPLOYED_CONF)
    ssn = open_session(cache, conf.tiers, conf.configurations)
    tasks = [t for j in ssn.jobs.values() for t in j.tasks.values()
             if t.status == TaskStatus.PENDING]
    nodes = list(ssn.nodes.values())
    node_t = NodeTensors(nodes, discover_resource_names(nodes, tasks))
    mask = ssn.plugins["predicates"].feasibility_mask(ssn, tasks, node_t)
    stateful = sorted(ssn.stateful_predicates)
    close_session(ssn)
    return world, [t.uid for t in tasks], mask, stateful


PLUGIN_CASES = {
    **{name: (lambda b=b, c=c: (lambda cache: (world_from_cache(cache),
                                               outcome(run_jax_cycle(cache, c),
                                                       cache)))(b()))
       for name, (b, c) in PLUGIN_WORLDS.items()},
    "proportion-3": lambda: _proportion_case(3, 0),
    "proportion-64": lambda: _proportion_case(64, 1),
    "proportion-96": lambda: _proportion_case(96, 2),
    "predicates-mask": _predicates_mask,
}


# ---------------------------------------------------------------------------
# the allocate engines: tests/test_allocate_action.py's worlds, each run by
# one AllocateAction(engine=...) under that file's tiers (or the default
# conf), in either package
# ---------------------------------------------------------------------------

ENGINES = ("callbacks", "tpu-strict", "tpu-strict-perjob", "tpu-blocks")

# tests/test_allocate_action.py::default_tiers
ENGINE_CONF = """
actions: "allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""


def _engine_job(name, queue, min_avail, reqs, priority=0, phase="Inqueue"):
    """tests/test_allocate_action.py::build_job."""
    from volcano_tpu.api import (JobInfo, PodGroup, PodGroupPhase, Resource,
                                 TaskInfo)
    pg = PodGroup(name=name, namespace="default", queue=queue,
                  min_member=min_avail, phase=PodGroupPhase(phase))
    job = JobInfo(uid=name, name=name, namespace="default", queue=queue,
                  min_available=min_avail, podgroup=pg, priority=priority)
    for i, (cpu, mem) in enumerate(reqs):
        job.add_task_info(TaskInfo(uid=f"{name}-{i}", name=f"{name}-{i}",
                                   namespace="default", job=name,
                                   resreq=Resource(cpu, mem),
                                   creation_timestamp=float(i)))
    return job


def _engine_node(name, cpu, mem, pods=100):
    from volcano_tpu.api import NodeInfo, Resource
    alloc = Resource(cpu, mem)
    alloc.max_task_num = pods
    return NodeInfo(name=name, allocatable=alloc)


def _engine_case(case):
    """The worlds of tests/test_allocate_action.py::TestAllocate and
    TestEngineParity.test_random_fixture_parity."""
    import random
    from volcano_tpu.api import QueueInfo
    J, N = _engine_job, _engine_node
    queues = [QueueInfo(name="default", weight=1)]
    if case == "gang-fits":
        jobs = [J("j1", "default", 3, [(1000, 1000)] * 3)]
        nodes = [N("n1", 2000, 2000), N("n2", 1000, 1000)]
    elif case == "gang-unsatisfiable":
        jobs = [J("j1", "default", 3, [(1000, 1000)] * 3)]
        nodes = [N("n1", 2000, 2000)]
    elif case == "pending-podgroup":
        jobs = [J("j1", "default", 1, [(100, 100)], phase="Pending")]
        nodes = [N("n1", 1000, 1000)]
    elif case == "discard-frees":
        jobs = [J("a-big", "default", 2, [(800, 800)] * 2, priority=10),
                J("b-small", "default", 1, [(800, 800)])]
        nodes = [N("n1", 1000, 1000)]
    elif case == "priority-order":
        jobs = [J("low", "default", 1, [(800, 800)], priority=1),
                J("high", "default", 1, [(800, 800)], priority=10)]
        nodes = [N("n1", 1000, 1000)]
    elif case == "best-effort":
        jobs = [J("j1", "default", 1, [(0, 0)])]
        nodes = [N("n1", 1000, 1000)]
    elif case == "node-selector":
        jobs = [J("j1", "default", 1, [(100, 100)])]
        for t in jobs[0].tasks.values():
            t.node_selector = {"zone": "a"}
        nodes = [N("n1", 1000, 1000), N("n2", 1000, 1000)]
        nodes[1].labels["zone"] = "a"
    elif case == "taint":
        jobs = [J("j1", "default", 1, [(100, 100)])]
        nodes = [N("n1", 1000, 1000), N("n2", 1000, 1000)]
        nodes[0].taints = [{"key": "dedicated", "value": "x",
                            "effect": "NoSchedule"}]
    elif case == "queue-weights":
        queues = _queues(3, 1)
        jobs = []
        for i in range(4):
            jobs.append(J(f"a{i}", "q1", 1, [(1000, 1000)]))
            jobs.append(J(f"b{i}", "q2", 1, [(1000, 1000)]))
        nodes = [N("n1", 4000, 4000)]
    else:                                   # "random-fixture"
        rng = random.Random(7)
        nodes = [N(f"n{i}", rng.choice([2000, 4000, 8000]),
                   rng.choice([4000, 8000, 16000])) for i in range(8)]
        jobs = []
        for j in range(12):
            k = rng.randint(1, 4)
            reqs = [(rng.choice([500, 1000, 2000]),
                     rng.choice([500, 1000, 2000]))] * k
            jobs.append(J(f"job{j}", "default", k, reqs,
                          priority=rng.randint(0, 5)))
    return _jax_cache(nodes, jobs, queues)


def _strict_multiqueue():
    """tests/test_allocate_action.py::test_strict_batched_multiqueue_parity's
    world: 300 pods in 30 gangs over 3 queues (3:2:1) on 40 nodes."""
    from volcano_tpu.cache.synthetic import make_cluster, make_jobs
    return _jax_cache(make_cluster(40, seed=7),
                      make_jobs(300, 30, ["q1", "q2", "q3"], seed=7),
                      _queues(3, 2, 1))


def _strict_adaptive():
    """test_strict_adaptive_batching_fewer_solves' world: 60 jobs of two
    (100, 100) tasks on eight 4,000/4,000 nodes."""
    from volcano_tpu.api import QueueInfo
    jobs = [_engine_job(f"j{i:02d}", "default", 1, [(100, 100)] * 2)
            for i in range(60)]
    return _jax_cache([_engine_node(f"n{i}", 4000, 4000) for i in range(8)],
                      jobs, [QueueInfo(name="default", weight=1)])


ENGINE_CASES = ("gang-fits", "gang-unsatisfiable", "pending-podgroup",
                "discard-frees", "priority-order", "best-effort",
                "node-selector", "taint", "queue-weights", "random-fixture")

# name -> (world builder, conf text or None for the default conf, the
# allocate action's arguments)
ENGINE_WORLDS = {
    **{c: ((lambda c=c: _engine_case(c)), ENGINE_CONF, {})
       for c in ENGINE_CASES},
    "1k-seed3": (lambda: _baseline_seed("1k", 3), None, {}),
    "strict-multiqueue": (_strict_multiqueue, None, {}),
    "strict-multiqueue-batch3": (_strict_multiqueue, None,
                                 {"strict-batch": 3}),
    "strict-adaptive": (_strict_adaptive, ENGINE_CONF, {"strict-batch": 4}),
}


def _baseline_seed(name, seed):
    from volcano_tpu.cache.synthetic import baseline_config
    return baseline_config(name, seed=seed)[0]


def run_allocate(cache, engine, conf_text, arguments, torch_port):
    """One AllocateAction(engine=...) alone in a session of ``conf_text``'s
    tiers (the default conf for None) with ``arguments`` as the allocate
    action's configuration, through the port on the CPU (``torch_port``) or
    the JAX package; returns (closed session, the solves the engine ran: the
    JAX package's strict engines counted at _solve_job_batch, the port's
    from its stats)."""
    if torch_port:
        import volcano_tpu_torch.plugins  # noqa: F401
        from volcano_tpu_torch.actions import AllocateAction, allocate
        from volcano_tpu_torch.framework import (Arguments, Configuration,
                                                 close_session, open_session,
                                                 parse_scheduler_conf)
        kw = {"device": "cpu"}
    else:
        import volcano_tpu.plugins  # noqa: F401
        from volcano_tpu.actions import AllocateAction, allocate
        from volcano_tpu.framework import (Configuration, close_session,
                                           open_session,
                                           parse_scheduler_conf)
        from volcano_tpu.framework.arguments import Arguments
        kw = {}
    conf = parse_scheduler_conf(conf_text)
    confs = ([Configuration(name="allocate", arguments=Arguments(arguments))]
             if arguments else [])
    ssn = open_session(cache, conf.tiers, confs, **kw)
    action = AllocateAction(engine=engine)
    solves = 0
    if torch_port:
        action.execute(ssn)
        solves = action.last_stats.get("solves", 0)
    else:
        real = allocate._solve_job_batch

        def counting(*a, **k):
            nonlocal solves
            solves += 1
            return real(*a, **k)

        allocate._solve_job_batch = counting
        try:
            action.execute(ssn)
        finally:
            allocate._solve_job_batch = real
        assert not allocate.LAST_FALLBACK, allocate.LAST_FALLBACK
    close_session(ssn)
    return ssn, solves


def engine_reference(name):
    """name is "engine:world": (the world, the outcome, the solves)."""
    engine, world_name = name.split(":", 1)
    build, conf_text, arguments = ENGINE_WORLDS[world_name]
    cache = build()
    world = world_from_cache(cache)
    ssn, solves = run_allocate(cache, engine, conf_text, arguments, False)
    return world, outcome(ssn, cache), solves


# ---------------------------------------------------------------------------
# the plain-data world, and one cycle through either package
# ---------------------------------------------------------------------------

def _vec(r, scalars):
    return [r.cpu, r.memory] + [r.scalars.get(s, 0.0) for s in scalars]


def world_from_cache(cache) -> dict:
    """The world (volcano_tpu_torch/cache/transfer.py) a cache of either
    package holds."""
    nodes = list(cache.nodes.values())
    jobs = list(cache.jobs.values())
    res = [n.allocatable for n in nodes] + [
        t.resreq for j in jobs for t in j.tasks.values()]
    scalars = sorted({k for r in res for k in r.scalars})
    R = 2 + len(scalars)
    def vec_or_none(r):
        return None if r is None else np.asarray(_vec(r, scalars), np.float64)

    world_jobs = []
    for j in jobs:
        ts = list(j.tasks.values())
        world_jobs.append({
            "uid": j.uid, "name": j.name, "namespace": j.namespace,
            "queue": j.queue, "priority": j.priority,
            "min_available": j.min_available,
            "creation_timestamp": j.creation_timestamp,
            "phase": j.podgroup.phase.value,
            "min_resources": vec_or_none(j.podgroup.min_resources),
            "tasks": {
                "uid": [t.uid for t in ts],
                "name": [t.name for t in ts],
                "resreq": np.asarray([_vec(t.resreq, scalars) for t in ts],
                                     np.float64).reshape(-1, R),
                "status": np.asarray([int(t.status) for t in ts], np.int64),
                "priority": np.asarray([t.priority for t in ts], np.int64),
                "creation_timestamp": np.asarray(
                    [t.creation_timestamp for t in ts], np.float64),
                "tolerations": [list(t.tolerations) for t in ts],
                "affinity": [dict(t.affinity) for t in ts],
                "node_selector": [dict(t.node_selector) for t in ts],
                "host_ports": [list(t.host_ports) for t in ts],
                "namespace": [t.namespace for t in ts],
                "labels": [dict(t.labels) for t in ts],
                "annotations": [dict(t.annotations) for t in ts],
                "topology_policy": [t.topology_policy for t in ts],
            },
        })
    return {
        "resource_names": ["cpu", "memory"] + scalars,
        "queues": [{"name": q.name, "weight": q.weight,
                    "capability": vec_or_none(q.capability),
                    "reclaimable": q.reclaimable,
                    "annotations": dict(q.annotations)}
                   for q in cache.queues.values()],
        "nodes": {
            "names": [n.name for n in nodes],
            "allocatable": np.asarray([_vec(n.allocatable, scalars)
                                       for n in nodes],
                                      np.float64).reshape(-1, R),
            "max_tasks": np.asarray([n.allocatable.max_task_num or 0
                                     for n in nodes], np.int64),
            "labels": [dict(n.labels) for n in nodes],
            "taints": [list(n.taints) for n in nodes],
            "tasks": [list(n.tasks) for n in nodes],
            "unschedulable": [bool(n.unschedulable) for n in nodes],
            "numa": [_numa_spec(n.numa_info) for n in nodes],
            "cards": [sorted([i, d.memory, sorted(d.task_map.items())]
                             for i, d in n.gpu_devices.items())
                      for n in nodes],
        },
        "jobs": world_jobs,
    }


def _numa_spec(topo):
    """A NumatopoInfo as transfer.py's plain form (None for none)."""
    if topo is None:
        return None
    cpu = topo.numa_res_map["cpu"]
    return {"policies": dict(topo.policies),
            "cpus": sorted([c, d.numa_id, d.socket_id, d.core_id]
                           for c, d in topo.cpu_detail.items()),
            "allocatable": sorted(cpu.allocatable),
            "capacity": cpu.capacity}


def assert_same(a, b, path="world"):
    """Structural equality of two worlds, arrays compared exactly."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def outcome(ssn, cache) -> dict:
    """What a cycle decided: binds, evictions, PodGroup phases and
    conditions (without the session id and time stamp), and the session's
    pipelined tasks."""
    return {
        "binds": dict(cache.binder.binds),
        "evicts": sorted(cache.evictor.evicts),
        "phases": {uid: j.podgroup.phase.value
                   for uid, j in cache.jobs.items()},
        "conditions": {uid: [(c["type"], c["status"], c["reason"],
                              c["message"]) for c in j.podgroup.conditions]
                       for uid, j in cache.jobs.items()},
        "pipelined": {t.uid: t.node_name for j in ssn.jobs.values()
                      for t in j.tasks.values()
                      if int(t.status) == 3},          # TaskStatus.PIPELINED
    }


def run_jax_cycle(cache, conf_text=SLICE_CONF):
    """One cycle of a conf (the slice conf by default) through the JAX
    package; returns the closed session. The fused engine runs its XLA scan
    on the CPU, and the run must not have fallen back to the callback
    placer."""
    import volcano_tpu.actions  # noqa: F401  (registers the actions)
    import volcano_tpu.plugins  # noqa: F401  (registers the plugins)
    from volcano_tpu.actions import allocate
    from volcano_tpu.framework import (close_session, get_action,
                                       open_session, parse_scheduler_conf)
    conf = parse_scheduler_conf(conf_text)
    ssn = open_session(cache, conf.tiers, conf.configurations)
    for name in conf.actions:
        get_action(name).execute(ssn)
    close_session(ssn)
    assert not allocate.LAST_FALLBACK, allocate.LAST_FALLBACK
    return ssn


def run_torch_cycle(cache, conf_text=SLICE_CONF):
    """One cycle of a conf (the slice conf by default) through the port on
    the CPU; returns the closed session."""
    import volcano_tpu_torch.actions  # noqa: F401
    import volcano_tpu_torch.plugins  # noqa: F401
    from volcano_tpu_torch.framework import (close_session, get_action,
                                             open_session,
                                             parse_scheduler_conf)
    conf = parse_scheduler_conf(conf_text)
    ssn = open_session(cache, conf.tiers, conf.configurations, device="cpu")
    for name in conf.actions:
        get_action(name).execute(ssn)
    close_session(ssn)
    return ssn


# the hole worlds: NAME:on / NAME:off run with the incremental snapshot and
# the persistent node tensors on (the JAX package's default) or off
HOLE_WORLDS = ("hole:on", "hole:off", "hole-open:on", "hole-open:off",
               "drain:off")
# drain:on meets the JAX package's refresh fault (ROADMAP §3): the port's
# run is held to drain:mended, the JAX package with that fault mended
DRAIN_WORLDS = ("drain:on", "drain:mended")


def _mend_jax_refresh(cls):
    """Patch the JAX package's ``PersistentNodeTensors.refresh`` (in this
    process only) so that a name changed and then removed before the
    refresh is left out of the touch loop, as the port's refresh does. The
    rebuild test keeps counting it, as the JAX package's does. Returns the
    original method."""
    orig = cls.refresh

    def refresh(self, nodes, changed):
        removed = [n for n in self.index if n not in nodes]
        added = [n for n in nodes if n not in self.index]
        touch = [n for n in changed if n in self.index]
        base = len(self.index)
        full = (base == 0 or (len(removed) + len(added) + len(touch)) / base
                > self.rebuild_ratio
                or len(added) > len(removed) + len(self._free))
        if not full:
            changed = {n for n in changed if n in nodes}
        return orig(self, nodes, changed)

    cls.refresh = refresh
    return orig


def _stale_rows(cache, torch_port: bool):
    """Refresh the persistent tensors on a fresh snapshot and name the rows
    whose device values differ from the host mirror ("" for a hole), or
    None when the cache holds no persistent tensors."""
    snap = cache.snapshot()
    tc = cache.tensor_cache
    if tc is None:
        return None
    if torch_port:
        tc = cache.tensor_refresh(snap.nodes, tc.rnames, tc.device)
        dev = {f: t.cpu().numpy() for f, t in tc._ensure_device().items()}
        host = tc.host
    else:
        tc = cache.tensor_refresh(snap.nodes, tc.rnames)
        dev = {f: np.asarray(a) for f, a in tc._ensure_device().items()}
        host = {f: getattr(tc, f) for f in dev}
    return sorted(tc.names[i] for i in range(len(tc.names))
                  if any((dev[f][i] != host[f][i]).any() for f in dev))


def hole_world_run(torch_port: bool, name: str, device: str = "cpu") -> dict:
    """Cycles of deploy/scheduler.conf over node churn, through the port on
    the CPU or the JAX package, recording every bind in order, each solve's
    node-tensor path (tools/sim_traces.py::TensorPathRecorder) and, at the
    end, the persistent rows whose device values differ from the host
    mirror (``_stale_rows``).

    ``hole``: 32 nodes of 8 CPU / 32 GiB / 20 pods, queue q1; cycle 1 binds
    two 2-pod gangs on node-00000..00003; then node-00004 (empty) leaves,
    zz-new (the same shape) joins, and two gangs of one 7.9-8 CPU pod
    arrive. With the persistent tensors zz-new takes node-00004's row, so
    the argmax tie among empty nodes picks it first; a fresh build puts it
    last.

    ``hole-open``: the same, with a PreferNoSchedule taint on node-00008
    and node-00009 (nodeorder's static matrix is on) and node-00006 leaving
    too, so a hole stays open through cycle 2; then three fresh nodes join
    (more than the holes: a full rebuild) and two more whole-node gangs
    arrive for cycle 3.

    ``drain``: 16 such nodes; cycle 1 binds two 2-pod gangs of 1-1.1 CPU
    pods, cycle 2 one more pod, so the persistent rows hold cycle 1's
    binds. Then every task on a-job-00000-0's node X completes, cycle 3
    has nothing pending (its snapshot marks X's row changed, no solve
    consumes the mark), X drains, zz-new joins, and cycle 4 places one
    pod: its refresh meets X both removed and changed. Cycle 5 brings one
    gang of 7.9-8 CPU pods, a pod for each empty node, zz-new included.

    The switch is ``on``, ``off`` or ``mended`` (the JAX package only:
    on, with ``_mend_jax_refresh``). ``device`` is where the port solves."""
    import sys as _sys
    _sys.path.insert(0, os.path.join(_REPO, "tools"))
    from sim_traces import TensorPathRecorder
    if torch_port:
        import volcano_tpu_torch.actions.allocate as alloc
        from volcano_tpu_torch import Scheduler
        from volcano_tpu_torch.api import NodeInfo, QueueInfo, Resource
        from volcano_tpu_torch.cache import (FakeBinder, FakeEvictor,
                                             SchedulerCache)
        from volcano_tpu_torch.cache.synthetic import make_cluster, make_jobs

        def scheduler(cache):
            return Scheduler(cache, DEPLOYED_CONF, device=device)
    else:
        import volcano_tpu.actions.allocate as alloc
        from volcano_tpu.api import NodeInfo, QueueInfo, Resource
        from volcano_tpu.cache import FakeBinder, FakeEvictor, SchedulerCache
        from volcano_tpu.cache.snapshot import PersistentNodeTensors
        from volcano_tpu.cache.synthetic import make_cluster, make_jobs
        from volcano_tpu.scheduler import Scheduler

        def scheduler(cache):
            return Scheduler(cache, DEPLOYED_CONF)
    world, switch = name.split(":")
    assert switch in ("on", "off") or (switch == "mended" and not torch_port)
    gi = 1 << 30
    taint = [{"key": "spot", "value": "true", "effect": "PreferNoSchedule"}]

    def node(n, tainted=False):
        alloc_r = Resource(8000, 32 * gi)
        alloc_r.max_task_num = 20
        return NodeInfo(name=n, allocatable=alloc_r,
                        taints=taint if tainted else None)

    def jobs(n_tasks, n_jobs, cpu, seed, prefix=""):
        for j in make_jobs(n_tasks, n_jobs, ["q1"],
                           cpu_range=(cpu, cpu + 100),
                           mem_range=(gi, gi + 1), seed=seed,
                           name_prefix=prefix):
            cache.add_job(j)

    old_env = os.environ.get("VOLCANO_TPU_INCREMENTAL_SNAPSHOT")
    os.environ["VOLCANO_TPU_INCREMENTAL_SNAPSHOT"] = \
        "0" if switch == "off" else "1"
    rec = TensorPathRecorder(alloc, SchedulerCache)
    orig_refresh = (_mend_jax_refresh(PersistentNodeTensors)
                    if switch == "mended" else None)
    try:
        binder = FakeBinder()
        cache = SchedulerCache(binder=binder, evictor=FakeEvictor())
        cache.add_queue(QueueInfo(name="q1", weight=1))
        n_nodes = 16 if world == "drain" else 32
        for n in make_cluster(n_nodes, cpu_milli=8000, mem=32 * gi, pods=20):
            if world == "hole-open" and n.name in ("node-00008",
                                                   "node-00009"):
                n = node(n.name, tainted=True)
            cache.add_node(n)
        sched = scheduler(cache)
        if world == "drain":
            jobs(4, 2, 1000, 0, "a-")
            failures = list(sched.run_once())
            jobs(1, 1, 1000, 1, "b-")
            failures += sched.run_once()
            drained = binder.binds["default/a-job-00000-0"]
            for job in list(cache.jobs.values()):
                for task in list(job.tasks.values()):
                    if task.node_name == drained:
                        cache.delete_task(task)
            failures += sched.run_once()
            cache.remove_node(drained)
            cache.add_node(node("zz-new"))
            jobs(1, 1, 1000, 2, "c-")
            failures += sched.run_once()
            empty = sum(1 for n in cache.nodes.values() if not n.tasks)
            jobs(empty, 1, 7900, 3, "d-")
            failures += sched.run_once()
        else:
            jobs(4, 2, 1000, 0)
            failures = list(sched.run_once())
            cache.remove_node("node-00004")
            if world == "hole-open":
                cache.remove_node("node-00006")
            cache.add_node(node("zz-new"))
            jobs(2, 2, 7900, 1, "b-")
            failures += sched.run_once()
        if world == "hole-open":
            for n in ("zz-a", "zz-b", "zz-c"):
                cache.add_node(node(n))
            jobs(2, 2, 7900, 2, "c-")
            failures += sched.run_once()
        stale = _stale_rows(cache, torch_port)
    finally:
        rec.close()
        if orig_refresh is not None:
            PersistentNodeTensors.refresh = orig_refresh
        if old_env is None:
            os.environ.pop("VOLCANO_TPU_INCREMENTAL_SNAPSHOT", None)
        else:
            os.environ["VOLCANO_TPU_INCREMENTAL_SNAPSHOT"] = old_env
    return {"binds": list(binder.binds.items()), "paths": rec.paths,
            "drift": rec.drift, "failures": [n for n, _ in failures],
            "stale_rows": stale}


# the JAX package's tests/test_pipelined.py conf (runner.PIPELINED_SIM_CONF)
PIPELINED_CONF = """
actions: "enqueue, allocate-tpu, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""
# tests/test_pipelined.py's drive worlds: a standing backlog (no mutation
# between cycles), bind acks with a late arrival each cycle, and two gang
# completions each cycle
PIPELINED_WORLDS = ("standing", "acks", "completions")


def pipelined_drive(torch_port: bool, name: str) -> dict:
    """tests/test_pipelined.py's ``drive``: 10 cycles of PIPELINED_CONF
    over 30 two-pod gangs of 1 CPU on 4 nodes of 2 CPU, with the world's
    mutation after each cycle, through the port on the CPU or the JAX
    package. ``name`` is "WORLD:serial" or "WORLD:pipelined". Returns each
    cycle's plane (every task's uid, node and status), each cycle's
    speculation verdict and the binds in order."""
    world, mode = name.split(":")
    gi = 1 << 30
    if torch_port:
        from volcano_tpu_torch import Scheduler
        from volcano_tpu_torch.api import (JobInfo, NodeInfo, PodGroup,
                                           PodGroupPhase, QueueInfo,
                                           Resource, TaskInfo, TaskStatus)
        from volcano_tpu_torch.cache import SchedulerCache, SequenceBinder

        def scheduler(cache, pipelined):
            return Scheduler(cache, conf_text=PIPELINED_CONF,
                             pipelined=pipelined, device="cpu")
    else:
        from volcano_tpu.api import (JobInfo, NodeInfo, PodGroup,
                                     PodGroupPhase, QueueInfo, Resource,
                                     TaskInfo, TaskStatus)
        from volcano_tpu.cache import SchedulerCache
        from volcano_tpu.cache.executors import SequenceBinder
        from volcano_tpu.scheduler import Scheduler

        def scheduler(cache, pipelined):
            return Scheduler(cache, conf_text=PIPELINED_CONF,
                             pipelined=pipelined)

    def mkjob(uid, ts, cpu=1000, tasks=2):
        pg = PodGroup(name=uid, queue="q1", min_member=tasks,
                      phase=PodGroupPhase.PENDING)
        job = JobInfo(uid=uid, name=uid, queue="q1", min_available=tasks,
                      podgroup=pg, creation_timestamp=ts)
        for t in range(tasks):
            job.add_task_info(TaskInfo(
                uid=f"{uid}-{t}", name=f"{uid}-{t}", job=uid,
                resreq=Resource(cpu, gi), creation_timestamp=ts + t * 1e-6))
        return job

    binder = SequenceBinder()
    cache = SchedulerCache(binder=binder, default_queue=None)
    cache.add_queue(QueueInfo(name="q1", weight=1))
    for i in range(4):
        alloc_r = Resource(2000, 64 * gi)
        alloc_r.max_task_num = 100
        cache.add_node(NodeInfo(name=f"n{i}", allocatable=alloc_r))
    for j in range(30):
        cache.add_job(mkjob(f"j{j}", float(j)))

    def mutate(cyc):
        if world == "acks":
            for job in cache.jobs.values():
                for t in list(job.tasks.values()):
                    if t.status == TaskStatus.BOUND:
                        cache.update_task_status(t, TaskStatus.RUNNING)
            cache.add_job(mkjob(f"late{cyc}", 1000.0 + cyc, cpu=500))
        elif world == "completions":
            done = [j for j in cache.jobs.values()
                    if j.ready_task_num() >= j.min_available][:2]
            for job in done:
                for task in list(job.tasks.values()):
                    cache.delete_task(task)
                cache.remove_job(job.uid)

    sched = scheduler(cache, mode == "pipelined")
    planes, outcomes = [], []
    for cyc in range(10):
        errs = sched.run_once()
        assert not errs, errs
        outcomes.append(sched.last_speculation.get("outcome"))
        planes.append(sorted(
            (t.uid, t.node_name, str(t.status).rsplit(".", 1)[-1])
            for j in cache.jobs.values() for t in j.tasks.values()))
        mutate(cyc)
    return {"planes": planes, "outcomes": outcomes,
            "binds": list(binder.sequence)}


CONTAINMENT_CONF = """
actions: "enqueue, allocate-tpu, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
configurations:
- name: allocate-tpu
  arguments:
    engine: {engine}
    solver-fallback: {fallback}
"""
CONTAINMENT_ENGINES = ("tpu-fused", "tpu-strict", "tpu-strict-perjob",
                       "tpu-blocks")
# each script: (injector plan, solver-fallback, solve_deadline_s, refresh
# fault cycle or None, the clock's advance before each cycle: "w" moves it
# one second past the open window)
CONTAINMENT_SCRIPTS = {
    "oom": ({"oom": [1]}, True, None, None, (0, 0, "w", 0, 0)),
    "lost-twice": ({"device_lost": [1, 2]}, True, None, None,
                   (0, 0, "w", 0, "w")),
    "no-fallback": ({"oom": [1]}, False, None, None, (0, 0, "w", 0, 0)),
    "deadline": ({}, True, 1e-9, None, (0, 0, "w", 0, 0)),
    "refresh": ({}, True, None, 2, (0, 0, 0, "w", 0)),
}
CONTAINMENT_CASES = [f"{e}:{s}" for e in CONTAINMENT_ENGINES
                     for s in CONTAINMENT_SCRIPTS
                     if e == "tpu-fused" or s == "oom"]


def containment_drive(torch_port: bool, name: str) -> dict:
    """Five cycles of CONTAINMENT_CONF over 30 two-pod gangs of 1 CPU on 4
    nodes of 2 CPU (two admitted gangs complete after each cycle), through
    the port on the CPU or the JAX package, with ``name`` = "ENGINE:SCRIPT"
    (CONTAINMENT_SCRIPTS): a DeviceFaultInjector at the allocate hook, the
    solver-fallback key, a solve deadline, a classified fault raised by the
    persistent tensor refresh, and the cool-down's clock moved past its
    window before chosen cycles. Returns each cycle's isolated failures,
    new binds, LAST_FALLBACK, the cool-down's state, the hook's attempts
    and the containment counters' deltas."""
    import time as _time
    engine, script = name.split(":")
    plan, fallback, deadline, refresh_cycle, advances = \
        CONTAINMENT_SCRIPTS[script]
    gi = 1 << 30
    if torch_port:
        from volcano_tpu_torch import Scheduler, metrics
        from volcano_tpu_torch.actions import allocate
        from volcano_tpu_torch.api import (JobInfo, NodeInfo, PodGroup,
                                           PodGroupPhase, QueueInfo,
                                           Resource, TaskInfo)
        from volcano_tpu_torch.cache import SchedulerCache, SequenceBinder
        from volcano_tpu_torch.chaos import DeviceFaultInjector
        from volcano_tpu_torch.device_health import DEVICE_HEALTH
        extra = {"device": "cpu"}

        def device_error():
            return RuntimeError("CUDA error: an illegal memory access was "
                                "encountered")
    else:
        from volcano_tpu import metrics
        from volcano_tpu.actions import allocate
        from volcano_tpu.api import (JobInfo, NodeInfo, PodGroup,
                                     PodGroupPhase, QueueInfo, Resource,
                                     TaskInfo)
        from volcano_tpu.cache import SchedulerCache
        from volcano_tpu.cache.executors import SequenceBinder
        from volcano_tpu.chaos import DeviceFaultInjector
        from volcano_tpu.device_health import DEVICE_HEALTH
        from volcano_tpu.scheduler import Scheduler
        extra = {}

        def device_error():
            return type("XlaRuntimeError", (RuntimeError,), {})(
                "DEVICE_LOST: device lost")

    def mkjob(uid, ts):
        pg = PodGroup(name=uid, queue="q1", min_member=2,
                      phase=PodGroupPhase.PENDING)
        job = JobInfo(uid=uid, name=uid, queue="q1", min_available=2,
                      podgroup=pg, creation_timestamp=ts)
        for t in range(2):
            job.add_task_info(TaskInfo(
                uid=f"{uid}-{t}", name=f"{uid}-{t}", job=uid,
                resreq=Resource(1000, gi), creation_timestamp=ts + t * 1e-6))
        return job

    clock = [0.0]
    DEVICE_HEALTH.reset(time_fn=lambda: clock[0])
    metrics.reset_local()
    binder = SequenceBinder()
    cache = SchedulerCache(binder=binder, default_queue=None)
    cache.add_queue(QueueInfo(name="q1", weight=1))
    for i in range(4):
        alloc_r = Resource(2000, 64 * gi)
        alloc_r.max_task_num = 100
        cache.add_node(NodeInfo(name=f"n{i}", allocatable=alloc_r))
    for j in range(30):
        cache.add_job(mkjob(f"j{j}", float(j)))
    conf = CONTAINMENT_CONF.format(engine=engine,
                                   fallback=str(fallback).lower())
    sched = Scheduler(cache, conf_text=conf, solve_deadline_s=deadline,
                      **extra)
    injector = DeviceFaultInjector(plan, seed=7)
    allocate.DEVICE_FAULT_HOOK = injector
    real_refresh = cache.tensor_refresh

    def refresh(*args, **kwargs):
        if cycle[0] == refresh_cycle:
            raise device_error()
        return real_refresh(*args, **kwargs)

    cache.tensor_refresh = refresh
    cycle = [0]
    keys = ("solver_fallback", "device_faults", "device_degraded_cycles")

    def counts():
        return {"/".join(k): v for k, v in metrics.local_counters().items()
                if k[0] in keys}

    out = []
    try:
        for cyc, adv in enumerate(advances, start=1):
            cycle[0] = cyc
            if adv == "w":
                clock[0] += DEVICE_HEALTH.cooldown_remaining() + 1.0
            seen, attempts, before = len(binder.sequence), \
                injector.attempt, counts()
            errors = sched.run_once()
            now = counts()
            d = DEVICE_HEALTH.detail()
            out.append({
                "errors": [(n, type(e).__name__) for n, e in errors],
                "binds": list(binder.sequence[seen:]),
                "fallback": dict(allocate.LAST_FALLBACK),
                "available": d["available"],
                "consecutive_faults": d["consecutive_faults"],
                "total_faults": d["total_faults"],
                "last_kind": d["last_kind"],
                "cooldown_remaining_s": d["cooldown_remaining_s"],
                "attempts": injector.attempt - attempts,
                "counts": {k: now[k] - before.get(k, 0) for k in now
                           if now[k] != before.get(k, 0)},
            })
            done = [j for j in cache.jobs.values()
                    if j.ready_task_num() >= j.min_available][:2]
            for job in done:
                for task in list(job.tasks.values()):
                    cache.delete_task(task)
                cache.remove_job(job.uid)
    finally:
        allocate.DEVICE_FAULT_HOOK = None
        DEVICE_HEALTH.reset(time_fn=_time.monotonic)
    return {"cycles": out, "injected": list(injector.injected)}


def jax_reference_script(argv, out_path, names=()) -> dict:
    """Run ``python *argv out_path *names`` in a child process without FMA
    contraction and load the pickle it writes to ``out_path``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=NO_FMA_XLA_FLAGS,
               PYTHONPATH=os.pathsep.join(
                   [_REPO, _TESTS, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, *argv, str(out_path), *names], env=env, cwd=_REPO,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out_path, "rb") as f:
        return pickle.load(f)


def jax_reference(kind: str, names, out_path) -> dict:
    """The JAX package's results for the named worlds, computed in a child
    process without FMA contraction (module docstring). ``kind`` "slice"
    and "deployed": name -> (world, outcome) of one cycle of that conf;
    "evict": name -> (world, evict_outcome) of one preempt or reclaim;
    "walk": name -> jax_walk(); "walk-modes": name -> jax_walk() of a
    FAULT_WALK_WORLDS world in both modes; "plugins": name ->
    PLUGIN_CASES[name]();
    "place": name -> jax_place(); "blocks": name -> jax_blocks();
    "engines": "engine:world" -> engine_reference(); "incremental":
    name -> hole_world_run() of a HOLE_WORLDS or DRAIN_WORLDS world;
    "pipelined": name -> pipelined_drive(); "topo": "world@weight" ->
    jax_topo(); "topo-dispatch": any name -> topo_dispatch();
    "containment": "ENGINE:SCRIPT" -> containment_drive(); "rpc": name
    -> jax_rpc() of an RPC_WORLDS world; "quota": name -> quota_run() of
    a QUOTA_CASES case; "podaffinity", "numa", "conformance":
    "CASE:ENGINE" -> podaffinity_run(), numa_run(), conformance_run();
    "plugin-world": a tools/plugin_reference.py world -> its digest;
    "once-refused": an ONCE_REFUSED name -> once_refused_run();
    "topology": "CASE:ENGINE" -> topology_run();
    "mixed":
    names are "kind:name", so one child process serves several kinds."""
    return jax_reference_script([os.path.abspath(__file__), kind], out_path,
                                names)


# ---------------------------------------------------------------------------
# one port sim run of tools/sim_reference.py's lists, on the CPU
# ---------------------------------------------------------------------------

def sim_port_run(source, args, env=(), out_dir=None, device="cpu"):
    """One run of ``volcano_tpu_torch.sim`` in this process, as
    tools/sim_reference.py's child runs the JAX package's: the run's
    environment switches that the port reads at import are applied to the
    live objects (``VOLCANO_TPU_TIMELINE_EVENTS`` to the timeline store,
    ``VOLCANO_TPU_AUDIT_CYCLES`` to the audit ring) and put back after, and
    a trailing ``--trace-out`` gets a file in ``out_dir``. Returns the exit
    code, the printed plane, its report, the sequence digest, the
    node-tensor paths, stderr, every SimRunner built, the trace object and
    path, and the recorder's state (audit records, timelines)."""
    import contextlib
    import io
    import json
    import importlib.util
    from volcano_tpu_torch import obs as pt_obs
    from volcano_tpu_torch.actions import allocate as torch_allocate
    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.obs import audit as pt_audit
    from volcano_tpu_torch.obs import trace as pt_trace
    from volcano_tpu_torch.sim.__main__ import main as sim_main
    from volcano_tpu_torch.sim.report import sequence_digest
    sys.path.insert(0, os.path.join(_REPO, "tools"))
    from sim_traces import TensorPathRecorder
    spec = importlib.util.spec_from_file_location(
        "sim_reference", os.path.join(_REPO, "tools", "sim_reference.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    env = dict(env)
    argv = list(args)
    path = None
    if argv[-1:] == ["--trace-out"]:
        path = os.path.join(str(out_dir), "trace.json")
        argv.append(path)
    events = pt_obs.TIMELINE.max_events
    pt_obs.TIMELINE.max_events = int(env.get(
        "VOLCANO_TPU_TIMELINE_EVENTS", events))
    pt_obs.AUDIT.configure(int(env.get("VOLCANO_TPU_AUDIT_CYCLES",
                                       pt_audit._default_cycles())))
    out, err = io.StringIO(), io.StringIO()
    runners = []
    paths = TensorPathRecorder(torch_allocate, SchedulerCache)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = sim_main(["--device", device, "--scenario", source,
                           "--deterministic", *argv], runners=runners)
        state = tool.recorder_state(pt_obs)
    finally:
        paths.close()
        pt_obs.TIMELINE.max_events = events
        pt_obs.AUDIT.configure(pt_audit._default_cycles())
        # the sim leaves the recorder off; back to the default ring and
        # clock
        pt_obs.TRACE.configure(max_cycles=pt_trace.DEFAULT_MAX_CYCLES,
                               logical=False)
    text = out.getvalue().encode()
    trace = None
    if path is not None and rc == 0:
        with open(path) as f:
            trace = json.load(f)
    return {"rc": rc, "text": text,
            "report": json.loads(text) if rc == 0 else None,
            "sequence": sequence_digest(runners[0]) if runners else None,
            "paths": paths.summary(), "stderr": err.getvalue(),
            "runners": runners, "trace": trace, "trace_path": path,
            "state": state, "tool": tool}


# ---------------------------------------------------------------------------
# the snapshot RPC (volcano_tpu_torch/rpc): one message through both
# packages' SchedulerService
# ---------------------------------------------------------------------------

RPC_GI = 1 << 30


def rpc_small_world(api):
    """tests/test_rpc.py's build_world in the package ``api`` (either
    package's ``api`` module): 4 nodes in two zones, 3 two-task Inqueue
    gangs over two queues and a running filler on n0."""
    nodes = []
    for i in range(4):
        alloc = api.Resource(8000, 16 * RPC_GI)
        alloc.max_task_num = 110
        nodes.append(api.NodeInfo(name=f"n{i}", allocatable=alloc,
                                  labels={"zone": "a" if i < 2 else "b"}))
    queues = [api.QueueInfo(name="default", weight=1),
              api.QueueInfo(name="best", weight=2)]
    jobs = []
    for j in range(3):
        queue = "default" if j % 2 == 0 else "best"
        pg = api.PodGroup(name=f"job{j}", queue=queue, min_member=2,
                          phase=api.PodGroupPhase.INQUEUE,
                          min_resources=api.Resource(1000, RPC_GI))
        job = api.JobInfo(uid=f"job{j}", name=f"job{j}", queue=queue,
                          min_available=2, podgroup=pg, priority=j,
                          creation_timestamp=float(j))
        for t in range(2):
            job.add_task_info(api.TaskInfo(
                uid=f"job{j}-{t}", name=f"job{j}-{t}", job=f"job{j}",
                resreq=api.Resource(1000, 2 * RPC_GI),
                creation_timestamp=float(t)))
        jobs.append(job)
    pg = api.PodGroup(name="filler", queue="default", min_member=1,
                      phase=api.PodGroupPhase.RUNNING)
    filler = api.JobInfo(uid="filler", name="filler", queue="default",
                         min_available=1, podgroup=pg,
                         creation_timestamp=10.0)
    t = api.TaskInfo(uid="filler-0", name="filler-0", job="filler",
                     resreq=api.Resource(2000, 4 * RPC_GI),
                     status=api.TaskStatus.RUNNING, creation_timestamp=0.0)
    filler.add_task_info(t)
    t.node_name = "n0"
    nodes[0].add_task(filler.tasks["filler-0"])
    jobs.append(filler)
    return nodes, jobs, queues


def _rpc_affinity(msg) -> None:
    """The small world's pods labelled with their job, job0 spread one pod
    a zone (required anti-affinity to itself) and job1 drawn to job0's zone
    (preferred affinity)."""
    def term(app):
        return {"labelSelector": {"matchLabels": {"app": app}},
                "topologyKey": "zone"}
    for job in msg["jobs"]:
        for task in job["tasks"]:
            task["labels"] = {"app": job["uid"]}
            if job["uid"] == "job0":
                task["affinity"] = {"podAntiAffinity": {
                    PA_REQUIRED: [term("job0")]}}
            elif job["uid"] == "job1":
                task["affinity"] = {"podAffinity": {PA_PREFERRED: [
                    {"weight": 50, "podAffinityTerm": term("job0")}]}}


def _rpc_baseline_message(name):
    """A synthetic world's first snapshot, encoded by the port."""
    from volcano_tpu_torch.cache.synthetic import baseline_config
    from volcano_tpu_torch.rpc import encode_snapshot
    snap = baseline_config(name, seed=0)[0].snapshot()
    return encode_snapshot(list(snap.nodes.values()),
                           list(snap.jobs.values()),
                           list(snap.queues.values()))


def rpc_message(name) -> dict:
    """RPC_WORLDS' message, as JSON carries it."""
    import json
    if name.startswith("small-"):
        import volcano_tpu_torch.api as api
        from volcano_tpu_torch.rpc import encode_snapshot
        msg = encode_snapshot(*rpc_small_world(api))
        if name.startswith("small-affinity"):
            _rpc_affinity(msg)
    elif name == "golden":
        with open(os.path.join(_REPO, "shim", "testdata",
                               "golden_snapshot.json")) as f:
            return json.load(f)
    else:
        msg = _rpc_baseline_message(name.rsplit("-", 1)[0] if name.endswith(
            ("-blocks", "-deployed")) else name)
    return json.loads(json.dumps(msg))


def rpc_conf(name):
    """RPC_WORLDS' conf text (None: the reference's default conf)."""
    if name.endswith("-deployed"):
        return DEPLOYED_CONF
    if name.endswith("-blocks"):
        sys.path.insert(0, os.path.join(_REPO, "tools"))
        import rpc_reference
        return rpc_reference.BLOCKS_CONF
    return None


# the default conf on test_rpc's world and on the shim's golden snapshot,
# the deployed conf (B1, preempt's walk) on the world and on the preempt
# mix at a tenth, and tpu-blocks (B4) on the 1k world
RPC_WORLDS = ("small-default", "small-deployed", "golden", "1k-blocks",
              "preempt-small-deployed", "small-affinity",
              "small-affinity-deployed")


def rpc_normalized(out: dict) -> dict:
    """A decisions reply without the conditions' session id and time."""
    return dict(out, podgroups=[
        dict(p, conditions=[{k: v for k, v in c.items()
                             if k not in ("lastTransitionTime",
                                          "transitionID")}
                            for c in p["conditions"]])
        for p in out["podgroups"]])


def jax_rpc(name) -> dict:
    """The JAX package's SchedulerService on RPC_WORLDS[name]'s message,
    its preempt walk per task (tools/rpc_reference.py)."""
    sys.path.insert(0, os.path.join(_REPO, "tools"))
    import rpc_reference
    from volcano_tpu.rpc import SchedulerService
    rpc_reference._per_task_walk()
    return rpc_normalized(SchedulerService(rpc_conf(name)).schedule(
        rpc_message(name)))


# ---------------------------------------------------------------------------
# ResourceQuota namespace weights through a store-fed cache
# ---------------------------------------------------------------------------

# case -> the quota writes, in order: (namespace, quota, weight), a weight
# of None deleting that quota
QUOTA_CASES = {
    "weights-1-3": [("ns-a", "rq", 1), ("ns-b", "rq", 3)],
    "weights-3-1": [("ns-a", "rq", 3), ("ns-b", "rq", 1)],
    "no-quota": [],
    "largest-of-two": [("ns-a", "rq", 1), ("ns-b", "rq", 2),
                       ("ns-b", "rq2", 5)],
    "deleted": [("ns-a", "rq", 1), ("ns-b", "rq", 3), ("ns-b", "rq", None)],
}


def quota_run(torch_port: bool, name: str) -> dict:
    """One cycle of NAMESPACE_CONF (drf's enabledNamespaceOrder,
    allocate-tpu) on a cache fed from an object store whose ResourceQuotas
    set the namespaces' weights: _namespaces()'s two namespaces of gangs
    over two queues on a tight cluster. Returns the binds in order and
    the session's namespace weights."""
    import importlib
    pkg = "volcano_tpu_torch" if torch_port else "volcano_tpu"
    imp = importlib.import_module
    api, objects = imp(f"{pkg}.api"), imp(f"{pkg}.apis.objects")
    synthetic = imp(f"{pkg}.cache.synthetic")
    framework = imp(f"{pkg}.framework")
    imp(f"{pkg}.actions")
    imp(f"{pkg}.plugins")
    store = imp(f"{pkg}.store").ObjectStore()
    cache = imp(f"{pkg}.cache.store_wiring").wire_cache_to_store(store)
    binds = []

    class OrderBinder(imp(f"{pkg}.cache").FakeBinder):
        def bind(self, task, hostname):
            binds.append([task.key(), hostname])
            super().bind(task, hostname)

    cache.binder = OrderBinder()
    for ns, quota, weight in QUOTA_CASES[name]:
        if weight is None:
            store.delete("ResourceQuota", ns, quota)
        else:
            store.create(objects.ResourceQuota(
                metadata=objects.ObjectMeta(name=quota, namespace=ns),
                hard={"volcano.sh/namespace.weight": weight}))
    for k, w in enumerate((2, 1)):
        cache.add_queue(api.QueueInfo(name=f"q{k + 1}", weight=w))
    for node in synthetic.make_cluster(16):
        cache.add_node(node)
    for j, job in enumerate(synthetic.make_jobs(400, 20, ["q1", "q2"],
                                                seed=8)):
        ns = "ns-a" if j % 3 else "ns-b"
        job.namespace = ns
        job.podgroup.namespace = ns
        for task in job.tasks.values():
            task.namespace = ns
        cache.add_job(job)
    conf = framework.parse_scheduler_conf(NAMESPACE_CONF)
    kwargs = {"device": "cpu"} if torch_port else {}
    ssn = framework.open_session(cache, conf.tiers, conf.configurations,
                                 **kwargs)
    weights = {n: info.get_weight() for n, info in ssn.namespaces.items()}
    for action in conf.actions:
        framework.get_action(action).execute(ssn)
    framework.close_session(ssn)
    return {"binds": binds, "weights": weights}


# ---------------------------------------------------------------------------
# the plugin slice: pod affinity, the GPU card model, NUMA placement and
# conformance, each world built with either package's modules
# ---------------------------------------------------------------------------

def plugin_modules(torch_port: bool):
    """The modules a plugin-slice case drives, of one package."""
    import importlib
    import types
    name = "volcano_tpu_torch" if torch_port else "volcano_tpu"
    imp = importlib.import_module
    imp(f"{name}.plugins")
    return types.SimpleNamespace(
        torch_port=torch_port, api=imp(f"{name}.api"),
        cache=imp(f"{name}.cache"), framework=imp(f"{name}.framework"),
        actions=imp(f"{name}.actions"),
        kw={"device": "cpu"} if torch_port else {})


PA_HOST = "kubernetes.io/hostname"
PA_ZONE = "topology.kubernetes.io/zone"
PA_REQUIRED = "requiredDuringSchedulingIgnoredDuringExecution"
PA_PREFERRED = "preferredDuringSchedulingIgnoredDuringExecution"
PA_PLUGINS = ("gang", "priority", "predicates", "nodeorder")
PA_ENGINES = ("callbacks", "tpu-fused")


def _pa_node(m, name, zone=None):
    """tests/test_podaffinity.py::build_node."""
    labels = {PA_HOST: name}
    if zone:
        labels[PA_ZONE] = zone
    alloc = m.api.Resource(8000, 16 * GI)
    alloc.max_task_num = 110
    return m.api.NodeInfo(name=name, allocatable=alloc, labels=labels)


def _pa_world(m, nodes, running=(), pending=()):
    """tests/test_podaffinity.py::build_world: running (name, node, labels,
    affinity), pending (name, labels, affinity), one task a job."""
    api = m.api
    cache = m.cache.SchedulerCache(binder=m.cache.FakeBinder(),
                                   evictor=m.cache.FakeEvictor())
    cache.add_queue(api.QueueInfo(name="default", weight=1))
    node_map = {n.name: n for n in nodes}
    for n in nodes:
        cache.add_node(n)
    jobs = []
    for phase, specs in (("Running", running), ("Inqueue", pending)):
        for spec in specs:
            name, node, labels, affinity = (spec if phase == "Running"
                                            else (spec[0], None, *spec[1:]))
            pg = api.PodGroup(name=name, queue="default", min_member=1,
                              phase=api.PodGroupPhase(phase))
            job = api.JobInfo(uid=name, name=name, queue="default",
                              min_available=1, podgroup=pg)
            task = api.TaskInfo(
                uid=f"{name}-0", name=f"{name}-0", job=name,
                resreq=api.Resource(1000, 1 * GI),
                status=(api.TaskStatus.RUNNING if node
                        else api.TaskStatus.PENDING),
                labels=labels, affinity=affinity or {})
            job.add_task_info(task)
            if node:
                node_map[node].add_task(job.tasks[task.uid])
            jobs.append(job)
    for j in jobs:
        cache.add_job(j)
    return cache


def _pa_req(selector, topology=PA_HOST):
    return {"labelSelector": selector, "topologyKey": topology}


def _pa_terms(kind, *terms, preferred=False):
    return {kind: {PA_PREFERRED if preferred else PA_REQUIRED: list(terms)}}


_WEB = {"matchLabels": {"app": "web"}}
_DB = {"matchLabels": {"app": "db"}}

# case -> world builder (m -> cache), as tests/test_podaffinity.py's tests
PODAFFINITY_CASES = {
    "required-affinity": lambda m: _pa_world(
        m, [_pa_node(m, f"n{i}") for i in range(4)],
        running=[("web", "n2", {"app": "web"}, None)],
        pending=[("cli", {"app": "cli"},
                  _pa_terms("podAffinity", _pa_req(_WEB)))]),
    "required-anti-affinity": lambda m: _pa_world(
        m, [_pa_node(m, f"n{i}") for i in range(2)],
        running=[("db0", "n0", {"app": "db"},
                  _pa_terms("podAntiAffinity", _pa_req(_DB)))],
        pending=[("db1", {"app": "db"},
                  _pa_terms("podAntiAffinity", _pa_req(_DB)))]),
    "symmetric-anti-affinity": lambda m: _pa_world(
        m, [_pa_node(m, f"n{i}") for i in range(2)],
        running=[("lonely", "n0", {"team": "blue"},
                  _pa_terms("podAntiAffinity",
                            _pa_req({"matchLabels": {"team": "red"}})))],
        pending=[("red", {"team": "red"}, None)]),
    "zone-domain": lambda m: _pa_world(
        m, [_pa_node(m, "n0", "a"), _pa_node(m, "n1", "a"),
            _pa_node(m, "n2", "b")],
        running=[("web", "n0", {"app": "web"}, None)],
        pending=[("cli", {"app": "cli"},
                  _pa_terms("podAffinity", _pa_req(_WEB, PA_ZONE)))]),
    "in-cycle-anti-affinity": lambda m: _pa_world(
        m, [_pa_node(m, f"n{i}") for i in range(2)],
        pending=[(n, {"app": "db"},
                  _pa_terms("podAntiAffinity", _pa_req(_DB)))
                 for n in ("da", "db")]),
    "self-affinity-bootstrap": lambda m: _pa_world(
        m, [_pa_node(m, f"n{i}") for i in range(3)],
        pending=[(n, {"app": "db"}, _pa_terms("podAffinity", _pa_req(_DB)))
                 for n in ("da", "db")]),
    "symmetric-preferred-repulsion": lambda m: _pa_world(
        m, [_pa_node(m, f"n{i}") for i in range(2)],
        running=[("svc", "n0", {"app": "svc"}, _pa_terms(
            "podAntiAffinity", {"weight": 100, "podAffinityTerm": _pa_req(
                {"matchLabels": {"app": "batch"}})}, preferred=True))],
        pending=[("batch", {"app": "batch"}, None)]),
    "preferred-affinity": lambda m: _pa_world(
        m, [_pa_node(m, f"n{i}") for i in range(4)],
        running=[("web", "n3", {"app": "web"}, None)],
        pending=[("cli", {"app": "cli"}, _pa_terms(
            "podAffinity", {"weight": 100, "podAffinityTerm": _pa_req(_WEB)},
            preferred=True))]),
    "partial-bootstrap-denied": lambda m: _pa_world(
        m, [_pa_node(m, f"n{i}") for i in range(3)],
        running=[("web", "n1", {"app": "web"}, None)],
        pending=[("p", {"tier": "db"}, _pa_terms(
            "podAffinity", _pa_req(_WEB),
            _pa_req({"matchLabels": {"tier": "db"}})))]),
}


def _pending_scores(ssn) -> dict:
    """Each pending task's f64 host scores over every node: nodeorder's
    per-node score and the batch scores (pod affinity normalized over the
    nodes), and the nodes the predicate chain admits."""
    nodes = list(ssn.nodes.values())
    out = {}
    for job in ssn.jobs.values():
        for t in job.tasks.values():
            if int(t.status) != 1:                 # TaskStatus.PENDING
                continue
            feasible = []
            for n in nodes:
                try:
                    ssn.predicate_fn(t, n)
                    feasible.append(n.name)
                except ValueError:
                    pass
            out[t.uid] = {"order": {n.name: ssn.node_order_fn(t, n)
                                    for n in nodes},
                          "batch": ssn.batch_node_order_fn(t, nodes),
                          "feasible": feasible}
    return out


def podaffinity_run(torch_port: bool, key: str) -> dict:
    """``CASE:ENGINE``: one allocate of a PODAFFINITY_CASES world with
    tests/test_podaffinity.py's tiers. Returns the binds and each pending
    task's host scores before the allocate."""
    case, engine = key.split(":")
    m = plugin_modules(torch_port)
    fw = m.framework
    cache = PODAFFINITY_CASES[case](m)
    tiers = [fw.Tier(plugins=[fw.PluginOption(n) for n in PA_PLUGINS])]
    ssn = fw.open_session(cache, tiers, [], **m.kw)
    scores = _pending_scores(ssn)
    m.actions.AllocateAction(engine=engine).execute(ssn)
    fw.close_session(ssn)
    return {"binds": dict(cache.binder.binds), "scores": scores}


PODAFFINITY_KEYS = [f"{c}:{e}" for c in PODAFFINITY_CASES
                    for e in PA_ENGINES]

# -- NUMA placement and GPU sharing through allocate ------------------------


def _numa_node(m, policy):
    node = m.api.NodeInfo(name="n1", allocatable=m.api.Resource(
        8000, 1 << 30, max_task_num=100))
    from importlib import import_module
    numa_info = import_module(m.api.__name__ + ".numa_info")
    node.numa_info = numa_info.NumatopoInfo.uniform("n1", 2, 4,
                                                    topology_policy=policy)
    return node


def _one_job(m, tasks):
    """tests/test_numa_device.py's job j1 (min 1) with ``tasks``: (uid,
    resreq, topology policy)."""
    api = m.api
    pg = api.PodGroup(name="j1", queue="default", min_member=1,
                      phase=api.PodGroupPhase.INQUEUE)
    job = api.JobInfo(uid="j1", name="j1", queue="default",
                      min_available=1, podgroup=pg)
    for i, (uid, resreq, policy) in enumerate(tasks):
        job.add_task_info(api.TaskInfo(
            uid=uid, name=uid, job="j1", resreq=resreq,
            topology_policy=policy, creation_timestamp=float(i)))
    return job


def _card_node(m, used):
    node = m.api.NodeInfo(name="n1", allocatable=m.api.Resource(
        4000, 1 << 30, scalars={"volcano.sh/gpu-memory": 8000},
        max_task_num=100))
    node.set_gpu_info(8000, 2)                   # 2 cards x 4000
    if used:
        node.gpu_devices[0].task_map["other"] = used
    return node


def _numa_case(m, name):
    """(node, job, plugins): tests/test_numa_device.py's integration
    worlds."""
    R = m.api.Resource
    gpu = {"volcano.sh/gpu-memory": 0}
    if name == "numa-fits":
        return _numa_node(m, "single-numa-node"), _one_job(
            m, [("t1", R(2000, 1000), "single-numa-node")]), "numa"
    if name == "numa-spans":
        return _numa_node(m, "single-numa-node"), _one_job(
            m, [("t1", R(5000, 1000), "single-numa-node")]), "numa"
    if name == "numa-policy-mismatch":
        return _numa_node(m, "best-effort"), _one_job(
            m, [("t1", R(2000, 1000), "single-numa-node")]), "numa"
    if name == "numa-siblings":
        return _numa_node(m, "single-numa-node"), _one_job(
            m, [(f"t{i}", R(2000, 1000), "single-numa-node")
                for i in range(3)]), "numa"
    if name == "gpu-no-single-card":
        gpu["volcano.sh/gpu-memory"] = 4500
        return _card_node(m, 3500), _one_job(
            m, [("t1", R(100, 100, scalars=gpu), "")]), "gpu"
    if name == "gpu-card-fits":
        gpu["volcano.sh/gpu-memory"] = 4000
        return _card_node(m, 0), _one_job(
            m, [("t1", R(100, 100, scalars=gpu), "")]), "gpu"
    raise ValueError(name)


NUMA_CASES = ("numa-fits", "numa-spans", "numa-policy-mismatch",
              "numa-siblings", "gpu-no-single-card", "gpu-card-fits")


def numa_run(torch_port: bool, key: str) -> dict:
    """``CASE:ENGINE``: one allocate of a NUMA_CASES world with the tiers
    of tests/test_numa_device.py (gang, predicates, numa-aware, nodeorder;
    predicates with GPU sharing on for the card cases), then, for the NUMA
    cases, the task t1 deleted from the cache. Returns the binds, each
    node's cpusets and per-task allocations after the cycle and after the
    delete, and the cards' use."""
    case, engine = key.split(":")
    m = plugin_modules(torch_port)
    fw, api = m.framework, m.api
    node, job, kind = _numa_case(m, case)
    cache = m.cache.SchedulerCache(binder=m.cache.FakeBinder(),
                                   evictor=m.cache.FakeEvictor())
    cache.add_queue(api.QueueInfo(name="default", weight=1))
    cache.add_node(node)
    cache.add_job(job)
    if kind == "numa":
        names = [("gang", None), ("predicates", None), ("numa-aware", None),
                 ("nodeorder", None)]
    else:
        names = [("gang", None), ("predicates",
                                  {"predicate.GPUSharingEnable": "true"}),
                 ("nodeorder", None)]
    tiers = [fw.Tier(plugins=[
        fw.PluginOption(n, arguments=fw.Arguments(a or {}))
        for n, a in names])]
    ssn = fw.open_session(cache, tiers, [], **m.kw)
    m.actions.AllocateAction(engine=engine).execute(ssn)
    fw.close_session(ssn)
    live = cache.nodes["n1"]

    def numa_state():
        if live.numa_info is None:
            return None
        return {"allocatable": sorted(
                    live.numa_info.numa_res_map["cpu"].allocatable),
                "allocations": {uid: {r: sorted(ids) for r, ids in s.items()}
                                for uid, s in live.numa_allocations.items()}}

    out = {"binds": dict(cache.binder.binds), "numa": numa_state(),
           "cards": {i: sorted(d.task_map.items())
                     for i, d in live.gpu_devices.items()}}
    bound = cache.jobs["j1"].tasks.get("t1")
    if kind == "numa" and bound is not None and bound.node_name:
        cache.delete_task(bound)
        out["after_delete"] = numa_state()
    return out


NUMA_KEYS = [f"{c}:{e}" for c in NUMA_CASES for e in PA_ENGINES]

# -- conformance through preempt --------------------------------------------


def _pr_job(m, name, min_avail, tasks, priority=0, namespace="default"):
    """tests/test_preempt_reclaim.py::build_job: tasks (cpu, mem, status,
    node)."""
    api = m.api
    pg = api.PodGroup(name=name, namespace=namespace, queue="default",
                      min_member=min_avail, phase=api.PodGroupPhase.INQUEUE)
    job = api.JobInfo(uid=name, name=name, namespace=namespace,
                      queue="default", min_available=min_avail,
                      podgroup=pg, priority=priority)
    targets = {}
    for i, (cpu, mem, status, node) in enumerate(tasks):
        uid = f"{name}-{i}"
        job.add_task_info(api.TaskInfo(
            uid=uid, name=uid, namespace=namespace, job=name,
            resreq=api.Resource(cpu, mem), status=api.TaskStatus(status),
            creation_timestamp=float(i)))
        if node:
            targets[uid] = node
    return job, targets


def conformance_run(torch_port: bool, key: str) -> dict:
    """``CASE:ENGINE``: tests/test_preempt_reclaim.py's conformance cases
    through preempt (engine callbacks or tpu): ``critical`` (a kube-system
    pod under tiers priority, conformance, gang) and ``intra-job`` (a
    starving gang evicts its own task under gang | conformance); and
    ``vetoed``, affinity-preempt's case in miniature: two kube-system pods
    of a lower-priority job fill the node under tiers priority, gang,
    conformance | drf, and drf would keep the first of them (shares 0.5
    and 0.5). Returns the evictions and the pipelined tasks."""
    case, engine = key.split(":")
    m = plugin_modules(torch_port)
    fw, api = m.framework, m.api
    RUN, PEND = 6, 1                     # TaskStatus.RUNNING, PENDING
    if case == "critical":
        jobs = [_pr_job(m, "sys", 1, [(3000, 3000, RUN, "n1")], priority=1,
                        namespace="kube-system"),
                _pr_job(m, "high", 1, [(3000, 3000, PEND, None)],
                        priority=10)]
        tiers = [fw.Tier(plugins=[fw.PluginOption(n) for n in
                                  ("priority", "conformance", "gang")])]
    elif case == "vetoed":
        jobs = [_pr_job(m, "sys", 1, [(2000, 2000, RUN, "n1"),
                                      (2000, 2000, RUN, "n1")], priority=1,
                        namespace="kube-system"),
                _pr_job(m, "high", 1, [(2000, 2000, PEND, None)],
                        priority=10)]
        tiers = [fw.Tier(plugins=[fw.PluginOption(n) for n in
                                  ("priority", "gang", "conformance")]),
                 fw.Tier(plugins=[fw.PluginOption("drf")])]
    else:
        jobs = [_pr_job(m, "j", 2, [(3000, 3000, RUN, "n1"),
                                    (3000, 3000, PEND, None),
                                    (3000, 3000, PEND, None)], priority=5)]
        tiers = [fw.Tier(plugins=[fw.PluginOption("gang")]),
                 fw.Tier(plugins=[fw.PluginOption("conformance")])]
    node = api.NodeInfo(name="n1", allocatable=api.Resource(4000, 4000))
    cache = m.cache.SchedulerCache(binder=m.cache.FakeBinder(),
                                   evictor=m.cache.FakeEvictor())
    cache.add_queue(api.QueueInfo(name="default", weight=1))
    cache.add_node(node)
    for job, targets in jobs:
        cache.add_job(job)
        for uid, target in targets.items():
            t = job.tasks[uid]
            t.node_name = ""
            node.add_task(t)
    ssn = fw.open_session(cache, tiers, [], **m.kw)
    m.actions.PreemptAction(engine=engine).execute(ssn)
    out = evict_outcome(ssn, cache)
    fw.close_session(ssn)
    return out


CONFORMANCE_KEYS = [f"{c}:{e}" for c in ("critical", "intra-job", "vetoed")
                    for e in ("callbacks", "tpu")]


# ---------------------------------------------------------------------------
# tdm, sla, overcommit, reservation and task-topology, with the elect and
# reserve actions (slice 18), each case built with either package's modules
# ---------------------------------------------------------------------------

ONCE_REFUSED_BASE = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: predicates
  - name: nodeorder
"""
# the seven names the port refused until slice 18, each in the conf that
# named it in tests/test_torch_scheduler.py's refusal cases
ONCE_REFUSED = {
    name: ONCE_REFUSED_BASE.replace("name: nodeorder", f"name: {name}")
    for name in ("tdm", "sla", "overcommit", "task-topology", "reservation")
}
ONCE_REFUSED.update({
    name: ONCE_REFUSED_BASE.replace("backfill", name)
    for name in ("reserve", "elect")})


def _once_refused_world(m):
    """Four nodes (the last in revocable zone ``rz``, which no conf names),
    a ps/worker gang with task-topology annotations, a Pending gang with
    minResources and an sla-waiting-time, a preemptable gang naming a
    revocable zone, and a Pending gang too large to enqueue under
    overcommit."""
    api = m.api
    cache = m.cache.SchedulerCache(binder=m.cache.FakeBinder(),
                                   evictor=m.cache.FakeEvictor())
    cache.add_queue(api.QueueInfo(name="default", weight=1))
    for i in range(4):
        alloc = api.Resource(16000, 32 * GI)
        alloc.max_task_num = 110
        labels = {"volcano.sh/revocable-zone": "rz"} if i == 3 else {}
        cache.add_node(api.NodeInfo(name=f"n{i}", allocatable=alloc,
                                    labels=labels))
    specs = (
        ("topo", api.PodGroupPhase.INQUEUE, 4, 3000, False,
         {"volcano.sh/task-topology-affinity": "ps,worker",
          "volcano.sh/task-topology-anti-affinity": "worker"}),
        ("waits", api.PodGroupPhase.PENDING, 2, 2000, False,
         {"sla-waiting-time": "1s"}),
        ("revocable", api.PodGroupPhase.INQUEUE, 3, 4000, True, {}),
        ("huge", api.PodGroupPhase.PENDING, 6, 12000, False, {}),
    )
    for name, phase, n, cpu, revocable, annotations in specs:
        pg = api.PodGroup(name=name, queue="default", min_member=n,
                          phase=phase, annotations=annotations,
                          min_resources=api.Resource(n * cpu, n * GI))
        job = api.JobInfo(uid=name, name=name, queue="default",
                          min_available=n, podgroup=pg,
                          creation_timestamp=0.0)
        job.preemptable = revocable
        for k in range(n):
            job.add_task_info(api.TaskInfo(
                uid=f"{name}-{k}", name=f"{name}-{k}", job=name,
                task_role="ps" if k == 0 else "worker",
                resreq=api.Resource(cpu, GI), preemptable=revocable,
                revocable_zone="rz" if revocable else "",
                creation_timestamp=float(k)))
        cache.add_job(job)
    return cache


def once_refused_run(torch_port: bool, name: str) -> dict:
    """One cycle of ``ONCE_REFUSED[name]`` through the package's Scheduler
    shell on a logical clock: its outcome and the reservation's target."""
    import importlib
    sys.path.insert(0, os.path.join(_REPO, "tools"))
    from system_reference import LogicalClock
    m = plugin_modules(torch_port)
    pkg = m.api.__name__.split(".")[0]
    res = importlib.import_module(f"{pkg}.utils.reservation").Reservation
    res.reset()
    sched_mod = importlib.import_module(f"{pkg}.scheduler")
    cache = _once_refused_world(m)
    clock = LogicalClock()
    cache.time_fn = cache.resync_queue.time_fn = clock.time
    sched = sched_mod.Scheduler(cache, ONCE_REFUSED[name], **m.kw)
    sched.clock = clock
    failures = [n for n, _ in sched.run_once()]
    target = res.target_job.uid if res.target_job is not None else None
    res.reset()
    return {"binds": dict(cache.binder.binds),
            "evicts": sorted(cache.evictor.evicts),
            "phases": {uid: j.podgroup.phase.value
                       for uid, j in cache.jobs.items()},
            "failures": failures, "target": target}


def topology_case(m, case: str):
    """tests/test_task_topology.py's TestScheduling worlds: ``mates`` (a
    ps and two workers with affinity, four nodes) and ``spread`` (two ps
    with self anti-affinity, two nodes); ``bound`` (the affinity job's ps
    already running on n1, two workers pending, anti-affinity between the
    workers, three nodes)."""
    api = m.api
    aff = "volcano.sh/task-topology-affinity"
    anti = "volcano.sh/task-topology-anti-affinity"
    if case == "mates":
        annotations, specs, n_nodes = {aff: "ps,worker"}, \
            [("ps", 1), ("worker", 2)], 4
    elif case == "spread":
        annotations, specs, n_nodes = {anti: "ps"}, [("ps", 2)], 2
    else:
        annotations, specs, n_nodes = {aff: "ps,worker", anti: "worker"}, \
            [("ps", 1), ("worker", 2)], 3
    min_avail = sum(n for _, n in specs)
    pg = api.PodGroup(name="j1", queue="default", min_member=min_avail,
                      phase=api.PodGroupPhase.INQUEUE,
                      annotations=annotations)
    job = api.JobInfo(uid="j1", name="j1", queue="default",
                      min_available=min_avail, podgroup=pg)
    i = 0
    for role, count in specs:
        for _ in range(count):
            running = case == "bound" and i == 0
            job.add_task_info(api.TaskInfo(
                uid=f"j1-{i}", name=f"j1-{role}-{i}", job="j1",
                task_role=role, resreq=api.Resource(100, 100),
                status=api.TaskStatus.RUNNING if running
                else api.TaskStatus.PENDING,
                creation_timestamp=float(i)))
            i += 1
    cache = m.cache.SchedulerCache(binder=m.cache.FakeBinder(),
                                   evictor=m.cache.FakeEvictor())
    cache.add_queue(api.QueueInfo(name="default", weight=1))
    nodes = [api.NodeInfo(name=f"n{i}", allocatable=api.Resource(
        4000, 4000, max_task_num=10)) for i in range(n_nodes)]
    if case == "bound":
        nodes[1].add_task(job.tasks["j1-0"])
    for n in nodes:
        cache.add_node(n)
    cache.add_job(job)
    return cache


TOPOLOGY_PLUGINS = ("gang", "predicates", "task-topology", "binpack")


def topology_run(torch_port: bool, key: str) -> dict:
    """``CASE:ENGINE``: one allocate of a ``topology_case`` world under
    tests/test_task_topology.py's tier, with each pending task's node
    scores and the allocate's task order before it."""
    case, engine = key.split(":")
    m = plugin_modules(torch_port)
    fw = m.framework
    cache = topology_case(m, case)
    tiers = [fw.Tier(plugins=[fw.PluginOption(n) for n in TOPOLOGY_PLUGINS])]
    ssn = fw.open_session(cache, tiers, [], **m.kw)
    import importlib
    alloc = importlib.import_module(m.actions.__name__ + ".allocate")
    order = {uid: [t.uid for t in alloc._pending_tasks(ssn, job)]
             for uid, job in ssn.jobs.items()}
    scores = {t.uid: {n.name: ssn.node_order_fn(t, n)
                      for n in ssn.nodes.values()}
              for job in ssn.jobs.values() for t in job.tasks.values()
              if int(t.status) == 1}                      # PENDING
    m.actions.AllocateAction(engine=engine).execute(ssn)
    fw.close_session(ssn)
    return {"binds": dict(cache.binder.binds), "order": order,
            "scores": scores}


TOPOLOGY_KEYS = [f"{c}:{e}" for c in ("mates", "spread", "bound")
                 for e in ("callbacks", "tpu-fused")]


def plugin_world_jax(world: str) -> dict:
    """tools/plugin_reference.py's digest of one world through the JAX
    package (in this child process)."""
    sys.path.insert(0, os.path.join(_REPO, "tools"))
    import plugin_reference
    return plugin_reference.run_world("volcano_tpu", world)["digest"]


def _reference(kind, name):
    if kind == "slice":
        cache = SLICE_WORLDS[name]()
        world = world_from_cache(cache)
        return world, outcome(run_jax_cycle(cache), cache)
    if kind == "deployed":
        cache = DEPLOYED_WORLDS[name]()
        world = world_from_cache(cache)
        return world, outcome(run_jax_cycle(cache, DEPLOYED_CONF), cache)
    if kind == "evict":
        build, action = EVICT_WORLDS[name]
        cache = build()
        world = world_from_cache(cache)
        return world, evict_outcome(run_jax_action(cache, action), cache)
    if kind == "walk":
        return jax_walk(WALK_WORLDS[name]())
    if kind == "walk-modes":
        world = FAULT_WALK_WORLDS[name]()
        return jax_walk(world), jax_walk(world, exact=True)
    if kind == "plugins":
        return PLUGIN_CASES[name]()
    if kind == "blocks":
        return jax_blocks(BLOCK_WORLDS[name]())
    if kind == "engines":
        return engine_reference(name)
    if kind == "incremental":
        return hole_world_run(False, name)
    if kind == "pipelined":
        return pipelined_drive(False, name)
    if kind == "topo":
        world, weight = name.split("@")
        return jax_topo(TOPO_WORLDS[world](), float(weight))
    if kind == "topo-dispatch":
        return topo_dispatch(False)
    if kind == "containment":
        return containment_drive(False, name)
    if kind == "rpc":
        return jax_rpc(name)
    if kind == "quota":
        return quota_run(False, name)
    if kind == "podaffinity":
        return podaffinity_run(False, name)
    if kind == "numa":
        return numa_run(False, name)
    if kind == "conformance":
        return conformance_run(False, name)
    if kind == "plugin-world":
        return plugin_world_jax(name)
    if kind == "once-refused":
        return once_refused_run(False, name)
    if kind == "topology":
        return topology_run(False, name)
    return jax_place(PLACE_WORLDS[name](), name in INTEGER_PLACE_WORLDS)


def _main(kind, out_path, names):
    # the port's tier dispatch and duration units are upstream's (ROADMAP
    # §3): every JAX result the tests hold it to comes from the JAX package
    # mended alike
    mend_jax()
    results = {}
    for name in names:
        if kind == "mixed":
            results[name] = _reference(*name.split(":", 1))
        else:
            results[name] = _reference(kind, name)
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2], sys.argv[3:])
