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
``python tests/torch_parity.py {slice|place} OUT NAME...``.
"""

from __future__ import annotations

import functools
import os
import pickle
import subprocess
import sys

import numpy as np

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
NO_FMA_XLA_FLAGS = "--xla_backend_optimization_level=0"


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


def _nodes(n, labels=lambda i: {}, taints=lambda i: [], gpus=0):
    """make_cluster's nodes (32 cores, 128 GiB, 110 pods), with labels and
    taints."""
    from volcano_tpu.api import NodeInfo, Resource
    from volcano_tpu.cache.synthetic import GI
    out = []
    for i in range(n):
        alloc = Resource(32000, 128 * GI,
                         {"nvidia.com/gpu": float(gpus)} if gpus else None)
        alloc.max_task_num = 110
        out.append(NodeInfo(name=f"node-{i:05d}", allocatable=alloc,
                            labels=labels(i), taints=taints(i)))
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
    for q in cache.queues.values():
        assert getattr(q, "capability", None) is None
    world_jobs = []
    for j in jobs:
        assert j.podgroup.min_resources is None
        ts = list(j.tasks.values())
        world_jobs.append({
            "uid": j.uid, "name": j.name, "namespace": j.namespace,
            "queue": j.queue, "priority": j.priority,
            "min_available": j.min_available,
            "creation_timestamp": j.creation_timestamp,
            "phase": j.podgroup.phase.value,
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
            },
        })
    return {
        "resource_names": ["cpu", "memory"] + scalars,
        "queues": [{"name": q.name, "weight": q.weight}
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
        },
        "jobs": world_jobs,
    }


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
    """What a cycle decided: binds, PodGroup phases and conditions (without
    the session id and time stamp), and the session's pipelined tasks."""
    return {
        "binds": dict(cache.binder.binds),
        "phases": {uid: j.podgroup.phase.value
                   for uid, j in cache.jobs.items()},
        "conditions": {uid: [(c["type"], c["status"], c["reason"],
                              c["message"]) for c in j.podgroup.conditions]
                       for uid, j in cache.jobs.items()},
        "pipelined": {t.uid: t.node_name for j in ssn.jobs.values()
                      for t in j.tasks.values()
                      if int(t.status) == 3},          # TaskStatus.PIPELINED
    }


def run_jax_cycle(cache):
    """One cycle of the slice conf through the JAX package; returns the
    closed session. The fused engine runs its XLA scan on the CPU, and the
    run must not have fallen back to the callback placer."""
    import volcano_tpu.actions  # noqa: F401  (registers the actions)
    import volcano_tpu.plugins  # noqa: F401  (registers the plugins)
    from volcano_tpu.actions import allocate
    from volcano_tpu.framework import (close_session, get_action,
                                       open_session, parse_scheduler_conf)
    conf = parse_scheduler_conf(SLICE_CONF)
    ssn = open_session(cache, conf.tiers, conf.configurations)
    for name in conf.actions:
        get_action(name).execute(ssn)
    close_session(ssn)
    assert not allocate.LAST_FALLBACK, allocate.LAST_FALLBACK
    return ssn


def run_torch_cycle(cache):
    """One cycle of the slice conf through the port on the CPU; returns
    the closed session."""
    import volcano_tpu_torch.actions  # noqa: F401
    import volcano_tpu_torch.plugins  # noqa: F401
    from volcano_tpu_torch.framework import (close_session, get_action,
                                             open_session,
                                             parse_scheduler_conf)
    conf = parse_scheduler_conf(SLICE_CONF)
    ssn = open_session(cache, conf.tiers, conf.configurations, device="cpu")
    for name in conf.actions:
        get_action(name).execute(ssn)
    close_session(ssn)
    return ssn


def jax_reference(kind: str, names, out_path) -> dict:
    """The JAX package's results for the named worlds, computed in a child
    process without FMA contraction (module docstring). ``kind`` "slice":
    name -> (world, outcome) of one cycle; "place": name -> jax_place()."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=NO_FMA_XLA_FLAGS,
               PYTHONPATH=os.pathsep.join(
                   [_REPO, _TESTS, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), kind, str(out_path),
         *names], env=env, cwd=_REPO, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out_path, "rb") as f:
        return pickle.load(f)


def _main(kind, out_path, names):
    results = {}
    for name in names:
        if kind == "slice":
            cache = SLICE_WORLDS[name]()
            world = world_from_cache(cache)
            results[name] = (world, outcome(run_jax_cycle(cache), cache))
        else:
            results[name] = jax_place(PLACE_WORLDS[name](),
                                      name in INTEGER_PLACE_WORLDS)
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2], sys.argv[3:])
