"""callbacks-parallel of the port against the serial callbacks engine and
against the JAX package's callbacks-parallel, on the CPU.

The engine (actions/callbacks_parallel.py) fans the node scans out over a
forked process pool and merges in node order in the parent, so its binds,
PodGroup phases and pipelined tasks must equal the serial engine's, node by
node (tests/test_allocate_action.py:369-395), and the JAX package's
callbacks-parallel's on the engine worlds and baseline_config("1k",
seed=3) (tests/torch_parity.py's child). Its workers evaluate host objects
only: none may initialise CUDA (its parent may hold CUDA state; the card
case is in tests/test_torch_cuda.py).
"""

import random

import pytest

from volcano_tpu_torch.actions import callbacks_parallel as cp
from volcano_tpu_torch.cache import cache_from_world

from torch_parity import port_gc_windows  # noqa: F401 (autouse)
from torch_parity import one_torch_thread  # noqa: F401
from torch_parity import (ENGINE_CASES, ENGINE_WORLDS, jax_reference,
                          outcome, run_allocate)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KEYS = [f"callbacks-parallel:{c}" for c in ENGINE_CASES] \
    + ["callbacks-parallel:1k-seed3"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_reference("engines", KEYS,
                         tmp_path_factory.mktemp("jax") / "cp.pkl")


def _port(engine, world_name, world):
    _, conf_text, arguments = ENGINE_WORLDS[world_name]
    cache = cache_from_world(world)
    ssn, _ = run_allocate(cache, engine, conf_text, arguments, True)
    return outcome(ssn, cache)


@pytest.mark.parametrize("key", KEYS)
def test_parallel_matches_jax_and_serial(key, reference):
    """Equal to the JAX package's callbacks-parallel and to the port's
    serial callbacks on the same world."""
    world_name = key.split(":", 1)[1]
    world, want, _ = reference[key]
    got = _port("callbacks-parallel", world_name, world)
    assert got == want
    assert got == _port("callbacks", world_name, world)


def test_node_level_parity_with_serial():
    """tests/test_allocate_action.py:369-395: ten nodes, ten gangs of
    random size and priority from one seed; the parallel engine binds each
    task to the node the serial one does."""
    from volcano_tpu_torch import Scheduler
    from volcano_tpu_torch.api import (JobInfo, NodeInfo, PodGroup,
                                       PodGroupPhase, QueueInfo, Resource,
                                       TaskInfo)
    from volcano_tpu_torch.cache import FakeBinder, SchedulerCache
    rng = random.Random(11)
    nodes = [(f"n{i}", rng.choice([2000, 4000, 8000]),
              rng.choice([4000, 8000, 16000])) for i in range(10)]
    jobs = []
    for j in range(10):
        k = rng.randint(1, 3)
        jobs.append((f"job{j}", k, (rng.choice([500, 1000, 2000]),
                                    rng.choice([500, 1000, 2000])),
                     rng.randint(0, 5)))
    conf = """actions: "enqueue, allocate, backfill"
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
- name: allocate
  arguments:
    engine: {engine}
"""
    binds = {}
    for engine in ("callbacks", "callbacks-parallel"):
        binder = FakeBinder()
        cache = SchedulerCache(binder=binder)
        cache.add_queue(QueueInfo(name="default", weight=1))
        for name, cpu, mem in nodes:
            alloc = Resource(cpu, mem)
            alloc.max_task_num = 110
            cache.add_node(NodeInfo(name=name, allocatable=alloc))
        for name, k, (cpu, mem), prio in jobs:
            pg = PodGroup(name=name, queue="default", min_member=k,
                          phase=PodGroupPhase.PENDING,
                          min_resources=Resource(cpu * k, mem * k))
            job = JobInfo(uid=name, name=name, queue="default",
                          min_available=k, podgroup=pg, priority=prio)
            for i in range(k):
                job.add_task_info(TaskInfo(
                    uid=f"{name}-{i}", name=f"{name}-{i}", job=name,
                    resreq=Resource(cpu, mem), priority=prio))
            cache.add_job(job)
        assert Scheduler(cache, conf.format(engine=engine),
                         device="cpu").run_once() == []
        binds[engine] = dict(binder.binds)
    assert binds["callbacks"] == binds["callbacks-parallel"]
    assert binds["callbacks"]


def test_workers_never_touch_cuda():
    """Every worker of a run reports no CUDA initialisation attempted and
    CUDA not initialised; a worker asked to initialise CUDA raises by name
    (the node fails its evaluation) and counts the attempt."""
    from volcano_tpu_torch.actions import allocate
    from volcano_tpu_torch.cache.synthetic import baseline_config
    from volcano_tpu_torch.framework import (Arguments, Configuration,
                                             close_session, open_session,
                                             parse_scheduler_conf)
    cache, binder, _ = baseline_config("tiny", seed=1)
    conf = parse_scheduler_conf(None)
    ssn = open_session(cache, conf.tiers, [Configuration(
        "allocate", Arguments({"engine": "callbacks-parallel"}))],
        device="cpu")
    placer = cp.ParallelCallbackJobPlacer(ssn, workers=2)
    try:
        allocate._execute_interleaved(ssn, placer)
        probes = placer.pool.cuda_attempts()
        assert len(probes) == 2
        assert all(a == 0 and not init for _, a, init in probes)
    finally:
        placer.close()
        close_session(ssn)
    assert len(binder.binds) == 3

    def touches_cuda(task, node):
        import torch
        torch.cuda._lazy_init()

    cache, _, _ = baseline_config("tiny", seed=1)
    ssn = open_session(cache, conf.tiers, [], device="cpu")
    ssn.predicate_fn = touches_cuda
    pool = cp._ScanPool(ssn, 2)
    try:
        task = next(t for j in ssn.jobs.values() for t in j.tasks.values())
        feasible, errors = pool.predicate(task)
        assert feasible == [] and len(errors.nodes) == len(ssn.nodes)
        assert "must not touch CUDA" in str(next(iter(
            errors.nodes.values())).reasons)
        assert sum(a for _, a, _ in pool.cuda_attempts()) == len(ssn.nodes)
    finally:
        pool.stop()
        close_session(ssn)


def test_worker_count():
    """Sixteen workers at most (the reference's workqueue width), no more
    than the CPUs this process may use."""
    assert 1 <= cp.effective_cpus()
    assert cp.DEFAULT_WORKERS == 16
