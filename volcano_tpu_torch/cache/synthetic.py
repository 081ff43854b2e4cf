"""Synthetic cluster generator for the BASELINE benchmark configs.

The same generator, seed for seed, as the JAX package's: one seed gives the
same world in both packages, for the configs this package runs (tiny, 1k,
10k, 20k, 100k, preempt, preempt-small, gpu, gpu-small), the
running+pending preempt mix and the pipeline world.
"""

from __future__ import annotations

import random
from typing import List, Optional

from ..api import (JobInfo, NodeInfo, PodGroup, PodGroupPhase, QueueInfo,
                   Resource, TaskInfo, TaskStatus)
from .cache import SchedulerCache
from .executors import FakeBinder, FakeEvictor

GI = 1 << 30


def make_cluster(num_nodes: int, cpu_milli: int = 32000,
                 mem: int = 128 * GI, pods: int = 110,
                 gpus: int = 0, seed: int = 0) -> List[NodeInfo]:
    """``num_nodes`` equal nodes, with ``gpus`` whole ``nvidia.com/gpu``
    each; ``seed`` is the JAX package's argument, which draws nothing."""
    nodes = []
    for i in range(num_nodes):
        scalars = {"nvidia.com/gpu": float(gpus)} if gpus else None
        alloc = Resource(cpu_milli, mem, scalars)
        alloc.max_task_num = pods
        nodes.append(NodeInfo(name=f"node-{i:05d}", allocatable=alloc))
    return nodes


def make_jobs(num_tasks: int, num_jobs: int, queues: List[str],
              cpu_range=(500, 4000), mem_range=(1 * GI, 8 * GI),
              gpus_per_task: int = 0, running_fraction: float = 0.0,
              nodes: Optional[List[NodeInfo]] = None,
              seed: int = 0, name_prefix: str = "") -> List[JobInfo]:
    """num_tasks split over num_jobs; each job is a whole gang (minAvailable
    = its task count) whose tasks share one request, with
    ``gpus_per_task`` whole ``nvidia.com/gpu``. running_fraction of
    the jobs are pre-placed RUNNING onto ``nodes``, round-robin wherever a
    task fits (the preempt and reclaim worlds); the others are Inqueue.
    ``name_prefix`` keeps a later batch's uids distinct from a live
    cluster's."""
    rng = random.Random(seed)
    sizes = _split(num_tasks, num_jobs, rng)
    jobs: List[JobInfo] = []
    node_cycle = 0
    for j, size in enumerate(sizes):
        queue = queues[j % len(queues)]
        running = rng.random() < running_fraction
        min_avail = size
        name = f"{name_prefix}job-{j:05d}"
        pg = PodGroup(name=name, queue=queue, min_member=min_avail,
                      phase=PodGroupPhase.RUNNING if running
                      else PodGroupPhase.INQUEUE)
        job = JobInfo(uid=name, name=name, queue=queue,
                      min_available=min_avail, podgroup=pg,
                      priority=rng.randint(0, 10),
                      creation_timestamp=float(j))
        cpu = rng.randrange(*cpu_range, 100)
        mem = rng.randrange(mem_range[0], mem_range[1], GI // 4)
        scalars = ({"nvidia.com/gpu": float(gpus_per_task)}
                   if gpus_per_task else None)
        for t in range(size):
            task = TaskInfo(uid=f"{name}-{t}", name=f"{name}-{t}", job=name,
                            resreq=Resource(cpu, mem, scalars),
                            creation_timestamp=float(j * 100000 + t))
            if running and nodes:
                for _ in range(len(nodes)):
                    node = nodes[node_cycle % len(nodes)]
                    node_cycle += 1
                    if task.resreq.less_equal(node.idle):
                        task.status = TaskStatus.RUNNING
                        job.add_task_info(task)
                        node.add_task(job.tasks[task.uid])
                        break
                else:
                    job.add_task_info(task)
            else:
                job.add_task_info(task)
        jobs.append(job)
    return jobs


def _split(total: int, parts: int, rng: random.Random) -> List[int]:
    if parts >= total:
        return [1] * total
    base = total // parts
    sizes = [base] * parts
    for i in rng.sample(range(parts), total - base * parts):
        sizes[i] += 1
    return sizes


def baseline_config(name: str, seed: int = 0):
    """Build (cache, binder, evictor) for a BASELINE.md config:

    - "tiny":  example/job.yaml analogue — 1 gang of 3, 10 nodes
    - "1k":    1k pending pods / 200 nodes
    - "10k":   10k pods in 200 gangs / 2k nodes, 3 queues
    - "20k":   20k pods in 400 gangs / 5k nodes, 3 queues
    - "100k":  100k pods in 2,000 gangs / 20k nodes, 3 queues
    - "preempt": 5k running + 5k pending / 1k nodes, 2 queues
    - "preempt-small": the preempt mix at a tenth
    - "gpu":   8k one-GPU pods in 160 gangs / 2k nodes of 8 GPUs
    - "gpu-small": the gpu mix at a tenth
    """
    binder, evictor = FakeBinder(), FakeEvictor()
    cache = SchedulerCache(binder=binder, evictor=evictor)
    if name == "tiny":
        nodes = make_cluster(10, cpu_milli=4000, mem=8 * GI)
        jobs = make_jobs(3, 1, ["default"], cpu_range=(900, 1000),
                         mem_range=(GI, GI + 1), seed=seed)
        queues = [QueueInfo(name="default", weight=1)]
    elif name == "1k":
        nodes = make_cluster(200)
        jobs = make_jobs(1000, 50, ["default"], seed=seed)
        queues = [QueueInfo(name="default", weight=1)]
    elif name == "10k":
        nodes = make_cluster(2000)
        jobs = make_jobs(10000, 200, ["q1", "q2", "q3"], seed=seed)
        queues = [QueueInfo(name="q1", weight=3),
                  QueueInfo(name="q2", weight=2),
                  QueueInfo(name="q3", weight=1)]
    elif name == "20k":
        nodes = make_cluster(5000)
        jobs = make_jobs(20000, 400, ["q1", "q2", "q3"], seed=seed)
        queues = [QueueInfo(name="q1", weight=3),
                  QueueInfo(name="q2", weight=2),
                  QueueInfo(name="q3", weight=1)]
    elif name == "100k":
        nodes = make_cluster(20000)
        jobs = make_jobs(100000, 2000, ["q1", "q2", "q3"], seed=seed)
        queues = [QueueInfo(name="q1", weight=3),
                  QueueInfo(name="q2", weight=2),
                  QueueInfo(name="q3", weight=1)]
    elif name == "preempt":
        nodes = make_cluster(1000)
        jobs = make_jobs(10000, 200, ["q1", "q2"], running_fraction=0.5,
                         nodes=nodes, seed=seed)
        queues = [QueueInfo(name="q1", weight=1),
                  QueueInfo(name="q2", weight=1)]
    elif name == "preempt-small":
        nodes = make_cluster(100)
        jobs = make_jobs(1000, 20, ["q1", "q2"], running_fraction=0.5,
                         nodes=nodes, seed=seed)
        queues = [QueueInfo(name="q1", weight=1),
                  QueueInfo(name="q2", weight=1)]
    elif name == "gpu":
        nodes = make_cluster(2000, gpus=8)
        jobs = make_jobs(8000, 160, ["default"], gpus_per_task=1, seed=seed)
        queues = [QueueInfo(name="default", weight=1)]
    elif name == "gpu-small":
        nodes = make_cluster(200, gpus=8)
        jobs = make_jobs(800, 16, ["default"], gpus_per_task=1, seed=seed)
        queues = [QueueInfo(name="default", weight=1)]
    else:
        raise ValueError(f"unknown baseline config {name!r}")
    return _wire(cache, queues, nodes, jobs), binder, evictor


def _wire(cache, queues, nodes, jobs):
    for q in queues:
        cache.add_queue(q)
    for n in nodes:
        cache.add_node(n)
    for j in jobs:
        cache.add_job(j)
    return cache


def preempt_mix_cache(n_nodes: int = 200, n_tasks: int = 1000,
                      n_jobs: int = 40, seed: int = 0):
    """The JAX package's standard running+pending preempt mix, as (cache,
    binder, evictor)."""
    binder, evictor = FakeBinder(), FakeEvictor()
    cache = SchedulerCache(binder=binder, evictor=evictor)
    nodes = make_cluster(n_nodes)
    jobs = make_jobs(n_tasks, n_jobs, ["q1", "q2"], running_fraction=0.5,
                     nodes=nodes, seed=seed)
    queues = [QueueInfo(name="q1", weight=1), QueueInfo(name="q2", weight=1)]
    return _wire(cache, queues, nodes, jobs), binder, evictor


def pipeline_world(seed: int = 0, num_nodes: int = 2000,
                   num_tasks: int = 10000, num_jobs: int = 200):
    """bench.py's pipeline world: 10k pods / 2k nodes in 3 queues with half
    the gangs pre-placed RUNNING, so every action of the deployed cycle has
    work. As (cache, binder, evictor); the sizes shrink it for tests."""
    binder, evictor = FakeBinder(), FakeEvictor()
    cache = SchedulerCache(binder=binder, evictor=evictor)
    nodes = make_cluster(num_nodes)
    jobs = make_jobs(num_tasks, num_jobs, ["q1", "q2", "q3"],
                     running_fraction=0.5, nodes=nodes, seed=seed)
    queues = [QueueInfo(name="q1", weight=3), QueueInfo(name="q2", weight=2),
              QueueInfo(name="q3", weight=1)]
    return _wire(cache, queues, nodes, jobs), binder, evictor
