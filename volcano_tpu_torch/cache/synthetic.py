"""Synthetic cluster generator for the BASELINE benchmark configs.

The same generator, seed for seed, as the JAX package's: one seed gives the
same world in both packages, for the configs this package runs (tiny, 1k,
10k); the others arrive with the actions and resources they exercise.
"""

from __future__ import annotations

import random
from typing import List

from ..api import (JobInfo, NodeInfo, PodGroup, PodGroupPhase, QueueInfo,
                   Resource, TaskInfo)
from .cache import SchedulerCache
from .executors import FakeBinder, FakeEvictor

GI = 1 << 30


def make_cluster(num_nodes: int, cpu_milli: int = 32000,
                 mem: int = 128 * GI, pods: int = 110) -> List[NodeInfo]:
    nodes = []
    for i in range(num_nodes):
        alloc = Resource(cpu_milli, mem)
        alloc.max_task_num = pods
        nodes.append(NodeInfo(name=f"node-{i:05d}", allocatable=alloc))
    return nodes


def make_jobs(num_tasks: int, num_jobs: int, queues: List[str],
              cpu_range=(500, 4000), mem_range=(1 * GI, 8 * GI),
              seed: int = 0) -> List[JobInfo]:
    """num_tasks split over num_jobs; each job is a whole gang (minAvailable
    = its task count), Inqueue, whose tasks share one request."""
    rng = random.Random(seed)
    sizes = _split(num_tasks, num_jobs, rng)
    jobs: List[JobInfo] = []
    for j, size in enumerate(sizes):
        queue = queues[j % len(queues)]
        # the JAX generator draws here whether the job starts running; the
        # draw is kept so one seed gives the same world in both packages
        rng.random()
        min_avail = size
        name = f"job-{j:05d}"
        pg = PodGroup(name=name, queue=queue, min_member=min_avail,
                      phase=PodGroupPhase.INQUEUE)
        job = JobInfo(uid=name, name=name, queue=queue,
                      min_available=min_avail, podgroup=pg,
                      priority=rng.randint(0, 10),
                      creation_timestamp=float(j))
        cpu = rng.randrange(*cpu_range, 100)
        mem = rng.randrange(mem_range[0], mem_range[1], GI // 4)
        for t in range(size):
            job.add_task_info(TaskInfo(uid=f"{name}-{t}", name=f"{name}-{t}", job=name,
                                       resreq=Resource(cpu, mem),
                                       creation_timestamp=float(j * 100000 + t)))
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
    else:
        raise ValueError(f"unknown baseline config {name!r}")

    for q in queues:
        cache.add_queue(q)
    for n in nodes:
        cache.add_node(n)
    for j in jobs:
        cache.add_job(j)
    return cache, binder, evictor
