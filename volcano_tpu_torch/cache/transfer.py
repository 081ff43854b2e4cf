"""Build a SchedulerCache from a plain-data description of a cluster.

A *world* is what another scheduler's cache holds, written out as Python
lists, dicts and NumPy arrays, so that two implementations can schedule the
very same cluster:

- ``resource_names``: column names of every resource array, cpu and memory
  first (the ``ResourceNames`` layout);
- ``queues``: ``[{"name", "weight"}]``;
- ``nodes``: ``{"names": [N], "allocatable": f64[N,R], "max_tasks": i64[N],
  "labels": [dict], "taints": [list], "tasks": [[task uid, ...]]}`` — the
  tasks each node holds, in the order the node took them;
- ``jobs``: ``[{"uid", "name", "namespace", "queue", "priority",
  "min_available", "creation_timestamp", "phase", "tasks": {"uid": [T],
  "name": [T], "resreq": f64[T,R], "status": i64[T] (TaskStatus values),
  "priority": i64[T], "creation_timestamp": f64[T],
  "tolerations": [list], "affinity": [dict]}}]``.

Resources stay float64 end to end, so node accounting is exact. The cache is
host-side: the device is chosen when a session opens on it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..api import (JobInfo, NodeInfo, PodGroup, PodGroupPhase, QueueInfo,
                   Resource, TaskInfo, TaskStatus)
from .cache import SchedulerCache
from .executors import FakeBinder, FakeEvictor


def _resource(row: np.ndarray, names: List[str]) -> Resource:
    scalars = {n: float(v) for n, v in zip(names[2:], row[2:]) if v != 0.0}
    return Resource(float(row[0]), float(row[1]), scalars)


def cache_from_world(world: Dict) -> SchedulerCache:
    """A cache holding ``world``, with a FakeBinder and a FakeEvictor."""
    names = list(world["resource_names"])
    cache = SchedulerCache(binder=FakeBinder(), evictor=FakeEvictor())
    for q in world["queues"]:
        cache.add_queue(QueueInfo(name=q["name"], weight=int(q["weight"])))

    tasks: Dict[str, TaskInfo] = {}
    for j in world["jobs"]:
        pg = PodGroup(name=j["name"], namespace=j["namespace"],
                      queue=j["queue"], min_member=int(j["min_available"]),
                      phase=PodGroupPhase(j["phase"]))
        job = JobInfo(uid=j["uid"], name=j["name"], namespace=j["namespace"],
                      queue=j["queue"], priority=int(j["priority"]),
                      min_available=int(j["min_available"]), podgroup=pg,
                      creation_timestamp=float(j["creation_timestamp"]))
        t = j["tasks"]
        for k, uid in enumerate(t["uid"]):
            task = TaskInfo(uid=uid, name=t["name"][k],
                            namespace=j["namespace"], job=j["uid"],
                            resreq=_resource(t["resreq"][k], names),
                            status=TaskStatus(int(t["status"][k])),
                            priority=int(t["priority"][k]),
                            tolerations=t["tolerations"][k],
                            affinity=t["affinity"][k],
                            creation_timestamp=float(
                                t["creation_timestamp"][k]))
            job.add_task_info(task)
            tasks[uid] = task
        cache.add_job(job)

    nodes = world["nodes"]
    for i, name in enumerate(nodes["names"]):
        alloc = _resource(nodes["allocatable"][i], names)
        alloc.max_task_num = int(nodes["max_tasks"][i])
        node = NodeInfo(name=name, allocatable=alloc,
                        labels=nodes["labels"][i], taints=nodes["taints"][i])
        for uid in nodes["tasks"][i]:
            node.add_task(tasks[uid])
        cache.add_node(node)
    return cache
