"""Build a SchedulerCache from a plain-data description of a cluster.

A *world* is what another scheduler's cache holds, written out as Python
lists, dicts and NumPy arrays, so that two implementations can schedule the
very same cluster:

- ``resource_names``: column names of every resource array, cpu and memory
  first (the ``ResourceNames`` layout);
- ``queues``: ``[{"name", "weight"}]``, optionally with ``"capability"``
  (f64[R] or None), ``"reclaimable"`` and ``"annotations"`` (the hierarchy
  keys);
- ``nodes``: ``{"names": [N], "allocatable": f64[N,R], "max_tasks": i64[N],
  "labels": [dict], "taints": [list], "tasks": [[task uid, ...]]}`` — the
  tasks each node holds (running, releasing, ...), in the order the node
  took them — optionally with ``"unschedulable": [bool]`` and ``"numa":
  [None or {"policies": dict, "cpus": [[cpu, numa, socket, core]],
  "allocatable": [cpu], "capacity": int}]`` (a node's NUMA topology under
  the cpu resource; its GPU cards come from the
  ``volcano.sh/gpu-*`` columns of ``allocatable``);
- ``jobs``: ``[{"uid", "name", "namespace", "queue", "priority",
  "min_available", "creation_timestamp", "phase", "tasks": {"uid": [T],
  "name": [T], "resreq": f64[T,R], "status": i64[T] (TaskStatus values),
  "priority": i64[T], "creation_timestamp": f64[T],
  "tolerations": [list], "affinity": [dict]}}]``, optionally with the
  PodGroup's ``"min_resources"`` (f64[R] or None) and the tasks'
  ``"node_selector": [dict]``, ``"host_ports": [list]``, ``"namespace":
  [str]``, ``"labels": [dict]``, ``"annotations": [dict]`` and
  ``"topology_policy": [str]``.

Resources stay float64 end to end, so node accounting is exact. The cache is
host-side: the device is chosen when a session opens on it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..api import (JobInfo, NodeInfo, PodGroup, PodGroupPhase, QueueInfo,
                   Resource, TaskInfo, TaskStatus)
from ..api.numa_info import CPU, CPUInfo, NumatopoInfo, ResourceInfo
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
        cap = q.get("capability")
        cache.add_queue(QueueInfo(
            name=q["name"], weight=int(q["weight"]),
            capability=None if cap is None else _resource(cap, names),
            reclaimable=bool(q.get("reclaimable", True)),
            annotations=q.get("annotations")))

    tasks: Dict[str, TaskInfo] = {}
    for j in world["jobs"]:
        min_res = j.get("min_resources")
        pg = PodGroup(name=j["name"], namespace=j["namespace"],
                      queue=j["queue"], min_member=int(j["min_available"]),
                      min_resources=(None if min_res is None
                                     else _resource(min_res, names)),
                      phase=PodGroupPhase(j["phase"]))
        job = JobInfo(uid=j["uid"], name=j["name"], namespace=j["namespace"],
                      queue=j["queue"], priority=int(j["priority"]),
                      min_available=int(j["min_available"]), podgroup=pg,
                      creation_timestamp=float(j["creation_timestamp"]))
        t = j["tasks"]
        n = len(t["uid"])
        selectors = t.get("node_selector") or [{}] * n
        ports = t.get("host_ports") or [[]] * n
        namespaces = t.get("namespace") or [j["namespace"]] * n
        labels = t.get("labels") or [{}] * n
        annotations = t.get("annotations") or [{}] * n
        policies = t.get("topology_policy") or [""] * n
        for k, uid in enumerate(t["uid"]):
            task = TaskInfo(uid=uid, name=t["name"][k],
                            namespace=namespaces[k], job=j["uid"],
                            resreq=_resource(t["resreq"][k], names),
                            status=TaskStatus(int(t["status"][k])),
                            priority=int(t["priority"][k]),
                            node_selector=selectors[k],
                            tolerations=t["tolerations"][k],
                            affinity=t["affinity"][k],
                            creation_timestamp=float(
                                t["creation_timestamp"][k]),
                            host_ports=ports[k], labels=labels[k],
                            annotations=annotations[k],
                            topology_policy=policies[k])
            job.add_task_info(task)
            tasks[uid] = task
        cache.add_job(job)

    nodes = world["nodes"]
    unsched = nodes.get("unschedulable") or [False] * len(nodes["names"])
    numa = nodes.get("numa") or [None] * len(nodes["names"])
    for i, name in enumerate(nodes["names"]):
        alloc = _resource(nodes["allocatable"][i], names)
        alloc.max_task_num = int(nodes["max_tasks"][i])
        node = NodeInfo(name=name, allocatable=alloc,
                        labels=nodes["labels"][i], taints=nodes["taints"][i],
                        unschedulable=bool(unsched[i]))
        if numa[i] is not None:
            node.numa_info = _numa(name, numa[i])
        for uid in nodes["tasks"][i]:
            node.add_task(tasks[uid])
        cache.add_node(node)
    return cache


def _numa(name: str, spec: Dict) -> NumatopoInfo:
    detail = {int(cpu): CPUInfo(numa_id=int(numa), socket_id=int(socket),
                                core_id=int(core))
              for cpu, numa, socket, core in spec["cpus"]}
    return NumatopoInfo(
        name=name, policies=dict(spec["policies"]),
        numa_res_map={CPU: ResourceInfo(set(spec["allocatable"]),
                                        int(spec["capacity"]))},
        cpu_detail=detail)
