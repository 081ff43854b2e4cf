"""The snapshot RPC's wire schema, version 1, the JAX package's
``rpc/codec.py``: JSON a Go shim emits straight from client-go objects.

Schema (version 1)::

  snapshot = {"v": 1,
    "nodes":  [{"name", "allocatable": RES, "capability": RES, "used": RES,
                "idle": RES, "releasing": RES, "pipelined": RES, "labels",
                "taints", "annotations", "unschedulable"}],
    "queues": [{"name", "weight", "reclaimable", "capability": RES|null,
                "annotations"}],
    "jobs":   [{"uid", "name", "namespace", "queue", "min_available",
                "priority", "phase", "created", "preemptable",
                "revocable_zone", "min_resources": RES|null,
                "tasks": [{"uid", "name", "status", "node", "resreq": RES,
                           "priority", "created", "preemptable",
                           "revocable_zone", "topology_policy", "task_role",
                           "labels", "annotations", "node_selector",
                           "tolerations", "affinity", "host_ports"}]}]}
  RES = {"cpu": milli, "memory": bytes, "scalars": {...},
         "max_task_num": pods}

  decisions = {"v": 1,
    "binds":  [{"uid", "namespace", "name", "node"}],
    "evicts": [{"uid", "namespace", "name", "reason"}],
    "podgroups": [{"uid", "phase", "conditions"}]}

A node's usage vectors are authoritative on decode: resources held by
pods outside the jobs array (daemonsets, system pods) stay accounted, and
placed tasks attach without being subtracted again. Host ports are not in
the usage vectors, so a placed task's claims are counted on its node.
"""

from __future__ import annotations

from typing import Dict, List

from ..api import (JobInfo, NodeInfo, PodGroup, PodGroupPhase, QueueInfo,
                   Resource, TaskInfo, TaskStatus)

VERSION = 1


def _res(r: Resource) -> dict:
    out = {"cpu": r.cpu, "memory": r.memory}
    if r.scalars:
        out["scalars"] = dict(r.scalars)
    if r.max_task_num is not None:
        out["max_task_num"] = r.max_task_num
    return out


def _res_from(d: dict) -> Resource:
    r = Resource(d.get("cpu", 0.0), d.get("memory", 0.0),
                 d.get("scalars") or None)
    if "max_task_num" in d:
        r.max_task_num = d["max_task_num"]
    return r


def encode_snapshot(nodes: List[NodeInfo], jobs: List[JobInfo],
                    queues: List[QueueInfo]) -> dict:
    return {
        "v": VERSION,
        "nodes": [{
            "name": n.name,
            "allocatable": _res(n.allocatable),
            "capability": _res(n.capability),
            "used": _res(n.used),
            "idle": _res(n.idle),
            "releasing": _res(n.releasing),
            "pipelined": _res(n.pipelined),
            "labels": n.labels,
            "taints": n.taints,
            "annotations": n.annotations,
            "unschedulable": n.unschedulable,
        } for n in nodes],
        "queues": [{
            "name": q.name,
            "weight": q.weight,
            "reclaimable": q.reclaimable,
            "capability": _res(q.capability) if q.capability else None,
            "annotations": q.annotations,
        } for q in queues],
        "jobs": [{
            "uid": j.uid,
            "name": j.name,
            "namespace": j.namespace,
            "queue": j.queue,
            "min_available": j.min_available,
            "priority": j.priority,
            "phase": j.podgroup.phase.value,
            "created": j.creation_timestamp,
            "preemptable": j.preemptable,
            "revocable_zone": j.revocable_zone,
            "min_resources": (_res(j.podgroup.min_resources)
                              if j.podgroup.min_resources else None),
            "tasks": [{
                "uid": t.uid,
                "name": t.name,
                "status": t.status.name,
                "node": t.node_name,
                "resreq": _res(t.resreq),
                "priority": t.priority,
                "created": t.creation_timestamp,
                "preemptable": t.preemptable,
                "revocable_zone": t.revocable_zone,
                "topology_policy": t.topology_policy,
                "task_role": t.task_role,
                "labels": t.labels,
                "annotations": t.annotations,
                "node_selector": t.node_selector,
                "tolerations": t.tolerations,
                "affinity": t.affinity,
                "host_ports": [list(p) for p in t.host_ports],
            } for t in j.tasks.values()],
        } for j in jobs],
    }


def decode_snapshot(msg: dict):
    """-> (nodes, jobs, queues): live api objects, each placed task
    attached to its node as the in-process snapshot has it."""
    if msg.get("v") != VERSION:
        raise ValueError(f"unsupported snapshot version {msg.get('v')!r}")
    nodes: Dict[str, NodeInfo] = {}
    for nd in msg["nodes"]:
        node = NodeInfo(name=nd["name"],
                        allocatable=_res_from(nd["allocatable"]),
                        capability=(_res_from(nd["capability"])
                                    if nd.get("capability") else None),
                        labels=nd.get("labels"), taints=nd.get("taints"),
                        annotations=nd.get("annotations"),
                        unschedulable=nd.get("unschedulable", False))
        # the wire's usage vectors are authoritative: they include pods
        # outside the jobs array
        node.used = _res_from(nd.get("used") or {})
        node.idle = (_res_from(nd["idle"]) if nd.get("idle")
                     else node.allocatable.clone())
        node.releasing = _res_from(nd.get("releasing") or {})
        node.pipelined = _res_from(nd.get("pipelined") or {})
        nodes[node.name] = node
    queues = [QueueInfo(
        name=qd["name"], weight=qd.get("weight", 1),
        reclaimable=qd.get("reclaimable", True),
        capability=(_res_from(qd["capability"])
                    if qd.get("capability") else None),
        annotations=qd.get("annotations")) for qd in msg["queues"]]
    jobs = []
    for jd in msg["jobs"]:
        pg = PodGroup(name=jd["name"], namespace=jd["namespace"],
                      queue=jd["queue"], min_member=jd["min_available"],
                      phase=PodGroupPhase(jd["phase"]),
                      min_resources=(_res_from(jd["min_resources"])
                                     if jd.get("min_resources") else None))
        job = JobInfo(uid=jd["uid"], name=jd["name"],
                      namespace=jd["namespace"], queue=jd["queue"],
                      min_available=jd["min_available"], podgroup=pg,
                      priority=jd.get("priority", 1),
                      creation_timestamp=jd.get("created"))
        job.preemptable = jd.get("preemptable", False)
        job.revocable_zone = jd.get("revocable_zone", "")
        for td in jd["tasks"]:
            task = TaskInfo(
                uid=td["uid"], name=td["name"], namespace=jd["namespace"],
                job=jd["uid"], resreq=_res_from(td["resreq"]),
                status=TaskStatus[td["status"]],
                priority=td.get("priority", 1),
                creation_timestamp=td.get("created"),
                preemptable=td.get("preemptable", False),
                revocable_zone=td.get("revocable_zone", ""),
                topology_policy=td.get("topology_policy", ""),
                task_role=td.get("task_role", ""),
                labels=td.get("labels"), annotations=td.get("annotations"),
                node_selector=td.get("node_selector"),
                tolerations=td.get("tolerations"),
                affinity=td.get("affinity"),
                host_ports=td.get("host_ports"))
            job.add_task_info(task)
            # the placement stands even when its node is not in the
            # snapshot (cordoned nodes, nodes with binds in flight): the
            # task keeps its node for affinity and eviction
            own = job.tasks[task.uid]
            own.node_name = td.get("node") or ""
            node = nodes.get(own.node_name)
            if node is not None:
                # attached without accounting: the usage vectors hold
                # every placed task already; host ports are not in them
                clone = own.clone()
                clone.node_name = node.name
                node.tasks[clone.uid] = clone
                for port in clone.host_ports:
                    node.used_ports[port] = node.used_ports.get(port, 0) + 1
        jobs.append(job)
    return list(nodes.values()), jobs, queues


def decisions_from_recorders(binder, evictor, jobs: List[JobInfo]) -> dict:
    """The reply: the recording executors' binds and evictions, and each
    job's PodGroup as the session closed it."""
    return {
        "v": VERSION,
        "binds": [{"uid": uid, "namespace": key.split("/", 1)[0],
                   "name": key.split("/", 1)[1], "node": node}
                  for (key, uid), node in binder.bind_records.items()],
        "evicts": [{"uid": uid, "namespace": key.split("/", 1)[0],
                    "name": key.split("/", 1)[1], "reason": reason}
                   for key, uid, reason in evictor.evict_records],
        "podgroups": [{
            "uid": j.uid,
            "phase": j.podgroup.phase.value,
            "conditions": list(j.podgroup.conditions),
        } for j in jobs],
    }
