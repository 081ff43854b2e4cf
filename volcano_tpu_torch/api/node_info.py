"""NodeInfo: per-node resource accounting.

Mirrors pkg/scheduler/api/node_info.go:29-400 — Idle/Used/
Releasing/Pipelined vectors, ``FutureIdle = Idle + Releasing - Pipelined``,
and the per-status AddTask/RemoveTask bookkeeping that the Statement undo log
relies on.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .job_info import TaskInfo
from .resource import Resource
from ..elastic_gang.membership import TOPOLOGY_ZONE_LABEL
from .types import TaskStatus


def ports_conflict(want, existing) -> bool:
    """k8s nodeports conflict rule over canonical (host_ip, protocol, port)
    tuples: conflict iff protocol and port match and the hostIPs are equal or
    either side binds the 0.0.0.0 wildcard."""
    for ip, proto, port in want:
        for eip, eproto, eport in existing:
            if (port == eport and proto == eproto
                    and (ip == eip or ip == "0.0.0.0" or eip == "0.0.0.0")):
                return True
    return False


class NodeInfo:
    def __init__(self, name: str = "", allocatable: Optional[Resource] = None,
                 labels: Optional[Dict[str, str]] = None,
                 taints: Optional[List[dict]] = None,
                 unschedulable: bool = False,
                 capability: Optional[Resource] = None,
                 annotations: Optional[Dict[str, str]] = None):
        self.name = name
        self.allocatable = allocatable.clone() if allocatable else Resource()
        # the node's raw capacity and annotations: the snapshot wire carries
        # them (rpc/codec.py); no plugin of this package reads them
        self.capability = (capability.clone() if capability
                           else self.allocatable.clone())
        self.annotations = dict(annotations or {})
        self.idle = self.allocatable.clone()
        self.used = Resource()
        self.releasing = Resource()
        self.pipelined = Resource()
        self.labels = dict(labels or {})
        self.taints = list(taints or [])
        self.unschedulable = unschedulable
        # the volcano.sh/topology-zone label names the node's interconnect
        # locality group (cache/snapshot.py zone_code)
        self.topology_zone = self.labels.get(TOPOLOGY_ZONE_LABEL, "")
        self.tasks: Dict[str, TaskInfo] = {}
        # Mutation witness for the incremental snapshot (cache/cache.py):
        # add_task/remove_task, the funnel every placement-accounting
        # mutation goes through, set it; clone() starts the copy clean. The
        # cache reuses a previous snapshot's clone only while both the live
        # node and that clone are untouched, so a session mutation can
        # never leak into the next cycle's snapshot.
        self._touched = False
        # (host_ip, protocol, port) -> claim count for tasks on this node
        # (k8s nodeports bookkeeping; predicates.go:321 Filter input)
        self.used_ports: Dict[tuple, int] = {}
        # ready mirrors NodePhase; the snapshot skips nodes flagged not-ready
        # (cache.go:822-827)
        self.ready = True

    @property
    def max_task_num(self) -> int:
        return self.allocatable.max_task_num or 0

    def future_idle(self) -> Resource:
        """Idle + Releasing - Pipelined (node_info.go FutureIdle)."""
        return self.idle.clone().add(self.releasing).sub(self.pipelined)

    def _allocate_idle(self, task: TaskInfo) -> None:
        if not task.resreq.less_equal(self.idle):
            raise ValueError(
                f"selected node NotReady: task {task.key()} resreq {task.resreq} "
                f"exceeds idle {self.idle} on node {self.name}")
        self.idle.sub(task.resreq)

    def add_task(self, task: TaskInfo) -> None:
        """Per-status accounting (node_info.go AddTask):

        - RELEASING: consumes idle, counted in both Releasing and Used;
        - PIPELINED: only reserves future resources (Pipelined);
        - otherwise (Allocated/Bound/...): consumes idle, counted in Used.
        """
        if task.node_name and self.name and task.node_name != self.name:
            raise ValueError(f"task {task.key()} already on node {task.node_name}")
        if task.uid in self.tasks:
            raise ValueError(f"task {task.key()} already on node {self.name}")

        self._touched = True
        ti = task.clone()
        if ti.status == TaskStatus.RELEASING:
            self._allocate_idle(ti)
            self.releasing.add(ti.resreq)
            self.used.add(ti.resreq)
        elif ti.status == TaskStatus.PIPELINED:
            self.pipelined.add(ti.resreq)
        else:
            self._allocate_idle(ti)
            self.used.add(ti.resreq)

        task.node_name = self.name
        ti.node_name = self.name
        self.tasks[ti.uid] = ti
        for port in ti.host_ports:
            self.used_ports[port] = self.used_ports.get(port, 0) + 1

    def remove_task(self, task: TaskInfo) -> None:
        own = self.tasks.get(task.uid)
        if own is None:
            return
        self._touched = True
        if own.status == TaskStatus.RELEASING:
            self.releasing.sub(own.resreq)
            self.idle.add(own.resreq)
            self.used.sub(own.resreq)
        elif own.status == TaskStatus.PIPELINED:
            self.pipelined.sub(own.resreq)
        else:
            self.idle.add(own.resreq)
            self.used.sub(own.resreq)
        task.node_name = ""
        del self.tasks[own.uid]
        for port in own.host_ports:
            left = self.used_ports.get(port, 0) - 1
            if left > 0:
                self.used_ports[port] = left
            else:
                self.used_ports.pop(port, None)

    def update_task(self, task: TaskInfo) -> None:
        self.remove_task(task)
        self.add_task(task)

    def clone(self) -> "NodeInfo":
        """Snapshot copy with direct state transfer: the aggregates are exact
        invariants of the task set, and allocatable, capability, labels,
        taints and annotations are never mutated after construction, so
        clones share them."""
        n = NodeInfo.__new__(NodeInfo)
        n.name = self.name
        n.allocatable = self.allocatable
        n.capability = self.capability
        n.annotations = self.annotations
        n.idle = self.idle.clone()
        n.used = self.used.clone()
        n.releasing = self.releasing.clone()
        n.pipelined = self.pipelined.clone()
        n.labels = self.labels
        n.taints = self.taints
        n.unschedulable = self.unschedulable
        n.topology_zone = self.topology_zone
        n.used_ports = dict(self.used_ports)
        n.ready = self.ready
        n._touched = False
        n.tasks = {}
        for uid, task in self.tasks.items():
            ti = task.clone()
            ti.node_name = self.name
            n.tasks[uid] = ti
        return n

    def has_port_conflict(self, task: TaskInfo) -> bool:
        """True when any of the task's hostPorts collides with a port already
        claimed on this node (k8s nodeports Filter semantics). Pipelined
        tasks' ports count too — they claim the node's future."""
        if not task.host_ports or not self.used_ports:
            return False
        return ports_conflict(task.host_ports, self.used_ports)

    def __repr__(self) -> str:
        return f"Node({self.name} idle=<{self.idle}> used=<{self.used}>)"
