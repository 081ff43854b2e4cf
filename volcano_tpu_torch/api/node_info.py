"""NodeInfo: per-node resource accounting.

Mirrors pkg/scheduler/api/node_info.go:29-400 — Idle/Used/
Releasing/Pipelined vectors, ``FutureIdle = Idle + Releasing - Pipelined``,
and the per-status AddTask/RemoveTask bookkeeping that the Statement undo log
relies on, with the node's GPU cards (node_info.go:57, 268-291, 460-480)
and its NUMA topology (node_info.go NumaSchedulerInfo).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .device_info import (GPU_MEMORY_RESOURCE, GPU_NUMBER_RESOURCE,
                          add_gpu_resource, gpu_memory_of_task,
                          make_gpu_devices, sub_gpu_resource)
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
        # the node's raw capacity (its GPU cards are read from it) and
        # annotations, as the snapshot wire carries them (rpc/codec.py)
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
        # NumatopoInfo for this node (node_info.go NumaSchedulerInfo), and
        # task uid -> ResNumaSets the numa-aware plugin committed, so the
        # cache can return a task's cpusets when it goes away
        self.numa_info = None
        self.numa_allocations: Dict[str, dict] = {}
        # GPU cards (node_info.go:57 GPUDevices), from the
        # volcano.sh/gpu-memory and volcano.sh/gpu-number capacity scalars
        # (NewNodeInfo -> setNodeGPUInfo), or set with set_gpu_info()
        self.gpu_devices: Dict[int, object] = {}
        gpu_mem = self.capability.get(GPU_MEMORY_RESOURCE)
        gpu_num = self.capability.get(GPU_NUMBER_RESOURCE)
        if gpu_mem > 0 and gpu_num > 0:
            # scalars are milli-scaled (Resource.from_dict); the memory stays
            # in that space, so it compares directly with task requests
            self.set_gpu_info(gpu_mem, int(round(gpu_num / 1000.0)))

    def set_gpu_info(self, total_memory: float, card_count: int) -> None:
        """node_info.go setNodeGPUInfo:268-291. ``total_memory`` is in the
        (milli-scaled) units of the tasks' volcano.sh/gpu-memory requests."""
        self.gpu_devices = make_gpu_devices(total_memory, card_count)

    def _account_gpu(self, task: TaskInfo, add: bool) -> None:
        if not self.gpu_devices or gpu_memory_of_task(task) <= 0:
            return
        if add:
            add_gpu_resource(self.gpu_devices, task)
        else:
            sub_gpu_resource(self.gpu_devices, task)

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
        if ti.status != TaskStatus.PIPELINED:
            self._account_gpu(ti, add=True)

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
        if own.status != TaskStatus.PIPELINED:
            self._account_gpu(own, add=False)

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
        n.numa_info = self.numa_info.deep_copy() if self.numa_info else None
        n.numa_allocations = {uid: {res: set(ids) for res, ids in sets.items()}
                              for uid, sets in self.numa_allocations.items()}
        n.gpu_devices = {i: d.clone() for i, d in self.gpu_devices.items()}
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
