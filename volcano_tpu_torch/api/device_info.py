"""GPU shared-device bookkeeping.

Mirrors pkg/scheduler/api/device_info.go:23-72 and the
node-side wiring in node_info.go:268-291,460-480: each node exposes a set of
GPU cards with per-card memory; GPU-sharing tasks request
``volcano.sh/gpu-memory`` and are packed onto single cards.

Besides the per-object accounting the host predicate reads,
:func:`devices_idle_matrix` flattens the per-node card state into a dense
``f32[N, D]`` matrix, so the GPU-share column of the feasibility mask that
the placement kernel reads (max over cards of idle memory >= request) is one
vectorised reduction.
"""

from __future__ import annotations

from typing import Dict, Optional

# volcano.sh/gpu-memory — per-card memory requested by a sharing task
# (well_known_labels.go:22); volcano.sh/gpu-number — number of physical cards
# on a node (well_known_labels.go:25).
GPU_MEMORY_RESOURCE = "volcano.sh/gpu-memory"
GPU_NUMBER_RESOURCE = "volcano.sh/gpu-number"
GPU_INDEX_ANNOTATION = "volcano.sh/gpu-index"
GPU_ASSIGNED_ANNOTATION = "volcano.sh/gpu-assigned"


def gpu_memory_of_task(task) -> float:
    """GPU memory requested by a task (device_info.go GetGPUResourceOfPod).
    Returned in the Resource scalar space (milli-scaled when built via
    Resource.from_dict); GPUDevice.memory lives in the same space because
    NodeInfo wires it from the capacity scalar unchanged."""
    return float(task.resreq.get(GPU_MEMORY_RESOURCE))


class GPUDevice:
    """One GPU card: id, per-card memory, and the tasks sharing it
    (device_info.go:23-40)."""

    def __init__(self, id: int, memory: float):
        self.id = id
        self.memory = memory
        # task uid -> requested gpu memory on this card
        self.task_map: Dict[str, float] = {}

    def used_memory(self) -> float:
        """device_info.go getUsedGPUMemory (terminated pods excluded at
        add/sub time by the node accounting)."""
        return sum(self.task_map.values())

    def idle_memory(self) -> float:
        return self.memory - self.used_memory()

    def clone(self) -> "GPUDevice":
        d = GPUDevice(self.id, self.memory)
        d.task_map = dict(self.task_map)
        return d


def make_gpu_devices(total_memory: float, card_count: int) -> Dict[int, GPUDevice]:
    """node_info.go setNodeGPUInfo:268-291 — split node GPU capacity into
    per-card devices of equal memory."""
    if card_count <= 0:
        return {}
    per_card = total_memory / card_count
    return {i: GPUDevice(i, per_card) for i in range(card_count)}


def predicate_gpu(task, devices: Dict[int, GPUDevice]) -> Optional[int]:
    """First card with enough idle memory for the request, lowest id first
    (predicates/gpu.go predicateGPU); None if no card fits."""
    request = gpu_memory_of_task(task)
    for dev_id in sorted(devices):
        if devices[dev_id].idle_memory() >= request:
            return dev_id
    return None


def add_gpu_resource(devices: Dict[int, GPUDevice], task) -> Optional[int]:
    """Account a placed GPU-sharing task onto its card (node_info.go
    AddGPUResource). The card comes from the task's gpu-index annotation if
    present, else the first fitting card."""
    request = gpu_memory_of_task(task)
    if request <= 0 or not devices:
        return None
    index = task.annotations.get(GPU_INDEX_ANNOTATION)
    dev_id = None
    if index is not None:
        try:
            dev_id = int(index)
        except ValueError:
            # invalid annotation: log-and-skip in the reference
            # (pod_info.go GetGPUIndex:141-155); fall back to first fit
            dev_id = None
    if dev_id is None:
        dev_id = predicate_gpu(task, devices)
    if dev_id is None or dev_id not in devices:
        return None
    devices[dev_id].task_map[task.uid] = request
    return dev_id


def sub_gpu_resource(devices: Dict[int, GPUDevice], task) -> None:
    """node_info.go SubGPUResource."""
    for device in devices.values():
        device.task_map.pop(task.uid, None)


def devices_idle_gpu_memory(devices: Dict[int, GPUDevice]) -> Dict[int, float]:
    """node_info.go GetDevicesIdleGPUMemory."""
    return {dev_id: dev.idle_memory() for dev_id, dev in devices.items()}


def devices_idle_matrix(nodes, max_cards: Optional[int] = None):
    """Dense ``f32[N, D]`` idle-GPU-memory matrix over a node list, padded
    with -inf for absent cards — the tensor-path feed for the GPU-sharing
    feasibility mask (feasible iff ``max_d idle[n, d] >= request``)."""
    import numpy as np

    if max_cards is None:
        max_cards = max((len(n.gpu_devices) for n in nodes), default=0)
    out = np.full((len(nodes), max(max_cards, 1)), -np.inf, dtype=np.float32)
    for i, node in enumerate(nodes):
        for dev_id, dev in node.gpu_devices.items():
            if dev_id < max_cards:
                out[i, dev_id] = dev.idle_memory()
    return out
