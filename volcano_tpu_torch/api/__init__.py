"""Scheduler in-memory model (the reference's pkg/scheduler/api, re-shaped
for dense-tensor snapshots)."""

from .resource import (CPU, INFINITY, MEMORY, MIN_RESOURCE, ZERO, Resource,
                       ResourceNames)
from .types import (BusAction, BusEvent, JobPhase, PodGroupConditionType,
                    PodGroupPhase, QueueState, TaskStatus, allocated_status)
from .device_info import (GPU_MEMORY_RESOURCE, GPU_NUMBER_RESOURCE, GPUDevice,
                          add_gpu_resource, devices_idle_gpu_memory,
                          devices_idle_matrix, gpu_memory_of_task,
                          make_gpu_devices, predicate_gpu, sub_gpu_resource)
from .numa_info import (CPUInfo, NumatopoInfo, ResNumaSets, ResourceInfo,
                        TopologyHint, generate_node_res_numa_sets,
                        generate_numa_nodes, get_policy)
from .job_info import DisruptionBudget, JobInfo, PodGroup, TaskInfo
from .node_info import NodeInfo
from .queue_info import NamespaceCollection, NamespaceInfo, QueueInfo
from .cluster_info import ClusterInfo
from .unschedule_info import FitError, FitErrors

__all__ = [
    "CPU", "INFINITY", "MEMORY", "MIN_RESOURCE", "ZERO", "Resource",
    "ResourceNames", "BusAction", "BusEvent", "JobPhase",
    "PodGroupConditionType", "PodGroupPhase", "QueueState",
    "TaskStatus",
    "allocated_status", "DisruptionBudget", "JobInfo", "PodGroup",
    "TaskInfo", "NodeInfo",
    "NamespaceCollection", "NamespaceInfo", "QueueInfo", "ClusterInfo",
    "FitError", "FitErrors",
    "GPU_MEMORY_RESOURCE", "GPU_NUMBER_RESOURCE", "GPUDevice",
    "add_gpu_resource", "devices_idle_gpu_memory", "devices_idle_matrix",
    "gpu_memory_of_task", "make_gpu_devices", "predicate_gpu",
    "sub_gpu_resource",
    "CPUInfo", "NumatopoInfo", "ResNumaSets", "ResourceInfo", "TopologyHint",
    "generate_node_res_numa_sets", "generate_numa_nodes", "get_policy",
]
