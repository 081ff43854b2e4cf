"""Scheduler in-memory model (the reference's pkg/scheduler/api, re-shaped
for dense-tensor snapshots)."""

from .resource import (CPU, INFINITY, MEMORY, MIN_RESOURCE, ZERO, Resource,
                       ResourceNames)
from .types import (BusAction, BusEvent, JobPhase, PodGroupConditionType,
                    PodGroupPhase, QueueState, TaskStatus, allocated_status)
from .job_info import JobInfo, PodGroup, TaskInfo
from .node_info import NodeInfo
from .queue_info import NamespaceCollection, NamespaceInfo, QueueInfo
from .cluster_info import ClusterInfo
from .unschedule_info import FitError, FitErrors

__all__ = [
    "CPU", "INFINITY", "MEMORY", "MIN_RESOURCE", "ZERO", "Resource",
    "ResourceNames", "BusAction", "BusEvent", "JobPhase",
    "PodGroupConditionType", "PodGroupPhase", "QueueState",
    "TaskStatus",
    "allocated_status", "JobInfo", "PodGroup", "TaskInfo", "NodeInfo",
    "NamespaceCollection", "NamespaceInfo", "QueueInfo", "ClusterInfo",
    "FitError", "FitErrors",
]
