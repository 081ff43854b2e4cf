"""Core enums (the statuses and phases the allocate cycle reads and writes).

Mirrors pkg/scheduler/api/types.go:23-167 and the CRD phase
enums from vendor/volcano.sh/apis (scheduling/v1beta1/types.go).
"""

from __future__ import annotations

import enum


class TaskStatus(enum.IntEnum):
    """Task lifecycle status (types.go:23-58)."""

    PENDING = 1
    ALLOCATED = 2
    PIPELINED = 3
    BINDING = 4
    BOUND = 5
    RUNNING = 6
    RELEASING = 7
    SUCCEEDED = 8
    FAILED = 9
    UNKNOWN = 10


def allocated_status(status: TaskStatus) -> bool:
    """AllocatedStatus (types.go:75-84): statuses that occupy node resources."""
    return status in (TaskStatus.BOUND, TaskStatus.BINDING,
                      TaskStatus.RUNNING, TaskStatus.ALLOCATED)


class PodGroupPhase(str, enum.Enum):
    """scheduling/v1beta1 PodGroupPhase (vendor .../scheduling/v1beta1/types.go)."""

    PENDING = "Pending"
    RUNNING = "Running"
    UNKNOWN = "Unknown"
    INQUEUE = "Inqueue"


class PodGroupConditionType(str, enum.Enum):
    SCHEDULED = "Scheduled"
    UNSCHEDULABLE = "Unschedulable"


class QueueState(str, enum.Enum):
    """scheduling/v1beta1 QueueState."""

    OPEN = "Open"
    CLOSED = "Closed"
    CLOSING = "Closing"
    UNKNOWN = "Unknown"


# predicate failure reasons (types.go:108-167)
NODE_POD_NUMBER_EXCEEDED = "node(s) pod number exceeded"
NODE_UNSCHEDULABLE = "node(s) were unschedulable"
TAINTS_UNTOLERATED = "node(s) had taints that the pod didn't tolerate"
NODE_AFFINITY_FAILED = "node(s) didn't match node affinity"
NODE_PORTS_FAILED = "node(s) didn't have free ports for the requested pod ports"
