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


class JobPhase(str, enum.Enum):
    """batch/v1alpha1 Job phases (vendor .../batch/v1alpha1/job.go)."""

    PENDING = "Pending"
    ABORTING = "Aborting"
    ABORTED = "Aborted"
    RUNNING = "Running"
    RESTARTING = "Restarting"
    COMPLETING = "Completing"
    COMPLETED = "Completed"
    TERMINATING = "Terminating"
    TERMINATED = "Terminated"
    FAILED = "Failed"


class BusAction(str, enum.Enum):
    """bus/v1alpha1 Actions (vendor .../bus/v1alpha1/actions.go:20-60)."""

    ABORT_JOB = "AbortJob"
    RESTART_JOB = "RestartJob"
    RESTART_TASK = "RestartTask"
    TERMINATE_JOB = "TerminateJob"
    COMPLETE_JOB = "CompleteJob"
    RESUME_JOB = "ResumeJob"
    SYNC_JOB = "SyncJob"
    ENQUEUE_JOB = "EnqueueJob"
    SYNC_QUEUE = "SyncQueue"
    OPEN_QUEUE = "OpenQueue"
    CLOSE_QUEUE = "CloseQueue"


class BusEvent(str, enum.Enum):
    """bus/v1alpha1 Events (vendor .../bus/v1alpha1/events.go)."""

    ANY = "*"
    POD_FAILED = "PodFailed"
    POD_EVICTED = "PodEvicted"
    JOB_UNKNOWN = "Unknown"
    TASK_COMPLETED = "TaskCompleted"
    OUT_OF_SYNC = "OutOfSync"
    COMMAND_ISSUED = "CommandIssued"
    JOB_UPDATED = "JobUpdated"


# predicate failure reasons (types.go:108-167)
NODE_POD_NUMBER_EXCEEDED = "node(s) pod number exceeded"
NODE_RESOURCE_FIT_FAILED = "node(s) resource fit failed"
NODE_UNSCHEDULABLE = "node(s) were unschedulable"
TAINTS_UNTOLERATED = "node(s) had taints that the pod didn't tolerate"
NODE_AFFINITY_FAILED = "node(s) didn't match node affinity"
NODE_PORTS_FAILED = "node(s) didn't have free ports for the requested pod ports"
