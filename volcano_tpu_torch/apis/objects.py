"""Store-level object definitions.

Field layout mirrors the reference CRDs:
- Job:      vendor/volcano.sh/apis/pkg/apis/batch/v1alpha1/job.go:48-105
- PodGroup: vendor/.../scheduling/v1beta1/types.go:165-194
- Queue:    vendor/.../scheduling/v1beta1/types.go:305-317
- Command:  vendor/.../bus/v1alpha1
- PartitionState: the federated control plane's store-backed state
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..api import (BusAction, BusEvent, JobPhase, PodGroupPhase, QueueState,
                   Resource, TaskStatus)

_uid = itertools.count()


def new_uid(prefix: str = "obj") -> str:
    return f"{prefix}-{next(_uid)}"


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = field(default_factory=lambda: new_uid())
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    owner_references: List[dict] = field(default_factory=list)
    creation_timestamp: float = field(default_factory=time.time)
    finalizers: List[str] = field(default_factory=list)
    resource_version: int = 0

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class PodTemplate:
    """Pod template inside a TaskSpec: the schedulable payload."""

    resources: Optional[Resource] = None           # per-replica request
    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: List[dict] = field(default_factory=list)
    affinity: dict = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    priority: int = 1
    containers: List[dict] = field(default_factory=list)
    restart_policy: str = "OnFailure"
    env: List[dict] = field(default_factory=list)
    volumes: List[dict] = field(default_factory=list)


@dataclass
class LifecyclePolicy:
    """Job events→actions policy (batch/v1alpha1 LifecyclePolicy)."""

    # None = no event clause (an exitCode-only policy); admission rejects
    # specifying both, matching validate/util.go:60-66
    event: Optional[BusEvent] = None
    action: BusAction = BusAction.SYNC_JOB
    exit_code: Optional[int] = None
    timeout: Optional[float] = None


@dataclass
class TaskSpec:
    """One task template of a Job (batch/v1alpha1 TaskSpec)."""

    name: str = ""
    replicas: int = 1
    min_available: Optional[int] = None
    template: PodTemplate = field(default_factory=PodTemplate)
    policies: List[LifecyclePolicy] = field(default_factory=list)


@dataclass
class JobSpec:
    scheduler_name: str = "volcano"
    queue: str = "default"
    min_available: int = 0
    tasks: List[TaskSpec] = field(default_factory=list)
    policies: List[LifecyclePolicy] = field(default_factory=list)
    plugins: Dict[str, List[str]] = field(default_factory=dict)
    max_retry: int = 3
    ttl_seconds_after_finished: Optional[float] = None
    priority_class_name: str = ""
    volumes: List[dict] = field(default_factory=list)
    # job succeeds once this many pods succeeded (job.go:104 MinSuccess)
    min_success: Optional[int] = None


@dataclass
class JobStatus:
    state: JobPhase = JobPhase.PENDING
    state_message: str = ""
    state_last_transition: float = field(default_factory=time.time)
    pending: int = 0
    running: int = 0
    succeeded: int = 0
    failed: int = 0
    terminating: int = 0
    unknown: int = 0
    version: int = 0
    retry_count: int = 0
    min_available: int = 0
    task_status_count: Dict[str, Dict[str, int]] = field(default_factory=dict)
    conditions: List[dict] = field(default_factory=list)
    # ControlledResources (job_controller_actions.go:446): resources this
    # job owns, e.g. "volume-pvc-<name>" -> pvc name
    controlled_resources: Dict[str, str] = field(default_factory=dict)


@dataclass
class Job:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: JobSpec = field(default_factory=JobSpec)
    status: JobStatus = field(default_factory=JobStatus)

    KIND = "Job"


@dataclass
class PodStatus:
    phase: str = "Pending"     # Pending/Running/Succeeded/Failed
    node_name: str = ""
    reason: str = ""
    conditions: List[dict] = field(default_factory=list)
    # main-container termination code — matched by exitCode lifecycle
    # policies (job.go:162-164)
    exit_code: Optional[int] = None


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    template: PodTemplate = field(default_factory=PodTemplate)
    scheduler_name: str = "volcano"
    status: PodStatus = field(default_factory=PodStatus)

    KIND = "Pod"


@dataclass
class PVCStatus:
    phase: str = "Pending"            # Pending | Bound
    node: str = ""                    # assumed/bound topology


@dataclass
class PVC:
    """PersistentVolumeClaim mirror — the job IO objects
    createJobIOIfNotExist manages (job_controller_actions.go:442-494)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: Dict = field(default_factory=dict)      # claim spec (size, class)
    status: PVCStatus = field(default_factory=PVCStatus)

    KIND = "PersistentVolumeClaim"


@dataclass
class PodGroupStatus:
    phase: PodGroupPhase = PodGroupPhase.PENDING
    conditions: List[dict] = field(default_factory=list)
    running: int = 0
    succeeded: int = 0
    failed: int = 0


@dataclass
class PodGroupSpec:
    min_member: int = 0
    queue: str = "default"
    priority_class_name: str = ""
    min_resources: Optional[Resource] = None


@dataclass
class PodGroupCR:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodGroupSpec = field(default_factory=PodGroupSpec)
    status: PodGroupStatus = field(default_factory=PodGroupStatus)

    KIND = "PodGroup"


@dataclass
class QueueStatus:
    state: QueueState = QueueState.OPEN
    unknown: int = 0
    pending: int = 0
    running: int = 0
    inqueue: int = 0


@dataclass
class QueueSpecCR:
    weight: int = 1
    capability: Optional[Resource] = None
    reclaimable: bool = True


@dataclass
class QueueCR:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: QueueSpecCR = field(default_factory=QueueSpecCR)
    status: QueueStatus = field(default_factory=QueueStatus)

    KIND = "Queue"


@dataclass
class ResourceQuota:
    """core/v1 ResourceQuota mirror — the scheduler reads ONLY the
    volcano.sh/namespace.weight key of spec.hard, which feeds drf's
    namespace fairness (event_handlers.go:740-770 updateResourceQuota,
    namespace_info.go NamespaceWeightKey)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    hard: Dict[str, float] = field(default_factory=dict)   # spec.hard

    KIND = "ResourceQuota"


@dataclass
class PriorityClass:
    """scheduling.k8s.io PriorityClass (resolved into JobInfo.priority by the
    cache wiring, mirroring event_handlers.go AddPriorityClass:633)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    global_default: bool = False

    KIND = "PriorityClass"


@dataclass
class PartitionStateCR:
    """The federated control plane's state as a store object (the
    store-backed transport): the PartitionMap's queue and node ownership
    with its pin and drain markers, and the ReserveLedger's open request
    set, through the same CAS and watch path as every other object.
    ``spec`` is one plain dict (queue_owner, node_owner, pinned, draining,
    rr_queue, rr_node, idle, requests, next_rid, version), so the CAS
    funnel deep-copies and replaces it whole: a partial write cannot
    exist, which makes an ownership flip atomic at the store."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: Dict = field(default_factory=dict)

    KIND = "PartitionState"


@dataclass
class Command:
    """bus/v1alpha1 Command: async RPC from CLI to controllers."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    action: BusAction = BusAction.SYNC_JOB
    target_object: Optional[dict] = None    # owner reference
    reason: str = ""
    message: str = ""

    KIND = "Command"
