"""TaskInfo and JobInfo: the in-memory scheduling model of tasks and gangs.

Mirrors pkg/scheduler/api/pod_info.go and job_info.go:187-600
(gang state: MinAvailable, TaskStatusIndex, ReadyTaskNum, ValidTaskNum,
CheckTaskMinAvailable). A snapshot flattens the pending tasks into a dense
``f32[T, R]`` request tensor for the placement kernel.
"""

from __future__ import annotations

import itertools
import time as _time
from typing import Dict, List, Optional, TYPE_CHECKING

from .resource import Resource
from .types import PodGroupPhase, TaskStatus, allocated_status

if TYPE_CHECKING:
    from .unschedule_info import FitErrors

_uid_counter = itertools.count()


def _new_uid(prefix: str) -> str:
    return f"{prefix}-{next(_uid_counter)}"


def normalize_host_ports(ports) -> List[tuple]:
    """Container hostPort declarations → canonical ``(host_ip, protocol,
    port)`` tuples (the k8s nodeports plugin's GetContainerPorts shape).

    Accepts bare ints, k8s ContainerPort dicts (only entries with
    ``hostPort > 0`` count), or pre-normalized tuples. ``hostIP`` defaults to
    the 0.0.0.0 wildcard and ``protocol`` to TCP, matching upstream."""
    out: List[tuple] = []
    for p in ports or []:
        if isinstance(p, int):
            out.append(("0.0.0.0", "TCP", p))
        elif isinstance(p, dict):
            hp = int(p.get("hostPort") or 0)
            if hp > 0:
                out.append((p.get("hostIP") or "0.0.0.0",
                            p.get("protocol") or "TCP", hp))
        else:
            ip, proto, port = p
            out.append((ip or "0.0.0.0", proto or "TCP", int(port)))
    return out


class TaskInfo:
    """One schedulable unit (a pod in the reference, pod_info.go)."""

    def __init__(self, uid: Optional[str] = None, name: str = "", namespace: str = "default",
                 job: str = "", resreq: Optional[Resource] = None,
                 status: TaskStatus = TaskStatus.PENDING, priority: int = 1,
                 node_name: str = "", task_role: str = "",
                 node_selector: Optional[Dict[str, str]] = None,
                 tolerations: Optional[List[dict]] = None,
                 affinity: Optional[dict] = None,
                 creation_timestamp: Optional[float] = None,
                 host_ports: Optional[List] = None,
                 labels: Optional[Dict[str, str]] = None,
                 annotations: Optional[Dict[str, str]] = None,
                 preemptable: bool = False, revocable_zone: str = "",
                 topology_policy: str = "",
                 pod: object = None):
        self.uid = uid or _new_uid("task")
        self.name = name or self.uid
        self.namespace = namespace
        self.job = job                      # owning JobInfo uid
        self.resreq = resreq.clone() if resreq else Resource()
        # InitResreq: request at admission time; Resreq may be zeroed when the
        # task is running on opportunistic resources. We keep them equal unless
        # a caller changes one.
        self.init_resreq = self.resreq.clone()
        self.status = status
        self.priority = priority
        self.node_name = node_name
        # task_role groups replicas of the same task template; per-template
        # minAvailable (job_info.go TaskMinAvailable) is keyed by it.
        self.task_role = task_role or name
        self.node_selector = dict(node_selector or {})
        self.tolerations = list(tolerations or [])
        self.affinity = affinity or {}
        # any required or preferred pod (anti-)affinity term; affinity never
        # changes after construction, so it is decided once
        self.has_pod_affinity = any(
            (self.affinity.get(kind) or {}).get(term)
            for kind in ("podAffinity", "podAntiAffinity")
            for term in ("requiredDuringSchedulingIgnoredDuringExecution",
                         "preferredDuringSchedulingIgnoredDuringExecution"))
        # (host_ip, protocol, port) tuples the pod claims on its node
        # (nodeports predicate); treated as immutable after construction.
        self.host_ports: List[tuple] = normalize_host_ports(host_ports)
        # what a store-fed task carries of its pod (store_wiring.pod_to_task)
        self.labels = dict(labels or {})
        self.annotations = dict(annotations or {})
        self.preemptable = preemptable
        self.revocable_zone = revocable_zone
        self.topology_policy = topology_policy
        self.pod = pod                      # backing store object, if any
        self.creation_timestamp = creation_timestamp if creation_timestamp is not None else _time.time()

    def clone(self) -> "TaskInfo":
        """Field-sharing copy (the cache snapshot clones every task every
        cycle). resreq / init_resreq are never mutated after construction,
        so sharing them is exact."""
        t = TaskInfo.__new__(TaskInfo)
        t.__dict__.update(self.__dict__)
        return t

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def __repr__(self) -> str:
        return (f"Task({self.namespace}/{self.name} job={self.job} "
                f"status={self.status.name} node={self.node_name!r})")


class PodGroup:
    """Minimal scheduling/v1beta1 PodGroup mirror carried on JobInfo."""

    def __init__(self, name: str = "", namespace: str = "default", queue: str = "default",
                 min_member: int = 0, min_resources: Optional[Resource] = None,
                 phase: PodGroupPhase = PodGroupPhase.PENDING,
                 annotations: Optional[Dict[str, str]] = None,
                 priority_class_name: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.namespace = namespace
        self.queue = queue
        self.min_member = min_member
        self.min_resources = min_resources
        self.priority_class_name = priority_class_name
        self.phase = phase
        self.annotations = dict(annotations or {})
        self.labels = dict(labels or {})
        self.conditions: List[dict] = []
        self.conditions_dirty = False
        self.running = 0
        self.succeeded = 0
        self.failed = 0


class DisruptionBudget:
    """JobInfo disruption budget (job_info.go:354-365): an int or a
    percentage string each."""

    def __init__(self, min_available=None, max_unavailable=None):
        self.min_available = min_available
        self.max_unavailable = max_unavailable


class JobInfo:
    """A gang: the scheduler-side view of one PodGroup and its tasks."""

    def __init__(self, uid: Optional[str] = None, name: str = "",
                 namespace: str = "default", queue: str = "default",
                 priority: int = 0, min_available: int = 0,
                 podgroup: Optional[PodGroup] = None,
                 creation_timestamp: Optional[float] = None):
        self.uid = uid or _new_uid("job")
        self.name = name or self.uid
        self.namespace = namespace
        self.queue = queue
        self.priority = priority
        self.min_available = min_available

        self.job_fit_errors = ""
        self.nodes_fit_errors: Dict[str, "FitErrors"] = {}

        self.tasks: Dict[str, TaskInfo] = {}
        self.task_status_index: Dict[TaskStatus, Dict[str, TaskInfo]] = {}
        self.task_min_available: Dict[str, int] = {}
        self.task_min_available_total = 0

        self.allocated = Resource()
        self.total_request = Resource()

        self.creation_timestamp = creation_timestamp if creation_timestamp is not None else _time.time()
        # when the cache ingested the job (SchedulerCache.add_job stamps it
        # from the cache's clock)
        self.schedule_start_timestamp: Optional[float] = None
        # the job's preemptable and revocable-zone annotations, as the
        # snapshot wire carries them (rpc/codec.py)
        self.preemptable = False
        self.revocable_zone = ""
        # the sla plugin's per-job waiting time in seconds (ahead of the
        # podgroup's sla-waiting-time annotation), and the disruption budget
        # the tdm plugin bounds its evictions by
        self.waiting_time: Optional[float] = None
        self.budget: Optional[DisruptionBudget] = None
        self.podgroup = podgroup or PodGroup(name=self.name, namespace=namespace,
                                             queue=queue, min_member=min_available)
        # Mutation witness for the incremental snapshot (cache/cache.py):
        # every task-state mutation funnels through _add_index/_del_index
        # (add_task_info, update_task_status, delete_task_info, the fused
        # batched replay), so the flag marks any job whose gang state moved
        # since clone().
        self._touched = False

    # -- task bookkeeping (job_info.go:375-437) -----------------------------

    def _add_index(self, task: TaskInfo) -> None:
        self._touched = True
        self.task_status_index.setdefault(task.status, {})[task.uid] = task

    def _del_index(self, task: TaskInfo) -> None:
        self._touched = True
        bucket = self.task_status_index.get(task.status)
        if bucket is not None:
            bucket.pop(task.uid, None)
            if not bucket:
                del self.task_status_index[task.status]

    def add_task_info(self, task: TaskInfo) -> None:
        task.job = self.uid
        self.tasks[task.uid] = task
        self._add_index(task)
        if task.status == TaskStatus.PENDING or allocated_status(task.status):
            self.total_request.add(task.resreq)
        if allocated_status(task.status):
            self.allocated.add(task.resreq)

    def delete_task_info(self, task: TaskInfo) -> None:
        own = self.tasks.pop(task.uid, None)
        if own is None:
            return
        if allocated_status(own.status):
            self.allocated.sub(own.resreq)
        if own.status == TaskStatus.PENDING or allocated_status(own.status):
            self.total_request.sub(own.resreq)
        self._del_index(own)

    def update_task_status(self, task: TaskInfo, status: TaskStatus) -> None:
        own = self.tasks.get(task.uid)
        if own is None:
            raise KeyError(f"task {task.uid} not in job {self.uid}")
        # sub-then-add of the same resreq is a no-op: only cross the
        # allocated boundary (hot at 10k binds/cycle, e.g. BINDING->BOUND)
        was = allocated_status(own.status)
        now = allocated_status(status)
        if was and not now:
            self.allocated.sub(own.resreq)
        self._del_index(own)
        own.status = status
        if now and not was:
            self.allocated.add(own.resreq)
        self._add_index(own)

    # -- gang state (job_info.go:509-600) -----------------------------------

    def ready_task_num(self) -> int:
        """Allocated/Bound/Binding/Running + Succeeded + best-effort Pending."""
        occupied = 0
        for status, tasks in self.task_status_index.items():
            if allocated_status(status) or status == TaskStatus.SUCCEEDED:
                occupied += len(tasks)
            elif status == TaskStatus.PENDING:
                occupied += sum(1 for t in tasks.values() if t.init_resreq.is_empty())
        return occupied

    def waiting_task_num(self) -> int:
        return len(self.task_status_index.get(TaskStatus.PIPELINED, {}))

    def ready(self) -> bool:
        return self.ready_task_num() >= self.min_available

    def valid_task_num(self) -> int:
        occupied = 0
        for status, tasks in self.task_status_index.items():
            if (allocated_status(status) or status in
                    (TaskStatus.SUCCEEDED, TaskStatus.PIPELINED, TaskStatus.PENDING)):
                occupied += len(tasks)
        return occupied

    def check_task_min_available(self) -> bool:
        """Per-task-template minAvailable check (job_info.go:543-570)."""
        if self.min_available < self.task_min_available_total:
            return True
        actual: Dict[str, int] = {}
        for status, tasks in self.task_status_index.items():
            if (allocated_status(status) or status in
                    (TaskStatus.SUCCEEDED, TaskStatus.PIPELINED, TaskStatus.PENDING)):
                for t in tasks.values():
                    actual[t.task_role] = actual.get(t.task_role, 0) + 1
        for role, min_avail in self.task_min_available.items():
            if actual.get(role, 0) < min_avail:
                return False
        return True

    def get_min_resources(self) -> Resource:
        if self.podgroup and self.podgroup.min_resources is not None:
            return self.podgroup.min_resources.clone()
        return Resource()

    def fit_error(self) -> str:
        """Aggregate pending-reason string (job_info.go:489-507)."""
        counts: Dict[TaskStatus, int] = {}
        for status, tasks in self.task_status_index.items():
            counts[status] = len(tasks)
        sorted_counts = ", ".join(
            f"{n} {s.name}" for s, n in sorted(counts.items(), key=lambda kv: kv[0]))
        return f"job is not ready, task statuses: {sorted_counts}"

    def clone(self) -> "JobInfo":
        job = JobInfo(uid=self.uid, name=self.name, namespace=self.namespace,
                      queue=self.queue, priority=self.priority,
                      min_available=self.min_available, podgroup=self.podgroup,
                      creation_timestamp=self.creation_timestamp)
        job.schedule_start_timestamp = self.schedule_start_timestamp
        job.preemptable = self.preemptable
        job.revocable_zone = self.revocable_zone
        job.waiting_time = self.waiting_time
        job.budget = self.budget
        job.task_min_available = dict(self.task_min_available)
        job.task_min_available_total = self.task_min_available_total
        for task in self.tasks.values():
            job.add_task_info(task.clone())
        job._touched = False        # a fresh clone starts clean
        return job

    def __repr__(self) -> str:
        return (f"Job({self.namespace}/{self.name} queue={self.queue} "
                f"minAvailable={self.min_available} tasks={len(self.tasks)})")
