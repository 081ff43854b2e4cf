"""Side-effect executors: Binder/Evictor/StatusUpdater/VolumeBinder
interfaces, the recording fakes used by action-level tests, the ordered
recorders the sim replays against, and the executors that write back into
an ObjectStore (StoreBinder, StoreEvictor, StoreStatusUpdater,
StoreVolumeBinder) (mirrors pkg/scheduler/cache/cache.go:119-312 and the
fakes in pkg/scheduler/util/test_utils.go:96-178)."""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional

from ..api import TaskInfo


class Binder:
    def bind(self, task: TaskInfo, hostname: str) -> None:
        raise NotImplementedError


class Evictor:
    def evict(self, task: TaskInfo, reason: str) -> None:
        raise NotImplementedError


class StatusUpdater:
    def update_pod_condition(self, task: TaskInfo, condition: dict) -> None:
        pass

    def update_pod_group(self, job) -> None:
        pass


class VolumeBinder:
    def get_pod_volumes(self, task: TaskInfo, node) -> Optional[object]:
        return None

    def allocate_volumes(self, task: TaskInfo, hostname: str, volumes) -> None:
        pass

    def bind_volumes(self, task: TaskInfo, volumes) -> None:
        pass


class FakeBinder(Binder):
    """Records ns/name -> node (test_utils.go:96-110)."""

    def __init__(self):
        self.binds: Dict[str, str] = {}
        self._lock = threading.Lock()

    def bind(self, task: TaskInfo, hostname: str) -> None:
        with self._lock:
            self.binds[task.key()] = hostname


class FakeEvictor(Evictor):
    """Records evicted task keys (test_utils.go:112-140)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.evicts: List[str] = []
        self.channel: "queue.Queue[str]" = queue.Queue()

    def evict(self, task: TaskInfo, reason: str) -> None:
        with self._lock:
            self.evicts.append(task.key())
        self.channel.put(task.key())


class SequenceBinder(FakeBinder):
    """FakeBinder that also records the ORDER of successful binds as
    (task uid, node) pairs — the simulator's determinism witness
    (volcano_tpu_torch/sim/runner.py): two replays of the same trace+seed must
    produce identical sequences, and the sim's post-cycle feedback walks
    the tail of this list to ack binds into RUNNING state."""

    def __init__(self):
        super().__init__()
        self.sequence: List[tuple] = []

    def bind(self, task: TaskInfo, hostname: str) -> None:
        super().bind(task, hostname)
        with self._lock:
            self.sequence.append((task.uid, hostname))


class SequenceEvictor(FakeEvictor):
    """FakeEvictor recording eviction order by task uid (see
    SequenceBinder)."""

    def __init__(self):
        super().__init__()
        self.sequence: List[str] = []

    def evict(self, task: TaskInfo, reason: str) -> None:
        super().evict(task, reason)
        with self._lock:
            self.sequence.append(task.uid)


class FakeStatusUpdater(StatusUpdater):
    pass


class FakeVolumeBinder(VolumeBinder):
    pass


class StoreBinder(Binder):
    """Binder that writes the bind back into an ObjectStore (the in-process
    analogue of POSTing pods/<p>/binding to the API server, cache.go:124-138)."""

    def __init__(self, store):
        self.store = store

    def bind(self, task: TaskInfo, hostname: str) -> None:
        self.store.bind_pod(task.namespace, task.name, hostname)


class StoreEvictor(Evictor):
    def __init__(self, store):
        self.store = store

    def evict(self, task: TaskInfo, reason: str) -> None:
        self.store.evict_pod(task.namespace, task.name, reason)


class StoreVolumeBinder(VolumeBinder):
    """Volume binder over store PVC objects — the in-process analogue of
    the k8s SchedulerVolumeBinder wrap (cache.go:241-273): GetPodVolumes
    finds the pod's unbound claims, AllocateVolumes assumes them onto the
    host (task.volume_ready mirrors the reference's VolumeReady), and
    BindVolumes commits Pending -> Bound."""

    def __init__(self, store):
        self.store = store

    def _claims(self, task: TaskInfo):
        pod = getattr(task, "pod", None)
        template = getattr(pod, "template", None)
        for v in getattr(template, "volumes", None) or []:
            name = v.get("claimName")
            if not name:
                continue
            pvc = self.store.get("PersistentVolumeClaim", task.namespace,
                                 name)
            if pvc is not None:
                yield pvc

    def get_pod_volumes(self, task: TaskInfo, node) -> Optional[list]:
        unbound = [p for p in self._claims(task)
                   if p.status.phase != "Bound"]
        return unbound or None

    def allocate_volumes(self, task: TaskInfo, hostname: str, volumes) -> None:
        for pvc in volumes or []:
            pvc.status.node = hostname
        task.volume_ready = not volumes

    def bind_volumes(self, task: TaskInfo, volumes) -> None:
        if task.volume_ready:
            return
        for pvc in volumes or []:
            pvc.status.phase = "Bound"
            pvc.status.node = task.node_name
            self.store.update_status(pvc)


class StoreStatusUpdater(StatusUpdater):
    """Writes PodGroup status back to the store (the jobUpdater's
    UpdatePodGroup PUT, job_updater.go:95-108)."""

    def __init__(self, store):
        self.store = store

    def update_pod_group(self, job) -> None:
        pg = self.store.get("PodGroup", job.namespace, job.podgroup.name)
        if pg is None:
            return
        pg.status.phase = job.podgroup.phase
        pg.status.conditions = list(job.podgroup.conditions)
        # forward-cluster and similar scheduler-written annotations
        # propagate with the status (podgroupBinder, cache.go:275-312)
        for k, v in job.podgroup.annotations.items():
            pg.metadata.annotations.setdefault(k, v)
        # FailedScheduling events for unschedulable gangs (the cache's
        # EventRecorder emissions, cache.go:597-641)
        if hasattr(self.store, "record_event"):
            for c in pg.status.conditions:
                if c.get("type") == "Unschedulable" \
                        and c.get("status") == "True":
                    self.store.record_event(
                        "PodGroup", job.namespace, job.podgroup.name,
                        "Warning", "FailedScheduling",
                        c.get("message", ""))
                    break
        self.store.update_status(pg)
