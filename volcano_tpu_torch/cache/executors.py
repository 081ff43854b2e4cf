"""Side-effect executors: Binder/Evictor/StatusUpdater/VolumeBinder
interfaces, the recording fakes used by action-level tests, the ordered
recorders the sim replays against, and the executors that write back into
an ObjectStore (StoreBinder, StoreEvictor, StoreStatusUpdater,
StoreVolumeBinder) (mirrors pkg/scheduler/cache/cache.go:119-312 and the
fakes in pkg/scheduler/util/test_utils.go:96-178).

Fencing: ``FencingAuthority`` is the cluster-side epoch watermark, the
highest lease fencing epoch any acquisition has published.
``FencedBinder``/``FencedEvictor`` wrap an executor chain and reject any
operation whose caller's epoch is below the watermark (``FencedError``),
so a paused or partitioned ex-leader's late bind cannot reach the cluster:
split-brain safety by construction, not by lease timing."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, List, Optional

from ..api import TaskInfo


class FencedError(RuntimeError):
    """An executor operation carried a fencing epoch below the highest
    the cluster has observed: the caller is a deposed leader. A plain
    Exception on purpose: the cache funnel's rollback path undoes the
    optimistic state, as for any other executor failure."""

    def __init__(self, op: str, epoch: int, current: int):
        super().__init__(
            f"fenced: {op} carries stale fencing epoch {epoch} "
            f"(cluster has observed {current}); a deposed leader may "
            f"not mutate cluster state")
        self.op = op
        self.epoch = epoch
        self.current = current


class FencingAuthority:
    """The cluster's monotonic fencing-epoch watermark (in a deployment,
    the Lease object enforced at admission; in process and in the sim,
    this shared object). Electors call ``advance`` on every successful
    lease write; executor gates call ``check`` before every side
    effect."""

    def __init__(self):
        self._lock = threading.Lock()
        self._current = 0
        self.rejections = 0

    def advance(self, epoch: int) -> None:
        with self._lock:
            if epoch > self._current:
                self._current = epoch

    def current(self) -> int:
        with self._lock:
            return self._current

    def check(self, op: str, epoch: int) -> None:
        """Admit an operation stamped with ``epoch``: raises FencedError
        when it is stale, advances the watermark otherwise (an op from a
        newer leader than any lease write seen proves that leadership
        exists)."""
        with self._lock:
            if epoch < self._current:
                self.rejections += 1
                current = self._current
            else:
                self._current = max(self._current, epoch)
                return
        from .. import metrics
        metrics.register_fencing_rejection(op)
        raise FencedError(op, epoch, current)


class FencingRegistry:
    """Per-partition fencing authorities of a federated control plane:
    each partition's Lease mints its own epoch sequence and each
    partition's executor gate checks against its own watermark.
    Authorities are made on demand and shared by reference."""

    def __init__(self):
        self._lock = threading.Lock()
        self._authorities: Dict[int, FencingAuthority] = {}

    def authority(self, pid: int) -> FencingAuthority:
        with self._lock:
            auth = self._authorities.get(pid)
            if auth is None:
                auth = self._authorities[pid] = FencingAuthority()
            return auth

    def current(self, pid: int) -> int:
        return self.authority(pid).current()

    def rejections(self) -> int:
        """Total stale-epoch rejections across every partition."""
        with self._lock:
            return sum(a.rejections for a in self._authorities.values())


class Binder:
    def bind(self, task: TaskInfo, hostname: str) -> None:
        raise NotImplementedError


class Evictor:
    def evict(self, task: TaskInfo, reason: str) -> None:
        raise NotImplementedError


class FencedBinder(Binder):
    """Binder gate: admits each bind through the authority at the
    caller's current epoch (``epoch_fn``: the replica's elector epoch, 0
    standalone, which the authority rejects only once a real leadership
    exists)."""

    def __init__(self, inner: Binder, epoch_fn: Callable[[], int],
                 authority: FencingAuthority):
        self.inner = inner
        self.epoch_fn = epoch_fn
        self.authority = authority

    def bind(self, task: TaskInfo, hostname: str) -> None:
        self.authority.check("bind", self.epoch_fn())
        self.inner.bind(task, hostname)


class FencedEvictor(Evictor):
    """Evictor twin of FencedBinder."""

    def __init__(self, inner: Evictor, epoch_fn: Callable[[], int],
                 authority: FencingAuthority):
        self.inner = inner
        self.epoch_fn = epoch_fn
        self.authority = authority

    def evict(self, task: TaskInfo, reason: str) -> None:
        self.authority.check("evict", self.epoch_fn())
        self.inner.evict(task, reason)


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
