"""Informer wiring: ObjectStore events → SchedulerCache mutations.

Mirrors pkg/scheduler/cache/event_handlers.go:47-880 (AddPod,
AddPodGroupV1beta1, AddQueueV1beta1, AddNode...) with the in-process store as
the watch source. Pods carry their gang membership in the
``scheduling.k8s.io/group-name`` annotation exactly like the reference
(pg_controller_handler.go:52-71).
"""

from __future__ import annotations

from typing import Callable, Optional

from ..api import (JobInfo, NodeInfo, PodGroup, PodGroupPhase, QueueInfo,
                   Resource, TaskInfo, TaskStatus)
from ..apis.objects import Pod, PodGroupCR, QueueCR
from ..store import ADDED, DELETED, UPDATED, ObjectStore
from .cache import SchedulerCache
from .executors import (StoreBinder, StoreEvictor, StoreStatusUpdater,
                        StoreVolumeBinder)

GROUP_NAME_ANNOTATION = "scheduling.k8s.io/group-name"


def pod_status(pod: Pod) -> TaskStatus:
    """Pod phase + nodeName → TaskStatus (the reference's getTaskStatus)."""
    phase = pod.status.phase
    if phase == "Running":
        return TaskStatus.RUNNING
    if phase == "Succeeded":
        return TaskStatus.SUCCEEDED
    if phase == "Failed":
        return TaskStatus.FAILED
    if pod.status.node_name:
        return TaskStatus.BOUND
    return TaskStatus.PENDING


def pod_to_task(pod: Pod) -> TaskInfo:
    group = pod.metadata.annotations.get(GROUP_NAME_ANNOTATION, "")
    job_uid = f"{pod.metadata.namespace}/{group}" if group else ""
    tpl = pod.template
    return TaskInfo(
        uid=pod.metadata.uid, name=pod.metadata.name,
        namespace=pod.metadata.namespace, job=job_uid,
        resreq=tpl.resources.clone() if tpl.resources else Resource(),
        status=pod_status(pod), priority=tpl.priority,
        node_name=pod.status.node_name,
        task_role=pod.metadata.annotations.get("volcano.sh/task-spec",
                                               pod.metadata.name),
        node_selector=tpl.node_selector, tolerations=tpl.tolerations,
        affinity=tpl.affinity, labels=tpl.labels,
        annotations=pod.metadata.annotations,
        preemptable=pod.metadata.annotations.get(
            "volcano.sh/preemptable", "false") == "true",
        revocable_zone=pod.metadata.annotations.get(
            "volcano.sh/revocable-zone", ""),
        topology_policy=pod.metadata.annotations.get(
            "volcano.sh/numa-topology-policy", ""),
        creation_timestamp=pod.metadata.creation_timestamp,
        host_ports=[p for c in tpl.containers
                    for p in c.get("ports", [])],
        pod=pod)


def podgroup_to_job(pg: PodGroupCR) -> JobInfo:
    uid = f"{pg.metadata.namespace}/{pg.metadata.name}"
    mirror = PodGroup(name=pg.metadata.name, namespace=pg.metadata.namespace,
                      queue=pg.spec.queue, min_member=pg.spec.min_member,
                      min_resources=pg.spec.min_resources,
                      priority_class_name=pg.spec.priority_class_name,
                      phase=pg.status.phase,
                      annotations=pg.metadata.annotations,
                      labels=pg.metadata.labels)
    job = JobInfo(uid=uid, name=pg.metadata.name,
                  namespace=pg.metadata.namespace, queue=pg.spec.queue,
                  min_available=pg.spec.min_member, podgroup=mirror,
                  creation_timestamp=pg.metadata.creation_timestamp)
    return job


def wire_cache_to_store(store: ObjectStore,
                        cache: Optional[SchedulerCache] = None,
                        resumable: Optional[bool] = None,
                        event_filter: Optional[Callable] = None,
                        ) -> SchedulerCache:
    """Subscribe a SchedulerCache to the store; side effects write back via
    StoreBinder/StoreEvictor (the REST-out half of the bus).

    ``store`` may be the raw ObjectStore or the production transport
    composition (store_transport.RetryingStoreTransport over it) — the
    executors write through whatever is handed in, which is how every
    scheduler-side store write rides the retry funnel (vlint VT016).

    ``resumable`` wraps each watch in a cache/watches.ResumableWatch
    (resourceVersion tracking, torn-stream resume, 410-Gone relist — the
    informer contract) and attaches the WatchManager as
    ``cache.watch_manager`` so the scheduler epilogue can drive stream
    upkeep. Default: on whenever the store supports consistent lists
    (list_with_rv); pass False to force the legacy direct wiring.

    ``event_filter(kind, obj) -> bool`` scopes Pod/PodGroup ingestion —
    the server-side filtered watch of a federated deployment (each
    partition's cache holds only its queue subset's jobs,
    docs/federation.md). The filter must be STABLE per object (queue
    ownership does not move outside the drain funnel, which schedules
    the queue on NO partition until the flip)."""
    if cache is None:
        cache = SchedulerCache(binder=StoreBinder(store),
                               evictor=StoreEvictor(store),
                               status_updater=StoreStatusUpdater(store),
                               volume_binder=StoreVolumeBinder(store))

    # PriorityClass name -> value, resolved into JobInfo.priority
    # (event_handlers.go AddPriorityClass:633)
    priorities: dict = {}

    def on_priority_class(event: str, pc, old) -> None:
        if event in (ADDED, UPDATED):
            priorities[pc.metadata.name] = pc.value
        elif event == DELETED:
            priorities.pop(pc.metadata.name, None)
        for job in cache.jobs.values():
            if job.podgroup is not None and \
                    job.podgroup.priority_class_name in priorities:
                value = priorities[job.podgroup.priority_class_name]
                if job.priority != value:
                    job.priority = value
                    cache.mark_job_dirty(job.uid)

    def on_pod(event: str, pod: Pod, old: Optional[Pod]) -> None:
        task = pod_to_task(pod)
        if not task.job:
            return
        if event == ADDED:
            _ensure_job(cache, task.job, pod.metadata.namespace)
            cache.add_task(task)
        elif event == UPDATED:
            old_task = pod_to_task(old) if old is not None else None
            if old_task is not None and old_task.job == task.job:
                job = cache.jobs.get(task.job)
                if job is not None and task.uid in job.tasks:
                    cached = job.tasks[task.uid]
                    prev_status = cached.status
                    new_status = pod_status(pod)
                    if not cached.node_name and pod.status.node_name:
                        # bound elsewhere (scheduler restart recovery)
                        cache.delete_task(cached)
                        cache.add_task(task)
                    elif prev_status != new_status:
                        # status flips enter through the FeedbackChannel
                        # normalizer (vlint VT017): the RUNNING flip is
                        # the kubelet ack — stale/duplicate replays off
                        # a resumed stream must not resurrect a dead
                        # placement (docs/robustness.md feedback
                        # failure model)
                        cache.feedback.pod_status_event(cached, new_status)
                    return
            _ensure_job(cache, task.job, pod.metadata.namespace)
            cache.add_task(task)
        elif event == DELETED:
            job = cache.jobs.get(task.job)
            if job is not None and task.uid in job.tasks:
                cache.delete_task(job.tasks[task.uid])
                if not job.tasks and job.podgroup is None:
                    # the PodGroup went first and this was the last pod:
                    # drop the empty shell so a long-running store-wired
                    # cache (and the sim's drain check) doesn't hold one
                    # JobInfo per completed job forever
                    cache.remove_job(task.job)

    def on_podgroup(event: str, pg: PodGroupCR, old) -> None:
        uid = f"{pg.metadata.namespace}/{pg.metadata.name}"
        if event in (ADDED, UPDATED):
            existing = cache.jobs.get(uid)
            fresh = podgroup_to_job(pg)
            fresh.priority = priorities.get(pg.spec.priority_class_name, 0)
            if existing is None:
                cache.add_job(fresh)
            else:
                existing.podgroup = fresh.podgroup
                existing.min_available = fresh.min_available
                existing.queue = fresh.queue
                existing.priority = fresh.priority
                cache.mark_job_dirty(uid)
        elif event == DELETED:
            job = cache.jobs.get(uid)
            if job is not None:
                job.podgroup = None
                cache.mark_job_dirty(uid)
                if not job.tasks:
                    # no pods left either: the job is fully gone
                    cache.remove_job(uid)

    def on_queue(event: str, q: QueueCR, old) -> None:
        if event in (ADDED, UPDATED):
            cache.add_queue(QueueInfo(
                uid=q.metadata.name, name=q.metadata.name,
                weight=q.spec.weight, capability=q.spec.capability,
                reclaimable=q.spec.reclaimable, state=q.status.state,
                annotations=q.metadata.annotations))
        elif event == DELETED:
            cache.remove_queue(q.metadata.name)

    def on_resource_quota(event: str, quota, old) -> None:
        # namespace weights for drf's namespace fairness
        # (event_handlers.go:740-837)
        if event == DELETED:
            cache.delete_resource_quota(quota)
        else:
            cache.add_resource_quota(quota)

    if event_filter is not None:
        def _filtered(kind, handler):
            def wrapped(event, obj, old):
                if not event_filter(kind, obj):
                    return
                handler(event, obj, old)
            return wrapped
        on_pod = _filtered("Pod", on_pod)
        on_podgroup = _filtered("PodGroup", on_podgroup)

    handlers = [("ResourceQuota", on_resource_quota),
                ("PriorityClass", on_priority_class),
                ("Pod", on_pod),
                ("PodGroup", on_podgroup),
                ("Queue", on_queue)]
    if resumable is None:
        resumable = hasattr(store, "list_with_rv") \
            and hasattr(store, "current_rv")
    if resumable:
        from .watches import WatchManager
        manager = WatchManager(store)
        for kind, handler in handlers:
            manager.add(kind, handler)
        cache.watch_manager = manager
    else:
        for kind, handler in handlers:
            store.watch(kind, handler)
    return cache


def _ensure_job(cache: SchedulerCache, job_uid: str, namespace: str) -> None:
    """Pods may arrive before their PodGroup (event_handlers.go
    getOrCreateJob); create a placeholder job that the PodGroup event
    completes."""
    if job_uid not in cache.jobs:
        name = job_uid.split("/", 1)[1]
        job = JobInfo(uid=job_uid, name=name, namespace=namespace)
        job.podgroup = None
        cache.add_job(job)
