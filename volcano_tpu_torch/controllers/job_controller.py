"""Job controller: the Job CR lifecycle engine.

Mirrors Volcano's pkg/controllers/job/{job_controller.go:118-218,
job_controller_actions.go:43-660, job_controller_handler.go:137-400} —
informers on Job/Pod/Command, syncJob (podgroup + pod diff create/delete),
killJob, lifecycle-policy event→action dispatch, and the job plugins
(ssh/svc/env) that mutate pods at creation.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from ..api import BusAction, BusEvent, JobPhase, PodGroupPhase, Resource
from ..apis.objects import (Command, Job, LifecyclePolicy, ObjectMeta, PVC,
                            Pod, PodGroupCR, PodGroupSpec, PodTemplate,
                            TaskSpec)
from ..cache.store_wiring import GROUP_NAME_ANNOTATION
from ..store import ADDED, DELETED, UPDATED, AdmissionError, ObjectStore
from . import job_state
from .framework import Controller
from .job_plugins import plugin_on_job_add, plugin_on_pod_create

TASK_SPEC_ANNOTATION = "volcano.sh/task-spec"
JOB_NAME_ANNOTATION = "volcano.sh/job-name"
TASK_INDEX_ANNOTATION = "volcano.sh/task-index"


def pod_name(job: Job, task: TaskSpec, index: int) -> str:
    return f"{job.metadata.name}-{task.name}-{index}"


def calc_pg_min_resources(job: Job) -> Resource:
    """Sum of the first minAvailable pod requests, tasks in priority order
    (job_controller_actions.go:638-660). Runs on every job sync, so it
    stops at minAvailable instead of materializing all replicas."""
    total = Resource()
    left = job.spec.min_available
    for task in sorted(job.spec.tasks, key=lambda t: -t.template.priority):
        if left <= 0:
            break
        take = min(left, task.replicas)
        r = task.template.resources or Resource()
        for _ in range(take):
            total.add(r)
        left -= take
    return total


class JobController(Controller):
    NAME = "job-controller"

    def __init__(self):
        self.store: ObjectStore = None
        self._lock = threading.RLock()
        # per-job reentrancy guard: a sync writes Job/PodGroup status, whose
        # watch events must not re-enter the same job's state machine (the
        # reference's workqueue naturally dedups; in-process events are
        # synchronous)
        self._in_execute: set = set()
        # jobs with churned pods awaiting a coalesced sync (the workqueue)
        self._dirty: set = set()
        # last observed PodGroup phase per job, for Unknown-transition
        # detection (status writes mutate in place, so watch `old` lies)
        self._pg_phases: dict = {}
        # the job each running state machine holds, by (namespace, name):
        # a handler that the machine's own writes call reads this job, phase
        # moves not yet written included. The Python store hands out its
        # own objects, so there it is the stored job; a store that
        # serializes (the native store) would hand out a copy that predates
        # those moves.
        self._working: dict = {}

    # -- wiring -------------------------------------------------------------

    def initialize(self, store: ObjectStore, **options) -> None:
        self.store = store
        job_state.sync_job = self.sync_job
        job_state.kill_job = self.kill_job
        store.watch("Job", self._on_job)
        store.watch("Pod", self._on_pod)
        store.watch("Command", self._on_command)
        store.watch("PodGroup", self._on_podgroup)
        store.watch("PersistentVolumeClaim", self._on_pvc)

    def _on_job(self, event: str, job: Job, old) -> None:
        if event == ADDED:
            self._execute(job, BusAction.SYNC_JOB)
        elif event == UPDATED:
            # value comparison, not identity: stores that serialize (the
            # native C++ store, a real API server) deliver copies, and a
            # status-only write must not re-trigger sync (handler.go
            # updateJob only reacts to spec changes)
            if old is not None and old.spec != job.spec:
                self._execute(job, BusAction.SYNC_JOB)
        elif event == DELETED:
            self._delete_job_resources(job)

    def _on_pod(self, event: str, pod: Pod, old) -> None:
        job_name = pod.metadata.annotations.get(JOB_NAME_ANNOTATION)
        if not job_name:
            return
        job = self._get_job(pod.metadata.namespace, job_name)
        if job is None:
            return
        bus_event = None
        if event == UPDATED and old is not None:
            if pod.status.phase == "Failed" and old.status.phase != "Failed":
                bus_event = BusEvent.POD_FAILED
            elif (pod.status.phase == "Succeeded"
                  and old.status.phase != "Succeeded"):
                bus_event = BusEvent.TASK_COMPLETED
        elif event == DELETED:
            if pod.status.conditions and any(
                    c.get("type") == "Evicted" for c in pod.status.conditions):
                bus_event = BusEvent.POD_EVICTED
            elif pod.status.phase not in ("Succeeded", "Failed"):
                bus_event = BusEvent.POD_EVICTED
        if bus_event is None:
            # plain churn (creates, phase flips to Running, drains): mark
            # dirty and coalesce — the reference's sharded workqueue dedups
            # job keys exactly like this; syncing per pod event is O(pods^2)
            # at 10k pods
            with self._lock:
                self._dirty.add((pod.metadata.namespace, job_name))
            return
        action = self._policy_action(job, pod, bus_event)
        self._execute(job, action)

    def process_dirty(self) -> int:
        """Sync every job whose pods churned since the last drain — called
        by the controller loop each scheduler period (the workqueue worker
        analogue, job_controller.go:256+)."""
        with self._lock:
            dirty = list(self._dirty)
            self._dirty.clear()
        for ns, name in dirty:
            job = self._get_job(ns, name)
            if job is not None:
                self._execute(job, BusAction.SYNC_JOB)
        return len(dirty)

    def _policy_action(self, job: Job, pod: Pod,
                       event: Optional[BusEvent]) -> BusAction:
        """LifecyclePolicy events→actions (handler.go:137-351,
        job_controller_util.go:170-200): task policies override job
        policies; an exitCode policy matches the pod's termination code,
        an event policy the bus event; default SyncJob."""
        if event is None:
            return BusAction.SYNC_JOB
        exit_code = pod.status.exit_code

        def matches(policy) -> bool:
            # two INDEPENDENT checks (applyPolicies
            # job_controller_util.go:168-200): the event clause when the
            # policy has one, the exit-code clause when it has one —
            # admission guarantees a policy carries exactly one of them
            if policy.event is not None \
                    and policy.event in (event, BusEvent.ANY):
                return True
            return (policy.exit_code is not None and exit_code is not None
                    and exit_code == policy.exit_code)

        task_name = pod.metadata.annotations.get(TASK_SPEC_ANNOTATION, "")
        for task in job.spec.tasks:
            if task.name == task_name:
                for policy in task.policies:
                    if matches(policy):
                        return policy.action
        for policy in job.spec.policies:
            if matches(policy):
                return policy.action
        return BusAction.SYNC_JOB

    def _on_podgroup(self, event: str, pg, old) -> None:
        """Re-sync the owning job whenever its PodGroup is schedulable —
        pods are only created once the group left Pending
        (job_controller_actions.go:263-280 syncTask gate). Status writes
        mutate in place, so `old` cannot be trusted for transition
        detection; the sync is idempotent (desired-vs-existing pod diff)."""
        if event == DELETED:
            self._pg_phases.pop((pg.metadata.namespace, pg.metadata.name),
                                None)
            return
        if event != UPDATED:
            return
        if pg.status.phase == PodGroupPhase.PENDING:
            return
        job = self._get_job(pg.metadata.namespace, pg.metadata.name)
        if job is None:
            return
        # a PodGroup turning Unknown (running members + a fresh
        # Unschedulable condition: the gang split) raises the JobUnknown
        # bus event against the job's lifecycle policies
        # (job_controller_handler.go:405-433); transition-tracked here
        # because status writes mutate in place
        key = (pg.metadata.namespace, pg.metadata.name)
        prev_phase = self._pg_phases.get(key)
        self._pg_phases[key] = pg.status.phase
        if (pg.status.phase == PodGroupPhase.UNKNOWN
                and prev_phase != PodGroupPhase.UNKNOWN):
            action = self._unknown_policy_action(job)
            if action != BusAction.SYNC_JOB:
                self._execute(job, action)
                return
        # only sync when pods are actually missing — sync_job itself writes
        # the PodGroup status, so an unconditional trigger would recurse
        desired = sum(t.replicas for t in job.spec.tasks)
        existing = sum(
            1 for p in self.store.list("Pod", job.metadata.namespace)
            if p.metadata.annotations.get(JOB_NAME_ANNOTATION)
            == job.metadata.name)
        if existing < desired:
            self._execute(job, BusAction.SYNC_JOB)

    def _unknown_policy_action(self, job: Job) -> BusAction:
        for policy in job.spec.policies:
            if policy.event in (BusEvent.JOB_UNKNOWN, BusEvent.ANY):
                return policy.action
        return BusAction.SYNC_JOB

    def _on_pvc(self, event: str, pvc, old) -> None:
        """A job waiting on a referenced-but-missing PVC re-syncs when it
        appears (the reference's pvc informer + error resync)."""
        if event != ADDED:
            return
        for job in self.store.list("Job", pvc.metadata.namespace):
            job = self._get_job(job.metadata.namespace, job.metadata.name)
            if any(v.get("volumeClaimName") == pvc.metadata.name
                   for v in job.spec.volumes):
                self._execute(job, BusAction.SYNC_JOB)

    def _on_command(self, event: str, cmd: Command, old) -> None:
        """Command CR → state-machine action (handler.go:364-400)."""
        if event != ADDED:
            return
        target = cmd.target_object or {}
        if target.get("kind") != "Job":
            return
        job = self._get_job(cmd.metadata.namespace, target.get("name"))
        self.store.delete("Command", cmd.metadata.namespace, cmd.metadata.name)
        if job is None:
            return
        self._execute(job, cmd.action)
        self.store.update_status(job)
        # a Resume lands in Restarting; drive the restart chain
        # (drain -> Pending -> resync) like the reference's requeue
        if job.status.state == JobPhase.RESTARTING:
            self._execute(job, BusAction.SYNC_JOB)

    def _execute(self, job: Job, action: BusAction) -> None:
        # keyed by (job, action, phase): a sync's own status writes must not
        # re-enter the same state, while a nested execute after a genuine
        # phase transition (e.g. Restarting -> Pending resync) proceeds
        key = (job.metadata.namespace, job.metadata.name, action,
               job.status.state)
        held = (job.metadata.namespace, job.metadata.name)
        with self._lock:
            if key in self._in_execute:
                return
            self._in_execute.add(key)
            outer = held not in self._working
            if outer:
                self._working[held] = job
            try:
                job_state.new_state(job).execute(action)
            finally:
                self._in_execute.discard(key)
                if outer:
                    del self._working[held]

    def _get_job(self, namespace: str, name: str) -> Optional[Job]:
        """The job a running state machine holds, else the stored one."""
        job = self._working.get((namespace, name))
        return job if job is not None else self.store.get("Job", namespace,
                                                          name)

    # -- core sync (job_controller_actions.go:206-440) -----------------------

    def sync_job(self, job: Job, next_phase: Callable) -> None:
        if job.status.state in (JobPhase.COMPLETED, JobPhase.FAILED,
                                JobPhase.TERMINATED, JobPhase.ABORTED):
            return
        io_ok = self._initiate_job(job)
        desired: Dict[str, tuple] = {}
        for task in job.spec.tasks:
            for i in range(task.replicas):
                desired[pod_name(job, task, i)] = (task, i)

        existing = {p.metadata.name: p
                    for p in self.store.list("Pod", job.metadata.namespace)
                    if p.metadata.annotations.get(JOB_NAME_ANNOTATION)
                    == job.metadata.name}

        # syncTask gate (job_controller_actions.go:263-280): create pods
        # only once the PodGroup left Pending (the scheduler's enqueue
        # admitted it); the /pods webhook rejects earlier creations
        pg = self.store.get("PodGroup", job.metadata.namespace,
                            job.metadata.name)
        sync_task = io_ok and pg is not None and \
            pg.status.phase != PodGroupPhase.PENDING
        if sync_task:
            for name, (task, i) in desired.items():
                if name not in existing:
                    self._create_pod(job, task, i)
            for name, pod in existing.items():
                if name not in desired:
                    self.store.delete("Pod", job.metadata.namespace, name)

        self._update_status(job)
        prev_state = job.status.state
        job_state._update_phase(job, next_phase(job.status))
        self.store.update_status(job)
        self._sync_podgroup_phase(job)
        # entering a finished phase runs the Finished state once (the
        # reference requeues the job after the status write): finished.go:30
        # drains straggler pods with the Soft retain set
        if job.status.state in (JobPhase.COMPLETED, JobPhase.FAILED,
                                JobPhase.TERMINATED) \
                and job.status.state != prev_state:
            self._execute(job, BusAction.SYNC_JOB)

    def kill_job(self, job: Job, phase: JobPhase,
                 transition: Optional[Callable] = None,
                 retain_phases: tuple = (), retry: bool = False) -> None:
        """Delete the job's pods except those in ``retain_phases``, then
        transition (job_controller_actions.go:43-146: PodRetainPhaseSoft
        keeps Succeeded/Failed pods on abort/terminate/complete;
        PodRetainPhaseNone on restart drains everything). ``retry`` counts
        a restart in the status that this call writes, as the reference's
        RestartJob update function does (state/running.go)."""
        job_state._update_phase(job, phase)
        for pod in self.store.list("Pod", job.metadata.namespace):
            if pod.metadata.annotations.get(JOB_NAME_ANNOTATION) \
                    == job.metadata.name \
                    and pod.status.phase not in retain_phases:
                self.store.delete("Pod", job.metadata.namespace,
                                  pod.metadata.name)
        self._update_status(job)
        if transition is not None:
            job_state._update_phase(job, transition(job.status))
        if retry:
            job.status.retry_count += 1
        self.store.update_status(job)
        # restart cycle continues: once drained, Restarting -> Pending resync
        if job.status.state == JobPhase.PENDING:
            self._execute(job, BusAction.SYNC_JOB)

    def _create_job_io_if_not_exist(self, job: Job) -> bool:
        """PVC lifecycle (createJobIOIfNotExist,
        job_controller_actions.go:442-494): generate claim names, create
        owned PVCs from volumeClaim specs, require referenced PVCs to
        exist — a missing one keeps the job Pending until it appears."""
        ok = True
        for i, volume in enumerate(job.spec.volumes):
            vc_name = volume.get("volumeClaimName", "")
            if not vc_name:
                n = 0
                while True:
                    vc_name = f"{job.metadata.name}-pvc-{i}-{n}"
                    if self.store.get("PersistentVolumeClaim",
                                      job.metadata.namespace,
                                      vc_name) is None:
                        break
                    n += 1
                volume["volumeClaimName"] = vc_name
                if volume.get("volumeClaim") is not None:
                    self.store.create(PVC(
                        metadata=ObjectMeta(
                            name=vc_name,
                            namespace=job.metadata.namespace,
                            owner_references=[{"kind": "Job",
                                               "name": job.metadata.name}]),
                        spec=dict(volume.get("volumeClaim") or {})))
                self.store.update(job)
            elif self.store.get("PersistentVolumeClaim",
                                job.metadata.namespace, vc_name) is None:
                job.status.state_message = (
                    f"pvc {vc_name} is not found, the job will be in the "
                    f"Pending state until the PVC is created")
                ok = False
                continue
            job.status.controlled_resources[f"volume-pvc-{vc_name}"] = vc_name
        return ok

    def _initiate_job(self, job: Job) -> bool:
        """Finalizer + PVCs + PodGroup + plugin OnJobAdd
        (job_controller_actions.go:442-560)."""
        if "volcano.sh/job-finalizer" not in job.metadata.finalizers:
            job.metadata.finalizers.append("volcano.sh/job-finalizer")
        io_ok = self._create_job_io_if_not_exist(job)
        plugin_on_job_add(self.store, job)
        pg = self.store.get("PodGroup", job.metadata.namespace,
                            job.metadata.name)
        min_res = calc_pg_min_resources(job)       # runs on EVERY sync
        if pg is None:
            pg = PodGroupCR(
                metadata=ObjectMeta(name=job.metadata.name,
                                    namespace=job.metadata.namespace,
                                    owner_references=[{
                                        "kind": "Job",
                                        "name": job.metadata.name}]),
                spec=PodGroupSpec(
                    min_member=job.spec.min_available,
                    queue=job.spec.queue,
                    priority_class_name=job.spec.priority_class_name,
                    min_resources=min_res))
            self.store.create(pg)
        elif (pg.spec.min_member != job.spec.min_available
              or pg.spec.priority_class_name != job.spec.priority_class_name
              or pg.spec.min_resources != min_res):
            # job_controller_actions.go:530-636 createOrUpdatePodGroup syncs
            # minMember, minResources AND priorityClassName on job updates —
            # minResources must be compared too, or an elastic template
            # change at constant minAvailable never reaches the scheduler's
            # enqueue quota math
            pg.spec.min_member = job.spec.min_available
            pg.spec.min_resources = min_res
            pg.spec.priority_class_name = job.spec.priority_class_name
            self.store.update(pg)
        return io_ok

    def _create_pod(self, job: Job, task: TaskSpec, index: int) -> None:
        import copy
        template = copy.deepcopy(task.template)
        pod = Pod(
            metadata=ObjectMeta(
                name=pod_name(job, task, index),
                namespace=job.metadata.namespace,
                annotations={
                    GROUP_NAME_ANNOTATION: job.metadata.name,
                    JOB_NAME_ANNOTATION: job.metadata.name,
                    TASK_SPEC_ANNOTATION: task.name,
                    TASK_INDEX_ANNOTATION: str(index),
                },
                owner_references=[{"kind": "Job", "name": job.metadata.name}]),
            template=template,
            scheduler_name=job.spec.scheduler_name)
        # mount the job's volumes into every pod (createJobPod's volume
        # wiring, job_controller_util.go)
        for volume in job.spec.volumes:
            vc_name = volume.get("volumeClaimName")
            if vc_name:
                pod.template.volumes.append(
                    {"claimName": vc_name,
                     "mountPath": volume.get("mountPath", "")})
        plugin_on_pod_create(self.store, job, task, index, pod)
        try:
            self.store.create(pod)
        except (ValueError, AdmissionError):
            pass

    def _update_status(self, job: Job) -> None:
        counts = {"Pending": 0, "Running": 0, "Succeeded": 0, "Failed": 0}
        task_counts: Dict[str, Dict[str, int]] = {}
        for pod in self.store.list("Pod", job.metadata.namespace):
            if pod.metadata.annotations.get(JOB_NAME_ANNOTATION) \
                    != job.metadata.name:
                continue
            counts[pod.status.phase] = counts.get(pod.status.phase, 0) + 1
            task = pod.metadata.annotations.get(TASK_SPEC_ANNOTATION, "")
            task_counts.setdefault(task, {}).setdefault(pod.status.phase, 0)
            task_counts[task][pod.status.phase] += 1
        job.status.pending = counts.get("Pending", 0)
        job.status.running = counts.get("Running", 0)
        job.status.succeeded = counts.get("Succeeded", 0)
        job.status.failed = counts.get("Failed", 0)
        job.status.terminating = 0
        job.status.min_available = job.spec.min_available
        job.status.task_status_count = task_counts
        job.status.version += 1

    def _sync_podgroup_phase(self, job: Job) -> None:
        pg = self.store.get("PodGroup", job.metadata.namespace,
                            job.metadata.name)
        if pg is None:
            return
        pg.status.running = job.status.running
        pg.status.succeeded = job.status.succeeded
        pg.status.failed = job.status.failed
        self.store.update_status(pg)

    def _delete_job_resources(self, job: Job) -> None:
        for pod in self.store.list("Pod", job.metadata.namespace):
            if pod.metadata.annotations.get(JOB_NAME_ANNOTATION) \
                    == job.metadata.name:
                self.store.delete("Pod", job.metadata.namespace,
                                  pod.metadata.name)
        self.store.delete("PodGroup", job.metadata.namespace,
                          job.metadata.name)
