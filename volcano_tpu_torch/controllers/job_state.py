"""Job state machine.

Mirrors Volcano's pkg/controllers/job/state/{factory.go:28-86,
pending.go, running.go:30-60, restarting.go, aborting.go, completing.go,
terminating.go, finished.go} — per-phase State objects transitioning on bus
Actions, with SyncJob/KillJob injected by the controller.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..api import BusAction, JobPhase
from ..apis.objects import Job

# Injected by the job controller (state/factory.go:48-53).
sync_job: Callable = None
kill_job: Callable = None

# state/factory.go:39-44: PodRetainPhaseNone drains everything (restart);
# PodRetainPhaseSoft keeps finished pods (abort/terminate/complete)
POD_RETAIN_PHASE_NONE = ()
POD_RETAIN_PHASE_SOFT = ("Succeeded", "Failed")


class State:
    def __init__(self, job: Job):
        self.job = job

    def execute(self, action: BusAction) -> None:
        raise NotImplementedError


def _update_phase(job: Job, phase: JobPhase, message: str = "") -> None:
    import time
    if job.status.state != phase:
        job.status.state = phase
        job.status.state_message = message
        job.status.state_last_transition = time.time()


class PendingState(State):
    def execute(self, action: BusAction) -> None:
        job = self.job
        if action == BusAction.RESTART_JOB:
            kill_job(job, JobPhase.RESTARTING,
                     retain_phases=POD_RETAIN_PHASE_NONE, retry=True)
        elif action == BusAction.ABORT_JOB:
            kill_job(job, JobPhase.ABORTING,
                     retain_phases=POD_RETAIN_PHASE_SOFT)
        elif action == BusAction.COMPLETE_JOB:
            kill_job(job, JobPhase.COMPLETING,
                     retain_phases=POD_RETAIN_PHASE_SOFT)
        elif action == BusAction.TERMINATE_JOB:
            kill_job(job, JobPhase.TERMINATING,
                     retain_phases=POD_RETAIN_PHASE_SOFT)
        else:
            sync_job(job, lambda status: JobPhase.RUNNING
                     if status.running + status.succeeded
                     >= job.spec.min_available
                     else JobPhase.PENDING)


class RunningState(State):
    def execute(self, action: BusAction) -> None:
        job = self.job
        if action == BusAction.RESTART_JOB:
            kill_job(job, JobPhase.RESTARTING,
                     retain_phases=POD_RETAIN_PHASE_NONE, retry=True)
        elif action == BusAction.ABORT_JOB:
            kill_job(job, JobPhase.ABORTING,
                     retain_phases=POD_RETAIN_PHASE_SOFT)
        elif action == BusAction.TERMINATE_JOB:
            kill_job(job, JobPhase.TERMINATING,
                     retain_phases=POD_RETAIN_PHASE_SOFT)
        elif action == BusAction.COMPLETE_JOB:
            kill_job(job, JobPhase.COMPLETING,
                     retain_phases=POD_RETAIN_PHASE_SOFT)
        else:
            total = sum(t.replicas for t in job.spec.tasks)

            def next_phase(status) -> JobPhase:
                """running.go:54-95: minSuccess early completion, then the
                all-pods-finished verdict (per-task minAvailable success
                minima, minSuccess floor, job minAvailable)."""
                if total == 0:
                    return JobPhase.RUNNING
                min_success = job.spec.min_success
                if min_success is not None \
                        and status.succeeded >= min_success:
                    return JobPhase.COMPLETED
                if status.succeeded + status.failed == total:
                    task_min_total = sum(
                        t.min_available for t in job.spec.tasks
                        if t.min_available is not None)
                    if job.spec.min_available >= task_min_total:
                        for task in job.spec.tasks:
                            if task.min_available is None:
                                continue
                            # running.go's `if taskStatus, ok := ...; ok`
                            # guard: the per-task success minimum only
                            # applies when the task has a status entry at
                            # all (e.g. a replicas=0 task never does)
                            counts = status.task_status_count.get(task.name)
                            if counts is None:
                                continue
                            if counts.get("Succeeded", 0) \
                                    < task.min_available:
                                return JobPhase.FAILED
                    if min_success is not None \
                            and status.succeeded < min_success:
                        return JobPhase.FAILED
                    if status.succeeded >= job.spec.min_available:
                        return JobPhase.COMPLETED
                    return JobPhase.FAILED
                # succeeded tasks keep counting toward the gang
                # (running.go:30-60)
                if status.running + status.succeeded < job.spec.min_available:
                    return JobPhase.PENDING
                return JobPhase.RUNNING

            sync_job(job, next_phase)


class RestartingState(State):
    def execute(self, action: BusAction) -> None:
        job = self.job
        if job.status.retry_count > job.spec.max_retry:
            _update_phase(job, JobPhase.FAILED, "number of retries exceeded")
            return

        def next_phase(status) -> JobPhase:
            if status.terminating or status.pending + status.running \
                    + status.succeeded + status.failed:
                # still draining old pods
                return JobPhase.RESTARTING
            return JobPhase.PENDING

        kill_job(job, JobPhase.RESTARTING, transition=next_phase,
                 retain_phases=POD_RETAIN_PHASE_NONE)


class AbortingState(State):
    def execute(self, action: BusAction) -> None:
        job = self.job
        if action == BusAction.RESUME_JOB:
            _update_phase(job, JobPhase.RESTARTING, "job resumed")
            job.status.retry_count += 1
            return
        kill_job(job, JobPhase.ABORTING,
                 transition=lambda status: JobPhase.ABORTED
                 if not status.terminating else JobPhase.ABORTING,
                 retain_phases=POD_RETAIN_PHASE_SOFT)


class AbortedState(State):
    def execute(self, action: BusAction) -> None:
        if action == BusAction.RESUME_JOB:
            _update_phase(self.job, JobPhase.RESTARTING, "job resumed")
            self.job.status.retry_count += 1
            return
        kill_job(self.job, JobPhase.ABORTED,
                 retain_phases=POD_RETAIN_PHASE_SOFT)


class CompletingState(State):
    def execute(self, action: BusAction) -> None:
        kill_job(self.job, JobPhase.COMPLETING,
                 transition=lambda status: JobPhase.COMPLETED
                 if not status.terminating else JobPhase.COMPLETING,
                 retain_phases=POD_RETAIN_PHASE_SOFT)


class TerminatingState(State):
    def execute(self, action: BusAction) -> None:
        kill_job(self.job, JobPhase.TERMINATING,
                 transition=lambda status: JobPhase.TERMINATED
                 if not status.terminating else JobPhase.TERMINATING,
                 retain_phases=POD_RETAIN_PHASE_SOFT)


class FinishedState(State):
    def execute(self, action: BusAction) -> None:
        # drain any pods still running when the job finished directly (a
        # minSuccess early completion leaves stragglers) — finished.go:30
        # kills with the Soft retain set; TTL deletion is the GC's job
        kill_job(self.job, self.job.status.state,
                 retain_phases=POD_RETAIN_PHASE_SOFT)


_STATES = {
    JobPhase.PENDING: PendingState,
    JobPhase.RUNNING: RunningState,
    JobPhase.RESTARTING: RestartingState,
    JobPhase.ABORTING: AbortingState,
    JobPhase.ABORTED: AbortedState,
    JobPhase.COMPLETING: CompletingState,
    JobPhase.COMPLETED: FinishedState,
    JobPhase.TERMINATING: TerminatingState,
    JobPhase.TERMINATED: FinishedState,
    JobPhase.FAILED: FinishedState,
}


def new_state(job: Job) -> State:
    return _STATES.get(job.status.state, PendingState)(job)
