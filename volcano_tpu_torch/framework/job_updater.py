"""Session-close writeback of PodGroup status, mirroring
pkg/scheduler/framework/job_updater.go:85-108 (the reference
fans out over 16 workers; here the cache write is in-process so a loop
suffices — dedup on unchanged status is kept).
"""

from __future__ import annotations

from ..api import PodGroupPhase, TaskStatus, allocated_status


def _phase_for(job, ssn_uid: str) -> PodGroupPhase:
    """jobStatus (session.go:176-214): running tasks + an Unschedulable
    condition from THIS session -> Unknown; else enough allocated (or
    succeeded) members -> Running; else non-Inqueue groups fall back to
    Pending."""
    if job.podgroup.phase == PodGroupPhase.PENDING:
        return PodGroupPhase.PENDING
    unschedulable = any(
        c.get("type") == "Unschedulable" and c.get("status") == "True"
        and c.get("transitionID") == ssn_uid
        for c in job.podgroup.conditions)
    running = sum(1 for t in job.tasks.values()
                  if t.status == TaskStatus.RUNNING)
    if running and unschedulable:
        return PodGroupPhase.UNKNOWN
    allocated = sum(1 for t in job.tasks.values()
                    if allocated_status(t.status)
                    or t.status == TaskStatus.SUCCEEDED)
    if allocated >= job.min_available and job.min_available > 0:
        return PodGroupPhase.RUNNING
    if job.podgroup.phase != PodGroupPhase.INQUEUE:
        return PodGroupPhase.PENDING
    return job.podgroup.phase


def update_all(ssn) -> None:
    for job in ssn.jobs.values():
        pg = job.podgroup
        running = sum(1 for t in job.tasks.values()
                      if t.status == TaskStatus.RUNNING)
        succeeded = sum(1 for t in job.tasks.values()
                        if t.status == TaskStatus.SUCCEEDED)
        failed = sum(1 for t in job.tasks.values()
                     if t.status == TaskStatus.FAILED)
        new_phase = _phase_for(job, ssn.uid)
        changed = (pg.running != running or pg.succeeded != succeeded
                   or pg.failed != failed or pg.phase != new_phase
                   or pg.conditions_dirty)
        if not changed:
            continue
        pg.running, pg.succeeded, pg.failed = running, succeeded, failed
        pg.phase = new_phase
        pg.conditions_dirty = False
        ssn.cache.update_job_status(job)
