"""Garbage collector: TTLSecondsAfterFinished job cleanup.

Mirrors Volcano's pkg/controllers/garbagecollector/
garbagecollector.go:70-296 — finished jobs past their TTL are deleted after
a freshness re-check.
"""

from __future__ import annotations

import time
from typing import List

from ..api import JobPhase
from ..apis.objects import Job
from ..store import ObjectStore
from .framework import Controller

FINISHED = (JobPhase.COMPLETED, JobPhase.FAILED, JobPhase.TERMINATED,
            JobPhase.ABORTED)


class GarbageCollector(Controller):
    NAME = "gc-controller"

    def __init__(self):
        self.store: ObjectStore = None

    def initialize(self, store: ObjectStore, **options) -> None:
        self.store = store

    def needs_cleanup(self, job: Job, now: float = None) -> bool:
        if job.spec.ttl_seconds_after_finished is None:
            return False
        if job.status.state not in FINISHED:
            return False
        now = now if now is not None else time.time()
        expiry = (job.status.state_last_transition
                  + job.spec.ttl_seconds_after_finished)
        return now >= expiry

    def process(self, now: float = None) -> List[str]:
        """One GC sweep; returns deleted job keys. The reference requeues on
        a timer — callers (tests, the controller-manager loop) drive this."""
        deleted = []
        for job in list(self.store.list("Job")):
            # freshness double-check (garbagecollector.go:200-240)
            fresh = self.store.get("Job", job.metadata.namespace,
                                   job.metadata.name)
            if fresh is None or not self.needs_cleanup(fresh, now):
                continue
            self.store.delete("Job", fresh.metadata.namespace,
                              fresh.metadata.name)
            deleted.append(fresh.metadata.key())
        return deleted
