"""The lifecycle command funnel: suspend, resume and scale, journaled and
fenced.

Operators (the sim's ``job_command`` events, tests) submit verbs against a
gang; nothing the scheduler reads changes at submit time. The scheduler
shell drains the funnel once a cycle, at the cycle boundary before the
snapshot opens, so no cycle sees half a command.

- ``submit()`` journals a ``command`` control record stamped with the
  current fencing epoch before the verb is queued; a submit carrying a
  stale expected epoch is rejected.
- ``consume()`` applies each verb as an annotation rewrite on the live
  job, marks the job dirty for the incremental snapshot and journals a
  ``command_applied`` record; a verb against a job that left is dropped
  (journaled ``command_dropped``).
- suspend evicts nothing here: the drain runs through grow-shrink's
  session evict path, the journaled evict funnel.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional, Tuple

from .membership import ELASTIC_DESIRED_ANNOTATION, SUSPEND_ANNOTATION

log = logging.getLogger(__name__)

VERBS = ("suspend", "resume", "scale")


class CommandFunnel:
    """A single-consumer command queue bound to one SchedulerCache."""

    def __init__(self, cache):
        self._cache = cache
        self._lock = threading.Lock()
        self._pending: List[Tuple[str, str, Optional[int]]] = []
        self.submitted = 0
        self.rejected = 0
        self.applied = 0
        self.dropped = 0

    def submit(self, verb: str, job_uid: str, value: Optional[int] = None,
               expected_epoch: Optional[int] = None) -> bool:
        """Queue a lifecycle verb. Returns False, and queues nothing, when
        ``expected_epoch`` is not the cache's fencing epoch: the submitter
        lost a leadership race."""
        if verb not in VERBS:
            raise ValueError(f"unknown command verb {verb!r}")
        if verb == "scale":
            if value is None:
                raise ValueError("scale requires a member-count value")
            value = int(value)
            if value < 0:
                raise ValueError("scale value must be >= 0")
        else:
            value = None
        epoch = self._cache.fencing_epoch()
        if expected_epoch is not None and expected_epoch != epoch:
            with self._lock:
                self.rejected += 1
            log.warning("command %s(%s) rejected: epoch %s != current %s",
                        verb, job_uid, expected_epoch, epoch)
            return False
        journal = getattr(self._cache, "journal", None)
        if journal is not None:
            journal.record_control("command", {
                "verb": verb, "job": job_uid, "value": value, "epoch": epoch})
        with self._lock:
            self._pending.append((verb, job_uid, value))
            self.submitted += 1
        return True

    def consume(self) -> int:
        """Drain and apply every queued verb against the live cache, under
        the cache lock. Returns the number applied."""
        with self._lock:
            batch, self._pending = list(self._pending), []
        if not batch:
            return 0
        cache = self._cache
        journal = getattr(cache, "journal", None)
        applied = dropped = 0
        with cache._lock:
            for verb, job_uid, value in batch:
                job = cache.jobs.get(job_uid)
                fields = {"verb": verb, "job": job_uid, "value": value,
                          "epoch": cache.fencing_epoch()}
                if job is None or getattr(job, "podgroup", None) is None:
                    dropped += 1
                    if journal is not None:
                        journal.record_control("command_dropped", fields)
                    log.warning("command %s(%s) dropped: job gone",
                                verb, job_uid)
                    continue
                ann = job.podgroup.annotations
                if verb == "suspend":
                    ann[SUSPEND_ANNOTATION] = "true"
                elif verb == "resume":
                    ann.pop(SUSPEND_ANNOTATION, None)
                else:
                    ann[ELASTIC_DESIRED_ANNOTATION] = str(value)
                cache.mark_job_dirty(job.uid)
                if journal is not None:
                    journal.record_control("command_applied", fields)
                applied += 1
        with self._lock:
            self.applied += applied
            self.dropped += dropped
        return applied

    def resolve_job(self, name: str, namespace: str = "default"
                    ) -> Optional[str]:
        """An operator-facing job name as the cache's job uid: a raw uid,
        the namespace-qualified form, or a (namespace, name) match."""
        jobs = self._cache.jobs
        if name in jobs:
            return name
        qualified = f"{namespace}/{name}"
        if qualified in jobs:
            return qualified
        for uid, job in jobs.items():
            if getattr(job, "name", None) == name and \
                    getattr(job, "namespace", "default") == namespace:
                return uid
        return None

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def stats(self) -> dict:
        with self._lock:
            return {"submitted": self.submitted, "applied": self.applied,
                    "rejected": self.rejected, "dropped": self.dropped,
                    "pending": len(self._pending)}
