"""Scheduler cache, executors, synthetic clusters and tensor marshaling."""

from .cache import RateLimitedQueue, SchedulerCache
from .executors import (Binder, Evictor, FakeBinder, FakeEvictor,
                        SequenceBinder, SequenceEvictor, StatusUpdater)
from .journal import IntentJournal
from .transfer import cache_from_world

__all__ = ["SchedulerCache", "RateLimitedQueue", "Binder", "Evictor",
           "FakeBinder", "FakeEvictor", "SequenceBinder", "SequenceEvictor",
           "StatusUpdater", "IntentJournal", "cache_from_world"]
