"""Scheduler cache, executors, synthetic clusters and tensor marshaling."""

from .cache import SchedulerCache
from .executors import (Binder, Evictor, FakeBinder, FakeEvictor,
                        StatusUpdater)
from .transfer import cache_from_world

__all__ = ["SchedulerCache", "Binder", "Evictor", "FakeBinder", "FakeEvictor",
           "StatusUpdater", "cache_from_world"]
