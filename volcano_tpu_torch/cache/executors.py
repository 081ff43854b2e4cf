"""Side-effect executors: Binder/Evictor/StatusUpdater interfaces and the
recording fakes used by action-level tests (mirrors
pkg/scheduler/cache/cache.go:119-312 and the fakes in
pkg/scheduler/util/test_utils.go:96-178)."""

from __future__ import annotations

import threading
from typing import Dict, List

from ..api import TaskInfo


class Binder:
    def bind(self, task: TaskInfo, hostname: str) -> None:
        raise NotImplementedError


class Evictor:
    def evict(self, task: TaskInfo, reason: str) -> None:
        raise NotImplementedError


class StatusUpdater:
    def update_pod_group(self, job) -> None:
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

    def evict(self, task: TaskInfo, reason: str) -> None:
        with self._lock:
            self.evicts.append(task.key())
