"""Side-effect executors: Binder/Evictor/StatusUpdater interfaces, the
recording fakes used by action-level tests, and the ordered recorders the
sim replays against (mirrors pkg/scheduler/cache/cache.go:119-312 and the
fakes in pkg/scheduler/util/test_utils.go:96-178)."""

from __future__ import annotations

import queue
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
    def update_pod_condition(self, task: TaskInfo, condition: dict) -> None:
        pass

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
