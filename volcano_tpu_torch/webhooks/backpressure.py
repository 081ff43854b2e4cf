"""Admission backpressure: the bounded pending-work budget of the front
door, the JAX package's ``webhooks/backpressure.py``.

Under sustained overload the accepted-but-unscheduled backlog is what grows
without bound: cache memory, snapshot cost and solve cost all scale with
it. ``AdmissionBudget`` bounds it at the door, the one place the system can
still say no cheaply:

- **per-queue depth**: each queue may carry at most ``max_queue_depth``
  accepted-but-unscheduled tasks;
- **global bytes**: the whole pending set may cost at most
  ``max_total_bytes`` (estimated, see ``estimate_job_bytes``);
- **priority-aware shedding**: past the ``shed_watermark`` fill fraction a
  priority floor rises linearly with fill, so the LOWEST priority batches
  are refused first and high-priority work still lands up to the hard
  limit;
- **retry-after hints**: every refusal carries ``retry_after_s``, derived
  from the observed drain throughput (an EWMA the caller feeds with
  per-cycle drained tasks), so clients back off in proportion to the
  actual excess.

Refusals are a typed :class:`BackpressureError` (the 429 of the in-process
apiserver; it subclasses the store's ``AdmissionError``) and are counted in
``metrics``' ``admission_backpressure`` counter by reason.

Accounting contract: ``admit_batch`` at acceptance, ``credit`` when the
work leaves the pending set; the caller feeds ``observe_drain`` so the
retry hints track real throughput. Every timestamp rides the injectable
``time_fn``; the seeded ``chaos.OverloadInjector`` drives the budget
deterministically in the sim's overload runs. The batched front door
``webhooks/admission.py::submit_job_batch`` charges it.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..store import AdmissionError

DEFAULT_MAX_QUEUE_DEPTH = 10_000
DEFAULT_MAX_TOTAL_BYTES = 256 * (1 << 20)
DEFAULT_SHED_WATERMARK = 0.75
# interpolation ceiling for the shed floor: queue fill rising from the
# watermark to 1.0 raises the floor 0 -> PRIORITY_CEIL, so priority-10
# work still lands until the queue is genuinely full
PRIORITY_CEIL = 10
# retry hints are capped: with no observed throughput yet the raw
# excess/throughput quotient is unbounded, and an unbounded hint parks
# clients forever on a system that is about to recover
MAX_RETRY_AFTER_CYCLES = 64

# byte-estimate model for a Job CR: metadata + spec overhead plus a
# per-task envelope (pod template, resources, policies) — deliberately
# coarse; the budget bounds growth, it does not meter heap bytes
_JOB_OVERHEAD_B = 512
_TASK_OVERHEAD_B = 256


class BackpressureError(AdmissionError):
    """Typed 429: the bounded pending-work budget refused the
    submission. ``reason`` is ``queue_depth`` | ``bytes`` |
    ``priority_shed``; ``retry_after_s`` is the drain-derived hint."""

    def __init__(self, message: str, reason: str, queue: str = "",
                 retry_after_s: float = 0.0,
                 priority_floor: Optional[int] = None):
        super().__init__(message)
        self.reason = reason
        self.queue = queue
        self.retry_after_s = float(retry_after_s)
        self.priority_floor = priority_floor


def estimate_job_bytes(n_tasks: int) -> int:
    """The budget's coarse cost model for one job of ``n_tasks``."""
    return _JOB_OVERHEAD_B + _TASK_OVERHEAD_B * int(n_tasks)


class AdmissionBudget:
    """Thread-safe pending-work ledger for the admission front door."""

    def __init__(self, max_queue_depth: int = DEFAULT_MAX_QUEUE_DEPTH,
                 max_total_bytes: int = DEFAULT_MAX_TOTAL_BYTES,
                 shed_watermark: float = DEFAULT_SHED_WATERMARK,
                 cycle_period_s: float = 1.0,
                 time_fn=time.monotonic):
        if not 0.0 <= shed_watermark <= 1.0:
            raise ValueError(f"shed_watermark {shed_watermark} not in "
                             f"[0, 1]")
        self.max_queue_depth = int(max_queue_depth)
        self.max_total_bytes = float(max_total_bytes)
        self.shed_watermark = float(shed_watermark)
        self.cycle_period_s = float(cycle_period_s)
        self.time_fn = time_fn
        self._lock = threading.Lock()
        self.depth: Dict[str, int] = {}       # queue -> pending tasks
        self.total_bytes = 0.0
        self.high_water_depth = 0
        self.high_water: Dict[str, int] = {}  # per-queue depth peaks
        self.shed: Dict[str, int] = {}        # reason -> refusals
        self.admitted = 0
        # EWMA of drained tasks/second (the scheduler's bind feedback);
        # 0.0 = never observed — retry hints then price one excess task
        # at one cycle period (the most conservative deterministic guess)
        self.drain_rate = 0.0

    # -- observation ---------------------------------------------------------

    def observe_drain(self, tasks: int, dt_s: Optional[float] = None
                      ) -> None:
        """Feed the drain-throughput EWMA: ``tasks`` left the pending
        set over ``dt_s`` seconds (default: one cycle period)."""
        dt = self.cycle_period_s if dt_s is None else max(dt_s, 1e-9)
        rate = tasks / dt
        with self._lock:
            self.drain_rate = rate if self.drain_rate == 0.0 \
                else 0.8 * self.drain_rate + 0.2 * rate

    def retry_after_s(self, excess_tasks: float) -> float:
        """The 429 hint: how long until ``excess_tasks`` of headroom
        should exist at the observed drain rate. Monotone non-decreasing
        in the excess (tested), capped at MAX_RETRY_AFTER_CYCLES
        periods."""
        with self._lock:
            return self.retry_after_locked(excess_tasks)

    def _priority_floor_locked(self, queue: str) -> int:
        """Caller holds self._lock: the minimum priority the queue
        accepts at its CURRENT fill (the batch that crosses the
        watermark still lands; what follows meets the floor). 0 below
        the shed watermark; rises linearly to PRIORITY_CEIL at the hard
        limit — lowest-priority batches shed first."""
        if self.max_queue_depth <= 0:
            return 0
        fill = self.depth.get(queue, 0) / float(self.max_queue_depth)
        if fill <= self.shed_watermark:
            return 0
        span = max(1.0 - self.shed_watermark, 1e-9)
        frac = min((fill - self.shed_watermark) / span, 1.0)
        return int(frac * PRIORITY_CEIL + 0.999999)   # ceil, floor<=10

    # -- the gate ------------------------------------------------------------

    def admit_batch(self, per_queue: Dict[str, int], nbytes: float,
                    priority=0) -> None:
        """All-or-nothing budget check + charge for one validated batch:
        ``per_queue`` maps queue name -> task count. Raises
        :class:`BackpressureError` (charging nothing) when any queue
        would exceed its depth, the global byte budget would overflow,
        or the batch's priority is below a shedding queue's floor.

        ``priority`` may be an int or a ZERO-ARG CALLABLE resolved only
        if a non-zero floor is actually hit — the front door passes a
        thunk so the PriorityClass store read is skipped in the common
        unloaded case, and the floor check resolves it under THIS lock
        (no window where a queue crosses the watermark between an
        outside peek and the gate)."""
        from .. import metrics
        resolved: Optional[int] = None if callable(priority) \
            else int(priority)
        with self._lock:
            for queue in sorted(per_queue):
                tasks = per_queue[queue]
                depth = self.depth.get(queue, 0)
                if depth + tasks > self.max_queue_depth > 0:
                    excess = depth + tasks - self.max_queue_depth
                    err = BackpressureError(
                        f"queue {queue!r} pending depth {depth}+{tasks} "
                        f"exceeds {self.max_queue_depth}; retry after "
                        f"{self.retry_after_locked(excess):.1f}s",
                        reason="queue_depth", queue=queue,
                        retry_after_s=self.retry_after_locked(excess))
                    self.shed["queue_depth"] = \
                        self.shed.get("queue_depth", 0) + 1
                    break
                floor = self._priority_floor_locked(queue)
                if floor > 0 and resolved is None:
                    resolved = int(priority())
                if floor > 0 and resolved < floor:
                    err = BackpressureError(
                        f"queue {queue!r} is shedding below priority "
                        f"{floor} (fill past the "
                        f"{self.shed_watermark:.0%} watermark); batch "
                        f"priority {resolved} refused",
                        reason="priority_shed", queue=queue,
                        retry_after_s=self.retry_after_locked(tasks),
                        priority_floor=floor)
                    self.shed["priority_shed"] = \
                        self.shed.get("priority_shed", 0) + 1
                    break
            else:
                if self.total_bytes + nbytes > self.max_total_bytes > 0:
                    err = BackpressureError(
                        f"pending-work bytes "
                        f"{self.total_bytes + nbytes:.0f} exceed the "
                        f"{self.max_total_bytes:.0f} budget",
                        reason="bytes",
                        retry_after_s=self.retry_after_locked(
                            sum(per_queue.values())))
                    self.shed["bytes"] = self.shed.get("bytes", 0) + 1
                else:
                    for queue, tasks in per_queue.items():
                        self.depth[queue] = \
                            self.depth.get(queue, 0) + tasks
                        self.high_water[queue] = max(
                            self.high_water.get(queue, 0),
                            self.depth[queue])
                    self.total_bytes += nbytes
                    self.admitted += 1
                    self.high_water_depth = max(
                        self.high_water_depth,
                        sum(self.depth.values()))
                    self._publish_locked()
                    err = None
        if err is not None:
            metrics.register_backpressure(err.reason)
            raise err

    def retry_after_locked(self, excess_tasks: float) -> float:
        """Caller holds self._lock (the lock is not reentrant, so
        admit_batch cannot call the public form)."""
        rate = self.drain_rate
        per_task = (1.0 / rate) if rate > 0 else self.cycle_period_s
        hint = self.cycle_period_s + max(excess_tasks, 0.0) * per_task
        return min(hint, MAX_RETRY_AFTER_CYCLES * self.cycle_period_s)

    def credit(self, queue: str, tasks: int, nbytes: float = 0.0) -> None:
        """Work left the pending set (bound, completed while pending, or
        deleted): release its budget."""
        with self._lock:
            left = self.depth.get(queue, 0) - tasks
            if left > 0:
                self.depth[queue] = left
            else:
                self.depth.pop(queue, None)
            self.total_bytes = max(self.total_bytes - nbytes, 0.0)
            self._publish_locked()

    def _publish_locked(self) -> None:
        """Caller holds self._lock: gauge publication happens INSIDE
        the mutating critical section so concurrent charge/credit pairs
        cannot publish their snapshots out of order (the metrics module
        takes only its own internal lock — no ordering cycle)."""
        from .. import metrics
        metrics.set_admission_pending(sum(self.depth.values()),
                                      self.total_bytes)

    # -- introspection -------------------------------------------------------

    def pending_depth(self) -> int:
        with self._lock:
            return sum(self.depth.values())

    def detail(self) -> dict:
        with self._lock:
            return {
                "max_queue_depth": self.max_queue_depth,
                "max_total_bytes": self.max_total_bytes,
                "depth": dict(sorted(self.depth.items())),
                "total_bytes": round(self.total_bytes, 1),
                "high_water_depth": self.high_water_depth,
                "high_water": dict(sorted(self.high_water.items())),
                "shed": dict(sorted(self.shed.items())),
                "admitted_batches": self.admitted,
                "drain_rate": round(self.drain_rate, 6),
            }
