"""Deterministic fault-injection harness.

Seeded chaos wrappers over the cache's side-effect executors
(cache/executors.py Binder/Evictor/StatusUpdater) plus an action-level
exception injector for the scheduler shell's per-action isolation
(scheduler.Scheduler.action_fault_hook). Everything is driven by one
``random.Random(seed)`` per wrapper, so a failing chaos test reproduces
exactly from its printed seed — no global RNG, no wall-clock coupling.

Typical rig::

    binder = ChaosBinder(FakeBinder(), failure_rate=0.2, seed=7)
    evictor = ChaosEvictor(FakeEvictor(), failure_rate=0.2, seed=7)
    cache = SchedulerCache(binder=binder, evictor=evictor)
    sched = Scheduler(cache, conf_text=...)
    sched.action_fault_hook = ActionFaultInjector(
        {"backfill": [2, 5]})          # raise on cycles 2 and 5
    for _ in range(20):
        sched.run_once()

The wrappers fail BEFORE invoking the inner executor (the failed attempt
has no side effect — the k8s API error model the resync queue assumes),
count attempts/failures per operation, and optionally sleep a fixed
latency on success to surface timing races.
"""

from __future__ import annotations

import random
import time
from typing import Dict, Iterable, List, Optional, Tuple

from .cache.executors import Binder, Evictor


class ChaosError(RuntimeError):
    """The injected failure type; carries the wrapper seed and attempt
    index so a log line alone is enough to reproduce."""

    def __init__(self, what: str, seed: int, attempt: int):
        super().__init__(f"chaos: injected {what} failure "
                         f"(seed={seed}, attempt={attempt})")
        self.what = what
        self.seed = seed
        self.attempt = attempt


class _ChaosWrapper:
    """Shared machinery: one seeded RNG, per-op attempt/failure counters."""

    def __init__(self, failure_rate: float = 0.2, latency: float = 0.0,
                 seed: int = 0):
        if not 0.0 <= failure_rate <= 1.0:
            raise ValueError(f"failure_rate {failure_rate} not in [0, 1]")
        self.failure_rate = failure_rate
        self.latency = latency
        self.seed = seed
        self._rng = random.Random(seed)
        self.attempts = 0
        self.failures = 0

    def _roll(self, what: str) -> None:
        """Raise ChaosError on a seeded coin flip; sleep the configured
        latency otherwise. Called before the inner executor so a failed
        attempt has no side effect."""
        self.attempts += 1
        if self._rng.random() < self.failure_rate:
            self.failures += 1
            raise ChaosError(what, self.seed, self.attempts)
        if self.latency:
            time.sleep(self.latency)


class ChaosBinder(_ChaosWrapper, Binder):
    def __init__(self, inner: Binder, failure_rate: float = 0.2,
                 latency: float = 0.0, seed: int = 0):
        _ChaosWrapper.__init__(self, failure_rate, latency, seed)
        self.inner = inner

    def bind(self, task, hostname: str) -> None:
        self._roll("bind")
        self.inner.bind(task, hostname)


class ChaosEvictor(_ChaosWrapper, Evictor):
    def __init__(self, inner: Evictor, failure_rate: float = 0.2,
                 latency: float = 0.0, seed: int = 0):
        _ChaosWrapper.__init__(self, failure_rate, latency, seed)
        self.inner = inner

    def evict(self, task, reason: str) -> None:
        self._roll("evict")
        self.inner.evict(task, reason)


class SimKill(BaseException):
    """A simulated process death. Derives from BaseException ON PURPOSE:
    the cache's bind/evict funnels catch ``Exception`` to roll back and
    resync — a real crash does neither, so the kill must tunnel through
    every except-Exception layer, leaving optimistic cache state and the
    journal's unacked intent exactly as a SIGKILL would. The restart
    harness (sim/runner.SimRunner) catches it at the cycle boundary."""

    def __init__(self, where: str):
        super().__init__(f"simulated crash at {where}")
        self.where = where


class KillPointBinder(Binder):
    """Binder wrapper that crashes the process at a chosen bind within a
    chosen cycle window — BEFORE the inner executor runs (the side
    effect never reached the cluster) or AFTER it (the cluster has the
    bind; the cache/journal never learned). Arm with ``arm(n, before)``;
    fires once per arming. Wrap OUTERMOST (outside any ChaosBinder) so
    kill-after still records the inner executor's side effect first."""

    def __init__(self, inner: Binder):
        self.inner = inner
        self._armed: Optional[Tuple[int, bool]] = None
        self._count = 0
        self.kills: List[tuple] = []       # (bind_index, before)

    def arm(self, at_bind: int, before: bool) -> None:
        self._armed = (at_bind, before)
        self._count = 0

    def disarm(self) -> None:
        self._armed = None

    def bind(self, task, hostname: str) -> None:
        if self._armed is not None:
            at, before = self._armed
            self._count += 1
            if self._count >= at:
                if before:
                    self._armed = None
                    self.kills.append((self._count, True))
                    raise SimKill(f"bind #{self._count} (before execute)")
                self.inner.bind(task, hostname)
                self._armed = None
                self.kills.append((self._count, False))
                raise SimKill(f"bind #{self._count} (after execute)")
        self.inner.bind(task, hostname)


class KillPointEvictor(Evictor):
    """Evictor twin of KillPointBinder."""

    def __init__(self, inner: Evictor):
        self.inner = inner
        self._armed: Optional[Tuple[int, bool]] = None
        self._count = 0
        self.kills: List[tuple] = []

    def arm(self, at_evict: int, before: bool) -> None:
        self._armed = (at_evict, before)
        self._count = 0

    def disarm(self) -> None:
        self._armed = None

    def evict(self, task, reason: str) -> None:
        if self._armed is not None:
            at, before = self._armed
            self._count += 1
            if self._count >= at:
                if before:
                    self._armed = None
                    self.kills.append((self._count, True))
                    raise SimKill(f"evict #{self._count} (before execute)")
                self.inner.evict(task, reason)
                self._armed = None
                self.kills.append((self._count, False))
                raise SimKill(f"evict #{self._count} (after execute)")
        self.inner.evict(task, reason)


def arm_speculation_kill(sched) -> None:
    """Arm the ``speculate`` kill point on a pipelined scheduler shell: the
    process dies right after its next speculative dispatch, before the
    commit that would use it, the window in which the pipeline must have
    journaled nothing. The hook disarms itself when it fires; a cycle that
    dispatches nothing leaves it armed."""

    def _hook(spec, _sched=sched):
        _sched.spec_fault_hook = None
        raise SimKill("between speculative dispatch and commit")

    sched.spec_fault_hook = _hook


class ActionFaultInjector:
    """Raise inside chosen actions on chosen cycles — the hook the
    scheduler shell calls before each action (Scheduler.action_fault_hook).

    ``plan`` maps action name -> iterable of 1-based CYCLE indices on
    which that action raises; the cycle counter increments each time the
    first configured action of the pipeline is seen again. With
    ``failure_rate`` set instead, every listed action fails on a seeded
    coin flip (plan values are ignored then; pass {"allocate": ()}).
    """

    def __init__(self, plan: Dict[str, Iterable[int]],
                 failure_rate: Optional[float] = None, seed: int = 0):
        self.plan = {name: set(cycles) for name, cycles in plan.items()}
        self.failure_rate = failure_rate
        self.seed = seed
        self._rng = random.Random(seed)
        self.cycle = 0
        self._seen_this_cycle: set = set()
        self.injected: List[tuple] = []    # (cycle, action)

    def __call__(self, name: str, ssn) -> None:
        # a repeated action name marks the next cycle (run_once walks the
        # pipeline in order, once per cycle)
        if name in self._seen_this_cycle:
            self._seen_this_cycle.clear()
        if not self._seen_this_cycle:
            self.cycle += 1
        self._seen_this_cycle.add(name)
        if name not in self.plan:
            return
        if self.failure_rate is not None:
            if self._rng.random() >= self.failure_rate:
                return
        elif self.cycle not in self.plan[name]:
            return
        self.injected.append((self.cycle, name))
        raise ChaosError(f"action:{name}", self.seed, self.cycle)
