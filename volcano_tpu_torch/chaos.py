"""Deterministic fault-injection harness.

Seeded chaos wrappers over the cache's side-effect executors
(cache/executors.py Binder/Evictor/StatusUpdater) plus an action-level
exception injector for the scheduler shell's per-action isolation
(scheduler.Scheduler.action_fault_hook), the store boundary's per-verb
fault plan (``StoreFaultInjector``, behind
store_transport.FaultyStoreTransport), the feedback plane's ack faults
(``AckFaultInjector``), the overload drills' seeded arrival bursts
(``OverloadInjector``) and the allocate solve's device faults
(``DeviceFaultInjector`` at ``actions.allocate.DEVICE_FAULT_HOOK``, and
``MeshFaultInjector`` there for faults attributed to one slot of the
sharded engine's mesh), and
the HA control plane's lease revocation (``LeaseLossInjector``) and lease
clock skew (``ClockSkewInjector``). Everything is driven by one
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

from .cache.executors import Binder, Evictor, StatusUpdater


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


class ChaosStatusUpdater(_ChaosWrapper, StatusUpdater):
    def __init__(self, inner: Optional[StatusUpdater] = None,
                 failure_rate: float = 0.2, latency: float = 0.0,
                 seed: int = 0):
        _ChaosWrapper.__init__(self, failure_rate, latency, seed)
        self.inner = inner or StatusUpdater()

    def update_pod_condition(self, task, condition: dict) -> None:
        self._roll("update_pod_condition")
        self.inner.update_pod_condition(task, condition)

    def update_pod_group(self, job) -> None:
        self._roll("update_pod_group")
        self.inner.update_pod_group(job)


class StoreFaultInjector:
    """Seeded per-verb fault plan for the API-server boundary — drives
    :class:`store_transport.FaultyStoreTransport`. Every
    store verb call rolls ONE seeded coin; a hit picks a fault kind by
    seeded weighted choice among the kinds legal for that verb:

    - ``transient``  — TransientStoreError (500/etcd-timeout analogue;
      the retrying transport absorbs it with backoff),
    - ``conflict``   — ConflictError on WRITE verbs (409; CAS loops
      re-read, non-CAS writers surface it like any error),
    - ``latency``    — a slow verb: ``sleep_fn(latency_s)`` then success
      (virtual seconds under the sim's clock — deterministic).

    Watch streams tear separately: ``roll_tear()`` is consulted per
    delivered watch event, and the sim additionally schedules whole-
    stream tears at seeded cycles. All RNG is one ``random.Random(seed)``
    per injector — a failing soak reproduces from its printed seed."""

    READ_VERBS = ("get", "list")
    WRITE_VERBS = ("create", "create_batch", "update", "update_status",
                   "delete", "bind_pod", "evict_pod")

    def __init__(self, failure_rate: float = 0.2, seed: int = 0,
                 conflict_share: float = 0.25, latency_share: float = 0.25,
                 latency_s: float = 0.05, tear_rate: float = 0.0,
                 sleep_fn=None):
        if not 0.0 <= failure_rate <= 1.0:
            raise ValueError(f"failure_rate {failure_rate} not in [0, 1]")
        self.failure_rate = failure_rate
        self.conflict_share = conflict_share
        self.latency_share = latency_share
        self.latency_s = latency_s
        self.tear_rate = tear_rate
        self.seed = seed
        self.sleep_fn = sleep_fn or time.sleep
        self._rng = random.Random(seed)
        self.attempts = 0
        self.injected: Dict[str, int] = {}     # kind -> count

    def _pick_kind(self, verb: str) -> str:
        r = self._rng.random()
        if verb not in self.READ_VERBS and r < self.conflict_share:
            return "conflict"
        if r < self.conflict_share + self.latency_share:
            return "latency"
        return "transient"

    def roll(self, verb: str) -> Optional[str]:
        """One verb attempt: returns the injected fault kind ("latency"
        is applied here — the sleep — and reported for counting), or
        None for a clean call."""
        self.attempts += 1
        if self._rng.random() >= self.failure_rate:
            return None
        kind = self._pick_kind(verb)
        self.injected[kind] = self.injected.get(kind, 0) + 1
        if kind == "latency":
            if self.latency_s:
                self.sleep_fn(self.latency_s)
        return kind

    def roll_tear(self) -> bool:
        """Per-delivered-watch-event tear roll (a torn stream stops
        receiving until its owner resumes it)."""
        if not self.tear_rate:
            return False
        if self._rng.random() >= self.tear_rate:
            return False
        self.injected["torn_watch"] = self.injected.get("torn_watch", 0) + 1
        return True


class AckFaultInjector:
    """Seeded fault plan for the cluster→scheduler FEEDBACK plane (the
    kubelet/status ack wire; docs/robustness.md feedback failure model).
    Every offered ack rolls ONE seeded coin; a hit picks a kind by
    seeded weighted choice:

    - ``delay``     — the ack arrives ``delay_s`` late (virtual seconds
      under the sim's clock — deterministic);
    - ``drop``      — the ack never arrives; only the in-flight
      watchdog's re-validation can settle the side effect;
    - ``duplicate`` — the ack arrives twice (the replay ``delay_s``
      later); the FeedbackChannel normalizer must make the second a
      no-op;
    - ``reorder``   — the ack is delivered AFTER the next ack offered
      (adjacent swap), the evict-ack/bind-ack inversion drill;
    - ``stale``     — the ack arrives, then is REPLAYED ``stale_delay_s``
      later — long enough that the placement it confirms is usually
      dead (evicted/completed); the replay must not resurrect it.

    One ``random.Random(seed)`` per injector — a failing soak reproduces
    from its printed seed. Counted in volcano_ack_faults_total{kind}."""

    KINDS = ("delay", "drop", "duplicate", "reorder", "stale")
    DEFAULT_SHARES = (("delay", 0.35), ("drop", 0.2), ("duplicate", 0.15),
                      ("reorder", 0.15), ("stale", 0.15))

    def __init__(self, failure_rate: float = 0.3, seed: int = 0,
                 delay_s: float = 2.5, stale_delay_s: float = 6.5,
                 shares=None):
        if not 0.0 <= failure_rate <= 1.0:
            raise ValueError(f"failure_rate {failure_rate} not in [0, 1]")
        self.failure_rate = failure_rate
        self.seed = seed
        self.delay_s = delay_s
        self.stale_delay_s = stale_delay_s
        self.shares = tuple(shares) if shares is not None \
            else self.DEFAULT_SHARES
        self._rng = random.Random(seed)
        self.attempts = 0
        self.injected: Dict[str, int] = {}     # kind -> count

    def roll(self, ack_kind: str) -> Optional[str]:
        """One offered ack: returns the injected fault kind, or None for
        a clean delivery."""
        self.attempts += 1
        if self._rng.random() >= self.failure_rate:
            return None
        total = sum(w for _, w in self.shares)
        r = self._rng.random() * total
        kind = self.shares[-1][0]
        for name, w in self.shares:
            if r < w:
                kind = name
                break
            r -= w
        self.injected[kind] = self.injected.get(kind, 0) + 1
        from . import metrics
        metrics.register_ack_fault(kind)
        return kind


class OverloadInjector:
    """Seeded arrival-burst generator for the admission-overload drills.
    Each ``tick()`` (one virtual cycle) rolls ONE seeded coin; a hit
    yields a burst of ``burst_range`` synthetic jobs on top of whatever
    the trace already delivers — the flash crowd the backpressure budget
    must shed and the cycle budget must survive. ``job_spec(n_queues)``
    draws one burst job's shape (queue index, priority, gang size,
    resources, duration) from the same seeded RNG, so a whole overload
    soak is a pure function of its seed and replays byte-identically.

    One ``random.Random(seed)`` per injector — a failing soak
    reproduces from its printed seed, like every other chaos harness
    here."""

    def __init__(self, burst_rate: float = 0.15,
                 burst_range: Tuple[int, int] = (8, 32), seed: int = 0,
                 priorities: Iterable[int] = (0, 0, 0, 5, 10),
                 cpu_choices: Iterable[int] = (500, 1000),
                 duration_range: Tuple[float, float] = (2.0, 6.0)):
        if not 0.0 <= burst_rate <= 1.0:
            raise ValueError(f"burst_rate {burst_rate} not in [0, 1]")
        self.burst_rate = burst_rate
        self.burst_range = tuple(burst_range)
        self.seed = seed
        self.priorities = tuple(priorities)
        self.cpu_choices = tuple(cpu_choices)
        self.duration_range = tuple(duration_range)
        self._rng = random.Random(seed)
        self.ticks = 0
        self.injected = 0
        self.bursts: List[Tuple[int, int]] = []   # (tick, size)

    def tick(self) -> int:
        """One cycle: 0 (no burst) or the seeded burst size."""
        self.ticks += 1
        if self._rng.random() >= self.burst_rate:
            return 0
        lo, hi = self.burst_range
        size = self._rng.randint(int(lo), int(hi))
        self.bursts.append((self.ticks, size))
        self.injected += size
        return size

    def job_spec(self, n_queues: int) -> Dict[str, object]:
        """One burst job's seeded shape; the caller names it and routes
        it through the admission front door like any client POST."""
        lo, hi = self.duration_range
        return {
            "queue_ix": self._rng.randrange(max(int(n_queues), 1)),
            "priority": self._rng.choice(self.priorities),
            "tasks": self._rng.choice((1, 1, 2)),
            "cpu_milli": self._rng.choice(self.cpu_choices),
            "duration": round(self._rng.uniform(lo, hi), 3),
        }


class DeviceFaultInjector:
    """Simulate device errors (OOM / device-lost) at the allocate solve
    boundary — install as ``actions.allocate.DEVICE_FAULT_HOOK``.

    ``plan`` maps a fault kind ("oom" | "device_lost") to the 1-based
    SOLVE-ATTEMPT indices on which to raise (each hook call is one
    device solve attempt); with ``failure_rate`` set, every attempt
    instead rolls a seeded coin and picks a kind round-robin from
    ``plan``'s keys (pass {"oom": ()}). Raises
    ``device_health.DeviceFaultError`` — classified like the card's own
    error, so the cool-down state machine, the device-state invalidation
    and the sequential-placer path are exercised end to end::

        from volcano_tpu_torch.actions import allocate
        allocate.DEVICE_FAULT_HOOK = DeviceFaultInjector(
            {"oom": [2]})             # second solve attempt OOMs
    """

    def __init__(self, plan: Dict[str, Iterable[int]],
                 failure_rate: Optional[float] = None, seed: int = 0):
        self.plan = {kind: set(attempts) for kind, attempts in plan.items()}
        self.failure_rate = failure_rate
        self.seed = seed
        self._rng = random.Random(seed)
        self.attempt = 0
        self.injected: List[tuple] = []    # (attempt, kind)

    def __call__(self, engine: str) -> None:
        from .device_health import DeviceFaultError
        self.attempt += 1
        kind = None
        if self.failure_rate is not None:
            if self._rng.random() < self.failure_rate:
                kinds = sorted(self.plan) or ["oom"]
                kind = kinds[len(self.injected) % len(kinds)]
        else:
            for k, attempts in self.plan.items():
                if self.attempt in attempts:
                    kind = k
                    break
        if kind is None:
            return
        self.injected.append((self.attempt, kind))
        msg = ("RESOURCE_EXHAUSTED: Out of memory allocating device buffer"
               if kind == "oom" else
               "DEVICE_LOST: device lost (simulated)")
        raise DeviceFaultError(kind, f"chaos: {msg} "
                                     f"(seed={self.seed}, "
                                     f"attempt={self.attempt})")


class MeshFaultInjector:
    """Per-slot device faults for the ``tpu-sharded`` engine — install as
    ``actions.allocate.DEVICE_FAULT_HOOK`` (the socket of
    ``DeviceFaultInjector``, so the two are interchangeable per run).

    Each fault is ATTRIBUTED to a live slot: the raised
    ``DeviceFaultError`` carries ``device=<id>``, picked seeded from
    ``allocate.CURRENT_MESH_DEVICES`` (the slot ids the current solve
    attempt runs over, refreshed per heal retry), so the lattice
    quarantines exactly one slot and the mesh heals mid-cycle. Kinds:
    "oom", "device_lost" and "slow" (a straggling shard).

    ``plan`` maps kind -> 1-based solve-attempt indices, or set
    ``failure_rate`` for a seeded coin per attempt (as
    ``DeviceFaultInjector``). Probe dry runs (hook calls named
    ``"<engine>:probe:<id>"``) are attempts of their own and fault the
    PROBED slot when their index is planned: that keeps a slot
    quarantined across probe windows. Faults are recorded in
    ``injected`` as ``(attempt, kind, device)``."""

    _MESSAGES = {
        "oom": "out of memory allocating a shard's buffer",
        "device_lost": "device lost (simulated)",
        "slow": "collective timed out waiting on the shard (simulated "
                "straggler)",
    }

    def __init__(self, plan: Dict[str, Iterable[int]],
                 failure_rate: Optional[float] = None, seed: int = 0):
        self.plan = {kind: set(attempts) for kind, attempts in plan.items()}
        self.failure_rate = failure_rate
        self.seed = seed
        self._rng = random.Random(seed)
        self.attempt = 0
        self.injected: List[tuple] = []    # (attempt, kind, device)

    def _pick_kind(self) -> Optional[str]:
        if self.failure_rate is not None:
            if self._rng.random() < self.failure_rate:
                kinds = sorted(self.plan) or ["device_lost"]
                return kinds[len(self.injected) % len(kinds)]
            return None
        for k, attempts in self.plan.items():
            if self.attempt in attempts:
                return k
        return None

    def __call__(self, engine: str) -> None:
        from .device_health import DeviceFaultError
        self.attempt += 1
        kind = self._pick_kind()
        if kind is None:
            return
        if ":probe:" in engine:
            device = int(engine.rsplit(":", 1)[1])
        else:
            from .actions.allocate import CURRENT_MESH_DEVICES
            if not CURRENT_MESH_DEVICES:
                return               # nothing live to attribute to
            device = CURRENT_MESH_DEVICES[
                self._rng.randrange(len(CURRENT_MESH_DEVICES))]
        self.injected.append((self.attempt, kind, device))
        raise DeviceFaultError(
            kind, f"chaos: {self._MESSAGES[kind]} "
                  f"(seed={self.seed}, attempt={self.attempt})",
            device=device)


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


class LeaseLossInjector:
    """Revoke a replica's leadership MID-CYCLE at chosen (cycle, action)
    points, the HA demotion drill: the leader must abandon its open
    session at the next action boundary instead of half-applying it, and
    its post-demotion writes must be fenced.

    This is the standalone form for single-scheduler rigs and tests; the
    HA sim (``sim --ha N --lease-loss-cycles``) runs the same drill inside
    its per-replica action hook, where the revocation follows whichever
    replica leads.

    ``plan`` maps 1-based CYCLE indices to the 1-based ACTION ordinal
    before which the revocation lands (``{3: 2}``: on cycle 3, revoke just
    before the second action runs). Install as (or compose into)
    ``Scheduler.action_fault_hook``; it never raises, the scheduler's own
    demotion check does the rest. ``elector_fn`` returns the live elector
    (replicas swap electors across restarts)."""

    def __init__(self, elector_fn, plan: Dict[int, int]):
        self.elector_fn = elector_fn
        self.plan = dict(plan)
        self.cycle = 0
        self._seen_this_cycle: set = set()
        self.injected: List[tuple] = []    # (cycle, action_ordinal)

    def __call__(self, name: str, ssn) -> None:
        if name in self._seen_this_cycle:
            self._seen_this_cycle.clear()
        if not self._seen_this_cycle:
            self.cycle += 1
        self._seen_this_cycle.add(name)
        at = self.plan.get(self.cycle)
        if at is None or len(self._seen_this_cycle) != at:
            return
        elector = self.elector_fn()
        if elector is None or not elector.leading:
            return
        self.injected.append((self.cycle, at))
        elector.revoke()


class ClockSkewInjector:
    """Wrap a wall-clock ``time_fn`` with a steerable offset, the NTP step
    model for lease-clock skew: lease timestamps (cross-process, wall
    based) skew with the offset while the renew-deadline watchdog keeps
    reading the untouched monotonic clock. Tests set ``offset`` (or call
    ``step``) mid-run to model the NTP daemon slewing or stepping the
    clock."""

    def __init__(self, base_fn, offset: float = 0.0):
        self.base_fn = base_fn
        self.offset = offset

    def step(self, delta: float) -> None:
        self.offset += delta

    def __call__(self) -> float:
        return self.base_fn() + self.offset


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
