"""Leader election over the ObjectStore: the HA story for the scheduler
(cmd/scheduler/app/server.go:111-141: resourcelock +
leaderelection.RunOrDie), the JAX package's ``volcano_tpu/
leaderelection.py`` in this package.

The store is the coordination backend, so the lock is a Lease object in
it: holder identity and renew time. Replicas point at one store; exactly
one holds the lease and schedules, the rest retry. A leader that misses
its renew deadline loses the lease to the first challenger (k8s
LeaseDuration/RenewDeadline/RetryPeriod semantics).

Fencing: every lease ACQUISITION (create or takeover, never a renewal)
mints a monotonically increasing fencing epoch. The epoch rides the lease
object, so the store's CAS makes it split-brain safe: two challengers
cannot both mint epoch E+1. The holder exposes it as ``fencing_epoch``;
the scheduler stamps every journaled bind/evict intent with it, and the
executor gate (cache/executors.FencedBinder/FencedEvictor) rejects any
operation whose epoch is below the highest the cluster has observed.

Two ways to drive it:

- ``run()``: the threaded RunOrDie loop. It blocks, renews on a daemon
  thread and fires ``on_lease_lost`` when the renew deadline passes
  without a successful renewal;
- ``step()``: one synchronous acquire/renew attempt. The cycle-driven HA
  mode (``sim --ha N`` and the shell's per-cycle gate) calls it each cycle
  instead of spawning threads, which keeps elections on the virtual clock
  and byte-deterministic.

``FlapGuard`` applies the device cool-down idiom to flapping leadership:
a replica that keeps losing the lease abstains from contending for a
doubling window instead of thrashing the lease between replicas.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Optional

from .apis.objects import ObjectMeta
from .store_transport import TransientStoreError

DEFAULT_LEASE_DURATION = 15.0
DEFAULT_RENEW_DEADLINE = 10.0
DEFAULT_RETRY_PERIOD = 2.0


def partition_lease_name(base: str, pid: int) -> str:
    """The per-partition Lease name of a federated control plane
    (docs/federation.md): each partition elects its own fenced leader
    under ``<base>-p<pid>``, so fencing epochs are namespaced by
    partition id — one partition's failover can never fence another's
    leader. The sim runner and ``vcctl federation status`` share this
    naming."""
    return f"{base}-p{int(pid)}"


@dataclass
class Lease:
    """coordination.k8s.io/v1 Lease mirror, extended with the fencing
    epoch (the k8s analogue would be an annotation; leaseTransitions is
    the closest stock field). ``epoch`` increments on every ACQUISITION
    (create/takeover) and is carried unchanged across renewals, so it
    totally orders leaderships."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    holder: str = ""
    renew_time: float = 0.0
    lease_duration: float = DEFAULT_LEASE_DURATION
    epoch: int = 0

    KIND = "Lease"


class FlapGuard:
    """Cool-down for flapping leadership (the device_health.DeviceHealth
    idiom applied to elections): each lease LOSS opens a doubling
    abstention window during which ``may_contend()`` is False — the
    replica sits out instead of thrashing the lease. The loss streak
    resets only once a re-acquired leadership has been HELD for a full
    base cooldown (the stability horizon) — resetting on the first
    successful renewal would make the doubling unreachable, since a
    loss always follows an acquisition. Runs on an injectable
    ``time_fn`` (the sim pins virtual time)."""

    def __init__(self, cooldown_s: float = 5.0, max_cooldown_s: float = 80.0,
                 time_fn: Callable[[], float] = time.monotonic):
        self.cooldown_s = cooldown_s
        self.max_cooldown_s = max_cooldown_s
        self.time_fn = time_fn
        self.consecutive_losses = 0
        self.total_losses = 0
        self._until: Optional[float] = None
        self._stable_after: Optional[float] = None

    def record_loss(self) -> float:
        """Leadership lost: open (or double) the abstention window.
        Returns the window length in force."""
        self.consecutive_losses += 1
        self.total_losses += 1
        window = min(self.cooldown_s * (2 ** (self.consecutive_losses - 1)),
                     self.max_cooldown_s)
        self._until = self.time_fn() + window
        self._stable_after = None
        return window

    def record_stable(self) -> None:
        """Called on every successful acquire/renew. The first call after
        a loss stamps the stability horizon (now + base cooldown); the
        streak resets only when leadership is still held past it."""
        if self.consecutive_losses == 0:
            return
        now = self.time_fn()
        if self._stable_after is None:
            self._stable_after = now + self.cooldown_s
            return
        if now >= self._stable_after:
            self.consecutive_losses = 0
            self._until = None
            self._stable_after = None

    def may_contend(self) -> bool:
        return self._until is None or self.time_fn() >= self._until

    def detail(self) -> dict:
        return {
            "may_contend": self.may_contend(),
            "consecutive_losses": self.consecutive_losses,
            "total_losses": self.total_losses,
            "cooldown_remaining_s": max(0.0, self._until - self.time_fn())
            if self._until is not None else 0.0,
        }


class LeaderElector:
    """RunOrDie analogue: call run() from the current thread; it blocks,
    acquiring the lease, invoking on_started_leading, renewing every
    retry_period, and invoking on_stopped_leading if the lease is lost."""

    def __init__(self, store, name: str,
                 on_started_leading: Callable[[], None],
                 on_stopped_leading: Optional[Callable[[], None]] = None,
                 identity: Optional[str] = None,
                 namespace: str = "volcano-system",
                 lease_duration: float = DEFAULT_LEASE_DURATION,
                 renew_deadline: float = DEFAULT_RENEW_DEADLINE,
                 retry_period: float = DEFAULT_RETRY_PERIOD,
                 time_fn: Callable[[], float] = time.time,
                 mono_fn: Callable[[], float] = time.monotonic,
                 on_lease_lost: Optional[Callable[[], None]] = None,
                 authority=None,
                 flap_guard: Optional[FlapGuard] = None):
        # Injectable time sources (vlint VT002). Lease timestamps are
        # wall-clock (``time_fn``) — they are compared ACROSS processes
        # (native store / RPC shim replicas), where a per-process
        # monotonic clock is meaningless. The renew-deadline watchdog is
        # the opposite: a PER-PROCESS elapsed interval, so it reads
        # ``mono_fn`` — measuring it on the wall clock would let an NTP
        # step backward mask lease loss (split brain) or a step forward
        # depose a healthy leader. A federated sim pins both to its
        # virtual clock to elect deterministically.
        self.time_fn = time_fn
        self.mono_fn = mono_fn
        self.store = store
        self.name = name
        self.namespace = namespace
        self.identity = identity or f"{name}-{uuid.uuid4().hex[:8]}"
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self._stop = threading.Event()
        self.leading = False
        # fencing (docs/robustness.md): the epoch of OUR current (or most
        # recent) leadership. Deliberately NOT reset on lease loss — a
        # fenced ex-leader keeps stamping operations with its stale epoch,
        # which is exactly what the executor gate rejects.
        self.fencing_epoch = 0
        # distinct from on_stopped_leading (which also fires on voluntary
        # stop): fires only when the lease was LOST — renew-deadline miss
        # or an injected revocation. The scheduler's demote path hangs off
        # this.
        self.on_lease_lost = on_lease_lost
        # cluster-side epoch watermark (cache/executors.FencingAuthority):
        # advanced on every successful acquire so a deposed predecessor's
        # writes are rejectable the moment the new leader exists
        self.authority = authority
        self.flap_guard = flap_guard
        self.takeovers = 0          # acquisitions of an expired foreign lease
        self._last_renew_mono: Optional[float] = None

    # -- lock primitives ----------------------------------------------------

    def _lease(self) -> Optional[Lease]:
        return self.store.get("Lease", self.namespace, self.name)

    def try_acquire_or_renew(self, now: Optional[float] = None) -> bool:
        """One CAS-guarded acquire/renew attempt, mirroring k8s
        resourcelock semantics: every write carries the resourceVersion it
        read, so two challengers racing on an expired lease cannot both
        win — the loser's update conflicts and it returns False.

        Timestamps come from the elector's injectable ``time_fn``
        (wall-clock by default): leases are compared across processes
        (native store / RPC shim replicas), where a per-process
        monotonic clock is meaningless."""
        now = self.time_fn() if now is None else now
        from .store import ConflictError
        # The lease path rides the SAME store boundary as every other
        # scheduler write (docs/robustness.md store failure model): in a
        # hostile deployment the store here is a RetryingStoreTransport
        # composition, and a verb that fails PAST the retry budget
        # surfaces as TransientStoreError. That loses THIS attempt, not
        # the leadership — k8s renew semantics: only the renew deadline
        # (monotonic) deposes, and step() owns that watchdog.
        try:
            lease = self._lease()
        except TransientStoreError:
            return False
        if lease is None:
            fresh = Lease(metadata=ObjectMeta(name=self.name,
                                              namespace=self.namespace),
                          holder=self.identity, renew_time=now,
                          lease_duration=self.lease_duration, epoch=1)
            try:
                self.store.create(fresh)
            except (ValueError, ConflictError):
                return False          # lost the create race; retry later
            except TransientStoreError:
                return False
            self._claimed(1)
            return True
        if lease.holder != self.identity \
                and now - lease.renew_time <= lease.lease_duration:
            return False              # live lease held by someone else
        # renew (ours, while we believe we lead) carries the epoch
        # unchanged; any ACQUISITION — takeover of an expired foreign
        # lease, or re-claiming our own lease after we stopped leading
        # (a restarted incarnation, a fenced ex-leader re-contending) —
        # mints epoch+1. The CAS makes the mint race-free: two
        # challengers reading the same expired lease cannot both win the
        # write, so exactly one epoch E+1 ever exists.
        renewal = lease.holder == self.identity and self.leading
        epoch = int(getattr(lease, "epoch", 0)) + (0 if renewal else 1)
        claimed = Lease(
            metadata=ObjectMeta(name=self.name, namespace=self.namespace),
            holder=self.identity, renew_time=now,
            lease_duration=self.lease_duration, epoch=epoch)
        try:
            self.store.update(
                claimed, expect_rv=lease.metadata.resource_version)
        except ConflictError:
            return False              # another challenger won this round
        except TransientStoreError:
            return False              # write lost past the retry budget
        if not renewal and lease.holder != self.identity:
            self.takeovers += 1
        self._claimed(epoch)
        return True

    def _claimed(self, epoch: int) -> None:
        """A lease write of ours landed: record the epoch locally, feed
        the renew-deadline watchdog (monotonic), and advance the
        cluster-side watermark, so a deposed predecessor's stale-epoch
        operations are rejectable from this instant on."""
        self.fencing_epoch = epoch
        self._last_renew_mono = self.mono_fn()
        if self.authority is not None:
            self.authority.advance(epoch)

    def _write_released(self) -> None:
        from .store import ConflictError
        try:
            lease = self._lease()
        except TransientStoreError:
            return                    # best effort: expiry releases it
        if lease is not None and lease.holder == self.identity:
            # epoch survives a release: the next acquirer must mint a
            # HIGHER epoch than ours, or fencing would stop ordering
            # leaderships
            released = Lease(
                metadata=ObjectMeta(name=self.name,
                                    namespace=self.namespace),
                holder=self.identity, renew_time=0.0,
                lease_duration=self.lease_duration,
                epoch=int(getattr(lease, "epoch", 0)))
            try:
                self.store.update(
                    released, expect_rv=lease.metadata.resource_version)
            except (ConflictError, TransientStoreError):
                pass                  # someone already took it over

    def release(self) -> None:
        self._write_released()
        self.leading = False

    # -- cycle-driven (threadless) consumption ------------------------------

    def step(self, now: Optional[float] = None) -> bool:
        """One synchronous election/renew attempt; returns whether this
        replica leads AFTER the attempt. The cycle-driven HA mode
        (scheduler shell per cycle; ``sim --ha N`` on the virtual clock)
        calls this instead of running the threaded loops.

        k8s renew semantics: one failed renewal does not depose a live
        leader — leadership is lost only when ``renew_deadline`` elapses
        (on the per-process monotonic clock) without a successful
        renewal. A non-leader honours the FlapGuard abstention window
        before contending."""
        if not self.leading and self.flap_guard is not None \
                and not self.flap_guard.may_contend():
            return False
        ok = self.try_acquire_or_renew(now)
        mono = self.mono_fn()
        if ok:
            self._last_renew_mono = mono
            self.leading = True
            if self.flap_guard is not None:
                self.flap_guard.record_stable()
            return True
        if self.leading:
            if self._last_renew_mono is None \
                    or mono - self._last_renew_mono > self.renew_deadline:
                self._lose()
        return self.leading

    def _lose(self) -> None:
        """Leadership lost (renew deadline passed, or revoked): flip the
        flag, open the flap cool-down, fire the loss callbacks. The
        fencing epoch deliberately stays at its stale value — see
        __init__."""
        if not self.leading:
            return
        self.leading = False
        if self.flap_guard is not None:
            self.flap_guard.record_loss()
        if self.on_lease_lost is not None:
            self.on_lease_lost()
        if self.on_stopped_leading is not None:
            self.on_stopped_leading()

    def revoke(self) -> None:
        """Forcibly relinquish a held lease AND the local leading state —
        the chaos LeaseLossInjector's entry point (models the lease
        being administratively stolen / a partition expiring it). The
        lease is written back expired-with-epoch so any challenger can
        take over immediately with epoch+1."""
        self._write_released()
        self._lose()

    # -- the election loop --------------------------------------------------

    def run(self) -> None:
        try:
            while not self._stop.is_set():
                if self.try_acquire_or_renew():
                    break
                self._stop.wait(self.retry_period)
            if self._stop.is_set():
                return
            self.leading = True
            renewer = threading.Thread(target=self._renew_loop, daemon=True,
                                       name=f"lease-renew-{self.name}")
            renewer.start()
            self.on_started_leading()
        finally:
            was_leading = self.leading
            self.leading = False
            self._stop.set()
            if was_leading and self.on_stopped_leading is not None:
                self.on_stopped_leading()

    def _renew_loop(self) -> None:
        last_renew = self.mono_fn()
        while not self._stop.is_set():
            self._stop.wait(self.retry_period)
            if self._stop.is_set():
                return
            if self.try_acquire_or_renew():
                last_renew = self.mono_fn()
            elif self.mono_fn() - last_renew > self.renew_deadline:
                # lost the lease: stop leading (RunOrDie klog.Fatal analogue
                # — here we signal the component loop to stop instead).
                # _lose fires on_lease_lost + on_stopped_leading and opens
                # the flap cool-down.
                self._stop.set()
                self._lose()
                return

    def stop(self) -> None:
        self._stop.set()
