"""Elastic partition membership, the JAX package's
``federation/elastic.py``: the partition COUNT itself follows load. The
rebalancer moves queues between a FIXED set of partitions; this
controller grows and shrinks the set through the same journaled funnels,
so a cluster that outgrows its membership splits and one that shrank
merges back, with no operator in the loop.

Every partition's leader runs one :class:`ElasticController` at its cycle
end (driven from :class:`~.member.PartitionMember`, exception-isolated
like the rebalancer):

1. **SPLIT**: a partition whose cycle budget is chronically exhausted
   (the budget-exhaustion counter's delta stays positive with real
   pending depth for ``hot_cycles`` consecutive steps) and that owns at
   least two settled queues mints a new partition through the journaled,
   fenced ``partition_spawn`` funnel, asks the host (the sim runner, or a
   deployment's supervisor) to spawn the scheduler shell and the
   per-partition Lease and FencingAuthority through ``spawn_fn``, and
   sheds half its queues to the newborn through the existing
   ``move_queue``/``settle_moves`` two-phase funnel: the queue drains
   (NEITHER side schedules it) and flips atomically, so no job is ever
   schedulable by two partitions at once. Capacity follows demand through
   the cross-partition reserve protocol: the newborn's member files
   starvation reserves and donors drain nodes before handover.
2. **MERGE**: a partition that is chronically idle (no pending depth and
   no open work for ``idle_cycles`` consecutive steps) and is not the
   lowest active pid marks itself retiring through ``begin_retire``
   (persisted, so a crash mid-merge resumes the drain), moves every owned
   queue to the LOWEST assignable partition through the same move funnel,
   releases its emptied node shard through the journaled
   ``release_nodes`` transfer, and retires through ``partition_retire``
   only once no open reserve, draining move or journal intent references
   it.
3. **guard**: each executed membership change opens a DOUBLING abstention
   window (capped), and queues received mid-run get a settle window
   before they count toward another decision, so oscillating load cannot
   flap the membership.

Crash windows reconcile to either the old or the new membership, never a
torn one: the spawn and retire records are single journal control
records (store-backed: single CAS writes on the PartitionState object), a
spawned but unloaded partition is simply chronically idle and merges
itself back, and a killed retiring partition resumes its drain from the
persisted ``retiring`` state. Every input is a published snapshot or the
injectable clock, so ``sim --elastic`` replays byte for byte.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

log = logging.getLogger(__name__)

DEFAULT_HOT_CYCLES = 6         # consecutive exhausted steps before a split
DEFAULT_IDLE_CYCLES = 12       # consecutive idle steps before a merge
DEFAULT_COOLDOWN_S = 16.0      # first membership-change abstention window
DEFAULT_MAX_COOLDOWN_S = 256.0
DEFAULT_MAX_PARTITIONS = 8


class ElasticController:
    """One partition's slice of the elastic-membership decision."""

    def __init__(self, pid: int, pmap, ledger, cache,
                 epoch_fn: Callable[[], int],
                 time_fn: Callable[[], float] = time.monotonic,
                 exhausted_fn: Optional[Callable[[], int]] = None,
                 spawn_fn: Optional[Callable[[int], None]] = None,
                 retire_fn: Optional[Callable[[int], None]] = None,
                 hot_cycles: int = DEFAULT_HOT_CYCLES,
                 idle_cycles: int = DEFAULT_IDLE_CYCLES,
                 cooldown_s: float = DEFAULT_COOLDOWN_S,
                 max_cooldown_s: float = DEFAULT_MAX_COOLDOWN_S,
                 max_partitions: int = DEFAULT_MAX_PARTITIONS):
        self.pid = pid
        self.pmap = pmap
        self.ledger = ledger
        self.cache = cache
        self.epoch_fn = epoch_fn
        self.time_fn = time_fn
        # reads the shell's cycle-budget exhaustion counter (monotonic);
        # the hot signal is its per-step delta: the overload metric IS
        # the split trigger
        self.exhausted_fn = exhausted_fn or (lambda: 0)
        # host hooks: spawn_fn(new_pid) builds the scheduler shell +
        # per-partition Lease/FencingAuthority for a minted partition;
        # retire_fn(pid) tears this partition's shell down after retire
        self.spawn_fn = spawn_fn
        self.retire_fn = retire_fn
        self.hot_cycles = int(hot_cycles)
        self.idle_cycles = int(idle_cycles)
        self.cooldown_s = float(cooldown_s)
        self.max_cooldown_s = float(max_cooldown_s)
        self.max_partitions = int(max_partitions)
        self._exhausted_prev = 0
        self._hot = 0
        self._idle = 0
        # flap guard: executed membership changes open a doubling window
        self._changes = 0
        self._block_until = 0.0
        # settle window: queues that ARRIVED since the last step must
        # drain under this partition before they count toward another
        # membership decision (mirrors the rebalancer's received-queue
        # discipline — a newborn partition must not merge itself back
        # before its first queue even settles)
        self._settle_until = 0.0
        self._owned_prev: set = set()
        self.retiring = False
        self.merge_target: Optional[int] = None
        self.splits = 0
        self.merges = 0
        self.abstentions = 0
        self.refused = 0
        self.last_split: Optional[dict] = None
        self.last_merge: Optional[dict] = None

    # -- load signals --------------------------------------------------------

    def pending_depth(self) -> int:
        """Pending task count over this partition's owned queues (its
        own cache — the split/merge triggers are local observations;
        only the merge TARGET choice reads published state)."""
        from ..api import TaskStatus
        owned = set(self.pmap.queues_of(self.pid))
        total = 0
        for job in self.cache.jobs.values():
            if job.queue in owned:
                total += len(
                    job.task_status_index.get(TaskStatus.PENDING, {}))
        return total

    def _open_work(self) -> bool:
        """Anything that makes 'idle' a lie: jobs still homed here, a
        draining move in or out, or an open reserve naming this pid."""
        owned = set(self.pmap.queues_of(self.pid))
        for job in self.cache.jobs.values():
            if job.queue in owned:
                return True
        with self.pmap._lock:
            draining = dict(self.pmap.draining)
        for queue, dest in draining.items():
            if dest == self.pid or queue in owned:
                return True
        return self.ledger.outstanding(self.pid) is not None

    # -- the decision --------------------------------------------------------

    def step(self, now: Optional[float] = None) -> None:
        """One leader-gated cycle-end pass: update the hysteresis
        counters, then execute at most ONE membership action."""
        from .. import metrics
        now = self.time_fn() if now is None else now
        owned = set(self.pmap.queues_of(self.pid))
        if owned - self._owned_prev:
            self._settle_until = max(self._settle_until,
                                     now + self.cooldown_s)
        self._owned_prev = owned
        state = self.pmap.state_of(self.pid)
        if self.retiring or state == "retiring":
            self.retiring = True
            self._finish_merge(now)
            metrics.set_elastic_detail(self.pid, self.detail())
            return
        exhausted = int(self.exhausted_fn())
        delta, self._exhausted_prev = \
            exhausted - self._exhausted_prev, exhausted
        pending = self.pending_depth()
        if delta > 0 and pending > 0:
            self._hot += 1
            self._idle = 0
        elif pending == 0 and not self._open_work():
            self._hot = 0
            self._idle += 1
        else:
            self._hot = 0
            self._idle = 0
        if now < self._block_until or now < self._settle_until:
            if self._hot >= self.hot_cycles \
                    or self._idle >= self.idle_cycles:
                self.abstentions += 1
            metrics.set_elastic_detail(self.pid, self.detail())
            return
        if self._hot >= self.hot_cycles:
            self._split(now, pending)
        elif self._idle >= self.idle_cycles:
            self._start_merge(now)
        metrics.set_elastic_detail(self.pid, self.detail())

    def _note_change(self, now: float) -> None:
        self._changes += 1
        window = min(self.cooldown_s * (2 ** (self._changes - 1)),
                     self.max_cooldown_s)
        self._block_until = now + window

    def _split(self, now: float, pending: int) -> None:
        """Mint a partition and shed half the owned queues to it. The
        shed set is deterministic: the deepest-first half (ties toward
        queue name), at least one, never the last settled queue."""
        from .. import metrics
        with self.pmap._lock:
            draining = set(self.pmap.draining)
        settled = [q for q in sorted(self.pmap.queues_of(self.pid))
                   if q not in draining]
        if len(settled) < 2 \
                or len(self.pmap.active_pids()) >= self.max_partitions:
            self.abstentions += 1
            return
        epoch = self.epoch_fn()
        new_pid = self.ledger.partition_spawn(self.pid, epoch)
        if new_pid is None:
            self.refused += 1
            metrics.register_partition_split("refused")
            return
        if self.spawn_fn is not None:
            self.spawn_fn(new_pid)
        depths = self._queue_depths(settled)
        ranked = sorted(settled, key=lambda q: (-depths.get(q, 0), q))
        shed = ranked[:len(settled) // 2]
        moved = [q for q in shed
                 if self.ledger.move_queue(q, new_pid, epoch)]
        self._hot = 0
        self._note_change(now)
        self.splits += 1
        self.last_split = {"t": round(now, 6), "new_pid": new_pid,
                           "moved": moved, "pending": pending}
        metrics.register_partition_split("executed")
        log.warning("elastic: partition %d (pending %d, chronic budget "
                    "exhaustion) split -> new partition %d takes %r",
                    self.pid, pending, new_pid, moved)

    def _queue_depths(self, queues) -> dict:
        from ..api import TaskStatus
        depths = {q: 0 for q in queues}
        for job in self.cache.jobs.values():
            if job.queue in depths:
                depths[job.queue] += len(
                    job.task_status_index.get(TaskStatus.PENDING, {}))
        return depths

    def _merge_target_pid(self) -> Optional[int]:
        """The deterministic merge destination: the LOWEST assignable
        pid other than self. The lowest active pid therefore never
        retires (it is everyone's sink), so concurrent merges cannot
        ping-pong queues between two mutually-retiring partitions."""
        pids = [p for p in self.pmap.assignable_pids() if p != self.pid]
        return min(pids) if pids else None

    def _start_merge(self, now: float) -> None:
        from .. import metrics
        target = self._merge_target_pid()
        if target is None or target > self.pid:
            # self is the lowest active pid: it is the sink, never a
            # merger — the membership bottoms out at one partition
            self._idle = 0
            return
        epoch = self.epoch_fn()
        if not self.ledger.begin_retire(self.pid, epoch):
            self.refused += 1
            metrics.register_partition_merge("refused")
            return
        self.retiring = True
        self.merge_target = target
        self._note_change(now)
        self.last_merge = {"t": round(now, 6), "to": target,
                           "state": "draining"}
        metrics.register_partition_merge("begun")
        log.warning("elastic: idle partition %d retiring, draining into "
                    "partition %d", self.pid, target)
        self._finish_merge(now)

    def _finish_merge(self, now: float) -> None:
        """Drive the drain each cycle until retirement lands: push every
        still-owned queue toward the target, release emptied nodes, and
        attempt the journaled retire (which defers while any open
        reserve/intent/move still references this pid)."""
        from .. import metrics
        epoch = self.epoch_fn()
        target = self.merge_target
        if target is None or self.pmap.state_of(target) != "active":
            target = self._merge_target_pid()
            self.merge_target = target
        if target is None:
            return
        with self.pmap._lock:
            draining = set(self.pmap.draining)
        for queue in self.pmap.queues_of(self.pid):
            if queue not in draining:
                self.ledger.move_queue(queue, target, epoch)
        self.ledger.release_nodes(self.pid, target, epoch)
        if self.ledger.partition_retire(self.pid, epoch):
            self.merges += 1
            self.last_merge = {"t": round(now, 6), "to": target,
                               "state": "retired"}
            metrics.register_partition_merge("completed")
            log.warning("elastic: partition %d retired into partition "
                        "%d", self.pid, target)
            if self.retire_fn is not None:
                self.retire_fn(self.pid)

    # -- introspection (vcctl federation elastic-status) ---------------------

    def detail(self) -> dict:
        return {
            "partition": self.pid,
            "retiring": self.retiring,
            "splits": self.splits,
            "merges": self.merges,
            "abstentions": self.abstentions,
            "refused": self.refused,
            "hot_streak": self._hot,
            "idle_streak": self._idle,
            "block_until": round(self._block_until, 3),
            "settle_until": round(self._settle_until, 3),
            "last_split": dict(self.last_split) if self.last_split
            else None,
            "last_merge": dict(self.last_merge) if self.last_merge
            else None,
            "thresholds": {"hot_cycles": self.hot_cycles,
                           "idle_cycles": self.idle_cycles,
                           "max_partitions": self.max_partitions},
        }
