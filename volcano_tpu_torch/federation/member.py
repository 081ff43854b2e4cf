"""PartitionMember: the per-partition glue between the scheduler shell
and the federation: the JAX package's ``federation/member.py``.

One member rides each partition's Scheduler (``sched.federation``). The
shell drives it only while this replica LEADS its partition (the hooks
sit behind the HA gate), so every reserve decision is made by a live,
fenced leadership:

- ``on_cycle_start`` (before the snapshot): expire timed-out reserves,
  settle drained queue moves, review incoming reserve requests — grants
  mutate cluster state BEFORE the cycle's snapshot, so the same cycle
  schedules against the post-transfer world;
- ``on_cycle_end`` (the cycle epilogue): publish this partition's idle
  capacity to the ledger, detect starvation, and file at most one
  reserve request.

Starvation is deliberately conservative: a gang is starved only when it
has waited ``starve_after_s`` of (virtual) time without admission AND
the partition's own idle capacity cannot cover it — anything less
self-heals next cycle without cross-partition traffic.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

from .partition import PartitionMap
from .reserve import ReserveLedger

log = logging.getLogger(__name__)

DEFAULT_STARVE_AFTER_S = 4.0


class PartitionMember:
    def __init__(self, pid: int, pmap: PartitionMap, ledger: ReserveLedger,
                 cache, epoch_fn: Callable[[], int],
                 time_fn: Callable[[], float] = time.monotonic,
                 starve_after_s: float = DEFAULT_STARVE_AFTER_S,
                 rebalancer=None, elastic=None):
        self.pid = pid
        self.pmap = pmap
        self.ledger = ledger
        self.cache = cache
        self.epoch_fn = epoch_fn
        self.time_fn = time_fn
        self.starve_after_s = starve_after_s
        self.requests_filed = 0
        # load-driven rebalancing (federation/rebalance.py): when a
        # RebalanceController rides this member, on_cycle_end publishes
        # load signals and may move ONE owned queue through the
        # journaled move funnel. None = operator moves only.
        self.rebalancer = rebalancer
        # elastic membership (federation/elastic.py): a controller
        # riding here may split this partition or drive its merge.
        # None = fixed membership.
        self.elastic = elastic
        ledger.attach_cache(pid, cache)

    # -- cycle hooks (leader-gated by the scheduler shell) -------------------

    def on_cycle_start(self) -> None:
        # store-backed maps (federation/store_backed.py) first heal a
        # torn PartitionState stream so this cycle reviews against the
        # freshest ownership/request state reachable
        sync = getattr(self.pmap, "sync", None)
        if sync is not None:
            sync()
        epoch = self.epoch_fn()
        self.ledger.expire(self.time_fn())
        self.ledger.settle_moves(self.pid, epoch)
        self.ledger.review(self.pid, epoch)

    def publish_follower(self) -> None:
        """Publish this replica's NON-leading state for its partition —
        called by the scheduler shell's HA gate on every follower cycle
        (the on_cycle_* hooks are leader-gated, so without this a
        deposed replica would export a stale leading=1 gauge forever
        and monitoring would show two leaders after a failover)."""
        from .. import metrics
        metrics.set_partition_leader(self.pid, False, self.epoch_fn(),
                                     detail=self.detail())

    def on_cycle_end(self) -> None:
        from .. import metrics
        now = self.time_fn()
        idle_cpu, idle_mem = self._owned_idle()
        self.ledger.publish_idle(self.pid, idle_cpu, idle_mem)
        if self.rebalancer is not None:
            # publish this partition's load signals and (hysteresis +
            # flap guard permitting) move at most one owned queue
            # through the journaled move_queue/settle_moves funnel —
            # isolated: a rebalancer fault must not cost the cycle
            try:
                self.rebalancer.step(now)
            except Exception:
                log.exception("rebalancer step failed; next cycle "
                              "re-evaluates")
        if self.elastic is not None:
            # the membership decision (split/merge) — isolated the same
            # way: an elastic fault must not cost the scheduling cycle
            try:
                self.elastic.step(now)
            except Exception:
                log.exception("elastic step failed; next cycle "
                              "re-evaluates")
        metrics.set_partition_leader(self.pid, True, self.epoch_fn(),
                                    detail=self.detail())
        starved = self._starved_need(now, idle_cpu, idle_mem)
        if starved is None:
            return
        need_cpu, need_mem = starved
        if self.ledger.outstanding(self.pid) is not None:
            return
        donor = self.ledger.pick_donor(self.pid)
        if donor is None:
            return
        rid = self.ledger.request(self.pid, donor, need_cpu, need_mem,
                                  self.epoch_fn())
        if rid is not None:
            self.requests_filed += 1
            log.warning("partition %d starved: reserved (%.0f mcpu, "
                        "%.0f B) from partition %d (rid=%d)",
                        self.pid, need_cpu, need_mem, donor, rid)

    # -- starvation detection ------------------------------------------------

    def _owned_idle(self) -> tuple:
        cpu = mem = 0.0
        for name in self.pmap.unpinned_nodes_of(self.pid):
            node = self.cache.nodes.get(name)
            if node is None or not node.ready:
                continue
            cpu += node.idle.cpu
            mem += node.idle.memory
        return cpu, mem

    def _starved_need(self, now: float, idle_cpu: float,
                      idle_mem: float) -> Optional[tuple]:
        """The oldest unadmitted gang that has waited past the
        starvation horizon and does not fit the partition's own idle
        capacity; returns its outstanding (cpu, mem) demand. Pending
        gangs that FIT are not starved — they place next cycle."""
        from ..api import TaskStatus
        oldest = None
        oldest_age = self.starve_after_s
        for job in self.cache.jobs.values():
            if job.min_available <= 0 or job.ready():
                continue
            born = job.schedule_start_timestamp
            if born is None:
                born = job.creation_timestamp or 0.0
            age = now - float(born)
            if age < oldest_age:
                continue
            cpu = mem = 0.0
            for task in job.tasks.values():
                if task.status == TaskStatus.PENDING:
                    cpu += task.resreq.cpu
                    mem += task.resreq.memory
            if cpu <= 0 and mem <= 0:
                continue
            if cpu <= idle_cpu and mem <= idle_mem:
                continue                   # fits locally: not starvation
            if oldest is None or (age, job.uid) > oldest[:2]:
                oldest = (age, job.uid, cpu, mem)
        if oldest is None:
            return None
        return oldest[2], oldest[3]

    # -- introspection (/healthz?detail, vcctl) ------------------------------

    def detail(self) -> dict:
        counts = self.pmap.counts().get(self.pid, {})
        out = {
            "partition": self.pid,
            "epoch": self.epoch_fn(),
            "queues": counts.get("queues", 0),
            "nodes": counts.get("nodes", 0),
            "requests_filed": self.requests_filed,
            "map_version": self.pmap.version,
        }
        if self.rebalancer is not None:
            out["rebalance_moves"] = len(self.rebalancer.moves)
        if self.elastic is not None:
            out["splits"] = self.elastic.splits
            out["merges"] = self.elastic.merges
            out["retiring"] = self.elastic.retiring
        return out
