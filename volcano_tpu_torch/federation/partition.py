"""PartitionMap: queue/node-shard ownership for the federated control
plane: the JAX package's ``federation/partition.py``.

Each partition owns a disjoint subset of queues (and therefore the jobs
in them — a task is only ever bound by its queue's owner, which is what
makes cross-partition double-binds impossible by construction) and a
disjoint shard of nodes (so partitions never race on capacity either).
Registration is deterministic round-robin in watch-stream order: the
same trace replays to the same map, which keeps ``sim --federated``
byte-deterministic.

Ownership TRANSFER is different from registration: moving a node or a
queue between partitions is a write to cluster state another partition
owns, and must flow through the reserve/transfer funnel
(federation/reserve.py) so it is journaled, epoch-stamped and
drain-safe. The raw mutators below (``_transfer_node_raw``,
``_transfer_queue_raw``, ``_pin_node_raw``, ``_begin_drain_raw``) exist
for that funnel alone (the JAX package's static analysis, vlint rule
VT009, flags any call to them without a ``_journal_reserve`` witness on
the path).

MEMBERSHIP is elastic (the membership-change protocol):
partitions can be spawned and retired at runtime through the journaled
``partition_spawn``/``partition_retire`` funnel on the reserve ledger.
The membership raw mutators (``_spawn_partition_raw``,
``_begin_retire_raw``, ``_retire_partition_raw``) exist for that funnel
alone (vlint rule VT019 in the JAX package flags any call without a
``_journal_reserve`` witness on the path). Partition ids are never
reused: ``next_pid`` only grows, so a fencing epoch, journal record or
pin that names a pid can never be confused with a later incarnation.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..api import ClusterInfo


class PartitionMap:
    """Thread-safe ownership map for N partitions. ``version`` bumps on
    every ownership change so consumers (scopes, health detail) can
    cheaply detect staleness."""

    def __init__(self, n_partitions: int):
        if n_partitions < 1:
            raise ValueError("n_partitions must be >= 1")
        self.n = int(n_partitions)
        self._lock = threading.Lock()
        self.queue_owner: Dict[str, int] = {}
        self.node_owner: Dict[str, int] = {}
        # queue -> destination pid while a queue move drains in-flight
        # intents (the two-phase move: neither side schedules the queue
        # until the flip — no orphaned intents, no double-binds)
        self.draining: Dict[str, int] = {}
        # node -> reserve rid while a grant drains the node before the
        # ownership flip; the owner's scope excludes pinned nodes so it
        # cannot refill capacity it is about to hand over
        self.pinned: Dict[str, int] = {}
        # elastic membership: pid -> "active" | "retiring". Static
        # deployments never touch this, so the initial map is exactly
        # {0..n-1: active} and every code path below degenerates to the
        # fixed-N arithmetic (byte-compat with pre-elastic runs).
        self.active: Dict[int, str] = {p: "active" for p in range(self.n)}
        self.next_pid = self.n
        self.version = 0
        self._rr_queue = 0
        self._rr_node = 0

    # -- membership lookups --------------------------------------------------

    def active_pids(self) -> List[int]:
        """Every live partition (including retiring ones still draining)."""
        with self._lock:
            return sorted(self.active)

    def assignable_pids(self) -> List[int]:
        """Partitions that may RECEIVE new ownership (not retiring)."""
        with self._lock:
            return sorted(p for p, s in self.active.items() if s == "active")

    def state_of(self, pid: int) -> Optional[str]:
        with self._lock:
            return self.active.get(pid)

    # -- registration (watch stream; deterministic round-robin) -------------

    def register_queue(self, name: str) -> int:
        """Assign a newly observed queue to a partition (idempotent)."""
        with self._lock:
            if name not in self.queue_owner:
                pids = sorted(p for p, s in self.active.items()
                              if s == "active")
                self.queue_owner[name] = pids[self._rr_queue % len(pids)]
                self._rr_queue += 1
                self.version += 1
            return self.queue_owner[name]

    def register_node(self, name: str) -> int:
        with self._lock:
            if name not in self.node_owner:
                pids = sorted(p for p, s in self.active.items()
                              if s == "active")
                self.node_owner[name] = pids[self._rr_node % len(pids)]
                self._rr_node += 1
                self.version += 1
            return self.node_owner[name]

    def forget_node(self, name: str) -> None:
        """The node left the cluster (node_fail): drop its ownership and
        any pending pin (the reserve ledger's expiry settles the
        request)."""
        with self._lock:
            self.node_owner.pop(name, None)
            self.pinned.pop(name, None)
            self.version += 1

    # -- lookups -------------------------------------------------------------

    def owner_of_queue(self, name: str) -> Optional[int]:
        with self._lock:
            return self.queue_owner.get(name)

    def owner_of_node(self, name: str) -> Optional[int]:
        with self._lock:
            return self.node_owner.get(name)

    def queues_of(self, pid: int) -> List[str]:
        with self._lock:
            return sorted(q for q, p in self.queue_owner.items() if p == pid)

    def nodes_of(self, pid: int) -> List[str]:
        with self._lock:
            return sorted(n for n, p in self.node_owner.items() if p == pid)

    def unpinned_nodes_of(self, pid: int) -> List[str]:
        with self._lock:
            return sorted(n for n, p in self.node_owner.items()
                          if p == pid and n not in self.pinned)

    def pin_of(self, node: str) -> Optional[int]:
        """The reserve rid a node is pinned for, or None — the locked
        read for protocol code (reading ``pinned`` raw would race a
        concurrent pin/unpin in a threaded deployment)."""
        with self._lock:
            return self.pinned.get(node)

    def counts(self) -> Dict[int, Dict[str, int]]:
        with self._lock:
            out = {p: {"queues": 0, "nodes": 0} for p in sorted(self.active)}
            for p in self.queue_owner.values():
                out.setdefault(p, {"queues": 0, "nodes": 0})["queues"] += 1
            for p in self.node_owner.values():
                out.setdefault(p, {"queues": 0, "nodes": 0})["nodes"] += 1
            return out

    # -- ownership transfer: reserve/transfer funnel ONLY ------------------

    def _transfer_node_raw(self, node: str, to: int) -> None:
        """Flip a node's owner. Reserve/transfer funnel only — callers
        must journal the transfer."""
        with self._lock:
            self.node_owner[node] = to
            self.pinned.pop(node, None)
            self.version += 1

    def _transfer_queue_raw(self, queue: str, to: int) -> None:
        with self._lock:
            self.queue_owner[queue] = to
            self.draining.pop(queue, None)
            self.version += 1

    def _pin_node_raw(self, node: str, rid: Optional[int]) -> None:
        """Pin (rid) or unpin (None) a node for an in-flight transfer."""
        with self._lock:
            if rid is None:
                self.pinned.pop(node, None)
            else:
                self.pinned[node] = rid
            self.version += 1

    def _begin_drain_raw(self, queue: str, to: int) -> None:
        with self._lock:
            self.draining[queue] = to
            self.version += 1

    # -- elastic membership: spawn/retire funnel ONLY ----------------------

    def _spawn_partition_raw(self) -> int:
        """Mint a new partition id. Membership funnel only — callers
        must journal the spawn. Pids are never reused."""
        with self._lock:
            pid = self.next_pid
            self.next_pid = pid + 1
            self.active[pid] = "active"
            self.version += 1
            return pid

    def _begin_retire_raw(self, pid: int) -> None:
        """Mark a partition retiring: it keeps scheduling what it still
        owns but can no longer receive queues/nodes or be a registration
        target. Membership funnel only."""
        with self._lock:
            if pid in self.active:
                self.active[pid] = "retiring"
                self.version += 1

    def _retire_partition_raw(self, pid: int) -> None:
        """Remove a fully drained partition from the membership.
        Membership funnel only."""
        with self._lock:
            self.active.pop(pid, None)
            self.version += 1

    # -- the per-partition scheduler scope -----------------------------------

    def scope(self, ci: ClusterInfo, pid: int) -> ClusterInfo:
        """Filter a cluster snapshot down to what partition ``pid``
        schedules: its owned queues (draining queues excluded — a queue
        mid-move is scheduled by NOBODY until the flip), the jobs in
        those queues, and its owned node shard minus nodes pinned for an
        in-flight transfer. Values are shared, not copied — this is a
        view, built per cycle after ``SchedulerCache.snapshot()``."""
        with self._lock:
            qown = self.queue_owner
            nown = self.node_owner
            draining = self.draining
            pinned = self.pinned
            out = ClusterInfo()
            out.queues = {u: q for u, q in ci.queues.items()
                          if qown.get(u) == pid and u not in draining}
            out.jobs = {u: j for u, j in ci.jobs.items()
                        if qown.get(j.queue) == pid
                        and j.queue not in draining}
            out.nodes = {n: node for n, node in ci.nodes.items()
                         if nown.get(n) == pid and n not in pinned}
            out.namespaces = ci.namespaces
            if hasattr(ci, "snap_epoch"):
                out.snap_epoch = ci.snap_epoch
            return out
