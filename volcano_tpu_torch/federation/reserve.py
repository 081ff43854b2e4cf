"""The cross-partition reserve/transfer protocol: the JAX package's
``federation/reserve.py``.

A starved partition cannot simply take capacity another partition owns —
that is a write to foreign cluster state, the federated analogue of the
split-brain double-bind. Instead every cross-partition reclaim flows
through this two-phase funnel, coordinated through the shared intent
journal:

1. **reserve** — the requester journals a ``reserve`` record naming the
   owning partition, the capacity it needs, its own fencing epoch AND
   the owner epoch it observed (both partitions' leaderships are named
   in the intent), and a virtual-time deadline;
2. **review** — the owner, at its next cycle boundary (leader-gated by
   the scheduler shell), grants or rejects. A grant picks a donor node,
   **pins** it (the owner's scope drops it, so the owner cannot refill
   capacity it is handing over), drains it by evicting the owner's own
   tasks through the owner's journaled+fenced evict funnel, and — once
   empty — journals the ``reserve_grant`` and flips the node's
   ownership in the PartitionMap;
3. **timeout-based release** — a request (or a half-granted pin) whose
   deadline passes is expired by WHICHEVER partition's cycle notices
   first, unpinning the node. A killed partition can therefore never
   strand capacity: its outstanding requests expire, its half-drained
   pins release, and the journal carries the full audit trail.

Queue moves (rebalancing a queue between partitions) ride the same
funnel: ``move_queue`` journals the move and marks the queue draining —
NEITHER partition schedules it — and ``settle_moves`` flips ownership
only once no open journal intent references the queue's jobs (no
orphaned intents, no double-binds across the flip).

All PartitionMap ownership transfers happen HERE, next to their
``_journal_reserve`` records; no other code path calls the raw transfer
mutators (vlint rule VT009 enforces it in the JAX package).
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from ..obs.lifecycle import TIMELINE
from ..obs.trace import TRACE as OBS_TRACE
from .partition import PartitionMap

log = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 8.0

REQUESTED = "requested"
GRANTING = "granting"      # node pinned, owner draining it
GRANTED = "granted"        # ownership transferred
REJECTED = "rejected"
EXPIRED = "expired"

_OPEN = (REQUESTED, GRANTING)


class ReserveRequest:
    """One cross-partition reserve, from journal record to settlement."""

    __slots__ = ("rid", "frm", "to", "cpu", "mem", "created", "deadline",
                 "state", "epoch_from", "epoch_to_observed", "node",
                 "epoch_granted")

    def __init__(self, rid: int, frm: int, to: int, cpu: float, mem: float,
                 created: float, deadline: float, epoch_from: int,
                 epoch_to_observed: int):
        self.rid = rid
        self.frm = frm                     # requesting partition
        self.to = to                       # owning partition
        self.cpu = float(cpu)
        self.mem = float(mem)
        self.created = created
        self.deadline = deadline
        self.state = REQUESTED
        self.epoch_from = epoch_from
        self.epoch_to_observed = epoch_to_observed
        self.node = ""                     # donor node once chosen
        self.epoch_granted = 0

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class ReserveLedger:
    """The shared reserve/transfer coordinator: in-process it is this
    object over the shared journal; a store-wired deployment would keep
    the same records in the store (the journal stream already crosses
    the process boundary via FileTailer). Thread-safe; all timestamps
    come from the injectable ``time_fn`` so ``sim --federated`` replays
    byte-deterministically."""

    def __init__(self, pmap: PartitionMap, journal=None, registry=None,
                 time_fn=time.monotonic,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 donor_guard: bool = False):
        self.pmap = pmap
        self.journal = journal
        self.registry = registry           # executors.FencingRegistry
        self.time_fn = time_fn
        self.timeout_s = timeout_s
        # Opt-in (elastic membership wires it on): a donor with its own
        # unadmitted gangs only donates EMPTY nodes. Off by default so
        # the static-federation decision plane is unchanged.
        self.donor_guard = donor_guard
        # reentrant: the store-backed subclass persists transitions
        # through a CAS funnel whose watch echo applies remote state
        # back onto this ledger's mirror — possibly on the same thread
        # that holds the lock mid-_settle
        self._lock = threading.RLock()
        self._rid = itertools.count(1)
        # OPEN requests only; settled ones move to the bounded history
        # below (the journal is the durable record), so a persistently
        # starved deployment filing one rejected request per cycle
        # cannot grow this dict — or the per-cycle scans — forever
        self.requests: Dict[int, ReserveRequest] = {}
        self.settled: "OrderedDict[int, ReserveRequest]" = OrderedDict()
        self.settled_keep = 64
        self.counts: Dict[str, int] = {}
        self.node_transfers = 0
        self.queue_moves = 0
        self._caches: Dict[int, object] = {}
        # pid -> (idle_cpu, idle_mem) published at each cycle end; the
        # requester's donor choice reads LAST cycle's published values,
        # never another partition's live cache
        self._idle: Dict[int, tuple] = {}
        # pid -> load-signal dict (pending depth, budget-exhaustion
        # rate, per-queue depths) published at each cycle end — the
        # load-driven rebalancer's only cross-partition input
        # decisions read LAST cycle's published
        # signals, never another partition's live cache
        self._load: Dict[int, dict] = {}
        # pid -> LOCAL receipt time of the last load-signal CHANGE.
        # Freshness must be judged on the READER's clock: the published
        # dict carries the publisher's own timestamp, and monotonic
        # epochs are not comparable across processes/hosts (the
        # store-backed deployment). An entry whose value stops changing
        # stops refreshing its receipt — a dead publisher goes stale no
        # matter what its last self-stamp claims.
        self._load_seen: Dict[int, float] = {}

    # -- wiring --------------------------------------------------------------

    def attach_cache(self, pid: int, cache) -> None:
        """Bind a partition's SchedulerCache (survives that partition's
        process restarts in the sim — cluster truth does not die with a
        scheduler)."""
        self._caches[pid] = cache

    def publish_idle(self, pid: int, cpu: float, mem: float) -> None:
        with self._lock:
            self._idle[pid] = (float(cpu), float(mem))

    def publish_load(self, pid: int, load: dict) -> None:
        """Publish a partition's load signals for the rebalancer
        (federation/rebalance.py); in-process the ledger IS the shared
        board, the store-backed subclass persists to the PartitionState
        CR."""
        with self._lock:
            self._apply_load_locked(pid, dict(load))

    def _apply_load_locked(self, pid: int, load: dict) -> None:
        """Caller holds self._lock: store a load signal and stamp its
        LOCAL receipt time iff the value changed (re-applying an
        unchanged entry — every CR watch echo re-delivers the whole
        state — must not keep a dead publisher looking fresh)."""
        if self._load.get(pid) != load:
            self._load_seen[pid] = self.time_fn()
        self._load[pid] = load

    def loads(self) -> Dict[int, dict]:
        """Every partition's last-published load signals (copies)."""
        with self._lock:
            return {pid: dict(d) for pid, d in self._load.items()}

    def load_seen(self, pid: int) -> Optional[float]:
        """LOCAL receipt time of ``pid``'s last load-signal change (the
        rebalancer's freshness witness), or None if never seen."""
        with self._lock:
            return self._load_seen.get(pid)

    def _count(self, result: str, n: int = 1) -> None:
        """Caller holds self._lock."""
        self.counts[result] = self.counts.get(result, 0) + n
        from .. import metrics
        metrics.register_cross_partition_reserve(result, n)

    def _settle(self, req: ReserveRequest, state: str) -> None:
        """Caller holds self._lock: move a request from the open set to
        the bounded settled history and count the outcome."""
        req.state = state
        self.requests.pop(req.rid, None)
        self.settled[req.rid] = req
        while len(self.settled) > self.settled_keep:
            self.settled.popitem(last=False)
        self._count(state)
        self._drop_request(req)

    # -- persistence hooks (federation/store_backed.py) ----------------------
    #
    # The in-process ledger IS the shared state, so these are no-ops. The
    # store-backed subclass persists every request transition to the
    # PartitionState CR through the CAS funnel, and allocates rids from
    # the CR — one protocol implementation, two transports.

    def _alloc_rid(self) -> int:
        return next(self._rid)

    def _persist_request(self, req: ReserveRequest) -> None:
        pass

    def _drop_request(self, req: ReserveRequest) -> None:
        pass

    def _persist_membership_purge(self, pid: int) -> None:
        pass

    def find(self, rid: int) -> Optional[ReserveRequest]:
        with self._lock:
            return self.requests.get(rid) or self.settled.get(rid)

    def _journal_reserve(self, kind: str, **fields) -> None:
        """The reserve/transfer journal funnel: every protocol step is a
        durable control record in the SHARED intent journal, so a
        restarted partition (or a warm standby tailing the stream) sees
        the full cross-partition audit trail.

        Each record carries a correlation ``ctx`` stamp
        (obs/lifecycle.py) unless the caller already attached job-level
        stamps — the ``ctx`` key is present only when the timeline store
        is enabled, so the pre-ctx record shape is preserved verbatim
        with the store off."""
        if self.journal is None:
            return
        if "ctx" not in fields and "jobs" not in fields:
            ctx = TIMELINE.stamp(part=fields.get("frm"),
                                 epoch=fields.get("epoch"))
            if ctx is not None:
                fields = dict(fields, ctx=ctx)
        self.journal.record_control(kind, fields)

    # -- requester side ------------------------------------------------------

    def outstanding(self, frm: int) -> Optional[ReserveRequest]:
        with self._lock:
            for req in self.requests.values():
                if req.frm == frm and req.state in _OPEN:
                    return req
        return None

    def pick_donor(self, frm: int) -> Optional[int]:
        """Deterministic donor choice: the other partition with the most
        recently PUBLISHED idle CPU (ties broken toward the lowest pid)
        that can afford to give a node up (keeps at least one unpinned
        node). Published values, not live reads — no partition ever
        inspects another's cache."""
        best: Optional[int] = None
        best_idle = -1.0
        for pid in self.pmap.assignable_pids():
            if pid == frm:
                continue
            if len(self.pmap.unpinned_nodes_of(pid)) <= 1:
                continue
            with self._lock:
                idle = self._idle.get(pid, (0.0, 0.0))[0]
            if idle > best_idle:
                best, best_idle = pid, idle
        return best

    def request(self, frm: int, to: int, cpu: float, mem: float,
                epoch_from: int) -> Optional[int]:
        """Journal a reserve intent from partition ``frm`` to owner
        ``to``; at most one outstanding request per requester. The
        intent is stamped with BOTH partitions' fencing epochs — the
        requester's own and the owner epoch it observed through the
        fencing registry."""
        if to == frm or self.pmap.state_of(to) != "active":
            return None
        if self.outstanding(frm) is not None:
            return None
        now = self.time_fn()
        epoch_to = self.registry.current(to) if self.registry is not None \
            else 0
        rid = self._alloc_rid()
        with self._lock:
            req = ReserveRequest(rid, frm, to, cpu, mem, now,
                                 now + self.timeout_s, epoch_from, epoch_to)
            self.requests[rid] = req
            self._count(REQUESTED)
        self._persist_request(req)
        self._journal_reserve("reserve", rid=rid, frm=frm, to=to, cpu=cpu,
                              mem=mem, epoch_from=epoch_from,
                              epoch_to=epoch_to, deadline=req.deadline)
        return rid

    # -- owner side (cycle boundary) -----------------------------------------

    def review(self, pid: int, epoch: int) -> None:
        """Grant or reject every open request addressed to partition
        ``pid`` — called by the owner's leader at its cycle boundary
        (the scheduler shell's federation hook). ``epoch`` is the
        reviewing leadership's fencing epoch; a deposed leader (epoch
        below the partition's watermark) may not settle anything."""
        if self.registry is not None and epoch < self.registry.current(pid):
            return
        cache = self._caches.get(pid)
        if cache is None:
            return
        with self._lock:
            pending = sorted((r.rid, r) for r in self.requests.values()
                             if r.to == pid and r.state in _OPEN)
        for _, req in pending:
            if req.state == REQUESTED:
                self._start_grant(req, cache, epoch)
            if req.state == GRANTING:
                self._drain_and_transfer(req, cache, epoch)
        self._vacate_pinned(pid, cache)
        if self.donor_guard:
            self._evict_straddlers(pid, cache)

    def _evict_straddlers(self, pid: int, cache) -> None:
        """Membership hygiene (elastic only, with ``donor_guard``): a
        gang that is NOT fully admitted must not straddle a membership
        change. After a queue move its half-bound tasks can sit on
        nodes the new owner does not own — remote usage that still
        counts against the queue's share while the scoped capacity can
        never complete the gang (proportion sees the queue overused,
        allocate binds nothing, the placed tasks' durations never start
        because the gang never re-admits: a permanent deadlock). Evict
        the foreign-placed tasks of unadmitted gangs; the gang re-pends
        whole and binds cleanly inside the new owner's scope."""
        from ..api import TaskStatus
        owned = set(self.pmap.nodes_of(pid))
        for job in sorted(cache.jobs.values(), key=lambda j: j.uid):
            if job.ready():
                continue
            for uid in sorted(job.tasks):
                task = job.tasks[uid]
                if not task.node_name or task.node_name in owned:
                    continue
                if task.status in (TaskStatus.RELEASING,
                                   TaskStatus.PENDING):
                    continue
                try:
                    cache.evict(task, "membership-straddle")
                except Exception:
                    log.exception("straddler evict %s failed; the "
                                  "resync queue owns the retry", uid)

    def _vacate_pinned(self, pid: int, cache) -> None:
        """Evict partition ``pid``'s own straggler tasks off any node
        pinned for an open grant. Queue moves (rebalancer, elastic
        split/merge) can home a RUNNING task in a partition that does
        not own its node — the donor's drain walks only its own mirror,
        so without this sweep a pinned node could transfer while still
        loaded and the receiver would overcommit it. Each partition
        evicts through its OWN journaled+fenced funnel; the donor's
        drain waits for every mirror to empty."""
        from ..api import TaskStatus
        with self._lock:
            pinned = sorted(req.node for req in self.requests.values()
                            if req.state == GRANTING and req.node
                            and req.to != pid)
        for name in pinned:
            node = cache.nodes.get(name)
            if node is None or not node.tasks:
                continue
            for uid in sorted(node.tasks):
                clone = node.tasks[uid]
                job = cache.jobs.get(clone.job)
                task = job.tasks.get(uid) if job is not None else None
                if task is None or task.status == TaskStatus.RELEASING:
                    continue
                try:
                    cache.evict(task, "cross-partition-reserve")
                except Exception:
                    log.exception("pinned-node vacate evict %s failed; "
                                  "the resync queue owns the retry", uid)

    @staticmethod
    def _has_pending_demand(cache) -> bool:
        """True when the donor's own cache holds an unadmitted gang with
        PENDING tasks — the same demand signal ``_starved_need`` reads,
        without the age horizon (OWN state only; never another
        partition's cache)."""
        from ..api import TaskStatus
        for job in cache.jobs.values():
            if job.min_available <= 0 or job.ready():
                continue
            for task in job.tasks.values():
                if task.status == TaskStatus.PENDING:
                    return True
        return False

    def _eligible_nodes(self, pid: int, cache) -> List[str]:
        out = []
        for name in self.pmap.unpinned_nodes_of(pid):
            node = cache.nodes.get(name)
            if node is not None and node.ready:
                out.append(name)
        return out

    def _start_grant(self, req: ReserveRequest, cache, epoch: int) -> None:
        """Phase 2a: choose and pin a donor node, or reject. The donor
        is the owner's least-loaded eligible node that covers the
        request by ALLOCATABLE (capacity follows demand even when the
        node is currently busy — draining empties it), falling back to
        the largest node when none covers it fully. The owner always
        keeps one unpinned node.

        A donor that itself has PENDING demand may only hand over EMPTY
        nodes: draining a busy node evicts running work the donor still
        needs placed, and under systemic overload (everyone starved,
        everyone publishing residual idle) those mutual drains destroy
        bound work faster than it can complete — a cluster-wide
        livelock. An unloaded donor keeps the original capacity-follows-
        demand behavior: its busy nodes drain and transfer."""
        nodes = self._eligible_nodes(req.to, cache)
        if len(nodes) <= 1:
            with self._lock:
                self._settle(req, REJECTED)
            self._journal_reserve("reserve_reject", rid=req.rid,
                                  epoch=epoch, reason="last-node")
            return
        if self.donor_guard and self._has_pending_demand(cache):
            nodes = [n for n in nodes if not cache.nodes[n].tasks]
            if not nodes:
                with self._lock:
                    self._settle(req, REJECTED)
                self._journal_reserve("reserve_reject", rid=req.rid,
                                      epoch=epoch, reason="donor-loaded")
                return
        covering = [n for n in nodes
                    if cache.nodes[n].allocatable.cpu >= req.cpu
                    and cache.nodes[n].allocatable.memory >= req.mem]
        if covering:
            # fewest resident tasks first (cheapest drain), then name
            chosen = min(covering,
                         key=lambda n: (len(cache.nodes[n].tasks), n))
        else:
            # nothing covers the request: hand over the LARGEST node
            # (maximum delivered capacity per transfer — repeated
            # small-node grants would churn without ever fitting the gang)
            chosen = min(nodes,
                         key=lambda n: (-cache.nodes[n].allocatable.cpu,
                                        len(cache.nodes[n].tasks), n))
        with self._lock:
            req.node = chosen
            req.state = GRANTING
        # persist the request transition BEFORE the pin: the pin write's
        # watch echo re-applies the CR's request record onto local
        # mirrors, so the record must already say GRANTING (store-backed
        # transport ordering, federation/store_backed.py)
        self._persist_request(req)
        self.pmap._pin_node_raw(chosen, req.rid)
        self._journal_reserve("reserve_pin", rid=req.rid, node=chosen,
                              epoch=epoch)

    def _drain_and_transfer(self, req: ReserveRequest, cache,
                            epoch: int) -> None:
        """Phase 2b: evict the owner's remaining tasks off the pinned
        node through the owner's OWN journaled+fenced evict funnel, and
        flip ownership once the node is empty. The requester never
        touches the owner's state."""
        from ..api import TaskStatus
        node = cache.nodes.get(req.node)
        if node is None or self.pmap.pin_of(req.node) != req.rid:
            # the donor vanished (node_fail) mid-drain: back to square
            # one; the deadline still bounds the whole exchange
            with self._lock:
                req.node = ""
                req.state = REQUESTED
            self._persist_request(req)
            return
        if node.tasks:
            for uid in sorted(node.tasks):
                clone = node.tasks[uid]
                job = cache.jobs.get(clone.job)
                task = job.tasks.get(uid) if job is not None else None
                if task is None or task.status == TaskStatus.RELEASING:
                    continue
                try:
                    cache.evict(task, "cross-partition-reserve")
                except Exception:
                    log.exception("reserve drain evict %s failed; the "
                                  "resync queue owns the retry", uid)
            if node.tasks:
                return                 # not empty yet: next cycle
        for other in self._caches.values():
            # a task whose queue moved away (rebalancer/elastic) is
            # homed in ANOTHER partition's cache while still placed on
            # this node — that partition's _vacate_pinned sweep evicts
            # it; the transfer must wait for every mirror to drain or
            # the receiver would see a loaded node as empty
            mirror = other.nodes.get(req.node)
            if mirror is not None and mirror.tasks:
                return
        self.pmap._transfer_node_raw(req.node, req.frm)
        with self._lock:
            req.epoch_granted = epoch
            self.node_transfers += 1
            self._settle(req, GRANTED)
        self._journal_reserve("reserve_grant", rid=req.rid, node=req.node,
                              frm=req.to, to=req.frm,
                              epoch_from=req.epoch_from, epoch=epoch)

    # -- timeout-based release (any partition's cycle) -----------------------

    def expire(self, now: Optional[float] = None) -> int:
        """Settle every open request whose deadline passed — run by
        WHICHEVER partition's cycle gets there first, so a killed
        requester or owner can never strand a request (or a pinned,
        half-drained node) forever."""
        now = self.time_fn() if now is None else now
        expired = []
        with self._lock:
            for req in list(self.requests.values()):
                if req.state in _OPEN and now > req.deadline:
                    expired.append(req)
                    self._settle(req, EXPIRED)
        for req in expired:
            if req.node:
                self.pmap._pin_node_raw(req.node, None)
            self._journal_reserve("reserve_expire", rid=req.rid,
                                  node=req.node)
        return len(expired)

    # -- queue rebalancing (the same funnel) ---------------------------------

    def move_queue(self, queue: str, to: int, epoch: int) -> bool:
        """Begin rebalancing ``queue`` to partition ``to``: journal the
        move and mark the queue draining. Ownership flips only in
        ``settle_moves`` once the queue's in-flight intents drained."""
        frm = self.pmap.owner_of_queue(queue)
        if frm is None or frm == to or queue in self.pmap.draining:
            return False
        if self.registry is not None \
                and epoch < self.registry.current(frm):
            return False             # a deposed leader may not move queues
        self._journal_reserve("queue_move", queue=queue, frm=frm, to=to,
                              epoch=epoch)
        self.pmap._begin_drain_raw(queue, to)
        return True

    def _queue_has_open_intents(self, queue: str, cache) -> bool:
        if self.journal is None:
            return False
        for intent in self.journal.unacked():
            job = cache.jobs.get(intent.job)
            if job is not None and job.queue == queue:
                return True
        return False

    def settle_moves(self, pid: int, epoch: int) -> int:
        """Complete every draining queue move whose source is ``pid``:
        once no open journal intent references the queue's jobs, move
        the jobs (and their node mirrors) to the destination partition's
        cache and flip ownership. Returns the number of flips."""
        if self.registry is not None and epoch < self.registry.current(pid):
            return 0                 # deposed-epoch reviewers may not flip
        cache = self._caches.get(pid)
        if cache is None:
            return 0
        moves = [(q, dest) for q, dest in sorted(self.pmap.draining.items())
                 if self.pmap.owner_of_queue(q) == pid]
        flipped = 0
        for queue, dest in moves:
            if self._queue_has_open_intents(queue, cache):
                continue
            dest_cache = self._caches.get(dest)
            if dest_cache is None:
                continue
            moved_jobs = self._move_queue_jobs(queue, cache, dest_cache)
            if moved_jobs is None:
                continue             # mirrors not ready: next cycle
            self.pmap._transfer_queue_raw(queue, dest)
            with self._lock:
                self.queue_moves += 1
            # per-job lifecycle stamps: each moved job gets
            # its own correlation ctx, recorded locally AND carried
            # inside the single queue_move_done record, so a follower on
            # the destination continues every job's timeline without a
            # duplicate (the store dedupes on (part, eid))
            job_ctx: Dict[str, dict] = {}
            for jid in moved_jobs:
                ctx = TIMELINE.stamp(part=pid, epoch=epoch)
                if ctx is not None:
                    job_ctx[jid] = ctx
                    TIMELINE.record(jid, "move", ctx=ctx, queue=queue,
                                    frm=pid, to=dest)
                    OBS_TRACE.flow_step("queue_move", f"job:{jid}",
                                        queue=queue)
            extra = {"jobs": job_ctx} if job_ctx else {}
            self._journal_reserve("queue_move_done", queue=queue, frm=pid,
                                  to=dest, epoch=epoch, **extra)
            flipped += 1
        return flipped

    @staticmethod
    def _move_queue_jobs(queue: str, frm_cache,
                         to_cache) -> Optional[List[str]]:
        """Surgically move a drained queue's jobs between partition
        caches: the job objects (and their placed tasks' node-mirror
        accounting) leave the source cache — remove_job also purges any
        queued retry/dead-letter state, so no orphaned side effects —
        and land in the destination, dirty-marked on both sides.
        Returns the moved job uids, or ``None`` when the flip deferred.

        The move is all-or-nothing: before touching either cache it
        proves every placed task fits its destination node mirror.
        A mirror that cannot absorb the accounting (a transient skew
        while an eviction or vacate sweep is still in flight) defers
        the whole flip to the next cycle — a half-applied move would
        strand jobs in a cache whose queue it no longer owns."""
        from ..api import TaskStatus
        moved = [j for j in list(frm_cache.jobs.values())
                 if j.queue == queue]
        demand: Dict[str, List] = {}
        for job in moved:
            for task in job.tasks.values():
                if task.node_name and task.status != TaskStatus.PIPELINED:
                    demand.setdefault(task.node_name, []).append(task)
        for node_name, tasks in demand.items():
            node = to_cache.nodes.get(node_name)
            if node is None:
                continue
            headroom = node.idle.clone()
            for task in tasks:
                if task.uid in node.tasks:
                    continue
                if not task.resreq.less_equal(headroom):
                    log.warning(
                        "deferring queue %s move: node %s mirror in the "
                        "destination cannot absorb task %s yet",
                        queue, node_name, task.uid)
                    return None
                headroom.sub(task.resreq)
        for job in moved:
            frm_cache.remove_job(job.uid)
            for task in job.tasks.values():
                node_name = task.node_name
                if node_name and node_name in frm_cache.nodes:
                    frm_cache.mark_node_dirty(node_name)
                    frm_cache.nodes[node_name].remove_task(task)
                    # remove_task clears node_name, but the task is
                    # still PLACED cluster-side — only its cache home
                    # moves; restore it for the destination mirror
                    task.node_name = node_name
            to_cache.add_job(job)
            for task in job.tasks.values():
                node = to_cache.nodes.get(task.node_name) \
                    if task.node_name else None
                if node is not None and task.uid not in node.tasks:
                    to_cache.mark_node_dirty(node.name)
                    node.add_task(task)
        return [job.uid for job in moved]

    # -- elastic membership (the same journaled funnel) --------------------

    def release_nodes(self, pid: int, to: int, epoch: int) -> int:
        """MERGE node drain: hand every unpinned node partition ``pid``
        owns that is EMPTY in its own cache (its resident tasks either
        completed or left with their moved jobs — whose mirrors already
        live in the destination cache) to partition ``to``, through the
        journaled transfer funnel. Nodes still running the retiring
        partition's tasks stay until they drain naturally; pinned nodes
        belong to an open reserve, which ``retire_blockers`` defers on
        anyway. Returns how many nodes ``pid`` still owns."""
        if self.registry is not None \
                and epoch < self.registry.current(pid):
            return len(self.pmap.nodes_of(pid))
        if self.pmap.state_of(to) != "active":
            return len(self.pmap.nodes_of(pid))
        cache = self._caches.get(pid)
        for name in self.pmap.unpinned_nodes_of(pid):
            node = cache.nodes.get(name) if cache is not None else None
            if node is not None and node.tasks:
                continue
            self._journal_reserve("node_handoff", node=name, frm=pid,
                                  to=to, epoch=epoch)
            self.pmap._transfer_node_raw(name, to)
            with self._lock:
                self.node_transfers += 1
        return len(self.pmap.nodes_of(pid))

    def partition_spawn(self, frm: int, epoch: int) -> Optional[int]:
        """SPLIT phase 1: mint a new partition id through the journaled
        membership funnel. ``frm`` is the splitting partition; its
        fencing epoch gates the record (a deposed leader may not grow
        the membership). Store-backed, the mint is one CAS on the
        PartitionState CR — other partitions see the new member or
        don't, never a torn state. The caller (the elastic controller's
        runner hooks) then spawns the scheduler shell + per-partition
        Lease and moves queues via the EXISTING ``move_queue`` funnel,
        so no job is ever schedulable by two partitions at any
        instant."""
        if self.registry is not None \
                and epoch < self.registry.current(frm):
            return None
        pid = self.pmap._spawn_partition_raw()
        self._journal_reserve("partition_spawn", pid=pid, frm=frm,
                              epoch=epoch)
        return pid

    def begin_retire(self, pid: int, epoch: int) -> bool:
        """MERGE phase 1: mark ``pid`` retiring — it keeps scheduling
        what it still owns while its queues drain away through
        ``move_queue``, but can no longer receive ownership, be a
        donor/requester target, or take new registrations. Refuses for
        the last active partition (the membership never empties)."""
        if self.pmap.state_of(pid) != "active":
            return False
        if self.registry is not None \
                and epoch < self.registry.current(pid):
            return False
        if len(self.pmap.assignable_pids()) <= 1:
            return False
        self._journal_reserve("partition_retire_begin", pid=pid,
                              epoch=epoch)
        self.pmap._begin_retire_raw(pid)
        return True

    def retire_blockers(self, pid: int) -> List[str]:
        """What still prevents ``pid`` from retiring — the merge defers
        (returns non-empty) while ANY of these reference the partition:
        owned queues/nodes, draining moves touching it, an OPEN reserve
        naming it as requester or owner (a pin held by a retiring
        partition releases only by grant or deadline expiry — the
        ledger, not the retirement, owns that lifecycle), or an open
        journal intent on a job still homed in its cache."""
        out: List[str] = []
        if self.pmap.queues_of(pid):
            out.append("owned-queues")
        if self.pmap.nodes_of(pid):
            out.append("owned-nodes")
        with self.pmap._lock:
            draining = dict(self.pmap.draining)
        for queue, dest in draining.items():
            if dest == pid:
                out.append("draining-inbound")
                break
        with self._lock:
            for req in self.requests.values():
                if req.state in _OPEN and pid in (req.frm, req.to):
                    out.append("open-reserve")
                    break
        cache = self._caches.get(pid)
        if cache is not None and self.journal is not None:
            for intent in self.journal.unacked():
                if intent.job in cache.jobs:
                    out.append("open-intent")
                    break
        return out

    def partition_retire(self, pid: int, epoch: int) -> bool:
        """MERGE phase 2: retire a fully drained partition. Defers
        (returns False) while ``retire_blockers`` is non-empty — in
        particular an open cross-partition reserve pin held by the
        retiring partition defers retirement until the ledger's
        deadline expiry releases it. On success the membership record
        journals, the pid leaves the map, and every ledger signal the
        partition ever published (idle, load, load_seen freshness,
        cache attachment) is purged so the retired pid can never
        linger as a ghost donor or rebalance target."""
        if self.pmap.state_of(pid) is None:
            return False
        if self.registry is not None \
                and epoch < self.registry.current(pid):
            return False
        if self.retire_blockers(pid):
            return False
        self._journal_reserve("partition_retire", pid=pid, epoch=epoch)
        self.pmap._retire_partition_raw(pid)
        self.purge_partition(pid)
        return True

    def purge_partition(self, pid: int) -> None:
        """Drop every per-partition signal for a retired pid (the ghost
        -partition fix): without this, stale ``load_seen``/``idle``
        entries keep the dead pid a candidate donor and rebalance
        target until freshness expiry."""
        with self._lock:
            self._idle.pop(pid, None)
            self._load.pop(pid, None)
            self._load_seen.pop(pid, None)
            self._caches.pop(pid, None)
        self._persist_membership_purge(pid)

    # -- introspection -------------------------------------------------------

    def detail(self) -> dict:
        with self._lock:
            open_reqs = [r.as_dict() for r in self.requests.values()
                         if r.state in _OPEN]
            return {
                "counts": dict(self.counts),
                "node_transfers": self.node_transfers,
                "queue_moves": self.queue_moves,
                "open": sorted(open_reqs, key=lambda d: d["rid"]),
            }
