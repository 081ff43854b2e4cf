"""Load-driven partition rebalancing: the JAX package's
``federation/rebalance.py``.

Without it the federation sheds hot-partition load only through operator
``move_queue`` calls; this controller drives the SAME journaled funnel
from observed load instead. Every partition's leader runs one
:class:`RebalanceController` at its cycle end:

1. **publish** — compute this partition's load signals (pending task
   depth per owned queue, the cycle-budget exhaustion rate, total
   depth) and publish them through the reserve ledger (in-process: the
   shared board; store-backed: the PartitionState CR — other
   partitions read their own CR mirrors, never this cache);
2. **decide** — a deterministic greedy bin-balancer over LAST cycle's
   published signals: if this partition's pending depth exceeds the
   coolest partition's by both an absolute gap and a ratio (the
   hysteresis that keeps borderline imbalance from churning), pick the
   owned queue whose depth best halves the gap (largest depth <=
   gap/2, falling back to the largest depth < gap — a dominating hot
   queue still moves when moving it reduces imbalance);
3. **guard** — a device_health-style flap guard: each time a queue
   moves, its next move is refused for a DOUBLING abstention window
   (capped), so oscillating load cannot ping-pong a queue between
   partitions;
4. **execute** — ``ledger.move_queue(queue, target, epoch)``: the
   existing journaled, leader-gated, epoch-fenced two-phase move
   funnel. The queue drains (NEITHER side schedules it) and
   ``settle_moves`` flips ownership byte-deterministically — the
   rebalancer adds a decision layer, never a new mutation path
   (ownership writes stay inside the reserve funnel).

Only the OWNING partition's leader may initiate a move of its queue
(``move_queue`` refuses deposed epochs), so concurrent rebalancers
cannot fight over one queue; distinct hot partitions shed independently.
All inputs are published snapshots + the injectable clock, so
``sim --federated`` replays byte-identically.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional

log = logging.getLogger(__name__)

DEFAULT_MIN_DEPTH = 8          # below this, a partition is never "hot"
DEFAULT_MIN_GAP = 8            # absolute pending-depth hysteresis
DEFAULT_RATIO = 2.0            # hot/cool ratio hysteresis
DEFAULT_COOLDOWN_S = 8.0       # first per-queue abstention window
DEFAULT_MAX_COOLDOWN_S = 128.0


class RebalanceController:
    """One partition's slice of the load-driven rebalancer."""

    def __init__(self, pid: int, pmap, ledger, cache,
                 epoch_fn: Callable[[], int],
                 time_fn: Callable[[], float] = time.monotonic,
                 exhausted_fn: Optional[Callable[[], int]] = None,
                 min_depth: int = DEFAULT_MIN_DEPTH,
                 min_gap: int = DEFAULT_MIN_GAP,
                 ratio: float = DEFAULT_RATIO,
                 cooldown_s: float = DEFAULT_COOLDOWN_S,
                 max_cooldown_s: float = DEFAULT_MAX_COOLDOWN_S,
                 stale_after_s: Optional[float] = None):
        self.pid = pid
        self.pmap = pmap
        self.ledger = ledger
        self.cache = cache
        self.epoch_fn = epoch_fn
        self.time_fn = time_fn
        # reads the shell's cycle-budget exhaustion counter (monotonic);
        # the published rate is its per-step delta
        self.exhausted_fn = exhausted_fn or (lambda: 0)
        self.min_depth = int(min_depth)
        self.min_gap = int(min_gap)
        self.ratio = float(ratio)
        self.cooldown_s = float(cooldown_s)
        self.max_cooldown_s = float(max_cooldown_s)
        # published signals older than this are not trusted: a silent
        # (leaderless, torn-mirror) partition must never look like the
        # coolest move target — nothing drains a queue handed to a
        # partition that stopped publishing
        self.stale_after_s = float(stale_after_s) \
            if stale_after_s is not None else 2.0 * self.cooldown_s
        self._last_exhausted = 0
        self._steps = 0
        # flap guard state: queue -> (times moved, abstain-until)
        self._queue_moves: Dict[str, int] = {}
        self._queue_block: Dict[str, float] = {}
        # queues owned at the last step: a queue that APPEARS here mid-
        # run just arrived from another partition's rebalancer — give it
        # a settle window before this controller may move it on, or two
        # still-warm partitions hop one hot queue around the ring
        # instead of letting the new home drain it
        self._owned_prev: set = set()
        self.moves: List[dict] = []        # executed move history
        self.abstentions = 0
        self.refused = 0

    # -- load signals --------------------------------------------------------

    def queue_depths(self) -> Dict[str, int]:
        """Pending task count per queue this partition owns (live cache
        read — published for OTHERS to consume next cycle). The walk is
        bounded by the partition's own job population (the per-queue
        admission depth bound upstream)."""
        from ..api import TaskStatus
        owned = set(self.pmap.queues_of(self.pid))
        depths = {q: 0 for q in sorted(owned)}
        for job in self.cache.jobs.values():
            if job.queue not in owned:
                continue
            n = len(job.task_status_index.get(TaskStatus.PENDING, {}))
            if n:
                depths[job.queue] += n
        return depths

    def publish(self, now: Optional[float] = None) -> dict:
        now = self.time_fn() if now is None else now
        depths = self.queue_depths()
        exhausted = int(self.exhausted_fn())
        delta, self._last_exhausted = \
            exhausted - self._last_exhausted, exhausted
        self._steps += 1
        load = {
            "pending": sum(depths.values()),
            "queues": depths,
            "exhausted_delta": max(delta, 0),
            "t": round(now, 6),
        }
        self.ledger.publish_load(self.pid, load)
        return load

    # -- the decision --------------------------------------------------------

    def _flap_blocked(self, queue: str, now: float) -> bool:
        until = self._queue_block.get(queue)
        return until is not None and now < until

    def _note_move(self, queue: str, now: float) -> None:
        n = self._queue_moves.get(queue, 0) + 1
        self._queue_moves[queue] = n
        window = min(self.cooldown_s * (2 ** (n - 1)),
                     self.max_cooldown_s)
        self._queue_block[queue] = now + window

    def _pick_queue(self, depths: Dict[str, int], gap: int,
                    now: float) -> Optional[str]:
        """The greedy bin-balance choice: largest-depth owned queue that
        halves the gap, else the largest that still shrinks it. Never
        the last queue; never a flap-blocked or draining queue; never an
        empty one (moving idle queues is churn, not balance)."""
        candidates = [(d, q) for q, d in depths.items()
                      if 0 < d < gap
                      and not self._flap_blocked(q, now)
                      and q not in self.pmap.draining]
        # the last-queue guard counts queues that would REMAIN after
        # already-draining ones settle: a two-queue partition whose
        # first move is still draining must not move its second queue
        # too (both settle -> zero owned queues, a stranded node shard)
        settled = [q for q in depths if q not in self.pmap.draining]
        if len(settled) < 2 or not candidates:
            return None
        candidates.sort(key=lambda p: (-p[0], p[1]))
        for d, q in candidates:
            if d <= gap / 2:
                return q
        return candidates[0][1]            # dominating queue: still helps

    def step(self, now: Optional[float] = None) -> Optional[dict]:
        """One leader-gated cycle-end pass: publish, then move at most
        ONE queue when the hysteresis says this partition is genuinely
        hot. Returns the executed move record, or None."""
        from .. import metrics
        now = self.time_fn() if now is None else now
        load = self.publish(now)
        owned = set(load["queues"])
        if self._owned_prev:
            for q in owned - self._owned_prev:
                self._queue_block[q] = max(
                    self._queue_block.get(q, 0.0),
                    now + self.cooldown_s)
        self._owned_prev = owned
        move = self._decide(load, now)
        metrics.set_rebalance_detail(self.pid, self.detail())
        return move

    def _decide(self, load: dict, now: float) -> Optional[dict]:
        from .. import metrics
        own = int(load["pending"])
        if own < max(self.min_depth, 1):
            return None
        loads = self.ledger.loads()
        coolest = None
        coolest_pending = None
        # assignable pids only: a retired partition's stale load entry
        # (or a retiring one mid-drain) must never be a move target —
        # the elastic retire funnel also purges its ledger signals
        for pid in self.pmap.assignable_pids():
            if pid == self.pid:
                continue
            other = loads.get(pid)
            # freshness on the LOCAL receipt clock (ledger.load_seen):
            # the published dict's own timestamp is the publisher's
            # monotonic reading, not comparable across processes
            seen = self.ledger.load_seen(pid)
            if other is None or seen is None \
                    or now - seen > self.stale_after_s:
                # never published, or went silent: unknown is not idle
                continue
            pending = int(other.get("pending", 0))
            if coolest_pending is None or (pending, pid) \
                    < (coolest_pending, coolest):
                coolest, coolest_pending = pid, pending
        if coolest is None:
            return None
        gap = own - coolest_pending
        # hysteresis: both an absolute gap and a ratio must hold, so a
        # borderline imbalance (or one the last move already fixed)
        # never churns a queue back and forth
        if gap < self.min_gap or own < self.ratio * max(coolest_pending,
                                                        1):
            return None
        queue = self._pick_queue(dict(load["queues"]), gap, now)
        if queue is None:
            self.abstentions += 1
            metrics.register_rebalance_move("abstained")
            return None
        if not self.ledger.move_queue(queue, coolest, self.epoch_fn()):
            # deposed epoch, already draining, or ownership raced — the
            # funnel said no; nothing happened
            self.refused += 1
            metrics.register_rebalance_move("refused")
            return None
        self._note_move(queue, now)
        rec = {"t": round(now, 6), "queue": queue, "frm": self.pid,
               "to": coolest, "own_pending": own,
               "target_pending": coolest_pending}
        self.moves.append(rec)
        metrics.register_rebalance_move("moved")
        log.warning("rebalance: partition %d (pending %d) moving queue "
                    "%r to partition %d (pending %d)", self.pid, own,
                    queue, coolest, coolest_pending)
        return rec

    # -- introspection (vcctl federation rebalance-status) -------------------

    def detail(self) -> dict:
        return {
            "partition": self.pid,
            "moves": len(self.moves),
            "abstentions": self.abstentions,
            "refused": self.refused,
            "last_move": dict(self.moves[-1]) if self.moves else None,
            "blocked_queues": {
                q: round(until, 3)
                for q, until in sorted(self._queue_block.items())
                if until > self.time_fn()},
            "thresholds": {"min_depth": self.min_depth,
                           "min_gap": self.min_gap,
                           "ratio": self.ratio},
        }
