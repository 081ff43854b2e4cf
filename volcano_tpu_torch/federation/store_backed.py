"""Store-backed federation transport, the JAX package's
``federation/store_backed.py``: the PartitionMap and ReserveLedger as a
``PartitionState`` CR flowing through the store's CAS/watch path — what
real multi-process deployments run.

Topology: every partition process holds its OWN
:class:`StoreBackedPartitionMap` / :class:`StoreBackedReserveLedger`
mirror over a shared :class:`StorePartitionBackend`. Writes go through
``backend.mutate`` — read the CR, apply the transition to a deep copy
of its one-dict spec, CAS it back (``update(expect_rv=...)``), retrying
on :class:`ConflictError` with a fresh read. Remote writes arrive on a
resumable PartitionState watch and replace the mirror wholesale.

The two-phase reserve/transfer protocol stays correct under store
chaos BY this shape:

- a transition either CASes (one atomic spec replacement — other
  partitions see all of it or none of it) or raises out of ``mutate``
  into the federation hook's isolation: nothing was half-written, and
  the request's deadline still stands, so the pin releases by expiry —
  grants and ownership flips land atomically or time out and release;
- ownership flips are PERSIST-FIRST: ``_transfer_node_raw`` writes the
  CR before touching the local mirror, so a flip every other partition
  can see is also the flip the owner acts on (never the reverse —
  locally-flipped-but-unpublished would strand the node);
- a torn PartitionState watch merely staves a mirror: reviews pause,
  ``sync()`` (driven from the partition's cycle hooks) resumes/relists
  the stream, and deadlines bound every in-flight exchange meanwhile.

The CAS loop here IS a store write funnel, with retry semantics
(fresh-read-and-reapply) that the generic retrying transport cannot
provide.
"""

from __future__ import annotations

import copy
import logging
import threading
from typing import Callable, Dict, List, Optional

from ..apis.objects import ObjectMeta, PartitionStateCR
from ..store import ConflictError
from .partition import PartitionMap
from .reserve import _OPEN, ReserveLedger, ReserveRequest

log = logging.getLogger(__name__)

PARTITION_STATE_NS = "volcano-system"
PARTITION_STATE_NAME = "partition-state"
DEFAULT_CAS_ATTEMPTS = 8


class StateExhaustedError(RuntimeError):
    """A PartitionState CAS loop ran out of attempts (hot contention or
    a sick store past the retry funnel). The caller's transition did NOT
    happen; deadlines own the cleanup."""


class NoChange(Exception):
    """Raised by a mutate() transition fn to abort WITHOUT writing (the
    state already reflects the transition — e.g. an idempotent
    re-registration); carries the return value."""

    def __init__(self, value=None):
        super().__init__("no change")
        self.value = value


def _initial_state(n: int) -> dict:
    return {"n": int(n), "queue_owner": {}, "node_owner": {},
            "pinned": {}, "draining": {}, "rr_queue": 0, "rr_node": 0,
            "idle": {}, "requests": {}, "next_rid": 1,
            "active": {p: "active" for p in range(int(n))},
            "next_pid": int(n), "version": 0}


def _state_active(state: dict) -> dict:
    """The membership map off a CR spec, tolerating pre-elastic CRs
    that predate the ``active`` field (static {0..n-1} membership)."""
    active = state.get("active")
    if active is None:
        active = {p: "active" for p in range(int(state["n"]))}
    return active


class StorePartitionBackend:
    """One partition process's connection to the PartitionState CR:
    the CAS write funnel plus a resumable watch keeping the attached
    mirrors (map + ledger) converged."""

    def __init__(self, store, n_partitions: int,
                 namespace: str = PARTITION_STATE_NS,
                 name: str = PARTITION_STATE_NAME,
                 cas_attempts: int = DEFAULT_CAS_ATTEMPTS):
        self.store = store
        self.n = int(n_partitions)
        self.namespace = namespace
        self.name = name
        self.cas_attempts = max(int(cas_attempts), 1)
        self._listeners: List[Callable[[dict], None]] = []
        self._watch = None
        self.cas_conflicts = 0
        self.ensure()
        from ..cache.watches import ResumableWatch
        self._watch = ResumableWatch(store, "PartitionState",
                                     self._on_event)

    # -- wiring --------------------------------------------------------------

    def add_listener(self, fn: Callable[[dict], None]) -> None:
        self._listeners.append(fn)
        obj = self.store.get("PartitionState", self.namespace, self.name)
        if obj is not None:
            fn(obj.spec)

    def _on_event(self, event: str, obj, old) -> None:
        if obj is None or event == "deleted":
            return
        for fn in self._listeners:
            fn(obj.spec)

    def sync(self) -> None:
        """Resume the PartitionState stream if it tore (the partition's
        cycle-start hook drives this; a stale mirror self-heals here)."""
        if self._watch is not None and self._watch.torn:
            self._watch.resume()

    # -- the CAS funnel ------------------------------------------------------

    def ensure(self) -> None:
        """Create the CR if absent (CAS create-only, race-safe)."""
        if self.store.get("PartitionState", self.namespace,
                          self.name) is not None:
            return
        obj = PartitionStateCR(
            metadata=ObjectMeta(name=self.name, namespace=self.namespace),
            spec=_initial_state(self.n))
        try:
            self.store.update(obj, expect_rv=0)
        except ConflictError:
            pass                          # another partition won the race

    def mutate(self, fn: Callable[[dict], object]):
        """Apply ``fn`` to a deep copy of the CR spec and CAS it back;
        on conflict, re-read and re-apply. ``fn`` may raise to abort
        (nothing written). Returns ``fn``'s return value. Raises
        :class:`StateExhaustedError` past the attempt budget and lets
        transient store errors (already retried by the transport
        funnel) propagate — either way the transition did not happen."""
        for _ in range(self.cas_attempts):
            obj = self.store.get("PartitionState", self.namespace,
                                 self.name)
            if obj is None:
                self.ensure()
                continue
            state = copy.deepcopy(obj.spec)
            try:
                out = fn(state)
            except NoChange as nc:
                return nc.value
            state["version"] = int(state.get("version", 0)) + 1
            new = PartitionStateCR(
                metadata=ObjectMeta(name=self.name,
                                    namespace=self.namespace),
                spec=state)
            try:
                self.store.update(new,
                                  expect_rv=obj.metadata.resource_version)
                return out
            except ConflictError:
                self.cas_conflicts += 1
                continue
        raise StateExhaustedError(
            f"PartitionState CAS exhausted after {self.cas_attempts} "
            f"attempts ({self.cas_conflicts} conflicts total)")


class StoreBackedPartitionMap(PartitionMap):
    """PartitionMap mirror whose ownership state lives on the
    PartitionState CR. Registration and the raw transfer mutators (the
    funnel targets — still only callable from the reserve
    funnel) go through the backend's CAS loop; remote writes land via
    the watch. Ownership FLIPS persist before they apply locally (see
    the module docstring's atomicity argument)."""

    def __init__(self, backend: StorePartitionBackend):
        super().__init__(backend.n)
        self.backend = backend
        backend.add_listener(self._apply_state)

    def sync(self) -> None:
        self.backend.sync()

    # -- mirror application --------------------------------------------------

    def _apply_state(self, state: dict) -> None:
        with self._lock:
            self.queue_owner = dict(state.get("queue_owner", {}))
            self.node_owner = dict(state.get("node_owner", {}))
            self.pinned = dict(state.get("pinned", {}))
            self.draining = dict(state.get("draining", {}))
            self._rr_queue = int(state.get("rr_queue", 0))
            self._rr_node = int(state.get("rr_node", 0))
            self.active = {int(p): s
                           for p, s in _state_active(state).items()}
            self.next_pid = int(state.get("next_pid", state.get("n", 0)))
            self.version = int(state.get("version", 0))

    # -- registration (watch stream; CAS-allocated round-robin) --------------

    def register_queue(self, name: str) -> int:
        with self._lock:
            if name in self.queue_owner:
                return self.queue_owner[name]

        def assign(state: dict) -> int:
            owner = state["queue_owner"].get(name)
            if owner is not None:
                raise NoChange(owner)     # idempotent re-registration
            pids = sorted(int(p) for p, s in _state_active(state).items()
                          if s == "active")
            owner = pids[state["rr_queue"] % len(pids)]
            state["queue_owner"][name] = owner
            state["rr_queue"] += 1
            return owner

        return self.backend.mutate(assign)

    def register_node(self, name: str) -> int:
        with self._lock:
            if name in self.node_owner:
                return self.node_owner[name]

        def assign(state: dict) -> int:
            owner = state["node_owner"].get(name)
            if owner is not None:
                raise NoChange(owner)
            pids = sorted(int(p) for p, s in _state_active(state).items()
                          if s == "active")
            owner = pids[state["rr_node"] % len(pids)]
            state["node_owner"][name] = owner
            state["rr_node"] += 1
            return owner

        return self.backend.mutate(assign)

    def forget_node(self, name: str) -> None:
        def drop(state: dict) -> None:
            if name not in state["node_owner"] \
                    and name not in state["pinned"]:
                raise NoChange()
            state["node_owner"].pop(name, None)
            state["pinned"].pop(name, None)

        self.backend.mutate(drop)

    # -- ownership transfer (reserve funnel only; persist-first) -------------

    def _transfer_node_raw(self, node: str, to: int) -> None:
        def flip(state: dict) -> None:
            state["node_owner"][node] = to
            state["pinned"].pop(node, None)

        self.backend.mutate(flip)

    def _transfer_queue_raw(self, queue: str, to: int) -> None:
        def flip(state: dict) -> None:
            state["queue_owner"][queue] = to
            state["draining"].pop(queue, None)

        self.backend.mutate(flip)

    def _pin_node_raw(self, node: str, rid: Optional[int]) -> None:
        def pin(state: dict) -> None:
            if rid is None:
                state["pinned"].pop(node, None)
            else:
                state["pinned"][node] = rid

        self.backend.mutate(pin)

    def _begin_drain_raw(self, queue: str, to: int) -> None:
        def drain(state: dict) -> None:
            state["draining"][queue] = to

        self.backend.mutate(drain)

    # -- elastic membership (spawn/retire funnel only; persist-first) --------

    def _spawn_partition_raw(self) -> int:
        def spawn(state: dict) -> int:
            active = _state_active(state)
            pid = int(state.get("next_pid", state["n"]))
            active[pid] = "active"
            state["active"] = active
            state["next_pid"] = pid + 1
            return pid

        pid = self.backend.mutate(spawn)
        # the watch echo replaces the mirror wholesale; apply eagerly
        # too so the caller's active_pids() sees the pid it just minted
        with self._lock:
            self.active[pid] = "active"
            self.next_pid = max(self.next_pid, pid + 1)
            self.version += 1
        return pid

    def _begin_retire_raw(self, pid: int) -> None:
        def mark(state: dict) -> None:
            active = _state_active(state)
            if str(pid) in active:
                active[str(pid)] = "retiring"
            elif pid in active:
                active[pid] = "retiring"
            else:
                raise NoChange()
            state["active"] = active

        self.backend.mutate(mark)
        with self._lock:
            if pid in self.active:
                self.active[pid] = "retiring"
                self.version += 1

    def _retire_partition_raw(self, pid: int) -> None:
        def drop(state: dict) -> None:
            active = _state_active(state)
            if active.pop(str(pid), None) is None \
                    and active.pop(pid, None) is None:
                raise NoChange()
            state["active"] = active

        self.backend.mutate(drop)
        with self._lock:
            self.active.pop(pid, None)
            self.version += 1


class StoreBackedReserveLedger(ReserveLedger):
    """ReserveLedger mirror whose OPEN request set lives on the
    PartitionState CR: the requester files through CAS, the owner's
    mirror sees it via the watch, every transition persists, and a
    settled request leaves the CR (the journal's control records stay
    the durable audit trail). Protocol logic is entirely inherited —
    only rid allocation, idle publication and the persistence hooks
    differ."""

    _REQ_FIELDS = ("rid", "frm", "to", "cpu", "mem", "created",
                   "deadline", "state", "epoch_from", "epoch_to_observed",
                   "node", "epoch_granted")

    def __init__(self, pmap: StoreBackedPartitionMap,
                 backend: StorePartitionBackend, **kwargs):
        super().__init__(pmap, **kwargs)
        self.backend = backend
        backend.add_listener(self._apply_state)

    # -- hooks ---------------------------------------------------------------

    def _alloc_rid(self) -> int:
        def bump(state: dict) -> int:
            rid = int(state.get("next_rid", 1))
            state["next_rid"] = rid + 1
            return rid

        return self.backend.mutate(bump)

    def _persist_request(self, req: ReserveRequest) -> None:
        d = {k: getattr(req, k) for k in self._REQ_FIELDS}

        def put(state: dict) -> None:
            state["requests"][req.rid] = d

        self.backend.mutate(put)

    def _drop_request(self, req: ReserveRequest) -> None:
        def drop(state: dict) -> None:
            state["requests"].pop(req.rid, None)

        try:
            self.backend.mutate(drop)
        except Exception:
            # a settle whose CR removal failed: every partition's expire
            # scan still bounds the leftover open record by its deadline
            log.exception("dropping settled reserve %d from the CR "
                          "failed; deadline expiry owns the cleanup",
                          req.rid)

    def publish_idle(self, pid: int, cpu: float, mem: float) -> None:
        super().publish_idle(pid, cpu, mem)

        def put(state: dict) -> None:
            state["idle"][pid] = (float(cpu), float(mem))

        self.backend.mutate(put)

    def publish_load(self, pid: int, load: dict) -> None:
        """The rebalancer's load signals persist to the PartitionState
        CR next to idle — other partitions' rebalancers read them off
        their own CR mirrors."""
        super().publish_load(pid, load)

        def put(state: dict) -> None:
            state.setdefault("load", {})[pid] = dict(load)

        self.backend.mutate(put)

    def _persist_membership_purge(self, pid: int) -> None:
        def purge(state: dict) -> None:
            hit = False
            for key in ("idle", "load"):
                table = state.get(key, {})
                if table.pop(pid, None) is not None \
                        or table.pop(str(pid), None) is not None:
                    hit = True
            if not hit:
                raise NoChange()

        try:
            self.backend.mutate(purge)
        except Exception:
            # a purge whose CR write failed leaves stale idle/load
            # entries for a pid no longer in the membership — harmless:
            # every reader iterates active pids, never these tables
            log.exception("purging retired partition %d from the CR "
                          "failed", pid)

    # -- mirror application --------------------------------------------------

    def _apply_state(self, state: dict) -> None:
        reqs = state.get("requests", {})
        with self._lock:
            for pid, pair in state.get("idle", {}).items():
                self._idle[int(pid)] = (float(pair[0]), float(pair[1]))
            for pid, load in state.get("load", {}).items():
                # change-detected receipt stamping (_apply_load_locked):
                # a watch echo re-delivering an unchanged entry must not
                # refresh a dead publisher's freshness
                self._apply_load_locked(int(pid), dict(load))
            for rid, d in reqs.items():
                rid = int(rid)
                req = self.requests.get(rid)
                if req is None:
                    req = ReserveRequest(
                        rid, d["frm"], d["to"], d["cpu"], d["mem"],
                        d["created"], d["deadline"], d["epoch_from"],
                        d["epoch_to_observed"])
                    self.requests[rid] = req
                req.state = d["state"]
                req.node = d.get("node", "")
                req.deadline = d["deadline"]
                req.epoch_granted = d.get("epoch_granted", 0)
            # open requests gone from the CR were settled by another
            # partition: drop them from the mirror without re-counting
            # (the settling partition counted; the journal has the trail)
            for rid in [r for r in self.requests
                        if r not in reqs
                        and self.requests[r].state in _OPEN]:
                del self.requests[rid]
