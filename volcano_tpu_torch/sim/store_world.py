"""Store-wired sim mode (docs/simulation.md --store-wired): the cluster
truth lives in a real :class:`ObjectStore` and every scheduler↔cluster
interaction crosses the hostile store boundary of store_transport.py —
per-verb seeded faults (latency on virtual time, transients the retry
funnel must absorb, 409s), torn watch streams the resumable informers
must recover, and the store-backed federation CR when combined with
``--federated``.

Topology per scheduler (partition): its OWN FaultyStoreTransport (own
seeded injector — two apiserver connections don't fail in lockstep)
under a RetryingStoreTransport pinned to the virtual clock and a seeded
jitter RNG; the cache is wired through resumable watches
(cache/watches.py), so the scheduler epilogue's upkeep step IS what
heals torn streams mid-soak.

Harness-side operations (the kubelet/job-controller analogues the sim
performs: completing gangs, recreating evicted pods, node death) go to
the RAW store — they model cluster components, not the scheduler's
connection, and the soak's accounting oracle must not depend on the
harness outrunning its own chaos. Client submissions DO ride a faulted
transport and re-queue on failure (a client retrying its POST).

The bind/evict determinism witness: a shared recording wrapper between
the (chaos/kill) wrappers and the per-scheduler StoreBinder — exactly
the executions that reached the store, in execution order, which is
also the crash-window oracle the journal reconciler consumes.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, List, Optional, Tuple

from ..apis.objects import (ObjectMeta, Pod, PodGroupCR, PodGroupSpec,
                            PodTemplate, PriorityClass, QueueCR,
                            QueueSpecCR)
from ..api import Resource
from ..cache import SchedulerCache
from ..cache.executors import (Binder, Evictor, StoreBinder, StoreEvictor,
                               StoreStatusUpdater)
from ..cache.store_wiring import GROUP_NAME_ANNOTATION, wire_cache_to_store
from ..chaos import StoreFaultInjector
from ..store import ObjectStore
from ..store_transport import FaultyStoreTransport, RetryingStoreTransport


class SharedWitness:
    """Duck-typed stand-in for SequenceBinder/SequenceEvictor on the
    runner: the shared ``sequence`` every partition's recording wrapper
    appends to (and ``binds`` for the binder half)."""

    def __init__(self):
        self.sequence: List = []
        self.binds: Dict[str, str] = {}


class RecordingBinder(Binder):
    """Appends to the shared witness AFTER the inner executor succeeded
    — the bind reached the store (SequenceBinder semantics over a real,
    failable executor)."""

    def __init__(self, inner: Binder, witness: SharedWitness):
        self.inner = inner
        self.witness = witness

    def bind(self, task, hostname: str) -> None:
        self.inner.bind(task, hostname)
        self.witness.sequence.append((task.uid, hostname))
        self.witness.binds[task.key()] = hostname


class RecordingEvictor(Evictor):
    def __init__(self, inner: Evictor, witness: SharedWitness):
        self.inner = inner
        self.witness = witness

    def evict(self, task, reason: str) -> None:
        self.inner.evict(task, reason)
        self.witness.sequence.append(task.uid)


class StoreWorld:
    """The store-wired sim's cluster: one raw ObjectStore (truth), one
    hostile transport per scheduler, the shared bind/evict witness, and
    the pod blueprints the harness recreates evicted pods from."""

    def __init__(self, clock, fault_rate: float = 0.0, fault_seed: int = 0,
                 latency_s: float = 0.05, n_schedulers: int = 1,
                 retry_rng_seed: int = 0, period: float = 1.0):
        self.clock = clock
        self.store = ObjectStore()
        self.fault_rate = fault_rate
        self.fault_seed = fault_seed
        self.latency_s = latency_s
        self.retry_rng_seed = retry_rng_seed
        self.period = period
        self.bind_witness = SharedWitness()
        self.evict_witness = SharedWitness()
        self.injectors: List[StoreFaultInjector] = []
        self.faulties: List[FaultyStoreTransport] = []
        self.transports: List[RetryingStoreTransport] = []
        for _ in range(max(n_schedulers, 1)):
            self.add_scheduler()
        # pod uid -> blueprint for the controller-recreate analogue
        self._blueprints: Dict[str, dict] = {}
        self._known_prio: set = set()
        # completed job names: a still-retrying submission thunk must
        # not resurrect a gang that already finished
        self._completed: set = set()

    # -- per-scheduler wiring -------------------------------------------------

    def add_scheduler(self) -> int:
        """Mint one more scheduler's hostile store chain (its own seeded
        injector under its own retry funnel) and return its transport
        index. Seeds derive from the index exactly as at construction,
        so a partition SPAWNED mid-run (sim --elastic) replays the same
        fault stream a same-index partition built up front would — the
        elastic soak stays byte-deterministic."""
        i = len(self.transports)
        inj = StoreFaultInjector(
            failure_rate=self.fault_rate, seed=self.fault_seed * 7919 + i,
            latency_s=self.latency_s, sleep_fn=self.clock.sleep)
        faulty = FaultyStoreTransport(self.store, inj)
        transport = RetryingStoreTransport(
            faulty, sleep_fn=self.clock.sleep, time_fn=self.clock.time,
            cycle_budget_s=2.0 * self.period,
            rng=random.Random(self.retry_rng_seed * 31 + i))
        self.injectors.append(inj)
        self.faulties.append(faulty)
        self.transports.append(transport)
        return i

    def build_cache(self, ix: int = 0,
                    binder_wrap: Optional[Callable] = None,
                    evictor_wrap: Optional[Callable] = None,
                    journal=None,
                    event_filter: Optional[Callable] = None,
                    fence: Optional[Callable] = None,
                    ) -> Tuple[SchedulerCache, Binder, Evictor]:
        """One scheduler's cache over its own hostile transport:
        executors ride retry funnel → faulty transport → store, wrapped
        (inside out) by the shared witness recorder, the optional chaos
        wraps, and the optional fencing gate (``fence(binder, evictor)``
        applied OUTERMOST, matching the HA/federated chains). Returns
        ``(cache, kill_binder_slot, kill_evictor_slot)`` — the chain
        BEFORE fencing so kill wrappers can be interposed by the
        caller."""
        transport = self.transports[ix]
        binder: Binder = RecordingBinder(StoreBinder(transport),
                                         self.bind_witness)
        evictor: Evictor = RecordingEvictor(StoreEvictor(transport),
                                            self.evict_witness)
        if binder_wrap is not None:
            binder = binder_wrap(binder)
        if evictor_wrap is not None:
            evictor = evictor_wrap(evictor)
        cache = SchedulerCache(
            binder=binder, evictor=evictor,
            status_updater=StoreStatusUpdater(transport),
            default_queue=None, journal=journal)
        cache.resync_queue.time_fn = self.clock.time
        cache.time_fn = self.clock.time
        wire_cache_to_store(transport, cache=cache,
                            event_filter=event_filter)
        return cache, binder, evictor

    # -- seeded whole-stream tears -------------------------------------------

    def tear_streams(self, n: int, rng: random.Random) -> List[str]:
        """Tear ``n`` live watch streams chosen across every scheduler's
        transport — the scheduled torn-watch drill; the schedulers'
        epilogue upkeep (or the federation sync hook) must recover them."""
        torn: List[str] = []
        for _ in range(n):
            live = [(f, s) for f in self.faulties
                    for s in f.streams if not s.torn]
            if not live:
                break
            f, s = live[rng.randrange(len(live))]
            s.tear()
            torn.append(s.kind)
            from .. import metrics
            metrics.register_store_fault("watch", "torn")
        return torn

    def faults_detail(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for inj in self.injectors:
            for kind, n in inj.injected.items():
                out[kind] = out.get(kind, 0) + n
        return out

    def retry_detail(self) -> Dict[str, int]:
        return {
            "retries": sum(t.retries for t in self.transports),
            "exhausted": sum(t.exhausted for t in self.transports),
        }

    # -- client-side submission (rides the faulted transport) -----------------

    def submit_job(self, ix: int, t: float, d: dict) -> Callable[[], None]:
        """Build the idempotent submission thunk for one job_arrival
        trace event: PriorityClass (on demand) + PodGroup + pod batch,
        resumable — a thunk that raised is re-run next cycle and only
        creates what is still missing (the client retrying its POSTs).
        Returns the thunk; the caller runs/queues it."""
        name, ns = d["name"], "default"
        transport = self.transports[min(ix, len(self.transports) - 1)]
        pc_name = f"prio-{d['priority']}" if d["priority"] else ""
        scalars = {"nvidia.com/gpu": float(d["gpus"])} if d["gpus"] else None
        pods = []
        for i in range(d["tasks"]):
            uid = f"{name}-{i}"
            pod = Pod(metadata=ObjectMeta(
                name=uid, namespace=ns, uid=uid,
                annotations={GROUP_NAME_ANNOTATION: name},
                creation_timestamp=t + i * 1e-6),
                template=PodTemplate(
                    resources=Resource(d["cpu_milli"], d["mem"], scalars),
                    priority=d["priority"]))
            pods.append(pod)
            self._blueprints[uid] = {
                "name": uid, "namespace": ns, "group": name,
                "creation_timestamp": t + i * 1e-6,
                "cpu_milli": d["cpu_milli"], "mem": d["mem"],
                "gpus": d["gpus"], "priority": d["priority"]}

        def thunk() -> None:
            if name in self._completed:
                return
            if pc_name and pc_name not in self._known_prio:
                if self.store.get("PriorityClass", ns, pc_name) is None:
                    transport.create(PriorityClass(
                        metadata=ObjectMeta(name=pc_name, namespace=ns),
                        value=d["priority"]))
                self._known_prio.add(pc_name)
            if self.store.get("PodGroup", ns, name) is None:
                transport.create(PodGroupCR(
                    metadata=ObjectMeta(name=name, namespace=ns,
                                        creation_timestamp=t),
                    spec=PodGroupSpec(min_member=d["min_available"],
                                      queue=d["queue"],
                                      priority_class_name=pc_name)))
            missing = [p for p in pods
                       if self.store.get("Pod", ns,
                                         p.metadata.name) is None]
            if missing:
                transport.create_batch(missing)

        return thunk

    def submit_queue(self, ix: int, d: dict) -> Callable[[], None]:
        name = d["name"]
        transport = self.transports[min(ix, len(self.transports) - 1)]

        def thunk() -> None:
            if self.store.get("Queue", "default", name) is None:
                transport.create(QueueCR(
                    metadata=ObjectMeta(name=name, namespace="default"),
                    spec=QueueSpecCR(weight=d["weight"])))

        return thunk

    # -- kubelet / job-controller analogues (raw store) -----------------------

    def recreate_pod(self, uid: str) -> bool:
        """Controller-recreate after an eviction/node death: a FRESH pod
        from the blueprint (same uid/name/timestamps — the recreated pod
        is the same logical member, as the direct-mode sim models)."""
        bp = self._blueprints.get(uid)
        if bp is None:
            return False
        if self.store.get("Pod", bp["namespace"], bp["name"]) is not None:
            return False
        scalars = {"nvidia.com/gpu": float(bp["gpus"])} if bp["gpus"] \
            else None
        self.store.create(Pod(metadata=ObjectMeta(
            name=bp["name"], namespace=bp["namespace"], uid=uid,
            annotations={GROUP_NAME_ANNOTATION: bp["group"]},
            creation_timestamp=bp["creation_timestamp"]),
            template=PodTemplate(
                resources=Resource(bp["cpu_milli"], bp["mem"], scalars),
                priority=bp["priority"])))
        return True

    def delete_pod(self, uid: str) -> None:
        bp = self._blueprints.get(uid)
        if bp is not None:
            self.store.delete("Pod", bp["namespace"], bp["name"])

    def complete_job(self, jid: str, task_uids: List[str]) -> None:
        """Gang completion: the pods and the PodGroup leave the cluster
        (job controller cleanup); caches follow through their watches."""
        ns, name = jid.split("/", 1)
        self._completed.add(name)
        for uid in task_uids:
            self.delete_pod(uid)
            self._blueprints.pop(uid, None)
        self.store.delete("PodGroup", ns, name)

    def pods_on_node(self, node_name: str) -> List[str]:
        return sorted(
            p.metadata.uid for p in self.store.list("Pod")
            if p.status.node_name == node_name
            and p.status.phase == "Running")
