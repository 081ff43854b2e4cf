"""SimRunner: discrete-event replay of a workload trace through the REAL
scheduler — the ``Scheduler`` shell, the configured action pipeline
(enqueue → allocate → preempt → reclaim → backfill), the real cache and
executors — under a virtual clock with no wall sleeps. This is the JAX
package's direct mode (``volcano_tpu/sim/runner.py``): one scheduler over
one cache, with seeded bind/evict chaos and seeded process kills.

The loop per virtual cycle:

1. apply trace events due at the current virtual time (arrivals, node
   add/drain/restore/fail) and fire due gang completions;
2. ``Scheduler.run_once()`` — one real cycle over the live cache (its
   host wall time is the run's ``pipeline_e2e_ms`` sample);
3. feed the cycle's side effects back the way a cluster would: newly
   bound tasks ack RUNNING, evicted tasks re-queue PENDING, gangs that
   reached ``min_available`` stamp their admission and schedule their
   completion ``duration`` later;
4. advance the virtual clock by one schedule period.

The DECISION plane (bind/evict counts, virtual-time latencies,
utilization, fairness) is a pure function of (trace, seed, conf): it is
byte-identical to the JAX package's for the same inputs. The WALL-CLOCK
plane (``pipeline_e2e_ms``, per-action latency) measures this host.

Chaos composes through ``binder_wrap``/``evictor_wrap``; injected failures
flow through the cache's rollback and resync machinery, whose backoff runs
on the virtual clock. ``kill_cycles`` names cycles on which the scheduler
process "dies" at a seeded kill point and restarts: volatile state (resync
queue, dead letters, in-flight ledger) is lost, the intent journal
survives, and startup reconciliation settles the crash window against the
executors' record before the next cycle.

``pipelined`` runs the pipelined shell (a speculative solve dispatched
after each cycle, committed or discarded at the next one's start) and adds
the ``speculate`` kill point; ``fast_admit`` binds trivially fitting gangs
as they arrive, before the cycle. Both default to ``PIPELINED_SIM_CONF``,
and the report gains their counters.

``store_wired`` puts cluster truth in an ``ObjectStore``
(sim/store_world.py): every pod, podgroup and queue is a store object, the
cache is fed by resumable informers, and the executors write through a
retrying transport over a seeded faulty one (``store_fault_rate``:
latency, transients, 409s; ``torn_watches`` whole-stream tears the
epilogue's watch upkeep must resume or relist). ``ack_fault_rate`` puts
seeded faults on the feedback plane: on the ack wire in direct mode, on
the watch path's RUNNING acks store-wired. The report gains the ``store``
and ``feedback`` sections.

``elastic_gangs`` runs elastic gangs (``elastic_sim_conf`` unless a conf
is given): ``job_command`` events go through the command funnel, the
scheduler drains it at each cycle boundary, and the report gains the
``elastic_gangs`` section (grows, shrinks, the below-min witness, elastic
continues, co-location at completion, the funnel's ledger).

``ha_replicas`` > 1 runs the HA control plane: N replica schedulers over
one virtual cluster, each with its own cache, shell, elector and journal
follower, over shared executors (each behind a fencing gate that reads
its replica's epoch), one in-memory intent journal (the standby's
replication stream) and one lease store. Exactly one replica leads and
schedules; the rest run their election step and tail the journal warm.
``kill_cycles`` then kills the LEADER at seeded points (the direct
mode's, plus mid-action and inside close_session), ``lease_loss_cycles``
revokes its lease before a seeded action, and ``lease_fault_rate`` puts
the lease CAS traffic behind the retrying transport over a seeded faulty
one. The report gains the ``ha`` section (failover cycles, lease losses,
replicas) and counts failovers and fenced rejections.

The overload plane: ``cycle_budget_s`` bounds each cycle's work on the
deterministic cost model, ``admission_depth`` puts a bounded admission
budget at the front door (a shed arrival retries at its retry_after hint)
and ``overload_burst_rate`` layers the seeded OverloadInjector's bursts on
the trace's arrival window. The report gains the ``overload`` section.

``federated_partitions`` > 1 runs the federated control plane: N partition
schedulers over one virtual cluster, each owning a disjoint queue subset
and node shard (a shared PartitionMap, round-robin in watch order), each
its own fenced leader (a lease and fencing authority a partition), its own
cache scoped to its partition, and a PartitionMember on the shell's
federation hooks; they coordinate only through the shared journal's
reserve/transfer protocol. ``kill_cycles`` kills a partition's leader,
``rebalance`` adds the load-driven queue rebalancer, and with
``store_wired`` the map and the ledger live on the PartitionState store
object. The report gains the ``federation`` section.
"""

from __future__ import annotations

import heapq
import itertools
import random
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .. import metrics
from ..api import (JobInfo, NodeInfo, PodGroup, PodGroupPhase, QueueInfo,
                   Resource, TaskInfo)
from ..cache import SchedulerCache
from ..cache.cache import RateLimitedQueue
from ..cache.executors import (FencedBinder, FencedEvictor,
                               FencingAuthority, SequenceBinder,
                               SequenceEvictor)
from ..cache.journal import IntentJournal, JournalFollower
from ..chaos import (AckFaultInjector, KillPointBinder, KillPointEvictor,
                     SimKill, arm_speculation_kill)
from ..elastic_gang.membership import (ELASTIC_DESIRED_ANNOTATION,
                                       TOPOLOGY_ZONE_LABEL, is_elastic)
from ..obs.lifecycle import TIMELINE, latency_classes
from ..obs.slo import SLOEngine
from ..obs.trace import TRACE as OBS_TRACE
from ..scheduler import ROLE_LEADER, Scheduler
from .trace import TraceEvent
from . import report as report_mod

# The sim's default pipeline: the chart conf's action chain with the
# deterministic host engines (deploy/scheduler.conf swaps in the device
# engines; pass conf_text to run the sim against those).
SIM_CONF = """
actions: "enqueue, allocate, preempt, reclaim, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


# the conf of --pipelined and --fast-admit runs: the speculative
# dispatch/fetch split serves the placement kernel's engine, so the allocate
# slot runs allocate-tpu; the serial oracle of
# --verify-pipelined-equivalence runs this same conf, so the comparison
# isolates the pipeline
PIPELINED_SIM_CONF = """
actions: "enqueue, allocate-tpu, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


# quarantine windows under --mesh-chaos, in virtual seconds: short enough
# that a quarantine -> probe -> readmit arc completes inside a scenario;
# run() restores the defaults when it hands DEVICE_HEALTH back
MESH_SIM_COOLDOWN_S = 6.0
MESH_SIM_MAX_COOLDOWN_S = 48.0


def sharded_sim_conf(devices: int = 0) -> str:
    """The conf of ``--sharded`` runs (the JAX package's runner.py:115-140):
    the pipelined conf's actions with allocate on the node-sharded engine,
    its mesh capped to the first ``devices`` slots (0: all). The sharded
    solve's decisions are mesh-size invariant, so ``devices=1`` is the
    single-device oracle --verify-sharded-equivalence diffs against."""
    return f"""
actions: "enqueue, allocate-tpu, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
configurations:
- name: allocate-tpu
  arguments:
    engine: tpu-sharded
    sharded-devices: {int(devices)}
"""


def elastic_sim_conf(topology_weight: float = 10.0) -> str:
    """The conf of ``--elastic-gangs`` runs: the default action chain with
    grow-shrink between allocate and preempt, the elastic-gang plugin in
    tier 1, and the topology weight given to both the plugin's node-order
    bonus and the allocate engine's anchor term. Weight 0 is the
    topology-unaware baseline."""
    w = float(topology_weight)
    return f"""
actions: "enqueue, allocate, grow-shrink, preempt, reclaim, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: elastic-gang
    arguments:
      topology-weight: {w}
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
configurations:
- name: allocate
  arguments:
    topology-weight: {w}
"""


class VirtualClock:
    """Monotonic virtual time: ``sleep`` advances it and returns
    immediately — the scheduler-shell clock for simulation (a thousand
    1 s cycles cost zero wall seconds)."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def time(self) -> float:
        return self._now

    def now(self) -> float:
        """Session/timestamp timebase (WallClock.now counterpart): in the
        sim pacing and timestamps live on the one virtual axis."""
        return self._now

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            self._now += seconds


class _AckWire:
    """The cluster→scheduler feedback wire of the direct mode: every
    kubelet/status ack the cluster owes the scheduler (RUNNING flip,
    eviction confirmation) rides this queue, and a seeded
    ``chaos.AckFaultInjector`` reshapes deliveries — latency on the
    virtual clock, drops, duplicates, adjacent-swap reorders, and stale
    replays that land after the placement they confirm is dead. With no
    injector every ack delivers at once in offer order. The wire is
    CLUSTER state: it survives scheduler kills."""

    __slots__ = ("clock", "injector", "delay_s", "stale_delay_s", "_heap",
                 "_seq", "delivered")

    def __init__(self, clock, injector=None, delay_s: float = 2.5,
                 stale_delay_s: float = 6.5):
        self.clock = clock
        self.injector = injector
        self.delay_s = delay_s
        self.stale_delay_s = stale_delay_s
        # (due, seq, kind, uid, node); seq is a float so a reordered ack
        # can slot between the next two offers (adjacent swap)
        self._heap: List[Tuple[float, float, str, str, str]] = []
        self._seq = 0.0
        self.delivered = 0

    def _next(self) -> float:
        self._seq += 1.0
        return self._seq

    def offer(self, kind: str, uid: str, node: str = "") -> None:
        now = self.clock.time()
        fault = self.injector.roll(kind) \
            if self.injector is not None else None
        seq = self._next()
        if fault == "drop":
            return
        if fault == "delay":
            heapq.heappush(self._heap,
                           (now + self.delay_s, seq, kind, uid, node))
            return
        if fault == "reorder":
            # sorts after the NEXT offered ack (seq n+1) but before the
            # one after it: the adjacent-pair swap
            heapq.heappush(self._heap, (now, seq + 1.5, kind, uid, node))
            return
        heapq.heappush(self._heap, (now, seq, kind, uid, node))
        if fault == "duplicate":
            heapq.heappush(self._heap, (now + self.delay_s, self._next(),
                                        kind, uid, node))
        elif fault == "stale":
            heapq.heappush(self._heap, (now + self.stale_delay_s,
                                        self._next(), kind, uid, node))

    def due(self, now: float) -> List[Tuple[str, str, str]]:
        out = []
        while self._heap and self._heap[0][0] <= now + 1e-9:
            _, _, kind, uid, node = heapq.heappop(self._heap)
            out.append((kind, uid, node))
        self.delivered += len(out)
        return out

    def pending(self) -> int:
        return len(self._heap)


class _Replica:
    """One scheduler replica of the HA control plane: its own cache,
    shell, elector and standby journal follower over the SHARED cluster
    (executors, journal transport, lease store)."""

    __slots__ = ("ix", "gen", "cache", "sched", "elector", "follower")

    def __init__(self, ix: int):
        self.ix = ix
        self.gen = 0
        self.cache = None
        self.sched = None
        self.elector = None
        self.follower = None

    def key(self) -> tuple:
        return (self.ix, self.gen)


class SimRunner:
    def __init__(self, trace: List[TraceEvent],
                 conf_text: Optional[str] = None,
                 period: float = 1.0,
                 seed: int = 0,
                 max_cycles: int = 100000,
                 stall_limit: int = 120,
                 binder_wrap: Optional[Callable] = None,
                 evictor_wrap: Optional[Callable] = None,
                 scenario: Optional[str] = None,
                 kill_cycles: Optional[Sequence[int]] = None,
                 kill_seed: int = 0,
                 journal: Optional[IntentJournal] = None,
                 cycle_budget_s: float = 0.0,
                 budget_cost_per_task: float = 0.0,
                 admission_depth: int = 0,
                 overload_burst_rate: float = 0.0,
                 device=None,
                 pipelined: bool = False,
                 fast_admit: bool = False,
                 elastic_gangs: bool = False,
                 topology_weight: float = 10.0,
                 lifecycle: bool = False,
                 store_wired: bool = False,
                 store_fault_rate: float = 0.0,
                 store_fault_seed: Optional[int] = None,
                 store_latency_s: float = 0.05,
                 torn_watches: int = 0,
                 ack_fault_rate: float = 0.0,
                 ack_fault_seed: Optional[int] = None,
                 ha_replicas: int = 1,
                 lease_loss_cycles: Optional[Sequence[int]] = None,
                 lease_fault_rate: float = 0.0,
                 lease_fault_seed: Optional[int] = None,
                 federated_partitions: int = 0,
                 rebalance: bool = False,
                 elastic: bool = False,
                 mesh_chaos: bool = False,
                 mesh_fault_rate: float = 0.0,
                 mesh_fault_plan: Optional[Dict[str, Sequence[int]]] = None,
                 mesh_fault_seed: Optional[int] = None):
        self.trace = list(trace)
        self.period = period
        self.seed = seed
        self.max_cycles = max_cycles
        self.stall_limit = stall_limit
        self.scenario = scenario
        self.device = device

        self.clock = VirtualClock()
        # lifecycle timelines (obs/lifecycle.py): the store records in
        # every run (it observes, never influences), but the derived report
        # sections (latency, slo) are emitted only under ``lifecycle``, so
        # a run without it keeps its decision plane. Cleared here so
        # back-to-back runs in one process mint the same event ids.
        self.lifecycle = bool(lifecycle)
        self._timeline = TIMELINE
        self._timeline.clear()
        self._slo_engine = SLOEngine(period=period) if self.lifecycle \
            else None
        self.binder = SequenceBinder()
        self.evictor = SequenceEvictor()
        binder = binder_wrap(self.binder) if binder_wrap else self.binder
        evictor = evictor_wrap(self.evictor) if evictor_wrap else self.evictor
        # crash/restart rig: kill wrappers sit OUTERMOST (outside chaos)
        # so a kill-after-execute still records the inner side effect —
        # the "cluster did it, the scheduler died before learning" window
        self.kill_cycles = set(kill_cycles or ())
        self.kill_seed = kill_seed
        self._kill_rng = random.Random(kill_seed)
        self.restarts = 0
        self.double_binds = 0
        self._live_bound: set = set()
        # requeues that undid a bind before the harvest read it: the late
        # harvest consumes the debt instead of counting a live bind
        self._requeue_debt: Dict[str, int] = {}
        self._journal_replayed: Dict[str, int] = {}
        self._kill_binder: Optional[KillPointBinder] = None
        self._kill_evictor: Optional[KillPointEvictor] = None
        self.journal = journal
        # HA mode: N replica schedulers over ONE virtual cluster (shared
        # executors, shared in-memory intent journal, shared lease store
        # and fencing authority); one replica holds the lease and
        # schedules, the rest tail the journal warm
        self.ha_replicas = max(int(ha_replicas), 1)
        # federated mode: N PARTITION schedulers (disjoint queue subsets
        # and node shards of one virtual cluster), each partition its own
        # fenced leader (a per-partition lease and authority), coordinating
        # only through the shared journal's reserve/transfer protocol. One
        # partition is the single scheduler; --ha is another topology
        self.federated = max(int(federated_partitions or 0), 0)
        if self.federated == 1 and not elastic:
            # one partition is the single scheduler, EXCEPT under elastic
            # membership, where 1 is only the starting partition count and
            # the federation machinery must be live to grow it
            self.federated = 0
        if self.federated and self.ha_replicas > 1:
            raise ValueError("ha_replicas and federated_partitions are "
                             "mutually exclusive")
        # the pipelined shell and fast admit do not carry a speculation
        # across a leadership or partition boundary
        if (pipelined or fast_admit) \
                and (federated_partitions or ha_replicas > 1):
            raise ValueError("pipelined/fast_admit are single-scheduler "
                             "modes (not --ha / --federated)")
        # store-wired mode: cluster truth in an ObjectStore behind the
        # hostile transport of store_transport.py (seeded verb faults, torn
        # watch streams); one scheduler, or the partitions of a federated
        # run over the store-backed PartitionState
        self.store_wired = bool(store_wired)
        self.store_fault_rate = float(store_fault_rate)
        self.store_fault_seed = seed if store_fault_seed is None \
            else store_fault_seed
        self.store_latency_s = float(store_latency_s)
        self.torn_watches = int(torn_watches)
        self.world = None
        self._store_pending: List[Callable] = []
        self._tear_rng = random.Random(self.store_fault_seed ^ 0x51F7)
        self._tear_cycles: List[int] = sorted(
            self._tear_rng.randint(2, 12) for _ in range(self.torn_watches))
        self.torn_watch_events = 0
        self.ledgers: List = []
        # the hostile feedback plane: seeded ack faults. The direct mode
        # faults the ack wire; store-wired, the watch-path RUNNING acks
        # inside the cache's FeedbackChannel
        self.ack_fault_rate = float(ack_fault_rate)
        self.ack_fault_seed = seed if ack_fault_seed is None \
            else ack_fault_seed
        self._ack_injector = AckFaultInjector(
            failure_rate=self.ack_fault_rate, seed=self.ack_fault_seed,
            delay_s=2.5 * period, stale_delay_s=6.5 * period) \
            if self.ack_fault_rate else None
        self._ack_wire = _AckWire(
            self.clock,
            None if self.store_wired else self._ack_injector,
            delay_s=2.5 * period, stale_delay_s=6.5 * period)
        if self.ack_fault_rate and ha_replicas > 1:
            raise ValueError("ack chaos supports single-scheduler and "
                             "federated topologies (not --ha: the "
                             "convergence sweep would mask delays)")
        self._store_ack_injectors: List[AckFaultInjector] = []
        # the HA lease path behind the faulted transport: each replica's
        # Lease CAS traffic rides retry funnel → faulty transport → lease
        # store when a rate is set
        self.lease_fault_rate = float(lease_fault_rate)
        self.lease_fault_seed = seed if lease_fault_seed is None \
            else lease_fault_seed
        self._lease_transports: Dict[int, object] = {}
        if self.store_wired and ha_replicas > 1:
            raise ValueError("store_wired supports single-scheduler and "
                             "federated topologies (not --ha)")
        if self.store_wired and (pipelined or fast_admit):
            raise ValueError("store_wired and pipelined/fast_admit are "
                             "separate modes")
        if self.kill_cycles:
            if self.journal is None:
                # in memory: survives the simulated process death
                self.journal = IntentJournal()
            if not self.store_wired:
                # store mode builds its executor chain in the store world
                # and interposes the kill wrappers there
                self._kill_binder = binder = KillPointBinder(binder)
                self._kill_evictor = evictor = KillPointEvictor(evictor)
        # the device cool-down runs on the virtual clock too, so a
        # DeviceFaultInjector's probe lands on a deterministic cycle; run()
        # hands it back to wall time
        from ..device_health import DEVICE_HEALTH
        DEVICE_HEALTH.reset(time_fn=self.clock.time)
        # per-slot mesh chaos: a seeded MeshFaultInjector on the allocate
        # fault hook attributes each fault to a live slot, so the lattice
        # quarantines slots and the mesh heals mid-cycle; the quarantine
        # windows run on the virtual clock at the sim's length. Restarts
        # reset the lattice (health is process memory) but not the
        # injector: the chaos survives them
        self.mesh_fault_rate = float(mesh_fault_rate)
        self.mesh_fault_plan = {k: tuple(v) for k, v in
                                (mesh_fault_plan or {}).items()}
        self.mesh_fault_seed = seed if mesh_fault_seed is None \
            else mesh_fault_seed
        self.mesh_chaos = bool(mesh_chaos or self.mesh_fault_rate
                               or self.mesh_fault_plan)
        self._mesh_injector = None
        self._mesh_section: Optional[dict] = None
        self._mesh_mark = dict(metrics.mesh_counts())
        self.rung_cycles: Dict[int, int] = {}
        if self.mesh_chaos:
            from ..actions import allocate as _alloc_mod
            from ..chaos import MeshFaultInjector
            DEVICE_HEALTH.cooldown_s = MESH_SIM_COOLDOWN_S
            DEVICE_HEALTH.max_cooldown_s = MESH_SIM_MAX_COOLDOWN_S
            rate = self.mesh_fault_rate or (
                None if self.mesh_fault_plan else 0.2)
            self._mesh_injector = MeshFaultInjector(
                self.mesh_fault_plan or {"device_lost": (), "oom": (),
                                         "slow": ()},
                failure_rate=rate, seed=self.mesh_fault_seed)
            _alloc_mod.DEVICE_FAULT_HOOK = self._mesh_injector
        # the overload plane: a per-cycle budget priced by a DETERMINISTIC
        # cost model (budget_cost_per_task virtual seconds a pending task an
        # action: the virtual clock never advances inside a cycle, so
        # exhaustion is a pure function of the decision plane), a bounded
        # admission budget at the front door (shed arrivals re-offer after
        # their retry_after hint, as a well-behaved client does), and a
        # seeded OverloadInjector layering arrival bursts on the trace. All
        # off by default, so a run without them keeps its decision plane
        self.cycle_budget_s = float(cycle_budget_s)
        self.budget_cost_per_task = float(budget_cost_per_task)
        self.admission_depth = int(admission_depth)
        self.overload_burst_rate = float(overload_burst_rate)
        # and, federated, the load-driven queue rebalancer
        self.rebalance = bool(rebalance)
        # elastic membership: the partition COUNT follows load. Chronically
        # budget-exhausted partitions split and chronically idle ones merge
        # back, through the journaled partition_spawn/partition_retire
        # funnel; the runner is the host supervisor whose spawn and retire
        # hooks build and reap partition shells mid-run
        self.elastic = bool(elastic)
        if self.elastic and not self.federated:
            raise ValueError("elastic requires federated_partitions")
        self.overload = bool(self.cycle_budget_s or self.admission_depth
                             or self.overload_burst_rate or self.rebalance)
        self._admission = None
        if self.admission_depth:
            from ..webhooks.backpressure import AdmissionBudget
            self._admission = AdmissionBudget(
                max_queue_depth=self.admission_depth,
                cycle_period_s=period, time_fn=self.clock.time)
        self._overload_inj = None
        if self.overload_burst_rate:
            from ..chaos import OverloadInjector
            self._overload_inj = OverloadInjector(
                burst_rate=self.overload_burst_rate, seed=seed)
        self._queue_names: List[str] = []
        self.sheds = 0
        self.shed_reasons: Dict[str, int] = {}
        self.readmit_attempts = 0
        self._retry_heap: List[tuple] = []    # (due, seq, arrival dict)
        self._retry_seq = itertools.count()
        self._burst_seq = itertools.count()
        self._adm_charge: Dict[str, tuple] = {}   # jid -> (queue, tasks, B)
        self._drained_tasks = 0
        self._budget_base = {"exhausted": 0, "deferred": 0, "spend": 0.0}
        self._rebalance_moves: List[dict] = []
        self._rebalance_base = {"abstentions": 0, "refused": 0}
        self._rebalancers: Dict[int, object] = {}
        self._cache_by_pid: Dict[int, SchedulerCache] = {}
        # elastic bookkeeping: the live controllers by pid, the counters
        # harvested from dead and retired incarnations, the membership
        # changes in order, and the trace specs a newborn partition's cache
        # backfills from (its relist)
        self._elastics: Dict[int, object] = {}
        self._elastic_base = {"splits": 0, "merges": 0,
                              "abstentions": 0, "refused": 0}
        self._elastic_events: List[dict] = []
        self._partition_peak = self.federated
        self._queue_specs: Dict[str, dict] = {}
        self._node_specs: Dict[str, dict] = {}
        self._unready_nodes: set = set()
        self._retired_watch_counts = {"resumes": 0, "relists": 0}
        self._max_queue_depth = 0
        # the federation plane (a run without partitions leaves it empty;
        # the store-backed one keeps a map and ledger mirror and the kill
        # wrappers of each partition's own store chain)
        self.pmap = None
        self.ledger = None
        self.registry = None
        self._p_maps: Dict[int, object] = {}
        self._p_ledgers: Dict[int, object] = {}
        self._store_kill_wrappers: Dict[int, tuple] = {}
        # the HA plane (a direct run leaves it empty: no failover, no
        # authority)
        self.lease_loss_cycles = set(lease_loss_cycles or ())
        self._lease_rng = random.Random(kill_seed ^ 0x9E3779B9)
        self.failovers = 0
        self.failover_cycles: List[int] = []
        self._vacant_since: Optional[int] = None
        self._leader_key: Optional[tuple] = None
        self._feedback_blocked = False
        self._armed_action: Optional[int] = None
        self._armed_close = False
        self._armed_revoke: Optional[int] = None
        self._had_leader = False
        self._pending_crash_oracle = None
        self.replicas: List[_Replica] = []
        self.authority: Optional[FencingAuthority] = None
        self.pipelined_mode = bool(pipelined)
        self.fast_admit_mode = bool(fast_admit)
        self.elastic_gangs = bool(elastic_gangs)
        self.topology_weight = float(topology_weight)
        self._wants_commands = any(ev.kind == "job_command"
                                   for ev in self.trace)
        if (self.elastic_gangs or self._wants_commands) \
                and (self.federated or self.store_wired
                     or self.ha_replicas > 1):
            raise ValueError(
                "elastic_gangs / job_command events require the "
                "direct single-scheduler topology")
        if conf_text is not None:
            self.conf_text = conf_text
        elif self.elastic_gangs:
            self.conf_text = elastic_sim_conf(self.topology_weight)
        elif self.pipelined_mode or self.fast_admit_mode:
            self.conf_text = PIPELINED_SIM_CONF
        else:
            self.conf_text = SIM_CONF

        if self.store_wired:
            from .store_world import StoreWorld
            self.world = StoreWorld(
                self.clock, fault_rate=self.store_fault_rate,
                fault_seed=self.store_fault_seed,
                latency_s=self.store_latency_s,
                n_schedulers=self.federated or 1,
                retry_rng_seed=seed, period=period)
            # the determinism witnesses: executions that REACHED the store,
            # recorded inside every scheduler's executor chain
            self.binder = self.world.bind_witness
            self.evictor = self.world.evict_witness
            if self.federated:
                self._init_federated_store(binder_wrap, evictor_wrap)
            else:
                self._init_store_single(binder_wrap, evictor_wrap)
        elif self.federated:
            self._init_federated(binder, evictor)
        elif self.ha_replicas > 1:
            self._init_ha(binder, evictor)
        else:
            self.cache = SchedulerCache(binder=binder, evictor=evictor,
                                        default_queue=None,
                                        journal=self.journal)
            # retry backoff, ingestion timestamps and in-flight ack
            # deadlines all run on virtual time
            self.cache.resync_queue.time_fn = self.clock.time
            self.cache.time_fn = self.clock.time
            self._pin_feedback(self.cache)
            self.sched = self._new_scheduler()
        if not self.replicas:
            # store-wired and direct: one cache (HA's and federation's
            # initialisers list every replica's)
            self.caches = [self.cache]
        # the process-wide counters, marked so the report shows this run's
        self._spec_mark = dict(metrics.speculation_counts())
        self._fa_mark = dict(metrics.fast_admit_counts())
        # elastic gangs: the command funnel (it holds the cache, cluster
        # truth here, so it outlives a crash restart, which re-attaches it
        # to the new shell), the metric mark for this run's deltas, and the
        # co-location counters taken at each gang's completion
        self._command_funnel = None
        self._elastic_continues = 0
        self.colocated_gangs = 0
        self.spread_gangs = 0
        self._eg_mark = dict(metrics.elastic_counts())
        if self.elastic_gangs or self._wants_commands:
            from ..elastic_gang import CommandFunnel
            self._command_funnel = CommandFunnel(self.cache)
            self.sched.command_funnel = self._command_funnel

        # decision-plane bookkeeping
        self.arrival_time: Dict[str, float] = {}
        self.duration: Dict[str, float] = {}
        self.task_job: Dict[str, str] = {}
        self.first_bind: Dict[str, float] = {}
        self.admitted_at: Dict[str, float] = {}
        self._admit_epoch: Dict[str, int] = {}
        self.jct: List[float] = []
        self.queueing_delay: List[float] = []
        self.gang_admission: List[float] = []
        self.completed = 0
        self.arrived = 0
        self.requeues = 0
        self.cycles = 0
        self.action_failures: List[Tuple[int, str]] = []
        self._binds_seen = 0
        self._evicts_seen = 0
        self._completions: List[tuple] = []          # (t, seq, uid, epoch)
        self._cseq = itertools.count()
        self._trace_ix = 0
        # per-cycle samples (decision plane: derived from cache state)
        self.util_cpu: List[float] = []
        self.util_mem: List[float] = []
        self.drf_gap: List[float] = []
        # wall-clock plane
        self.pipeline_e2e_ms: List[float] = []

    def rebalance_stats(self) -> Dict[str, object]:
        moves = list(self._rebalance_moves)
        for ctrl in self._rebalancers.values():
            moves.extend(ctrl.moves)
        moves.sort(key=lambda m: (m["t"], m["queue"]))
        last_t = max((m["t"] for m in moves), default=0.0)
        return {
            "enabled": self.rebalance,
            "moves": moves,
            "move_count": len(moves),
            "last_move_t": last_t,
            "abstentions": self._rebalance_base["abstentions"] + sum(
                c.abstentions for c in self._rebalancers.values()),
            "refused": self._rebalance_base["refused"] + sum(
                c.refused for c in self._rebalancers.values()),
        }

    def _new_scheduler(self, cache: Optional[SchedulerCache] = None
                       ) -> Scheduler:
        """A scheduler shell over ``cache`` (THE cache by default): at
        construction and at every crash restart, with the same clock,
        seed, budget and device."""
        kwargs = {}
        if self.cycle_budget_s:
            kwargs = {"cycle_budget_s": self.cycle_budget_s,
                      "budget_cost_fn": self._budget_cost}
        return Scheduler(cache or self.cache, conf_text=self.conf_text,
                         schedule_period=self.period, clock=self.clock,
                         rng=random.Random(self.seed), device=self.device,
                         pipelined=self.pipelined_mode,
                         fast_admit=self.fast_admit_mode, **kwargs)

    # -- overload plumbing --------------------------------------------------

    def _budget_cost(self, name: str, ssn) -> float:
        """Each action is priced by the pending backlog it walks — a pure
        function of the session snapshot."""
        from ..api import TaskStatus
        pending = 0
        for job in ssn.jobs.values():
            pending += len(job.task_status_index.get(TaskStatus.PENDING,
                                                     {}))
        return self.budget_cost_per_task * pending

    def _harvest_budget(self, sched) -> None:
        """A shell is about to be replaced (crash restart): fold its
        budget counters into the run totals."""
        self._budget_base["exhausted"] += sched.budget_exhausted_total
        self._budget_base["deferred"] += sched.deferred_actions_total
        self._budget_base["spend"] = max(self._budget_base["spend"],
                                         sched.max_cycle_spend_s)

    def budget_stats(self) -> Dict[str, object]:
        scheds = [rep.sched for rep in self.replicas] \
            if self.replicas else [self.sched]
        exhausted = self._budget_base["exhausted"] \
            + sum(s.budget_exhausted_total for s in scheds)
        deferred = self._budget_base["deferred"] \
            + sum(s.deferred_actions_total for s in scheds)
        spend = max([self._budget_base["spend"]]
                    + [s.max_cycle_spend_s for s in scheds])
        return {"budget_s": self.cycle_budget_s,
                "exhausted": exhausted, "deferred_actions": deferred,
                "max_cycle_spend_s": round(spend, 6)}

    def _admit_arrival(self, t: float, d: dict) -> bool:
        """The front door's backpressure gate: charge the arrival against
        the bounded admission budget, or shed it and schedule the client's
        retry at the refusal's retry_after hint. True: admitted."""
        if self._admission is None:
            return True
        from ..webhooks.backpressure import (BackpressureError,
                                             estimate_job_bytes)
        jid = self._jid(d["name"])
        tasks = int(d["tasks"])
        nbytes = estimate_job_bytes(tasks)
        try:
            self._admission.admit_batch({d["queue"]: tasks}, nbytes,
                                        int(d.get("priority", 0)))
        except BackpressureError as exc:
            self.sheds += 1
            self.shed_reasons[exc.reason] = \
                self.shed_reasons.get(exc.reason, 0) + 1
            # the shed is the job's first timeline event: a gang refused
            # at the door still explains itself
            self._timeline.record(jid, "shed", t=t, reason=exc.reason,
                                  queue=d["queue"])
            heapq.heappush(self._retry_heap,
                           (t + exc.retry_after_s,
                            next(self._retry_seq), dict(d)))
            return False
        self._adm_charge[jid] = (d["queue"], tasks, nbytes)
        return True

    def _credit_admission(self, jid: str) -> None:
        """The gang left the system (completed): release its admission
        budget and feed the drain-throughput EWMA."""
        charge = self._adm_charge.pop(jid, None)
        if charge is None or self._admission is None:
            return
        queue, tasks, nbytes = charge
        self._admission.credit(queue, tasks, nbytes)
        self._drained_tasks += tasks

    def _drain_retries(self, now: float) -> None:
        """Shed clients retry once their retry_after hint expires, through
        the same gate, so a still-full queue sheds them again with a fresh
        hint."""
        while self._retry_heap and self._retry_heap[0][0] <= now + 1e-9:
            _, _, d = heapq.heappop(self._retry_heap)
            self.readmit_attempts += 1
            self._arrive(now, d)

    def _inject_bursts(self, now: float) -> None:
        """The seeded OverloadInjector's flash crowds: extra single-gang
        jobs on top of the trace, offered through the same admission gate
        as any client. Bursts ride the trace's arrival window only: once
        the trace is spent the crowd stops, the shed retries drain and the
        run ends."""
        if self._overload_inj is None or not self._queue_names \
                or self._trace_ix >= len(self.trace):
            return
        n = self._overload_inj.tick()
        GI = 1 << 30
        for _ in range(n):
            spec = self._overload_inj.job_spec(len(self._queue_names))
            name = f"ovl-{next(self._burst_seq):06d}"
            self._arrive(now, {
                "name": name,
                "queue": self._queue_names[spec["queue_ix"]],
                "priority": int(spec["priority"]),
                "tasks": int(spec["tasks"]),
                "min_available": int(spec["tasks"]),
                "cpu_milli": int(spec["cpu_milli"]),
                "mem": GI // 4, "gpus": 0,
                "duration": float(spec["duration"])})

    def overload_stats(self) -> Dict[str, object]:
        """The report's overload section (overload runs only)."""
        out: Dict[str, object] = {
            "cycle_budget": self.budget_stats(),
            "shed_total": self.sheds,
            "shed": dict(sorted(self.shed_reasons.items())),
            "readmit_attempts": self.readmit_attempts,
            "retries_pending": len(self._retry_heap),
            "burst_jobs": self._overload_inj.injected
            if self._overload_inj is not None else 0,
        }
        if self._admission is not None:
            out["admission"] = self._admission.detail()
        return out

    def _pin_feedback(self, cache: SchedulerCache) -> None:
        """In-flight ack deadlines expire on the virtual clock after a few
        periods, and a watchdog-recovered evict ack hands the
        controller-recreate to the runner."""
        cache.inflight.time_fn = self.clock.time
        cache.inflight.ack_timeout_s = 3.0 * self.period
        cache.feedback.on_watchdog_evict = \
            lambda jid, uid, c=cache: self._watchdog_requeued(c, jid, uid)

    def _watchdog_requeued(self, cache: SchedulerCache, jid: str,
                           uid: str) -> None:
        """A cache's watchdog recovered a LOST eviction ack and requeued
        the member in that cache: do the cluster's half (the requeue fans
        out to the other replica caches) and keep the runner's gang
        bookkeeping consistent (one logical requeue)."""
        if self.store_wired:
            # the controller-recreate path owns both the idempotency guard
            # (recreate_pod refuses when the harvest already recreated the
            # pod) and the requeue bookkeeping
            self._requeue_task(uid)
            return
        for other in self.caches:
            if other is not cache:
                other.requeue_lost_member(jid, uid, detach=True)
        self._note_requeue(uid)
        self.requeues += 1
        if jid in self.admitted_at:
            del self.admitted_at[jid]
            self._admit_epoch[jid] = self._admit_epoch.get(jid, 0) + 1

    def _note_requeue(self, uid: str) -> None:
        """A cluster-side requeue retired ``uid``'s live placement: drop it
        from the live-bound witness — or, when the undone bind still sits
        unharvested in the executor record (the watchdog runs inside the
        cycle, before the harvest), record a debt the harvest consumes."""
        if uid in self._live_bound:
            self._live_bound.discard(uid)
        elif any(uid == u for u, _ in
                 self.binder.sequence[self._binds_seen:]):
            self._requeue_debt[uid] = self._requeue_debt.get(uid, 0) + 1

    # -- the store-wired world -----------------------------------------------

    def _jid(self, name: str) -> str:
        """The job uid a trace job name maps to: store mode ingests jobs
        through the informer path, whose uid is namespace-qualified."""
        return f"default/{name}" if self.store_wired else name

    def _store_inflight_oracle(self, entry):
        """Cluster truth for the store-wired watchdog: the pod's state in
        the raw store."""
        pod = self.world.store.get("Pod", "default", entry.uid)
        if entry.op == "bind":
            return pod is not None and pod.status.node_name == entry.node
        # the evict took effect iff the pod as placed is gone (the
        # controller's recreate is a fresh, unplaced pod)
        return pod is None or not pod.status.node_name

    def _pin_store_feedback(self, cache: SchedulerCache, ix: int) -> None:
        """Store-wired feedback plumbing: virtual ack deadlines, the
        store-truth oracle and, under ack chaos, the watch-path injector on
        the cache's FeedbackChannel."""
        self._pin_feedback(cache)
        cache.inflight_oracle_fn = self._store_inflight_oracle
        if self._ack_injector is not None:
            inj = AckFaultInjector(
                failure_rate=self.ack_fault_rate,
                seed=self.ack_fault_seed * 7919 + ix,
                delay_s=2.5 * self.period,
                stale_delay_s=6.5 * self.period)
            cache.feedback.attach_injector(inj, self.clock.time)
            self._store_ack_injectors.append(inj)

    def _init_store_single(self, binder_wrap, evictor_wrap) -> None:
        """One scheduler over the hostile store boundary: the cache is
        informer-fed (resumable watches) and every executor write rides
        retry funnel → faulty transport → store."""
        cache, b, e = self.world.build_cache(
            0, binder_wrap, evictor_wrap, journal=self.journal)
        self._pin_store_feedback(cache, 0)
        if self.kill_cycles:
            self._kill_binder = KillPointBinder(b)
            self._kill_evictor = KillPointEvictor(e)
            cache.binder = self._kill_binder
            cache.evictor = self._kill_evictor
        self.cache = cache
        self.sched = self._new_scheduler()

    def _drain_store_pending(self) -> None:
        """Re-run client submissions that failed at the store boundary (the
        client retrying its POSTs next cycle); the thunks are idempotent."""
        pending, self._store_pending = self._store_pending, []
        for thunk in pending:
            try:
                thunk()
            except Exception:
                self._store_pending.append(thunk)

    def store_detail(self) -> Dict[str, object]:
        """The report's deterministic store-boundary section."""
        resumes = self._retired_watch_counts["resumes"]
        relists = self._retired_watch_counts["relists"]
        for cache in self.caches:
            mgr = getattr(cache, "watch_manager", None)
            if mgr is not None:
                for w in mgr.watches:
                    resumes += w.resumes
                    relists += w.relists
        for lg in self.ledgers:
            # the partitions' PartitionState streams
            w = lg.backend._watch
            if w is not None:
                resumes += w.resumes
                relists += w.relists
        return {
            "fault_rate": self.store_fault_rate,
            "faults": self.world.faults_detail(),
            "retry_funnel": self.world.retry_detail(),
            "torn_watch_events": self.torn_watch_events,
            "watch_resumes": resumes,
            "watch_relists": relists,
            "pending_submissions": len(self._store_pending),
        }

    @property
    def ack_chaos(self) -> bool:
        return self._ack_injector is not None

    def feedback_stats(self) -> Dict[str, object]:
        """The report's deterministic feedback-plane section: faults
        injected, normalizer verdicts, in-flight ledger resolutions, and
        the zero-stuck witnesses (open entries and pending acks at the
        run's end)."""
        faults: Dict[str, int] = {}
        injectors = ([self._ack_injector] if not self.store_wired
                     else self._store_ack_injectors)
        for inj in injectors:
            if inj is None:
                continue
            for kind, n in inj.injected.items():
                faults[kind] = faults.get(kind, 0) + n
        acks: Dict[str, int] = {}
        resolved: Dict[str, int] = {}
        open_entries = 0
        pending_watch = 0
        for cache in self.caches:
            for (kind, verdict), n in cache.feedback.counts.items():
                key = f"{kind}/{verdict}"
                acks[key] = acks.get(key, 0) + n
            for how, n in cache.inflight.resolved.items():
                resolved[how] = resolved.get(how, 0) + n
            open_entries += cache.inflight.open_count()
            pending_watch += cache.feedback.pending()
        return {
            "fault_rate": self.ack_fault_rate,
            "faults": dict(sorted(faults.items())),
            "acks": dict(sorted(acks.items())),
            "inflight_resolved": dict(sorted(resolved.items())),
            "inflight_open": open_entries,
            "wire_pending": self._ack_wire.pending() + pending_watch,
            "watchdog_fired": sum(
                resolved.get(k, 0)
                for k in ("repaired", "rolled_back", "reissued")),
        }

    # -- trace/event application --------------------------------------------

    def _apply_trace_until(self, now: float) -> int:
        n = 0
        while self._trace_ix < len(self.trace) \
                and self.trace[self._trace_ix].t <= now + 1e-9:
            self._apply_event(self.trace[self._trace_ix])
            self._trace_ix += 1
            n += 1
        return n

    def _view(self) -> SchedulerCache:
        """The cache the decision-plane samples and the run's bookkeeping
        read: the current (or most recent) leader's in HA mode, THE cache
        otherwise. Replica caches converge through the journal tail and
        the shared feedback, so the choice matters only during failover
        windows, and it is deterministic."""
        return self.caches[self._view_ix] if self.replicas else self.cache

    def _job(self, uid: str):
        """The live JobInfo for ``uid``: the first replica cache that holds
        it (replicas converge), THE cache otherwise."""
        for cache in self.caches:
            job = cache.jobs.get(uid)
            if job is not None:
                return job
        return None

    def _apply_event(self, ev: TraceEvent) -> None:
        """Apply one trace event to EVERY replica cache (the watch stream
        every replica sees), and the runner's bookkeeping once."""
        d = ev.data
        if ev.kind == "queue_add" and d["name"] not in self._queue_names:
            # the burst injector's routing table, in watch-stream order
            self._queue_names.append(d["name"])
        # an elastic spawn backfills the newborn partition's cache from
        # these recorded specs (the relist a fresh process start performs)
        if ev.kind == "queue_add":
            self._queue_specs[d["name"]] = dict(d)
        elif ev.kind == "node_add":
            self._node_specs[d["name"]] = dict(d)
        elif ev.kind == "node_fail":
            self._node_specs.pop(d["name"], None)
            self._unready_nodes.discard(d["name"])
        elif ev.kind == "node_drain":
            self._unready_nodes.add(d["name"])
        elif ev.kind == "node_restore":
            self._unready_nodes.discard(d["name"])
        if self.pmap is not None:
            # federated: the watch stream also feeds the partition map
            # (deterministic round-robin in stream order)
            if ev.kind == "queue_add":
                self.pmap.register_queue(d["name"])
            elif ev.kind == "node_add":
                self.pmap.register_node(d["name"])
            elif ev.kind == "node_fail":
                self.pmap.forget_node(d["name"])
        if ev.kind == "node_fail":
            self._fail_node(d["name"])
            return
        if ev.kind == "job_arrival":
            self._arrive(ev.t, d)
            return
        if ev.kind == "job_complete":
            jid = self._jid(d["name"])
            if self._job(jid) is not None:
                self._complete_job(jid, ev.t)
            return
        if ev.kind == "job_command":
            # a lifecycle verb changes nothing here: it goes through the
            # journaled funnel and applies at the next cycle boundary
            self._command_funnel.submit(d["verb"], d["name"], d.get("value"))
            return
        if self.store_wired and ev.kind == "queue_add":
            # the queue is a store object; the cache learns it through its
            # watch. The submission rides the faulted transport and
            # re-queues on failure like any client POST
            thunk = self.world.submit_queue(0, d)
            try:
                thunk()
            except Exception:
                self._store_pending.append(thunk)
            return
        for cache in self.caches:
            if ev.kind == "queue_add":
                cache.add_queue(QueueInfo(name=d["name"],
                                          weight=d["weight"]))
            elif ev.kind == "node_add":
                # a fresh Resource and NodeInfo a cache: live caches keep
                # their node accounting apart
                scalars = {"nvidia.com/gpu": float(d["gpus"])} \
                    if d["gpus"] else None
                alloc = Resource(d["cpu_milli"], d["mem"], scalars)
                alloc.max_task_num = d["pods"]
                labels = {TOPOLOGY_ZONE_LABEL: d["zone"]} \
                    if d.get("zone") else None
                cache.add_node(NodeInfo(name=d["name"], allocatable=alloc,
                                        labels=labels))
            elif ev.kind == "node_drain":
                node = cache.nodes.get(d["name"])
                if node is not None:
                    node.ready = False
                    cache.mark_node_dirty(node.name)
            elif ev.kind == "node_restore":
                node = cache.nodes.get(d["name"])
                if node is not None:
                    node.ready = True
                    cache.mark_node_dirty(node.name)

    def unfinished_jobs(self) -> int:
        if self.federated:
            return sum(len(c.jobs) for c in self.caches)
        return len(self._view().jobs)

    def dead_letter_total(self) -> int:
        if self.federated:
            return sum(len(c.dead_letter) for c in self.caches)
        return len(self._view().dead_letter)

    def fencing_rejections(self) -> int:
        if self.registry is not None:
            return self.registry.rejections()
        return self.authority.rejections if self.authority is not None \
            else 0

    def _arrive(self, t: float, d: dict) -> None:
        if not self._admit_arrival(t, d):
            return                 # shed: the client's retry is queued
        name = d["name"]
        if self.store_wired:
            # informer-path ingestion: the job becomes a PodGroup and pod
            # objects through the (faulted) transport and the cache learns
            # it from its watches. Bookkeeping is stamped at the front door;
            # a failed submission retries next cycle
            jid = self._jid(name)
            for i in range(d["tasks"]):
                self.task_job[f"{name}-{i}"] = jid
            self.arrival_time[jid] = t
            self.duration[jid] = d["duration"]
            self.arrived += 1
            self._timeline.record(jid, "arrival", t=t, queue=d["queue"])
            thunk = self.world.submit_job(0, t, d)
            try:
                thunk()
            except Exception:
                self._store_pending.append(thunk)
            return
        caches = self.caches
        if self.federated:
            # partitioned ingestion: the job materializes only in its
            # queue's owning partition (a server-side filtered watch)
            pid = self.pmap.owner_of_queue(d["queue"])
            cache = self._cache_by_pid.get(pid)
            caches = [cache if cache is not None else self.caches[0]]
        for cache in caches:
            # a fresh JobInfo a replica cache
            scalars = {"nvidia.com/gpu": float(d["gpus"])} if d["gpus"] \
                else None
            ann = {ELASTIC_DESIRED_ANNOTATION: str(int(d["desired"]))} \
                if d.get("desired") is not None else None
            pg = PodGroup(name=name, queue=d["queue"],
                          min_member=d["min_available"],
                          phase=PodGroupPhase.PENDING, annotations=ann)
            job = JobInfo(uid=name, name=name, queue=d["queue"],
                          priority=d["priority"],
                          min_available=d["min_available"], podgroup=pg,
                          creation_timestamp=t)
            for i in range(d["tasks"]):
                uid = f"{name}-{i}"
                job.add_task_info(TaskInfo(
                    uid=uid, name=uid, job=name,
                    resreq=Resource(d["cpu_milli"], d["mem"], scalars),
                    creation_timestamp=t + i * 1e-6))
            cache.add_job(job)
        for i in range(d["tasks"]):
            self.task_job[f"{name}-{i}"] = name
        self.arrival_time[name] = t
        self.duration[name] = d["duration"]
        self.arrived += 1
        self._timeline.record(name, "arrival", t=t, queue=d["queue"])

    def _fail_node(self, name: str) -> None:
        """The node dies with its tasks: lost members re-queue PENDING and
        their gang must re-admit (duration restarts — a gang below
        min_available has lost its collective progress)."""
        if self.store_wired:
            if not any(name in c.nodes for c in self.caches):
                return
            # the kubelet dies with its pods: delete and controller
            # recreate against cluster truth; the caches follow by watch
            for uid in self.world.pods_on_node(name):
                self.world.delete_pod(uid)
                self._requeue_task(uid, on_node=False)
            for cache in self.caches:
                cache.remove_node(name)
            return
        uids: List[str] = []
        seen: set = set()
        present = False
        for cache in self.caches:
            node = cache.nodes.get(name)
            if node is None:
                continue
            present = True
            for uid in list(node.tasks):
                if uid not in seen:
                    seen.add(uid)
                    uids.append(uid)
        if not present:
            return
        for uid in uids:
            # the lost members ride the validate-then-requeue resolution
            # (cache.requeue_lost_member): a member mid-bind on the dying
            # node has its in-flight entry resolved with the requeue
            self._requeue_task(uid, on_node=False, lost_node=name)
        for cache in self.caches:
            cache.remove_node(name)

    def _requeue_task(self, uid: str, on_node: bool = True,
                      via_ack: bool = False,
                      lost_node: Optional[str] = None) -> None:
        jid = self.task_job.get(uid, "")
        if self.store_wired:
            # the evicted or killed pod was deleted cluster-side; the
            # controller recreates it (the same logical member) and the
            # cache converges by watch. recreate_pod refusing (no blueprint:
            # the gang completed; the pod present: already recreated)
            # means there is nothing to requeue
            if not self.world.recreate_pod(uid):
                return
            self._note_requeue(uid)
            self.requeues += 1
            if jid in self.admitted_at:
                del self.admitted_at[jid]
                self._admit_epoch[jid] = self._admit_epoch.get(jid, 0) + 1
            return
        touched_any = False
        for cache in self.caches:
            if via_ack:
                # an eviction confirmation off the ack wire, consumed
                # through the cache's FeedbackChannel normalizer
                touched = cache.feedback.ack_evicted(jid, uid) == "applied"
            else:
                # cluster-initiated loss (node death): validate-then-
                # requeue
                touched = cache.requeue_lost_member(jid, uid,
                                                    lost_node=lost_node,
                                                    detach=on_node)
            touched_any = touched or touched_any
        if not touched_any:
            return
        if not via_ack:
            # cluster-initiated loss: the ack funnel never saw it, so the
            # runner records the requeue milestone itself
            self._timeline.record(jid, "requeue", task=uid,
                                  node=lost_node or None)
        self._note_requeue(uid)
        self.requeues += 1
        if jid in self.admitted_at:
            vjob = self._job(jid)
            if (vjob is not None and is_elastic(vjob)
                    and vjob.ready_task_num() >= max(vjob.min_available, 1)):
                # elastic-continue: the gang still holds >= min, so its
                # completion timer keeps running
                self._elastic_continues += 1
                return
            # the gang dropped below min_available: cancel its pending
            # completion (the epoch bump makes it stale) and re-admit
            del self.admitted_at[jid]
            self._admit_epoch[jid] = self._admit_epoch.get(jid, 0) + 1

    def _fire_completions_until(self, now: float) -> None:
        while self._completions and self._completions[0][0] <= now + 1e-9:
            t, _, uid, epoch = heapq.heappop(self._completions)
            if self._admit_epoch.get(uid, 0) != epoch \
                    or uid not in self.admitted_at:
                continue                       # stale: gang was broken up
            self._complete_job(uid, t)

    def _complete_job(self, uid: str, t: float) -> None:
        if self.store_wired:
            # cluster-truth completion: the pods and the PodGroup leave the
            # store; the cache drains through its watches
            task_uids = sorted(u for u, j in self.task_job.items()
                               if j == uid)
            if not task_uids:
                return
            self.world.complete_job(uid, task_uids)
            for tuid in task_uids:
                self.task_job.pop(tuid, None)
                self._live_bound.discard(tuid)
            self.admitted_at.pop(uid, None)
            self._credit_admission(uid)
            self.jct.append(t - self.arrival_time[uid])
            self._timeline.record(uid, "complete", t=t)
            OBS_TRACE.flow_end("complete", f"job:{uid}")
            self.completed += 1
            return
        vjob = self._job(uid)
        if vjob is None:
            return
        self._note_colocation(vjob)
        uids = list(vjob.tasks)
        for cache in self.caches:
            job = cache.jobs.get(uid)
            if job is None:
                continue
            for task in list(job.tasks.values()):
                cache.delete_task(task)
            cache.remove_job(uid)
        for tuid in uids:
            self.task_job.pop(tuid, None)
            self._live_bound.discard(tuid)
        self.admitted_at.pop(uid, None)
        self._credit_admission(uid)
        self.jct.append(t - self.arrival_time[uid])
        self._timeline.record(uid, "complete", t=t)
        OBS_TRACE.flow_end("complete", f"job:{uid}")
        self.completed += 1

    def _note_colocation(self, job) -> None:
        """The topology witness at completion: did the gang finish with all
        its placed members in one zone? Counted for gangs of two or more
        placed members, all on zoned nodes."""
        if not self.elastic_gangs:
            return
        zones = []
        view = self._view()
        for task in job.tasks.values():
            if not task.node_name:
                continue
            node = view.nodes.get(task.node_name)
            zones.append(node.topology_zone if node is not None else "")
        if len(zones) < 2 or not all(zones):
            return
        if len(set(zones)) == 1:
            self.colocated_gangs += 1
        else:
            self.spread_gangs += 1

    # -- post-cycle feedback ------------------------------------------------

    def _feedback(self, now: float) -> None:
        """Close the loop the way a live cluster would: binds ack to
        RUNNING, evictions delete-and-recreate PENDING, full gangs stamp
        admission and schedule completion. The HARVEST (reading the
        executor records) is cluster truth and stamps the runner's
        bookkeeping at once; the acks ride the _AckWire and are consumed
        by each cache's FeedbackChannel normalizer (the watch stream is
        cluster-wide, so deliveries fan out to every replica cache)."""
        # feedback runs between cycles: timeline events minted here carry
        # the feedback instant, not the previous cycle's
        self._timeline.set_context(t=now)
        touched: Dict[str, bool] = {}
        seq = self.binder.sequence
        while self._binds_seen < len(seq):
            uid, host = seq[self._binds_seen]
            self._binds_seen += 1
            # a second cluster-side bind of a task whose first bind is
            # still live (no evict/requeue in between) is a DOUBLE-BIND
            if uid in self._live_bound:
                self.double_binds += 1
            elif self._requeue_debt.get(uid):
                self._requeue_debt[uid] -= 1
                if not self._requeue_debt[uid]:
                    del self._requeue_debt[uid]
            else:
                self._live_bound.add(uid)
            jid = self.task_job.get(uid)
            if jid is None:
                continue
            placed = any(jid in cache.jobs
                         and uid in cache.jobs[jid].tasks
                         for cache in self.caches)
            if not placed:
                continue
            if not self.store_wired:
                # store mode: the RUNNING ack arrives through the watch
                # stream (possibly after a torn-stream resume)
                self._ack_wire.offer("running", uid, host)
            if jid not in self.first_bind:
                self.first_bind[jid] = now
                self.queueing_delay.append(now - self.arrival_time[jid])
                # the harvested first bind, the instant queueing_delay
                # samples, so timeline ttfb and the report agree
                self._timeline.record(jid, "bind", t=now, node=host)
            touched[jid] = True
        eseq = self.evictor.sequence
        while self._evicts_seen < len(eseq):
            uid = eseq[self._evicts_seen]
            self._evicts_seen += 1
            if self.store_wired:
                self._requeue_task(uid)
            else:
                self._ack_wire.offer("evicted", uid)
        if not self.store_wired:
            for kind, uid, node in self._ack_wire.due(now):
                jid = self.task_job.get(uid)
                if jid is None:
                    continue           # gang completed while the ack flew
                if kind == "running":
                    for cache in self.caches:
                        cache.feedback.ack_running(jid, uid, node)
                else:
                    self._requeue_task(uid, via_ack=True)
        if self.store_wired:
            # torn watch streams can delay the RUNNING acks past the cycle
            # that bound the gang: keep re-checking gangs with binds until
            # they admit, so admission lands on the first cycle the
            # (resumed) cache shows the gang ready
            for jid in self.first_bind:
                if jid not in self.admitted_at:
                    touched.setdefault(jid, True)
        if self.replicas and not self.store_wired:
            # HA: a failover's handoff reconcile can re-assert a
            # crash-window bind AFTER its kubelet ack was consumed above
            # (the ack arrived while leadership was vacant and feedback
            # waited): converge every still-BOUND task the cluster runs
            # through the normalizer, in sorted uid order
            for uid in sorted(self._live_bound):
                jid = self.task_job.get(uid)
                if jid is None:
                    continue
                for cache in self.caches:
                    cache.feedback.ack_running(jid, uid, node=None,
                                               source="converge")
        for jid in touched:
            job = self._job(jid)
            if job is None or jid in self.admitted_at:
                continue
            if job.min_available > 0 \
                    and job.ready_task_num() >= job.min_available:
                self.admitted_at[jid] = now
                self.gang_admission.append(now - self.arrival_time[jid])
                self._timeline.record(jid, "admitted", t=now)
                epoch = self._admit_epoch.get(jid, 0)
                heapq.heappush(self._completions,
                               (now + self.duration[jid], next(self._cseq),
                                jid, epoch))

    # -- the run loop -------------------------------------------------------

    def _progress_signature(self) -> tuple:
        return (self._trace_ix, self._binds_seen, self._evicts_seen,
                self.completed, self.requeues, self.unfinished_jobs(),
                self._ack_wire.delivered, self._ack_wire.pending(),
                sum(len(c.resync_queue) for c in self.caches),
                sum(len(c.dead_letter) for c in self.caches),
                len(self._retry_heap), self.sheds,
                self.readmit_attempts)

    def _done(self) -> bool:
        return (self._trace_ix >= len(self.trace)
                and not self._completions
                and not self.unfinished_jobs()
                # shed arrivals still waiting out their retry_after hints
                # land (and complete) before the run ends
                and not self._retry_heap
                and not self._ack_wire.pending()
                and not any(c.feedback.pending() for c in self.caches)
                # a submitted verb meets its cycle boundary (applied or
                # journaled dropped) before the run ends
                and (self._command_funnel is None
                     or not self._command_funnel.pending_count())
                # an elastic run ends on the SHRUNK membership: spawned
                # partitions idle out and merge back before the run
                # reports (the 1 -> N -> 1 witness); stall_limit stays the
                # backstop for a wedged merge
                and (not self.elastic
                     or len(self.replicas) <= max(self.federated, 1)))

    # -- crash/restart ------------------------------------------------------

    _KILL_MODES = ("bind_before", "bind_after", "evict_before",
                   "evict_after", "post_cycle")

    def _arm_kill(self) -> str:
        """Pick (seeded) where this cycle's crash lands and arm the
        matching kill point. Returns the mode; "post_cycle" crashes
        cleanly between run_once and the next cycle instead. Pipelined
        runs add "speculate": the process dies between the speculative
        dispatch and its commit."""
        modes = self._KILL_MODES + ("speculate",) if self.pipelined_mode \
            else self._KILL_MODES
        mode = self._kill_rng.choice(modes)
        at = self._kill_rng.randint(1, 5)
        if mode == "bind_before":
            self._kill_binder.arm(at, before=True)
        elif mode == "bind_after":
            self._kill_binder.arm(at, before=False)
        elif mode == "evict_before":
            self._kill_evictor.arm(at, before=True)
        elif mode == "evict_after":
            self._kill_evictor.arm(at, before=False)
        elif mode == "speculate":
            arm_speculation_kill(self.sched)
        return mode

    def _crash_restart(self, kill_mode: Optional[str] = None) -> None:
        """Simulate the scheduler process dying and a fresh incarnation
        starting against the same cluster. The cache's object graph
        stands in for what a restart rebuilds from the API server, so the
        restart drops exactly the state a process death loses — the
        resync queue, the dead-letter set, the in-flight ledger, every
        cached snapshot clone and the persistent node tensors — then
        settles the journal's crash window against the executors' record
        and replaces the shell."""
        c = self.cache
        if self._kill_binder is not None:
            self._kill_binder.disarm()
        if self._kill_evictor is not None:
            self._kill_evictor.disarm()
        c.binding_tasks.clear()
        c.inflight.clear()
        c.dead_letter.clear()
        metrics.set_dead_letter_size(0)
        c.err_tasks.clear()
        c.resync_queue = RateLimitedQueue(
            max_retries=c.resync_queue.max_retries,
            time_fn=self.clock.time)
        # the new process starts cold: every cached clone and the
        # persistent node tensors die with the old one
        c.mark_all_dirty()
        c.tensor_cache = None
        c._tensor_dirty = set()
        self._harvest_budget(self.sched)
        # a speculation in flight dies with the process
        self.sched.drop_speculation()
        self.sched = self._new_scheduler()
        # so does the device cool-down state (it lives in process memory);
        # its clock stays virtual
        from ..device_health import DEVICE_HEALTH
        DEVICE_HEALTH.reset(time_fn=self.clock.time)
        # the funnel outlives the shell: verbs submitted before the crash
        # apply at the new incarnation's first cycle boundary
        self.sched.command_funnel = self._command_funnel
        # the crash window holds at most ONE unacked intent (execution is
        # synchronous) and the kill mode says whether its executor ran:
        # only an after-execute kill makes the executor's last record the
        # crash-window op
        cluster_binds = dict(self.binder.sequence[-1:]) \
            if kill_mode == "bind_after" else {}
        etail = self.evictor.sequence[-1:] \
            if kill_mode == "evict_after" else []

        def cluster_evicts(uid: str) -> bool:
            return uid in etail

        report = self.sched.startup_reconcile(cluster_binds, cluster_evicts)
        if report is not None:
            for k, v in report.as_dict().items():
                if v:
                    self._journal_replayed[k] = \
                        self._journal_replayed.get(k, 0) + v
        self.restarts += 1

    # -- the HA control plane -------------------------------------------------

    def _lease_store_for(self, ix: int):
        """The store a replica's elector sees: the raw lease store, or,
        with ``lease_fault_rate``, its Lease CAS traffic behind the
        hostile-transport composition every other scheduler write rides
        (retry funnel → seeded faulty transport → store). One transport a
        replica index, kept across restarts, so its fault stream replays
        deterministically."""
        if not self.lease_fault_rate:
            return self.lease_store
        transport = self._lease_transports.get(ix)
        if transport is None:
            from ..chaos import StoreFaultInjector
            from ..store_transport import (FaultyStoreTransport,
                                           RetryingStoreTransport)
            injector = StoreFaultInjector(
                failure_rate=self.lease_fault_rate,
                seed=self.lease_fault_seed * 7919 + ix,
                latency_s=0.05, sleep_fn=self.clock.sleep)
            transport = RetryingStoreTransport(
                FaultyStoreTransport(self.lease_store, injector,
                                     name=f"lease-{ix}"),
                sleep_fn=self.clock.sleep, time_fn=self.clock.time,
                cycle_budget_s=0.5 * self.period,
                rng=random.Random(self.lease_fault_seed * 31 + ix))
            self._lease_transports[ix] = transport
        return transport

    def _init_ha(self, binder, evictor) -> None:
        """Build the N-replica control plane: a shared lease store,
        fencing authority and in-memory journal (the standby transport);
        a cache, shell, elector and follower a replica. Each replica's
        cache reaches the shared executor chain (kill and chaos wrappers
        over the sequence recorders) through a fencing gate that reads
        THAT replica's elector epoch, so a fenced ex-leader's write is
        rejected before it reaches the cluster."""
        from ..store import ObjectStore
        if self.journal is None:
            self.journal = IntentJournal()
        self.lease_store = ObjectStore()
        self.authority = FencingAuthority()
        self._pending_crash_oracle = None
        self.caches: List[SchedulerCache] = []
        self._view_ix = 0
        for ix in range(self.ha_replicas):
            rep = _Replica(ix)
            self._build_replica_cache(rep, binder, evictor)
            self._build_replica_shell(rep)
            self.replicas.append(rep)
            self.caches.append(rep.cache)
        self.cache = self.caches[0]
        self.sched = self.replicas[0].sched

    def _build_replica_cache(self, rep: _Replica, binder, evictor) -> None:
        cache = SchedulerCache(
            binder=FencedBinder(binder,
                                lambda r=rep: r.elector.fencing_epoch,
                                self.authority),
            evictor=FencedEvictor(evictor,
                                  lambda r=rep: r.elector.fencing_epoch,
                                  self.authority),
            default_queue=None, journal=self.journal)
        cache.resync_queue.time_fn = self.clock.time
        cache.time_fn = self.clock.time
        self._pin_feedback(cache)
        rep.cache = cache
        rep.follower = JournalFollower(cache)
        rep.follower.attach(self.journal)

    def _build_replica_shell(self, rep: _Replica) -> None:
        """(Re)build a replica's shell and elector: at construction and
        after each simulated process death (the cache survives; it stands
        in for the relist a restart performs)."""
        from ..leaderelection import FlapGuard, LeaderElector
        ident = f"replica-{rep.ix}" if rep.gen == 0 \
            else f"replica-{rep.ix}-g{rep.gen}"
        rep.elector = LeaderElector(
            self._lease_store_for(rep.ix), "vc-scheduler",
            on_started_leading=lambda: None,
            identity=ident,
            lease_duration=1.6 * self.period,
            renew_deadline=1.2 * self.period,
            retry_period=self.period,
            time_fn=self.clock.time, mono_fn=self.clock.time,
            authority=self.authority,
            flap_guard=FlapGuard(cooldown_s=4 * self.period,
                                 max_cooldown_s=16 * self.period,
                                 time_fn=self.clock.time))
        sched = self._new_scheduler(rep.cache)
        sched.attach_elector(rep.elector)
        sched.reconcile_oracle_fn = self._take_crash_oracle
        sched.action_fault_hook = self._mk_action_hook(rep)
        sched.close_fault_hook = self._close_hook
        rep.sched = sched

    def _take_crash_oracle(self):
        oracle, self._pending_crash_oracle = self._pending_crash_oracle, \
            None
        return oracle

    def _mk_action_hook(self, rep: _Replica) -> Callable:
        """A replica's pre-action hook: the seeded mid-action SimKill and
        the mid-cycle lease revocation both land at action boundaries of
        whoever LEADS (followers never reach the action loop)."""
        def hook(name: str, ssn) -> None:
            if self._armed_action is not None:
                self._armed_action -= 1
                if self._armed_action <= 0:
                    self._armed_action = None
                    raise SimKill(f"mid-action (before {name})")
            if self._armed_revoke is not None:
                self._armed_revoke -= 1
                if self._armed_revoke <= 0:
                    self._armed_revoke = None
                    rep.elector.revoke()
        return hook

    def _close_hook(self, ssn) -> None:
        if self._armed_close:
            self._armed_close = False
            raise SimKill("inside close_session")

    _HA_EXTRA_KILL_MODES = ("mid_action", "in_close")

    def _arm_kill_ha(self) -> str:
        """HA kill arming: the direct mode's kill points plus two HA ones,
        a SimKill before a seeded action and one inside close_session."""
        mode = self._kill_rng.choice(self._KILL_MODES
                                     + self._HA_EXTRA_KILL_MODES)
        at = self._kill_rng.randint(1, 5)
        if mode == "bind_before":
            self._kill_binder.arm(at, before=True)
        elif mode == "bind_after":
            self._kill_binder.arm(at, before=False)
        elif mode == "evict_before":
            self._kill_evictor.arm(at, before=True)
        elif mode == "evict_after":
            self._kill_evictor.arm(at, before=False)
        elif mode == "mid_action":
            self._armed_action = at
        elif mode == "in_close":
            self._armed_close = True
        return mode

    def _disarm_kills(self) -> None:
        for kb, ke in self._store_kill_wrappers.values():
            kb.disarm()
            ke.disarm()
        if self._kill_binder is not None:
            self._kill_binder.disarm()
        if self._kill_evictor is not None:
            self._kill_evictor.disarm()
        self._armed_action = None
        self._armed_close = False

    def _wipe_volatile(self, rep: _Replica) -> None:
        """What the death of a replica's or a partition's process loses:
        the armed kill points, the cache's resync queue, dead letters,
        in-flight ledger, every cached clone and the persistent node
        tensors, and the device cool-down state (its clock stays virtual).
        The incarnation count rises."""
        self._disarm_kills()
        c = rep.cache
        c.binding_tasks.clear()
        c.inflight.clear()
        c.dead_letter.clear()
        metrics.set_dead_letter_size(0)
        c.err_tasks.clear()
        c.resync_queue = RateLimitedQueue(
            max_retries=c.resync_queue.max_retries,
            time_fn=self.clock.time)
        c.mark_all_dirty()
        c.tensor_cache = None
        c._tensor_dirty = set()
        from ..device_health import DEVICE_HEALTH
        DEVICE_HEALTH.reset(time_fn=self.clock.time)
        rep.gen += 1

    def _crash_window_oracle(self, kill_mode: Optional[str]) -> tuple:
        """The cluster's record of the crash window, exact to the kill
        mode: only an after-execute kill makes the executor's last record
        the crash-window op. ``(cluster_binds, cluster_evicts)``."""
        cluster_binds = dict(self.binder.sequence[-1:]) \
            if kill_mode == "bind_after" else {}
        etail = tuple(self.evictor.sequence[-1:]) \
            if kill_mode == "evict_after" else ()

        def cluster_evicts(uid: str, tail=etail) -> bool:
            return uid in tail

        return cluster_binds, cluster_evicts

    def _crash_restart_replica(self, rep: _Replica,
                               kill_mode: Optional[str]) -> None:
        """A replica's process dies and restarts as a FOLLOWER: volatile
        state is lost (its persistent node tensors with it), the shared
        journal and lease store survive. The crash-window oracle (exact
        to the kill mode, as the direct restart's) is parked for whichever
        replica next acquires the lease: failover IS lease-acquire →
        startup_reconcile → resume. Cluster feedback waits while
        leadership is vacant (a real cluster's acks would queue in the new
        leader's informer sync), so reconcile settles the crash window
        before any ack is consumed."""
        self._wipe_volatile(rep)
        # a fresh incarnation: new identity, elector and shell; the
        # standby follower reseeds from the surviving journal's open
        # intents so the coming reconcile's acks resolve against it
        if rep.follower is not None:
            rep.follower.detach()
        rep.follower = JournalFollower(rep.cache)
        rep.follower.attach(self.journal)
        self._harvest_budget(rep.sched)
        self._build_replica_shell(rep)
        self._pending_crash_oracle = self._crash_window_oracle(kill_mode)
        self._feedback_blocked = True
        self.restarts += 1

    def _account_leadership(self) -> None:
        """End-of-cycle leadership bookkeeping: failovers, the
        failover-time-in-cycles samples, the view cache, the handoff
        report and the feedback gate."""
        leader = None
        for rep in self.replicas:
            if rep.sched.role == ROLE_LEADER and rep.elector.leading:
                leader = rep
                break
        if leader is None:
            if self._leader_key is not None:
                self._leader_key = None
            if self._vacant_since is None:
                self._vacant_since = self.cycles
            return
        self._view_ix = leader.ix
        key = leader.key()
        if key != self._leader_key:
            if self._had_leader:
                # a failover: across a vacancy (a killed leader's lease had
                # to expire) or a same-cycle handoff (revocation and
                # immediate takeover, gap 0)
                self.failovers += 1
                gap = 0 if self._vacant_since is None \
                    else self.cycles - self._vacant_since
                self.failover_cycles.append(gap)
            self._vacant_since = None
            self._leader_key = key
            self._had_leader = True
            rpt = getattr(leader.sched, "last_handoff_report", None)
            leader.sched.last_handoff_report = None
            if rpt is not None:
                for k, v in rpt.as_dict().items():
                    if v:
                        self._journal_replayed[k] = \
                            self._journal_replayed.get(k, 0) + v
        self._feedback_blocked = False

    def _ha_cycle(self, now: float) -> None:
        """One virtual cycle of the N-replica control plane: seeded kill
        and lease-loss arming, every replica's run_once in replica order
        (followers run their election step and nothing else), leadership
        accounting, then cluster feedback unless a vacancy defers it."""
        kill_mode: Optional[str] = None
        if self.cycles in self.kill_cycles:
            kill_mode = self._arm_kill_ha()
        if self.cycles in self.lease_loss_cycles:
            # the leader is revoked just before a seeded action ordinal: it
            # must abandon its open session at that boundary and demote
            self._armed_revoke = self._lease_rng.randint(1, 5)
        for transport in self._lease_transports.values():
            transport.new_cycle()
        leader_ran = False
        for rep in self.replicas:
            t0 = time.perf_counter()
            try:
                errors = rep.sched.run_once()
            except SimKill:
                errors = []
                self._crash_restart_replica(rep, kill_mode)
                kill_mode = None
            else:
                if rep.sched.role == ROLE_LEADER:
                    leader_ran = True
                    self.pipeline_e2e_ms.append(
                        (time.perf_counter() - t0) * 1e3)
                    if kill_mode is not None:
                        # the armed kill never fired in the leader's cycle
                        # (too few side effects, or post_cycle): a death
                        # at the clean boundary, still a real restart
                        self._crash_restart_replica(rep, "post_cycle")
                        kill_mode = None
            for name, _ in errors:
                self.action_failures.append((self.cycles, name))
        if kill_mode is not None and not leader_ran:
            # a kill armed for a cycle with no leader: nothing to kill;
            # disarm so the stale arm cannot fire later
            self._disarm_kills()
        self._armed_revoke = None
        self._account_leadership()
        if not self._feedback_blocked:
            self._feedback(now)

    # -- the federated control plane ----------------------------------------

    def _init_federated(self, binder, evictor) -> None:
        """Build the N-partition control plane: a shared PartitionMap,
        reserve ledger, in-memory journal and lease store, and a partition
        each of: a cache (its snapshot scoped to the partition's queue
        subset and node shard), a fenced executor gate against its OWN
        authority (epochs namespaced by partition id), a cycle-driven
        elector on its OWN lease, and a PartitionMember riding the shell's
        federation hooks."""
        from ..cache.executors import FencingRegistry
        from ..federation import PartitionMap, ReserveLedger
        from ..store import ObjectStore
        if self.journal is None:
            self.journal = IntentJournal()
        self.lease_store = ObjectStore()
        self.registry = FencingRegistry()
        self.pmap = PartitionMap(self.federated)
        self.ledger = ReserveLedger(self.pmap, journal=self.journal,
                                    registry=self.registry,
                                    time_fn=self.clock.time,
                                    timeout_s=8 * self.period,
                                    donor_guard=self.elastic)
        self.caches: List[SchedulerCache] = []
        self._view_ix = 0
        self._fed_oracles: Dict[int, tuple] = {}
        self._p_leader_key: Dict[int, Optional[tuple]] = {}
        self._p_vacant: Dict[int, Optional[int]] = {}
        self._p_had: Dict[int, bool] = {}
        # kept for elastic spawns: a newborn partition's executor gate
        # wraps the SAME (possibly kill-wrapped) cluster executors
        self._fed_binder = binder
        self._fed_evictor = evictor
        for pid in range(self.federated):
            rep = _Replica(pid)
            cache = SchedulerCache(
                binder=FencedBinder(binder,
                                    lambda r=rep: r.elector.fencing_epoch,
                                    self.registry.authority(pid)),
                evictor=FencedEvictor(evictor,
                                      lambda r=rep: r.elector.fencing_epoch,
                                      self.registry.authority(pid)),
                default_queue=None, journal=self.journal)
            cache.resync_queue.time_fn = self.clock.time
            cache.time_fn = self.clock.time
            self._pin_feedback(cache)
            cache.snapshot_scope = \
                lambda ci, p=pid: self.pmap.scope(ci, p)
            cache.partition = pid
            rep.cache = cache
            self._build_partition_shell(rep)
            self.replicas.append(rep)
            self.caches.append(cache)
            self._cache_by_pid[pid] = cache
            self._p_leader_key[pid] = None
            self._p_vacant[pid] = None
            self._p_had[pid] = False
        self.cache = self.caches[0]
        self.sched = self.replicas[0].sched
        metrics.set_partition_count(len(self.replicas))

    def _build_partition_shell(self, rep: _Replica) -> None:
        """(Re)build one partition's shell, elector and member: at
        construction and after a simulated partition death (the cache and
        the shared map, ledger and journal survive)."""
        from ..federation import PartitionMember
        from ..leaderelection import (FlapGuard, LeaderElector,
                                      partition_lease_name)
        pid = rep.ix
        ident = f"fed-p{pid}" if rep.gen == 0 else f"fed-p{pid}-g{rep.gen}"
        rep.elector = LeaderElector(
            self._lease_store_for(pid),
            partition_lease_name("vc-scheduler", pid),
            on_started_leading=lambda: None,
            identity=ident,
            lease_duration=1.6 * self.period,
            renew_deadline=1.2 * self.period,
            retry_period=self.period,
            time_fn=self.clock.time, mono_fn=self.clock.time,
            authority=self.registry.authority(pid),
            flap_guard=FlapGuard(cooldown_s=4 * self.period,
                                 max_cooldown_s=16 * self.period,
                                 time_fn=self.clock.time))
        sched = self._new_scheduler(rep.cache)
        sched.attach_elector(rep.elector)
        sched.reconcile_oracle_fn = \
            lambda p=pid: self._fed_oracles.pop(p, None)
        sched.action_fault_hook = self._mk_action_hook(rep)
        sched.close_fault_hook = self._close_hook
        # the store-backed federation gives each partition its OWN map and
        # ledger mirror; in process the partitions share one
        pmap = self._p_maps.get(pid, self.pmap)
        ledger = self._p_ledgers.get(pid, self.ledger)
        member = PartitionMember(
            pid, pmap, ledger, rep.cache,
            epoch_fn=lambda r=rep: r.elector.fencing_epoch,
            time_fn=self.clock.time,
            starve_after_s=4 * self.period)
        if self.rebalance:
            # load-driven rebalancing: each partition's controller moves
            # only its OWN queues, off published load signals. A restart
            # loses the flap guard's state (volatile, like the device
            # cool-down) but never the moves: the runner harvests a dying
            # incarnation's in _crash_restart_partition
            from ..federation import RebalanceController
            ctrl = RebalanceController(
                pid, pmap, ledger, rep.cache,
                epoch_fn=lambda r=rep: r.elector.fencing_epoch,
                time_fn=self.clock.time,
                exhausted_fn=lambda s=sched: s.budget_exhausted_total,
                min_depth=8, min_gap=8, ratio=2.0,
                cooldown_s=8 * self.period,
                max_cooldown_s=64 * self.period)
            member.rebalancer = ctrl
            self._rebalancers[pid] = ctrl
        if self.elastic:
            # elastic membership: this partition's controller may split it
            # or drive its merge, with the runner as host supervisor
            # (spawn_fn and retire_fn build and reap shells). A restart
            # loses the streak and flap state (volatile) but never the
            # counters, which _crash_restart_partition harvests; a killed
            # RETIRING partition resumes its drain from the persisted
            # membership state
            from ..federation import ElasticController
            ectrl = ElasticController(
                pid, pmap, ledger, rep.cache,
                epoch_fn=lambda r=rep: r.elector.fencing_epoch,
                time_fn=self.clock.time,
                exhausted_fn=lambda s=sched: s.budget_exhausted_total,
                spawn_fn=self._spawn_partition,
                retire_fn=self._retire_partition,
                cooldown_s=16 * self.period,
                max_cooldown_s=128 * self.period)
            member.elastic = ectrl
            self._elastics[pid] = ectrl
        sched.federation = member
        rep.sched = sched

    # -- elastic membership hooks -------------------------------------------

    def _spawn_partition(self, pid: int) -> None:
        """The host half of a SPLIT: the journaled ``partition_spawn``
        already minted ``pid`` in the map; build the newborn's cache (with
        its own persistent node tensors, built at its first solve),
        scheduler shell, Lease and FencingAuthority, as a deployment's
        supervisor starts one more partition process. The newborn owns
        nothing until the split's queue moves settle through the drain
        funnel; its cache backfills queues and nodes from the recorded
        trace specs (direct mode: the relist a fresh process runs) or its
        own filtered informers (store mode)."""
        rep = _Replica(pid)
        if self.store_wired:
            from ..federation import (StoreBackedPartitionMap,
                                      StoreBackedReserveLedger,
                                      StorePartitionBackend)
            # the newborn's own hostile store chain, seeded by pid as an
            # up-front partition's is
            while len(self.world.transports) <= pid:
                self.world.add_scheduler()
            backend = StorePartitionBackend(self.world.transports[pid],
                                            self.federated)
            pmap_p = StoreBackedPartitionMap(backend)
            ledger = StoreBackedReserveLedger(
                pmap_p, backend, journal=self.journal,
                registry=self.registry, time_fn=self.clock.time,
                timeout_s=8 * self.period, donor_guard=self.elastic)
            cache, b, e = self.world.build_cache(
                pid, self._fed_binder_wrap, self._fed_evictor_wrap,
                journal=self.journal,
                event_filter=self._fed_event_filter(pid))
            self._pin_store_feedback(cache, pid)
            if self.kill_cycles:
                kb, ke = KillPointBinder(b), KillPointEvictor(e)
                self._store_kill_wrappers[pid] = (kb, ke)
                b, e = kb, ke
            cache.binder = FencedBinder(
                b, lambda r=rep: r.elector.fencing_epoch,
                self.registry.authority(pid))
            cache.evictor = FencedEvictor(
                e, lambda r=rep: r.elector.fencing_epoch,
                self.registry.authority(pid))
            cache.snapshot_scope = \
                lambda ci, m=pmap_p, p=pid: m.scope(ci, p)
            cache.partition = pid
            rep.cache = cache
            ledger.attach_cache(pid, cache)
            self._p_maps[pid] = pmap_p
            self._p_ledgers[pid] = ledger
            self.ledgers.append(ledger)
            # the newborn's mirror learns every live cache and every live
            # mirror learns the newborn's: settle_moves needs the
            # destination cache
            for other_pid, other_cache in self._cache_by_pid.items():
                ledger.attach_cache(other_pid, other_cache)
            for lg in self.ledgers:
                lg.attach_cache(pid, cache)
        else:
            cache = SchedulerCache(
                binder=FencedBinder(
                    self._fed_binder,
                    lambda r=rep: r.elector.fencing_epoch,
                    self.registry.authority(pid)),
                evictor=FencedEvictor(
                    self._fed_evictor,
                    lambda r=rep: r.elector.fencing_epoch,
                    self.registry.authority(pid)),
                default_queue=None, journal=self.journal)
            cache.resync_queue.time_fn = self.clock.time
            cache.time_fn = self.clock.time
            self._pin_feedback(cache)
            cache.snapshot_scope = \
                lambda ci, p=pid: self.pmap.scope(ci, p)
            cache.partition = pid
            rep.cache = cache
        # the relist: every queue and node the watch stream has announced
        # so far (jobs arrive only through the move funnel). A newborn
        # process LISTS before it watches; the store-wired cache's watch
        # delivers only events from now on, so both modes backfill here
        cache = rep.cache
        for spec in self._queue_specs.values():
            cache.add_queue(QueueInfo(name=spec["name"],
                                      weight=spec["weight"]))
        for spec in self._node_specs.values():
            scalars = {"nvidia.com/gpu": float(spec["gpus"])} \
                if spec["gpus"] else None
            alloc = Resource(spec["cpu_milli"], spec["mem"], scalars)
            alloc.max_task_num = spec["pods"]
            labels = {TOPOLOGY_ZONE_LABEL: spec["zone"]} \
                if spec.get("zone") else None
            node = NodeInfo(name=spec["name"], allocatable=alloc,
                            labels=labels)
            if spec["name"] in self._unready_nodes:
                node.ready = False
            cache.add_node(node)
        self._build_partition_shell(rep)
        self.replicas.append(rep)
        self.caches.append(rep.cache)
        self._cache_by_pid[pid] = rep.cache
        self._p_leader_key[pid] = None
        self._p_vacant[pid] = None
        self._p_had[pid] = False
        self._partition_peak = max(self._partition_peak,
                                   len(self.replicas))
        self._elastic_events.append(
            {"cycle": self.cycles, "kind": "spawn", "pid": pid})
        metrics.set_partition_count(len(self.replicas))

    def _retire_partition(self, pid: int) -> None:
        """The host half of a MERGE: the journaled ``partition_retire``
        already removed ``pid`` from the map with its ownership drained;
        reap the shell, folding every counter the report sums into the run
        totals (the harvest a crash restart performs: retirement is a
        PLANNED process exit), and free the retired cache's persistent
        node tensors on the device. Pids are never reused, so the reaped
        slot leaves the live lists."""
        rep = next((r for r in self.replicas if r.ix == pid), None)
        if rep is None:
            return
        self._harvest_budget(rep.sched)
        ctrl = self._rebalancers.pop(pid, None)
        if ctrl is not None:
            self._rebalance_moves.extend(ctrl.moves)
            self._rebalance_base["abstentions"] += ctrl.abstentions
            self._rebalance_base["refused"] += ctrl.refused
        ectrl = self._elastics.pop(pid, None)
        if ectrl is not None:
            self._harvest_elastic(ectrl)
        if self.store_wired:
            # the retired cache leaves self.caches: bank its stream
            # recovery counters so store_detail stays whole-run
            mgr = getattr(rep.cache, "watch_manager", None)
            if mgr is not None:
                for w in mgr.watches:
                    self._retired_watch_counts["resumes"] += w.resumes
                    self._retired_watch_counts["relists"] += w.relists
        # the process exits: its device tensors go with it
        rep.cache.tensor_cache = None
        rep.cache._tensor_dirty = set()
        self.replicas.remove(rep)
        self.caches.remove(rep.cache)
        self._cache_by_pid.pop(pid, None)
        self._p_leader_key.pop(pid, None)
        self._p_vacant.pop(pid, None)
        self._p_had.pop(pid, None)
        self._fed_oracles.pop(pid, None)
        self._elastic_events.append(
            {"cycle": self.cycles, "kind": "retire", "pid": pid})
        metrics.set_partition_count(len(self.replicas))

    def _harvest_elastic(self, ectrl) -> None:
        """An elastic controller dies with its shell (crash restart or
        retirement): fold its decision counters into the run totals."""
        for k in ("splits", "merges", "abstentions", "refused"):
            self._elastic_base[k] += getattr(ectrl, k)

    def elastic_stats(self) -> Dict[str, object]:
        """The report's deterministic elastic-membership section."""
        totals = dict(self._elastic_base)
        for c in self._elastics.values():
            for k in ("splits", "merges", "abstentions", "refused"):
                totals[k] += getattr(c, k)
        return {
            "enabled": self.elastic,
            "splits": totals["splits"],
            "merges": totals["merges"],
            "abstentions": totals["abstentions"],
            "refused": totals["refused"],
            "partitions_initial": self.federated,
            "partitions_final": len(self.replicas),
            "partitions_peak": self._partition_peak,
            "max_queue_depth": self._max_queue_depth,
            "events": list(self._elastic_events),
        }

    def _sample_queue_depth(self) -> None:
        """The elastic run's bounded-depth witness: the deepest single
        queue's pending-task count, maxed over the run."""
        from ..api import TaskStatus
        depth = 0
        for cache in self.caches:
            per_q: Dict[str, int] = {}
            for job in cache.jobs.values():
                n = len(job.task_status_index.get(TaskStatus.PENDING, {}))
                if n:
                    per_q[job.queue] = per_q.get(job.queue, 0) + n
            if per_q:
                depth = max(depth, max(per_q.values()))
        self._max_queue_depth = max(self._max_queue_depth, depth)

    def _crash_restart_partition(self, rep: _Replica,
                                 kill_mode: Optional[str]) -> None:
        """One partition's process dies and restarts: volatile state is
        lost (its persistent node tensors with it), the shared journal,
        map, ledger and lease store (and the cache, standing in for the
        relist) survive. The crash-window oracle, exact to the kill mode,
        is parked for THIS partition's next leader; the other partitions
        keep scheduling their own subsets, and cluster feedback waits until
        every partition has a leader again (the killed partition's handoff
        reconcile settles its crash window before any ack is consumed)."""
        self._wipe_volatile(rep)
        self._harvest_budget(rep.sched)
        ctrl = self._rebalancers.get(rep.ix)
        if ctrl is not None:
            # the controller dies with the shell: fold its moves and
            # decision counters into the run's totals before the rebuild
            self._rebalance_moves.extend(ctrl.moves)
            self._rebalance_base["abstentions"] += ctrl.abstentions
            self._rebalance_base["refused"] += ctrl.refused
        ectrl = self._elastics.get(rep.ix)
        if ectrl is not None:
            # the same for the elastic controller; a killed RETIRING
            # partition is not lost: the fresh controller resumes the
            # drain from the persisted membership state
            self._harvest_elastic(ectrl)
        self._build_partition_shell(rep)
        self._fed_oracles[rep.ix] = self._crash_window_oracle(kill_mode)
        self._feedback_blocked = True
        self.restarts += 1

    def _account_partitions(self) -> None:
        """End-of-cycle leadership bookkeeping a partition: failovers and
        vacancy gaps (the HA report fields), the handoff report's harvest,
        and the feedback gate, opened once EVERY partition has a live
        leader."""
        all_lead = True
        for rep in self.replicas:
            pid = rep.ix
            leads = rep.sched.role == ROLE_LEADER and rep.elector.leading
            if not leads:
                all_lead = False
                self._p_leader_key[pid] = None
                if self._p_vacant[pid] is None:
                    self._p_vacant[pid] = self.cycles
                continue
            key = rep.key()
            if key != self._p_leader_key[pid]:
                if self._p_had[pid]:
                    self.failovers += 1
                    gap = 0 if self._p_vacant[pid] is None \
                        else self.cycles - self._p_vacant[pid]
                    self.failover_cycles.append(gap)
                self._p_vacant[pid] = None
                self._p_leader_key[pid] = key
                self._p_had[pid] = True
                rpt = getattr(rep.sched, "last_handoff_report", None)
                rep.sched.last_handoff_report = None
                if rpt is not None:
                    for k, v in rpt.as_dict().items():
                        if v:
                            self._journal_replayed[k] = \
                                self._journal_replayed.get(k, 0) + v
        if all_lead:
            self._feedback_blocked = False

    def _federated_cycle(self, now: float) -> None:
        """One virtual cycle of the N-partition control plane: seeded kill
        arming (the kill fires inside whichever partition's cycle trips
        the armed point; an arm that never fires becomes a clean-boundary
        death of a seeded partition), every partition's run_once in pid
        order, leadership accounting, then cluster feedback unless a
        partition vacancy defers it."""
        kill_mode: Optional[str] = None
        boundary_rep = self.replicas[0]
        if self.cycles in self.kill_cycles:
            live = self.replicas
            if self.store_wired:
                # the store world builds kill wrappers a partition (each
                # has its own store chain): seed the boundary partition
                # first and arm its wrappers
                boundary_rep = live[self._kill_rng.randint(
                    0, len(live) - 1)]
                self._kill_binder, self._kill_evictor = \
                    self._store_kill_wrappers[boundary_rep.ix]
                kill_mode = self._arm_kill_ha()
            else:
                kill_mode = self._arm_kill_ha()
                boundary_rep = live[self._kill_rng.randint(
                    0, len(live) - 1)]
        if self.cycles in self.lease_loss_cycles:
            self._armed_revoke = self._lease_rng.randint(1, 5)
        for transport in self._lease_transports.values():
            transport.new_cycle()
        fired = False
        # a snapshot: a partition's run_once may SPAWN a sibling (it runs
        # from the next cycle) or retire ITSELF (it already ran this one)
        for rep in list(self.replicas):
            t0 = time.perf_counter()
            try:
                errors = rep.sched.run_once()
            except SimKill:
                errors = []
                self._crash_restart_partition(rep, kill_mode)
                kill_mode = None
                fired = True
            else:
                if rep.sched.role == ROLE_LEADER:
                    self.pipeline_e2e_ms.append(
                        (time.perf_counter() - t0) * 1e3)
            for name, _ in errors:
                self.action_failures.append((self.cycles, name))
        if kill_mode is not None and not fired:
            # the armed kill never fired (too few side effects, or
            # post_cycle): a clean-boundary death of the seeded partition
            if boundary_rep not in self.replicas:
                # the seeded partition retired THIS cycle (its merge
                # completed before the arm could fire): the clean-boundary
                # death lands on the merge sink instead
                boundary_rep = self.replicas[0]
            self._crash_restart_partition(boundary_rep, "post_cycle")
        self._armed_revoke = None
        self._account_partitions()
        if not self._feedback_blocked:
            self._feedback(now)

    def _fed_event_filter(self, pid: int):
        """The server-side filtered watch of a federated deployment:
        Pod and PodGroup events reach only their queue's owning partition.
        Ownership is read from the REGISTRAR map (the raw-store
        PartitionState, the server's own view, never torn), so the filter
        stays stable while a partition's faulted streams lag."""
        from ..cache.store_wiring import GROUP_NAME_ANNOTATION

        def filt(kind: str, obj) -> bool:
            if kind == "PodGroup":
                queue = obj.spec.queue
            else:
                group = obj.metadata.annotations.get(
                    GROUP_NAME_ANNOTATION, "")
                pg = self.world.store.get("PodGroup",
                                          obj.metadata.namespace, group)
                queue = pg.spec.queue if pg is not None else None
            if queue is None:
                return pid == 0
            owner = self.pmap.owner_of_queue(queue)
            return (owner if owner is not None else 0) == pid

        return filt

    def _init_federated_store(self, binder_wrap, evictor_wrap) -> None:
        """N partitions over the hostile store boundary, with the
        PartitionMap and ReserveLedger on the PartitionState object: a
        partition each of its OWN hostile transport, its own map and ledger
        mirror over it, an informer-fed cache filtered to its queue subset
        and a fenced executor gate, coordinating only through the store
        and the shared journal (the multi-process deployment's shape)."""
        from ..cache.executors import FencingRegistry
        from ..federation import (StoreBackedPartitionMap,
                                  StoreBackedReserveLedger,
                                  StorePartitionBackend)
        from ..store import ObjectStore
        if self.journal is None:
            self.journal = IntentJournal()
        self.lease_store = ObjectStore()
        self.registry = FencingRegistry()
        # the registrar mirror over the RAW store: trace-stream
        # registration, the server-side ingestion filter and the report's
        # map
        self._registrar_backend = StorePartitionBackend(self.world.store,
                                                        self.federated)
        self.pmap = StoreBackedPartitionMap(self._registrar_backend)
        self.caches = []
        self._view_ix = 0
        self._fed_oracles = {}
        self._p_leader_key = {}
        self._p_vacant = {}
        self._p_had = {}
        # kept for elastic spawns: a newborn's store chain takes the same
        # chaos wraps an up-front partition's does
        self._fed_binder_wrap = binder_wrap
        self._fed_evictor_wrap = evictor_wrap
        for pid in range(self.federated):
            rep = _Replica(pid)
            backend = StorePartitionBackend(self.world.transports[pid],
                                            self.federated)
            pmap_p = StoreBackedPartitionMap(backend)
            ledger = StoreBackedReserveLedger(
                pmap_p, backend, journal=self.journal,
                registry=self.registry, time_fn=self.clock.time,
                timeout_s=8 * self.period, donor_guard=self.elastic)
            cache, b, e = self.world.build_cache(
                pid, binder_wrap, evictor_wrap, journal=self.journal,
                event_filter=self._fed_event_filter(pid))
            self._pin_store_feedback(cache, pid)
            if self.kill_cycles:
                kb, ke = KillPointBinder(b), KillPointEvictor(e)
                self._store_kill_wrappers[pid] = (kb, ke)
                b, e = kb, ke
            cache.binder = FencedBinder(
                b, lambda r=rep: r.elector.fencing_epoch,
                self.registry.authority(pid))
            cache.evictor = FencedEvictor(
                e, lambda r=rep: r.elector.fencing_epoch,
                self.registry.authority(pid))
            cache.snapshot_scope = \
                lambda ci, m=pmap_p, p=pid: m.scope(ci, p)
            cache.partition = pid
            rep.cache = cache
            ledger.attach_cache(pid, cache)
            self._p_maps[pid] = pmap_p
            self._p_ledgers[pid] = ledger
            self.ledgers.append(ledger)
            self._build_partition_shell(rep)
            self.replicas.append(rep)
            self.caches.append(cache)
            self._cache_by_pid[pid] = cache
            self._p_leader_key[pid] = None
            self._p_vacant[pid] = None
            self._p_had[pid] = False
        # every partition's cache on every ledger mirror: settle_moves does
        # its job surgery on the DESTINATION cache, and the drain waits on
        # every mirror (the relist a destination process would run)
        for lg in self.ledgers:
            for other_pid, other_cache in self._cache_by_pid.items():
                lg.attach_cache(other_pid, other_cache)
        self.cache = self.caches[0]
        self.sched = self.replicas[0].sched
        self.ledger = self.ledgers[0]
        metrics.set_partition_count(len(self.replicas))

    def reserve_counts(self) -> Dict[str, int]:
        """Cross-partition reserve counters, summed over the ledger mirrors
        of a store-backed federation (each settlement is counted once, by
        the partition that performed it)."""
        if self.ledgers:
            out: Dict[str, int] = {}
            for lg in self.ledgers:
                for k, v in lg.counts.items():
                    out[k] = out.get(k, 0) + v
            return out
        return dict(self.ledger.counts) if self.ledger is not None else {}

    def federation_totals(self) -> Dict[str, int]:
        ledgers = self.ledgers or ([self.ledger]
                                   if self.ledger is not None else [])
        return {
            "node_transfers": sum(lg.node_transfers for lg in ledgers),
            "queue_moves": sum(lg.queue_moves for lg in ledgers),
        }

    def speculation_stats(self) -> Dict[str, object]:
        """This run's speculation verdicts; hit_rate counts committed
        speculations (hits and partial replays) over all verdicts."""
        now = metrics.speculation_counts()
        d = {k: int(now.get(k, 0) - self._spec_mark.get(k, 0))
             for k in set(now) | set(self._spec_mark)}
        hits = d.get("hit", 0)
        partial = d.get("partial", 0)
        conflicts = d.get("conflict", 0)
        total = hits + partial + conflicts
        return {"hits": hits, "partial": partial, "conflicts": conflicts,
                "hit_rate": round((hits + partial) / total, 4)
                if total else 0.0}

    def elastic_gang_stats(self) -> Dict[str, object]:
        """The report's elastic-gangs section: this run's grows and shrinks
        (deltas of the process-wide counters), the below-min witness
        (expected 0), elastic continues, co-location at completion and the
        command funnel's ledger."""
        now = metrics.elastic_counts()
        d = {k: int(now.get(k, 0) - self._eg_mark.get(k, 0))
             for k in set(now) | set(self._eg_mark)}
        shrinks = {k.split("/", 1)[1]: v for k, v in d.items()
                   if k.startswith("shrink/") and v}
        placed = self.colocated_gangs + self.spread_gangs
        return {
            "enabled": self.elastic_gangs,
            "topology_weight": self.topology_weight,
            "grows": d.get("grows", 0),
            "shrinks": dict(sorted(shrinks.items())),
            "below_min_evictions": d.get("below_min", 0),
            "elastic_continues": self._elastic_continues,
            "colocated_gangs": self.colocated_gangs,
            "spread_gangs": self.spread_gangs,
            "colocation_rate": round(self.colocated_gangs / placed, 4)
            if placed else 0.0,
            "commands": self._command_funnel.stats()
            if self._command_funnel is not None else {},
        }

    def lifecycle_stats(self) -> Dict[str, object]:
        """The report's ``latency`` section (``lifecycle`` only): per queue
        class, percentiles of every timeline-derived latency — ttfb_s
        agrees with ``queueing_delay_s`` and jct_s with ``jct_s``, because
        both planes sample the same virtual instants."""
        classes = latency_classes(self._timeline)
        stats = self._timeline.stats()
        return {
            "classes": {
                cls: {kind: report_mod.percentiles(vals)
                      for kind, vals in sorted(kinds.items())}
                for cls, kinds in sorted(classes.items())},
            "timeline": {
                "jobs": stats["jobs"],
                "events": stats["events"],
                "lru_evicted": stats["evicted"],
                "duplicates_dropped": stats["duplicates_dropped"],
            },
        }

    def slo_status(self) -> List[dict]:
        """End-of-run SLO evaluation (``lifecycle`` only), published to the
        metrics as it goes, so ``metrics.health_detail()`` and the gauges
        agree with the report."""
        return self._slo_engine.publish(self._timeline,
                                        now=self.clock.time())

    def mesh_stats(self) -> Dict[str, object]:
        """The report's mesh section (seeded injector and virtual-clock
        windows, so byte-reproducible): faults injected by kind and slot,
        the heals, quarantines and readmissions since construction, the
        cycles on each rung and the CPU-rung witness (rung 3 cycles, 0
        while a slot survives). run() takes it before it hands
        DEVICE_HEALTH back to wall time."""
        if self._mesh_section is not None:
            return self._mesh_section
        from ..device_health import DEVICE_HEALTH
        now = metrics.mesh_counts()
        d = {k: now.get(k, 0) - self._mesh_mark.get(k, 0)
             for k in set(now) | set(self._mesh_mark)}
        heals = {k.split("/", 1)[1]: int(v) for k, v in d.items()
                 if k.startswith("heals/") and v}
        quars = {k.split("/", 1)[1]: int(v) for k, v in d.items()
                 if k.startswith("quarantines/") and v}
        inj: Dict[str, int] = {}
        devices_hit: List[int] = []
        if self._mesh_injector is not None:
            for _, kind, dev in self._mesh_injector.injected:
                inj[kind] = inj.get(kind, 0) + 1
                if dev not in devices_hit:
                    devices_hit.append(dev)
        detail = DEVICE_HEALTH.detail()
        return {
            "fault_rate": self.mesh_fault_rate,
            "injected": dict(sorted(inj.items())),
            "devices_faulted": sorted(devices_hit),
            "heals": dict(sorted(heals.items())),
            "quarantines": dict(sorted(quars.items())),
            "readmissions": int(d.get("readmissions", 0)),
            "rung_cycles": {str(k): v for k, v in
                            sorted(self.rung_cycles.items())},
            "cpu_fallback_cycles": int(self.rung_cycles.get(3, 0)),
            "devices_healthy_final": detail["devices_healthy"],
            "devices_quarantined_final": detail["devices_quarantined"],
        }

    def fast_admit_stats(self) -> Dict[str, int]:
        now = metrics.fast_admit_counts()
        return {k: int(now.get(k, 0) - self._fa_mark.get(k, 0))
                for k in ("gangs", "binds")}

    def run(self) -> dict:
        """Run the trace to completion (or stall/max_cycles); returns the
        report dict (sim/report.py)."""
        wall0 = time.perf_counter()
        mark = metrics.durations_mark()
        stall = 0
        last_sig = None
        while self.cycles < self.max_cycles:
            now = self.clock.time()
            if self.overload:
                # shed clients whose retry_after expired try again, and the
                # seeded injector may land a flash crowd, both through the
                # same admission gate as the trace
                self._drain_retries(now)
                self._inject_bursts(now)
            self._apply_trace_until(now)
            self._fire_completions_until(now)
            if self.store_wired:
                # client submissions that failed at the store boundary
                # retry here; the seeded torn-watch drill fires at its
                # cycles (the epilogue's upkeep must then resume or relist)
                self._drain_store_pending()
                while self._tear_cycles \
                        and self._tear_cycles[0] <= self.cycles:
                    self._tear_cycles.pop(0)
                    self.torn_watch_events += len(
                        self.world.tear_streams(1, self._tear_rng))
            if self.fast_admit_mode and not self.federated \
                    and not self.replicas:
                # the arrivals just applied bind now, through the journaled
                # funnel; the feedback pass stamps their first bind at this
                # virtual time, before the full cycle
                if self.sched.fast_admit():
                    self._feedback(now)
            if self.federated:
                self._federated_cycle(now)
            elif self.replicas:
                self._ha_cycle(now)
            else:
                kill_mode = None
                if self.cycles in self.kill_cycles:
                    kill_mode = self._arm_kill()
                t0 = time.perf_counter()
                try:
                    errors = self.sched.run_once()
                except SimKill:
                    errors = []
                    self._crash_restart(kill_mode)
                else:
                    if kill_mode is not None:
                        # "post_cycle", or an armed kill point that never
                        # fired this cycle: a restart at the clean
                        # boundary (the crash window is empty)
                        self._crash_restart("post_cycle")
                self.pipeline_e2e_ms.append(
                    (time.perf_counter() - t0) * 1e3)
                for name, _ in errors:
                    self.action_failures.append((self.cycles, name))
                self._feedback(now)
            # decision-plane samples: federated, the planes live in
            # DISJOINT partition caches, so utilization and fairness sum
            # across them; otherwise they read the (converged) view cache
            sample = self.caches if self.federated else [self._view()]
            if self.elastic:
                self._sample_queue_depth()
            self.util_cpu.append(report_mod.cpu_utilization_all(sample))
            self.util_mem.append(report_mod.mem_utilization_all(sample))
            self.drf_gap.append(report_mod.drf_fairness_gap_all(sample))
            if self._admission is not None:
                # the drain-throughput EWMA behind the retry_after hints,
                # fed virtual counts, so the hint stream is deterministic
                self._admission.observe_drain(self._drained_tasks)
                self._drained_tasks = 0
            if self.mesh_chaos:
                # the rung the allocate gate picked this cycle, a function
                # of the seeded faults on the virtual clock
                rung = int(metrics.mesh_counts().get("rung", 0))
                self.rung_cycles[rung] = self.rung_cycles.get(rung, 0) + 1
            self.cycles += 1
            self.clock.sleep(self.period)
            if self._done():
                break
            sig = self._progress_signature()
            stall = stall + 1 if sig == last_sig else 0
            last_sig = sig
            if stall >= self.stall_limit:
                break                # wedged backlog: report what's left
        # the run is over: a speculation still in flight is never committed
        self.sched.drop_speculation()
        wall_s = time.perf_counter() - wall0
        # hand the process-wide device cool-down back to wall time, so code
        # after the run is not stuck on a frozen virtual clock; the mesh
        # section first (the reset clears the lattice it reads)
        from ..device_health import (DEFAULT_COOLDOWN_S,
                                     DEFAULT_MAX_COOLDOWN_S, DEVICE_HEALTH)
        if self.mesh_chaos:
            self._mesh_section = self.mesh_stats()
            from ..actions import allocate as _alloc_mod
            if _alloc_mod.DEVICE_FAULT_HOOK is self._mesh_injector:
                _alloc_mod.DEVICE_FAULT_HOOK = None
            DEVICE_HEALTH.cooldown_s = DEFAULT_COOLDOWN_S
            DEVICE_HEALTH.max_cooldown_s = DEFAULT_MAX_COOLDOWN_S
        DEVICE_HEALTH.reset(time_fn=time.monotonic)
        # runs longer than the bounded metrics ring lose their oldest
        # per-action samples: flag the affected series
        since = metrics.durations_since(mark)
        end = metrics.durations_mark()
        truncated = sorted(
            "/".join(k) for k, vals in since.items()
            if end.get(k, 0) - mark.get(k, 0) > len(vals))
        return report_mod.build_report(
            self, actions_ms=since, wall_s=wall_s,
            actions_truncated=truncated)
