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

``elastic_gangs`` runs elastic gangs (``elastic_sim_conf`` unless a conf
is given): ``job_command`` events go through the command funnel, the
scheduler drains it at each cycle boundary, and the report gains the
``elastic_gangs`` section (grows, shrinks, the below-min witness, elastic
continues, co-location at completion, the funnel's ledger).
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
from ..cache.executors import SequenceBinder, SequenceEvictor
from ..cache.journal import IntentJournal
from ..chaos import (KillPointBinder, KillPointEvictor, SimKill,
                     arm_speculation_kill)
from ..elastic_gang.membership import (ELASTIC_DESIRED_ANNOTATION,
                                       TOPOLOGY_ZONE_LABEL, is_elastic)
from ..obs.lifecycle import TIMELINE, latency_classes
from ..obs.slo import SLOEngine
from ..obs.trace import TRACE as OBS_TRACE
from ..scheduler import Scheduler
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
    """The cluster→scheduler feedback wire: every kubelet/status ack the
    cluster owes the scheduler (RUNNING flip, eviction confirmation)
    rides this queue and is delivered in offer order at the instant it
    is offered. The wire is CLUSTER state: it survives scheduler kills."""

    __slots__ = ("clock", "_heap", "_seq", "delivered")

    def __init__(self, clock):
        self.clock = clock
        self._heap: List[Tuple[float, float, str, str, str]] = []
        self._seq = 0.0
        self.delivered = 0

    def offer(self, kind: str, uid: str, node: str = "") -> None:
        self._seq += 1.0
        heapq.heappush(self._heap,
                       (self.clock.time(), self._seq, kind, uid, node))

    def due(self, now: float) -> List[Tuple[str, str, str]]:
        out = []
        while self._heap and self._heap[0][0] <= now + 1e-9:
            _, _, kind, uid, node = heapq.heappop(self._heap)
            out.append((kind, uid, node))
        self.delivered += len(out)
        return out

    def pending(self) -> int:
        return len(self._heap)


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
                 device=None,
                 pipelined: bool = False,
                 fast_admit: bool = False,
                 elastic_gangs: bool = False,
                 topology_weight: float = 10.0,
                 lifecycle: bool = False):
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
        if self.kill_cycles:
            if self.journal is None:
                # in memory: survives the simulated process death
                self.journal = IntentJournal()
            self._kill_binder = binder = KillPointBinder(binder)
            self._kill_evictor = evictor = KillPointEvictor(evictor)
        # the overload plane's cycle budget, priced by a DETERMINISTIC cost
        # model (budget_cost_per_task virtual seconds a pending task an
        # action): exhaustion is a pure function of the decision plane
        self.cycle_budget_s = float(cycle_budget_s)
        self.budget_cost_per_task = float(budget_cost_per_task)
        self.overload = bool(self.cycle_budget_s)
        self._budget_base = {"exhausted": 0, "deferred": 0, "spend": 0.0}
        # what the report's HA and federation planes read: a direct run
        # has one scheduler and no partitions
        self.failovers = 0
        self.authority = None
        self.ledger = None
        self._ack_wire = _AckWire(self.clock)
        self.pipelined_mode = bool(pipelined)
        self.fast_admit_mode = bool(fast_admit)
        self.elastic_gangs = bool(elastic_gangs)
        self.topology_weight = float(topology_weight)
        self._wants_commands = any(ev.kind == "job_command"
                                   for ev in self.trace)
        if conf_text is not None:
            self.conf_text = conf_text
        elif self.elastic_gangs:
            self.conf_text = elastic_sim_conf(self.topology_weight)
        elif self.pipelined_mode or self.fast_admit_mode:
            self.conf_text = PIPELINED_SIM_CONF
        else:
            self.conf_text = SIM_CONF

        self.cache = SchedulerCache(binder=binder, evictor=evictor,
                                    default_queue=None,
                                    journal=self.journal)
        # retry backoff, ingestion timestamps and in-flight ack deadlines
        # all run on virtual time
        self.cache.resync_queue.time_fn = self.clock.time
        self.cache.time_fn = self.clock.time
        self._pin_feedback(self.cache)
        self.sched = self._new_scheduler()
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

    def _new_scheduler(self) -> Scheduler:
        """A scheduler shell over the cache: at construction and at every
        crash restart, with the same clock, seed, budget and device."""
        kwargs = {}
        if self.cycle_budget_s:
            kwargs = {"cycle_budget_s": self.cycle_budget_s,
                      "budget_cost_fn": self._budget_cost}
        return Scheduler(self.cache, conf_text=self.conf_text,
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
        s = self.sched
        spend = max(self._budget_base["spend"], s.max_cycle_spend_s)
        return {"budget_s": self.cycle_budget_s,
                "exhausted": self._budget_base["exhausted"]
                + s.budget_exhausted_total,
                "deferred_actions": self._budget_base["deferred"]
                + s.deferred_actions_total,
                "max_cycle_spend_s": round(spend, 6)}

    def overload_stats(self) -> Dict[str, object]:
        """The report's overload section. Only the cycle budget is in
        this package: admission shedding and injected bursts are not, so
        their counters stand at zero."""
        return {"cycle_budget": self.budget_stats(), "shed_total": 0,
                "shed": {}, "readmit_attempts": 0, "retries_pending": 0,
                "burst_jobs": 0}

    def _pin_feedback(self, cache: SchedulerCache) -> None:
        """In-flight ack deadlines expire on the virtual clock after a few
        periods, and a watchdog-recovered evict ack hands the
        controller-recreate to the runner."""
        cache.inflight.time_fn = self.clock.time
        cache.inflight.ack_timeout_s = 3.0 * self.period
        cache.feedback.on_watchdog_evict = \
            lambda jid, uid: self._watchdog_requeued(jid, uid)

    def _watchdog_requeued(self, jid: str, uid: str) -> None:
        """The watchdog recovered a LOST eviction ack and requeued the
        member: keep the runner's gang bookkeeping consistent."""
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

    # -- trace/event application --------------------------------------------

    def _apply_trace_until(self, now: float) -> int:
        n = 0
        while self._trace_ix < len(self.trace) \
                and self.trace[self._trace_ix].t <= now + 1e-9:
            self._apply_event(self.trace[self._trace_ix])
            self._trace_ix += 1
            n += 1
        return n

    def _apply_event(self, ev: TraceEvent) -> None:
        d = ev.data
        if ev.kind == "node_fail":
            self._fail_node(d["name"])
            return
        if ev.kind == "job_arrival":
            self._arrive(ev.t, d)
            return
        if ev.kind == "job_complete":
            if self.cache.jobs.get(d["name"]) is not None:
                self._complete_job(d["name"], ev.t)
            return
        if ev.kind == "job_command":
            # a lifecycle verb changes nothing here: it goes through the
            # journaled funnel and applies at the next cycle boundary
            self._command_funnel.submit(d["verb"], d["name"], d.get("value"))
            return
        cache = self.cache
        if ev.kind == "queue_add":
            cache.add_queue(QueueInfo(name=d["name"], weight=d["weight"]))
        elif ev.kind == "node_add":
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
        return len(self.cache.jobs)

    def dead_letter_total(self) -> int:
        return len(self.cache.dead_letter)

    def _arrive(self, t: float, d: dict) -> None:
        name = d["name"]
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
        self.cache.add_job(job)
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
        node = self.cache.nodes.get(name)
        if node is None:
            return
        for uid in list(node.tasks):
            # the lost members ride the validate-then-requeue resolution
            # (cache.requeue_lost_member): a member mid-bind on the dying
            # node has its in-flight entry resolved with the requeue
            self._requeue_task(uid, on_node=False, lost_node=name)
        self.cache.remove_node(name)

    def _requeue_task(self, uid: str, on_node: bool = True,
                      via_ack: bool = False,
                      lost_node: Optional[str] = None) -> None:
        jid = self.task_job.get(uid, "")
        cache = self.cache
        if via_ack:
            # an eviction confirmation off the ack wire, consumed through
            # the cache's FeedbackChannel normalizer
            touched = cache.feedback.ack_evicted(jid, uid) == "applied"
        else:
            # cluster-initiated loss (node death): validate-then-requeue
            touched = cache.requeue_lost_member(jid, uid,
                                                lost_node=lost_node,
                                                detach=on_node)
        if not touched:
            return
        if not via_ack:
            # cluster-initiated loss: the ack funnel never saw it, so the
            # runner records the requeue milestone itself
            self._timeline.record(jid, "requeue", task=uid,
                                  node=lost_node or None)
        self._note_requeue(uid)
        self.requeues += 1
        if jid in self.admitted_at:
            vjob = cache.jobs.get(jid)
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
        cache = self.cache
        job = cache.jobs.get(uid)
        if job is None:
            return
        self._note_colocation(job)
        uids = list(job.tasks)
        for task in list(job.tasks.values()):
            cache.delete_task(task)
        cache.remove_job(uid)
        for tuid in uids:
            self.task_job.pop(tuid, None)
            self._live_bound.discard(tuid)
        self.admitted_at.pop(uid, None)
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
        for task in job.tasks.values():
            if not task.node_name:
                continue
            node = self.cache.nodes.get(task.node_name)
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
        by the cache's FeedbackChannel normalizer."""
        # feedback runs between cycles: timeline events minted here carry
        # the feedback instant, not the previous cycle's
        self._timeline.set_context(t=now)
        cache = self.cache
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
            job = cache.jobs.get(jid)
            if job is None or uid not in job.tasks:
                continue
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
            self._ack_wire.offer("evicted", uid)
        for kind, uid, node in self._ack_wire.due(now):
            jid = self.task_job.get(uid)
            if jid is None:
                continue               # gang completed while the ack flew
            if kind == "running":
                cache.feedback.ack_running(jid, uid, node)
            else:
                self._requeue_task(uid, via_ack=True)
        for jid in touched:
            job = cache.jobs.get(jid)
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
                len(self.cache.resync_queue), len(self.cache.dead_letter))

    def _done(self) -> bool:
        return (self._trace_ix >= len(self.trace)
                and not self._completions
                and not self.unfinished_jobs()
                and not self._ack_wire.pending()
                # a submitted verb meets its cycle boundary (applied or
                # journaled dropped) before the run ends
                and (self._command_funnel is None
                     or not self._command_funnel.pending_count()))

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
            self._apply_trace_until(now)
            self._fire_completions_until(now)
            if self.fast_admit_mode:
                # the arrivals just applied bind now, through the journaled
                # funnel; the feedback pass stamps their first bind at this
                # virtual time, before the full cycle
                if self.sched.fast_admit():
                    self._feedback(now)
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
                    # fired this cycle: a restart at the clean boundary
                    # (the crash window is empty)
                    self._crash_restart("post_cycle")
            self.pipeline_e2e_ms.append((time.perf_counter() - t0) * 1e3)
            for name, _ in errors:
                self.action_failures.append((self.cycles, name))
            self._feedback(now)
            sample = [self.cache]
            self.util_cpu.append(report_mod.cpu_utilization_all(sample))
            self.util_mem.append(report_mod.mem_utilization_all(sample))
            self.drf_gap.append(report_mod.drf_fairness_gap_all(sample))
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
