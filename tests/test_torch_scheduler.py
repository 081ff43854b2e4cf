"""The port's serial scheduler shell (volcano_tpu_torch/scheduler.py) and
its cache on the CPU: conf hot-reload, per-action isolation, the crash-loop
guard, the resync queue with dead letters, the intent journal at every
crash phase and restart reconciliation — the port's versions of
tests/test_scheduler_shell.py, tests/test_chaos.py and the non-HA,
non-store cases of tests/test_journal_recovery.py — and the rule that a
refusal is never isolated: every engine, argument, plugin, action and mode
the port lacks raises when the conf loads (construction or hot reload) or
from the sim's CLI, never as an action failure inside a cycle."""

import gc
import os
import time

import pytest

from volcano_tpu_torch import metrics
from volcano_tpu_torch.api import (JobInfo, NodeInfo, PodGroup, PodGroupPhase,
                                   Resource, TaskInfo, TaskStatus)
from volcano_tpu_torch.cache import (FakeBinder, FakeEvictor, SchedulerCache,
                                     SequenceBinder, SequenceEvictor)
from volcano_tpu_torch.cache.cache import RateLimitedQueue
from volcano_tpu_torch.cache.journal import IntentJournal, journal_enabled
from volcano_tpu_torch.chaos import (ActionFaultInjector, ChaosBinder,
                                     ChaosError, ChaosEvictor,
                                     KillPointBinder, KillPointEvictor,
                                     SimKill)
from volcano_tpu_torch.scheduler import Scheduler
from volcano_tpu_torch.sim.runner import VirtualClock

from torch_parity import DEPLOYED_CONF, port_gc_windows  # noqa: F401
from torch_parity import ONCE_REFUSED, jax_reference, once_refused_run
from torch_parity import ONCE_REFUSED_ENGINES, once_refused_engine_run
from torch_parity import one_torch_thread  # noqa: F401

GI = 1 << 30
SEED = 20260803


def make_world(binder, evictor=None, n_nodes=4, n_jobs=4, tasks_per_job=3,
               **cache_kw):
    cache = SchedulerCache(binder=binder,
                           evictor=evictor or SequenceEvictor(), **cache_kw)
    for i in range(n_nodes):
        alloc = Resource(16000, 32 * GI)
        alloc.max_task_num = 110
        cache.add_node(NodeInfo(name=f"n{i}", allocatable=alloc))
    for j in range(n_jobs):
        pg = PodGroup(name=f"j{j}", queue="default",
                      min_member=tasks_per_job, phase=PodGroupPhase.INQUEUE)
        job = JobInfo(uid=f"j{j}", name=f"j{j}", queue="default",
                      min_available=tasks_per_job, podgroup=pg)
        for k in range(tasks_per_job):
            job.add_task_info(TaskInfo(uid=f"j{j}-{k}", name=f"j{j}-{k}",
                                       job=f"j{j}",
                                       resreq=Resource(1000, GI)))
        cache.add_job(job)
    return cache


def scheduler(cache, **kw):
    kw.setdefault("schedule_period", 0.0)
    return Scheduler(cache, device="cpu", **kw)


def same(a: Resource, b: Resource) -> bool:
    """Value equality of two Resources, in every dimension within 1e-9."""
    names = set(a.resource_names()) | set(b.resource_names())
    return all(abs(a.get(n) - b.get(n)) < 1e-9 for n in names)


def assert_exact_accounting(cache, ctx=""):
    """Every node's idle/used equals allocatable minus exactly the
    requests of the tasks it carries."""
    for node in cache.nodes.values():
        expected = Resource()
        for t in node.tasks.values():
            if t.status not in (TaskStatus.PIPELINED, TaskStatus.RELEASING):
                expected.add(t.resreq)
        assert same(node.used, expected), \
            f"{ctx}: node {node.name} used drifted"
        assert same(node.idle, node.allocatable.clone().sub(expected)), \
            f"{ctx}: node {node.name} idle drifted"


def drive_to_bound(cache, cycles=30):
    sched = scheduler(cache)
    total = sum(len(j.tasks) for j in cache.jobs.values())
    for _ in range(cycles):
        sched.run_once()
        bound = sum(1 for j in cache.jobs.values()
                    for t in j.tasks.values()
                    if t.status == TaskStatus.BOUND)
        if bound == total and not len(cache.resync_queue):
            break
    return sched


def oracle(binder, evictor):
    """Cluster truth from the executors' tails: only the LAST executed
    side effect can be the crash window's unacked one."""
    return (dict(binder.sequence[-1:]),
            lambda uid: bool(evictor.sequence)
            and evictor.sequence[-1] == uid)


def simulate_restart(cache, binder, evictor):
    """What a process death loses, plus startup reconciliation, as
    SimRunner._crash_restart models it."""
    cache.binding_tasks.clear()
    cache.dead_letter.clear()
    cache.resync_queue = RateLimitedQueue(max_retries=12)
    cache.mark_all_dirty()
    binds, evicts = oracle(binder, evictor)
    return cache.reconcile_journal(binds, evicts)


# ---------------------------------------------------------------------------
# the shell: hot reload, resync drain, isolation, crash-loop guard
# ---------------------------------------------------------------------------

def test_conf_hot_reload(tmp_path):
    conf_path = tmp_path / "scheduler.conf"
    # first conf: enqueue only — nothing binds
    conf_path.write_text('actions: "enqueue"\n')
    cache = make_world(FakeBinder(), n_nodes=1, n_jobs=1, tasks_per_job=1)
    binder = cache.binder
    sched = scheduler(cache, conf_path=str(conf_path))
    assert sched.run_once() == []
    assert binder.binds == {}
    assert sched.conf.actions == ["enqueue"]

    # rewrite the conf: allocate joins the pipeline; mtime must change
    time.sleep(0.01)
    conf_path.write_text('actions: "enqueue, allocate"\n')
    os.utime(conf_path)
    assert sched.run_once() == []
    assert sched.conf.actions == ["enqueue", "allocate"]
    assert binder.binds == {"default/j0-0": "n0"}


def test_run_once_drains_resync_queue():
    cache = make_world(FakeBinder())
    calls = []
    # the shell passes its per-cycle cap (None = unbounded without a
    # cycle budget)
    cache.process_resync_tasks = \
        lambda max_items=None: calls.append(max_items) or 0
    scheduler(cache).run_once()
    assert calls == [None]


def test_run_once_records_phases_and_spans():
    metrics.reset_local()
    cache = make_world(FakeBinder())
    sched = scheduler(cache)
    assert sched.run_once() == []
    assert set(sched.last_cycle_s) == {"open_session", "enqueue",
                                       "allocate", "backfill",
                                       "close_session", "cycle"}
    durations = metrics.local_durations()
    assert len(durations[("e2e",)]) == 1
    assert {("action", n) for n in ("enqueue", "allocate", "backfill")} \
        <= set(durations)


def test_action_fault_isolated_session_closes():
    """An injected exception in one action: the action is skipped and
    counted, later actions still run, the session still closes (GC window
    restored), and run_once reports the failure."""
    metrics.reset_local()
    inner = SequenceBinder()
    cache = make_world(inner, n_jobs=2, tasks_per_job=5)
    sched = scheduler(cache)
    sched.action_fault_hook = ActionFaultInjector({"enqueue": [1]},
                                                  seed=SEED)
    errors = sched.run_once()
    assert [name for name, _ in errors] == ["enqueue"], \
        f"seed={SEED}: expected the injected enqueue fault, got {errors}"
    assert isinstance(errors[0][1], ChaosError)
    total = sum(len(j.tasks) for j in cache.jobs.values())
    assert len(inner.binds) == total, \
        f"seed={SEED}: allocate did not run after the enqueue fault"
    assert gc.isenabled(), "session did not close (GC still suspended)"
    assert metrics.local_counters().get(("action_failures", "enqueue")) == 1
    assert sched.run_once() == []


def test_crash_loop_guard_backoff_and_recovery():
    """A persistently failing action keeps run() alive in degraded state
    with backoff; removing the fault recovers to healthy."""
    metrics.reset_local()
    cache = make_world(FakeBinder(), n_jobs=1)
    sched = Scheduler(cache, schedule_period=0.005, backoff_base=0.005,
                      backoff_max=0.02, backoff_jitter=0.0, device="cpu")
    sched.action_fault_hook = ActionFaultInjector(
        {"allocate": ()}, failure_rate=1.0, seed=SEED)
    thread = sched.start()
    deadline = time.time() + 20
    while sched.consecutive_failures < 3 and time.time() < deadline:
        time.sleep(0.005)
    assert sched.consecutive_failures >= 3, \
        f"seed={SEED}: crash-loop guard never engaged"
    assert thread.is_alive(), "run() thread died on action faults"
    state, fails = metrics.health()
    assert state == metrics.DEGRADED and fails >= 3

    sched.action_fault_hook = None          # fault fixed
    deadline = time.time() + 20
    while metrics.health()[0] != metrics.HEALTHY and time.time() < deadline:
        time.sleep(0.005)
    assert metrics.health() == (metrics.HEALTHY, 0), \
        f"seed={SEED}: did not recover after the fault cleared"
    assert sched.consecutive_failures == 0
    sched.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_scheduler_virtual_clock_no_wall_sleep():
    """Scheduler.run paces through the injected clock: with a virtual
    clock, N one-second cycles advance N virtual seconds in wall
    milliseconds."""
    class StoppingClock(VirtualClock):
        def __init__(self, n):
            super().__init__()
            self.n = n
            self.sched = None

        def sleep(self, seconds):
            super().sleep(seconds)
            self.n -= 1
            if self.n <= 0:
                self.sched.stop()

    clock = StoppingClock(5)
    sched = Scheduler(SchedulerCache(), conf_text='actions: "enqueue"\n',
                      schedule_period=1.0, clock=clock, device="cpu")
    clock.sched = sched
    t0 = time.perf_counter()
    sched.run()                        # returns: the clock stops it
    wall = time.perf_counter() - t0
    assert clock.time() >= 4.0, "virtual clock did not advance per cycle"
    assert wall < 2.0, f"virtual-clock run still slept {wall:.1f}s of wall"


def test_prewarm_on_the_cpu_does_nothing():
    """prewarm builds the CUDA kernels and opens the card's context; a
    CPU scheduler has neither to do."""
    assert scheduler(make_world(FakeBinder())).prewarm() == 0


def test_cycle_budget_defers_with_carry_over():
    """A budget spent by the first action defers the rest of the pipeline
    to the next cycle, which starts with the first deferred action."""
    cache = make_world(SequenceBinder())
    seen = []
    sched = scheduler(cache, cycle_budget_s=1.0,
                      budget_cost_fn=lambda name, ssn: 2.0)
    sched.action_fault_hook = lambda name, ssn: seen.append(name)
    sched.run_once()
    sched.run_once()
    assert seen == ["enqueue", "allocate"]
    assert sched.budget_exhausted_total == 2
    assert sched.deferred_actions_total == 2 + 2


# ---------------------------------------------------------------------------
# chaos: bind/evict faults through the resync queue
# ---------------------------------------------------------------------------

def test_chaos_bind_convergence_e2e():
    """~20% seeded bind failures over >= 10 cycles: every gang converges to
    fully BOUND through the resync queue, with exact accounting, zero
    double-binds and zero lost tasks."""
    inner = SequenceBinder()
    binder = ChaosBinder(inner, failure_rate=0.2, seed=SEED)
    cache = make_world(binder, n_jobs=8, tasks_per_job=5)
    sched = scheduler(cache)
    total = sum(len(j.tasks) for j in cache.jobs.values())
    deadline = time.time() + 60
    cycles = 0
    while time.time() < deadline:
        sched.run_once()
        cycles += 1
        bound = sum(1 for j in cache.jobs.values()
                    for t in j.tasks.values()
                    if t.status == TaskStatus.BOUND)
        if bound == total and len(cache.resync_queue) == 0 and cycles >= 10:
            break
        time.sleep(0.01)
    assert binder.failures > 0, f"seed={SEED}: chaos injected no failures"
    keys = [k for k, _ in inner.sequence]
    assert len(keys) == len(set(keys)) == total, \
        f"seed={SEED}: double-bind or lost task"
    placements = {}
    for node in cache.nodes.values():
        for uid in node.tasks:
            assert uid not in placements, f"seed={SEED}: {uid} on two nodes"
            placements[uid] = node.name
    assert len(placements) == total
    assert_exact_accounting(cache, f"seed={SEED}")
    assert not cache.dead_letter


def test_chaos_evict_convergence():
    """~20% seeded evict failures: every eviction executes exactly once
    through the resync queue."""
    inner = FakeEvictor()
    evictor = ChaosEvictor(inner, failure_rate=0.2, seed=SEED + 1)
    cache = make_world(FakeBinder(), evictor=evictor, n_jobs=4,
                       tasks_per_job=5)
    tasks = []
    nodes = list(cache.nodes)
    for j, job in enumerate(cache.jobs.values()):
        job.podgroup.phase = PodGroupPhase.RUNNING
        for t in job.tasks.values():
            job.update_task_status(t, TaskStatus.RUNNING)
            cache.nodes[nodes[j % len(nodes)]].add_task(t)
            tasks.append(t)
    for t in tasks:
        cache.evict(t, "chaos")
    deadline = time.time() + 30
    while len(inner.evicts) < len(tasks) and time.time() < deadline:
        time.sleep(0.01)
        cache.process_resync_tasks()
    assert evictor.failures > 0, f"seed={SEED + 1}: no failures injected"
    assert sorted(inner.evicts) == sorted(t.key() for t in tasks)


def test_resync_dead_letter_and_redrive():
    """A permanently failing bind stops spinning after its retry budget,
    lands in the dead-letter set, and redrive_dead_letter() recovers it
    once the fault is fixed."""
    metrics.reset_local()

    class BrokenBinder(FakeBinder):
        def __init__(self):
            super().__init__()
            self.broken = True

        def bind(self, task, hostname):
            if self.broken:
                raise RuntimeError("permanent apiserver rejection")
            super().bind(task, hostname)

    binder = BrokenBinder()
    cache = make_world(binder, n_jobs=1, tasks_per_job=1,
                       resync_max_retries=3)
    cache.resync_queue.base_delay = 0.001
    job = next(iter(cache.jobs.values()))
    task = next(iter(job.tasks.values()))
    placed = task.clone()        # the session's copy, like dispatch sends
    placed.node_name = "n0"
    cache.bind(placed)
    assert len(cache.resync_queue) == 1
    deadline = time.time() + 10
    while not cache.dead_letter and time.time() < deadline:
        time.sleep(0.005)
        cache.process_resync_tasks()
    assert list(cache.dead_letter) == [f"bind/{task.uid}"]
    assert len(cache.resync_queue) == 0
    assert metrics.local_counters().get(("resync_dead_letter", "bind")) == 1
    assert metrics.dead_letter_size() == 1
    assert_exact_accounting(cache, f"seed={SEED}")

    binder.broken = False                     # operator fixed the fault
    assert cache.redrive_dead_letter() == 1
    deadline = time.time() + 10
    while not binder.binds and time.time() < deadline:
        time.sleep(0.005)
        cache.process_resync_tasks()
    assert binder.binds == {task.key(): "n0"}
    assert not cache.dead_letter and metrics.dead_letter_size() == 0
    assert job.tasks[task.uid].status == TaskStatus.BOUND


def test_chaos_binder_deterministic_from_seed():
    def pattern(seed):
        b = ChaosBinder(FakeBinder(), failure_rate=0.5, seed=seed)
        out = []
        t = TaskInfo(uid="t", name="t", job="j", resreq=Resource(1, 1))
        for _ in range(32):
            try:
                b.bind(t, "n0")
                out.append(True)
            except ChaosError:
                out.append(False)
        return out

    assert pattern(SEED) == pattern(SEED)
    assert pattern(SEED) != pattern(SEED + 1)


def test_resync_queue_virtual_time():
    """RateLimitedQueue honors an injected time source: nothing is ready
    until the VIRTUAL clock passes the backoff deadline."""
    clock = VirtualClock()
    q = RateLimitedQueue(base_delay=5.0, time_fn=clock.time)
    assert q.add_rate_limited("k", "item")
    assert q.pop_ready() == []
    clock.sleep(4.9)
    assert q.pop_ready() == []
    clock.sleep(0.2)
    assert q.pop_ready() == [("k", "item")]


# ---------------------------------------------------------------------------
# the intent journal at every crash phase
# ---------------------------------------------------------------------------

def _crash_bind(before: bool):
    inner = SequenceBinder()
    kb = KillPointBinder(inner)
    cache = make_world(kb, journal=IntentJournal())
    kb.arm(3, before=before)           # die at the 3rd bind of cycle 0
    with pytest.raises(SimKill):
        scheduler(cache).run_once()
    assert gc.isenabled(), "a crashed cycle kept collection suspended"
    return cache, inner


def test_crash_before_bind_ack_rolls_back():
    """Crash BEFORE the executor ran: the optimistic BOUND mark rolls back
    at reconciliation — the cluster never saw the bind."""
    cache, inner = _crash_bind(before=True)
    open_intents = cache.journal.unacked()
    assert len(open_intents) == 1 and open_intents[0].op == "bind"
    victim = open_intents[0].task
    report = simulate_restart(cache, inner, SequenceEvictor())
    assert report.rolled_back == 1 and report.repaired_binds == 0, report
    task = cache.jobs[open_intents[0].job].tasks[victim]
    assert task.status == TaskStatus.PENDING and not task.node_name
    assert not any(victim in n.tasks for n in cache.nodes.values())
    assert_exact_accounting(cache, "after rollback")
    assert len(cache.journal.unacked()) == 0
    assert simulate_restart(cache, inner, SequenceEvictor()).replayed == 0
    drive_to_bound(cache)
    uids = [u for u, _ in inner.sequence]
    assert sorted(uids) == sorted(set(uids)), "double-bind detected"
    assert len(uids) == sum(len(j.tasks) for j in cache.jobs.values())
    assert_exact_accounting(cache, "after recovery")


def test_crash_after_bind_ack_repairs_without_rebind():
    """Crash AFTER the executor ran but before the ack: reconciliation
    re-asserts the bind and must NOT re-issue it."""
    cache, inner = _crash_bind(before=False)
    open_intents = cache.journal.unacked()
    assert len(open_intents) == 1
    victim, node = open_intents[0].task, open_intents[0].node
    executed_before = len(inner.sequence)
    report = simulate_restart(cache, inner, SequenceEvictor())
    assert report.repaired_binds == 1 and report.rolled_back == 0, report
    assert len(inner.sequence) == executed_before
    task = cache.jobs[open_intents[0].job].tasks[victim]
    assert task.status == TaskStatus.BOUND and task.node_name == node
    assert victim in cache.nodes[node].tasks
    assert_exact_accounting(cache, "after repair")
    drive_to_bound(cache)
    uids = [u for u, _ in inner.sequence]
    assert sorted(uids) == sorted(set(uids)), "double-bind detected"
    assert_exact_accounting(cache, "after recovery")


def test_crash_before_rebind_keeps_previous_placement():
    """A RE-bind intent (task already validly placed) whose executor never
    ran must NOT be rolled back to pending: the cluster still runs the
    task on its previous node."""
    inner = SequenceBinder()
    kb = KillPointBinder(inner)
    cache = make_world(kb, journal=IntentJournal())
    drive_to_bound(cache)
    job = cache.jobs["j0"]
    task = next(iter(job.tasks.values()))
    prev_node = task.node_name
    rebind = task.clone()
    rebind.node_name = [n for n in cache.nodes if n != prev_node][0]
    kb.arm(1, before=True)
    with pytest.raises(SimKill):
        cache.bind(rebind)
    intent = cache.journal.unacked()[0]
    assert intent.fresh is False and intent.node == rebind.node_name
    report = simulate_restart(cache, inner, SequenceEvictor())
    assert report.rolled_back == 1, report
    cached = job.tasks[task.uid]
    assert cached.node_name == prev_node
    assert cached.uid in cache.nodes[prev_node].tasks
    assert_exact_accounting(cache, "re-bind rollback")


def _world_with_bound():
    inner = SequenceBinder()
    evictor = SequenceEvictor()
    ke = KillPointEvictor(evictor)
    cache = make_world(inner, ke, journal=IntentJournal())
    drive_to_bound(cache)
    return cache, inner, evictor, ke


def test_crash_before_evict_ack_leaves_decision_to_next_cycle():
    cache, inner, evictor, ke = _world_with_bound()
    job = cache.jobs["j0"]
    task = next(iter(job.tasks.values()))
    ke.arm(1, before=True)
    with pytest.raises(SimKill):
        cache.evict(task, "test")
    assert len(cache.journal.unacked()) == 1
    report = simulate_restart(cache, inner, evictor)
    assert report.rolled_back == 1, report
    assert job.tasks[task.uid].status == TaskStatus.BOUND
    assert not evictor.sequence
    assert_exact_accounting(cache, "evict-before")


def test_crash_after_evict_ack_repairs_releasing():
    cache, inner, evictor, ke = _world_with_bound()
    job = cache.jobs["j0"]
    task = next(iter(job.tasks.values()))
    ke.arm(1, before=False)
    with pytest.raises(SimKill):
        cache.evict(task, "test")
    assert evictor.sequence == [task.uid]
    report = simulate_restart(cache, inner, evictor)
    assert report.repaired_evicts == 1, report
    assert job.tasks[task.uid].status == TaskStatus.RELEASING
    assert len(evictor.sequence) == 1, "evict re-issued"


def test_unacked_bind_redone_idempotently_onto_journaled_node():
    """Without a cluster oracle the reconciler REDOES the intent, always
    onto the journaled node."""
    inner = SequenceBinder()
    kb = KillPointBinder(inner)
    cache = make_world(kb, journal=IntentJournal())
    kb.arm(2, before=True)
    with pytest.raises(SimKill):
        scheduler(cache).run_once()
    intent = cache.journal.unacked()[0]
    report = cache.reconcile_journal()         # no oracle
    assert report.redone == 1, report
    task = cache.jobs[intent.job].tasks[intent.task]
    assert task.status == TaskStatus.BOUND
    assert task.node_name == intent.node
    assert_exact_accounting(cache, "no-oracle redo")


def test_stale_intent_for_deleted_task_dropped():
    inner = SequenceBinder()
    kb = KillPointBinder(inner)
    cache = make_world(kb, journal=IntentJournal())
    kb.arm(1, before=True)
    with pytest.raises(SimKill):
        scheduler(cache).run_once()
    intent = cache.journal.unacked()[0]
    for t in list(cache.jobs[intent.job].tasks.values()):
        cache.delete_task(t)
    cache.remove_job(intent.job)
    report = cache.reconcile_journal()
    assert report.stale == 1 and report.redone == 0, report


# ---------------------------------------------------------------------------
# resync retry validity
# ---------------------------------------------------------------------------

def _world_with_queued_retry():
    inner = SequenceBinder()

    class FailFirst(SequenceBinder):
        def __init__(self):
            super().__init__()
            self.calls = 0

        def bind(self, task, hostname):
            self.calls += 1
            if self.calls == 1:
                raise RuntimeError("transient")
            inner.bind(task, hostname)
            super().bind(task, hostname)

    cache = make_world(FailFirst(), n_nodes=1, n_jobs=1, tasks_per_job=1)
    scheduler(cache).run_once()                 # bind fails -> retry queued
    assert len(cache.resync_queue) == 1
    return cache, inner


def test_retry_dropped_when_node_filled_up():
    cache, inner = _world_with_queued_retry()
    node = cache.nodes["n0"]
    filler = TaskInfo(uid="filler", name="filler", job="jX",
                      resreq=node.idle.clone(), status=TaskStatus.RUNNING)
    filler.node_name = "n0"
    cache.add_task(filler)
    time.sleep(0.02)                            # let the backoff expire
    assert cache.process_resync_tasks() == 0
    assert len(cache.resync_queue) == 0
    assert not inner.sequence, "retry executed the stale bind"
    task = next(iter(cache.jobs["j0"].tasks.values()))
    assert task.status == TaskStatus.PENDING, "half-applied BOUND state"
    assert_exact_accounting(cache, "full-node retry")


def test_retry_dropped_for_releasing_task():
    cache, inner = _world_with_queued_retry()
    job = cache.jobs["j0"]
    task = next(iter(job.tasks.values()))
    job.update_task_status(task, TaskStatus.RELEASING)
    time.sleep(0.02)
    assert cache.process_resync_tasks() == 0
    assert len(cache.resync_queue) == 0
    assert not inner.sequence


def test_valid_retry_still_executes():
    cache, inner = _world_with_queued_retry()
    time.sleep(0.02)
    assert cache.process_resync_tasks() == 1
    assert [u for u, _ in inner.sequence] == ["j0-0"]
    task = next(iter(cache.jobs["j0"].tasks.values()))
    assert task.status == TaskStatus.BOUND
    assert_exact_accounting(cache, "valid retry")


def test_evict_retry_updates_node_mirror():
    """The evict-retry success path updates the NODE's task mirror and
    accounting like the direct evict path does."""
    class FailFirstEvictor(SequenceEvictor):
        def __init__(self):
            super().__init__()
            self.calls = 0

        def evict(self, task, reason):
            self.calls += 1
            if self.calls == 1:
                raise RuntimeError("transient")
            super().evict(task, reason)

    cache = make_world(SequenceBinder(), FailFirstEvictor(),
                       n_jobs=1, tasks_per_job=1)
    drive_to_bound(cache)
    job = cache.jobs["j0"]
    task = next(iter(job.tasks.values()))
    node = cache.nodes[task.node_name]
    cache.evict(task, "test")              # fails -> retry queued
    assert task.status == TaskStatus.BOUND
    time.sleep(0.02)
    assert cache.process_resync_tasks() == 1
    assert job.tasks[task.uid].status == TaskStatus.RELEASING
    assert node.tasks[task.uid].status == TaskStatus.RELEASING
    assert same(node.releasing, task.resreq)


# ---------------------------------------------------------------------------
# journal durability mechanics
# ---------------------------------------------------------------------------

def test_file_recovery_after_process_death(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    j = IntentJournal(path, fsync_batch=1)
    t1 = TaskInfo(uid="t1", name="t1", job="j1", resreq=Resource(1, 1))
    t2 = TaskInfo(uid="t2", name="t2", job="j1", resreq=Resource(1, 1))
    s1 = j.record_intent("bind", t1, "n0")
    j.ack(s1, True)
    j.record_intent("bind", t2, "n1")          # never acked: the window
    j.close()
    j2 = IntentJournal(path)
    open_intents = j2.unacked()
    assert [(i.op, i.task, i.node) for i in open_intents] \
        == [("bind", "t2", "n1")]
    assert j2.record_intent("evict", t1) > open_intents[0].seq
    j2.close()


def test_rotation_compacts_acked_records(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    j = IntentJournal(path, fsync_batch=4, max_bytes=2000)
    t = TaskInfo(uid="t1", name="t1", job="j1", resreq=Resource(1, 1))
    keep = j.record_intent("bind", t, "n-keep")
    for i in range(200):
        s = j.record_intent("bind", t, f"n{i}")
        j.ack(s, True)
    assert j.rotations > 0
    assert os.path.getsize(path) < 2500
    j.close()
    j2 = IntentJournal(path)
    assert [i.seq for i in j2.unacked()] == [keep]
    j2.close()


def test_torn_tail_line_is_dropped(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    j = IntentJournal(path, fsync_batch=1)
    t = TaskInfo(uid="t1", name="t1", job="j1", resreq=Resource(1, 1))
    j.record_intent("bind", t, "n0")
    j.close()
    with open(path, "a") as f:
        f.write('{"kind": "intent", "seq": 99, "op": "bi')   # torn
    j2 = IntentJournal(path)
    assert [i.task for i in j2.unacked()] == ["t1"]
    j2.close()


def test_intent_durable_before_executor_runs(tmp_path):
    """By the time the binder executes, the intent is already on disk."""
    path = str(tmp_path / "journal.jsonl")

    class DiskCheckingBinder(SequenceBinder):
        def __init__(self):
            super().__init__()
            self.intent_on_disk_at_bind = []

        def bind(self, task, hostname):
            with open(path) as f:
                on_disk = any(f'"task":"{task.uid}"' in line
                              and '"kind":"intent"' in line for line in f)
            self.intent_on_disk_at_bind.append((task.uid, on_disk))
            super().bind(task, hostname)

    binder = DiskCheckingBinder()
    cache = make_world(binder,
                       journal=IntentJournal(path, fsync_batch=10_000))
    drive_to_bound(cache)
    assert binder.intent_on_disk_at_bind
    assert all(ok for _, ok in binder.intent_on_disk_at_bind)


def test_kill_switch_detaches_journal(monkeypatch):
    monkeypatch.setenv("VOLCANO_TPU_JOURNAL", "0")
    assert not journal_enabled()
    assert SchedulerCache(journal=IntentJournal()).journal is None
    monkeypatch.delenv("VOLCANO_TPU_JOURNAL")
    assert journal_enabled()


# ---------------------------------------------------------------------------
# restart under chaos: the sim soak
# ---------------------------------------------------------------------------

def _chaos_run(kill_cycles, kill_seed):
    from volcano_tpu_torch.sim.runner import SimRunner
    from volcano_tpu_torch.sim.workload import make_scenario
    runner = SimRunner(
        make_scenario("smoke", seed=3), seed=3,
        binder_wrap=lambda b: ChaosBinder(b, failure_rate=0.2, seed=SEED),
        evictor_wrap=lambda e: ChaosEvictor(e, failure_rate=0.2, seed=SEED),
        kill_cycles=kill_cycles, kill_seed=kill_seed, device="cpu")
    return runner.run()


def test_killed_run_converges_to_unkilled_accounting():
    from volcano_tpu_torch.sim.report import terminal_accounting
    baseline = _chaos_run([], 0)
    assert baseline["jobs"]["completed"] == baseline["jobs"]["arrived"]
    killed = _chaos_run([2, 5, 9, 13], 1)
    assert killed["restarts"] == 4, f"seed={SEED}"
    assert terminal_accounting(killed) == terminal_accounting(baseline)
    assert killed["double_binds"] == 0
    assert killed["jobs"]["unfinished"] == 0
    assert killed["journal_replayed"].get("replayed", 0) >= 1, \
        f"seed={SEED}: no journal replay — kills never landed mid-op"


def test_killed_run_is_deterministic():
    from volcano_tpu_torch.sim.report import deterministic_json
    assert deterministic_json(_chaos_run([2, 5, 9], 2)) \
        == deterministic_json(_chaos_run([2, 5, 9], 2))


# ---------------------------------------------------------------------------
# no refusal is isolated
# ---------------------------------------------------------------------------

SIMPLE_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: predicates
  - name: nodeorder
"""

# the engines once refused by name (ROADMAP §0), which run since slice 19:
# (conf text, the engine). ``_established`` gives each conf with the engine
# whose decisions it must equal (tpu-sharded's are tpu-blocks' at every
# mesh size, preempt's the single walk's, reclaim's the callbacks
# rotation's; callbacks-parallel's are callbacks'); tests/test_torch_sharded
# .py and test_torch_callbacks_parallel.py hold those to the JAX package
REFUSED_CONFS = [
    (SIMPLE_CONF + "configurations:\n- name: allocate\n  arguments:\n"
     f"    engine: {engine}\n", engine)
    for engine in ("tpu-sharded", "callbacks-parallel")
] + [
    (DEPLOYED_CONF.replace("engine: tpu\n- name: reclaim",
                           "engine: tpu-sharded\n- name: reclaim"),
     "tpu-sharded"),
    (DEPLOYED_CONF.replace("- name: reclaim\n  arguments:\n    engine: tpu",
                           "- name: reclaim\n  arguments:\n"
                           "    engine: tpu-sharded"), "tpu-sharded"),
]


def _established(conf_text: str) -> str:
    return (conf_text
            .replace("engine: tpu-sharded\n- name: preempt",
                     "engine: tpu-blocks\n- name: preempt")
            .replace("engine: tpu-sharded\n- name: reclaim",
                     "engine: tpu\n- name: reclaim")
            .replace("    engine: tpu-sharded\n    ", "    engine: tpu\n    ")
            .replace("reclaim\n  arguments:\n    engine: tpu-sharded",
                     "reclaim\n  arguments:\n    engine: callbacks")
            .replace("engine: tpu-sharded", "engine: tpu-blocks")
            .replace("engine: callbacks-parallel", "engine: callbacks"))


@pytest.fixture
def four_slots(one_torch_thread):
    from volcano_tpu_torch.ops import unified
    unified.set_devices(4, "cpu")
    yield
    unified.set_devices(None)


@pytest.mark.parametrize("conf_text, refused", REFUSED_CONFS,
                         ids=[f"{r}-{i}" for i, (_, r)
                              in enumerate(REFUSED_CONFS)])
def test_refusal_raises_at_construction(conf_text, refused, four_slots):
    """The name is the refusal this test held before slice 19; it now
    holds that the conf runs: a cycle over four CPU slots with no action
    failure, deciding what the established engine decides."""
    runs = []
    for text in (conf_text, _established(conf_text)):
        cache = make_world(FakeBinder(), n_jobs=3)
        assert Scheduler(cache, text, device="cpu").run_once() == []
        runs.append((dict(cache.binder.binds), list(cache.evictor.evicts)))
    assert _established(conf_text) != conf_text
    assert runs[0] == runs[1] and runs[0][0]


@pytest.mark.parametrize("conf_text, refused", REFUSED_CONFS,
                         ids=[f"{r}-{i}" for i, (_, r)
                              in enumerate(REFUSED_CONFS)])
def test_refusal_raises_at_reload_not_as_action_failure(tmp_path,
                                                        conf_text, refused,
                                                        four_slots):
    """The name is the refusal this test held before slice 19; it now
    holds that a hot-reloaded conf naming the engine is taken: the next
    cycles run it with no action failure."""
    metrics.reset_local()
    conf_path = tmp_path / "scheduler.conf"
    conf_path.write_text(SIMPLE_CONF)
    cache = make_world(FakeBinder(), n_jobs=3)
    sched = scheduler(cache, conf_path=str(conf_path))
    assert sched.run_once() == []
    time.sleep(0.01)
    conf_path.write_text(conf_text)
    os.utime(conf_path)
    for _ in range(2):
        assert sched.run_once() == []
    assert not [k for k in metrics.local_counters()
                if k[0] == "action_failures"]
    assert refused in [c.arguments.get("engine")
                       for c in sched.conf.configurations]
    time.sleep(0.01)
    conf_path.write_text(SIMPLE_CONF)
    os.utime(conf_path)
    assert sched.run_once() == []
    assert sched.run_once() == []


@pytest.fixture(scope="module")
def once_refused_reference(tmp_path_factory):
    return jax_reference("once-refused", list(ONCE_REFUSED),
                         tmp_path_factory.mktemp("jax") / "refused.pkl")


@pytest.mark.parametrize("name", list(ONCE_REFUSED))
def test_once_refused_name_runs_equal_to_jax(name, once_refused_reference):
    """tdm, sla, overcommit, task-topology and reservation, and the elect
    and reserve actions, were refused by name until slice 18. Each conf
    that named one now builds a scheduler, and its first cycle binds,
    evicts, moves PodGroups and elects as the JAX package's does, with no
    action failure."""
    conf = Scheduler(make_world(FakeBinder(), n_jobs=1),
                     ONCE_REFUSED[name], device="cpu").conf
    assert name in ([p.name for t in conf.tiers for p in t.plugins]
                    + conf.actions)
    got = once_refused_run(True, name)
    assert got == once_refused_reference[name]
    assert got["failures"] == [] and got["binds"]


@pytest.fixture(scope="module")
def once_refused_engine_reference(tmp_path_factory):
    return jax_reference("once-refused-engine", list(ONCE_REFUSED_ENGINES),
                         tmp_path_factory.mktemp("jax") / "engines.pkl")


@pytest.mark.parametrize("name", list(ONCE_REFUSED_ENGINES))
def test_once_refused_engine_runs_equal_to_jax(name,
                                              once_refused_engine_reference,
                                              one_torch_thread):
    """tpu-sharded (allocate, preempt, reclaim) and callbacks-parallel were
    refused by name until slice 19. Each conf that named one now runs a
    cycle on a preempt mix that binds, evicts and moves PodGroups as the
    JAX package's does, with no action failure."""
    assert name.split(":")[1] in ONCE_REFUSED_ENGINES[name]
    got = once_refused_engine_run(True, name)
    assert got == once_refused_engine_reference[name]
    assert got["failures"] == [] and got["binds"]
    if not name.startswith("allocate:"):
        assert got["evicts"]


# confs the port once refused and now runs: (conf text, what it names)
ACCEPTED_CONFS = [
    (SIMPLE_CONF + "configurations:\n- name: allocate\n  arguments:\n"
     "    topology-weight: 3\n", "topology-weight"),
    (DEPLOYED_CONF.replace("engine: tpu-fused\n",
                           "engine: tpu-fused\n    topology-weight: 10\n")
     .replace("  - name: gang\n", "  - name: gang\n  - name: elastic-gang\n")
     .replace("allocate-tpu, preempt", "allocate-tpu, grow-shrink, preempt"),
     "elastic-gang"),
]


@pytest.mark.parametrize("conf_text, named", ACCEPTED_CONFS,
                         ids=[n for _, n in ACCEPTED_CONFS])
def test_accepted_conf_constructs_and_runs(conf_text, named):
    assert named in conf_text
    cache = make_world(FakeBinder(), n_jobs=2)
    sched = Scheduler(cache, conf_text, device="cpu")
    assert sched.run_once() == []
    assert len(cache.binder.binds) == 6


@pytest.mark.parametrize("conf_text, named", ACCEPTED_CONFS,
                         ids=[n for _, n in ACCEPTED_CONFS])
def test_accepted_conf_hot_reloads(tmp_path, conf_text, named):
    """A hot reload to a conf naming the topology term or the elastic-gang
    plugin and stage takes effect at the next cycle, with no action
    failure."""
    metrics.reset_local()
    conf_path = tmp_path / "scheduler.conf"
    conf_path.write_text(SIMPLE_CONF)
    cache = make_world(FakeBinder(), n_jobs=2)
    sched = scheduler(cache, conf_path=str(conf_path))
    time.sleep(0.01)
    conf_path.write_text(conf_text)
    os.utime(conf_path)
    assert sched.run_once() == []
    reloaded = [c.arguments.get("topology-weight")
                for c in sched.conf.configurations] + sched.conf.actions \
        + [o.name for t in sched.conf.tiers for o in t.plugins]
    assert any(x for x in reloaded if x in ("3", 3, "elastic-gang"))
    assert not [k for k in metrics.local_counters()
                if k[0] == "action_failures"]
    assert len(cache.binder.binds) == 6


def test_refused_reload_keeps_run_degraded(tmp_path):
    """run() over a conf file the port refuses stays degraded, cycle
    after cycle, until the file is fixed: the refusal is not reported
    once and then dropped."""
    metrics.reset_local()
    conf_path = tmp_path / "scheduler.conf"
    conf_path.write_text(SIMPLE_CONF)
    cache = make_world(FakeBinder(), n_jobs=1)

    class StoppingClock(VirtualClock):
        n = 4

        def sleep(self, seconds):
            super().sleep(seconds)
            self.n -= 1
            if self.n <= 0:
                sched.stop()

    sched = Scheduler(cache, conf_path=str(conf_path), schedule_period=1.0,
                      backoff_base=1.0, backoff_max=1.0, backoff_jitter=0.0,
                      clock=StoppingClock(), device="cpu")
    assert sched.run_once() == []
    time.sleep(0.01)
    # an engine neither package has: still refused by name
    conf_path.write_text(REFUSED_CONFS[0][0].replace("tpu-sharded",
                                                     "tpu-nonexistent"))
    os.utime(conf_path)
    sched.run()
    assert sched.consecutive_failures == 4
    assert metrics.health() == (metrics.DEGRADED, 4)
    assert sched.conf.actions == ["enqueue", "allocate", "backfill"]


def test_pod_affinity_refusal_propagates_from_the_cycle(tmp_path):
    """The name is the refusal this test held before pod affinity was
    ported, kept so that the suite's record of it runs on; it now holds
    parity. Pod affinity, once refused in open_session, runs through the shell:
    Scheduler.run_once on tests/torch_parity.py's affinity world decides
    what the JAX package's deployed cycle decides, with no action failure,
    and the session's GC window closes."""
    from volcano_tpu_torch.cache import cache_from_world

    from torch_parity import jax_reference
    world, want = jax_reference("deployed", ["affinity"],
                                tmp_path / "affinity.pkl")["affinity"]
    cache = cache_from_world(world)
    sched = scheduler(cache, conf_text=DEPLOYED_CONF)
    assert sched.run_once() == []
    assert dict(cache.binder.binds) == want["binds"]
    assert sorted(cache.evictor.evicts) == want["evicts"]
    assert {uid: j.podgroup.phase.value
            for uid, j in cache.jobs.items()} == want["phases"]
    assert gc.isenabled()


@pytest.mark.parametrize("mode, value", [("solve_deadline_s", 0.5)])
def test_refused_scheduler_modes(mode, value):
    """The JAX shell's constructor modes the port once refused now run:
    ``solve_deadline_s`` is a hard deadline on the allocate action, and a
    span past it opens the device cool-down (the behaviour is held in
    tests/test_torch_device_health.py)."""
    import time as _time

    from volcano_tpu_torch.device_health import DEVICE_HEALTH
    sched = Scheduler(make_world(FakeBinder(), n_jobs=1), device="cpu",
                      **{mode: value})
    assert getattr(sched, mode) == value
    DEVICE_HEALTH.reset(time_fn=_time.monotonic)
    assert sched.run_once() == []
    assert DEVICE_HEALTH.available()     # a small cycle meets 0.5 s


def test_every_refused_sim_flag_exits_by_name(capsys):
    """The name is this test's before slice 19, when the sim's mesh flags
    were refused; since then none is: REFUSED_FLAGS is empty and every
    flag the JAX package's sim CLI takes parses, the mesh ones included
    (--sharded, --sharded-devices, --verify-sharded-equivalence,
    --mesh-chaos, --mesh-fault-rate, --mesh-fault-seed,
    --verify-mesh-equivalence)."""
    import re
    from pathlib import Path

    from volcano_tpu_torch.sim.__main__ import REFUSED_FLAGS, build_parser
    assert REFUSED_FLAGS == {}
    src = (Path(__file__).resolve().parents[1] / "volcano_tpu" / "sim"
           / "__main__.py").read_text()
    parser = build_parser()
    takes = {}
    for action in parser._actions:
        for opt in action.option_strings:
            takes[opt] = action.nargs != 0
    for flag in re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"', src):
        if flag in ("--help", "--list"):
            continue
        source = [] if flag in ("--scenario", "--trace") \
            else ["--scenario", "smoke"]
        argv = source + [flag] + (["1"] if takes[flag] else [])
        args = parser.parse_args(argv)
        assert not getattr(args, "refused", []), flag
    assert capsys.readouterr().err == ""


def test_sim_cli_flags_match_the_jax_package():
    """Every flag of the JAX package's sim CLI is either run by the port
    or refused by name: none is unknown and none is silently ignored."""
    import re
    from pathlib import Path

    from volcano_tpu_torch.sim.__main__ import REFUSED_FLAGS, build_parser
    src = (Path(__file__).resolve().parents[1] / "volcano_tpu" / "sim"
           / "__main__.py").read_text()
    jax_flags = set(re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"', src))
    ours = {opt for action in build_parser()._actions
            for opt in action.option_strings if opt.startswith("--")}
    assert jax_flags <= ours, sorted(jax_flags - ours)
    assert set(REFUSED_FLAGS) <= jax_flags
    assert ours - jax_flags == {"--device", "--help"}
