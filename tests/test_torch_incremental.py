"""The port's incremental state on the CPU: clone-on-dirty snapshots, the
persistent node tensors with stable rows and holes, and the shadow drift
verifier — the port's versions of tests/test_incremental_snapshot.py and of
tests/test_journal_recovery.py::TestDriftSelfHealing, and the hole worlds
live against the JAX package.

- A seeded random mutation sequence (binds, acks, evictions, requeues,
  completions, arrivals, node drain/restore/add/remove, queue edits, real
  scheduler cycles) drives the cache; after EVERY step the snapshot must
  equal a from-scratch clone of the live state, and each persistent row
  must equal a fresh NodeTensors row of the same node, by name.
- The hole worlds (tests/torch_parity.py::hole_world_run) must bind every
  pod to the JAX package's node, in the same order, with the switch on
  (rows follow the holes) and off (snapshot order), and take the JAX
  package's node-tensor path solve by solve.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from volcano_tpu_torch import Scheduler, metrics
from volcano_tpu_torch.api import (JobInfo, NodeInfo, PodGroup,
                                   PodGroupPhase, QueueInfo, Resource,
                                   TaskInfo, TaskStatus)
from volcano_tpu_torch.cache import (FakeBinder, FakeEvictor, SchedulerCache,
                                     SequenceBinder, SequenceEvictor)
from volcano_tpu_torch.cache.snapshot import (NodeTensors,
                                              discover_resource_names,
                                              node_infos_for)
from volcano_tpu_torch.cache.synthetic import make_cluster, make_jobs
from volcano_tpu_torch.framework import (close_session, open_session,
                                         parse_scheduler_conf)

from torch_parity import (DEPLOYED_CONF, DRAIN_WORLDS,  # noqa: F401
                          HOLE_WORLDS, hole_world_run, jax_reference,
                          port_gc_windows)

GI = 1 << 30
OFF = "VOLCANO_TPU_INCREMENTAL_SNAPSHOT"


def _world(seed=0, nodes=12, tasks=60, jobs=12):
    cache = SchedulerCache(binder=FakeBinder(), evictor=FakeEvictor())
    for q in (QueueInfo(name="q1", weight=2), QueueInfo(name="q2", weight=1)):
        cache.add_queue(q)
    for n in make_cluster(nodes, cpu_milli=8000, mem=32 * GI, pods=20,
                          seed=seed):
        cache.add_node(n)
    for j in make_jobs(tasks, jobs, ["q1", "q2"], cpu_range=(500, 2000),
                       mem_range=(GI, 4 * GI), seed=seed):
        cache.add_job(j)
    return cache


def _all_tasks(container):
    return [t for j in container.values() for t in j.tasks.values()]


def _rnames(cache):
    return discover_resource_names(list(cache.nodes.values()),
                                   _all_tasks(cache.jobs))


def _assert_snapshot_matches_live(cache, snap, rn):
    """The incremental snapshot must equal a from-scratch clone of the
    live cache: per-node aggregates and task sets, per-job gang state."""
    inflight = set(cache.binding_tasks.values())
    expect_nodes = {name for name, n in cache.nodes.items()
                    if n.ready and name not in inflight}
    assert set(snap.nodes) == expect_nodes
    for name in expect_nodes:
        live, got = cache.nodes[name], snap.nodes[name]
        for field in ("idle", "used", "releasing", "pipelined"):
            lv = getattr(live, field).to_vector(rn)
            gv = getattr(got, field).to_vector(rn)
            assert np.array_equal(lv, gv), (
                f"node {name} {field}: snapshot {gv} != live {lv}")
        assert got.allocatable is live.allocatable
        assert got.ready and got.unschedulable == live.unschedulable
        assert got.used_ports == live.used_ports
        assert {u: (t.status, t.node_name) for u, t in got.tasks.items()} \
            == {u: (t.status, t.node_name) for u, t in live.tasks.items()}
    expect_jobs = {uid for uid, j in cache.jobs.items()
                   if j.podgroup is not None}
    assert set(snap.jobs) == expect_jobs
    for uid in expect_jobs:
        live, got = cache.jobs[uid], snap.jobs[uid]
        assert got.podgroup is live.podgroup
        assert (got.priority, got.queue, got.min_available) \
            == (live.priority, live.queue, live.min_available)
        assert {u: t.status for u, t in got.tasks.items()} \
            == {u: t.status for u, t in live.tasks.items()}
        assert np.array_equal(got.allocated.to_vector(rn),
                              live.allocated.to_vector(rn))
        assert got.ready_task_num() == live.ready_task_num()
    for uid, q in cache.queues.items():
        assert snap.queues[uid].weight == q.weight


ROW_FIELDS = ("idle", "used", "releasing", "pipelined", "allocatable",
              "max_tasks", "ntasks", "zone_code")


def _assert_tensor_rows_match(cache, snap, rn):
    """Each persistent row must EXACTLY equal a fresh NodeTensors row of
    the same snapshot node, by name — the device rows (scatter path
    included) and the host mirror alike; holes must be neutralized."""
    tc = cache.tensor_refresh(snap.nodes, rn, "cpu", snap.snap_epoch)
    assert tc is not None
    fresh = NodeTensors(list(snap.nodes.values()), rn, torch.device("cpu"))
    assert set(tc.index) == set(fresh.index)
    for f in ROW_FIELDS:
        pv, fv = getattr(tc, f), getattr(fresh, f)
        np.testing.assert_array_equal(pv.numpy(), tc.host[f])
        for name, fi in fresh.index.items():
            assert torch.equal(pv[tc.index[name]], fv[fi]), (
                f"row {name} {f}: persistent {pv[tc.index[name]]} != "
                f"fresh {fv[fi]}")
    for name, fi in fresh.index.items():
        assert torch.equal(tc.future_idle[tc.index[name]],
                           fresh.future_idle[fi])
    # holes can never be selected: zero rows with max_tasks 0
    for i, name in enumerate(tc.names):
        if not name:
            assert tc.max_tasks[i] == 0 and not tc.idle[i].any()
    # future idle on the device is idle + releasing - pipelined, in f32
    np.testing.assert_array_equal(
        tc.future_idle.numpy(),
        tc.host["idle"] + tc.host["releasing"] - tc.host["pipelined"])
    return tc


CYCLE_CONF = (
    'actions: "enqueue, {allocate}, backfill"\n'
    "tiers:\n"
    "- plugins:\n"
    "  - name: priority\n"
    "  - name: gang\n"
    "- plugins:\n"
    "  - name: drf\n"
    "  - name: predicates\n"
    "  - name: proportion\n"
    "  - name: nodeorder\n")


def _step(cache, rng, arrivals, conf):
    """One random mutation through the cache's real mutation paths."""
    kind = rng.choice(["bind", "ack", "evict", "requeue", "complete",
                       "arrive", "drain", "restore", "node_add",
                       "node_remove", "queue_edit", "cycle", "noop"])
    jobs = [j for j in cache.jobs.values() if j.podgroup is not None]
    if kind == "bind":
        pend = [(j, t) for j in jobs
                for t in j.task_status_index.get(TaskStatus.PENDING,
                                                 {}).values()]
        rng.shuffle(pend)
        for job, task in pend:
            fits = [n for n in cache.nodes.values()
                    if n.ready and task.resreq.less_equal(n.idle)
                    and len(n.tasks) < (n.max_task_num or 1 << 30)]
            if not fits:
                continue
            t = task.clone()
            t.node_name = rng.choice(fits).name
            cache.bind(t)
            return
    elif kind == "ack":
        bound = [t for j in jobs for t in j.tasks.values()
                 if t.status == TaskStatus.BOUND]
        if bound:
            cache.update_task_status(rng.choice(bound), TaskStatus.RUNNING)
    elif kind == "evict":
        running = [t for j in jobs for t in j.tasks.values()
                   if t.status in (TaskStatus.BOUND, TaskStatus.RUNNING)]
        if running:
            cache.evict(rng.choice(running), "chaos")
    elif kind == "requeue":
        rel = [t for j in jobs for t in j.tasks.values()
               if t.status == TaskStatus.RELEASING]
        if rel:
            # pod delete + controller recreate, collapsed (sim semantics)
            task = rng.choice(rel)
            job = cache.jobs[task.job]
            cache.delete_task(job.tasks[task.uid])
            cache.add_task(TaskInfo(uid=task.uid, name=task.name,
                                    job=task.job, resreq=task.resreq.clone(),
                                    creation_timestamp=
                                    task.creation_timestamp))
    elif kind == "complete":
        done = [j for j in jobs
                if j.min_available and j.ready_task_num() >= j.min_available]
        if done:
            job = rng.choice(done)
            for task in list(job.tasks.values()):
                cache.delete_task(task)
            cache.remove_job(job.uid)
    elif kind == "arrive":
        n = next(arrivals)
        for j in make_jobs(rng.randint(2, 6), 1, ["q1", "q2"],
                           cpu_range=(500, 2000), mem_range=(GI, 2 * GI),
                           seed=n, name_prefix=f"arr{n}-"):
            cache.add_job(j)
    elif kind == "drain":
        ready = [n for n in cache.nodes.values() if n.ready]
        if len(ready) > 2:
            node = rng.choice(ready)
            node.ready = False
            cache.mark_node_dirty(node.name)   # direct mutation contract
    elif kind == "restore":
        drained = [n for n in cache.nodes.values() if not n.ready]
        if drained:
            node = rng.choice(drained)
            node.ready = True
            cache.mark_node_dirty(node.name)
    elif kind == "node_add":
        n = next(arrivals)
        alloc = Resource(8000, 32 * GI)
        alloc.max_task_num = 20
        cache.add_node(NodeInfo(name=f"fresh-{n:03d}", allocatable=alloc))
    elif kind == "node_remove":
        empty = [n for n in cache.nodes.values() if not n.tasks]
        if len(empty) > 1:
            cache.remove_node(rng.choice(empty).name)
    elif kind == "queue_edit":
        cache.add_queue(QueueInfo(name="q2", weight=rng.randint(1, 5)))
    elif kind == "cycle":
        # a REAL scheduling cycle: sessions, statements, enqueue phase
        # flips, close-time writeback — the full reuse/invalidation surface
        errs = Scheduler(cache, conf_text=conf, device="cpu").run_once()
        assert not errs, f"cycle faulted: {errs}"


def _drive(seed: int, steps: int, allocate: str):
    cache = _world(seed=seed)
    rng = random.Random(seed)
    arrivals = iter(range(10_000))
    conf = CYCLE_CONF.format(allocate=allocate)
    for _ in range(steps):
        _step(cache, rng, arrivals, conf)
        snap = cache.snapshot()
        rn = _rnames(cache)
        _assert_snapshot_matches_live(cache, snap, rn)
        _assert_tensor_rows_match(cache, snap, rn)


@pytest.mark.parametrize("allocate", ["allocate", "allocate-tpu"])
@pytest.mark.parametrize("seed", [0, 7])
def test_incremental_oracle_random_mutations(seed, allocate):
    """The seeded mutation oracle, with the cycles' allocate on the
    callbacks engine and on tpu-fused (whose solves refresh the persistent
    tensors mid-sequence)."""
    _drive(seed, steps=60, allocate=allocate)


def test_snapshot_reuses_clean_clones():
    """Steady state with zero mutations: the second snapshot shares every
    node and job with the first, and the stats say so."""
    cache = _world()
    s1 = cache.snapshot()
    s2 = cache.snapshot()
    assert all(s2.nodes[k] is s1.nodes[k] for k in s1.nodes)
    assert all(s2.jobs[k] is s1.jobs[k] for k in s1.jobs)
    stats = cache.last_snapshot_stats
    assert stats["dirty_nodes"] == 0 and not stats["full"]
    assert stats["reused_nodes"] == len(s1.nodes)
    assert s2.snap_epoch == s1.snap_epoch + 1


def test_kill_switch_forces_full_clone(monkeypatch):
    monkeypatch.setenv(OFF, "0")
    cache = _world()
    s1 = cache.snapshot()
    s2 = cache.snapshot()
    assert all(s2.nodes[k] is not s1.nodes[k] for k in s1.nodes)
    assert cache.last_snapshot_stats["full"]
    assert cache.tensor_refresh(s2.nodes, _rnames(cache), "cpu") is None


def test_session_mutations_never_leak_into_next_snapshot():
    """Pipelines are session-only and discarded statements roll back —
    neither may survive into the next cycle through a reused clone."""
    cache = _world()
    conf = parse_scheduler_conf(None)
    ssn = open_session(cache, conf.tiers, [], device="cpu")
    job = next(j for j in ssn.jobs.values()
               if j.task_status_index.get(TaskStatus.PENDING))
    task = next(iter(job.task_status_index[TaskStatus.PENDING].values()))
    node = next(iter(ssn.nodes.values()))
    stmt = ssn.statement()
    stmt.pipeline(task, node.name)           # session-only, kept open
    other = next(j for j in ssn.jobs.values()
                 if j.uid != job.uid
                 and j.task_status_index.get(TaskStatus.PENDING))
    t2 = next(iter(other.task_status_index[TaskStatus.PENDING].values()))
    stmt2 = ssn.statement()
    stmt2.allocate(t2, node)
    stmt2.discard()                           # rolled back entirely
    close_session(ssn)

    snap = cache.snapshot()
    got = snap.jobs[job.uid].tasks[task.uid]
    assert got.status == TaskStatus.PENDING and not got.node_name
    got2 = snap.jobs[other.uid].tasks[t2.uid]
    assert got2.status == TaskStatus.PENDING and not got2.node_name
    assert snap.nodes[node.name].pipelined.is_empty()
    assert not snap.nodes[node.name].tasks
    _assert_snapshot_matches_live(cache, snap, _rnames(cache))


def _bind_one(cache):
    job = next(j for j in cache.jobs.values()
               if j.task_status_index.get(TaskStatus.PENDING))
    task = next(iter(job.task_status_index[TaskStatus.PENDING].values()))
    t = task.clone()
    t.node_name = next(n for n in cache.nodes.values()
                       if task.resreq.less_equal(n.idle)).name
    cache.bind(t)
    return job, task, t.node_name


def test_tensor_delta_uses_scatter_not_rebuild():
    """A small dirty set takes the row-scatter path; a bulk mutation falls
    back to a full rebuild (the observable fallback)."""
    metrics.reset_local()
    cache = _world(nodes=16)
    snap = cache.snapshot()
    rn = _rnames(cache)
    tc = cache.tensor_refresh(snap.nodes, rn, "cpu", snap.snap_epoch)
    assert tc.last_refresh["full"]            # cold: full build
    _bind_one(cache)                          # a one-node delta
    snap = cache.snapshot()
    tc2 = cache.tensor_refresh(snap.nodes, rn, "cpu", snap.snap_epoch)
    assert tc2 is tc and not tc.last_refresh["full"]
    assert tc.last_refresh["rows"] == 1
    _assert_tensor_rows_match(cache, snap, rn)
    for name in list(cache.nodes)[:9]:        # 9 of 16 rows: past 0.5
        cache.mark_node_dirty(name)
    snap = cache.snapshot()
    cache.tensor_refresh(snap.nodes, rn, "cpu", snap.snap_epoch)
    assert tc.last_refresh["full"]
    assert metrics.local_counters()[("snapshot_full_rebuilds",
                                     "tensor")] == 2
    # a stale session's delta is refused, and the caller builds fresh
    assert cache.tensor_refresh(snap.nodes, rn, "cpu",
                                snap.snap_epoch - 1) is None


def test_invalidate_device_state_retires_the_rows():
    """invalidate_device_state drops the persistent tensors and moves the
    epoch: a session opened before it gets a fresh build, and the next
    session's refresh rebuilds every row."""
    cache = _world()
    rn = _rnames(cache)
    ssn = open_session(cache, parse_scheduler_conf(None).tiers, [],
                       device="cpu")
    assert ssn.snapshot_node_tensors(rn) is not None
    cache.invalidate_device_state()
    assert cache.tensor_cache is None
    assert ssn.snapshot_node_tensors(rn) is None
    close_session(ssn)
    snap = cache.snapshot()
    tc = cache.tensor_refresh(snap.nodes, rn, "cpu", snap.snap_epoch)
    assert tc.last_refresh["full"]


def test_holes_take_stable_rows_and_refill_lowest_first():
    """A removed node leaves a zeroed hole; the next added node takes the
    lowest hole; more arrivals than holes rebuild in snapshot order."""
    cache = _world(nodes=12, tasks=0, jobs=0)
    rn = _rnames(cache)
    snap = cache.snapshot()
    tc = cache.tensor_refresh(snap.nodes, rn, "cpu", snap.snap_epoch)
    for name in ("node-00007", "node-00003"):
        cache.remove_node(name)
    snap = cache.snapshot()
    cache.tensor_refresh(snap.nodes, rn, "cpu", snap.snap_epoch)
    assert tc.names[3] == tc.names[7] == ""
    assert tc.last_refresh == {"full": False, "rows": 2,
                               "host_s": tc.last_refresh["host_s"]}
    _assert_tensor_rows_match(cache, snap, rn)
    alloc = Resource(8000, 32 * GI)
    alloc.max_task_num = 20
    cache.add_node(NodeInfo(name="zz-a", allocatable=alloc))
    snap = cache.snapshot()
    cache.tensor_refresh(snap.nodes, rn, "cpu", snap.snap_epoch)
    assert tc.index["zz-a"] == 3 and tc.names[7] == ""
    for name in ("zz-b", "zz-c"):             # two arrivals, one hole
        cache.add_node(NodeInfo(name=name, allocatable=alloc))
    snap = cache.snapshot()
    cache.tensor_refresh(snap.nodes, rn, "cpu", snap.snap_epoch)
    assert tc.last_refresh["full"]
    assert tc.names == list(snap.nodes)


def test_pinned_epoch_keeps_the_rows_before_a_scatter():
    """The scatter publishes new tensors (index_copy out of place), and
    the host mirror is copied on upload: a pinned view keeps reading the
    epoch it pinned while the live rows move on."""
    cache = _world(nodes=8)
    rn = _rnames(cache)
    snap = cache.snapshot()
    tc = cache.tensor_refresh(snap.nodes, rn, "cpu", snap.snap_epoch)
    view = tc.pin_epoch()
    idle_before = view.idle.clone()
    _, _, host = _bind_one(cache)
    snap = cache.snapshot()
    cache.tensor_refresh(snap.nodes, rn, "cpu", snap.snap_epoch)
    row = tc.index[host]
    assert tc.epoch == view.epoch + 1 and tc.last_refresh["rows"] == 1
    assert torch.equal(view.idle, idle_before)
    assert not torch.equal(tc.idle[row], view.idle[row])
    assert tc.live_pins == 1
    tc.retire_epoch(view)
    tc.retire_epoch(view)                     # idempotent
    assert tc.live_pins == 0 and view.retired


def test_preempt_fast_replay_helpers_set_touched_witness():
    """The preempt/reclaim batched replay mutates session node clones
    directly (_fast_pipeline/_fast_evict and their undos): it must set the
    _touched witness, or session-only pipeline state would leak into the
    next cycle's snapshot through a reused clone."""
    from volcano_tpu_torch.actions.evict_tpu import (_fast_evict,
                                                     _fast_pipeline,
                                                     _fast_unevict,
                                                     _fast_unpipeline)
    cache = _world()
    job, victim, host = _bind_one(cache)
    cache.update_task_status(victim, TaskStatus.RUNNING)
    cache.snapshot()                      # prime the reuse cache

    conf = parse_scheduler_conf(None)
    ssn = open_session(cache, conf.tiers, [], device="cpu")
    other = next(j for j in ssn.jobs.values()
                 if j.uid != job.uid
                 and j.task_status_index.get(TaskStatus.PENDING))
    preemptor = next(iter(
        other.task_status_index[TaskStatus.PENDING].values()))
    vt = ssn.jobs[job.uid].tasks[victim.uid]
    own = _fast_evict(ssn, vt)
    _fast_pipeline(ssn, preemptor, host)
    # roll half of it back too — undos are mutations of their own
    _fast_unpipeline(ssn, preemptor)
    _fast_pipeline(ssn, preemptor, host)
    _fast_unevict(ssn, own)
    close_session(ssn)

    snap = cache.snapshot()
    _assert_snapshot_matches_live(cache, snap, _rnames(cache))
    assert snap.nodes[host].pipelined.is_empty()
    assert victim.uid not in {u for u, t_ in snap.jobs[job.uid].tasks.items()
                              if t_.status == TaskStatus.RELEASING}


def test_fused_replay_sets_touched_witness():
    """The fused batched replay writes node aggregates directly: the
    session's nodes are touched, so a second solve in the session builds
    fresh rows instead of reading the snapshot-time persistent rows."""
    cache = _world()
    conf = parse_scheduler_conf(CYCLE_CONF.format(allocate="allocate-tpu"))
    ssn = open_session(cache, conf.tiers, conf.configurations,
                       device="cpu")
    rn = _rnames(cache)
    assert ssn.snapshot_node_tensors(rn) is not None
    from volcano_tpu_torch.framework import get_action
    get_action("allocate-tpu").execute(ssn)
    assert any(n._touched for n in ssn.nodes.values())
    assert ssn.snapshot_node_tensors(rn) is None
    close_session(ssn)


def test_refresh_error_propagates():
    """No quiet fallback: an error raised by the persistent refresh (a CUDA
    error on the card) fails the allocate action instead of rebuilding."""
    cache = _world()
    sched = Scheduler(cache, CYCLE_CONF.format(allocate="allocate-tpu"),
                      device="cpu")

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access")

    cache.tensor_refresh = broken
    errors = sched.run_once()
    assert [name for name, _ in errors] == ["allocate-tpu"]
    assert "illegal memory access" in str(errors[0][1])


def test_refresh_error_drops_the_persistent_tensors(monkeypatch):
    """A refresh applies in full or not at all: when it raises half way,
    the cache drops its persistent tensors, so no row written on the host
    and never scattered survives, and the next refresh rebuilds them."""
    from volcano_tpu_torch.cache.snapshot import PersistentNodeTensors
    cache = _world(nodes=16)
    rn = _rnames(cache)
    snap = cache.snapshot()
    cache.tensor_refresh(snap.nodes, rn, "cpu", snap.snap_epoch)
    _bind_one(cache)
    snap = cache.snapshot()
    real = PersistentNodeTensors.refresh

    def broken(self, nodes, changed):
        self.host["idle"][0] = -1.0           # a host row, never scattered
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(PersistentNodeTensors, "refresh", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        cache.tensor_refresh(snap.nodes, rn, "cpu", snap.snap_epoch)
    assert cache.tensor_cache is None
    monkeypatch.setattr(PersistentNodeTensors, "refresh", real)
    snap = cache.snapshot()
    tc = cache.tensor_refresh(snap.nodes, rn, "cpu", snap.snap_epoch)
    assert tc.last_refresh["full"]
    _assert_tensor_rows_match(cache, snap, rn)


def test_refresh_skips_a_node_changed_then_removed():
    """A node dirty-marked by a snapshot whose cycle ran no solve, then
    removed before the next refresh: its row becomes a hole, the node that
    joins takes it, and the scatter writes both on the device (the JAX
    package raises KeyError here, ROADMAP §3)."""
    cache = _world(nodes=16)
    rn = _rnames(cache)
    snap = cache.snapshot()
    cache.tensor_refresh(snap.nodes, rn, "cpu", snap.snap_epoch)
    _, _, gone = _bind_one(cache)
    cache.snapshot()                          # marks gone's row, no refresh
    for job in cache.jobs.values():
        for task in list(job.tasks.values()):
            if task.node_name == gone:
                cache.delete_task(task)
    cache.remove_node(gone)
    row = cache.tensor_cache.index[gone]
    joined = next(iter(cache.nodes.values())).clone()
    joined.name = "zz-new"
    for task in list(joined.tasks.values()):
        joined.remove_task(task)
    cache.add_node(joined)
    snap = cache.snapshot()
    tc = cache.tensor_refresh(snap.nodes, rn, "cpu", snap.snap_epoch)
    assert not tc.last_refresh["full"]
    assert tc.index["zz-new"] == row and gone not in tc.index
    _assert_tensor_rows_match(cache, snap, rn)


def test_run_once_noop_pipeline_skips_snapshot():
    """A cycle whose pipeline has no action must not pay the snapshot
    and open_session at all."""
    cache = _world()
    calls = []
    orig = cache.snapshot
    cache.snapshot = lambda: (calls.append(1), orig())[1]
    sched = Scheduler(cache, conf_text='actions: ""\n', device="cpu")
    assert sched.conf.actions == []
    assert sched.run_once() == []
    assert calls == [], "no-op cycle still snapshotted the cluster"
    # sanity: a real pipeline still opens a session
    Scheduler(cache, CYCLE_CONF.format(allocate="allocate"),
              device="cpu").run_once()
    assert calls


def test_hole_rows_mask_and_score_match_jax():
    """A hole column of the persistent tensors gets the JAX package's
    feasibility mask and static score (the inert hole node: unschedulable,
    untainted), on a world with tainted nodes and an open hole."""
    import volcano_tpu.actions  # noqa: F401  (registers)
    import volcano_tpu.plugins  # noqa: F401
    from volcano_tpu import framework as jax_fw
    from volcano_tpu.api import NodeInfo as JaxNode
    from volcano_tpu.cache import snapshot as jax_snapshot
    from volcano_tpu.cache.synthetic import make_cluster as jax_cluster
    from volcano_tpu.cache.synthetic import make_jobs as jax_jobs
    from volcano_tpu_torch.cache import cache_from_world
    from volcano_tpu_torch.cache.snapshot import (assemble_feasibility,
                                                  assemble_static_score)
    from torch_parity import _jax_cache, _queues, world_from_cache

    taint = [{"key": "spot", "value": "true", "effect": "PreferNoSchedule"}]
    nodes = [n if n.name not in ("node-00002", "node-00005") else
             JaxNode(name=n.name, allocatable=n.allocatable, taints=taint)
             for n in jax_cluster(10, cpu_milli=8000, mem=32 * GI, pods=20)]
    jax = _jax_cache(nodes, jax_jobs(12, 3, ["q1", "q2"], seed=4),
                     _queues(2, 1))
    port = cache_from_world(world_from_cache(jax))
    conf_p = parse_scheduler_conf(DEPLOYED_CONF)
    conf_j = jax_fw.parse_scheduler_conf(DEPLOYED_CONF)
    ssn_p = open_session(port, conf_p.tiers, conf_p.configurations,
                         device="cpu")
    ssn_j = jax_fw.open_session(jax, conf_j.tiers, conf_j.configurations)
    try:
        rn_p = discover_resource_names(list(ssn_p.nodes.values()),
                                       _all_tasks(ssn_p.jobs))
        rn_j = jax_snapshot.discover_resource_names(
            list(ssn_j.nodes.values()), _all_tasks(ssn_j.jobs))
        # a first refresh builds every row, then a removal opens a hole
        assert ssn_p.snapshot_node_tensors(rn_p).last_refresh["full"]
        assert ssn_j.snapshot_node_tensors(rn_j).last_refresh["full"]
    finally:
        close_session(ssn_p)
        jax_fw.close_session(ssn_j)
    for cache in (port, jax):
        cache.remove_node("node-00003")      # an empty node
    ssn_p = open_session(port, conf_p.tiers, conf_p.configurations,
                         device="cpu")
    ssn_j = jax_fw.open_session(jax, conf_j.tiers, conf_j.configurations)
    try:
        tc_p = ssn_p.snapshot_node_tensors(rn_p)
        tc_j = ssn_j.snapshot_node_tensors(rn_j)
        assert tc_p.names == tc_j.names and tc_p.names[3] == ""
        assert [n.name for n in node_infos_for(ssn_p, tc_p)] \
            == [n.name for n in jax_snapshot.node_infos_for(ssn_j, tc_j)]
        tasks_p = sorted(_all_tasks(ssn_p.jobs), key=lambda t: t.uid)
        tasks_j = sorted(_all_tasks(ssn_j.jobs), key=lambda t: t.uid)
        mask = assemble_feasibility(ssn_p, tasks_p, tc_p)
        static = assemble_static_score(ssn_p, tasks_p, tc_p)
        assert mask is not None and not mask[:, 3].any()
        assert static is not None
        np.testing.assert_array_equal(
            mask, jax_snapshot.assemble_feasibility(ssn_j, tasks_j, tc_j))
        np.testing.assert_array_equal(
            static, jax_snapshot.assemble_static_score(ssn_j, tasks_j, tc_j))
    finally:
        close_session(ssn_p)
        jax_fw.close_session(ssn_j)


# -- the hole worlds, live against the JAX package --------------------------

@pytest.fixture(scope="module")
def hole_reference(tmp_path_factory):
    return jax_reference("incremental", HOLE_WORLDS + DRAIN_WORLDS,
                         tmp_path_factory.mktemp("incremental") / "ref.pkl")


@pytest.mark.parametrize("name", HOLE_WORLDS)
def test_hole_world_matches_jax(hole_reference, name):
    """Every bind lands on the JAX package's node, in order, and every
    solve takes the JAX package's node-tensor path (persistent or fresh;
    full rebuild or scatter, and its rows). ``hole:on`` is the JAX
    default: b-job-00001-0 takes zz-new, which filled node-00004's row."""
    got = hole_world_run(True, name)
    want = hole_reference[name]
    assert got == want
    assert not got["failures"]
    binds = dict(got["binds"])
    if name == "hole:on":
        assert binds["default/b-job-00001-0"] == "zz-new"
        assert [p[0] for p in got["paths"]] == ["persistent"] * 3
    if name.endswith(":off"):
        assert {p[0] for p in got["paths"]} == {"fresh"}


def test_drain_world_mends_the_jax_refresh_fault(hole_reference):
    """The drain world with the switch on: the JAX package's refresh meets
    a node changed and then removed, raises KeyError half way, builds
    fresh for that solve and keeps the half-applied rows, so zz-new's
    device row still holds the drained node's tasks and cycle 5's gang,
    which fits, stays pending. The port refreshes through it: its binds,
    paths and rows equal the JAX package's with that fault mended
    (tests/torch_parity.py::_mend_jax_refresh)."""
    got = hole_world_run(True, "drain:on")
    assert got == hole_reference["drain:mended"]
    assert not got["failures"] and got["stale_rows"] == []
    assert got["paths"][3] == ["persistent", False, 3]
    gang = [t for t, _ in got["binds"] if t.startswith("default/d-")]
    assert len(gang) == 11
    jax_on = hole_reference["drain:on"]
    assert jax_on["paths"][3] == ["fresh", False, 16]
    assert jax_on["stale_rows"] == ["zz-new"]
    assert not [t for t, _ in jax_on["binds"] if t.startswith("default/d-")]


# -- the shadow drift verifier ----------------------------------------------

def make_world(n_nodes=4, n_jobs=2, tasks_per_job=3):
    cache = SchedulerCache(binder=SequenceBinder(),
                           evictor=SequenceEvictor())
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


def _snapshotted_world():
    cache = make_world()
    sched = Scheduler(cache, device="cpu", schedule_period=0.0,
                      drift_verify_every=0)
    for _ in range(5):
        sched.run_once()
    assert all(t.status == TaskStatus.BOUND for t in _all_tasks(cache.jobs))
    cache.snapshot()           # absorb: dirty sets clear, clones cached
    return cache


class TestDriftSelfHealing:
    def test_clean_state_verifies_clean(self):
        cache = _snapshotted_world()
        stats = cache.verify_state_integrity()
        assert stats["drift_total"] == 0 and not stats["repaired"]

    def test_node_drift_detected_and_repaired(self):
        """A live-node mutation that misses every dirty mark is detected
        and repaired by forcing the full-rebuild path."""
        metrics.reset_local()
        cache = _snapshotted_world()
        node = cache.nodes["n0"]
        node.idle.sub(Resource(500, GI))           # no dirty mark, no witness
        node._touched = False
        stats = cache.verify_state_integrity()
        assert stats["drift"].get("node") == ["n0"], f"{stats}"
        assert stats["repaired"] and cache._dirty_all
        assert metrics.local_counters().get(("state_drift", "node")) == 1
        # the repair makes the NEXT snapshot serve live truth again
        snap = cache.snapshot()
        assert snap.nodes["n0"].idle == node.idle

    def test_job_drift_detected(self):
        cache = _snapshotted_world()
        job = cache.jobs["j0"]
        task = next(iter(job.tasks.values()))
        task.status = TaskStatus.RUNNING           # bypasses every funnel
        job._touched = False
        stats = cache.verify_state_integrity()
        assert "j0" in stats["drift"].get("job", []), f"{stats}"

    def test_tensor_row_drift_detected_and_repaired(self):
        metrics.reset_local()
        cache = _snapshotted_world()
        snap = cache.snapshot()
        tc = cache.tensor_refresh(snap.nodes, _rnames(cache), "cpu",
                                  snap.snap_epoch)
        assert tc is not None
        tc.host["idle"][0, 0] += 7.0               # corrupt one row
        stats = cache.verify_state_integrity()
        assert stats["drift"].get("tensor"), f"{stats}"
        assert cache.tensor_cache is None, \
            "tensor drift must drop the persistent cache (full rebuild)"
        assert metrics.local_counters().get(("state_drift", "tensor")) == 1

    def test_scheduler_drives_cadence_off_cycle(self):
        """With drift_verify_every=N the shell detects an injected
        corruption within N cycles, after the timed window."""
        metrics.reset_local()
        cache = make_world(n_jobs=4)
        sched = Scheduler(cache, device="cpu", schedule_period=0.0,
                          drift_verify_every=3)
        for _ in range(4):
            sched.run_once()
        node = cache.nodes["n1"]
        node.used.add(Resource(123, GI))           # silent corruption
        node._touched = False
        cache._dirty_nodes.discard("n1")
        for _ in range(3):
            sched.run_once()
        assert metrics.local_counters().get(("state_drift", "node"), 0) >= 1
        # repaired: the live cache now snapshots its (corrupted-but-true)
        # state, so a fresh verify is clean again
        assert cache.verify_state_integrity()["drift_total"] == 0

    def test_dirty_marked_changes_are_not_drift(self):
        cache = _snapshotted_world()
        node = cache.nodes["n0"]
        node.idle.sub(Resource(500, GI))
        cache.mark_node_dirty("n0")                # properly marked
        stats = cache.verify_state_integrity()
        assert stats["drift_total"] == 0

    def test_verifier_fault_is_isolated(self, monkeypatch):
        """A verifier that raises costs no cycle: counted as a
        drift-verify failure, the cycle still returns clean."""
        metrics.reset_local()
        cache = make_world()
        sched = Scheduler(cache, device="cpu", schedule_period=0.0,
                          drift_verify_every=1)

        def broken():
            raise RuntimeError("verifier bug")

        monkeypatch.setattr(cache, "verify_state_integrity", broken)
        assert sched.run_once() == []
        assert metrics.local_counters()[("action_failures",
                                         "drift-verify")] == 1

    def test_env_sets_the_cadence(self, monkeypatch):
        monkeypatch.setenv("VOLCANO_TPU_DRIFT_VERIFY_EVERY", "5")
        assert Scheduler(make_world(), device="cpu").drift_verify_every == 5
        monkeypatch.delenv("VOLCANO_TPU_DRIFT_VERIFY_EVERY")
        assert Scheduler(make_world(), device="cpu").drift_verify_every == 64


# -- sim determinism: incremental on vs off ---------------------------------

def test_sim_decisions_identical_incremental_on_off(monkeypatch):
    """The ``steady`` scenario's decision plane is byte-identical with the
    incremental snapshot and persistent tensors on (the default) and off:
    clone-on-dirty never changes a decision there."""
    from volcano_tpu_torch.sim import (SimRunner, deterministic_json,
                                       make_scenario)
    trace = make_scenario("steady", seed=3)

    def plane():
        runner = SimRunner(trace, seed=3, scenario="steady", device="cpu")
        return deterministic_json(runner.run()), runner.binder.sequence

    monkeypatch.setenv(OFF, "1")
    on = plane()
    monkeypatch.setenv(OFF, "0")
    off = plane()
    assert on == off


def test_sim_restart_starts_a_cold_tensor_cache():
    """A simulated kill and restart drops every cached clone and the
    persistent node tensors, as a process death does: the first cycle
    after it clones everything and rebuilds every row."""
    from volcano_tpu_torch.sim import SimRunner, make_scenario
    runner = SimRunner(make_scenario("smoke", seed=0),
                       conf_text=DEPLOYED_CONF, seed=0, kill_cycles=[5],
                       device="cpu")
    seen = []
    real = runner._crash_restart

    def crash_restart(*args, **kwargs):
        out = real(*args, **kwargs)
        cache = runner.cache
        seen.append((cache.tensor_cache, cache._dirty_all,
                     set(cache._tensor_dirty)))
        return out

    runner._crash_restart = crash_restart
    report = runner.run()
    assert report["restarts"] == 1 and report["action_failures"] == 0
    assert seen == [(None, True, set())]
