"""The port's pipelined cycle and fast admit on the CPU: the port's versions
of tests/test_pipelined.py (the epoch pair, the staged speculative snapshot,
the conflict check at the commit boundary, equivalence with the serial
shell, fast admit, the crash window between speculative dispatch and
commit), with the drive worlds held live against the JAX package
(tests/torch_parity.py::pipelined_drive, computed in a child process), B7's
plain version against the JAX package's ``_packed_decoder``, the
speculative dispatch against the serial solve, and the engine names
``tpu-scan`` and ``tpu-pallas``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from volcano_tpu_torch import Scheduler, metrics
from volcano_tpu_torch.actions import allocate as alloc
from volcano_tpu_torch.api import (JobInfo, NodeInfo, PodGroup,
                                   PodGroupPhase, QueueInfo, Resource,
                                   ResourceNames, TaskInfo, TaskStatus)
from volcano_tpu_torch.cache import SchedulerCache
from volcano_tpu_torch.cache.journal import IntentJournal
from volcano_tpu_torch.cache.snapshot import PersistentNodeTensors
from volcano_tpu_torch.cache.synthetic import baseline_config
from volcano_tpu_torch.chaos import SimKill
from volcano_tpu_torch.framework import (abandon_session, close_session,
                                         open_session)
from volcano_tpu_torch.ops.place import (F_KEEP, F_PIPE, F_PLACE, F_READY,
                                         decode_packed_plain, fetch_packed,
                                         place, place_dispatch,
                                         unpack_placement)

from torch_parity import (PIPELINED_CONF as CONF,  # noqa: F401
                          PIPELINED_WORLDS, jax_reference, pipelined_drive,
                          port_gc_windows)

GI = 1 << 30
CPU = torch.device("cpu")


def mkjob(uid: str, ts: float, cpu: int = 1000, tasks: int = 2,
          queue: str = "q1", **task_kw) -> JobInfo:
    pg = PodGroup(name=uid, queue=queue, min_member=tasks,
                  phase=PodGroupPhase.PENDING)
    job = JobInfo(uid=uid, name=uid, queue=queue, min_available=tasks,
                  podgroup=pg, creation_timestamp=ts)
    for t in range(tasks):
        job.add_task_info(TaskInfo(
            uid=f"{uid}-{t}", name=f"{uid}-{t}", job=uid,
            resreq=Resource(cpu, GI), creation_timestamp=ts + t * 1e-6,
            **task_kw))
    return job


def build_cache(n_nodes: int = 4, node_cpu: int = 2000, n_jobs: int = 30,
                cpu: int = 1000, journal: IntentJournal = None
                ) -> SchedulerCache:
    cache = SchedulerCache(default_queue=None, journal=journal)
    cache.add_queue(QueueInfo(name="q1", weight=1))
    for i in range(n_nodes):
        alloc_r = Resource(node_cpu, 64 * GI)
        alloc_r.max_task_num = 100
        cache.add_node(NodeInfo(name=f"n{i}", allocatable=alloc_r))
    for j in range(n_jobs):
        cache.add_job(mkjob(f"j{j}", float(j), cpu))
    return cache


def state_plane(cache) -> list:
    return sorted((t.uid, t.node_name, str(t.status).rsplit(".", 1)[-1])
                  for j in cache.jobs.values() for t in j.tasks.values())


def windows() -> list:
    """The GC suspension windows port sessions hold open."""
    from volcano_tpu_torch.framework import framework as fw
    return list(fw._GC_OPEN_WINDOWS)


def scheduler(cache, **kw) -> Scheduler:
    return Scheduler(cache, conf_text=CONF, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_drives(tmp_path_factory):
    names = [f"{w}:{m}" for w in PIPELINED_WORLDS
             for m in ("serial", "pipelined")]
    return jax_reference("pipelined", names,
                         tmp_path_factory.mktemp("pipelined") / "ref.pkl")


# ---------------------------------------------------------------------------
# the epoch pair
# ---------------------------------------------------------------------------

def test_epoch_pair_pin_survives_scatter():
    rnames = ResourceNames(["cpu", "memory"])
    alloc_r = Resource(4000, 8 * GI)
    alloc_r.max_task_num = 10
    nodes = {f"n{i}": NodeInfo(name=f"n{i}", allocatable=alloc_r)
             for i in range(3)}
    tc = PersistentNodeTensors(rnames, CPU)
    tc.full_build(nodes)
    view = tc.pin_epoch()
    assert tc.live_pins == 1
    pinned_idle = view.idle.clone()
    row = tc.index["n1"]
    nodes["n1"].idle.sub(Resource(1000, GI))
    epoch_before = tc.epoch
    tc.refresh(nodes, {"n1"})
    assert tc.epoch > epoch_before
    # the scatter published new tensors: the pinned epoch kept its own
    assert torch.equal(view.idle, pinned_idle)
    assert not torch.equal(tc.idle, pinned_idle)
    assert view.host["idle"][row][0] == pinned_idle[row][0].item()
    assert tc.host["idle"][row][0] != pinned_idle[row][0].item()
    tc.retire_epoch(view)
    tc.retire_epoch(view)
    assert tc.live_pins == 0


def test_epoch_pair_prewarm_is_cheap_noop_when_empty():
    tc = PersistentNodeTensors(ResourceNames(["cpu", "memory"]), CPU)
    tc.prewarm_epoch_pair()
    assert tc.live_pins == 0


def test_epoch_pair_prewarm_pins_and_retires():
    rnames = ResourceNames(["cpu", "memory"])
    nodes = {"n0": NodeInfo(name="n0", allocatable=Resource(4000, GI))}
    tc = PersistentNodeTensors(rnames, CPU)
    tc.full_build(nodes)
    tc.prewarm_epoch_pair()
    assert tc.live_pins == 0 and tc._device is not None


# ---------------------------------------------------------------------------
# the staged speculative snapshot
# ---------------------------------------------------------------------------

def test_speculative_snapshot_stages_without_consuming():
    cache = build_cache(n_jobs=3)
    cache.snapshot()
    cache.add_job(mkjob("late", 99.0))
    dirty_before = set(cache._dirty_jobs)
    epoch_before = cache._snap_epoch
    ci, staged = cache.speculative_snapshot()
    assert cache._snap_epoch == epoch_before
    assert staged["dirty_jobs"] == frozenset(dirty_before)
    assert not cache._dirty_jobs
    assert "late" in ci.jobs
    # the re-cloned job's witness reset waits for adopt
    assert "late" in staged["touched_jobs"]
    assert cache.adopt_speculative_snapshot(staged)
    assert cache._snap_epoch == epoch_before + 1
    assert ci.snap_epoch == cache._snap_epoch
    assert cache._snap_jobs["late"] is ci.jobs["late"]


def test_speculation_delta_sees_remutation_of_stage_dirty_key():
    cache = build_cache(n_jobs=3)
    cache.snapshot()
    cache.add_job(mkjob("late", 99.0))
    ci, staged = cache.speculative_snapshot()
    cache.mark_job_dirty("late")
    delta = cache.speculation_delta(staged)
    assert "late" in delta["jobs"]
    assert not delta["epoch_moved"]
    assert not cache.adopt_speculative_snapshot(staged)
    cache.discard_speculative_snapshot(staged)
    assert "late" in cache._dirty_jobs


def test_speculation_delta_reports_a_mark_all_dirty_as_an_epoch_move():
    """The drift repair's mark_all_dirty invalidates the staged clones
    wholesale: the delta reports it as the epoch moving."""
    cache = build_cache(n_jobs=3)
    cache.snapshot()
    _, staged = cache.speculative_snapshot()
    assert not cache.speculation_delta(staged)["epoch_moved"]
    cache.mark_all_dirty()
    assert cache.speculation_delta(staged)["epoch_moved"]
    assert not cache.adopt_speculative_snapshot(staged)


def test_real_snapshot_reabsorbs_orphaned_speculation_dirt():
    cache = build_cache(n_jobs=2)
    cache.snapshot()
    cache.add_job(mkjob("late", 99.0))
    _, staged = cache.speculative_snapshot()
    ci = cache.snapshot()
    assert "late" in ci.jobs
    assert cache._spec_dirt is None
    assert not cache.adopt_speculative_snapshot(staged)
    cache.discard_speculative_snapshot(staged)
    assert not cache._dirty_jobs


def test_speculative_session_pins_an_epoch_and_consumes_nothing():
    """A speculative session's refresh pins its epoch and leaves the
    tensor-dirty set for the next real refresh; abandoning it retires the
    pin and releases its GC window."""
    cache = build_cache(n_jobs=4)
    sched = scheduler(cache)
    assert sched.run_once() == []
    cache.add_job(mkjob("late", 99.0))
    ssn = open_session(cache, sched.conf.tiers, sched.conf.configurations,
                       device="cpu", speculative=True)
    assert ssn.speculative and ssn.spec_basis is not None
    tensor_dirty = set(cache._tensor_dirty)
    rnames = ResourceNames(["cpu", "memory"])
    view = ssn.snapshot_node_tensors(rnames)
    assert view is not None and ssn._pinned_epoch is view
    assert cache.tensor_cache.live_pins == 1
    assert cache._tensor_dirty == tensor_dirty
    abandon_session(ssn)
    assert cache.tensor_cache.live_pins == 0
    assert not windows()


# ---------------------------------------------------------------------------
# the pipelined shell against the serial one and the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", PIPELINED_WORLDS)
def test_pipelined_drive_matches_jax(jax_drives, world):
    """Each drive world, serial and pipelined, binds and decides as the
    JAX package's, cycle by cycle, with the same speculation verdicts."""
    for mode in ("serial", "pipelined"):
        name = f"{world}:{mode}"
        assert pipelined_drive(True, name) == jax_drives[name], name


def test_pipelined_hits_match_serial_on_standing_backlog():
    serial = pipelined_drive(True, "standing:serial")
    piped = pipelined_drive(True, "standing:pipelined")
    assert serial["planes"] == piped["planes"]
    outcomes = piped["outcomes"]
    assert outcomes[1:] == ["hit"] * (len(outcomes) - 1)


def test_pipelined_partial_matches_serial_under_acks_and_arrivals():
    serial = pipelined_drive(True, "acks:serial")
    piped = pipelined_drive(True, "acks:pipelined")
    assert serial["planes"] == piped["planes"]
    assert "partial" in piped["outcomes"]
    assert "conflict" not in piped["outcomes"]


def test_completions_commit_partial_and_match_serial():
    serial = pipelined_drive(True, "completions:serial")
    piped = pipelined_drive(True, "completions:pipelined")
    assert serial["planes"] == piped["planes"]
    outcomes = piped["outcomes"]
    assert "conflict" not in outcomes
    assert outcomes.count("partial") >= len(outcomes) - 2


def test_solution_touching_a_shrunk_node_is_refused():
    from types import SimpleNamespace
    mapped = SimpleNamespace(
        task_node=np.asarray([0, 2, -1], np.int32),
        node_t=SimpleNamespace(names=["n0", "n1", "n2"]))
    assert Scheduler._solution_touches(mapped, {"n2"})
    assert Scheduler._solution_touches(mapped, {"n0", "n9"})
    assert not Scheduler._solution_touches(mapped, {"n1"})
    assert not Scheduler._solution_touches(mapped, set())


def test_node_completion_shrunk_classifier():
    alloc_r = Resource(4000, 8 * GI)
    alloc_r.max_task_num = 10
    base = NodeInfo(name="n0", allocatable=alloc_r)

    def node(tasks):
        n = base.clone()
        for uid, status in tasks:
            t = TaskInfo(uid=uid, name=uid, job="j",
                         resreq=Resource(1000, GI), status=status)
            t.node_name = "n0"
            n.tasks[uid] = t
        return n

    a = node([("t0", TaskStatus.RUNNING), ("t1", TaskStatus.RUNNING)])
    shed = node([("t0", TaskStatus.RUNNING)])
    assert Scheduler._node_completion_shrunk(a, shed)
    assert not Scheduler._node_completion_shrunk(a, a)
    assert not Scheduler._node_completion_shrunk(shed, a)
    flipped = node([("t0", TaskStatus.RELEASING)])
    assert not Scheduler._node_completion_shrunk(a, flipped)


def test_speculation_counters_move():
    before = dict(metrics.speculation_counts())
    cache = build_cache()
    sched = scheduler(cache, pipelined=True)
    for _ in range(4):
        assert sched.run_once() == []
    after = metrics.speculation_counts()
    assert after.get("hit", 0) > before.get("hit", 0)


def test_pipelined_cycles_leave_no_pin_and_no_gc_window():
    """Every speculation ends in a commit or a discard that retires its
    epoch and releases its GC window; the last one is in flight."""
    cache = build_cache()
    sched = scheduler(cache, pipelined=True)
    for _ in range(5):
        assert sched.run_once() == []
    assert sched._spec is not None
    assert cache.tensor_cache.live_pins == 1
    assert len(windows()) == 1
    sched._discard_speculation("conflict")
    assert cache.tensor_cache.live_pins == 0
    assert not windows()


def test_modes_construct_and_read_the_environment(monkeypatch):
    cache = build_cache(n_jobs=1)
    assert scheduler(cache, pipelined=True).pipelined
    assert scheduler(cache, fast_admit=True).fast_admit_enabled
    assert cache.fast_admit_feed
    monkeypatch.setenv("VOLCANO_TPU_PIPELINED", "1")
    monkeypatch.setenv("VOLCANO_TPU_FAST_ADMIT", "1")
    sched = scheduler(build_cache(n_jobs=1))
    assert sched.pipelined and sched.fast_admit_enabled
    assert scheduler(cache, solve_deadline_s=0.5).solve_deadline_s == 0.5


# ---------------------------------------------------------------------------
# fast admit
# ---------------------------------------------------------------------------

def test_fast_admit_binds_through_the_journaled_funnel():
    journal = IntentJournal()
    records = []
    append = journal._append

    def record(rec, *a, **kw):
        records.append(dict(rec))
        return append(rec, *a, **kw)

    journal._append = record
    cache = build_cache(n_nodes=2, node_cpu=4000, n_jobs=0,
                        journal=journal)
    sched = scheduler(cache, fast_admit=True)
    cache.add_job(mkjob("fa0", 0.0, cpu=500))
    assert sched.fast_admit() == 2
    job = cache.jobs["fa0"]
    assert all(t.status == TaskStatus.BOUND for t in job.tasks.values())
    assert job.podgroup.phase == PodGroupPhase.INQUEUE
    binds = [r for r in records if r.get("kind") == "intent"
             and r.get("op") == "bind"]
    assert len(binds) == 2
    assert not journal.unacked()
    assert sched.run_once() == []
    assert sum(1 for t in job.tasks.values()
               if t.status == TaskStatus.BOUND) == 2


def test_fast_admit_declines_anything_not_provably_trivial():
    cache = build_cache(n_nodes=1, node_cpu=4000, n_jobs=0)
    sched = scheduler(cache, fast_admit=True)
    cache.add_job(mkjob("sel", 0.0, cpu=500, node_selector={"zone": "a"}))
    cache.add_job(mkjob("big", 1.0, cpu=3000))
    assert sched.fast_admit() == 0
    assert all(t.status == TaskStatus.PENDING
               for j in cache.jobs.values() for t in j.tasks.values())


def test_fast_admit_respects_pipelined_reservations():
    cache = build_cache(n_nodes=1, node_cpu=2000, n_jobs=0)
    sched = scheduler(cache, fast_admit=True)
    node = cache.nodes["n0"]
    node.pipelined.add(Resource(1500, GI))
    node._touched = True
    cache.mark_node_dirty("n0")
    cache.add_job(mkjob("fa0", 0.0, cpu=500))
    assert sched.fast_admit() == 0


def test_fast_admit_counters_move():
    before = dict(metrics.fast_admit_counts())
    cache = build_cache(n_nodes=2, node_cpu=4000, n_jobs=0)
    sched = scheduler(cache, fast_admit=True)
    cache.add_job(mkjob("fa0", 0.0, cpu=500))
    cache.add_job(mkjob("fa1", 1.0, cpu=500, tasks=3))
    assert sched.fast_admit() == 5
    after = metrics.fast_admit_counts()
    assert after["gangs"] - before["gangs"] == 2
    assert after["binds"] - before["binds"] == 5
    assert sched.fast_admit() == 0            # the feed was drained


# ---------------------------------------------------------------------------
# the crash window between speculative dispatch and commit
# ---------------------------------------------------------------------------

def test_simkill_mid_speculation_loses_only_speculative_state(jax_drives):
    journal = IntentJournal()
    cache = build_cache(journal=journal)
    sched = scheduler(cache, pipelined=True)
    assert sched.run_once() == []
    assert sched._spec is not None
    journal_len_before = len(journal)

    def boom(spec):
        raise SimKill("between dispatch and commit")

    sched.spec_fault_hook = boom
    with pytest.raises(SimKill):
        sched.run_once()
    # the dispatch journaled nothing, and the dead speculation holds no
    # GC window
    assert len(journal) == journal_len_before
    assert not journal.unacked()
    assert sched._spec is None
    assert not windows()
    plane_at_death = state_plane(cache)
    cache.mark_all_dirty()
    cache.tensor_cache = None
    cache._tensor_dirty = set()
    sched2 = scheduler(cache, pipelined=True)
    sched2.startup_reconcile()
    assert state_plane(cache) == plane_at_death
    for _ in range(3):
        assert sched2.run_once() == []
    serial = build_cache()
    s = scheduler(serial, pipelined=False)
    for _ in range(5):
        assert s.run_once() == []
    assert state_plane(serial) == state_plane(cache)
    # the JAX package's serial drive of the same world, five cycles in
    assert state_plane(cache) == jax_drives["standing:serial"]["planes"][4]


def test_pipelined_requires_standalone_topology():
    """With an elector the shell runs serial cycles: a speculation never
    crosses a leadership boundary."""
    cache = build_cache(n_jobs=4)
    sched = scheduler(cache, pipelined=True)

    class AlwaysLeader:
        leading = True
        fencing_epoch = 1
        identity = "r1"

        def step(self):
            return True

    sched.attach_elector(AlwaysLeader())
    before = dict(metrics.speculation_counts())
    for _ in range(3):
        assert sched.run_once() == []
    assert metrics.speculation_counts() == before
    assert sched._spec is None


# ---------------------------------------------------------------------------
# B7's plain version and the dispatch
# ---------------------------------------------------------------------------

def _wire_world(seed: int, T: int, J: int, multi: bool):
    """Seeded packed words and job indices: random flags (zero-flag rows
    included), jobs with no boundary row, and with ``multi`` jobs with
    several boundary rows."""
    rng = np.random.default_rng(seed)
    job_ix = np.sort(rng.integers(0, J, T)).astype(np.int32)
    node = rng.integers(0, 500, T)
    flags = rng.integers(0, 16, T)
    if not multi:
        # B1's shape: READY/KEEP only on each job's last row
        last = np.r_[job_ix[1:] != job_ix[:-1], True]
        flags = np.where(last, flags, flags & (F_PLACE | F_PIPE))
    flags[rng.random(T) < 0.2] = 0
    return ((node + 1) << 4 | flags).astype(np.int32), job_ix


WIRE_WORLDS = [(0, 64, 9, False), (1, 300, 40, True), (2, 1000, 7, True),
               (3, 5, 12, False), (4, 0, 3, False), (5, 2048, 2048, True)]


def _jax_decode(packed, job_ix, J):
    import jax.numpy as jnp
    from volcano_tpu.ops.pallas_place import _packed_decoder
    return np.asarray(_packed_decoder(J)(jnp.asarray(packed),
                                         jnp.asarray(job_ix)))


@pytest.mark.parametrize("world", WIRE_WORLDS,
                         ids=[f"seed{w[0]}-T{w[1]}-J{w[2]}"
                              for w in WIRE_WORLDS])
def test_decode_packed_plain_matches_jax(world):
    seed, T, J, multi = world
    packed, job_ix = _wire_world(seed, T, J, multi)
    got = decode_packed_plain(torch.from_numpy(packed),
                              torch.from_numpy(job_ix), J)
    assert got.dtype == torch.int32 and got.shape == (2 * T + 2 * J,)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_decode(packed, job_ix, J))


def test_decode_packed_plain_ors_several_boundary_rows():
    # job 0: its first row READY|KEEP, its last row neither; job 1 none
    packed = np.asarray([(3 << 4) | F_PLACE | F_READY | F_KEEP,
                         (4 << 4) | F_PLACE | F_PIPE,
                         (5 << 4) | F_PLACE], np.int32)
    job_ix = np.asarray([0, 0, 1], np.int32)
    got = decode_packed_plain(torch.from_numpy(packed),
                              torch.from_numpy(job_ix), 2).tolist()
    assert got == [2, 3, -1, 0, 1, 0, 1, 0, 1, 0]
    np.testing.assert_array_equal(got, _jax_decode(packed, job_ix, 2))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fetch_packed_equals_the_host_decode(seed):
    """On B1's wires the device decode and its fetch give what the serial
    path's host decode gives."""
    packed, job_ix = _wire_world(seed, 200, 30, False)
    J = 30
    wire = decode_packed_plain(torch.from_numpy(packed),
                               torch.from_numpy(job_ix), J)
    got = fetch_packed(wire, None, 200, J)
    want = unpack_placement(packed, job_ix, J)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_dispatch_equals_the_serial_solve():
    """The speculative dispatch's solution equals the serial solve's on the
    same session: the one assembly, B1's plain version and B7's."""
    cache = baseline_config("1k", seed=3)[0]
    sched = scheduler(cache)
    ssn = open_session(cache, sched.conf.tiers, sched.conf.configurations,
                       device="cpu", speculative=True)
    try:
        pending = alloc.dispatch_speculative_solve(ssn, "tpu-fused")
        assert pending is not None and pending.event is None
        got = alloc.finalize_speculative_dispatch(pending)
        inputs = alloc.placement_inputs(ssn, pending.ordered_jobs)
        want = alloc._fused_solution(inputs)
        assert [t.uid for t in got.tasks] == [t.uid for t in want.tasks]
        for f in ("task_node", "pipelined", "job_ready", "job_kept"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert np.asarray(got.job_kept).any()
        assert pending.done_at_fetch and pending.wait_s >= 0.0
    finally:
        abandon_session(ssn)


def test_place_dispatch_on_cpu_runs_the_plain_versions():
    cache = baseline_config("tiny")[0]
    sched = scheduler(cache)
    ssn = open_session(cache, sched.conf.tiers, sched.conf.configurations,
                       device="cpu")
    try:
        ordered = alloc._fixed_job_order(ssn)
        inp = alloc.placement_inputs(ssn, ordered)
        nt = inp.node_t
        args = (nt.idle, nt.future_idle, nt.used, nt.ntasks, nt.allocatable,
                nt.max_tasks, inp.req, inp.job_ix, inp.masked_static,
                inp.min_available, inp.base_ready, inp.base_pipelined,
                inp.weights)
        wire, event = place_dispatch(*args)
        assert event is None
        T, J = len(inp.tasks), len(inp.min_available)
        got = fetch_packed(wire, event, T, J)
        want = place(*args)
        for g, w in zip(got, want[:4]):
            np.testing.assert_array_equal(g, w)
    finally:
        close_session(ssn)


def test_dispatch_declines_what_it_does_not_serve():
    cache = baseline_config("tiny")[0]
    sched = scheduler(cache)
    ssn = open_session(cache, sched.conf.tiers, sched.conf.configurations,
                       device="cpu", speculative=True)
    try:
        assert alloc.dispatch_speculative_solve(ssn, "tpu-blocks") is None
        assert alloc.dispatch_speculative_solve(ssn, "tpu-sharded") is None
        ssn.stateful_predicates.add("x")
        assert alloc.dispatch_speculative_solve(ssn, "tpu-fused") is None
    finally:
        abandon_session(ssn)


def test_fetch_packed_refuses_a_wire_of_another_size():
    with pytest.raises(ValueError, match="wire"):
        fetch_packed(torch.zeros(7, dtype=torch.int32), None, 2, 1)


def test_decode_and_dispatch_refuse_the_card_path_without_a_card():
    """On a CPU tensor the CUDA wrapper raises instead of running the plain
    version, and a CUDA dispatch without a stream is refused."""
    from volcano_tpu_torch.ops.place import decode_packed_cuda
    with pytest.raises(ValueError, match="CUDA"):
        decode_packed_cuda(torch.zeros(3, dtype=torch.int32),
                           torch.zeros(3, dtype=torch.int32), 1)


# ---------------------------------------------------------------------------
# the engine names tpu-scan and tpu-pallas
# ---------------------------------------------------------------------------

ENGINE_CONF = CONF + """configurations:
- name: allocate-tpu
  arguments:
    engine: {engine}
"""


@pytest.mark.parametrize("engine", ["tpu-scan", "tpu-pallas"])
def test_scan_and_pallas_engines_bind_as_tpu_fused(engine):
    def binds(name):
        cache = baseline_config("1k", seed=3)[0]
        sched = Scheduler(cache, ENGINE_CONF.format(engine=name),
                          device="cpu")
        assert sched.run_once() == []
        return dict(cache.binder.binds)

    want = binds("tpu-fused")
    assert want
    assert binds(engine) == want


@pytest.mark.parametrize("engine", ["tpu-scan", "tpu-pallas"])
def test_scan_and_pallas_engines_speculate(engine):
    cache = build_cache()
    sched = Scheduler(cache, ENGINE_CONF.format(engine=engine),
                      device="cpu", pipelined=True)
    for _ in range(3):
        assert sched.run_once() == []
    assert sched.last_speculation == {"outcome": "hit", "promoted": True}
    assert sched._allocate_engine(
        [(n, a) for n, a in zip(sched.conf.actions, sched.actions)]) \
        == engine


def test_sharded_engine_stays_refused():
    with pytest.raises(ValueError, match="tpu-sharded"):
        Scheduler(build_cache(n_jobs=1),
                  ENGINE_CONF.format(engine="tpu-sharded"), device="cpu")
