"""Elastic gangs and the zone-anchor solve in the port, on the CPU: B6's
plain version (``ops/place.py::place_topo_plain``) against the JAX
package's ``place_scan_topo_packed`` to the bit, wire and final node state
(the JAX side computed in a child process at XLA optimization level 0,
tests/torch_parity.py); at weight 0 against B1's plain version and B1's
path; one speculative zone-anchor dispatch against the JAX dispatch; the
command funnel, the journal's control records, the membership helpers, the
elastic-gang plugin, grow-shrink and the elastic victim tier; and the
``topology-weight`` argument, which the port runs.

The kernel itself runs only on the card (test_torch_cuda.py).
"""

import threading

import numpy as np
import pytest
import torch

from volcano_tpu_torch import Scheduler, metrics
from volcano_tpu_torch.actions import allocate as alloc
from volcano_tpu_torch.actions import evict_tpu
from volcano_tpu_torch.api import (JobInfo, NodeInfo, PodGroup,
                                   PodGroupPhase, QueueInfo, Resource,
                                   TaskInfo, TaskStatus)
from volcano_tpu_torch.cache import SchedulerCache
from volcano_tpu_torch.cache.journal import IntentJournal
from volcano_tpu_torch.elastic_gang import (CommandFunnel,
                                            ELASTIC_DESIRED_ANNOTATION,
                                            SUSPEND_ANNOTATION,
                                            allocate_pending_filter,
                                            desired_members, grow_candidates,
                                            shrink_allowance,
                                            shrink_candidates)
from volcano_tpu_torch.framework import close_session, open_session
from volcano_tpu_torch.ops import place as place_mod
from volcano_tpu_torch.ops.place import (decode_packed_plain, place,
                                         place_plain, place_topo_cuda,
                                         place_topo_plain)

from torch_parity import (TOPO_CASES, TOPO_CONF, TOPO_WORLDS,  # noqa: F401
                          jax_reference, port_gc_windows, topo_args,
                          topo_dispatch, topo_small_world)

GI = 1 << 30


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_reference("topo", [f"{w}@{tw}" for w, tw in TOPO_CASES],
                         tmp_path_factory.mktemp("jax") / "topo.pkl")


def port_topo(world, topo_weight):
    args = topo_args(world, torch.device("cpu"))
    out = place_topo_plain(*args[:12], args[12], topo_weight)
    J = len(world["min_available"])
    wire = decode_packed_plain(out[0], torch.from_numpy(world["job_ix"]), J)
    return (wire.numpy(),) + tuple(t.numpy() for t in out[1:])


FIELDS = ("wire", "idle", "future_idle", "used", "ntasks")


# -- B6's plain version against the JAX package ------------------------------

@pytest.mark.parametrize("world,topo_weight", TOPO_CASES,
                         ids=[f"{w}@{tw}" for w, tw in TOPO_CASES])
def test_topo_plain_matches_jax(world, topo_weight, reference):
    got = port_topo(TOPO_WORLDS[world](), topo_weight)
    want = reference[f"{world}@{topo_weight}"]
    for name, g, w in zip(FIELDS, got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_small_worlds_are_the_elastic_tests_worlds(seed):
    """torch_parity's NumPy copy of test_elastic_gang.py's _small_world
    draws the same world."""
    from test_elastic_gang import _small_world
    nodes, tasks, jobs, alloc_, max_tasks, zone = _small_world(seed)
    w = topo_small_world(seed)
    pairs = [(w["idle"], nodes.idle), (w["future_idle"], nodes.future_idle),
             (w["used"], nodes.used), (w["ntasks"], nodes.ntasks),
             (w["allocatable"], alloc_), (w["max_tasks"], max_tasks),
             (w["zone_code"], zone), (w["req"], tasks.req),
             (w["job_ix"], tasks.job_ix), (w["feas"], tasks.feas),
             (w["static"], tasks.static_score),
             (w["min_available"], jobs.min_available)]
    for ours, theirs in pairs:
        np.testing.assert_array_equal(ours, np.asarray(theirs))


def test_topo_worlds_exercise_what_they_name(reference):
    """The anchor moves the picks: at weight 10 every gang of the wide-ties
    world stays in one zone and the picks pass node 64 (the CTA slices of
    the larger clusters), at 0 every gang straddles zones; the rollback
    world rolls gangs back; no task lands on a hole row; the unzoned world's
    first gang anchors nothing and a later one anchors on its second
    pick."""
    def nodes_of(world, tw):
        wire = reference[f"{world}@{tw}"][0]
        return wire[:len(TOPO_WORLDS[world]()["job_ix"])]

    wt = TOPO_WORLDS["wide-ties"]()
    zone = wt["zone_code"]
    for tw in (10.0, 0.0):
        tn = nodes_of("wide-ties", tw)
        zones = [len(set(zone[tn[wt["job_ix"] == j]])) for j in range(24)]
        assert all(z == 1 for z in zones) if tw else min(zones) > 1
    assert nodes_of("wide-ties", 10.0).max() > 64
    rb = TOPO_WORLDS["rollback"]()
    wire = reference["rollback@10.0"][0]
    T, J = len(rb["job_ix"]), len(rb["min_available"])
    kept = wire[2 * T + J:]
    assert not kept.all() and kept.any()
    holes = nodes_of("holes", 10.0)
    assert not np.isin(holes, [1, 4]).any() and (holes >= 0).all()
    uz = TOPO_WORLDS["unzoned-first"]()
    tz = uz["zone_code"][nodes_of("unzoned-first", 10.0)]
    first = uz["job_ix"] == 0
    assert (tz[first] == 0).any() and (tz[~first] != 0).any()


@pytest.mark.parametrize("world", list(TOPO_WORLDS))
def test_weight_zero_is_b1(world):
    """At weight 0 the zone-anchor loop gives B1's words and node state,
    and ``place`` takes B1's path: the JAX package dispatches place_scan
    there too."""
    w = TOPO_WORLDS[world]()
    args = topo_args(w, torch.device("cpu"))
    b1 = place_plain(*args[:12])
    b6 = place_topo_plain(*args[:12], args[12], 0.0)
    for g, x in zip(b6, b1):
        assert torch.equal(g, x)
    J = len(w["min_available"])
    zeros = np.zeros(J, np.int32)
    calls = []
    real = place_mod.place_topo_plain
    place_mod.place_topo_plain = lambda *a: calls.append(a) or real(*a)
    try:
        res0 = place(*args[:7], w["job_ix"], args[10], w["min_available"],
                     zeros, zeros, args[11], args[12], 0.0)
        assert not calls
        place(*args[:7], w["job_ix"], args[10], w["min_available"],
              zeros, zeros, args[11], args[12], 10.0)
        assert len(calls) == 1
    finally:
        place_mod.place_topo_plain = real
    assert torch.equal(res0.idle, b1[1])


def test_topo_cuda_refuses_cpu_tensors():
    """On CPU tensors the CUDA wrapper raises; it never runs the plain
    version."""
    args = topo_args(TOPO_WORLDS["holes"](), torch.device("cpu"))
    with pytest.raises(ValueError, match="not a CUDA device"):
        place_topo_cuda(*args[:12], args[12], 10.0)


def test_launch_plan_counts_the_zone_codes():
    p0 = place_mod.launch_plan(2000, 3, False, 16)
    p1 = place_mod.launch_plan(2000, 3, False, 16, topo=True)
    assert p1.cluster == p0.cluster and p1.in_smem
    assert p1.smem_bytes - p0.smem_bytes == 4 * p0.slice
    assert (place_mod.node_bytes(3, True, True, True)
            - place_mod.node_bytes(3, True, True) == 4)


def test_rescores_count_the_anchor_zones():
    """The cache rule B6's bound counts: an anchor move re-scores the old
    and the new anchor zones' nodes, so the wide-ties world at weight 10
    counts more than B1's rule; with every node unzoned the counts are
    B1's."""
    from volcano_tpu_torch.ops.place import task_rescores
    w = TOPO_WORLDS["wide-ties"]()
    args = topo_args(w, torch.device("cpu"))
    words = place_topo_plain(*args[:12], args[12], 10.0)[0].numpy()
    flags, req, N = args[7].numpy(), w["req"], len(w["zone_code"])
    plain = task_rescores(words, flags, req, None, N)
    zoned = task_rescores(words, flags, req, None, N, w["zone_code"])
    assert zoned.sum() > plain.sum() and (zoned >= plain).all()
    np.testing.assert_array_equal(
        task_rescores(words, flags, req, None, N, np.zeros(N, np.int32)),
        plain)


# -- the speculative dispatch --------------------------------------------------

def test_speculative_topo_dispatch_matches_jax(tmp_path):
    want = jax_reference("topo-dispatch", ["drive"],
                         tmp_path / "dispatch.pkl")["drive"]
    got = topo_dispatch(True)
    assert got == want
    assert any(got["kept"]) and len(got["tasks"]) >= 3


# -- the allocate action's topology weight -------------------------------------

def _zoned_cache(n_nodes=12, zone_of=lambda i: f"z{i // 4}", journal=None):
    cache = SchedulerCache(default_queue=None, journal=journal)
    cache.add_queue(QueueInfo(name="q1", weight=1))
    for i in range(n_nodes):
        r = Resource(4000, 16 * GI)
        r.max_task_num = 40
        cache.add_node(NodeInfo(name=f"n{i:02d}", allocatable=r,
                                labels={"volcano.sh/topology-zone":
                                        zone_of(i)}))
    return cache


def _job(uid, tasks, min_available, cpu=1000, desired=None, ts=0.0):
    ann = {ELASTIC_DESIRED_ANNOTATION: str(desired)} \
        if desired is not None else None
    pg = PodGroup(name=uid, queue="q1", min_member=min_available,
                  phase=PodGroupPhase.PENDING, annotations=ann)
    job = JobInfo(uid=uid, name=uid, queue="q1", min_available=min_available,
                  podgroup=pg, creation_timestamp=ts)
    for t in range(tasks):
        job.add_task_info(TaskInfo(uid=f"{uid}-{t}", name=f"{uid}-{t}",
                                   job=uid, resreq=Resource(cpu, GI),
                                   creation_timestamp=ts + t * 1e-6))
    return job


def test_topology_weight_reads_the_allocate_blocks():
    cache = _zoned_cache()
    sched = Scheduler(cache, TOPO_CONF, device="cpu")
    ssn = open_session(cache, sched.conf.tiers, sched.conf.configurations,
                       device="cpu")
    try:
        assert alloc._topology_weight(ssn) == 10.0
    finally:
        close_session(ssn)
    for text, want in (("-3", 0.0), ("x", 0.0), ("2.5", 2.5)):
        conf = TOPO_CONF.replace("topology-weight: 10.0",
                                 f"topology-weight: {text}")
        sched = Scheduler(cache, conf, device="cpu")
        ssn = open_session(cache, sched.conf.tiers,
                           sched.conf.configurations, device="cpu")
        try:
            assert alloc._topology_weight(ssn) == want
        finally:
            close_session(ssn)


def test_fused_solve_packs_gangs_into_their_zone():
    """tpu-fused at weight 100 (more than least-allocated's pull toward an
    empty node) places each 3-pod gang in one zone; the same world at
    weight 0 spreads some across zones."""
    def run(w):
        cache = _zoned_cache()
        for j in range(6):
            cache.add_job(_job(f"g{j}", 3, 3, ts=float(j)))
        conf = TOPO_CONF.replace("topology-weight: 10.0",
                                 f"topology-weight: {w}")
        assert Scheduler(cache, conf, device="cpu").run_once() == []
        zones = {}
        for uid, node in cache.binder.binds.items():
            zones.setdefault(uid.split("/")[-1].rsplit("-", 1)[0],
                             set()).add(int(node[1:]) // 4)
        return zones

    aware, blind = run(100), run(0)
    assert len(aware) == len(blind) == 6
    assert all(len(z) == 1 for z in aware.values())
    assert any(len(z) > 1 for z in blind.values())


# -- membership ----------------------------------------------------------------

def _ready(job, n):
    for t in list(job.tasks.values())[:n]:
        job.update_task_status(t, TaskStatus.RUNNING)


def test_membership_counts_and_orders():
    job = _job("eg", 6, 2, desired=4)
    assert desired_members(job) == 4
    assert shrink_allowance(job) == 0
    _ready(job, 5)
    assert shrink_allowance(job) == 3
    assert [t.uid for t in shrink_candidates(job)] == \
        [f"eg-{i}" for i in (4, 3, 2, 1, 0)]
    assert [t.uid for t in grow_candidates(job)] == ["eg-5"]
    job.podgroup.annotations[ELASTIC_DESIRED_ANNOTATION] = "1"
    assert desired_members(job) == 2          # clamped to min
    rigid = _job("r", 4, 4)
    _ready(rigid, 4)
    assert shrink_allowance(rigid) == 0


def test_pending_filter_is_the_decision_class():
    job = _job("eg", 6, 2, desired=6)
    pend = list(job.tasks.values())[::-1]
    assert [t.uid for t in allocate_pending_filter(job, pend)] == \
        ["eg-0", "eg-1"]
    _ready(job, 2)
    assert allocate_pending_filter(job, pend[:4]) == []
    job.podgroup.annotations[SUSPEND_ANNOTATION] = "true"
    assert allocate_pending_filter(job, pend) == []
    rigid = _job("r", 3, 3)
    tasks = list(rigid.tasks.values())
    assert allocate_pending_filter(rigid, tasks) is tasks


# -- the command funnel and the journal -----------------------------------------

class _FakeCache:
    """The funnel's cache surface: jobs, epoch, dirty marks, journal."""

    def __init__(self, journal=None):
        self.jobs = {}
        self._lock = threading.Lock()
        self.journal = journal
        self.dirty = []

    def fencing_epoch(self):
        return 7

    def mark_job_dirty(self, uid):
        self.dirty.append(uid)


def test_funnel_round_trip():
    """Verbs change nothing at submit; consume applies them at the cycle
    boundary, marks the job dirty and balances the ledger."""
    cache = _FakeCache()
    job = _job("eg", 6, 2, desired=6)
    cache.jobs[job.uid] = job
    funnel = CommandFunnel(cache)
    assert funnel.resolve_job("eg") == "eg"
    assert funnel.submit("scale", "eg", 4)
    assert funnel.submit("suspend", "eg")
    ann = job.podgroup.annotations
    assert ann[ELASTIC_DESIRED_ANNOTATION] == "6"
    assert SUSPEND_ANNOTATION not in ann
    assert funnel.consume() == 2
    assert ann[ELASTIC_DESIRED_ANNOTATION] == "4"
    assert ann[SUSPEND_ANNOTATION] == "true"
    assert cache.dirty == ["eg", "eg"]
    assert funnel.submit("resume", "eg")
    assert funnel.submit("scale", "ghost", 2)
    assert funnel.consume() == 1
    assert SUSPEND_ANNOTATION not in ann
    assert funnel.stats() == {"submitted": 4, "applied": 3, "rejected": 0,
                              "dropped": 1, "pending": 0}


def test_funnel_refuses_stale_epochs_and_bad_verbs():
    funnel = CommandFunnel(_FakeCache())
    assert not funnel.submit("suspend", "eg", expected_epoch=6)
    assert funnel.submit("suspend", "eg", expected_epoch=7)
    assert funnel.stats()["rejected"] == 1
    with pytest.raises(ValueError):
        funnel.submit("delete", "eg")
    with pytest.raises(ValueError):
        funnel.submit("scale", "eg")
    with pytest.raises(ValueError):
        funnel.submit("scale", "eg", -1)


def test_control_records_are_durable_and_open_no_window(tmp_path):
    """A control record takes a seq and is on disk at once; it never
    enters the open set, and a restarted journal continues after it."""
    path = tmp_path / "j.jsonl"
    journal = IntentJournal(str(path))
    cache = _FakeCache(journal)
    cache.jobs["eg"] = _job("eg", 3, 1, desired=3)
    funnel = CommandFunnel(cache)
    funnel.submit("scale", "eg", 2)
    funnel.consume()
    funnel.submit("suspend", "ghost")
    funnel.consume()
    kinds = [line.split('"kind":"')[1].split('"')[0]
             for line in path.read_text().splitlines()]
    assert kinds == ["command", "command_applied", "command",
                     "command_dropped"]
    assert len(journal) == 0
    journal.close()
    again = IntentJournal(str(path))
    assert again.record_control("elastic_grow", {"job": "eg"}) == 5
    assert len(again) == 0
    again.close()


# -- the plugin, grow-shrink and the victim tier --------------------------------

ELASTIC_CONF = """
actions: "enqueue, allocate, grow-shrink, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: elastic-gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


def test_grow_shrink_admits_at_min_then_grows_in_zone():
    """An elastic gang admits at min in allocate and grows toward desired
    in grow-shrink, in the zone its members hold, with a journaled grow
    record each."""
    journal = IntentJournal()
    cache = _zoned_cache(journal=journal)
    cache.add_job(_job("eg", 6, 2, desired=5))
    metrics.reset_local()
    sched = Scheduler(cache, ELASTIC_CONF, device="cpu")
    assert sched.run_once() == []
    binds = dict(cache.binder.binds)
    assert len(binds) == 5
    assert len({int(n[1:]) // 4 for n in binds.values()}) == 1
    gs = next(a for a in sched.actions if a.name() == "grow-shrink")
    assert gs.last_stats["grows"] == 3
    assert metrics.elastic_counts() == {"grows": 3.0}
    assert gs.last_stats["above_min_members"] == 3
    assert gs.last_stats["topology_spread"] == 0


def test_suspended_gang_is_not_schedulable_and_drains():
    cache = _zoned_cache()
    job = _job("eg", 4, 2, desired=4)
    cache.add_job(job)
    funnel = CommandFunnel(cache)
    sched = Scheduler(cache, ELASTIC_CONF, device="cpu")
    sched.command_funnel = funnel
    assert sched.run_once() == []
    assert len(cache.binder.binds) == 4
    for t in job.tasks.values():
        cache.update_task_status(t, TaskStatus.RUNNING)
    metrics.reset_local()
    funnel.submit("suspend", "eg")
    assert sched.run_once() == []
    assert sorted(cache.evictor.evicts) == [f"eg-{i}" for i in range(4)] \
        or len(cache.evictor.evicts) == 4
    assert metrics.elastic_counts().get("shrink/suspend") == 4.0
    assert metrics.elastic_counts().get("below_min", 0.0) == 0.0


def test_elastic_victims_lead_the_eviction_order():
    """Above-min members of an elastic gang move to the front of the
    victim order, highest uid first, capped at the shrink allowance; a
    world without them keeps its order."""
    cache = _zoned_cache()
    eg = _job("eg", 5, 2, desired=5)
    rigid = _job("rg", 2, 2, ts=1.0)
    for j in (eg, rigid):
        cache.add_job(j)
    sched = Scheduler(cache, ELASTIC_CONF.replace("grow-shrink, ", ""),
                      device="cpu")
    ssn = open_session(cache, sched.conf.tiers, sched.conf.configurations,
                       device="cpu")
    try:
        sjob = ssn.jobs["eg"]
        _ready(sjob, 5)
        victims = list(ssn.jobs["rg"].tasks.values()) + \
            list(sjob.tasks.values())
        order = evict_tpu._elastic_victims_first(ssn, victims)
        # the gang's three highest uids, in the order they were given
        assert [t.uid for t in order] == ["eg-2", "eg-3", "eg-4", "rg-0",
                                          "rg-1", "eg-0", "eg-1"]
        rest = list(ssn.jobs["rg"].tasks.values())
        assert evict_tpu._elastic_victims_first(ssn, rest) is rest
    finally:
        close_session(ssn)
