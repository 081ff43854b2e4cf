"""Elastic partition membership in volcano_tpu_torch
(``federation/elastic.py``, the runner's spawn and retire hooks, ``sim
--elastic``), held to the JAX package's, and the batched admission front
door (``webhooks/admission.py::submit_job_batch``).

- The ElasticController's decisions (split on chronic budget exhaustion,
  merge on chronic idleness, the doubling abstention window, the settle
  window, the lowest pid as everyone's sink, ``detail()``): each scenario
  runs once through each package's classes and the two records must be
  equal. The ledger-level cases of tests/test_federation.py's
  TestElasticMembership are in tests/test_torch_federation.py.
- TestElasticSim's runs: tools/sim_reference.py's ELASTIC_RUNS that the CPU
  holds (the sim's default conf: CI's elastic soak, the contract run and
  its kill run) through the port's sim, compared with the JAX package's
  digests (report with its ``federation.elastic`` section, side-effect
  sequence, node-tensor path partition by partition), with the contract's
  assertions. The deploy/scheduler.conf run is the card's
  (``chip_smoke.py``'s ``elastic-membership`` phase).
- TestBatchedAdmission and ``vcctl federation elastic-status``, each run
  through both packages.
"""

import hashlib
import json

import pytest

from volcano_tpu_torch.sim.__main__ import REFUSED_FLAGS, build_parser
from volcano_tpu_torch.sim.__main__ import main as sim_main

from test_torch_federation import (JAX, PORT, FakeClock, both,
                                   make_cache, make_federation, make_job)
from torch_parity import sim_port_run

# ---------------------------------------------------------------------------
# the controller's decisions, through both packages
# ---------------------------------------------------------------------------

QUEUES = ("qa", "qb", "qc", "qd")


def _world(p, n=1, queues=QUEUES, depths=(3, 1, 2, 1)):
    """``n`` partitions, ``queues`` registered round-robin, and in each
    queue's owner a pending gang of the given depth."""
    clock = FakeClock()
    journal = p.journal.IntentJournal()
    records = []
    journal.subscribe(records.append)
    pm, reg, ledger, caches = make_federation(p, clock, n=n,
                                              journal=journal)
    for i, (q, k) in enumerate(zip(queues, depths)):
        pm.register_queue(q)
        if k:
            owner = pm.owner_of_queue(q)
            caches[owner].add_job(make_job(p, f"j{i}", q, k,
                                           p.api.PodGroupPhase.INQUEUE))
    return clock, journal, records, pm, ledger, caches


def _controller(p, pid, pm, ledger, cache, clock, journal, exhausted,
                events, **kw):
    def spawn(new_pid):
        events.append(["spawn", new_pid])
        ledger.attach_cache(new_pid, make_cache(p, n_nodes=0,
                                                journal=journal))

    def retire(old_pid):
        events.append(["retire", old_pid])

    return p.fed.ElasticController(
        pid, pm, ledger, cache, epoch_fn=lambda: 0, time_fn=clock,
        exhausted_fn=lambda: exhausted["n"], spawn_fn=spawn,
        retire_fn=retire, **dict(dict(hot_cycles=3, idle_cycles=4,
                                      cooldown_s=4.0, max_cooldown_s=16.0),
                                 **kw))


def _kinds(records):
    """The journal's control records without their lifecycle stamps (a
    queue move's ``jobs`` map each job to its timeline context, whose event
    ids count every event this process recorded before)."""
    out = []
    for r in records:
        r = {k: v for k, v in r.items() if k not in ("ctx", "seq")}
        if "jobs" in r:
            r["jobs"] = sorted(r["jobs"])
        out.append(r)
    return out


def _map(pm):
    return {"queues": {str(pid): sorted(pm.queues_of(pid))
                       for pid in pm.active_pids()},
            "draining": dict(sorted(pm.draining.items())),
            "states": {str(pid): pm.state_of(pid)
                       for pid in pm.active_pids()}}


def test_split_on_chronic_budget_exhaustion():
    """Three hot steps (the exhaustion counter rising with pending depth)
    mint a partition through the journaled spawn and move the deepest half
    of the owned queues to it; the move drains (neither side schedules the
    queue) and flips at the newborn's settle."""
    def scenario(p):
        p.metrics.reset_local()
        clock, journal, records, pm, ledger, caches = _world(p)
        exhausted, events = {"n": 0}, []
        ctrl = _controller(p, 0, pm, ledger, caches[0], clock, journal,
                           exhausted, events)
        steps = []
        for _ in range(5):
            clock.advance(1.0)
            exhausted["n"] += 1
            ctrl.step()
            steps.append([ctrl.detail()["hot_streak"], ctrl.splits,
                          ctrl.abstentions])
        before = _map(pm)
        ledger.settle_moves(1, 0)
        ledger.settle_moves(0, 0)
        return (steps, events, ctrl.detail(), before, _map(pm),
                _kinds(records),
                p.metrics.health_detail()["partition_splits_total"])

    steps, events, detail, before, after, records, splits = both(scenario)
    # the owned queues' settle window holds the first hot steps back (two
    # abstentions at the threshold), then the split fires
    assert steps == [[1, 0, 0], [2, 0, 0], [3, 0, 1], [4, 0, 2],
                     [0, 1, 2]]
    assert events == [["spawn", 1]]
    assert detail["splits"] == 1 and detail["last_split"]["new_pid"] == 1
    # the deepest half (qa at 3, then qc at 2), ties toward the name
    assert detail["last_split"]["moved"] == ["qa", "qc"]
    assert before["draining"] == {"qa": 1, "qc": 1}
    assert after["queues"] == {"0": ["qb", "qd"], "1": ["qa", "qc"]}
    assert any(r["kind"] == "partition_spawn" for r in records)
    assert splits == {"executed": 1}


def test_flap_guard_doubles_the_abstention_window():
    """After a membership change the controller abstains while the load
    stays hot; the window doubles with each change."""
    def scenario(p):
        clock, journal, records, pm, ledger, caches = _world(p)
        exhausted, events = {"n": 0}, []
        ctrl = _controller(p, 0, pm, ledger, caches[0], clock, journal,
                           exhausted, events)
        out = []
        for _ in range(10):
            clock.advance(1.0)
            exhausted["n"] += 1
            ctrl.step()
            for pid in pm.active_pids():
                ledger.settle_moves(pid, 0)
            d = ctrl.detail()
            out.append([clock(), d["splits"], d["abstentions"],
                        d["block_until"]])
        return out, events, _map(pm)

    out, events, final = both(scenario)
    assert events == [["spawn", 1], ["spawn", 2]]
    # the first split at t=5 blocks for 4 s, the second at t=9 for 8 s
    assert [row for row in out if row[0] in (5.0, 9.0)] == [
        [5.0, 1, 2, 9.0], [9.0, 2, 3, 17.0]]
    assert final["queues"] == {"0": ["qd"], "1": ["qa", "qc"],
                               "2": ["qb"]}


def test_merge_on_chronic_idleness_drains_into_the_lowest_pid():
    """An idle partition that is not the lowest pid begins its retirement
    (journaled), moves its queues to the lowest assignable pid, releases
    its nodes and retires once nothing references it."""
    def scenario(p):
        clock, journal, records, pm, ledger, caches = _world(
            p, n=2, depths=(2, 0, 1, 0))
        exhausted, events = {"n": 0}, []
        ctrl = _controller(p, 1, pm, ledger, caches[1], clock, journal,
                           exhausted, events)
        out = []
        for _ in range(8):
            clock.advance(1.0)
            ctrl.step()
            for pid in pm.active_pids():
                ledger.settle_moves(pid, 0)
            out.append([ctrl.retiring, ctrl.merges, pm.state_of(1)])
        return (out, events, ctrl.detail(), _map(pm),
                [r["kind"] for r in records if "partition" in r["kind"]])

    out, events, detail, final, kinds = both(scenario)
    assert detail["merges"] == 1 and detail["last_merge"]["to"] == 0
    assert events == [["retire", 1]]
    assert final["queues"] == {"0": ["qa", "qb", "qc", "qd"]}
    assert "partition_retire_begin" in kinds and "partition_retire" in kinds


def test_lowest_pid_is_the_sink_and_never_merges():
    def scenario(p):
        clock, journal, records, pm, ledger, caches = _world(
            p, n=2, depths=(0, 2, 0, 1))
        exhausted, events = {"n": 0}, []
        ctrl = _controller(p, 0, pm, ledger, caches[0], clock, journal,
                           exhausted, events)
        for _ in range(10):
            clock.advance(1.0)
            ctrl.step()
        return ctrl.detail(), events, _map(pm)

    detail, events, final = both(scenario)
    assert detail["merges"] == 0 and not detail["retiring"] and not events
    assert final["states"] == {"0": "active", "1": "active"}


def test_split_refused_with_one_settled_queue_or_at_max_partitions():
    def scenario(p, queues, depths, max_partitions):
        clock, journal, records, pm, ledger, caches = _world(
            p, queues=queues, depths=depths)
        exhausted, events = {"n": 0}, []
        ctrl = _controller(p, 0, pm, ledger, caches[0], clock, journal,
                           exhausted, events, max_partitions=max_partitions)
        for _ in range(4):
            clock.advance(1.0)
            exhausted["n"] += 1
            ctrl.step()
        return ctrl.detail(), events

    detail, events = both(scenario, ("qa",), (4,), 8)
    assert detail["splits"] == 0 and detail["abstentions"] > 0 \
        and not events
    detail, events = both(scenario, QUEUES, (3, 1, 2, 1), 1)
    assert detail["splits"] == 0 and detail["abstentions"] > 0


def test_received_queue_settles_before_it_counts():
    """A queue moved INTO a partition opens its settle window: a newborn
    does not merge itself back before its first queue settles."""
    def scenario(p):
        clock, journal, records, pm, ledger, caches = _world(
            p, n=2, depths=(0, 0, 0, 0))
        exhausted, events = {"n": 0}, []
        ctrl = _controller(p, 1, pm, ledger, caches[1], clock, journal,
                           exhausted, events, idle_cycles=2)
        clock.advance(1.0)
        ctrl.step()
        ledger.move_queue("qa", 1, 0)
        ledger.settle_moves(1, 0)
        out = []
        for _ in range(6):
            clock.advance(1.0)
            ctrl.step()
            ledger.settle_moves(0, 0)
            d = ctrl.detail()
            out.append([d["settle_until"], d["abstentions"], d["retiring"]])
        return out

    out = both(scenario)
    assert out[0][0] > 0 and out[0][2] is False
    assert any(a > 0 for _, a, _ in out)


def test_member_steps_the_controller_at_cycle_end():
    """PartitionMember.on_cycle_end runs the elastic step, isolated: a
    raising controller does not cost the cycle."""
    def scenario(p):
        clock, journal, records, pm, ledger, caches = _world(p)
        exhausted, events = {"n": 0}, []
        ctrl = _controller(p, 0, pm, ledger, caches[0], clock, journal,
                           exhausted, events)
        member = p.fed.PartitionMember(0, pm, ledger, caches[0],
                                       epoch_fn=lambda: 0, time_fn=clock,
                                       elastic=ctrl)
        for _ in range(5):
            clock.advance(1.0)
            exhausted["n"] += 1
            member.on_cycle_end()

        def broken(now=None):
            raise RuntimeError("boom")

        ctrl.step = broken
        member.on_cycle_end()
        return events, ctrl.splits

    events, splits = both(scenario)
    assert events == [["spawn", 1]] and splits == 1


# ---------------------------------------------------------------------------
# sim --elastic: ELASTIC_RUNS on the CPU, held to the JAX package's digests
# ---------------------------------------------------------------------------

def _load_tool():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "sim_reference", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "tools", "sim_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _load_tool()
# the sim's default conf; the deploy/scheduler.conf run is the card's
RUNS = [r for r in TOOL.ELASTIC_RUNS if TOOL.DEPLOYED not in r[1]]
IDS = [TOOL.run_key(*r) for r in RUNS]
# the --overload-chaos preset's admission depth
ADMISSION_DEPTH = 48


@pytest.fixture(scope="module")
def digests():
    with open(TOOL.DIGESTS) as f:
        return {run["key"]: run for run in json.load(f)["runs"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(run):
        key = TOOL.run_key(*run)
        if key not in cache:
            cache[key] = sim_port_run(
                *run, out_dir=tmp_path_factory.mktemp("elastic"))
        return cache[key]
    return get


def test_every_elastic_run_has_a_digest(digests):
    for run in TOOL.ELASTIC_RUNS + tuple(
            r for r in TOOL.MENDED_RUNS if r[0] == "diurnal-flash-crowd"):
        assert TOOL.run_key(*run) in digests
    for run in TOOL.ELASTIC_RUNS:
        TOOL.held_to(run, digests)           # the record it is held to


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_elastic_run_matches_jax(digests, runs, run):
    """Report (with ``federation.elastic``), side-effect sequence and
    node-tensor paths (each partition's, the newborns' included): the JAX
    package's, with each of its faults that the port fixes mended where it
    fired."""
    got, (want, _) = runs(run), TOOL.held_to(run, digests)
    assert got["rc"] == 0, got["stderr"][-2000:]
    assert hashlib.sha256(got["text"]).hexdigest() == want["sha256"]
    assert len(got["text"]) == want["bytes"]
    assert (got["sequence"]["sha256"], got["sequence"]["binds"],
            got["sequence"]["evicts"]) == (want["sequence_sha256"],
                                           want["sequence_binds"],
                                           want["sequence_evicts"])
    assert got["paths"] == want["tensor_paths"]


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_elastic_run_contract(runs, run):
    """TestElasticSim's contract: at least one split and one merge, the
    membership back at one partition, every admitted gang completed, no
    double bind, bounded per-queue depth, no stranded pin and no open
    reserve; a kill run restarted; the verifier passed where it ran."""
    _, args, _ = run
    got = runs(run)
    report = got["report"]
    el = report["federation"]["elastic"]
    assert el["splits"] >= 1 and el["merges"] >= 1, el
    assert el["partitions_peak"] >= 2
    assert el["partitions_final"] == el["partitions_initial"] == 1
    assert report["jobs"]["completed"] == report["jobs"]["arrived"]
    assert report["jobs"]["unfinished"] == 0
    assert report["double_binds"] == 0 and report["action_failures"] == 0
    assert el["max_queue_depth"] <= ADMISSION_DEPTH
    runner = got["runners"][0]
    assert runner.pmap.pinned == {}
    assert runner.ledger.detail()["open"] == []
    assert [e["kind"] for e in el["events"]].count("spawn") == el["splits"]
    if "--kill-cycles" in args:
        assert report["restarts"] >= 1
    if "--verify-elastic-equivalence" in args:
        assert "elastic-equivalence OK" in got["stderr"]
        assert len(got["runners"]) == 2


def test_retired_partition_leaves_no_node_tensors(runs):
    """A retired partition's cache leaves the run with its persistent node
    tensors dropped; the survivors' caches are the live ones."""
    got = runs(RUNS[1])
    runner = got["runners"][0]
    assert len(runner.caches) == 1 and runner.caches[0].partition == 0
    assert sorted(runner._cache_by_pid) == [0]


def test_elastic_flags_are_no_longer_refused():
    assert "--elastic" not in REFUSED_FLAGS
    assert "--verify-elastic-equivalence" not in REFUSED_FLAGS
    args = build_parser().parse_args(
        ["--scenario", "smoke", "--federated", "1", "--elastic",
         "--verify-elastic-equivalence"])
    assert args.elastic and args.verify_elastic_equivalence
    assert args.refused == []


@pytest.mark.parametrize("argv", [
    ["--elastic"], ["--federated", "2", "--verify-elastic-equivalence"]],
    ids=["elastic-without-federated", "verify-without-elastic"])
def test_elastic_flag_misuse_is_a_usage_error(argv):
    with pytest.raises(SystemExit) as e:
        sim_main(["--device", "cpu", "--scenario", "smoke", *argv])
    assert e.value.code == 2


# ---------------------------------------------------------------------------
# the batched admission front door and the elastic-status verb
# ---------------------------------------------------------------------------

def _admission_store(p):
    o = p.objects
    store = p.store.ObjectStore()
    p.admission.register_webhooks(store)
    store.create(o.QueueCR(metadata=o.ObjectMeta(name="default",
                                                 namespace="default"),
                           spec=o.QueueSpecCR(weight=1)))
    return store


def _admission_job(p, name, queue="default", replicas=2):
    o = p.objects
    return o.Job(metadata=o.ObjectMeta(name=name, namespace="default"),
                 spec=o.JobSpec(queue=queue, tasks=[
                     o.TaskSpec(name="main", replicas=replicas,
                                template=o.PodTemplate())]))


def _with_system(ns, pkg):
    import importlib
    ns.objects = importlib.import_module(f"{pkg}.apis.objects")
    ns.admission = importlib.import_module(f"{pkg}.webhooks.admission")
    ns.vcctl = importlib.import_module(f"{pkg}.cli.vcctl")
    return ns


_with_system(JAX, "volcano_tpu")
_with_system(PORT, "volcano_tpu_torch")


def _batch_one_queue_read(p):
    store = _admission_store(p)
    reads = {"n": 0}
    orig = store.get

    def counting_get(kind, ns, name):
        if kind == "Queue":
            reads["n"] += 1
        return orig(kind, ns, name)

    store.get = counting_get
    created = p.admission.submit_job_batch(
        store, [_admission_job(p, f"b{i}") for i in range(64)])
    return (len(created), reads["n"], len(store.list("Job")),
            created[0].spec.min_available, created[0].spec.scheduler_name)


def _batch_rejected_atomically(p):
    store = _admission_store(p)
    bad = _admission_job(p, "bad", queue="no-such-queue")
    try:
        p.admission.submit_job_batch(store, [_admission_job(p, "ok1"), bad,
                                             _admission_job(p, "ok2")])
    except p.store.AdmissionError as exc:
        return str(exc), store.list("Job")
    return None, store.list("Job")


def _batch_size_metric(p):
    p.metrics.reset_local()
    store = _admission_store(p)
    p.admission.submit_job_batch(
        store, [_admission_job(p, f"m{i}") for i in range(7)])
    return p.metrics.local_durations().get(("admission_batch",))


def _create_batch_all_or_nothing(p):
    store = _admission_store(p)
    store.create(_admission_job(p, "dup"))
    try:
        store.create_batch([_admission_job(p, "fresh"),
                            _admission_job(p, "dup")], admit=False)
    except ValueError:
        return "refused", len(store.list("Job"))
    return "accepted", len(store.list("Job"))


@pytest.mark.parametrize("scenario,want", [
    (_batch_one_queue_read, (64, 0, 64, 2, "volcano")),
    (_batch_rejected_atomically, None),
    (_batch_size_metric, [7.0]),
    (_create_batch_all_or_nothing, ("refused", 1)),
], ids=["one-queue-read", "rejected-atomically", "batch-size-metric",
        "create-batch-all-or-nothing"])
def test_batched_admission(scenario, want):
    """TestBatchedAdmission: the batch is defaulted and validated against
    one prefetched queue read and lands in one store write; an invalid job
    rejects the whole batch before anything is written."""
    got = both(scenario)
    if scenario is _batch_rejected_atomically:
        message, jobs = got
        assert "default/bad" in message and jobs == []
    else:
        assert got == want


def test_vcctl_federation_elastic_status_verb():
    def scenario(p):
        p.metrics.reset_local()
        out = []
        rc0 = p.vcctl.main(["federation", "elastic-status"],
                           store=p.store.ObjectStore(), out=out.append)
        p.metrics.set_partition_count(2)
        p.metrics.register_partition_split("committed")
        p.metrics.register_partition_merge("committed")
        p.metrics.set_elastic_detail(0, {
            "partition": 0, "retiring": False, "splits": 1, "merges": 1,
            "abstentions": 4, "refused": 0, "hot_streak": 2,
            "idle_streak": 0, "block_until": 17.5,
            "last_split": {"t": 9.0, "pid": 1}})
        rc1 = p.vcctl.main(["federation", "elastic-status"],
                           store=p.store.ObjectStore(), out=out.append)
        p.metrics.reset_local()
        return rc0, rc1, out

    rc0, rc1, out = both(scenario)
    assert rc0 == 1 and "not enabled" in out[0]
    assert rc1 == 0
    assert "partitions=2" in out[1] and "committed" in out[1]
    assert out[2].startswith("p0\t") and "hot=2" in out[2] \
        and "splits=1" in out[2]
    assert "last_split" in out[3] and '"pid": 1' in out[3]
