"""The federated control plane's protocol in volcano_tpu_torch
(``federation/``), held to the JAX package's: the port of
tests/test_federation.py's TestPartitionMap, TestReserveProtocol,
TestQueueRebalance, TestStoreBackedFederation, the ledger-level cases of
TestElasticMembership (the journaled spawn/retire funnel lives in
``reserve.py``), the shared-journal follower and control-record cases, and
tests/test_overload.py's TestRebalancer. Each scenario runs once through
each package's classes and the two records must be equal; the assertions
are the reference tests'. The elastic controller, the batched admission
front door and the elastic-status verb are in
tests/test_torch_elastic_membership.py."""

import random
import types

import pytest

import volcano_tpu.api as jax_api
import volcano_tpu.cache as jax_cache
import volcano_tpu.cache.executors as jax_exec
import volcano_tpu.cache.journal as jax_journal
import volcano_tpu.chaos as jax_chaos
import volcano_tpu.federation as jax_fed
import volcano_tpu.metrics as jax_metrics
import volcano_tpu.store as jax_store
import volcano_tpu.store_transport as jax_transport
import volcano_tpu_torch.api as pt_api
import volcano_tpu_torch.cache as pt_cache
import volcano_tpu_torch.cache.executors as pt_exec
import volcano_tpu_torch.cache.journal as pt_journal
import volcano_tpu_torch.chaos as pt_chaos
import volcano_tpu_torch.federation as pt_fed
import volcano_tpu_torch.metrics as pt_metrics
import volcano_tpu_torch.store as pt_store
import volcano_tpu_torch.store_transport as pt_transport

JAX = types.SimpleNamespace(api=jax_api, cache=jax_cache, exec=jax_exec,
                            journal=jax_journal, chaos=jax_chaos,
                            fed=jax_fed, metrics=jax_metrics,
                            store=jax_store, transport=jax_transport)
PORT = types.SimpleNamespace(api=pt_api, cache=pt_cache, exec=pt_exec,
                             journal=pt_journal, chaos=pt_chaos,
                             fed=pt_fed, metrics=pt_metrics,
                             store=pt_store, transport=pt_transport)

GI = 1 << 30


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` through each package; the records must
    be equal. Returns the port's."""
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, d: float) -> None:
        self.t += d


def make_cache(p, n_nodes=2, prefix="n", owner_jobs=(), journal=None):
    a = p.api
    cache = p.cache.SchedulerCache(binder=p.exec.SequenceBinder(),
                                   evictor=p.exec.SequenceEvictor(),
                                   default_queue=None, journal=journal)
    for i in range(n_nodes):
        alloc = a.Resource(16000, 32 * GI)
        alloc.max_task_num = 110
        cache.add_node(a.NodeInfo(name=f"{prefix}{i}", allocatable=alloc))
    for jid, queue, k in owner_jobs:
        cache.add_job(make_job(p, jid, queue, k,
                               a.PodGroupPhase.INQUEUE))
    return cache


def make_job(p, jid, queue, k, phase):
    a = p.api
    pg = a.PodGroup(name=jid, queue=queue, min_member=k, phase=phase)
    job = a.JobInfo(uid=jid, name=jid, queue=queue, min_available=k,
                    podgroup=pg, creation_timestamp=0.0)
    for i in range(k):
        job.add_task_info(a.TaskInfo(uid=f"{jid}-{i}", name=f"{jid}-{i}",
                                     job=jid, resreq=a.Resource(1000, GI)))
    return job


def place(p, cache, jid, i, node):
    job = cache.jobs[jid]
    task = job.tasks[f"{jid}-{i}"]
    cache.mark_node_dirty(node)
    task.node_name = node
    job.update_task_status(task, p.api.TaskStatus.RUNNING)
    cache.nodes[node].add_task(task)
    return task


def make_federation(p, clock, n=2, nodes_each=2, journal=None):
    pm = p.fed.PartitionMap(n)
    reg = p.exec.FencingRegistry()
    ledger = p.fed.ReserveLedger(pm, journal=journal, registry=reg,
                                 time_fn=clock, timeout_s=8.0)
    caches = []
    for pid in range(n):
        cache = make_cache(p, n_nodes=0, journal=journal)
        caches.append(cache)
        ledger.attach_cache(pid, cache)
    # every cache mirrors every node; ownership round-robins
    for i in range(n * nodes_each):
        name = f"n{i}"
        pm.register_node(name)
        for cache in caches:
            alloc = p.api.Resource(16000, 32 * GI)
            alloc.max_task_num = 110
            cache.add_node(p.api.NodeInfo(name=name, allocatable=alloc))
    return pm, reg, ledger, caches


def _busy_owner(p, caches):
    """Partition 1 runs a 2-task gang over both its nodes (n1, n3), so
    whichever donor a review picks has tasks to drain."""
    owner = caches[1]
    owner.add_job(make_job(p, "vj", "qb", 2, p.api.PodGroupPhase.RUNNING))
    place(p, owner, "vj", 0, "n1")
    place(p, owner, "vj", 1, "n3")
    return owner


def _req(req):
    return {"state": req.state, "node": req.node}


# ---------------------------------------------------------------------------
# PartitionMap: registration, scope, drain and pin
# ---------------------------------------------------------------------------

def test_round_robin_registration_is_deterministic():
    def scenario(p):
        a, b = p.fed.PartitionMap(3), p.fed.PartitionMap(3)
        for pm in (a, b):
            for q in ("q1", "q2", "q3", "q4"):
                pm.register_queue(q)
            for n in ("n0", "n1", "n2", "n3", "n4"):
                pm.register_node(n)
        assert a.queue_owner == b.queue_owner
        # idempotent: re-registration neither moves nor advances the rr
        return (dict(a.queue_owner), dict(a.node_owner),
                a.register_queue("q2"), a.register_node("n5"), a.version)

    queues, nodes, again, n5, _ = both(scenario)
    assert queues == {"q1": 0, "q2": 1, "q3": 2, "q4": 0}
    assert nodes == {"n0": 0, "n1": 1, "n2": 2, "n3": 0, "n4": 1}
    assert again == 1 and n5 == 2


def test_scope_filters_queues_jobs_and_node_shard():
    def scenario(p):
        a = p.api
        pm = p.fed.PartitionMap(2)
        pm.register_queue("qa")               # -> 0
        pm.register_queue("qb")               # -> 1
        pm.register_node("n0")                # -> 0
        pm.register_node("n1")                # -> 1
        ci = a.ClusterInfo()
        ci.queues = {"qa": a.QueueInfo(name="qa"),
                     "qb": a.QueueInfo(name="qb")}
        ci.nodes = {"n0": a.NodeInfo(name="n0"),
                    "n1": a.NodeInfo(name="n1")}
        ci.jobs = {
            "ja": a.JobInfo(uid="ja", queue="qa",
                            podgroup=a.PodGroup(name="ja", queue="qa")),
            "jb": a.JobInfo(uid="jb", queue="qb",
                            podgroup=a.PodGroup(name="jb", queue="qb")),
        }
        ci.snap_epoch = 9
        s0 = pm.scope(ci, 0)
        # objects are shared, not cloned: this is a view
        assert s0.nodes["n0"] is ci.nodes["n0"]
        out = [sorted(s0.queues), sorted(s0.jobs), sorted(s0.nodes),
               s0.snap_epoch]
        # a draining queue is scheduled by NOBODY until the flip
        pm._begin_drain_raw("qa", 1)
        out += [sorted(pm.scope(ci, 0).jobs), sorted(pm.scope(ci, 1).jobs),
                sorted(pm.scope(ci, 0).queues),
                sorted(pm.scope(ci, 1).queues)]
        # a pinned node leaves its owner's scope (capacity being handed
        # over must not be refilled)
        pm._pin_node_raw("n0", rid=7)
        out.append(sorted(pm.scope(ci, 0).nodes))
        return out

    got = both(scenario)
    assert got[:4] == [["qa"], ["ja"], ["n0"], 9]
    assert got[4:] == [[], ["jb"], [], ["qb"], []]


# ---------------------------------------------------------------------------
# the reserve/transfer protocol
# ---------------------------------------------------------------------------

def test_request_review_grant_transfers_an_empty_node():
    def scenario(p):
        clock = FakeClock()
        journal = p.journal.IntentJournal()
        records = []
        journal.subscribe(records.append)
        pm, reg, ledger, caches = make_federation(p, clock, journal=journal)
        reg.authority(0).advance(3)
        reg.authority(1).advance(5)
        rid = ledger.request(frm=0, to=1, cpu=4000, mem=GI, epoch_from=3)
        # one outstanding request per requester
        again = ledger.request(frm=0, to=1, cpu=1, mem=1, epoch_from=3)
        ledger.review(pid=1, epoch=5)
        req = ledger.find(rid)
        return {"rid": rid, "again": again, "req": _req(req),
                "open": rid in ledger.requests,
                "owner": pm.owner_of_node(req.node),
                "pinned": dict(pm.pinned),
                "transfers": ledger.node_transfers,
                "records": [{k: v for k, v in r.items() if k != "ctx"}
                            for r in records]}

    got = both(scenario)
    assert got["rid"] is not None and got["again"] is None
    assert got["req"]["state"] == "granted"
    assert not got["open"], \
        "settled requests leave the open set (bounded history)"
    assert got["owner"] == 0 and not got["pinned"]
    assert got["transfers"] == 1
    # the reserve intent names BOTH partitions' epochs, the grant too
    reserve = [r for r in got["records"] if r["kind"] == "reserve"][-1]
    assert reserve["epoch_from"] == 3 and reserve["epoch_to"] == 5
    grant = [r for r in got["records"] if r["kind"] == "reserve_grant"][-1]
    assert grant["epoch"] == 5 and grant["epoch_from"] == 3


def test_granting_drains_owner_tasks_through_the_evict_funnel():
    def scenario(p):
        clock = FakeClock()
        journal = p.journal.IntentJournal()
        pm, reg, ledger, caches = make_federation(p, clock, journal=journal)
        pm.register_queue("qa")                       # -> 0
        pm.register_queue("qb")                       # -> 1
        owner = _busy_owner(p, caches)
        ledger.request(frm=0, to=1, cpu=4000, mem=GI, epoch_from=1)
        ledger.review(pid=1, epoch=1)
        (rid, req), = ledger.requests.items()
        # phase 2a: pinned and draining, NOT yet transferred; the eviction
        # went through the owner's journaled funnel
        mid = {"req": _req(req), "pinned": dict(pm.pinned), "rid": rid,
               "evicted": list(owner.evictor.sequence),
               "status": owner.jobs["vj"].tasks["vj-0"].status.name,
               "owner": pm.owner_of_node("n1")}
        # the cluster deletes and recreates the pod: the node empties
        owner.delete_task(owner.jobs["vj"].tasks["vj-0"])
        ledger.review(pid=1, epoch=1)
        return mid, _req(req), pm.owner_of_node("n1")

    mid, done, owner_after = both(scenario)
    assert mid["req"] == {"state": "granting", "node": "n1"}
    assert mid["pinned"] == {"n1": mid["rid"]}
    assert mid["evicted"] == ["vj-0"] and mid["status"] == "RELEASING"
    assert mid["owner"] == 1
    assert done["state"] == "granted" and owner_after == 0


def test_owner_never_gives_up_its_last_node():
    def scenario(p):
        pm, reg, ledger, caches = make_federation(p, FakeClock(),
                                                  nodes_each=1)
        ledger.request(frm=0, to=1, cpu=1000, mem=GI, epoch_from=1)
        ledger.review(pid=1, epoch=1)
        (req,) = ledger.settled.values()
        return req.state, dict(ledger.counts)

    state, counts = both(scenario)
    assert state == "rejected" and counts.get("rejected") == 1


def test_timeout_release_unpins_so_capacity_is_never_stranded():
    def scenario(p):
        clock = FakeClock()
        journal = p.journal.IntentJournal()
        pm, reg, ledger, caches = make_federation(p, clock, journal=journal)
        pm.register_queue("qa")
        pm.register_queue("qb")
        _busy_owner(p, caches)
        ledger.request(frm=0, to=1, cpu=4000, mem=GI, epoch_from=1)
        ledger.review(pid=1, epoch=1)          # pins n1, starts draining
        pinned = bool(pm.pinned)
        # the OWNER is killed mid-drain; another partition's cycle expires
        # the request once the deadline passes
        clock.advance(9.0)
        expired = ledger.expire()
        (req,) = ledger.settled.values()
        # the requester may immediately file a fresh request
        fresh = ledger.request(frm=0, to=1, cpu=4000, mem=GI, epoch_from=1)
        return (pinned, expired, req.state, dict(pm.pinned),
                pm.owner_of_node("n1"), fresh is not None)

    pinned, expired, state, after, owner, fresh = both(scenario)
    assert pinned and expired == 1 and state == "expired"
    assert not after, "an expired grant must unpin the donor node"
    assert owner == 1 and fresh


def test_deposed_leader_cannot_review():
    def scenario(p):
        pm, reg, ledger, caches = make_federation(p, FakeClock())
        reg.authority(1).advance(4)
        ledger.request(frm=0, to=1, cpu=1000, mem=GI, epoch_from=1)
        ledger.review(pid=1, epoch=3)          # stale: the watermark is 4
        (req,) = ledger.requests.values()
        stale = req.state
        ledger.review(pid=1, epoch=4)
        return stale, req.state

    stale, state = both(scenario)
    assert stale == "requested", \
        "a deposed partition leader must not settle reserves"
    assert state == "granted"


def test_donor_choice_reads_published_idle():
    def scenario(p):
        pm, reg, ledger, caches = make_federation(p, FakeClock(), n=3)
        ledger.publish_idle(1, 5000.0, GI)
        ledger.publish_idle(2, 9000.0, GI)
        first = ledger.pick_donor(0)
        ledger.publish_idle(2, 1000.0, GI)
        return first, ledger.pick_donor(0)

    assert both(scenario) == (2, 1)


def test_ledger_detail_and_counts_match():
    """A whole exchange (two requests, a grant, a rejection, an expiry)
    leaves the same ledger detail, counts and map in both packages."""
    def scenario(p):
        clock = FakeClock()
        journal = p.journal.IntentJournal()
        pm, reg, ledger, caches = make_federation(p, clock, n=3,
                                                  journal=journal)
        for q in ("qa", "qb", "qc"):
            pm.register_queue(q)
        ledger.request(frm=0, to=1, cpu=2000, mem=GI, epoch_from=0)
        ledger.review(pid=1, epoch=0)
        ledger.request(frm=2, to=1, cpu=2000, mem=GI, epoch_from=0)
        ledger.review(pid=1, epoch=0)
        ledger.request(frm=1, to=0, cpu=2000, mem=GI, epoch_from=0)
        clock.advance(20.0)
        ledger.expire()
        return (ledger.detail(), dict(ledger.counts), pm.counts(),
                pm.version)

    detail, counts, pmap_counts, _ = both(scenario)
    assert sum(counts.values()) > 0 and pmap_counts


# ---------------------------------------------------------------------------
# queue rebalancing: drain, then flip
# ---------------------------------------------------------------------------

def _queue_setup(p):
    clock = FakeClock()
    journal = p.journal.IntentJournal()
    pm, reg, ledger, caches = make_federation(p, clock, journal=journal)
    pm.register_queue("qa")                      # -> 0
    pm.register_queue("qb")                      # -> 1
    frm = caches[0]
    frm.add_job(make_job(p, "mj", "qa", 2, p.api.PodGroupPhase.RUNNING))
    place(p, frm, "mj", 0, "n0")
    return clock, journal, pm, ledger, caches


def test_move_waits_for_in_flight_intents_then_flips():
    def scenario(p):
        clock, journal, pm, ledger, caches = _queue_setup(p)
        frm, to = caches
        # an in-flight intent for the queue's job: the crash window a flip
        # must NOT race
        seq = journal.record_intent("bind", frm.jobs["mj"].tasks["mj-1"],
                                    "n0")
        out = [ledger.move_queue("mj-queue-missing", 1, epoch=1),
               ledger.move_queue("qa", 1, epoch=1), dict(pm.draining)]
        ledger.settle_moves(0, epoch=1)
        out += [pm.owner_of_queue("qa"), "mj" in frm.jobs]
        journal.ack(seq, ok=True)
        ledger.settle_moves(0, epoch=1)
        out += [pm.owner_of_queue("qa"), dict(pm.draining),
                ledger.queue_moves, "mj" in frm.jobs, "mj" in to.jobs,
                "mj-0" in frm.nodes["n0"].tasks,
                "mj-0" in to.nodes["n0"].tasks, to.nodes["n0"].used.cpu]
        return out

    got = both(scenario)
    assert got[:3] == [False, True, {"qa": 1}]
    assert got[3:5] == [0, True], \
        "ownership must not flip while an intent is open"
    # the job (and its node-mirror accounting) moved caches whole
    assert got[5:] == [1, {}, 1, False, True, False, True, 1000]


def test_move_purges_source_retry_state_no_orphans():
    def scenario(p):
        clock, journal, pm, ledger, caches = _queue_setup(p)
        frm, to = caches
        retry = frm.jobs["mj"].tasks["mj-1"].clone()
        retry.node_name = "n0"
        frm.resync_task(retry)
        queued = len(frm.resync_queue)
        moved = ledger.move_queue("qa", 1, epoch=1)
        ledger.settle_moves(0, epoch=1)
        # remove_job dropped the queued retry (no orphaned side effect
        # firing against a cache that no longer owns the job)
        return (queued, moved, pm.owner_of_queue("qa"),
                frm.resync_queue.failures("bind/mj-1"),
                len(frm.dead_letter))

    assert both(scenario) == (1, True, 1, 0, 0)


def test_moved_queue_dirties_both_caches():
    """settle_moves mutates two caches outside the cycle: the source drops
    the job, the destination adopts it with its placement. Both caches'
    dirty sets must see it, so the next snapshot of each is right (the
    clone-on-dirty maps hold no stale clone)."""
    def scenario(p):
        clock, journal, pm, ledger, caches = _queue_setup(p)
        frm, to = caches
        snaps = [sorted(c.snapshot().jobs) for c in caches]
        ledger.move_queue("qa", 1, epoch=1)
        ledger.settle_moves(0, epoch=1)
        after = [c.snapshot() for c in caches]
        return (snaps, [sorted(s.jobs) for s in after],
                [s.nodes["n0"].used.cpu for s in after],
                [sorted(s.nodes["n0"].tasks) for s in after])

    before, jobs, used, tasks = both(scenario)
    assert before == [["mj"], []]
    assert jobs == [[], ["mj"]]
    assert used == [0, 1000] and tasks == [[], ["mj-0"]]


# ---------------------------------------------------------------------------
# the journaled membership funnel (partition_spawn/partition_retire)
# ---------------------------------------------------------------------------

def _membership(p, n=2):
    clock = FakeClock()
    journal = p.journal.IntentJournal()
    records = []
    journal.subscribe(records.append)
    pm, reg, ledger, caches = make_federation(p, clock, n=n,
                                              journal=journal)
    return clock, journal, records, pm, reg, ledger, caches


def _kinds(records, kind):
    return [{k: v for k, v in r.items() if k != "ctx"}
            for r in records if r["kind"] == kind]


def test_spawn_mints_a_journaled_fenced_partition_id():
    def scenario(p):
        clock, journal, records, pm, reg, ledger, caches = _membership(p)
        reg.authority(0).advance(2)
        # a deposed leader (stale epoch) may not grow the membership
        stale = ledger.partition_spawn(frm=0, epoch=1)
        pid = ledger.partition_spawn(frm=0, epoch=2)
        out = [stale, pid, pm.state_of(pid), pid in pm.assignable_pids()]
        # ids are never reused
        out.append(ledger.partition_spawn(frm=0, epoch=2))
        return out, _kinds(records, "partition_spawn")

    out, spawns = both(scenario)
    assert out == [None, 2, "active", True, 3]
    assert spawns[0]["pid"] == 2 and spawns[0]["frm"] == 0 \
        and spawns[0]["epoch"] == 2


def test_membership_never_empties_and_retiring_is_no_target():
    def scenario(p):
        clock, journal, records, pm, reg, ledger, caches = _membership(p)
        out = [ledger.begin_retire(1, epoch=0), pm.state_of(1)]
        # a retiring partition can no longer be a reserve target
        out.append(ledger.request(frm=0, to=1, cpu=1000, mem=GI,
                                  epoch_from=0))
        # ... and the LAST assignable partition may never retire
        out += [ledger.begin_retire(0, epoch=0), pm.state_of(0)]
        return out, _kinds(records, "partition_retire_begin")

    out, begins = both(scenario)
    assert out == [True, "retiring", None, False, "active"]
    assert begins[-1]["pid"] == 1


def test_merge_defers_on_open_reserve_pin_until_expiry():
    """A pin held by the retiring partition (its open reserve against a
    donor) defers retirement until the ledger's deadline expiry releases
    it: retiring the requester early would strand the donor's node."""
    def scenario(p):
        clock, journal, records, pm, reg, ledger, caches = _membership(p)
        pm.register_queue("qa")                       # -> 0
        pm.register_queue("qb")                       # -> 1
        pid = ledger.partition_spawn(frm=0, epoch=0)  # -> 2
        ledger.attach_cache(pid, make_cache(p, n_nodes=0, journal=journal))
        _busy_owner(p, caches)
        rid = ledger.request(frm=pid, to=1, cpu=4000, mem=GI, epoch_from=0)
        ledger.review(pid=1, epoch=0)         # pins n1, starts draining
        out = [dict(pm.pinned) == {"n1": rid},
               ledger.begin_retire(pid, epoch=0),
               "open-reserve" in ledger.retire_blockers(pid),
               ledger.partition_retire(pid, epoch=0), pm.state_of(pid),
               bool(pm.pinned)]
        clock.advance(9.0)
        out += [ledger.expire(), bool(pm.pinned), pm.owner_of_node("n1"),
                ledger.partition_retire(pid, epoch=0), pm.state_of(pid)]
        return out, _kinds(records, "partition_retire")

    out, retires = both(scenario)
    assert out[:6] == [True, True, True, False, "retiring", True]
    # the expiry (not the retirement) releases the pin; then the merge
    # completes
    assert out[6:] == [1, False, 1, True, None]
    assert retires[-1]["pid"] == 2


def test_retired_pid_purged_never_a_ghost_donor_or_move_target():
    """Every ledger signal a retired pid ever published (idle, load,
    freshness, its cache) is purged on partition_retire: the dead pid is
    never again a donor, and the rebalancer finds no move target at it."""
    def scenario(p):
        clock, journal, records, pm, reg, ledger, caches = _membership(p)
        for q in ("qa", "qb", "qc"):
            pm.register_queue(q)
        pid = ledger.partition_spawn(frm=0, epoch=0)  # -> 2
        ledger.attach_cache(pid, make_cache(p, n_nodes=0, journal=journal))
        pm._transfer_node_raw("n2", pid)
        pm._transfer_node_raw("n3", pid)
        ledger.publish_idle(pid, 9000.0, GI)
        ledger.publish_load(pid, {"pending": 0, "queues": {}, "t": 0.0})
        out = [ledger.pick_donor(0) == pid,
               ledger.load_seen(pid) is not None]
        assert ledger.begin_retire(pid, epoch=0)
        pm._transfer_node_raw("n2", 0)
        pm._transfer_node_raw("n3", 1)
        out += [ledger.partition_retire(pid, epoch=0), pm.state_of(pid),
                pid in pm.assignable_pids(), ledger.pick_donor(0) == pid,
                pid in ledger.loads(), ledger.load_seen(pid),
                pid in ledger._idle, pid in ledger._caches]
        caches[0].add_job(make_job(p, "hj", "qa", 3,
                                   p.api.PodGroupPhase.INQUEUE))
        rc = p.fed.RebalanceController(0, pm, ledger, caches[0],
                                       epoch_fn=lambda: 0, time_fn=clock,
                                       min_depth=1, min_gap=1, ratio=1.0)
        out += [rc.step(now=clock()), dict(pm.draining), list(rc.moves)]
        return out

    assert both(scenario) == [True, True, True, None, False, False, False,
                              None, False, False, None, {}, []]


# ---------------------------------------------------------------------------
# the shared journal: one follower, many partitions' intents
# ---------------------------------------------------------------------------

def test_follower_seeds_across_multiple_partitions_open_intents():
    """A warm standby tailing the SHARED journal resolves acks for open
    intents that predate its subscription, from EVERY partition."""
    def scenario(p):
        journal = p.journal.IntentJournal()
        observer = make_cache(p, n_nodes=4, owner_jobs=[("j0", "qa", 1),
                                                        ("j1", "qb", 1)])
        t0 = observer.jobs["j0"].tasks["j0-0"]
        t1 = observer.jobs["j1"].tasks["j1-0"]
        s0 = journal.record_intent("bind", t0, "n0", epoch=3)
        s1 = journal.record_intent("bind", t1, "n1", epoch=7)
        follower = p.journal.JournalFollower(observer)
        follower.attach(journal)
        seeded = {i.seq for i in journal.unacked()} == {s0, s1}
        journal.ack(s0, ok=True)
        journal.ack(s1, ok=True)
        j0 = observer.jobs["j0"].tasks["j0-0"]
        j1 = observer.jobs["j1"].tasks["j1-0"]
        return (seeded, follower.applied, j0.status.name, j0.node_name,
                j1.status.name, "j0-0" in observer.nodes["n0"].tasks,
                "j1-0" in observer.nodes["n1"].tasks)

    assert both(scenario) == (True, 2, "BOUND", "n0", "BOUND", True, True)


def test_control_records_flow_to_subscribers_and_survive_recovery(
        tmp_path):
    def scenario(p, path):
        journal = p.journal.IntentJournal(path)
        records = []
        journal.subscribe(records.append)
        seq = journal.record_control("reserve", {"rid": 1, "frm": 0,
                                                 "to": 1, "epoch_from": 2,
                                                 "epoch_to": 5})
        kind = records[-1]["kind"], records[-1]["seq"] == seq
        journal.close()
        # recovery skips control records; the sequence continues past
        reopened = p.journal.IntentJournal(path)
        t = p.api.TaskInfo(uid="t", name="t", job="j",
                           resreq=p.api.Resource(1, 1))
        out = (kind, len(reopened.unacked()),
               reopened.record_intent("bind", t, "n0") == seq + 1)
        reopened.close()
        return out

    got = scenario(JAX, str(tmp_path / "jax.jsonl"))
    assert scenario(PORT, str(tmp_path / "port.jsonl")) == got
    assert got == (("reserve", True), 0, True)


def test_healthz_detail_federation_section():
    def scenario(p):
        p.metrics.reset_local()
        try:
            detail = p.metrics.health_detail()
            out = [detail["federation"],
                   detail["cross_partition_reserves_total"]]
            p.metrics.set_partition_leader(2, True, epoch=4,
                                           detail={"queues": 3, "nodes": 5})
            p.metrics.register_cross_partition_reserve("granted")
            p.metrics.set_partition_count(4)
            detail = p.metrics.health_detail()
            return out + [detail["federation"],
                          detail["cross_partition_reserves_total"],
                          detail["partition_count"]]
        finally:
            p.metrics.reset_local()

    got = both(scenario)
    assert got[0] == {"enabled": False} and got[1] == {}
    assert got[2]["enabled"] is True and got[2]["partition_count"] == 4
    assert got[2]["2"] == {"leading": True, "epoch": 4, "queues": 3,
                           "nodes": 5}
    assert got[3] == {"granted": 1.0} and got[4] == 4


# ---------------------------------------------------------------------------
# the load-driven rebalancer
# ---------------------------------------------------------------------------

class Rebalancing:
    """Two partitions, four queues round-robin (p0: q1, q3; p1: q2, q4),
    a controller each on one fake clock."""

    def __init__(self, p, n=2, queues=("q1", "q2", "q3", "q4")):
        self.p = p
        self.t = [0.0]
        self.pmap = p.fed.PartitionMap(n)
        for q in queues:
            self.pmap.register_queue(q)
        self.ledger = p.fed.ReserveLedger(self.pmap,
                                          time_fn=lambda: self.t[0])
        self.caches = [p.cache.SchedulerCache(default_queue=None)
                       for _ in range(n)]
        self.ctrls = [p.fed.RebalanceController(
            pid, self.pmap, self.ledger, self.caches[pid],
            epoch_fn=lambda: 1, time_fn=lambda: self.t[0], min_depth=8,
            min_gap=8, ratio=2.0, cooldown_s=8.0, max_cooldown_s=64.0)
            for pid in range(n)]

    def pend(self, pid, queue, name, tasks):
        self.caches[pid].add_job(make_job(self.p, name, queue, tasks,
                                          self.p.api.PodGroupPhase.INQUEUE))


def test_hot_partition_moves_biggest_helpful_queue():
    def scenario(p):
        f = Rebalancing(p)
        # p0 owns q1 and q3, both loaded; p1 idle
        f.pend(0, "q1", "hot1", 12)
        f.pend(0, "q3", "hot3", 10)
        f.ctrls[1].step()                  # p1 publishes pending=0
        move = f.ctrls[0].step()
        return move, dict(f.pmap.draining)

    move, draining = both(scenario)
    assert move is not None
    assert move["queue"] == "q3" and move["to"] == 1, \
        "the largest depth <= gap/2 moves (q3=10 <= 22/2)"
    assert draining == {"q3": 1}           # the journaled funnel engaged


def test_below_hysteresis_never_moves():
    def scenario(p):
        f = Rebalancing(p)
        f.pend(0, "q1", "j", 6)            # below min_depth
        f.ctrls[1].step()
        return f.ctrls[0].step(), dict(f.pmap.draining)

    assert both(scenario) == (None, {})


def test_last_queue_never_moves():
    def scenario(p):
        f = Rebalancing(p, queues=("q1", "q2"))
        f.pend(0, "q1", "hot", 50)         # p0 owns only q1
        f.ctrls[1].step()
        return f.ctrls[0].step()

    assert both(scenario) is None


def test_no_ping_pong_under_oscillating_load():
    """50 cycles of load oscillating between the two partitions inside the
    hysteresis band: no move."""
    def scenario(p):
        f = Rebalancing(p)
        f.pend(0, "q1", "a", 10)
        f.pend(1, "q2", "b", 9)
        for cycle in range(50):
            f.t[0] = float(cycle)
            f.ctrls[cycle % 2].step()
            f.ctrls[(cycle + 1) % 2].step()
        return (f.ctrls[0].moves, f.ctrls[1].moves, dict(f.pmap.draining),
                [c.abstentions for c in f.ctrls])

    moves0, moves1, draining, _ = both(scenario)
    assert moves0 == [] and moves1 == [] and draining == {}


def test_flap_guard_doubles_abstention_window():
    def scenario(p):
        ctrl = Rebalancing(p).ctrls[0]
        out = []
        for now in (0.0, 10.0, 30.0):
            ctrl._note_move("q1", now=now)
            out.append(ctrl._queue_block["q1"])
        return out

    assert both(scenario) == pytest.approx([8.0, 26.0, 62.0])


def test_received_queue_gets_settle_window():
    """A queue that just arrived from another partition's move may not be
    moved on before its settle window: the hop-chain guard."""
    def scenario(p):
        f = Rebalancing(p)
        ctrl = f.ctrls[1]
        ctrl.step()                        # the baseline ownership
        f.ledger.move_queue("q1", 1, epoch=1)
        f.pmap._transfer_queue_raw("q1", 1)  # a direct settle
        f.t[0] = 1.0
        ctrl.step()
        return ctrl._flap_blocked("q1", now=2.0), \
            ctrl._flap_blocked("q1", now=20.0)

    assert both(scenario) == (True, False)


def test_draining_first_move_blocks_second_to_zero_queues():
    """A two-queue partition whose first move still drains must not move
    its second queue: both settling would leave it owning no queue."""
    def scenario(p):
        f = Rebalancing(p)
        f.pend(0, "q1", "hot1", 40)
        f.pend(0, "q3", "hot3", 30)
        f.ctrls[1].step()
        first = f.ctrls[0].step()
        f.t[0] = 1.0
        f.ctrls[1].step()
        return first, f.ctrls[0].step(), list(f.pmap.draining)

    first, second, draining = both(scenario)
    assert first is not None and second is None
    assert draining == [first["queue"]]


def test_silent_partition_is_not_a_move_target():
    """A partition that never published, or went stale past the freshness
    horizon, does not read as pending=0."""
    def scenario(p):
        f = Rebalancing(p)
        f.pend(0, "q1", "hot1", 12)
        f.pend(0, "q3", "hot3", 10)
        out = [f.ctrls[0].step()]          # p1 NEVER published
        f.ctrls[1].step()
        f.t[0] = f.ctrls[0].stale_after_s + 1.0
        out.append(f.ctrls[0].step())      # p1 went silent
        f.ctrls[1].step()
        out.append(f.ctrls[0].step() is not None)
        return out

    assert both(scenario) == [None, None, True]


def test_rebalance_detail_published_to_health_detail():
    """The rebalancer publishes its state and counts its decisions (the
    JAX package's vcctl verb reads the same detail)."""
    def scenario(p):
        p.metrics.reset_local()
        try:
            f = Rebalancing(p)
            f.pend(0, "q1", "hot1", 12)
            f.pend(0, "q3", "hot3", 10)
            f.ctrls[1].step()
            f.ctrls[0].step()
            moved = {k: v for k, v in p.metrics.local_counters().items()
                     if k[0] == "rebalance_moves"}
            return moved, p.metrics.health_detail()["overload"]["rebalance"]
        finally:
            p.metrics.reset_local()

    moved, detail = both(scenario)
    assert moved[("rebalance_moves", "moved")] == 1.0
    assert detail["0"]["moves"] == 1


# ---------------------------------------------------------------------------
# the store-backed transport: PartitionState over the CAS/watch path
# ---------------------------------------------------------------------------

def make_store_backed(p, clock, n=2, nodes_each=2, journal=None):
    """A map and ledger MIRROR a partition over one shared store (the
    multi-process topology)."""
    store = p.store.ObjectStore()
    reg = p.exec.FencingRegistry()
    backends, maps, ledgers, caches = [], [], [], []
    for pid in range(n):
        backend = p.fed.StorePartitionBackend(store, n)
        pm = p.fed.StoreBackedPartitionMap(backend)
        ledger = p.fed.StoreBackedReserveLedger(
            pm, backend, journal=journal, registry=reg, time_fn=clock,
            timeout_s=8.0)
        cache = make_cache(p, n_nodes=0, journal=journal)
        ledger.attach_cache(pid, cache)
        backends.append(backend)
        maps.append(pm)
        ledgers.append(ledger)
        caches.append(cache)
    for i in range(n * nodes_each):
        name = f"n{i}"
        maps[0].register_node(name)
        for cache in caches:
            alloc = p.api.Resource(16000, 32 * GI)
            alloc.max_task_num = 110
            cache.add_node(p.api.NodeInfo(name=name, allocatable=alloc))
    return store, reg, backends, maps, ledgers, caches


def test_mirrors_converge_and_match_in_process_round_robin():
    def scenario(p):
        store, reg, backends, maps, ledgers, caches = \
            make_store_backed(p, FakeClock(), n=3, nodes_each=0)
        oracle = p.fed.PartitionMap(3)
        for q in ("q1", "q2", "q3", "q4"):
            maps[0].register_queue(q)
            oracle.register_queue(q)
        for nd in ("n0", "n1", "n2"):
            maps[1].register_node(nd)
            oracle.register_node(nd)
        out = [all(pm.queue_owner == oracle.queue_owner
                   and pm.node_owner == oracle.node_owner for pm in maps)]
        # idempotent re-registration writes nothing (version stable)
        v = maps[0].version
        out += [maps[2].register_queue("q2") == oracle.queue_owner["q2"],
                maps[0].version == v]
        # a late mirror (a restarted partition) rebuilds from the store
        late = p.fed.StoreBackedPartitionMap(
            p.fed.StorePartitionBackend(store, 3))
        out += [late.queue_owner == oracle.queue_owner,
                late.node_owner == oracle.node_owner]
        return out, dict(oracle.queue_owner)

    out, owners = both(scenario)
    assert all(out)


def test_reserve_protocol_end_to_end_over_the_store():
    def scenario(p):
        p.metrics.reset_local()
        journal = p.journal.IntentJournal()
        store, reg, backends, maps, ledgers, caches = \
            make_store_backed(p, FakeClock(), journal=journal)
        reg.authority(0).advance(3)
        reg.authority(1).advance(5)
        # the REQUESTER files through ITS ledger, the OWNER's mirror sees
        # it through the watch
        rid = ledgers[0].request(frm=0, to=1, cpu=4000, mem=GI,
                                 epoch_from=3)
        seen = ledgers[1].requests[rid].state
        ledgers[1].review(pid=1, epoch=5)
        req = ledgers[1].find(rid)
        out = [rid is not None, seen, req.state,
               [pm.owner_of_node(req.node) for pm in maps],
               [req.node in pm.pinned for pm in maps],
               rid in ledgers[0].requests,
               p.metrics.local_counters().get(
                   ("cross_partition_reserves", "granted"), 0)]
        p.metrics.reset_local()
        return out

    got = both(scenario)
    assert got[:3] == [True, "requested", "granted"]
    # ownership converged on EVERY mirror, the pin released everywhere,
    # and the settled request left the requester's open set
    assert got[3] == [0, 0] and got[4] == [False, False] and not got[5]
    assert got[6] >= 1


def test_published_idle_flows_through_the_cr():
    def scenario(p):
        store, reg, backends, maps, ledgers, caches = \
            make_store_backed(p, FakeClock(), n=3)
        ledgers[1].publish_idle(1, 5000.0, GI)
        ledgers[2].publish_idle(2, 9000.0, GI)
        return ledgers[0].pick_donor(0)

    assert both(scenario) == 2


def test_cas_conflicts_retry_and_converge():
    def scenario(p):
        store = p.store.ObjectStore()
        inj = p.chaos.StoreFaultInjector(failure_rate=0.4, seed=9,
                                         conflict_share=1.0,
                                         latency_share=0.0)
        transport = p.transport.RetryingStoreTransport(
            p.transport.FaultyStoreTransport(store, inj),
            sleep_fn=lambda s: None, rng=random.Random(0))
        backend = p.fed.StorePartitionBackend(transport, 2)
        pm = p.fed.StoreBackedPartitionMap(backend)
        oracle = p.fed.PartitionMap(2)
        for i in range(20):
            pm.register_node(f"n{i}")
            oracle.register_node(f"n{i}")
        return pm.node_owner == oracle.node_owner, backend.cas_conflicts

    same, conflicts = both(scenario)
    assert same and conflicts > 0


def test_failed_flip_leaves_pin_and_expiry_releases():
    """An ownership flip whose CAS cannot land does NOT half-apply: the
    pin stays (on the object and every mirror) and deadline expiry
    releases it."""
    def scenario(p):
        clock = FakeClock()
        journal = p.journal.IntentJournal()
        store, reg, backends, maps, ledgers, caches = \
            make_store_backed(p, clock, journal=journal)
        ledgers[0].request(frm=0, to=1, cpu=4000, mem=GI, epoch_from=1)
        owner_map = maps[1]
        real = owner_map.backend.mutate

        def broken(fn):
            raise RuntimeError("store down at flip time")

        owner_map.backend.mutate = broken
        try:
            with pytest.raises(RuntimeError):
                ledgers[1].review(pid=1, epoch=1)
        finally:
            owner_map.backend.mutate = real
        (rid, req), = ledgers[1].requests.items()
        out = [req.state, bool(req.node),
               [pm.owner_of_node(req.node) for pm in maps]]
        clock.advance(9.0)
        out += [ledgers[0].expire(),          # ANY partition's cycle
                [req.node in pm.pinned for pm in maps],
                [pm.owner_of_node(req.node) for pm in maps]]
        return out

    assert both(scenario) == ["granting", True, [1, 1], 1, [False, False],
                              [1, 1]]


def test_torn_partition_state_stream_heals_on_sync():
    def scenario(p):
        store, reg, backends, maps, ledgers, caches = \
            make_store_backed(p, FakeClock())
        backends[1]._watch.tear()
        rid = ledgers[0].request(frm=0, to=1, cpu=4000, mem=GI,
                                 epoch_from=1)
        # the owner's mirror is stale: it reviews nothing this cycle
        out = [rid in ledgers[1].requests]
        ledgers[1].review(pid=1, epoch=1)
        out.append(ledgers[0].requests[rid].state)
        # the cycle-start sync heals it
        maps[1].sync()
        out.append(rid in ledgers[1].requests)
        ledgers[1].review(pid=1, epoch=1)
        out.append(ledgers[1].find(rid).state)
        return out

    assert both(scenario) == [False, "requested", True, "granted"]


def test_reconcile_leaves_another_partitions_crash_window():
    """Partition 1's first handoff reconciles the shared journal while
    partition 0's bind intent is still open (partition 0 died mid-funnel).
    The JAX package settles it as stale: partition 0's own handoff then has
    nothing to repair. The port leaves an intent that another partition's
    cache journaled open, and partition 0's handoff repairs it. The intent
    carries its partition with the lifecycle timeline off."""
    def scenario(p):
        journal = p.journal.IntentJournal()
        owner = make_cache(p, n_nodes=2, owner_jobs=[("j0", "qa", 1)],
                           journal=journal)
        other = make_cache(p, n_nodes=2, journal=journal)
        owner.partition, other.partition = 0, 1
        task = owner.jobs["j0"].tasks["j0-0"]
        seq = owner._journal_intent("bind", task, "n0", sync=False)
        first = p.journal.reconcile(other, journal).as_dict()
        still_open = [i.seq for i in journal.unacked()]
        second = p.journal.reconcile(owner, journal,
                                     cluster_binds={"j0-0": "n0"}).as_dict()
        return first, still_open == [seq], second

    from volcano_tpu_torch.obs import TIMELINE
    jax_first, jax_open, jax_second = scenario(JAX)
    assert jax_first["stale"] == 1 and not jax_open
    assert jax_second["replayed"] == 0
    enabled, TIMELINE.enabled = TIMELINE.enabled, False
    try:
        first, still_open, second = scenario(PORT)
    finally:
        TIMELINE.enabled = enabled
    assert first["replayed"] == 0 and still_open
    assert second["replayed"] == 1 and second["repaired_binds"] == 1
