"""The object store and the feedback watch path of volcano_tpu_torch,
held to the JAX package's on the same call sequences: ``store`` (resource
versions, watch events, backlog resume, 410 Gone, bookmarks, 409
payloads), ``store_transport`` (the seeded faulty transport, the retrying
funnel and its counters), ``cache/watches`` (resumable informers, the 410
relist, the manager's upkeep), ``cache/store_wiring`` (a cache fed by
informers over the hostile boundary), ``cache/feedback``'s watch path and
the chaos injectors, and ``sim/store_world``. Each scenario runs once
through each package and the two records must be equal; the scenarios
follow tests/test_store_transport.py, test_feedback.py and
test_resync_churn.py. All of it is host code: nothing here touches a
device.
"""

import random
import types

import pytest

import volcano_tpu.api as jax_api
import volcano_tpu.apis.objects as jax_objects
import volcano_tpu.cache as jax_cache
import volcano_tpu.cache.executors as jax_executors
import volcano_tpu.cache.store_wiring as jax_wiring
import volcano_tpu.cache.watches as jax_watches
import volcano_tpu.chaos as jax_chaos
import volcano_tpu.metrics as jax_metrics
import volcano_tpu.sim.runner as jax_runner
import volcano_tpu.sim.store_world as jax_world
import volcano_tpu.store as jax_store
import volcano_tpu.store_transport as jax_transport
import volcano_tpu_torch.api as pt_api
import volcano_tpu_torch.apis.objects as pt_objects
import volcano_tpu_torch.cache as pt_cache
import volcano_tpu_torch.cache.executors as pt_executors
import volcano_tpu_torch.cache.store_wiring as pt_wiring
import volcano_tpu_torch.cache.watches as pt_watches
import volcano_tpu_torch.chaos as pt_chaos
import volcano_tpu_torch.metrics as pt_metrics
import volcano_tpu_torch.sim.runner as pt_runner
import volcano_tpu_torch.sim.store_world as pt_world
import volcano_tpu_torch.store as pt_store
import volcano_tpu_torch.store_transport as pt_transport

GI = 1 << 30

JAX = types.SimpleNamespace(
    api=jax_api, objects=jax_objects, cache=jax_cache,
    executors=jax_executors, wiring=jax_wiring, watches=jax_watches,
    chaos=jax_chaos, metrics=jax_metrics, runner=jax_runner,
    world=jax_world, store=jax_store, transport=jax_transport)
PORT = types.SimpleNamespace(
    api=pt_api, objects=pt_objects, cache=pt_cache,
    executors=pt_executors, wiring=pt_wiring, watches=pt_watches,
    chaos=pt_chaos, metrics=pt_metrics, runner=pt_runner,
    world=pt_world, store=pt_store, transport=pt_transport)


def make_pod(p, name, group="g1", ns="default", cpu=100):
    o = p.objects
    return o.Pod(metadata=o.ObjectMeta(
        name=name, namespace=ns, uid=name, creation_timestamp=1.0,
        annotations={"scheduling.k8s.io/group-name": group}),
        template=o.PodTemplate(resources=p.api.Resource(cpu, 1 << 20)))


def make_pg(p, name, ns="default", min_member=1, phase="Inqueue"):
    o = p.objects
    pg = o.PodGroupCR(metadata=o.ObjectMeta(name=name, namespace=ns,
                                            creation_timestamp=1.0),
                      spec=o.PodGroupSpec(min_member=min_member))
    pg.status.phase = p.api.PodGroupPhase(phase)
    return pg


class Recorder:
    """An rv-aware watch handler recording (event, key, rv)."""

    def __init__(self):
        self.events = []

    def __call__(self, event, obj, old, rv=None):
        key = obj.metadata.key() if obj is not None else None
        self.events.append((event, key, rv))


def _catch(fn):
    """fn()'s result, or its exception's type name and message."""
    try:
        return ("ok", fn())
    except Exception as exc:       # both packages raise the same kinds
        return (type(exc).__name__, str(exc))


# ---------------------------------------------------------------------------
# the scenarios: each takes a package namespace and returns a record
# ---------------------------------------------------------------------------

def s_resource_versions(p):
    s = p.store.ObjectStore()
    rec = Recorder()
    s.watch("Pod", rec, with_rv=True)
    s.watch("PodGroup", rec, with_rv=True)
    out = [s.current_rv()]
    s.create(make_pod(p, "p1"))
    s.create_batch([make_pod(p, f"b{i}") for i in range(3)])
    pg = s.create(make_pg(p, "g1"))
    out.append(_catch(lambda: s.update(pg, expect_rv=1)))
    pg.status.phase = p.api.PodGroupPhase.RUNNING
    s.update_status(pg)
    s.delete("Pod", "default", "b1")
    out.append(_catch(lambda: s.create(make_pod(p, "p1"))))
    objs, rv = s.list_with_rv("Pod")
    out.append((sorted(o.metadata.name for o in objs), rv,
                s.current_rv()))
    s.bind_pod("default", "p1", "n0")
    out.append(s.get("Pod", "default", "p1").status.node_name)
    return {"out": out, "events": rec.events}


def s_resume_and_gone(p):
    s = p.store.ObjectStore(watch_backlog=4)
    rec = Recorder()
    w = s.watch("Pod", rec, with_rv=True)
    s.create(make_pod(p, "p1"))
    last = rec.events[-1][2]
    s.unwatch("Pod", w)
    s.create(make_pod(p, "p2"))
    s.delete("Pod", "default", "p1")
    s.watch("Pod", rec, since_rv=last, with_rv=True)
    rv = s.current_rv()
    for i in range(3, 12):
        s.create(make_pod(p, f"p{i}"))
    gone = _catch(lambda: s.watch("Pod", Recorder(), since_rv=rv,
                                  with_rv=True))
    return {"events": rec.events, "gone": gone,
            "bookmarks": s.emit_bookmarks()}


def s_resumable_watch(p):
    s = p.store.ObjectStore(watch_backlog=4)
    out = []
    for i in range(2):
        s.create(make_pod(p, f"pre{i}"))
    s.delete("Pod", "default", "pre0")
    rec = Recorder()
    w = p.watches.ResumableWatch(s, "Pod", lambda e, o, old: rec(e, o, old))
    s.create(make_pod(p, "keeper"))
    w.tear()
    s.create(make_pod(p, "p2"))
    s.delete("Pod", "default", "pre1")
    out.append((w.torn, w.resume(), w.detail()))
    s.create(make_pod(p, "victim"))
    w.tear()
    s.delete("Pod", "default", "victim")
    for i in range(8):
        s.create(make_pod(p, f"new{i}"))
    out.append((w.resume(), w.resumes, w.relists, w.last_rv,
                w.detail()))
    return {"out": out, "events": rec.events}


def s_relist_updates(p):
    s = p.store.ObjectStore(watch_backlog=2)
    s.create(make_pg(p, "g1", phase="Pending"))
    events = []
    w = p.watches.ResumableWatch(
        s, "PodGroup",
        lambda e, o, old: events.append((e, str(o.status.phase),
                                         old is None)))
    w.tear()
    pg = s.get("PodGroup", "default", "g1")
    pg.status.phase = p.api.PodGroupPhase.INQUEUE
    s.update_status(pg)
    for i in range(4):
        s.create(make_pg(p, f"x{i}"))
        s.delete("PodGroup", "default", f"x{i}")
    outcome = w.resume()
    idle = p.watches.ResumableWatch(s, "Queue", lambda e, o, old: None)
    for i in range(10):
        s.create(make_pod(p, f"q{i}"))
    s.emit_bookmarks()
    return {"events": events, "outcome": outcome,
            "idle_rv": (idle.last_rv, s.current_rv())}


def s_manager_step(p):
    p.metrics.reset_local()
    s = p.store.ObjectStore()
    manager = p.watches.WatchManager(s)
    rec = Recorder()
    w = manager.add("Pod", lambda e, o, old: rec(e, o, old))
    manager.add("Queue", lambda e, o, old: None)
    s.create(make_pod(p, "p1"))
    w.tear()
    s.create(make_pod(p, "p2"))
    stale = manager.staleness()
    stepped = manager.step()
    detail = p.metrics.health_detail()["store"]
    counts = p.metrics.store_counts()
    return {"events": rec.events, "stale": stale, "stepped": stepped,
            "torn": [x.torn for x in manager.watches], "detail": detail,
            "resumes": counts["watch_resumes"]}


def s_faulty_transport(p):
    inj = p.chaos.StoreFaultInjector(failure_rate=0.5, seed=7,
                                     latency_s=0.0, tear_rate=0.05)
    s = p.store.ObjectStore()
    t = p.transport.FaultyStoreTransport(s, inj)
    rec = Recorder()
    handles = [t.watch(k, rec, with_rv=True)
               for k in ("Pod", "PodGroup", "Queue")]
    out = []
    for i in range(30):
        out.append(_catch(lambda: t.create(make_pod(p, f"p{i}")))[0])
    for i in range(10):
        out.append(_catch(lambda: t.update_status(make_pg(p, f"g{i}")))[0])
    torn = t.tear_streams(2, random.Random(5))
    return {"out": out, "injected": dict(inj.injected),
            "attempts": inj.attempts, "events": rec.events,
            "torn_handles": [h.torn for h in handles], "tear": torn,
            "stored": sorted(o.metadata.name for o in s.list("Pod"))}


def s_retrying_transport(p):
    p.metrics.reset_local()
    s = p.store.ObjectStore()
    inj = p.chaos.StoreFaultInjector(failure_rate=0.4, seed=11,
                                     conflict_share=0.0, latency_share=0.2,
                                     latency_s=0.01)
    sleeps = []
    clock = [0.0]

    def sleep(d):
        sleeps.append(round(d, 9))
        clock[0] += d

    inj.sleep_fn = sleep
    t = p.transport.RetryingStoreTransport(
        p.transport.FaultyStoreTransport(s, inj), sleep_fn=sleep,
        time_fn=lambda: clock[0], cycle_budget_s=0.5,
        rng=random.Random(3))
    out = []
    for i in range(40):
        out.append(_catch(lambda: t.create(make_pod(p, f"p{i}")))[0])
        if i % 10 == 9:
            t.new_cycle()
    q = s.create(p.objects.QueueCR(metadata=p.objects.ObjectMeta(name="q")))
    s.update(q)
    out.append(_catch(lambda: t.update(q, expect_rv=1)))
    exhausted = p.transport.RetryingStoreTransport(
        p.transport.FaultyStoreTransport(s, p.chaos.StoreFaultInjector(
            failure_rate=1.0, seed=2, conflict_share=0.0,
            latency_share=0.0)),
        max_attempts=3, sleep_fn=lambda d: None, rng=random.Random(0))
    out.append(_catch(lambda: exhausted.create(make_pod(p, "x"))))
    return {"out": out, "sleeps": sleeps, "retries": t.retries,
            "exhausted": (t.exhausted, exhausted.exhausted),
            "counts": p.metrics.store_counts(),
            "stored": len(s.list("Pod"))}


def _wired(p, fault_rate=0.0, seed=5, tear_rate=0.0):
    s = p.store.ObjectStore()
    inj = p.chaos.StoreFaultInjector(failure_rate=fault_rate, seed=seed,
                                     latency_s=0.0, tear_rate=tear_rate)
    faulty = p.transport.FaultyStoreTransport(s, inj)
    transport = p.transport.RetryingStoreTransport(
        faulty, sleep_fn=lambda d: None, rng=random.Random(seed))
    cache = p.wiring.wire_cache_to_store(transport)
    return s, faulty, transport, cache


def _cache_state(cache):
    return {
        "jobs": {uid: (j.queue, j.min_available, str(j.podgroup.phase)
                       if j.podgroup is not None else None,
                       sorted((t.uid, str(t.status), t.node_name)
                              for t in j.tasks.values()))
                 for uid, j in sorted(cache.jobs.items())},
        "queues": sorted((q.name, q.weight) for q in cache.queues.values()),
        "nodes": {n: sorted(node.tasks) for n, node in cache.nodes.items()},
    }


def s_wired_cache(p):
    s, faulty, transport, cache = _wired(p)
    alloc = p.api.Resource(4000, 8 * GI)
    alloc.max_task_num = 10
    cache.add_node(p.api.NodeInfo(name="n1", allocatable=alloc))
    transport.create(p.objects.QueueCR(metadata=p.objects.ObjectMeta(
        name="q1"), spec=p.objects.QueueSpecCR(weight=3)))
    transport.create(p.objects.PriorityClass(
        metadata=p.objects.ObjectMeta(name="hi"), value=7))
    transport.create(make_pg(p, "g1"))
    transport.create(make_pod(p, "m1", group="g1"))
    transport.create(make_pod(p, "m2", group="g2"))   # before its group
    transport.create(make_pg(p, "g2", min_member=2))
    before = _cache_state(cache)
    task = cache.jobs["default/g1"].tasks["m1"]
    pod_stream = [w for w in cache.watch_manager.watches
                  if w.kind == "Pod"][0]
    pod_stream.tear()
    clone = task.clone()
    clone.node_name = "n1"
    cache.bind(clone)
    torn = (s.get("Pod", "default", "m1").status.phase, str(task.status))
    stepped = cache.watch_manager.step()
    after = _cache_state(cache)
    used = cache.nodes["n1"].used.cpu
    s.delete("PodGroup", "default", "g2")
    s.delete("Pod", "default", "m2")
    return {"before": before, "torn": torn, "stepped": stepped,
            "after": after, "used": used, "end": _cache_state(cache),
            "kinds": [w.kind for w in cache.watch_manager.watches]}


def s_wired_cache_under_faults(p):
    s, faulty, transport, cache = _wired(p, fault_rate=0.2)
    ok = []
    for i in range(30):
        r = _catch(lambda: (transport.create(make_pg(p, f"grp{i}")),
                            transport.create(make_pod(p, f"p{i}",
                                                      group=f"grp{i}"))))
        if r[0] == "ok":
            ok.append(i)
    cache.watch_manager.step()
    for i in ok:
        for _ in range(10):
            if _catch(lambda: transport.delete("Pod", "default",
                                               f"p{i}"))[0] == "ok":
                break
    cache.watch_manager.step()
    return {"ok": ok, "state": _cache_state(cache),
            "live": sorted(o.metadata.name for o in s.list("Pod")),
            "injected": dict(faulty.injector.injected),
            "retries": (transport.retries, transport.exhausted)}


def s_feedback_watch_path(p):
    """Store-wired RUNNING acks through the channel with a scripted
    injector: drop, delay, duplicate, stale, reorder, then delivery on the
    injectable clock."""
    s, faulty, transport, cache = _wired(p)
    alloc = p.api.Resource(8000, 8 * GI)
    alloc.max_task_num = 10
    cache.add_node(p.api.NodeInfo(name="n1", allocatable=alloc))
    transport.create(make_pg(p, "g1", min_member=1))
    for i in range(6):
        transport.create(make_pod(p, f"m{i}", group="g1"))

    class Plan:
        delay_s = 2.5
        stale_delay_s = 6.5

        def __init__(self, kinds):
            self.kinds = list(kinds)

        def roll(self, kind):
            return self.kinds.pop(0) if self.kinds else None

    clock = [0.0]
    cache.feedback.attach_injector(
        Plan(["drop", "delay", "duplicate", "stale", "reorder", None]),
        lambda: clock[0])
    for i in range(6):
        task = cache.jobs["default/g1"].tasks[f"m{i}"].clone()
        task.node_name = "n1"
        cache.bind(task)
    out = [(_cache_state(cache), cache.feedback.pending())]
    for step in (1.0, 2.0, 5.0):
        clock[0] = step
        out.append((cache.feedback.deliver_due(), cache.feedback.pending()))
    out.append(_cache_state(cache))
    counts = {f"{k}/{v}": n for (k, v), n in cache.feedback.counts.items()}
    return {"out": out, "counts": counts}


def s_injectors(p):
    ack = p.chaos.AckFaultInjector(failure_rate=0.6, seed=13)
    kinds = [ack.roll("running" if i % 3 else "evicted") for i in range(200)]
    store = p.chaos.StoreFaultInjector(failure_rate=0.3, seed=17,
                                       latency_s=0.0, tear_rate=0.1)
    verbs = ("get", "list", "create", "update", "bind_pod", "evict_pod")
    rolls = [store.roll(verbs[i % len(verbs)]) for i in range(300)]
    tears = [store.roll_tear() for _ in range(50)]
    dev = p.chaos.DeviceFaultInjector({"oom": [2], "device_lost": [4]},
                                      seed=3)
    dev_out = [_catch(lambda: dev("tpu-fused")) for _ in range(5)]
    rate = p.chaos.DeviceFaultInjector({"oom": (), "device_lost": ()},
                                       failure_rate=0.5, seed=9)
    rate_out = [_catch(lambda: rate("tpu-fused"))[0] for _ in range(20)]

    class Sink(p.executors.StatusUpdater):
        def __init__(self):
            self.seen = []

        def update_pod_group(self, job):
            self.seen.append(job)

    css = p.chaos.ChaosStatusUpdater(Sink(), failure_rate=0.4, seed=4)
    css_out = [_catch(lambda: css.update_pod_group(i))[0]
               for i in range(20)]
    return {"ack": kinds, "ack_injected": ack.injected,
            "store": rolls, "tears": tears,
            "store_injected": store.injected, "dev": dev_out,
            "dev_injected": dev.injected, "rate": rate_out,
            "css": css_out, "css_seen": css.inner.seen}


def s_ack_wire(p):
    """The direct mode's ack wire under a scripted plan (the JAX package's
    test_ack_wire_drop_dup_delay_stale and the adjacent-swap reorder)."""
    class Plan:
        delay_s = 2.5
        stale_delay_s = 6.5

        def __init__(self, kinds):
            self.kinds = list(kinds)

        def roll(self, kind):
            return self.kinds.pop(0) if self.kinds else None

    clock = p.runner.VirtualClock()
    wire = p.runner._AckWire(clock, Plan(
        ["drop", "duplicate", "delay", "stale", "reorder", None]))
    for uid in "abcdef":
        wire.offer("running", uid, "n0")
    out = [wire.due(clock.time())]
    for dt in (2.5, 4.0):
        clock.sleep(dt)
        out.append(wire.due(clock.time()))
    return {"out": out, "pending": wire.pending(),
            "delivered": wire.delivered}


def s_store_world(p):
    """The store-wired sim's world: seeded submissions over the faulted
    transport, a torn-stream drill, the controller's recreate, a node's
    pods, a gang's completion."""
    p.metrics.reset_local()
    clock = p.runner.VirtualClock()
    world = p.world.StoreWorld(clock, fault_rate=0.3, fault_seed=4,
                               latency_s=0.05, retry_rng_seed=4)
    cache, binder, evictor = world.build_cache(0)
    alloc = p.api.Resource(16000, 64 * GI)
    alloc.max_task_num = 50
    cache.add_node(p.api.NodeInfo(name="n0", allocatable=alloc))
    pending, out = [], []
    for q in ("q1", "q2"):
        thunk = world.submit_queue(0, {"name": q, "weight": 2})
        out.append(_catch(thunk)[0])
        pending.append(thunk)
    for j in range(6):
        d = {"name": f"job-{j}", "tasks": 3, "cpu_milli": 1000,
             "mem": GI, "gpus": 0, "priority": j % 3, "queue": "q1",
             "min_available": 3, "duration": 5.0}
        thunk = world.submit_job(0, float(j), d)
        out.append(_catch(thunk)[0])
        pending.append(thunk)
    for _ in range(5):
        out.append([_catch(t)[0] for t in pending])
        cache.watch_manager.step()
    task = cache.jobs["default/job-0"].tasks["job-0-0"].clone()
    task.node_name = "n0"
    cache.bind(task)
    tear = world.tear_streams(2, random.Random(1))
    cache.watch_manager.step()
    on_node = world.pods_on_node("n0")
    world.delete_pod("job-0-0")
    recreated = (world.recreate_pod("job-0-0"), world.recreate_pod("job-0-0"))
    world.complete_job("default/job-1", ["job-1-0", "job-1-1", "job-1-2"])
    cache.watch_manager.step()
    return {"out": out, "tear": tear, "on_node": on_node,
            "recreated": recreated, "faults": world.faults_detail(),
            "retry": world.retry_detail(), "state": _cache_state(cache),
            "binds": list(world.bind_witness.sequence),
            "clock": clock.time(), "counts": p.metrics.store_counts()}


SCENARIOS = {name[2:]: fn for name, fn in sorted(globals().items())
             if name.startswith("s_") and callable(fn)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_store_modules_equal_jax(name):
    fn = SCENARIOS[name]
    want = fn(JAX)
    got = fn(PORT)
    assert got == want


def test_scenarios_are_not_vacuous():
    """Faults fire and events flow in the scenarios that inject them."""
    rec = s_faulty_transport(PORT)
    assert rec["injected"] and rec["events"] and any(rec["torn_handles"])
    assert set(s_retrying_transport(PORT)["out"][:40]) == {"ok"}
    fb = s_feedback_watch_path(PORT)
    assert fb["counts"].get("running/duplicate") \
        and fb["out"][0][1] > 0
    world = s_store_world(PORT)
    assert world["faults"] and world["tear"] and world["recreated"] == (
        True, False)


@pytest.fixture(scope="module")
def jax_quota(tmp_path_factory):
    import torch_parity as tp
    return tp.jax_reference("quota", tp.QUOTA_CASES,
                            tmp_path_factory.mktemp("quota") / "jax.pkl")


@pytest.mark.parametrize("case", ["weights-1-3", "weights-3-1", "no-quota",
                                  "largest-of-two", "deleted"])
def test_resource_quota_sets_the_namespace_weight(jax_quota, case):
    """A ResourceQuota reaching a store-fed cache sets its namespace's
    weight (the largest of the namespace's quotas; a deleted one no
    longer counts), and drf's namespace order under allocate-tpu then
    binds what the JAX package binds, in its order."""
    import torch_parity as tp
    got = tp.quota_run(True, case)
    want = jax_quota[case]
    assert got["weights"] == want["weights"]
    assert got["binds"] == want["binds"]
    writes = {(ns, q): w for ns, q, w in tp.QUOTA_CASES[case]}
    for ns in ("ns-a", "ns-b"):
        live = [w for (n, _), w in writes.items() if n == ns and w]
        assert got["weights"][ns] == (max(live) if live else 1)


def test_namespace_order_follows_the_weights():
    """The weights reach the solve's job order: with ns-b at three times
    ns-a's weight the cycle binds in another order than with the default
    weights."""
    import torch_parity as tp
    heavy = tp.quota_run(True, "weights-1-3")["binds"]
    flat = tp.quota_run(True, "no-quota")["binds"]
    assert heavy and flat and heavy != flat