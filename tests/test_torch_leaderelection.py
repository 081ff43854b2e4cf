"""Leader election over the store lease in volcano_tpu_torch
(``leaderelection.py``), held to the JAX package's: the port of
tests/test_leaderelection.py (the native store's CAS and the verb parsers
wait for the rest of the control plane). Where a scenario is
deterministic (a fake clock, scripted steps), it runs once through each
package's classes and the two records must be equal; the threaded drives
run the port alone, and the last one runs two port Schedulers over one
port store, each under ``run_with_leader_election``.
"""

import random
import threading
import time
import types

import pytest

import volcano_tpu.apis.objects as jax_objects
import volcano_tpu.chaos as jax_chaos
import volcano_tpu.leaderelection as jax_le
import volcano_tpu.store as jax_store
import volcano_tpu.store_transport as jax_transport
import volcano_tpu_torch.apis.objects as pt_objects
import volcano_tpu_torch.chaos as pt_chaos
import volcano_tpu_torch.leaderelection as pt_le
import volcano_tpu_torch.store as pt_store
import volcano_tpu_torch.store_transport as pt_transport

JAX = types.SimpleNamespace(le=jax_le, store=jax_store, chaos=jax_chaos,
                            objects=jax_objects, transport=jax_transport)
PORT = types.SimpleNamespace(le=pt_le, store=pt_store, chaos=pt_chaos,
                             objects=pt_objects, transport=pt_transport)


class _Clock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, d):
        self.t += d


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` through each package; the records must
    be equal. Returns the port's."""
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def elector(p, store, ident, name="x", **kw):
    return p.le.LeaderElector(store, name, on_started_leading=lambda: None,
                              identity=ident, **kw)


def lease_of(store, name="x"):
    lease = store.get("Lease", "volcano-system", name)
    return None if lease is None else (lease.holder, lease.epoch)


# ---------------------------------------------------------------------------
# the threaded RunOrDie loop (the port's own)
# ---------------------------------------------------------------------------

def test_single_replica_acquires_and_runs():
    store = pt_store.ObjectStore()
    ran = threading.Event()
    el = pt_le.LeaderElector(store, "vc-scheduler",
                             on_started_leading=ran.set)
    el.run()
    assert ran.is_set()
    lease = store.get("Lease", "volcano-system", "vc-scheduler")
    assert lease.holder == el.identity and lease.epoch == 1


def test_second_replica_blocks_until_lease_expires():
    store = pt_store.ObjectStore()
    a = pt_le.LeaderElector(store, "vc-scheduler",
                            on_started_leading=lambda: None, identity="a",
                            lease_duration=0.2, retry_period=0.02)
    assert a.try_acquire_or_renew()
    b_started = threading.Event()
    b = pt_le.LeaderElector(store, "vc-scheduler",
                            on_started_leading=b_started.set,
                            identity="b", lease_duration=0.2,
                            retry_period=0.02)
    assert not b.try_acquire_or_renew()      # a holds a fresh lease
    t = threading.Thread(target=b.run, daemon=True)
    t.start()
    assert not b_started.wait(0.05)          # still blocked
    # a stops renewing; its lease expires and b takes over
    assert b_started.wait(2.0)
    lease = store.get("Lease", "volcano-system", "vc-scheduler")
    assert lease.holder == "b" and lease.epoch == 2
    b.stop()
    t.join(timeout=2)


def test_renew_loop_loses_the_lease_past_its_deadline():
    """The threaded renewer: once another holder owns a live lease, the
    renewals fail and past the renew deadline (monotonic) the leader
    stops, fires on_lease_lost and on_stopped_leading, and opens the flap
    cool-down."""
    store = pt_store.ObjectStore()
    lost, stopped = threading.Event(), threading.Event()
    leading = threading.Event()
    guard = pt_le.FlapGuard(cooldown_s=30.0)

    def started():
        # the component loop: runs until the lease is lost
        leading.set()
        stopped.wait(5.0)

    a = pt_le.LeaderElector(store, "x", on_started_leading=started,
                            on_stopped_leading=stopped.set,
                            on_lease_lost=lost.set, identity="a",
                            lease_duration=0.2, renew_deadline=0.1,
                            retry_period=0.02, flap_guard=guard)
    t = threading.Thread(target=a.run, daemon=True)
    t.start()
    assert leading.wait(2.0)                  # acquired, renewing
    assert a.leading and a.fencing_epoch == 1
    # a foreign holder takes the lease over with a long lease
    lease = store.get("Lease", "volcano-system", "x")
    store.update(pt_le.Lease(
        metadata=pt_objects.ObjectMeta(name="x", namespace="volcano-system"),
        holder="b", renew_time=time.time(), lease_duration=60.0,
        epoch=lease.epoch + 1),
        expect_rv=lease.metadata.resource_version)
    assert lost.wait(2.0) and stopped.wait(2.0)
    t.join(timeout=2)
    assert not t.is_alive()
    assert not a.leading and a.fencing_epoch == 1
    assert guard.total_losses == 1 and not guard.may_contend()


def test_leader_loses_expired_lease_to_challenger():
    def scenario(p):
        clock = _Clock(100.0)
        store = p.store.ObjectStore()
        a = elector(p, store, "a", lease_duration=0.1, time_fn=clock,
                    mono_fn=clock)
        out = [a.try_acquire_or_renew()]
        clock.advance(0.15)
        b = elector(p, store, "b", lease_duration=0.1, time_fn=clock,
                    mono_fn=clock)
        out.append(b.try_acquire_or_renew())     # takeover after expiry
        out.append(a.try_acquire_or_renew())     # a lost it
        out.append(lease_of(store))
        out.append(b.takeovers)
        return out
    assert both(scenario) == [True, True, False, ("b", 2), 1]


def test_racing_challengers_cannot_both_win():
    """Two challengers racing on an expired lease read the same stale
    resourceVersion; only the first CAS write wins, the loser's update
    conflicts and it must NOT start leading."""
    def scenario(p):
        clock = _Clock(10.0)
        store = p.store.ObjectStore()
        dead = elector(p, store, "dead", lease_duration=0.01,
                       time_fn=clock, mono_fn=clock)
        assert dead.try_acquire_or_renew()
        clock.advance(0.05)                        # the lease expires
        a = elector(p, store, "a", lease_duration=10, time_fn=clock,
                    mono_fn=clock)
        b = elector(p, store, "b", lease_duration=10, time_fn=clock,
                    mono_fn=clock)
        stale = store.get("Lease", "volcano-system", "x")
        won_a = a.try_acquire_or_renew()
        real = b._lease
        b._lease = lambda: stale
        try:
            won_b = b.try_acquire_or_renew()       # the CAS must reject
        finally:
            b._lease = real
        return [won_a, won_b, lease_of(store), b.leading, b.fencing_epoch]
    assert both(scenario) == [True, False, ("a", 2), False, 0]


def test_racing_creates_cannot_both_win():
    """Both see no lease; the second create loses and returns False."""
    def scenario(p):
        store = p.store.ObjectStore()
        a = elector(p, store, "a", name="y")
        b = elector(p, store, "b", name="y")
        real = b._lease
        b._lease = lambda: None                # b read before the create
        try:
            out = [a.try_acquire_or_renew(), b.try_acquire_or_renew()]
        finally:
            b._lease = real
        return out + [lease_of(store, "y")]
    assert both(scenario) == [True, False, ("a", 1)]


def test_store_cas_conflict():
    """update(expect_rv=...) rejects stale Lease writes; expect_rv=0 is
    create-only, and a create through the CAS path is an ADD to
    watchers."""
    def scenario(p):
        Lease, Meta = p.le.Lease, p.objects.ObjectMeta
        store = p.store.ObjectStore()
        store.create(Lease(metadata=Meta(name="l", namespace="ns"),
                           holder="h1", renew_time=1.0))
        rv = store.get("Lease", "ns", "l").metadata.resource_version
        store.update(Lease(metadata=Meta(name="l", namespace="ns"),
                           holder="h2", renew_time=2.0), expect_rv=rv)
        stale = Lease(metadata=Meta(name="l", namespace="ns"),
                      holder="h3", renew_time=3.0)
        out = []
        for expect in (rv, 0):
            with pytest.raises(p.store.ConflictError):
                store.update(stale, expect_rv=expect)
            out.append(store.get("Lease", "ns", "l").holder)
        events = []
        store.watch("Lease", lambda ev, obj, old=None: events.append(ev))
        del events[:]                          # the ADDED replay
        store.update(Lease(metadata=Meta(name="l2", namespace="ns"),
                           holder="h9", renew_time=9.0), expect_rv=0)
        out += [store.get("Lease", "ns", "l2").holder,
                events[-1] == p.store.ADDED]
        return out
    assert both(scenario) == ["h2", "h2", "h9", True]


def test_fencing_epoch_monotonic_across_acquisitions():
    """Every ACQUISITION (create, takeover, re-claim) mints epoch+1; a
    renewal carries the epoch unchanged, the total order fencing rests
    on."""
    def scenario(p):
        wall = _Clock()
        store = p.store.ObjectStore()
        a = elector(p, store, "a", lease_duration=5.0, time_fn=wall,
                    mono_fn=wall)
        b = elector(p, store, "b", lease_duration=5.0, time_fn=wall,
                    mono_fn=wall)
        out = [(a.step(), a.fencing_epoch)]           # create
        wall.advance(1.0)
        out.append((a.step(), a.fencing_epoch))       # renewal
        wall.advance(6.0)                             # a's lease expires
        out.append((b.step(), b.fencing_epoch))       # takeover
        b.release()
        out.append((a.step(), a.fencing_epoch))       # re-claim
        out.append(lease_of(store))
        return out
    assert both(scenario) == [(True, 1), (True, 1), (True, 2), (True, 3),
                              ("a", 3)]


def test_ntp_step_backward_does_not_mask_lease_loss():
    """The wall clock steps BACKWARD while the lease is lost to a
    challenger: the renew-deadline watchdog reads the monotonic clock, so
    the loss is detected on time and on_lease_lost fires."""
    def scenario(p):
        wall_base, mono = _Clock(), _Clock()
        wall = p.chaos.ClockSkewInjector(wall_base)
        store = p.store.ObjectStore()
        lost = []
        a = elector(p, store, "a", lease_duration=4.0, renew_deadline=3.0,
                    time_fn=wall, mono_fn=mono,
                    on_lease_lost=lambda: lost.append("a"))
        b = elector(p, store, "b", lease_duration=4.0, renew_deadline=3.0,
                    time_fn=wall, mono_fn=mono)
        out = [a.step()]
        wall_base.advance(5.0)
        mono.advance(5.0)
        out.append((b.step(), b.fencing_epoch))
        wall.step(-1000.0)
        out += [a.step(), a.leading, list(lost), a.fencing_epoch]
        return out
    assert both(scenario) == [True, (True, 2), False, False, ["a"], 1]


def test_ntp_step_forward_does_not_depose_healthy_leader():
    def scenario(p):
        wall_base, mono = _Clock(), _Clock()
        wall = p.chaos.ClockSkewInjector(wall_base)
        store = p.store.ObjectStore()
        lost = []
        a = elector(p, store, "a", lease_duration=4.0, renew_deadline=3.0,
                    time_fn=wall, mono_fn=mono,
                    on_lease_lost=lambda: lost.append("a"))
        out = [a.step()]
        wall.step(+1000.0)                             # NTP leaps forward
        for _ in range(5):
            wall_base.advance(1.0)
            mono.advance(1.0)
            out.append(a.step())
        return out + [a.leading, list(lost)]
    assert both(scenario) == [True] * 6 + [True, []]


def test_partition_lease_name():
    assert pt_le.partition_lease_name("vc-scheduler", 3) \
        == jax_le.partition_lease_name("vc-scheduler", 3) \
        == "vc-scheduler-p3"


def _election_soak(p, seed, fault_rate):
    """Three electors with flap guards over one lease store (behind the
    retrying transport over a seeded faulty one when ``fault_rate``), on a
    fake clock: seeded steps, revocations, releases and clock advances.
    Returns every step's (who, verdict, epoch, leading), the lease and
    the counters."""
    clock = _Clock(1000.0)
    store = p.store.ObjectStore()
    rng = random.Random(seed)

    def store_for(ix):
        if not fault_rate:
            return store
        inj = p.chaos.StoreFaultInjector(failure_rate=fault_rate,
                                         seed=seed * 7919 + ix,
                                         latency_s=0.05,
                                         sleep_fn=clock.advance)
        return p.transport.RetryingStoreTransport(
            p.transport.FaultyStoreTransport(store, inj, name=f"l{ix}"),
            sleep_fn=clock.advance, time_fn=clock, cycle_budget_s=0.5,
            rng=random.Random(seed * 31 + ix))

    electors = []
    for ix in range(3):
        electors.append(elector(
            p, store_for(ix), f"r{ix}", name="vc-scheduler",
            lease_duration=1.6, renew_deadline=1.2, retry_period=1.0,
            time_fn=clock, mono_fn=clock,
            flap_guard=p.le.FlapGuard(cooldown_s=4.0, max_cooldown_s=16.0,
                                      time_fn=clock)))
    log = []
    for step in range(60):
        for el in electors:
            st = el.store
            if hasattr(st, "new_cycle"):
                st.new_cycle()
        roll = rng.random()
        if roll < 0.08:
            leaders = [e for e in electors if e.leading]
            if leaders:
                leaders[0].revoke()
                log.append(("revoke", leaders[0].identity))
        elif roll < 0.12:
            leaders = [e for e in electors if e.leading]
            if leaders:
                leaders[0].release()
                log.append(("release", leaders[0].identity))
        for el in electors:
            log.append((el.identity, el.step(), el.fencing_epoch,
                        el.leading))
        clock.advance(rng.choice((0.5, 1.0, 1.0, 1.0, 2.0)))
    return {"log": log, "lease": lease_of(store, "vc-scheduler"),
            "takeovers": [e.takeovers for e in electors],
            "losses": [e.flap_guard.total_losses for e in electors],
            "flap": [e.flap_guard.detail() for e in electors]}


@pytest.mark.parametrize("seed, fault_rate",
                         [(1, 0.0), (2, 0.0), (3, 0.6), (7, 0.3)])
def test_seeded_election_soak_equals_jax(seed, fault_rate):
    """The same seeded election, step by step, through both packages:
    every verdict, epoch and cool-down equal; never two leaders at once
    (the CAS and the monotonic watchdog)."""
    rec = both(_election_soak, seed, fault_rate)
    steps = [e for e in rec["log"] if len(e) == 4]
    assert max(e[2] for e in steps) >= 2, \
        "the soak never changed leadership"
    holders = {}
    for ident, _, epoch, leading in steps:
        if leading:
            holders.setdefault(epoch, set()).add(ident)
    # one holder an epoch: the CAS mints each epoch exactly once
    assert all(len(h) == 1 for h in holders.values())


# ---------------------------------------------------------------------------
# two port Schedulers under run_with_leader_election
# ---------------------------------------------------------------------------

def _replica(store):
    """A port Scheduler over its own informer-fed cache of the shared
    store (its binds write pod status back to the store)."""
    from volcano_tpu_torch.api import NodeInfo, Resource
    from volcano_tpu_torch.cache.store_wiring import wire_cache_to_store
    from volcano_tpu_torch.scheduler import Scheduler
    cache = wire_cache_to_store(store)
    alloc = Resource(8000, 16 << 30)
    alloc.max_task_num = 110
    cache.add_node(NodeInfo(name="n0", allocatable=alloc))
    return Scheduler(cache, schedule_period=0.02, device="cpu",
                     drift_verify_every=0)


def _submit(store, name, replicas=2):
    from volcano_tpu_torch.api import Resource
    from volcano_tpu_torch.apis.objects import (ObjectMeta, Pod,
                                                PodGroupCR, PodGroupSpec,
                                                PodTemplate)
    store.create(PodGroupCR(
        metadata=ObjectMeta(name=name, namespace="default",
                            creation_timestamp=time.time()),
        spec=PodGroupSpec(min_member=replicas, queue="default")))
    store.create_batch([Pod(metadata=ObjectMeta(
        name=f"{name}-{i}", namespace="default", uid=f"{name}-{i}",
        annotations={"scheduling.k8s.io/group-name": name},
        creation_timestamp=time.time()),
        template=PodTemplate(resources=Resource(500, 1 << 28)))
        for i in range(replicas)])


def _bound(store, name, replicas=2):
    pods = [store.get("Pod", "default", f"{name}-{i}")
            for i in range(replicas)]
    return all(p is not None and p.status.node_name for p in pods)


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def test_scheduler_runs_under_election():
    """Two port Schedulers over one port store, each in a thread under
    run_with_leader_election: one leads and binds; kill it (stop its loop
    and its elector) and the standby leads at epoch + 1 and binds new
    jobs."""
    from volcano_tpu_torch.apis.objects import ObjectMeta, QueueCR, \
        QueueSpecCR
    from volcano_tpu_torch.scheduler import ROLE_FOLLOWER, ROLE_LEADER
    store = pt_store.ObjectStore()
    store.create(QueueCR(metadata=ObjectMeta(name="default",
                                             namespace="default"),
                         spec=QueueSpecCR(weight=1)))
    scheds = [_replica(store), _replica(store)]
    kw = {"lease_duration": 0.6, "renew_deadline": 0.4,
          "retry_period": 0.05}
    threads = []
    for i, s in enumerate(scheds):
        t = threading.Thread(
            target=lambda s=s, i=i: s.run_with_leader_election(
                store, identity=f"replica-{i}", **kw), daemon=True)
        t.start()
        threads.append(t)
        if i == 0:
            # replica-0 takes the lease before its peer contends
            assert _wait(lambda: scheds[0].role == ROLE_LEADER)
    leader, standby = scheds
    _submit(store, "j1")
    assert _wait(lambda: _bound(store, "j1"))
    epoch = leader._elector.fencing_epoch
    assert epoch == 1 and standby.role == ROLE_FOLLOWER
    # the standby's cache followed the store: it sees j1's pods bound
    assert _wait(lambda: all(
        t.node_name == "n0"
        for t in standby.cache.jobs["default/j1"].tasks.values()))
    # kill the leader: its loop and its elector stop, its lease expires
    leader.stop()
    leader._elector.stop()
    threads[0].join(timeout=5)
    assert not threads[0].is_alive()
    assert _wait(lambda: standby.role == ROLE_LEADER)
    assert standby._elector.fencing_epoch == epoch + 1
    lease = store.get("Lease", "volcano-system", "vc-scheduler")
    assert lease.holder == "replica-1" and lease.epoch == epoch + 1
    _submit(store, "j2")
    assert _wait(lambda: _bound(store, "j2"))
    standby.stop()
    standby._elector.stop()
    threads[1].join(timeout=5)
    assert not threads[1].is_alive()
