"""The HA control plane of volcano_tpu_torch, held to the JAX package's:
the port of tests/test_ha.py's fencing, role-state-machine, standby-replay
and sim classes (``vcctl leader status`` waits for the rest of the control
plane).

Fencing: epochs minted at the elector, stamped on journal intents, and
stale-epoch rejection at the executor gate (the split-brain regression).
The shell's role state machine: a standby never opens a session; a leader
demoted mid-cycle abandons the open session instead of half-applying it;
a fresh leader settles the journal's crash window before its first cycle.
Warm-standby replay over both transports (the in-memory subscription and
the file tail), and a follower's applies reaching the persistent node
tensors. ``SimRunner(ha_replicas=3)``: seeded leader kills, lease losses
and lease faults, each run through both packages' runners in this process
under the sim's default conf (host engines only) with equal reports and
side-effect sequences.

Each deterministic scenario runs once through each package and the two
records must be equal.
"""

import gc
import json
import types

import pytest

import volcano_tpu.api as jax_api
import volcano_tpu.cache as jax_cache
import volcano_tpu.cache.executors as jax_executors
import volcano_tpu.cache.journal as jax_journal
import volcano_tpu.chaos as jax_chaos
import volcano_tpu.leaderelection as jax_le
import volcano_tpu.metrics as jax_metrics
import volcano_tpu.scheduler as jax_scheduler
import volcano_tpu.sim.report as jax_report
import volcano_tpu.sim.runner as jax_runner
import volcano_tpu.sim.workload as jax_workload
import volcano_tpu.store as jax_store
import volcano_tpu.store_transport as jax_transport
import volcano_tpu_torch.api as pt_api
import volcano_tpu_torch.cache as pt_cache
import volcano_tpu_torch.cache.executors as pt_executors
import volcano_tpu_torch.cache.journal as pt_journal
import volcano_tpu_torch.chaos as pt_chaos
import volcano_tpu_torch.leaderelection as pt_le
import volcano_tpu_torch.metrics as pt_metrics
import volcano_tpu_torch.scheduler as pt_scheduler
import volcano_tpu_torch.sim.report as pt_report
import volcano_tpu_torch.sim.runner as pt_runner
import volcano_tpu_torch.sim.workload as pt_workload
import volcano_tpu_torch.store as pt_store
import volcano_tpu_torch.store_transport as pt_transport

from torch_parity import port_gc_windows  # noqa: F401

GI = 1 << 30

JAX = types.SimpleNamespace(
    name="jax", api=jax_api, cache=jax_cache, executors=jax_executors,
    journal=jax_journal, chaos=jax_chaos, le=jax_le, metrics=jax_metrics,
    scheduler=jax_scheduler, report=jax_report, runner=jax_runner,
    workload=jax_workload, store=jax_store, transport=jax_transport,
    sched_kw={})
PORT = types.SimpleNamespace(
    name="port", api=pt_api, cache=pt_cache, executors=pt_executors,
    journal=pt_journal, chaos=pt_chaos, le=pt_le, metrics=pt_metrics,
    scheduler=pt_scheduler, report=pt_report, runner=pt_runner,
    workload=pt_workload, store=pt_store, transport=pt_transport,
    sched_kw={"device": "cpu"})


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, d: float) -> None:
        self.t += d


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` through each package; the records must
    be equal. Returns the port's."""
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def clone(task):
    """A task copy that carries a placement (the funnels' argument)."""
    return task.shallow_clone() if hasattr(task, "shallow_clone") \
        else task.clone()


def make_world(p, binder, evictor=None, n_nodes=2, n_jobs=2,
               tasks_per_job=2, **cache_kw):
    a = p.api
    cache = p.cache.SchedulerCache(
        binder=binder, evictor=evictor or p.executors.SequenceEvictor(),
        **cache_kw)
    for i in range(n_nodes):
        alloc = a.Resource(16000, 32 * GI)
        alloc.max_task_num = 110
        cache.add_node(a.NodeInfo(name=f"n{i}", allocatable=alloc))
    for j in range(n_jobs):
        pg = a.PodGroup(name=f"j{j}", queue="default",
                        min_member=tasks_per_job,
                        phase=a.PodGroupPhase.INQUEUE)
        job = a.JobInfo(uid=f"j{j}", name=f"j{j}", queue="default",
                        min_available=tasks_per_job, podgroup=pg)
        for k in range(tasks_per_job):
            job.add_task_info(a.TaskInfo(uid=f"j{j}-{k}", name=f"j{j}-{k}",
                                         job=f"j{j}",
                                         resreq=a.Resource(1000, GI)))
        cache.add_job(job)
    return cache


def make_elector(p, store, authority, ident, wall, mono=None, **kw):
    kw.setdefault("lease_duration", 10.0)
    kw.setdefault("renew_deadline", 6.0)
    return p.le.LeaderElector(store, "vc-scheduler",
                              on_started_leading=lambda: None,
                              identity=ident, time_fn=wall,
                              mono_fn=mono or wall, authority=authority,
                              **kw)


def make_sched(p, cache, **kw):
    return p.scheduler.Scheduler(cache, schedule_period=0.0,
                                 drift_verify_every=0, **p.sched_kw, **kw)


def task_state(cache):
    """Every task's (status, node) and every node's task set."""
    return ({uid: (int(t.status), t.node_name)
             for j in cache.jobs.values() for uid, t in j.tasks.items()},
            {n: sorted(node.tasks) for n, node in cache.nodes.items()})


# ---------------------------------------------------------------------------
# fencing: epochs, the authority, the executor gate
# ---------------------------------------------------------------------------

class TestFencing:
    def test_authority_rejects_stale_and_advances(self):
        def scenario(p):
            auth = p.executors.FencingAuthority()
            auth.check("bind", 1)            # first leadership observed
            auth.check("bind", 1)
            auth.advance(3)
            with pytest.raises(p.executors.FencedError) as e:
                auth.check("bind", 2)
            auth.check("evict", 3)           # the live leader passes
            auth.check("evict", 5)           # a newer leader proves itself
            return [e.value.op, e.value.epoch, e.value.current,
                    auth.rejections, auth.current(), str(e.value)]
        assert both(scenario)[:5] == ["bind", 2, 3, 1, 5]

    def test_fencing_registry_namespaces_epochs(self):
        def scenario(p):
            reg = p.executors.FencingRegistry()
            reg.authority(0).advance(4)
            reg.authority(1).advance(1)
            reg.authority(1).check("bind", 1)
            with pytest.raises(p.executors.FencedError):
                reg.authority(0).check("bind", 2)
            return [reg.current(0), reg.current(1), reg.current(2),
                    reg.rejections(), reg.authority(0) is reg.authority(0)]
        assert both(scenario) == [4, 1, 0, 1, True]

    def test_fenced_binder_blocks_inner_executor(self):
        def scenario(p):
            a = p.api
            auth = p.executors.FencingAuthority()
            inner = p.executors.SequenceBinder()
            evs = p.executors.SequenceEvictor()
            epoch = {"v": 1}
            gate = p.executors.FencedBinder(inner, lambda: epoch["v"], auth)
            egate = p.executors.FencedEvictor(evs, lambda: epoch["v"], auth)
            task = a.TaskInfo(uid="t1", name="t1", job="j",
                              resreq=a.Resource(1000, GI))
            task.node_name = "n0"
            gate.bind(task, "n0")
            auth.advance(2)                   # a newer leader exists
            out = []
            for fn in (lambda: gate.bind(task, "n1"),
                       lambda: egate.evict(task, "x")):
                with pytest.raises(p.executors.FencedError) as e:
                    fn()
                out.append(e.value.op)
            return [list(inner.sequence), list(evs.sequence), out]
        assert both(scenario) == [[("t1", "n0")], [], ["bind", "evict"]]

    def test_fenced_ex_leader_bind_rejected_and_counted(self):
        """THE acceptance regression: a stale-epoch bind issued by a
        fenced ex-leader, one that lost the lease but never noticed, is
        rejected by the executor, the optimistic cache state rolls back,
        and the rejection is counted. Split-brain safety by
        construction."""
        def scenario(p):
            wall = FakeClock()
            store = p.store.ObjectStore()
            auth = p.executors.FencingAuthority()
            a = make_elector(p, store, auth, "a", wall, lease_duration=5.0,
                             renew_deadline=3.0)
            b = make_elector(p, store, auth, "b", wall, lease_duration=5.0,
                             renew_deadline=3.0)
            out = [a.step(), a.fencing_epoch]
            cluster = p.executors.SequenceBinder()
            cache = make_world(
                p, p.executors.FencedBinder(cluster,
                                            lambda: a.fencing_epoch, auth),
                evictor=p.executors.FencedEvictor(
                    p.executors.SequenceEvictor(),
                    lambda: a.fencing_epoch, auth),
                journal=p.journal.IntentJournal())
            cache.fencing_epoch_fn = lambda: a.fencing_epoch
            t0 = clone(cache.jobs["j0"].tasks["j0-0"])
            t0.node_name = "n0"
            cache.bind(t0)                    # the live leader binds
            out.append(list(cluster.sequence))
            wall.advance(6.0)                 # a's lease expires unnoticed
            out += [b.step(), b.fencing_epoch, auth.current()]
            before = p.metrics.local_counters().get(
                ("fencing_rejections", "bind"), 0)
            t1 = clone(cache.jobs["j0"].tasks["j0-1"])
            t1.node_name = "n0"
            cache.bind(t1)                    # rolled back, resync queued
            cached = cache.jobs["j0"].tasks["j0-1"]
            out += [list(cluster.sequence), int(cached.status),
                    cached.node_name, auth.rejections,
                    p.metrics.local_counters().get(
                        ("fencing_rejections", "bind"), 0) - before]
            # the queued resync retry is fenced too
            cache.resync_queue.time_fn = lambda: 1e9
            cache.process_resync_tasks()
            out += [list(cluster.sequence), auth.rejections]
            return out
        got = both(scenario)
        assert got[:3] == [True, 1, [("j0-0", "n0")]]
        assert got[3:6] == [True, 2, 2]
        assert got[6] == [("j0-0", "n0")], \
            "the deposed leader's bind reached the cluster (split brain)"
        assert got[7] == int(pt_api.TaskStatus.PENDING) and got[8] == ""
        assert got[9] >= 1 and got[10] == 1
        assert got[11] == [("j0-0", "n0")] and got[12] >= 2

    def test_intent_epoch_stamped_and_durable(self, tmp_path):
        def scenario(p):
            path = str(tmp_path / f"journal-{p.name}.jsonl")
            journal = p.journal.IntentJournal(path=path)
            cache = make_world(p, p.executors.SequenceBinder(),
                               journal=journal)
            cache.fencing_epoch_fn = lambda: 7

            class FailBinder:
                def bind(self, task, hostname):
                    raise RuntimeError("boom")

            cache.binder = FailBinder()
            t = clone(cache.jobs["j0"].tasks["j0-0"])
            t.node_name = "n0"
            cache.bind(t)                     # fails: intent + nack
            journal.close()
            recs = [json.loads(line) for line in open(path)]
            intents = [(r["epoch"], r["op"], r["task"], r["node"])
                       for r in recs if r["kind"] == "intent"]
            j2 = p.journal.IntentJournal(path=path)
            n_open = len(j2)                  # the nack settled it
            j2.close()
            return [intents, n_open]
        assert both(scenario) == [[(7, "bind", "j0-0", "n0")], 0]


# ---------------------------------------------------------------------------
# the role state machine
# ---------------------------------------------------------------------------

class TestRoleStateMachine:
    def test_standby_never_opens_session(self, monkeypatch):
        wall = FakeClock()
        store = pt_store.ObjectStore()
        auth = pt_executors.FencingAuthority()
        holder = make_elector(PORT, store, auth, "holder", wall)
        assert holder.step()                  # someone holds a live lease
        standby = make_elector(PORT, store, auth, "standby", wall)
        cache = make_world(PORT, pt_executors.SequenceBinder())
        sched = make_sched(PORT, cache)
        sched.attach_elector(standby)
        monkeypatch.setattr(
            pt_scheduler, "open_session",
            lambda *a, **k: pytest.fail("standby opened a session"))
        snapshots = []
        monkeypatch.setattr(cache, "snapshot",
                            lambda *a, **k: snapshots.append(1))
        for _ in range(3):
            assert sched.run_once() == []
            assert sched.role == pt_scheduler.ROLE_FOLLOWER
        assert not standby.leading and not snapshots
        assert pt_metrics.health_detail()["leader"] == {
            "leading": False, "role": "follower", "epoch": 0}
        # once the lease expires the same shell takes over and schedules
        monkeypatch.undo()
        wall.advance(standby.lease_duration + 1)
        sched.run_once()
        assert sched.role == pt_scheduler.ROLE_LEADER
        assert standby.fencing_epoch == 2
        assert sched.cache.fencing_epoch() == 2
        assert pt_metrics.health_detail()["leader"] == {
            "leading": True, "role": "leader", "epoch": 2}

    def test_leader_demotes_mid_cycle_without_half_applying(self):
        """A revocation at an action boundary demotes the leader to
        FENCED: the remaining actions are skipped, the open session is
        ABANDONED (no plugin close, no podgroup status flush) and the GC
        window resumes."""
        def scenario(p):
            wall = FakeClock()
            store = p.store.ObjectStore()
            auth = p.executors.FencingAuthority()
            elector = make_elector(p, store, auth, "a", wall)
            updates = []

            class RecordingUpdater(p.executors.FakeStatusUpdater):
                def update_pod_group(self, job):
                    updates.append(job.uid)

            cache = make_world(p, p.executors.SequenceBinder(),
                               status_updater=RecordingUpdater())
            sched = make_sched(p, cache)
            sched.attach_elector(elector)
            out = [sched.run_once(), sched.role, bool(updates)]
            del updates[:]
            seen = []
            injector = p.chaos.LeaseLossInjector(lambda: elector, {1: 2})

            def hook(name, ssn):
                seen.append(name)
                injector(name, ssn)

            sched.action_fault_hook = hook
            out += [sched.run_once(), sched.role, list(injector.injected),
                    list(seen), list(updates), gc.isenabled()]
            # the ex-leader re-contends (no flap guard): the fresh
            # acquisition mints a HIGHER epoch
            out += [sched.run_once(), sched.role, elector.fencing_epoch]
            return out
        got = both(scenario)
        assert got[:3] == [[], "leader", True]
        assert got[3:5] == [[], "fenced"] and got[5] == [(1, 2)]
        assert len(got[6]) <= 2, got[6]
        assert got[7] == [], \
            "a demoted leader must not half-apply close writebacks"
        assert got[8], "the abandoned session must resume GC"
        assert got[9:] == [[], "leader", 2]

    def test_flap_guard_cools_down_flapping_leadership(self):
        """loss → window → re-acquire → prompt loss again DOUBLES the
        window: the streak resets only after leadership is held past the
        stability horizon."""
        def scenario(p):
            clock = FakeClock()
            guard = p.le.FlapGuard(cooldown_s=5.0, max_cooldown_s=20.0,
                                   time_fn=clock)
            out = [guard.may_contend(), guard.record_loss(),
                   guard.may_contend()]
            clock.advance(5.1)
            out.append(guard.may_contend())
            guard.record_stable()
            clock.advance(1.0)
            guard.record_stable()
            out += [guard.consecutive_losses, guard.record_loss()]
            clock.advance(10.1)
            guard.record_stable()
            clock.advance(5.1)
            guard.record_stable()
            out += [guard.consecutive_losses, guard.detail()]
            return out
        got = both(scenario)
        assert got[:6] == [True, 5.0, False, True, 1, 10.0]
        assert got[6] == 0

    def test_flap_guard_engages_through_the_elector(self):
        def scenario(p):
            wall = FakeClock()
            store = p.store.ObjectStore()
            auth = p.executors.FencingAuthority()
            guard = p.le.FlapGuard(cooldown_s=4.0, max_cooldown_s=32.0,
                                   time_fn=wall)
            a = p.le.LeaderElector(store, "vc-scheduler",
                                   on_started_leading=lambda: None,
                                   identity="a", lease_duration=2.0,
                                   renew_deadline=1.5, time_fn=wall,
                                   mono_fn=wall, authority=auth,
                                   flap_guard=guard)
            out = [a.step()]
            a.revoke()
            out += [guard.consecutive_losses, a.step()]
            wall.advance(4.1)
            out.append(a.step())
            a.revoke()
            out += [guard.consecutive_losses, a.step()]
            wall.advance(4.1)
            out.append(a.step())
            wall.advance(4.1)
            out += [a.step(), a.fencing_epoch, auth.current()]
            return out
        assert both(scenario) == [True, 1, False, True, 2, False, False,
                                  True, 3, 3]

    def test_handoff_settles_the_crash_window_before_the_first_cycle(self):
        """A fresh leader runs startup_reconcile with the crash oracle on
        its first gated cycle (lease-acquire → reconcile → resume): the
        dead predecessor's open intent is settled, the report kept, and a
        takeover counted as a failover."""
        def scenario(p):
            wall = FakeClock()
            store = p.store.ObjectStore()
            auth = p.executors.FencingAuthority()
            journal = p.journal.IntentJournal()
            dead = make_elector(p, store, auth, "dead", wall,
                                lease_duration=2.0)
            assert dead.step()
            cache = make_world(p, p.executors.SequenceBinder(),
                               journal=journal)
            # the predecessor's crash window: an intent the cluster ran
            # and one it never saw
            for uid, node in (("j0-0", "n1"), ("j0-1", "n1")):
                t = clone(cache.jobs["j0"].tasks[uid])
                t.node_name = node
                journal.record_intent("bind", t, node, epoch=1)
            new = make_elector(p, store, auth, "new", wall,
                               lease_duration=2.0)
            sched = make_sched(p, cache)
            sched.attach_elector(new)
            sched.reconcile_oracle_fn = lambda: (
                {"j0-0": "n1"}, lambda uid: False)
            before = p.metrics.local_counters().get(("failovers",), 0)
            out = [sched.run_once(), sched.role]
            wall.advance(3.0)                 # the dead lease expires
            sched.run_once()
            rpt = sched.last_handoff_report
            out += [sched.role, new.fencing_epoch,
                    rpt.as_dict() if rpt is not None else None,
                    len(journal),
                    p.metrics.local_counters().get(("failovers",), 0)
                    - before,
                    int(cache.jobs["j0"].tasks["j0-0"].status)]
            return out
        got = both(scenario)
        assert got[:3] == [[], "follower", "leader"] and got[3] == 2
        assert got[4]["replayed"] == 2 and got[4]["repaired_binds"] == 1 \
            and got[4]["rolled_back"] == 1
        assert got[5] == 0 and got[6] == 1

    def test_health_detail_counts_rejections_and_failovers(self):
        before = pt_metrics.health_detail()
        auth = pt_executors.FencingAuthority()
        auth.advance(2)
        with pytest.raises(pt_executors.FencedError):
            auth.check("evict", 1)
        pt_metrics.register_failover()
        after = pt_metrics.health_detail()
        assert after["fencing_rejections_total"].get("evict", 0) \
            == before["fencing_rejections_total"].get("evict", 0) + 1
        assert after["failovers_total"] == before["failovers_total"] + 1

    def test_fast_admit_waits_for_the_lease(self):
        """Fast admit binds nothing on a replica that does not lead."""
        wall = FakeClock()
        store = pt_store.ObjectStore()
        auth = pt_executors.FencingAuthority()
        holder = make_elector(PORT, store, auth, "holder", wall)
        assert holder.step()
        standby = make_elector(PORT, store, auth, "standby", wall)
        binder = pt_executors.SequenceBinder()
        cache = make_world(PORT, binder, n_jobs=0)
        sched = make_sched(PORT, cache, fast_admit=True)
        sched.attach_elector(standby)
        a = pt_api
        pg = a.PodGroup(name="fa", queue="default", min_member=2,
                        phase=a.PodGroupPhase.INQUEUE)
        job = a.JobInfo(uid="fa", name="fa", queue="default",
                        min_available=2, podgroup=pg)
        for k in range(2):
            job.add_task_info(a.TaskInfo(uid=f"fa-{k}", name=f"fa-{k}",
                                         job="fa",
                                         resreq=a.Resource(1000, GI)))
        cache.add_job(job)
        assert sched.fast_admit() == 0 and binder.sequence == []
        # once it leads, the gang that trivially fits binds between cycles
        wall.advance(standby.lease_duration + 1)
        assert standby.step()
        assert sched.fast_admit() == 2
        assert sorted(u for u, _ in binder.sequence) == ["fa-0", "fa-1"]


# ---------------------------------------------------------------------------
# warm-standby journal replay
# ---------------------------------------------------------------------------

class TestStandbyReplay:
    def _pair(self, p, journal):
        leader = make_world(p, p.executors.SequenceBinder(),
                            journal=journal)
        standby = make_world(p, p.executors.SequenceBinder())
        follower = p.journal.JournalFollower(standby)
        return leader, standby, follower

    def test_in_memory_tail_converges_standby(self):
        def scenario(p):
            journal = p.journal.IntentJournal()
            leader, standby, follower = self._pair(p, journal)
            follower.attach(journal)
            t = clone(leader.jobs["j0"].tasks["j0-0"])
            t.node_name = "n1"
            leader.bind(t)
            out = [task_state(standby)]
            leader.evict(leader.jobs["j0"].tasks["j0-0"], "test")
            out += [task_state(standby), follower.applied,
                    task_state(standby) == task_state(leader)]
            follower.detach()
            t = clone(leader.jobs["j1"].tasks["j1-0"])
            t.node_name = "n0"
            leader.bind(t)                    # detached: nothing applies
            out += [follower.applied,
                    int(standby.jobs["j1"].tasks["j1-0"].status)]
            return out
        got = both(scenario)
        tasks, nodes = got[0]
        assert tasks["j0-0"] == (int(pt_api.TaskStatus.BOUND), "n1")
        assert "j0-0" in nodes["n1"]
        assert got[1][0]["j0-0"][0] == int(pt_api.TaskStatus.RELEASING)
        assert got[2] == 2 and got[3]
        assert got[4:] == [2, int(pt_api.TaskStatus.PENDING)]

    def test_failed_bind_does_not_move_standby(self):
        def scenario(p):
            journal = p.journal.IntentJournal()
            leader, standby, follower = self._pair(p, journal)
            follower.attach(journal)

            class FailBinder:
                def bind(self, task, hostname):
                    raise RuntimeError("boom")

            leader.binder = FailBinder()
            t = clone(leader.jobs["j0"].tasks["j0-0"])
            t.node_name = "n1"
            leader.bind(t)                    # nack: rollback both sides
            return [task_state(standby), follower.applied]
        got = both(scenario)
        assert got[0][0]["j0-0"] == (int(pt_api.TaskStatus.PENDING), "")

    def test_seed_resolves_acks_for_pre_subscription_intents(self):
        """A standby started mid-stream (or restarted after a crash)
        still resolves acks whose intents predate its subscription."""
        def scenario(p):
            journal = p.journal.IntentJournal()
            leader, standby, follower = self._pair(p, journal)
            seq = journal.record_intent(
                "bind", leader.jobs["j0"].tasks["j0-0"], "n1", epoch=1)
            follower.attach(journal)          # seeds from the open set
            journal.ack(seq, ok=True)
            # an ack of an intent it never saw (settled history) is moot
            journal.ack(seq + 100, ok=True)
            return [task_state(standby), follower.applied]
        got = both(scenario)
        assert got[0][0]["j0-0"] == (int(pt_api.TaskStatus.BOUND), "n1")
        assert got[1] == 1

    def test_file_tail_transport(self, tmp_path):
        def scenario(p):
            path = str(tmp_path / f"journal-{p.name}.jsonl")
            journal = p.journal.IntentJournal(path=path)
            leader = make_world(p, p.executors.SequenceBinder(),
                                journal=journal)
            standby = make_world(p, p.executors.SequenceBinder())
            follower = p.journal.JournalFollower(standby)
            tailer = p.journal.FileTailer(path)
            out = [tailer.poll()]             # nothing written yet
            t = clone(leader.jobs["j1"].tasks["j1-0"])
            t.node_name = "n0"
            leader.bind(t)
            journal.flush()
            recs = tailer.poll()
            for rec in recs:
                follower.apply_record(rec)
            out += [[(r["kind"], r["seq"]) for r in recs],
                    task_state(standby), tailer.poll()]
            # compaction rewrites the file; the tailer restarts
            # idempotently
            journal.compact()
            journal.flush()
            for rec in tailer.poll():
                follower.apply_record(rec)
            out += [task_state(standby), follower.applied]
            journal.close()
            return out
        got = both(scenario)
        assert got[0] == [] and got[1] == [("intent", 1), ("ack", 1)]
        assert got[2][0]["j1-0"] == (int(pt_api.TaskStatus.BOUND), "n0")
        assert got[3] == [] and got[4] == got[2] and got[5] == 1

    def test_file_tail_leaves_a_torn_line(self, tmp_path):
        got = {}
        for p in (JAX, PORT):
            path = tmp_path / f"j-{p.name}.jsonl"
            path.write_text('{"kind":"intent","seq":1,"op":"bind",'
                            '"task":"a","job":"j","node":"n"}\n'
                            '{"kind":"ack","se')
            tailer = p.journal.FileTailer(str(path))
            first = tailer.poll()             # the torn ack waits
            with open(path, "a") as f:
                f.write('q":1,"ok":true}\n')
            got[p.name] = [first, tailer.poll()]
        assert got["port"] == got["jax"]
        assert [r["kind"] for r in got["port"][0]] == ["intent"]
        assert got["port"][1] == [{"kind": "ack", "seq": 1, "ok": True}]

    def test_follower_applies_reach_the_persistent_node_tensors(self):
        """A standby that built its persistent node tensors and then
        followed another leader's bind rewrites that node's row at its
        next refresh (the apply went through the dirty marks), so a
        replica that leads again reads the other leader's placements."""
        from volcano_tpu_torch.cache.snapshot import (
            discover_resource_names)
        journal = pt_journal.IntentJournal()
        leader, standby, follower = self._pair(PORT, journal)
        follower.attach(journal)

        def refresh():
            snap = standby.snapshot()
            tasks = [t for j in snap.jobs.values() for t in j.tasks.values()]
            rnames = discover_resource_names(list(snap.nodes.values()),
                                             tasks)
            return standby.tensor_refresh(snap.nodes, rnames, "cpu",
                                          snap.snap_epoch)

        tc = refresh()
        assert tc.last_refresh["full"]
        row = tc.index["n1"]
        assert tc.host["ntasks"][row] == 0
        t = clone(leader.jobs["j0"].tasks["j0-0"])
        t.node_name = "n1"
        leader.bind(t)
        assert "n1" in standby._dirty_nodes and "j0" in standby._dirty_jobs
        tc = refresh()
        assert not tc.last_refresh["full"] and tc.last_refresh["rows"] >= 1
        assert tc.host["ntasks"][row] == 1
        node = standby.nodes["n1"]
        assert list(tc.host["used"][row]) == list(
            node.used.to_vector(tc.rnames))


# ---------------------------------------------------------------------------
# SimRunner(ha_replicas=3): both packages' runners, in this process
# ---------------------------------------------------------------------------

KILLS = (2, 5, 9, 13)


def sim_run(p, scenario="smoke", seed=3, **kw):
    if p is PORT:
        kw["device"] = "cpu"
    runner = p.runner.SimRunner(p.workload.make_scenario(scenario,
                                                         seed=seed),
                                seed=seed, scenario=scenario, **kw)
    report = runner.run()
    return runner, report


def run_both(scenario="smoke", seed=3, **kw):
    """The same HA run through both packages: equal decision planes and
    side-effect sequences. Returns the port's report and runner."""
    jr, want = sim_run(JAX, scenario, seed, **kw)
    pr, got = sim_run(PORT, scenario, seed, **kw)
    assert pt_report.deterministic_json(got) \
        == jax_report.deterministic_json(want)
    assert [list(b) for b in pr.binder.sequence] \
        == [list(b) for b in jr.binder.sequence]
    assert list(pr.evictor.sequence) == list(jr.evictor.sequence)
    return got, pr


@pytest.mark.sim
class TestHASim:
    def test_seeded_leader_kills_zero_double_binds_bounded_failover(self):
        report, _ = run_both(ha_replicas=3, kill_cycles=KILLS, kill_seed=2)
        assert report["double_binds"] == 0
        assert report["restarts"] == len(KILLS)
        assert report["jobs"]["completed"] == report["jobs"]["arrived"]
        assert report["jobs"]["unfinished"] == 0
        assert report["failovers"] == len(KILLS)
        assert report["ha"]["failover_cycles_max"] <= 3, report["ha"]

    def test_ha_run_byte_deterministic(self):
        kw = dict(ha_replicas=3, kill_cycles=KILLS, kill_seed=2,
                  lease_loss_cycles=(7,))
        a, _ = run_both(**kw)
        _, b = sim_run(PORT, **kw)
        assert pt_report.deterministic_json(a) \
            == pt_report.deterministic_json(b)
        assert a["ha"]["lease_losses"] == 1

    def test_non_contended_ha_equals_single_scheduler_oracle(self):
        ha, runner = run_both(ha_replicas=3)
        _, single = sim_run(PORT, ha_replicas=1)
        assert json.dumps(pt_report.oracle_part(ha), sort_keys=True) \
            == json.dumps(pt_report.oracle_part(single), sort_keys=True)
        assert ha["failovers"] == 0 and ha["fenced_rejections"] == 0
        assert "ha" in ha and "ha" not in single
        # the standbys converged on the leader's state through the tail
        planes = [task_state(c) for c in runner.caches]
        assert planes[1] == planes[0] and planes[2] == planes[0]

    def test_lease_loss_fails_over_to_warm_standby(self):
        report, _ = run_both(ha_replicas=3, lease_loss_cycles=(3, 8))
        assert report["double_binds"] == 0
        assert report["restarts"] == 0        # demotion, not death
        assert report["failovers"] >= 1
        assert report["jobs"]["completed"] == report["jobs"]["arrived"]
        assert report["ha"]["failover_cycles_max"] <= 3

    def test_lease_verb_faults_bounded_failover_no_split_brain(self):
        """The Lease CAS path behind the retrying transport over a seeded
        faulty one: a failed acquire or renew loses a ROUND, never the
        process; failover stays bounded and split brain impossible."""
        report, _ = run_both(ha_replicas=3, lease_fault_rate=0.6,
                             lease_fault_seed=3)
        assert report["failovers"] > 0
        assert report["ha"]["failover_cycles_max"] <= 3, report["ha"]
        assert report["double_binds"] == 0
        assert report["jobs"]["completed"] == report["jobs"]["arrived"]
        assert report["restarts"] == 0

    @pytest.mark.parametrize("scenario, seed, kw", [
        ("smoke", 0, {"kill_cycles": (3, 7, 12), "kill_seed": 1}),
        ("smoke", 5, {"kill_cycles": (1, 4, 6, 10, 15), "kill_seed": 4,
                      "lease_loss_cycles": (8,)}),
        ("smoke", 3, {"chaos": 0.2, "kill_cycles": (5, 12),
                      "kill_seed": 5}),
        ("smoke", 3, {"ha_replicas": 2, "lease_loss_cycles": (2, 6, 11),
                      "lease_fault_rate": 0.3}),
        ("preempt-burst", 0, {"kill_cycles": (10, 30, 47), "kill_seed": 2,
                              "lease_loss_cycles": (20,)}),
    ], ids=["kills-s0", "kills-loss-s5", "chaos-kills", "two-replicas",
            "preempt-burst"])
    def test_other_seeds_equal_jax(self, scenario, seed, kw):
        """Other kill seeds, chaos under kills, two replicas with faulted
        leases, and preempt-burst: both packages decide alike, with no
        double bind and every job completed."""
        kw = dict(kw)
        kw.setdefault("ha_replicas", 3)
        rate = kw.pop("chaos", 0.0)
        if rate:
            jr, want = _chaos_run(JAX, scenario, seed, rate, kw)
            pr, got = _chaos_run(PORT, scenario, seed, rate, kw)
            assert pt_report.deterministic_json(got) \
                == jax_report.deterministic_json(want)
            assert [list(b) for b in pr.binder.sequence] \
                == [list(b) for b in jr.binder.sequence]
            report = got
        else:
            report, _ = run_both(scenario, seed, **kw)
        # the CI soak's vacancy bound (<= 3 cycles) is not asserted here:
        # with kills two cycles apart (kills-loss-s5) a vacancy lasts four
        # cycles, in both packages alike
        assert report["double_binds"] == 0
        assert report["jobs"]["completed"] == report["jobs"]["arrived"]

    def test_lease_transient_does_not_depose_within_deadline(self):
        """One failed renewal must not depose a live leader: a single
        TransientStoreError loses the attempt, and leadership holds until
        the renew deadline passes on the monotonic clock."""
        def scenario(p):
            clock = FakeClock()
            store = p.store.ObjectStore()

            class Flaky:
                def __init__(self, inner):
                    self.inner = inner
                    self.fail_next = 0

                def __getattr__(self, name):
                    if name in ("get", "update", "create"):
                        def verb(*a, **kw):
                            if self.fail_next:
                                self.fail_next -= 1
                                raise p.transport.TransientStoreError(
                                    name, 0, 0)
                            return getattr(self.inner, name)(*a, **kw)
                        return verb
                    return getattr(self.inner, name)

            flaky = Flaky(store)
            el = p.le.LeaderElector(flaky, "vc-scheduler",
                                    on_started_leading=lambda: None,
                                    identity="r0", lease_duration=1.6,
                                    renew_deadline=1.2, retry_period=1.0,
                                    time_fn=clock, mono_fn=clock)
            out = [el.step()]
            flaky.fail_next = 1
            clock.advance(1.0)
            out.append(el.step())
            flaky.fail_next = 99
            clock.advance(1.0)
            out.append(el.step())
            clock.advance(1.0)
            out.append(el.step())
            return out
        assert both(scenario) == [True, True, False, False]

    def test_crashed_replica_drops_its_tensors(self):
        """A killed replica's restart drops its cache's persistent node
        tensors with its volatile state; it comes back a follower under a
        new identity, and the next leader's first solve builds fresh."""
        from pathlib import Path

        from volcano_tpu_torch.sim.runner import SimRunner
        conf = (Path(__file__).resolve().parents[1] / "deploy"
                / "scheduler.conf").read_text()
        runner = SimRunner(pt_workload.make_scenario("smoke", seed=3),
                           seed=3, scenario="smoke", device="cpu",
                           conf_text=conf, ha_replicas=3,
                           kill_cycles=(2,), kill_seed=2)
        seen = []
        real = runner._crash_restart_replica

        def crash(rep, mode):
            had = rep.cache.tensor_cache is not None
            real(rep, mode)
            seen.append((rep.key(), had, rep.cache.tensor_cache,
                         rep.sched.role, rep.elector.identity))
        runner._crash_restart_replica = crash
        report = runner.run()
        assert report["restarts"] == 1 and report["double_binds"] == 0
        (key, had, tc, role, ident), = seen
        assert had and tc is None
        assert role == pt_scheduler.ROLE_FOLLOWER
        assert ident == f"replica-{key[0]}-g{key[1]}"


def _chaos_run(p, scenario, seed, rate, kw):
    wrap_b = lambda b: p.chaos.ChaosBinder(b, failure_rate=rate,  # noqa
                                           seed=seed)
    wrap_e = lambda e: p.chaos.ChaosEvictor(e, failure_rate=rate,  # noqa
                                            seed=seed)
    return sim_run(p, scenario, seed, binder_wrap=wrap_b,
                   evictor_wrap=wrap_e, **kw)
