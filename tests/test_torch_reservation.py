"""The reservation plugin, the elect and reserve actions and the session's
target-job and reserved-nodes hooks in the port against the JAX package,
on the CPU.

tests/test_framework.py::TestReservationElection runs through both
packages' sessions in process; the hooks' tier dispatch and the actions'
cases likewise (none of them reaches a device program). The world is
tools/plugin_reference.py's reservation-1k (200 nodes, 800 pods in 32
gangs, and two Pending gangs of a queue whose capability keeps them
Pending) through ``enqueue, elect, allocate-tpu, backfill, reserve`` for
four cycles under both engines: its digest, with the elected target and
the locked nodes cycle by cycle, equals the JAX package's, run in a child
at XLA level 0. The reservation is a module global in both packages: every
test starts and ends with it reset.
"""

import os
import sys
import types

import pytest

import volcano_tpu.actions  # noqa: F401 (registers the actions)
import volcano_tpu.plugins  # noqa: F401 (registers the plugins)
import volcano_tpu_torch.actions  # noqa: F401
import volcano_tpu_torch.plugins  # noqa: F401
from volcano_tpu.utils.reservation import Reservation as JaxReservation
from volcano_tpu_torch.utils.reservation import Reservation

from torch_parity import port_gc_windows  # noqa: F401 (autouse)
from torch_parity import jax_reference, plugin_modules

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import plugin_reference  # noqa: E402

GI = 1 << 30
WORLDS = ("reservation-1k", "reservation-1k@callbacks")


@pytest.fixture(autouse=True)
def reservation_reset():
    Reservation.reset()
    JaxReservation.reset()
    yield
    Reservation.reset()
    JaxReservation.reset()


def _both():
    return plugin_modules(True), plugin_modules(False)


def _reservation(m):
    import importlib
    return importlib.import_module(
        m.api.__name__.split(".")[0] + ".utils.reservation").Reservation


def _cache(m, nodes=(("n0", 8000),), capability=None):
    cache = m.cache.SchedulerCache(binder=m.cache.FakeBinder(),
                                   evictor=m.cache.FakeEvictor())
    cache.add_queue(m.api.QueueInfo(name="default", weight=1,
                                    capability=capability))
    for name, cpu in nodes:
        alloc = m.api.Resource(cpu, 8 * GI)
        alloc.max_task_num = 110
        cache.add_node(m.api.NodeInfo(name=name, allocatable=alloc))
    return cache


def _pending_job(m, name, priority, created, start=None, tasks=1, cpu=1000,
                 phase=None):
    api = m.api
    pg = api.PodGroup(name=name, queue="default", min_member=tasks,
                      phase=phase or api.PodGroupPhase.PENDING)
    job = api.JobInfo(uid=name, name=name, queue="default",
                      min_available=tasks, podgroup=pg, priority=priority,
                      creation_timestamp=created)
    job.schedule_start_timestamp = start
    for k in range(tasks):
        job.add_task_info(api.TaskInfo(uid=f"{name}-{k}", name=f"{name}-{k}",
                                       job=name,
                                       resreq=api.Resource(cpu, GI)))
    return job


def _session(m, cache, plugins=("reservation",)):
    fw = m.framework
    tiers = [fw.Tier(plugins=[fw.PluginOption(n) for n in plugins])]
    return fw.open_session(cache, tiers, [], **m.kw)


def test_target_job_longest_wait_by_schedule_start():
    """reservation.go:66-117: among the highest-priority pending jobs the
    elected target is the one waiting longest on its ScheduleStartTimestamp
    (not its creation timestamp); a higher-priority job trumps wait time.
    The port elects as the JAX package does."""
    got = []
    for m in _both():
        res = _reservation(m)
        cache = _cache(m)
        # young was created first but entered scheduling last
        for name, created, start in (("young", 1.0, 300.0),
                                     ("old", 2.0, 100.0)):
            cache.add_job(_pending_job(m, name, 5, created, start))
        ssn = _session(m, cache)
        m.actions.ElectAction().execute(ssn)
        first = res.target_job.uid
        m.framework.close_session(ssn)
        res.reset()
        cache.add_job(_pending_job(m, "vip", 9, 3.0, 400.0))
        ssn = _session(m, cache)
        m.actions.ElectAction().execute(ssn)
        got.append((first, res.target_job.uid))
        m.framework.close_session(ssn)
        res.reset()
    assert got[0] == got[1] == ("old", "vip")


def test_elect_keeps_its_target_and_skips_non_pending_jobs():
    """An elected target stays until reserve resets it; only Pending jobs
    stand; with none, nothing is elected."""
    got = []
    for m in _both():
        res = _reservation(m)
        cache = _cache(m)
        cache.add_job(_pending_job(m, "inqueue", 9, 1.0, 1.0,
                                   phase=m.api.PodGroupPhase.INQUEUE))
        ssn = _session(m, cache)
        m.actions.ElectAction().execute(ssn)
        none = res.target_job
        m.framework.close_session(ssn)
        cache.add_job(_pending_job(m, "a", 1, 1.0, 1.0))
        ssn = _session(m, cache)
        m.actions.ElectAction().execute(ssn)
        m.framework.close_session(ssn)
        cache.add_job(_pending_job(m, "b", 5, 2.0, 2.0))
        ssn = _session(m, cache)
        m.actions.ElectAction().execute(ssn)
        got.append((none, res.target_job.uid))
        m.framework.close_session(ssn)
    assert got[0] == got[1] == (None, "a")


def test_reserve_locks_the_most_idle_node_each_cycle():
    """reservation.go:120-141: each reserve locks the unlocked node with the
    most idle resources (the later of equals); a target that became ready,
    or is gone from the session, resets the reservation."""
    got = []
    for m in _both():
        res = _reservation(m)
        cache = _cache(m, (("n0", 4000), ("n1", 8000), ("n2", 8000),
                           ("n3", 2000)))
        cache.add_job(_pending_job(m, "t", 9, 1.0, 1.0, tasks=2,
                                   cpu=16000))
        locked = []
        for _ in range(3):
            ssn = _session(m, cache)
            m.actions.ElectAction().execute(ssn)
            m.actions.ReserveAction().execute(ssn)
            locked.append(sorted(res.locked_nodes))
            m.framework.close_session(ssn)
        del cache.jobs["t"]
        ssn = _session(m, cache)
        m.actions.ReserveAction().execute(ssn)
        m.framework.close_session(ssn)
        got.append((locked, res.target_job, dict(res.locked_nodes)))
    assert got[0] == got[1]
    assert got[0] == ([["n2"], ["n1", "n2"], ["n0", "n1", "n2"]], None, {})


def test_reserve_resets_once_the_target_is_ready():
    got = []
    for m in _both():
        res = _reservation(m)
        cache = _cache(m)
        job = _pending_job(m, "t", 9, 1.0, 1.0)
        cache.add_job(job)
        ssn = _session(m, cache)
        m.actions.ElectAction().execute(ssn)
        task = ssn.jobs["t"].tasks["t-0"]
        ssn.allocate(task, ssn.nodes["n0"])
        m.actions.ReserveAction().execute(ssn)
        got.append((res.target_job, dict(res.locked_nodes)))
        m.framework.close_session(ssn)
    assert got[0] == got[1] == (None, {})


def test_allocate_places_onto_locked_nodes():
    """No reader of the locked nodes exists outside the plugin and its
    state: allocate binds onto a locked node, in the JAX package as in the
    port (ROADMAP §3)."""
    got = []
    for m in _both():
        res = _reservation(m)
        cache = _cache(m)
        cache.add_job(_pending_job(m, "j", 1, 1.0, 1.0,
                                   phase=m.api.PodGroupPhase.INQUEUE))
        res.locked_nodes["n0"] = cache.nodes["n0"]
        ssn = _session(m, cache, ("priority", "gang", "predicates"))
        m.actions.AllocateAction(engine="callbacks").execute(ssn)
        m.framework.close_session(ssn)
        got.append(dict(cache.binder.binds))
    assert got[0] == got[1] == {"default/j-0": "n0"}


# -- the session's hooks ---------------------------------------------------------

def _hooked(m, enabled_first=True):
    fw = m.framework
    calls = []
    # two registered plugins that register neither hook themselves
    first = fw.PluginOption("priority", enabled={} if enabled_first else {
        "enabledTargetJob": False, "enabledReservedNodes": False})
    tiers = [fw.Tier(plugins=[first]),
             fw.Tier(plugins=[fw.PluginOption("gang")])]
    ssn = fw.open_session(_cache(m), tiers, [], **m.kw)
    for name in ("priority", "gang"):
        ssn.add_target_job_fn(name, lambda jobs, n=name: n)
        ssn.add_reserved_nodes_fn(name, lambda n=name: calls.append(n))
    ssn.reserved_nodes()
    out = (ssn.target_job([]), calls)
    m.framework.close_session(ssn)
    return out


@pytest.mark.parametrize("enabled_first", [True, False])
def test_target_job_and_reserved_nodes_dispatch_as_jax(enabled_first):
    """TargetJob asks the first enabled plugin in tier order; ReservedNodes
    calls every enabled one; enableTargetJob / enableReservedNodes false
    skips a plugin."""
    port, ref = (_hooked(m, enabled_first) for m in _both())
    assert port == ref
    assert port == (("priority", ["priority", "gang"]) if enabled_first
                    else ("gang", ["gang"]))


def test_session_has_the_jax_registries():
    """node_map_fns and node_reduce_fns: registered by no plugin, kept for
    the reference's surface."""
    got = []
    for m in _both():
        ssn = _session(m, _cache(m))
        ssn.add_node_map_fn("x", len)
        ssn.add_node_reduce_fn("y", sum)
        got.append((sorted(ssn.node_map_fns), sorted(ssn.node_reduce_fns),
                    sorted(ssn.target_job_fns),
                    sorted(ssn.reserved_nodes_fns)))
        m.framework.close_session(ssn)
    assert got[0] == got[1] == (["x"], ["y"], ["reservation"],
                                ["reservation"])


def test_actions_keep_their_spans():
    """elect and reserve record the JAX package's spans, elect_target once
    a target is elected and reserve_nodes each cycle a target stands."""
    from volcano_tpu_torch.obs.trace import TRACE
    conf = plugin_reference.with_engine(plugin_reference.reservation_conf(),
                                        "callbacks")
    m = plugin_modules(True)
    # proportion keeps the gang Pending: its minimum exceeds the capability
    cache = _cache(m, capability=m.api.Resource(1000, GI))
    job = _pending_job(m, "t", 9, 1.0, 1.0, tasks=2, cpu=16000)
    job.podgroup.min_resources = m.api.Resource(32000, 2 * GI)
    cache.add_job(job)
    from volcano_tpu_torch.scheduler import Scheduler
    sched = Scheduler(cache, conf, device="cpu")
    TRACE.clear()
    TRACE.enable()
    try:
        for cycle in range(2):
            TRACE.begin_cycle(cycle)
            assert sched.run_once() == []
        TRACE.end_cycle()
        names = [ev["name"] for ev in TRACE.chrome_events()
                 if ev["ph"] == "B" and ev["name"] in ("elect_target",
                                                       "reserve_nodes")]
    finally:
        TRACE.disable()
        TRACE.clear()
    assert names == ["elect_target", "reserve_nodes", "reserve_nodes"]


# -- the world -------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_reference("plugin-world", list(WORLDS),
                         tmp_path_factory.mktemp("jax") / "reservation.pkl")


@pytest.mark.parametrize("world", WORLDS)
def test_world_equals_jax(world, reference):
    """The elected target and the locked nodes cycle by cycle, with the
    binds, PodGroups and node-tensor paths."""
    got = plugin_reference.run_world("volcano_tpu_torch", world,
                                     "cpu")["digest"]
    assert got == reference[world]
    cycles = got["per_cycle"]
    assert [c["target"] for c in cycles] == ["vip"] * 4
    assert [len(c["locked"]) for c in cycles] == [1, 2, 3, 4]
    assert cycles[-1]["podgroup_phases"]["Pending"] == 2
    assert Reservation.target_job is None
