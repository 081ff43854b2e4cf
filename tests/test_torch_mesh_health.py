"""Mesh fault containment of the port (device_health's per-slot lattice,
allocate's heal, ladder and probes, chaos.MeshFaultInjector, the sim's
mesh chaos), on the CPU over 8 slots of ops/unified.py: the 25 cases of
tests/test_mesh_health.py.

A fault attributed to one slot quarantines that slot and the mesh heals in
the same cycle, with the decisions of the healthy mesh (the sharded solve
is mesh-size invariant); an unattributed fault keeps the fleet cool-down.
The ladder (full mesh, shrunken mesh, one slot, the sequential placer)
descends a rung only when the one above is gone, and a quarantined slot
returns only through a dry-run probe. The soak at the end holds the
mesh-chaos sim to the JAX package's record
(tests/sharded_reference_digests.json, tools/sharded_reference.py).
"""

import json
import time as _time

import pytest

from volcano_tpu_torch import metrics
from volcano_tpu_torch.api import (JobInfo, NodeInfo, PodGroup,
                                   PodGroupPhase, QueueInfo, Resource,
                                   TaskInfo)
from volcano_tpu_torch.cache import (SchedulerCache, SequenceBinder,
                                     SequenceEvictor)
from volcano_tpu_torch.chaos import DeviceFaultInjector, MeshFaultInjector
from volcano_tpu_torch.device_health import (DEFAULT_COOLDOWN_S,
                                             DEVICE_HEALTH, DeviceFaultError,
                                             DeviceHealth,
                                             attribute_device_fault,
                                             classify_device_fault)
from volcano_tpu_torch.ops import unified
from volcano_tpu_torch.scheduler import Scheduler

from torch_parity import port_gc_windows  # noqa: F401 (autouse)
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GI = 1 << 30
SEED = 20260807
SLOTS = 8


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


@pytest.fixture
def mesh_rig():
    """Eight CPU slots, a virtual clock on the global lattice, and the hook
    and lattice restored after: every test leaves the process-wide state
    as it found it."""
    from volcano_tpu_torch.actions import allocate as alloc_mod
    clock = FakeClock()
    metrics.reset_local()
    DEVICE_HEALTH.reset(time_fn=clock)
    unified.set_devices(SLOTS, "cpu")
    saved_mesh = alloc_mod.CURRENT_MESH_DEVICES
    yield clock
    alloc_mod.DEVICE_FAULT_HOOK = None
    alloc_mod.CURRENT_MESH_DEVICES = saved_mesh
    unified.set_devices(None)
    DEVICE_HEALTH.reset(time_fn=_time.monotonic)


# ---------------------------------------------------------------------------
# classification and attribution
# ---------------------------------------------------------------------------

class TestFaultAttribution:
    def test_injected_device_attribute_wins(self):
        exc = DeviceFaultError("oom", device=3)
        assert attribute_device_fault(exc, (0, 1, 2, 3)) == 3

    def test_message_names_no_slot(self):
        """The JAX package attributes a message naming a shard; the port
        does not parse messages: every slot shares the card, so a real
        CUDA error names none, and only an injected fault's ``device``
        attributes."""
        for msg in ("oom on shard 5", "slot=2 failed", "shard: 3 lost",
                    "CUDA error: out of memory on device 0"):
            assert attribute_device_fault(RuntimeError(msg)) is None, msg
        assert attribute_device_fault(
            DeviceFaultError("oom", "oom on shard 5", device=2)) == 2

    def test_ordinal_outside_mesh_is_unattributed(self):
        exc = DeviceFaultError("oom", device=9)
        assert attribute_device_fault(exc, (0, 1, 2, 3)) is None

    def test_no_ordinal_is_unattributed(self):
        assert attribute_device_fault(
            RuntimeError("CUDA error: out of memory")) is None

    def test_classify_kinds(self):
        import torch
        assert classify_device_fault(
            torch.cuda.OutOfMemoryError("x")) == "oom"
        assert classify_device_fault(RuntimeError(
            "CUDA error: an illegal memory access was encountered")) \
            == "device_lost"
        assert classify_device_fault(RuntimeError("CUDA error: weird")) \
            == "xla"
        assert classify_device_fault(ValueError("not a device")) is None
        assert classify_device_fault(DeviceFaultError("slow")) == "slow"


# ---------------------------------------------------------------------------
# the per-slot lattice
# ---------------------------------------------------------------------------

class TestDeviceLattice:
    def mk(self, clock):
        return DeviceHealth(cooldown_s=10.0, max_cooldown_s=40.0,
                            time_fn=clock)

    def test_per_device_windows_double_independently(self, mesh_rig):
        clock = mesh_rig
        dh = self.mk(clock)
        assert dh.quarantine(2, "oom") == 10.0
        clock.now = 11.0
        assert dh.device_state(2) == "probe"
        assert dh.quarantine(2, "oom") == 20.0
        assert dh.quarantine(3, "device_lost") == 10.0
        clock.now = 80.0
        assert dh.quarantine(2, "oom") == 40.0

    def test_fault_inside_open_window_dedups(self, mesh_rig):
        dh = self.mk(mesh_rig)
        dh.quarantine(2, "oom")
        dh.quarantine(2, "device_lost")
        d = dh.detail()["devices"]["2"]
        assert d["consecutive_faults"] == 1
        assert d["last_kind"] == "device_lost"

    def test_probe_never_live(self, mesh_rig):
        clock = mesh_rig
        dh = self.mk(clock)
        dh.quarantine(1, "oom")
        assert dh.healthy_devices([0, 1, 2]) == [0, 2]
        assert dh.probe_candidates([0, 1, 2]) == []
        clock.now = 11.0
        assert dh.device_state(1) == "probe"
        assert dh.healthy_devices([0, 1, 2]) == [0, 2]
        assert dh.probe_candidates([0, 1, 2]) == [1]

    def test_readmit_resets_and_counts(self, mesh_rig):
        dh = self.mk(mesh_rig)
        dh.quarantine(1, "oom")
        dh.readmit(1)
        assert dh.device_state(1) == "ok"
        assert dh.healthy_devices([0, 1]) == [0, 1]
        d = dh.detail()["devices"]["1"]
        assert (d["consecutive_faults"], d["readmissions"],
                d["total_faults"]) == (0, 1, 1)
        dh.readmit(0)
        assert dh.detail()["devices"]["0"]["readmissions"] == 0

    def test_unattributed_suspects_all_but_keeps_mesh(self, mesh_rig):
        dh = self.mk(mesh_rig)
        dh.healthy_devices([0, 1, 2, 3])
        assert dh.record_fault("oom") == 10.0
        assert not dh.available()
        assert all(dh.device_state(i) == "suspect" for i in range(4))
        assert dh.healthy_devices([0, 1, 2, 3]) == [0, 1, 2, 3]
        dh.record_ok()
        assert dh.available()
        assert all(dh.device_state(i) == "ok" for i in range(4))

    def test_attributed_fault_keeps_fleet_window_closed(self, mesh_rig):
        dh = self.mk(mesh_rig)
        dh.quarantine(5, "device_lost")
        assert dh.available()

    def test_record_fault_with_device_delegates(self, mesh_rig):
        dh = self.mk(mesh_rig)
        dh.record_fault("oom", device=4)
        assert dh.device_state(4) == "quarantined"
        assert dh.available()

    def test_reset_clears_lattice(self, mesh_rig):
        dh = self.mk(mesh_rig)
        dh.quarantine(1, "oom")
        dh.record_fault("oom")
        dh.reset(time_fn=mesh_rig)
        d = dh.detail()
        assert d["devices_known"] == 0 and d["available"]
        assert d["consecutive_faults"] == 0


class TestDegradationRung:
    def test_rungs(self):
        from volcano_tpu_torch.actions.allocate import _degradation_rung
        assert _degradation_rung(8, 8) == 0
        assert _degradation_rung(1, 1) == 0
        assert _degradation_rung(8, 5) == 1
        assert _degradation_rung(8, 1) == 2
        assert _degradation_rung(8, 0) == 3


# ---------------------------------------------------------------------------
# MeshFaultInjector
# ---------------------------------------------------------------------------

class TestMeshFaultInjector:
    def test_plan_mode_targets_a_live_shard(self, mesh_rig):
        from volcano_tpu_torch.actions import allocate as alloc_mod
        alloc_mod.CURRENT_MESH_DEVICES = (0, 1, 2, 3)
        inj = MeshFaultInjector({"oom": [2]}, seed=SEED)
        inj("tpu-sharded")
        with pytest.raises(DeviceFaultError) as ei:
            inj("tpu-sharded")
        assert ei.value.kind == "oom" and ei.value.device in (0, 1, 2, 3)
        assert inj.injected == [(2, "oom", ei.value.device)]

    def test_probe_calls_target_the_probed_device(self, mesh_rig):
        inj = MeshFaultInjector({"device_lost": [1]}, seed=SEED)
        with pytest.raises(DeviceFaultError) as ei:
            inj("tpu-sharded:probe:5")
        assert ei.value.device == 5 and ei.value.kind == "device_lost"

    def test_empty_mesh_is_a_noop(self, mesh_rig):
        from volcano_tpu_torch.actions import allocate as alloc_mod
        alloc_mod.CURRENT_MESH_DEVICES = ()
        inj = MeshFaultInjector({"oom": [1]}, seed=SEED)
        inj("tpu-sharded")
        assert inj.injected == []

    def test_rate_mode_is_seed_deterministic(self, mesh_rig):
        from volcano_tpu_torch.actions import allocate as alloc_mod
        alloc_mod.CURRENT_MESH_DEVICES = tuple(range(8))

        def run(seed):
            inj = MeshFaultInjector({"oom": (), "device_lost": (),
                                     "slow": ()},
                                    failure_rate=0.3, seed=seed)
            for _ in range(30):
                try:
                    inj("tpu-sharded")
                except DeviceFaultError:
                    pass
            return inj.injected

        a, b, c = run(7), run(7), run(8)
        assert a == b and a != c and a
        assert {k for _, k, _ in a} > {"oom"}


# ---------------------------------------------------------------------------
# allocate: heal, ladder, probe, readmit
# ---------------------------------------------------------------------------

SHARDED_CONF = (
    'actions: "allocate-tpu"\n'
    "tiers:\n- plugins:\n  - name: priority\n  - name: gang\n"
    "- plugins:\n  - name: drf\n  - name: proportion\n"
    "configurations:\n- name: allocate-tpu\n"
    "  arguments:\n    engine: tpu-sharded\n")


def build_cluster():
    binder = SequenceBinder()
    cache = SchedulerCache(binder=binder, evictor=SequenceEvictor())
    for i in range(8):
        alloc = Resource(16000, 32 * GI)
        alloc.max_task_num = 110
        cache.add_node(NodeInfo(name=f"n{i}", allocatable=alloc))
    for j in range(4):
        pg = PodGroup(name=f"j{j}", queue="default", min_member=3,
                      phase=PodGroupPhase.INQUEUE)
        job = JobInfo(uid=f"j{j}", name=f"j{j}", queue="default",
                      min_available=3, podgroup=pg)
        for k in range(3):
            job.add_task_info(TaskInfo(
                uid=f"j{j}-{k}", name=f"j{j}-{k}", job=f"j{j}",
                resreq=Resource(1000, GI)))
        cache.add_job(job)
    return cache, binder


def sched_of(cache, conf=SHARDED_CONF, **kw):
    return Scheduler(cache, conf_text=conf, schedule_period=0.0,
                     drift_verify_every=0, device="cpu", **kw)


class TestMeshHeal:
    def test_attributed_fault_heals_same_cycle_byte_identical(
            self, mesh_rig):
        from volcano_tpu_torch.actions import allocate as alloc_mod
        healthy_cache, healthy_binder = build_cluster()
        assert not sched_of(healthy_cache).run_once()
        cache, binder = build_cluster()
        inj = MeshFaultInjector({"oom": [1]}, seed=SEED)
        alloc_mod.DEVICE_FAULT_HOOK = inj
        epoch_before = cache._snap_epoch
        assert not sched_of(cache).run_once()
        assert len(inj.injected) == 1
        _, kind, device = inj.injected[0]
        assert DEVICE_HEALTH.device_state(device) == "quarantined"
        assert DEVICE_HEALTH.available()
        assert cache._snap_epoch > epoch_before
        assert not alloc_mod.LAST_FALLBACK
        counts = metrics.mesh_counts()
        assert counts.get(f"heals/{kind}") == 1
        assert counts.get(f"quarantines/{kind}") == 1
        assert counts["rung"] == 1 and counts["devices_healthy"] == 7
        assert binder.binds == healthy_binder.binds and binder.binds

    def test_probe_readmits_with_epoch_bump(self, mesh_rig):
        from volcano_tpu_torch.actions import allocate as alloc_mod
        clock = mesh_rig
        cache, _ = build_cluster()
        inj = MeshFaultInjector({"device_lost": [1]}, seed=SEED)
        alloc_mod.DEVICE_FAULT_HOOK = inj
        sched = sched_of(cache)
        assert not sched.run_once()
        device = inj.injected[0][2]
        assert DEVICE_HEALTH.device_state(device) == "quarantined"
        probes = []
        alloc_mod.DEVICE_FAULT_HOOK = \
            lambda engine: probes.append(engine) \
            if ":probe:" in engine else None
        clock.now += DEFAULT_COOLDOWN_S + 1.0
        assert DEVICE_HEALTH.device_state(device) == "probe"
        epoch_before = cache._snap_epoch
        assert not sched.run_once()
        assert probes == [f"tpu-sharded:probe:{device}"]
        assert DEVICE_HEALTH.device_state(device) == "ok"
        assert DEVICE_HEALTH.detail()["devices"][str(device)][
            "readmissions"] == 1
        assert cache._snap_epoch > epoch_before
        assert metrics.mesh_counts()["rung"] == 0
        assert metrics.mesh_counts()["devices_healthy"] == 8

    def test_probe_failure_doubles_window_and_stays_out(self, mesh_rig):
        from volcano_tpu_torch.actions import allocate as alloc_mod
        clock = mesh_rig
        cache, _ = build_cluster()
        inj = MeshFaultInjector({"oom": [1]}, seed=SEED)
        alloc_mod.DEVICE_FAULT_HOOK = inj
        sched = sched_of(cache)
        assert not sched.run_once()
        device = inj.injected[0][2]

        def failing_probe(engine):
            if ":probe:" in engine:
                raise DeviceFaultError(
                    "device_lost", device=int(engine.rsplit(":", 1)[1]))

        alloc_mod.DEVICE_FAULT_HOOK = failing_probe
        clock.now += DEFAULT_COOLDOWN_S + 1.0
        assert not sched.run_once()
        d = DEVICE_HEALTH.detail()["devices"][str(device)]
        assert d["state"] == "quarantined"
        assert (d["consecutive_faults"], d["readmissions"]) == (2, 0)
        assert d["window_remaining_s"] == pytest.approx(
            2 * DEFAULT_COOLDOWN_S, abs=1.0)

    def test_cpu_rung_only_at_zero_healthy(self, mesh_rig):
        from volcano_tpu_torch.actions import allocate as alloc_mod
        cache, binder = build_cluster()
        for did in range(7):
            DEVICE_HEALTH.quarantine(did, "oom")
        assert not sched_of(cache).run_once()
        assert metrics.mesh_counts()["rung"] == 2
        assert not alloc_mod.LAST_FALLBACK
        assert binder.binds
        DEVICE_HEALTH.quarantine(7, "oom")
        cache2, binder2 = build_cluster()
        assert not sched_of(cache2).run_once()
        assert metrics.mesh_counts()["rung"] == 3
        assert alloc_mod.LAST_FALLBACK.get("error") == "device cool-down"
        assert len(binder2.binds) == len(binder.binds)

    def test_unattributed_fault_keeps_fleet_semantics(self, mesh_rig):
        from volcano_tpu_torch.actions import allocate as alloc_mod
        cache, binder = build_cluster()
        alloc_mod.DEVICE_FAULT_HOOK = DeviceFaultInjector({"oom": [1]},
                                                          seed=SEED)
        assert not sched_of(cache).run_once()
        assert not DEVICE_HEALTH.available()
        assert all(DEVICE_HEALTH.device_state(d) == "suspect"
                   for d in range(SLOTS))
        assert alloc_mod.LAST_FALLBACK.get("engine") == "tpu-sharded"
        assert len(binder.binds) == \
            sum(len(j.tasks) for j in cache.jobs.values())


# speculation: the pipelined shell dispatches no tpu-sharded solve ahead,
# so a mesh that changed between cycles is solved over as it is then
# ---------------------------------------------------------------------------

PIPELINED_SHARDED_CONF = (
    'actions: "enqueue, allocate-tpu, backfill"\n'
    "tiers:\n- plugins:\n  - name: priority\n  - name: gang\n"
    "- plugins:\n  - name: drf\n  - name: proportion\n"
    "configurations:\n- name: allocate-tpu\n"
    "  arguments:\n    engine: tpu-sharded\n")


def build_pending_cluster():
    """Four 2-CPU nodes and 30 gangs of two 1-CPU tasks: capacity for
    four gangs a cycle, the rest pending."""
    binder = SequenceBinder()
    cache = SchedulerCache(binder=binder, evictor=SequenceEvictor(),
                           default_queue=None)
    cache.add_queue(QueueInfo(name="q1", weight=1))
    for i in range(4):
        alloc = Resource(2000, 64 * GI)
        alloc.max_task_num = 100
        cache.add_node(NodeInfo(name=f"n{i}", allocatable=alloc))
    for j in range(30):
        pg = PodGroup(name=f"j{j}", queue="q1", min_member=2,
                      phase=PodGroupPhase.PENDING)
        job = JobInfo(uid=f"j{j}", name=f"j{j}", queue="q1",
                      min_available=2, podgroup=pg,
                      creation_timestamp=float(j))
        for t in range(2):
            job.add_task_info(TaskInfo(
                uid=f"j{j}-{t}", name=f"j{j}-{t}", job=f"j{j}",
                resreq=Resource(1000, GI),
                creation_timestamp=float(j) + t * 1e-6))
        cache.add_job(job)
    return cache, binder


class TestSpeculationMeshConflict:
    def test_mesh_change_between_pipelined_cycles_uses_live_mesh(
            self, mesh_rig):
        """The JAX package's test_mesh_change_mid_speculation_is_conflict
        makes a mesh change between a speculative dispatch and its commit
        a conflict. The port's pipelined shell dispatches no tpu-sharded solve ahead (the
        block auction reads a flag a pass on the host), so there is no
        speculation for the change to hit: the cycle after a slot is
        quarantined solves over the live mesh of the other slots, and the
        binds equal the serial shell's under the same change."""
        binds = {}
        for pipelined in (True, False):
            DEVICE_HEALTH.reset(time_fn=mesh_rig)
            cache, binder = build_pending_cluster()
            sched = sched_of(cache, PIPELINED_SHARDED_CONF,
                             pipelined=pipelined)
            allocate = next(a for a in sched.actions
                            if a.name() == "allocate-tpu")
            assert not sched.run_once()
            assert sched._spec is None
            assert allocate.last_stats["mesh_devices"] == SLOTS
            DEVICE_HEALTH.quarantine(SLOTS - 1, "oom")
            cache.invalidate_device_state()
            assert not sched.run_once()
            assert sched._spec is None
            assert allocate.last_stats["mesh_devices"] == SLOTS - 1
            binds[pipelined] = dict(binder.binds)
        assert binds[True] == binds[False]
        assert len(binds[True]) == 8


# ---------------------------------------------------------------------------
# sim soak: faults x kills, the one-slot oracle, the JAX record
# ---------------------------------------------------------------------------

def test_mesh_chaos_soak_with_kills_matches_oracle(mesh_rig):
    """Seeded mesh faults of all three kinds composed with kills: every
    gang completes, no double bind, no CPU-rung cycle, a quarantined slot
    readmitted, the decision plane equal to the fault-free one-slot oracle
    under the same kills and equal, with the mesh section, to the JAX
    package's record of ``--scenario mesh-chaos --mesh-chaos
    --verify-mesh-equivalence --kill-cycles 6,17 --deterministic``."""
    import contextlib
    import io
    import os

    from volcano_tpu_torch.sim.__main__ import main as sim_main
    from volcano_tpu_torch.sim.report import deterministic_json, oracle_part
    from volcano_tpu_torch.sim.runner import SimRunner, sharded_sim_conf
    from volcano_tpu_torch.sim.workload import make_scenario

    trace = make_scenario("smoke", seed=SEED)
    kills = [6, 17]

    def faulted():
        return SimRunner(trace, conf_text=sharded_sim_conf(0), seed=SEED,
                         scenario="smoke", kill_cycles=kills,
                         mesh_fault_rate=0.2, mesh_fault_seed=2,
                         device="cpu")

    runner = faulted()
    rep = runner.run()
    mesh = rep["mesh"]
    assert sum(mesh["injected"].values()) > 0
    assert sum(mesh["heals"].values()) >= 1
    assert mesh["readmissions"] >= 1
    assert mesh["cpu_fallback_cycles"] == 0
    assert runner.restarts == len(kills) and runner.double_binds == 0
    assert rep["jobs"]["completed"] == rep["jobs"]["arrived"]
    assert deterministic_json(rep) == deterministic_json(faulted().run())
    orep = SimRunner(trace, conf_text=sharded_sim_conf(1), seed=SEED,
                     scenario="smoke", kill_cycles=kills,
                     device="cpu").run()
    assert "mesh" not in orep
    assert deterministic_json(oracle_part(rep)) == \
        deterministic_json(oracle_part(orep))

    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import sharded_reference
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = sim_main(sharded_reference.SIMS["sim-mesh-chaos"]
                      + ["--device", "cpu"])
    assert rc == 0
    want = {k: v for k, v in
            sharded_reference.load_digests()["sim-mesh-chaos"].items()
            if k != "jax_wall_s"}
    assert sharded_reference.sim_plane(out.getvalue()) == want
    assert json.loads(out.getvalue())["mesh"]["readmissions"] >= 1
