"""Device containment in volcano_tpu_torch against the JAX package: the
fleet cool-down state machine (``device_health.DeviceHealth``), the fault classification retargeted to
what PyTorch raises, and the allocate action's solver fallback, held to
the JAX package's decisions under the same DeviceFaultInjector scripts.

The state-machine cases are the fleet window's host-only ones of
tests/test_journal_recovery.py::TestDeviceFaultContainment, run against
both packages' classes on one fake clock. The fallback cases run
``tests/torch_parity.py::containment_drive`` through the port on the CPU
and through the JAX package in a child process (without FMA contraction,
as every JAX reference of these tests). The rest is the port's narrowing
of the JAX package's catch: a kernel that does not build or launch or
writes a malformed wire, a CUDA error raised at a sync, a CPU tensor at a
CUDA wrapper and a failed batched replay stay failed actions with every
fallback counter at 0.
"""

import logging
import time

import numpy as np
import pytest
import torch

import torch_parity as tp
import volcano_tpu.device_health as jax_dh
import volcano_tpu_torch.device_health as pt_dh
from volcano_tpu_torch import Scheduler, metrics
from volcano_tpu_torch.actions import allocate
from volcano_tpu_torch.actions.allocate import ReplayFault, SolverFault
from volcano_tpu_torch.chaos import DeviceFaultInjector
from volcano_tpu_torch.device_health import (DEVICE_HEALTH, DeviceFaultError,
                                             classify_device_fault)
from volcano_tpu_torch.ops.build import KernelError


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


@pytest.fixture
def rig():
    """A fresh fake clock on the port's DEVICE_HEALTH and clean metrics;
    the hook and the clock are restored after."""
    clock = FakeClock()
    metrics.reset_local()
    DEVICE_HEALTH.reset(time_fn=clock)
    yield clock
    allocate.DEVICE_FAULT_HOOK = None
    allocate.LAST_FALLBACK.clear()
    DEVICE_HEALTH.reset(time_fn=time.monotonic)


# ---------------------------------------------------------------------------
# the state machine, both packages on one fake clock
# ---------------------------------------------------------------------------

# each script is a list of (operation, arguments); "advance" moves the
# clock, "window" moves it one second past the window; every other
# operation is a DeviceHealth method whose return value is recorded, of
# "detail" the fleet window's keys (detail adds the per-slot lattice's,
# LATTICE_KEYS, held by tests/test_torch_mesh_health.py)
FLEET_KEYS = ("available", "consecutive_faults", "total_faults",
              "last_kind", "cooldown_remaining_s")
LATTICE_KEYS = ("devices", "devices_known", "devices_healthy",
                "devices_quarantined")
HEALTH_SCRIPTS = {
    # tests/test_journal_recovery.py::test_repeated_faults_double_the_window
    "repeated-faults-double": [
        ("record_fault", ("oom",)), ("window",), ("available",),
        ("record_fault", ("device_lost",)), ("detail",), ("record_ok",),
        ("detail",)],
    # the fleet window opens, dedups inside, expires into PROBE, closes
    "fleet-window": [
        ("available",), ("record_fault", ("oom",)), ("available",),
        ("cooldown_remaining",), ("advance", 10.0),
        ("record_fault", ("device_lost",)), ("cooldown_remaining",),
        ("detail",), ("window",), ("available",), ("record_ok",),
        ("available",), ("detail",)],
    # the window doubles up to its cap
    "window-cap": [("record_fault", ("oom",)), ("window",)] * 6
    + [("detail",)],
    "reset-clears-the-window": [
        ("record_fault", ("oom",)), ("record_fault", ("oom",)), ("reset",),
        ("detail",), ("available",)],
}


def _run_health_script(module, script):
    clock = FakeClock()
    health = module.DeviceHealth(time_fn=clock)
    out = []
    for step in script:
        op, args = step[0], step[1] if len(step) > 1 else ()
        if op == "advance":
            clock.now += args
            continue
        if op == "window":
            clock.now += health.cooldown_remaining() + 1.0
            continue
        value = getattr(health, op)(*args)
        if op == "detail":
            value = {k: value[k] for k in FLEET_KEYS}
        out.append((op, value))
    return out


@pytest.mark.parametrize("name", sorted(HEALTH_SCRIPTS))
def test_health_state_machine_equals_jax(name):
    script = HEALTH_SCRIPTS[name]
    want = _run_health_script(jax_dh, script)
    got = _run_health_script(pt_dh, script)
    assert got == want
    assert any(v not in (None, True) for _, v in got), "a script of no-ops"


def test_detail_is_the_fleet_window():
    """The fleet window's keys, then the per-slot lattice's (slice 19), in
    the JAX package's order."""
    from volcano_tpu.device_health import DeviceHealth as JaxHealth
    assert tuple(pt_dh.DeviceHealth().detail()) \
        == FLEET_KEYS + LATTICE_KEYS == tuple(JaxHealth().detail())


# ---------------------------------------------------------------------------
# the classification boundary
# ---------------------------------------------------------------------------

AcceleratorError = type("AcceleratorError", (RuntimeError,), {})

CLASSIFY_CASES = [
    ("oom", torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 96.00 GiB"), "oom"),
    ("cuda-illegal-address", RuntimeError(
        "CUDA error: an illegal memory access was encountered"),
     "device_lost"),
    ("cuda-launch-failure", RuntimeError(
        "CUDA error: unspecified launch failure"), "device_lost"),
    ("cuda-device-assert", RuntimeError(
        "CUDA error: device-side assert triggered"), "device_lost"),
    ("cuda-ecc", RuntimeError(
        "CUDA error: uncorrectable ECC error encountered"), "device_lost"),
    ("cuda-oom-message", RuntimeError("CUDA error: out of memory"), "oom"),
    ("cuda-other", RuntimeError(
        "CUDA error: invalid configuration argument"), pt_dh.GENERIC_KIND),
    ("accelerator-error", AcceleratorError(
        "CUDA error: an illegal memory access was encountered"),
     "device_lost"),
    ("injected", DeviceFaultError("slow"), "slow"),
    ("kernel-launch", KernelError(
        "place_cuda: kernel launch failed with cudaError_t 719"), None),
    ("kernel-build", KernelError("nvcc failed for place (exit 1)"), None),
    ("kernel-cuda-text", KernelError("CUDA error: from the C entry"), None),
    ("value-error", ValueError("place_cuda: tensors are on cpu, not a CUDA "
                               "device"), None),
    ("type-error", TypeError("place_cuda: req is torch.float64"), None),
    ("solver-fault", SolverFault("non-finite score weights"), None),
    ("runtime-error", RuntimeError("no CUDA device; pass device='cpu'"),
     None),
]


@pytest.mark.parametrize("exc, kind", [c[1:] for c in CLASSIFY_CASES],
                         ids=[c[0] for c in CLASSIFY_CASES])
def test_classification_boundary(exc, kind):
    assert classify_device_fault(exc) == kind


def test_generic_kind_is_the_jax_packages():
    """A CUDA error that is neither an OOM nor sticky counts under the JAX
    package's generic kind, so both packages' device_faults labels
    agree."""
    xla = type("XlaRuntimeError", (RuntimeError,), {})
    assert jax_dh.classify_device_fault(xla("INTERNAL: boom")) \
        == pt_dh.GENERIC_KIND


# ---------------------------------------------------------------------------
# fallback decisions against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def containment_reference(tmp_path_factory):
    return tp.jax_reference("containment", tp.CONTAINMENT_CASES,
                            tmp_path_factory.mktemp("jax") / "c.pkl")


@pytest.mark.parametrize("name", tp.CONTAINMENT_CASES)
def test_fallback_decisions_equal_jax(name, containment_reference):
    """Binds, LAST_FALLBACK, the cool-down's transitions, the hook's
    attempts (none in a degraded cycle, one at the probe) and the
    counters, cycle by cycle."""
    got = tp.containment_drive(True, name)
    assert got == containment_reference[name]
    cycles = got["cycles"]
    script = name.split(":")[1]
    if script in ("oom", "lost-twice"):
        assert cycles[0]["fallback"]["engine"] == name.split(":")[0]
        assert cycles[1]["fallback"]["error"] == "device cool-down"
        assert cycles[1]["attempts"] == 0
        assert cycles[2]["attempts"] == 1
        assert all(c["errors"] == [] for c in cycles)
        assert all(c["binds"] for c in cycles[:3])
    if script == "no-fallback":
        assert [c["errors"] for c in cycles[:2]] == [
            [("allocate-tpu", "DeviceFaultError")],
            [("allocate-tpu", "RuntimeError")]]


def test_fallback_is_visible(rig, caplog):
    """Every place the contract names shows the fallback and the degraded
    cycle: LAST_FALLBACK, last_stats["fallback"], the counters, the device
    section of health_detail and an error log line; the shell sees no
    action error."""
    cache = _small_world()
    sched = Scheduler(cache, tp.CONTAINMENT_CONF.format(
        engine="tpu-fused", fallback="true"), device="cpu")
    allocate.DEVICE_FAULT_HOOK = DeviceFaultInjector({"oom": [1]})
    with caplog.at_level(logging.ERROR):
        assert sched.run_once() == []
    action = [a for a in sched.actions if a.name() == "allocate-tpu"][0]
    assert action.last_stats["fallback"] == allocate.LAST_FALLBACK
    assert allocate.LAST_FALLBACK["engine"] == "tpu-fused"
    assert "DeviceFaultError" in allocate.LAST_FALLBACK["error"]
    counts = metrics.containment_counts()
    assert counts == {"solver_fallback/allocate-tpu": 1.0,
                      "device_faults/oom": 1.0}
    device = metrics.health_detail()["device"]
    assert device["available"] is False and device["last_kind"] == "oom"
    assert any("device fault (oom)" in r.getMessage()
               for r in caplog.records if r.levelno >= logging.ERROR)
    assert any("completing the cycle with the sequential placer"
               in r.getMessage() for r in caplog.records)
    assert len(cache.binder.sequence) > 0
    # the degraded cycle
    assert sched.run_once() == []
    assert action.last_stats["fallback"] == {
        "engine": "tpu-fused", "error": "device cool-down"}
    assert metrics.containment_counts()["device_degraded_cycles"] == 1.0


def _small_world(n_jobs=12):
    from volcano_tpu_torch.api import (JobInfo, NodeInfo, PodGroup,
                                       PodGroupPhase, QueueInfo, Resource,
                                       TaskInfo)
    from volcano_tpu_torch.cache import SchedulerCache, SequenceBinder
    gi = 1 << 30
    cache = SchedulerCache(binder=SequenceBinder(), default_queue=None)
    cache.add_queue(QueueInfo(name="q1", weight=1))
    for i in range(4):
        alloc_r = Resource(4000, 64 * gi)
        alloc_r.max_task_num = 100
        cache.add_node(NodeInfo(name=f"n{i}", allocatable=alloc_r))
    for j in range(n_jobs):
        uid = f"j{j}"
        pg = PodGroup(name=uid, queue="q1", min_member=2,
                      phase=PodGroupPhase.PENDING)
        job = JobInfo(uid=uid, name=uid, queue="q1", min_available=2,
                      podgroup=pg, creation_timestamp=float(j))
        for t in range(2):
            job.add_task_info(TaskInfo(
                uid=f"{uid}-{t}", name=f"{uid}-{t}", job=uid,
                resreq=Resource(1000, gi), creation_timestamp=j + t * 1e-6))
        cache.add_job(job)
    return cache


def test_solve_deadline_opens_the_window(rig):
    cache = _small_world()
    sched = Scheduler(cache, tp.CONTAINMENT_CONF.format(
        engine="tpu-fused", fallback="true"), device="cpu",
        solve_deadline_s=1e-9)
    assert sched.run_once() == []
    assert not DEVICE_HEALTH.available()
    assert DEVICE_HEALTH.detail()["last_kind"] == "slow_solve"
    assert metrics.containment_counts() == {"device_faults/slow_solve": 1.0}
    assert allocate.LAST_FALLBACK == {}
    # the next cycle is degraded and never reaches the hook
    hook = DeviceFaultInjector({})
    allocate.DEVICE_FAULT_HOOK = hook
    assert sched.run_once() == []
    assert hook.attempt == 0
    assert allocate.LAST_FALLBACK["error"] == "device cool-down"


def test_solver_fallback_false_raises_in_the_cool_down(rig):
    rig.now = 0.0
    DEVICE_HEALTH.record_fault("oom")
    cache = _small_world()
    sched = Scheduler(cache, tp.CONTAINMENT_CONF.format(
        engine="tpu-fused", fallback="false"), device="cpu")
    errors = sched.run_once()
    assert [n for n, _ in errors] == ["allocate-tpu"]
    assert "solver-fallback is disabled" in str(errors[0][1])
    assert len(cache.binder.sequence) == 0


def test_speculative_dispatch_waits_out_the_cool_down(rig):
    from volcano_tpu_torch.api import PodGroupPhase
    from volcano_tpu_torch.framework import open_session, abandon_session
    cache = _small_world()
    for job in cache.jobs.values():
        job.podgroup.phase = PodGroupPhase.INQUEUE
    sched = Scheduler(cache, tp.CONTAINMENT_CONF.format(
        engine="tpu-fused", fallback="true"), device="cpu")
    DEVICE_HEALTH.record_fault("oom")
    ssn = open_session(cache, sched.conf.tiers, sched.conf.configurations,
                       device="cpu")
    try:
        assert allocate.dispatch_speculative_solve(ssn) is None
        rig.now += DEVICE_HEALTH.cooldown_remaining() + 1.0
        assert allocate.dispatch_speculative_solve(ssn) is not None
    finally:
        abandon_session(ssn)


# ---------------------------------------------------------------------------
# what never enters the fallback
# ---------------------------------------------------------------------------

def _kernel_launch(*a, **k):
    raise KernelError("place_cuda: kernel launch failed with cudaError_t "
                      "719 (injected)")


def _kernel_build(*a, **k):
    raise KernelError("nvcc failed for place (exit 1):\nerror")


def _kernel_library(*a, **k):
    raise KernelError("the place kernel library did not load")


def _cpu_tensor_at_cuda_wrapper(idle, future_idle, used, ntasks,
                                allocatable, max_tasks, req, flags,
                                ready_need, keep_need, masked_static,
                                weights, cluster=None):
    from volcano_tpu_torch.ops import place as place_mod
    return place_mod.place_cuda(idle, future_idle, used, ntasks,
                                allocatable, max_tasks, req, flags,
                                ready_need, keep_need, masked_static,
                                weights, cluster)


def _shape_error(*a, **k):
    raise ValueError("place_cuda: req has shape (3, 2), not (4, 2)")


_REAL_PLACE = allocate.place


def _malformed_wire(*a, **k):
    """The placement kernel's result with one node index past the last
    node, as a kernel that writes out of its range would give it."""
    res = _REAL_PLACE(*a, **k)
    task_node = res.task_node.copy()
    task_node[0] = 1 << 20
    return res._replace(task_node=task_node)


NEVER_CASES = {
    "kernel-launch": ("solve", _kernel_launch, KernelError),
    "kernel-build": ("solve", _kernel_build, KernelError),
    "kernel-library": ("solve", _kernel_library, KernelError),
    "cpu-tensor-at-cuda-wrapper": ("plain", _cpu_tensor_at_cuda_wrapper,
                                   ValueError),
    "shape-check": ("plain", _shape_error, ValueError),
    "malformed-wire": ("solve", _malformed_wire, KernelError),
}


@pytest.mark.parametrize("engine", ["tpu-fused", "tpu-strict"])
@pytest.mark.parametrize("case", sorted(NEVER_CASES))
def test_kernel_failures_stay_failed_actions(rig, monkeypatch, case,
                                             engine):
    """A kernel that does not build, load or launch or writes a malformed
    wire, or a wrapper's device, type or shape check, fails the allocate
    action with its own error:
    every fallback counter stays at 0, the cool-down stays closed and
    nothing binds through the sequential placer."""
    from volcano_tpu_torch.ops import place as place_mod
    where, fn, exc_type = NEVER_CASES[case]
    if where == "solve":
        monkeypatch.setattr(allocate, "place", fn)
    else:
        monkeypatch.setattr(place_mod, "place_plain", fn)
    cache = _small_world()
    sched = Scheduler(cache, tp.CONTAINMENT_CONF.format(
        engine=engine, fallback="true"), device="cpu")
    errors = sched.run_once()
    assert [n for n, _ in errors] == ["allocate-tpu"]
    assert isinstance(errors[0][1], exc_type)
    assert metrics.containment_counts() == {}
    assert DEVICE_HEALTH.available()
    assert allocate.LAST_FALLBACK == {}
    assert len(cache.binder.sequence) == 0


CUDA_SYNC_CASES = [
    ("illegal-address", RuntimeError(
        "CUDA error: an illegal memory access was encountered"),
     "device_lost"),
    ("misaligned-address", RuntimeError("CUDA error: misaligned address"),
     "device_lost"),
    ("launch-failure", RuntimeError(
        "CUDA error: unspecified launch failure"), "device_lost"),
    ("device-assert", AcceleratorError(
        "CUDA error: device-side assert triggered"), "device_lost"),
    ("other", RuntimeError("CUDA error: invalid resource handle"),
     pt_dh.GENERIC_KIND),
]


@pytest.mark.parametrize("engine", ["tpu-fused", "tpu-strict"])
@pytest.mark.parametrize("exc, kind", [c[1:] for c in CUDA_SYNC_CASES],
                         ids=[c[0] for c in CUDA_SYNC_CASES])
def test_cuda_error_at_sync_fails_the_action(rig, monkeypatch, exc, kind,
                                             engine):
    """A CUDA error raised at a sync or a fetch after the solve's launches
    is what a faulty hand kernel raises too: it is counted, opens the
    cool-down and drops the device tensors, and the allocate action fails
    with it. No solver fallback and no degraded cycle is counted, and
    nothing binds through the sequential placer."""
    def solve_then_sync(*a, **k):
        _REAL_PLACE(*a, **k)
        raise exc

    monkeypatch.setattr(allocate, "place", solve_then_sync)
    cache = _small_world()
    invalidated = []
    real_invalidate = cache.invalidate_device_state
    cache.invalidate_device_state = lambda: (invalidated.append(1),
                                             real_invalidate())
    sched = Scheduler(cache, tp.CONTAINMENT_CONF.format(
        engine=engine, fallback="true"), device="cpu")
    errors = sched.run_once()
    assert [(n, e) for n, e in errors] == [("allocate-tpu", exc)]
    assert metrics.containment_counts() == {f"device_faults/{kind}": 1.0}
    assert not DEVICE_HEALTH.available()
    assert DEVICE_HEALTH.detail()["last_kind"] == kind
    assert invalidated == [1]
    assert allocate.LAST_FALLBACK == {}
    assert len(cache.binder.sequence) == 0


def test_missing_gpu_fails_the_entry_point(rig, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scheduler(_small_world(), tp.CONTAINMENT_CONF.format(
            engine="tpu-fused", fallback="true"))
    assert metrics.containment_counts() == {}


def test_replay_fault_poisons_the_cycle(rig, monkeypatch):
    """A raise inside the statement-free replay is a ReplayFault: it never
    enters the fallback and the shell aborts the rest of the cycle."""
    def broken(ssn, sol):
        raise KeyError("half applied")

    monkeypatch.setattr(allocate, "_replay_fused_fast", broken)
    cache = _small_world()
    sched = Scheduler(cache, tp.CONTAINMENT_CONF.format(
        engine="tpu-fused", fallback="true"), device="cpu")
    errors = sched.run_once()
    assert [(n, type(e)) for n, e in errors] == [("allocate-tpu",
                                                  ReplayFault)]
    assert "backfill" not in sched.last_cycle_s
    assert metrics.containment_counts() == {}
    assert len(cache.binder.sequence) == 0


def test_non_finite_inputs_fall_back(rig, monkeypatch):
    """A SolverFault the port raises on non-finite inputs is one of the
    three cases that enter the fallback; it opens no cool-down."""
    real = allocate.task_requests

    def nan_requests(tasks, rnames):
        out = real(tasks, rnames)
        out[0, 0] = np.nan
        return out

    monkeypatch.setattr(allocate, "task_requests", nan_requests)
    cache = _small_world()
    sched = Scheduler(cache, tp.CONTAINMENT_CONF.format(
        engine="tpu-fused", fallback="true"), device="cpu")
    assert sched.run_once() == []
    assert "SolverFault" in allocate.LAST_FALLBACK["error"]
    assert metrics.containment_counts() == {
        "solver_fallback/allocate-tpu": 1.0}
    assert DEVICE_HEALTH.available()
    assert len(cache.binder.sequence) > 0
