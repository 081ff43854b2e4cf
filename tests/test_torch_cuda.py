"""The CUDA kernels against their plain versions, on the card: the
placement kernel at every cluster size the card launches, and the preempt
victim walk on every walk world, on three worlds too large for the plain
walk on the CPU (2,500 nodes; W = 64 at 400 nodes and 8,192 nodes, in
device-memory plans) and on a preempt world's own walk.

These tests need an NVIDIA card and nvcc; without a card they skip. On the
card: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from volcano_tpu_torch.ops.place import (CLUSTER_SIZES, NEG, launch_plan,
                                         max_cluster, place, place_cuda,
                                         place_plain, rowdiff_cuda,
                                         rowdiff_plain, task_flags)
from volcano_tpu_torch.ops.evict import (launch_plan as walk_plan,
                                         to_device, walk, walk_cuda,
                                         walk_dispatches, walk_plain)
from volcano_tpu_torch.ops.scores import default_weights

from torch_parity import port_gc_windows  # noqa: F401 (autouse)
from torch_parity import CARD_WALK_WORLDS, PLACE_WORLDS, WALK_WORLDS

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _args(inst, device):
    (idle, releasing, used, ntasks, cap, max_tasks, req, job_ix,
     feas, static, min_avail) = inst
    zeros = np.zeros(len(min_avail), np.int32)
    flags, ready_need, keep_need = task_flags(job_ix, min_avail, zeros, zeros)
    t = lambda a: torch.tensor(a, device=device)  # noqa: E731
    return (t(idle), t(idle + releasing), t(used), t(ntasks), t(cap),
            t(max_tasks), t(req), t(flags), t(ready_need), t(keep_need),
            t(np.where(feas, static, NEG).astype(np.float32)),
            default_weights(req.shape[1]))


def _assert_same(got, want, label):
    for name, g, w in zip(("packed", "idle", "future_idle", "used",
                           "ntasks"), got, want):
        assert torch.equal(g, w), f"{label}: {name}"


@pytest.mark.parametrize("world", list(PLACE_WORLDS))
def test_kernel_matches_plain(world, card):
    """Packed words and final state equal to the bit, at the default plan
    and at every cluster size the card launches."""
    args = _args(PLACE_WORLDS[world](), card)
    want = place_plain(*args)
    _assert_same(place_cuda(*args), want, "default")
    for c in CLUSTER_SIZES:
        if c <= max_cluster():
            _assert_same(place_cuda(*args, cluster=c), want, f"cluster {c}")
    torch.cuda.synchronize()


def test_device_memory_planes_match_plain(card):
    """R=8 at 40,000 nodes does not fit a 16-CTA cluster's shared memory: the
    planes stay in device memory, through the same kernel."""
    rng = np.random.RandomState(5)
    N, R, T, J = 40000, 8, 200, 20
    cap = rng.choice([2000.0, 4000.0, 8000.0], size=(N, R)).astype(np.float32)
    used = (cap * rng.uniform(0, 0.6, (N, R))).astype(np.float32)
    req = rng.choice([250.0, 500.0, 1000.0], (T, R)).astype(np.float32)
    job_ix = np.sort(rng.randint(0, J, T)).astype(np.int32)
    min_avail = rng.randint(1, 8, J).astype(np.int32)
    zeros = np.zeros(J, np.int32)
    flags, ready_need, keep_need = task_flags(job_ix, min_avail, zeros, zeros)
    t = lambda a: torch.tensor(a, device=card)  # noqa: E731
    args = (t(cap - used), t(cap - used), t(used),
            t(rng.randint(0, 3, N).astype(np.int32)), t(cap),
            t(rng.randint(2, 60, N).astype(np.int32)), t(req), t(flags),
            t(ready_need), t(keep_need), None, default_weights(R))
    assert not launch_plan(N, R, False, max_cluster()).in_smem
    _assert_same(place_cuda(*args), place_plain(*args), "device memory")


def test_place_dispatches_cuda_tensors_to_the_kernel(card):
    inst = PLACE_WORLDS["ties"]()
    args = _args(inst, card)
    before = place_cuda.launches
    rows_before = rowdiff_cuda.launches
    res = place(*args[:7], inst[7], args[10], inst[10],
                np.zeros(len(inst[10]), np.int32),
                np.zeros(len(inst[10]), np.int32), args[11])
    assert place_cuda.launches == before + 1
    assert rowdiff_cuda.launches == rows_before + 1
    assert (res.task_node >= 0).all()


@pytest.mark.parametrize("world", list(PLACE_WORLDS))
def test_rowdiff_matches_plain(world, card):
    """The static-row pre-pass marks exactly the rows place_plain's
    reading of them would."""
    ms = _args(PLACE_WORLDS[world](), card)[10]
    assert torch.equal(rowdiff_cuda(ms), rowdiff_plain(ms))


def _assert_walk_same(got, want, label):
    for name in ("task_node", "owner", "job_done"):
        assert torch.equal(getattr(got, name), getattr(want, name)), \
            f"{label}: {name}"
    assert got.steps == want.steps, label


@pytest.mark.parametrize("world", list(WALK_WORLDS))
def test_walk_kernel_matches_plain(world, card):
    """Task nodes, slot owners and quota verdicts equal to the bit; the
    kernel dispatched the nodes its cache rule needs, no more."""
    inputs, kinds, sizes, gang = WALK_WORLDS[world]()
    d = to_device(inputs, card)
    got = walk_cuda(d, kinds, sizes, gang)
    _assert_walk_same(got, walk_plain(d, kinds, sizes, gang), world)
    assert got.redispatched == walk_dispatches(
        d, kinds, sizes, gang).per_node.sum()
    torch.cuda.synchronize()


@pytest.mark.parametrize("world", list(CARD_WALK_WORLDS))
def test_walk_kernel_matches_plain_card_worlds(world, card):
    """More nodes than threads (a thread owns several), victim tables larger
    than shared memory, and node state and group allocations larger than
    it (the device-memory plans)."""
    inputs, kinds, sizes, gang = CARD_WALK_WORLDS[world]()
    d = to_device(inputs, card)
    N, W, R = inputs.nw.vreq.shape
    got = walk_cuda(d, kinds, sizes, gang)
    assert got.plan == walk_plan(N, W, R, inputs.tier_masks.shape[0],
                                 inputs.jalloc0.shape[0])
    if world == "w64-n400":
        assert not got.plan.where()["tables"]
    if world == "n8192":
        assert not got.plan.where()["nodes"]
        assert not got.plan.where()["groups"]
    _assert_walk_same(got, walk_plain(d, kinds, sizes, gang), world)
    assert got.redispatched == walk_dispatches(
        d, kinds, sizes, gang).per_node.sum()
    assert got.redispatched >= N and got.steps > 0


def test_walk_dispatches_cuda_tensors_to_the_kernel(card):
    inputs, kinds, sizes, gang = WALK_WORLDS["drf"]()
    d = to_device(inputs, card)
    before = walk_cuda.launches
    got = walk(d, kinds, sizes, gang)
    assert walk_cuda.launches == before + 1
    _assert_walk_same(got, walk_plain(d, kinds, sizes, gang), "drf")


def test_walk_preempt_world_matches_plain(card):
    """The walk that preempt builds on the preempt mix at a tenth (phase 1
    under deploy/scheduler.conf's tiers), recorded on a CPU run."""
    from volcano_tpu_torch.actions import PreemptAction, evict_tpu
    from volcano_tpu_torch.cache.synthetic import baseline_config
    from volcano_tpu_torch.framework import open_session, parse_scheduler_conf

    from torch_parity import DEPLOYED_CONF
    seen = []
    real = evict_tpu.walk

    def recording(inputs, kinds, sizes, gang_commit):
        seen.append((inputs, kinds, sizes, gang_commit))
        return real(inputs, kinds, sizes, gang_commit)

    conf = parse_scheduler_conf(DEPLOYED_CONF)
    ssn = open_session(baseline_config("preempt-small")[0], conf.tiers,
                       conf.configurations, device="cpu")
    evict_tpu.walk = recording
    try:
        PreemptAction(engine="tpu").execute(ssn)
    finally:
        evict_tpu.walk = real
    assert seen
    for inputs, kinds, sizes, gang in seen:
        d = to_device(inputs, card)
        _assert_walk_same(walk_cuda(d, kinds, sizes, gang),
                          walk_plain(d, kinds, sizes, gang), "preempt-small")
