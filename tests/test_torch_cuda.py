"""The CUDA kernels against their plain versions, on the card: the
placement kernel at every cluster size the card launches (and a strict
engine's sequence of batches), the preempt victim walk on every walk world,
on three worlds too large for the plain walk on the CPU (2,500 nodes; W =
64 at 400 nodes and 8,192 nodes, in device-memory plans) and on a preempt
world's own walk, and the block auction's kernels on every blocks world
and on the tpu-blocks engine's first solve at 20,000 pods; its two card
worlds (20,000 nodes with few request classes, which splits the candidate
kernel's node axis; a fractional world of 20,000 tasks, whose chunks all
keep the reference's sum order), both sum modes, and the per-solve class
ids and exactness flags computed on the card as on the CPU. The cache's
persistent node rows (scattered with an out-of-place ``index_copy``) on
the card equal the CPU's, the shell's prewarm uploads them, and the hole
worlds (holes in the placement kernel's node axis) decide on the card as
on the CPU. B6, the placement kernel's zone-anchor mode
(``place_topo_cuda``), equals ``place_topo_plain`` on every zone-anchor
world at every cluster size and in a device-memory plan, equals B1 at
weight 0, and is what ``place`` launches at a positive weight.

These tests need an NVIDIA card and nvcc; without a card they skip. On the
card: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from volcano_tpu_torch.ops.place import (CLUSTER_SIZES, NEG, launch_plan,
                                         max_cluster, place, place_cuda,
                                         place_plain, place_topo_cuda,
                                         place_topo_plain, rowdiff_cuda,
                                         rowdiff_plain, task_flags)
from volcano_tpu_torch.ops.evict import (launch_plan as walk_plan,
                                         pad_nodes, to_device, walk,
                                         walk_cuda, walk_dispatches,
                                         walk_plain, walk_sharded_cuda)
from volcano_tpu_torch.ops.blocks import (blocks, blocks_cuda, blocks_plain,
                                          free_cuda, merge_cuda, merge_plain,
                                          round_cuda, round_sharded_cuda,
                                          topk_cuda)
from volcano_tpu_torch.ops.scores import default_weights

from torch_parity import port_gc_windows  # noqa: F401 (autouse)
from torch_parity import (BLOCK_WORLDS, CARD_BLOCK_WORLDS, CARD_WALK_WORLDS,
                          HOLE_WORLDS, PLACE_WORLDS, PORT_WALK_WORLDS,
                          TOPO_CASES, TOPO_WORLDS, WALK_WORLDS, blocks_args,
                          hole_world_run, pad_blocks_nodes,
                          topo_args)

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


@pytest.mark.parametrize("world,topo_weight", TOPO_CASES,
                         ids=[f"{w}@{tw}" for w, tw in TOPO_CASES])
def test_topo_kernel_matches_plain(world, topo_weight, card):
    """B6's words and final state equal place_topo_plain's to the bit, at
    the default plan and at every cluster size the card launches."""
    args = topo_args(TOPO_WORLDS[world](), card)
    want = place_topo_plain(*args[:12], args[12], topo_weight)
    _assert_same(place_topo_cuda(*args[:12], args[12], topo_weight), want,
                 "default")
    for c in CLUSTER_SIZES:
        if c <= max_cluster():
            _assert_same(place_topo_cuda(*args[:12], args[12], topo_weight,
                                         cluster=c), want, f"cluster {c}")
    torch.cuda.synchronize()


@pytest.mark.parametrize("world", list(TOPO_WORLDS))
def test_topo_kernel_at_weight_zero_is_b1(world, card):
    args = topo_args(TOPO_WORLDS[world](), card)
    _assert_same(place_topo_cuda(*args[:12], args[12], 0.0),
                 place_cuda(*args[:12]), "weight 0")


def test_topo_device_memory_planes_match_plain(card):
    """R=8 at 40,000 nodes in zones of 16: B6 with its planes and zone
    codes in device memory."""
    rng = np.random.RandomState(6)
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
    zone = t((1 + np.arange(N) // 16).astype(np.int32))
    assert not launch_plan(N, R, False, max_cluster(), topo=True).in_smem
    _assert_same(place_topo_cuda(*args, zone, 10.0),
                 place_topo_plain(*args, zone, 10.0), "device memory")


def test_place_takes_b6_at_a_positive_weight(card):
    w = TOPO_WORLDS["unzoned-first"]()
    args = topo_args(w, card)
    zeros = np.zeros(len(w["min_available"]), np.int32)
    b1, b6 = place_cuda.launches, place_topo_cuda.launches
    place(*args[:7], w["job_ix"], args[10], w["min_available"], zeros, zeros,
          args[11], args[12], 0.0)
    assert (place_cuda.launches, place_topo_cuda.launches) == (b1 + 1, b6)
    place(*args[:7], w["job_ix"], args[10], w["min_available"], zeros, zeros,
          args[11], args[12], 10.0)
    assert (place_cuda.launches, place_topo_cuda.launches) == (b1 + 1, b6 + 1)


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


@pytest.mark.parametrize("world", [*WALK_WORLDS, *PORT_WALK_WORLDS])
def test_walk_kernel_matches_plain(world, card):
    """Task nodes, slot owners and quota verdicts equal to the bit; the
    kernel dispatched the nodes its cache rule needs, no more."""
    inputs, kinds, sizes, gang = {**WALK_WORLDS, **PORT_WALK_WORLDS}[world]()
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


# ---------------------------------------------------------------------------
# the block auction (B4)
# ---------------------------------------------------------------------------

def _assert_blocks_same(got, want, label):
    for name, g, w in zip(("packed", "idle", "future_idle", "used",
                           "ntasks"), got, want):
        assert torch.equal(g, w), f"{label}: {name}"


@pytest.mark.parametrize("world", list(BLOCK_WORLDS))
def test_blocks_kernels_match_plain(world, card):
    """The packed row and the final node state equal to the bit."""
    args, kw = blocks_args(BLOCK_WORLDS[world](), card)
    stats = {}
    got = blocks_cuda(*args, stats=stats, **kw)
    _assert_blocks_same(got, blocks_plain(*args, **kw), world)
    assert stats["chunks"] > 0 and stats["rounds"] > 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("world", list(CARD_BLOCK_WORLDS))
def test_blocks_kernels_match_plain_card_worlds(world, card):
    """The card-only worlds: few classes over 20,000 nodes (the candidate
    kernel's split node axis), a fractional world at 20,000 tasks / 5,000
    nodes, summed in the reference's order throughout, and 2^23 + 64 nodes
    (the round kernel's 64-bit grouping keys)."""
    args, kw = blocks_args(CARD_BLOCK_WORLDS[world](), card)
    stats = {}
    got = blocks_cuda(*args, stats=stats, **kw)
    _assert_blocks_same(got, blocks_plain(*args, **kw), world)
    if world == "fractional-20k":
        assert stats["chunks_exact"] == 0 and stats["chunks"] >= 79
    else:
        assert stats["chunks_exact"] == stats["chunks"]
        assert stats["classes"] <= 2 * stats["chunks"]


def test_blocks_sum_modes_per_chunk(card):
    """mixed-exact's solve takes the exact mode in its first chunk and the
    in-order mode in its second; both modes equal blocks_plain."""
    from volcano_tpu_torch.ops.blocks import chunk_exact
    args, kw = blocks_args(BLOCK_WORLDS["mixed-exact"](), card)
    assert chunk_exact(args[6], kw["chunk"]).tolist() == [True, False]
    stats = {}
    got = blocks_cuda(*args, stats=stats, **kw)
    _assert_blocks_same(got, blocks_plain(*args, **kw), "mixed-exact")
    assert 0 < stats["chunks_exact"] < stats["chunks"]


@pytest.mark.parametrize("world", ["static-classes", "fractional-ms",
                                   "mixed-exact", "unified-0-ms-33",
                                   "n-lt-32", "t300-padding"])
def test_blocks_prep_kernel_matches_the_cpu(world, card):
    """prep_cuda (the class and exactness kernels) gives on the card what
    task_classes and chunk_exact give on the CPU (the tests there hold those
    against NumPy)."""
    from volcano_tpu_torch.ops.blocks import (chunk_exact, prep_cuda,
                                              task_classes)
    on_card, kw = blocks_args(BLOCK_WORLDS[world](), card)
    on_cpu, _ = blocks_args(BLOCK_WORLDS[world](), "cpu")
    C = kw["chunk"]
    classes, exact = prep_cuda(on_card[6], on_card[10], C)
    for g, w in zip(classes, task_classes(on_cpu[6], on_cpu[10], C)):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(exact.cpu(),
                       chunk_exact(on_cpu[6], C).to(torch.uint8))


def test_blocks_20k_solve_matches_plain(card):
    """The tpu-blocks engine's first solve of baseline_config("20k")
    (20,000 pods, 5,000 nodes, budgets 5/4) under deploy/scheduler.conf:
    the kernels against blocks_plain on its own inputs."""
    from volcano_tpu_torch.actions import allocate
    from volcano_tpu_torch.cache.synthetic import baseline_config
    from volcano_tpu_torch.framework import (abandon_session, get_action,
                                             open_session,
                                             parse_scheduler_conf)
    from volcano_tpu_torch.ops.blocks import JobMeta, pad_tasks

    from torch_parity import DEPLOYED_CONF
    conf = parse_scheduler_conf(
        DEPLOYED_CONF.replace("engine: tpu-fused", "engine: tpu-blocks"))
    ssn = open_session(baseline_config("20k")[0], conf.tiers,
                       conf.configurations, device=card)
    try:
        get_action("enqueue").execute(ssn)
        inp = allocate.placement_inputs(ssn, allocate._fixed_job_order(ssn))
    finally:
        abandon_session(ssn)
    T = len(inp.tasks)
    req, valid, job_ix, ms = pad_tasks(
        inp.req, torch.ones(T, dtype=torch.bool, device=card),
        torch.tensor(inp.job_ix, device=card), inp.masked_static)
    jobs = JobMeta(*(torch.tensor(a, device=card) for a in (
        inp.min_available, inp.base_ready, inp.base_pipelined)))
    nt = inp.node_t
    args = (nt.idle, nt.future_idle, nt.used, nt.ntasks, nt.allocatable,
            nt.max_tasks, req, valid, job_ix, jobs, ms, inp.weights)
    got = blocks_cuda(*args, sweeps=5, passes=4)
    _assert_blocks_same(got, blocks_plain(*args, sweeps=5, passes=4), "20k")
    assert T == 20000 and (got[0][:T] >= 0).all()


def test_blocks_dispatches_cuda_tensors_to_the_kernels(card):
    from volcano_tpu_torch.ops.blocks import prep_cuda
    args, kw = blocks_args(BLOCK_WORLDS["t300-padding"](), card)
    prep_before = prep_cuda.launches
    before = (topk_cuda.launches, round_cuda.launches, free_cuda.launches)
    got = blocks(*args, **kw)
    assert prep_cuda.launches == prep_before + 1
    assert topk_cuda.launches > before[0]
    assert round_cuda.launches > before[1]
    assert free_cuda.launches > before[2]
    _assert_blocks_same(got, blocks_plain(*args, **kw), "t300-padding")


def test_blocks_cuda_refuses_more_than_eight_resources(card):
    args, kw = blocks_args(BLOCK_WORLDS["n-lt-32"](), card)
    wide = [torch.cat([a] * 5, dim=1) if a is not None and a.dim() == 2
            and a.shape[1] == 2 else a for a in args[:7]]
    with pytest.raises(ValueError, match="resource columns"):
        blocks_cuda(*wide, *args[7:], **kw)


def test_strict_batches_carry_the_same_state(card):
    """A strict engine's batch sequence — each batch solved from the node
    state the last one left — ends in the same node state through
    place_cuda as through place_plain."""
    inst = PLACE_WORLDS["multi-chunk"]()
    args = _args(inst, card)
    state = {"cuda": args[:4], "plain": args[:4]}
    for lo in range(0, args[6].shape[0], 60):
        hi = min(lo + 60, args[6].shape[0])
        job_ix = inst[7][lo:hi]
        for name, solve in (("cuda", place_cuda), ("plain", place_plain)):
            zeros = np.zeros(int(job_ix.max()) + 1, np.int32)
            flags, ready_need, keep_need = (
                torch.tensor(a, device=card) for a in task_flags(
                    job_ix, inst[10][:len(zeros)], zeros, zeros))
            out = solve(*state[name], args[4], args[5], args[6][lo:hi],
                        flags, ready_need, keep_need, args[10][lo:hi],
                        args[11])
            state[name] = out[1:]
    for g, w in zip(state["cuda"], state["plain"]):
        assert torch.equal(g, w)


def _churned_caches():
    """Two equal caches, node churn applied to both: rows with holes."""
    from volcano_tpu_torch.api import NodeInfo, QueueInfo, Resource
    from volcano_tpu_torch.cache import FakeBinder, FakeEvictor, SchedulerCache
    from volcano_tpu_torch.cache.synthetic import make_cluster, make_jobs
    gi = 1 << 30
    caches = []
    for _ in range(2):
        cache = SchedulerCache(binder=FakeBinder(), evictor=FakeEvictor())
        cache.add_queue(QueueInfo(name="q1", weight=1))
        for n in make_cluster(300, cpu_milli=8000, mem=32 * gi, pods=20):
            cache.add_node(n)
        for j in make_jobs(40, 8, ["q1"], seed=3):
            cache.add_job(j)
        caches.append(cache)
    return caches, NodeInfo, Resource


def test_persistent_rows_on_the_card_match_the_cpu(card):
    """The scatter path on the card: each refresh leaves the same rows,
    holes and future idle as on the CPU, bit for bit."""
    from volcano_tpu_torch.cache.snapshot import discover_resource_names
    (gpu, cpu), NodeInfo, Resource = _churned_caches()
    rn = discover_resource_names(list(cpu.nodes.values()),
                                 [t for j in cpu.jobs.values()
                                  for t in j.tasks.values()])

    def refresh_both():
        out = []
        for cache, dev in ((gpu, card), (cpu, torch.device("cpu"))):
            snap = cache.snapshot()
            out.append(cache.tensor_refresh(snap.nodes, rn, dev,
                                            snap.snap_epoch))
        tg, tc = out
        assert tg.names == tc.names and tg.last_refresh["full"] \
            == tc.last_refresh["full"]
        for f in ("idle", "used", "releasing", "pipelined", "allocatable",
                  "max_tasks", "ntasks", "zone_code", "future_idle"):
            assert getattr(tg, f).device.type == "cuda"
            assert torch.equal(getattr(tg, f).cpu(), getattr(tc, f)), f
        return tg

    assert refresh_both().last_refresh["full"]
    alloc = Resource(8000, 32 << 30)
    alloc.max_task_num = 20
    for cache in (gpu, cpu):
        for name in ("node-00007", "node-00100", "node-00201"):
            cache.remove_node(name)
    tg = refresh_both()
    assert not tg.last_refresh["full"] and tg.last_refresh["rows"] == 3
    for cache in (gpu, cpu):
        cache.add_node(NodeInfo(name="zz-new", allocatable=alloc))
        cache.mark_node_dirty("node-00050")
    tg = refresh_both()
    assert tg.index["zz-new"] == 7 and tg.names[100] == ""


def test_prewarm_uploads_the_persistent_tensors(card):
    """Scheduler.prewarm builds the kernels and, once the cache has nodes,
    puts the persistent rows on the card."""
    import os
    from volcano_tpu_torch import Scheduler
    from volcano_tpu_torch.cache.snapshot import NodeTensors
    (cache, _), _, _ = _churned_caches()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "deploy", "scheduler.conf")) as f:
        conf = f.read()
    assert Scheduler(cache, conf, device="cuda").prewarm() > 0
    tc = cache.tensor_cache
    assert tc is not None and tc.device.type == "cuda"
    fresh = NodeTensors(list(cache.nodes.values()), tc.rnames, card)
    assert tc.names == fresh.names
    assert torch.equal(tc.idle, fresh.idle)
    assert torch.equal(tc.future_idle, fresh.future_idle)


@pytest.mark.parametrize("name", HOLE_WORLDS + ("drain:on",))
def test_hole_worlds_decide_on_the_card_as_on_the_cpu(name, card):
    """The hole worlds (tests/test_torch_incremental.py holds the CPU run
    to the JAX package) bind alike on the card, with the same node-tensor
    path: the placement kernel reads hole rows as unselectable."""
    got = hole_world_run(True, name, device="cuda")
    assert got == hole_world_run(True, name)



# ---------------------------------------------------------------------------
# B7 and the speculative dispatch
# ---------------------------------------------------------------------------

def _seeded_wire(seed, T, J, device):
    rng = np.random.default_rng(seed)
    job_ix = np.sort(rng.integers(0, J, T)).astype(np.int32)
    flags = rng.integers(0, 16, T)
    flags[rng.random(T) < 0.2] = 0          # rows with zero flags
    packed = ((rng.integers(0, 5000, T) + 1) << 4 | flags).astype(np.int32)
    t = lambda a: torch.tensor(a, device=device)  # noqa: E731
    return t(packed), t(job_ix)


@pytest.mark.parametrize("seed, T, J", [(0, 1, 1), (1, 100, 7),
                                        (2, 10000, 200), (3, 5000, 5000),
                                        (4, 0, 4), (5, 70000, 33)])
def test_decode_kernel_matches_plain(seed, T, J, card):
    """To the bit, on wires with jobs of no boundary row and of several."""
    from volcano_tpu_torch.ops.place import (decode_packed_cuda,
                                             decode_packed_plain)
    packed, job_ix = _seeded_wire(seed, T, J, card)
    got = decode_packed_cuda(packed, job_ix, J)
    torch.cuda.synchronize()
    assert torch.equal(got, decode_packed_plain(packed, job_ix, J))


def test_dispatch_does_not_synchronize_and_equals_the_serial_solve(card):
    """dispatch_speculative_solve raises nothing under the sync debug mode
    "error", and its fetched solution equals the serial solve's on the
    same speculative session."""
    from volcano_tpu_torch import Scheduler
    from volcano_tpu_torch.actions import allocate as alloc
    from volcano_tpu_torch.cache.synthetic import baseline_config
    from volcano_tpu_torch.framework import abandon_session, open_session
    from volcano_tpu_torch.ops.place import max_cluster as probe
    from torch_parity import PIPELINED_CONF
    cache = baseline_config("10k")[0]
    sched = Scheduler(cache, PIPELINED_CONF, device=card, pipelined=True)
    probe()
    ssn = open_session(cache, sched.conf.tiers, sched.conf.configurations,
                       device=card, speculative=True)
    try:
        # the previous cycle's enqueue, which the sim's speculation follows
        sched.actions[0].execute(ssn)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = alloc.dispatch_speculative_solve(ssn, "tpu-fused")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert pending is not None and pending.event is not None
        got = alloc.finalize_speculative_dispatch(pending)
        want = alloc._fused_solution(
            alloc.placement_inputs(ssn, pending.ordered_jobs))
        for f in ("task_node", "pipelined", "job_ready", "job_kept"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert (np.asarray(got.task_node) >= 0).sum() == 10000
    finally:
        abandon_session(ssn)


def test_tdm_world_on_the_card(card):
    """tools/plugin_reference.py's tdm-1k (tdm-10k at a tenth) through the
    Scheduler on the card decides as the port's CPU path: B1 once a solve
    under tdm's feasibility mask, B3 once a walk under its tier mask, and
    the drain of rz-closed's nodes in the first cycle only."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import plugin_reference
    want = plugin_reference.run_world("volcano_tpu_torch", "tdm-1k",
                                      "cpu")["digest"]
    b1, b3 = place_cuda.launches, walk_cuda.launches
    got = plugin_reference.run_world("volcano_tpu_torch", "tdm-1k",
                                     card)["digest"]
    assert got == want
    assert place_cuda.launches - b1 == got["solves"] > 0
    assert walk_cuda.launches - b3 == got["walks"] > 0
    assert got["per_cycle"][0]["evicts_by_zone"]["rz-closed"] > 0


# ---------------------------------------------------------------------------
# the node mesh: B4's merge and sharded round, the sharded walk
# ---------------------------------------------------------------------------

# blocks worlds for the sharded solve: both budget tiers, a masked static
# matrix, fewer nodes than K, one contended node, padding, the in-order sum
# mode in waves and split, row classes, pod caps, and both modes in one
# solve
SHARDED_BLOCK_WORLDS = ["unified-0-ms-33", "unified-1-plain-54", "n-lt-32",
                        "one-node-40", "t300-padding", "lanes-wave-256",
                        "lanes-split-256", "static-classes",
                        "max-tasks-exact", "mixed-exact"]


@pytest.mark.parametrize("shards", [2, 8])
@pytest.mark.parametrize("world", SHARDED_BLOCK_WORLDS)
def test_blocks_sharded_kernels_match_plain(world, shards, card):
    """Over a mesh of 2 and 8 shards (the node axis padded to a multiple):
    the candidate kernel a shard, the merge kernel and the round kernel as
    a cluster give blocks_plain's sharded form to the bit, which is its
    unsharded form."""
    args, kw = blocks_args(pad_blocks_nodes(BLOCK_WORLDS[world](), shards),
                           card)
    m0, r0 = merge_cuda.launches, round_sharded_cuda.launches
    got = blocks_cuda(*args, shards=shards, **kw)
    _assert_blocks_same(got, blocks_plain(*args, shards=shards, **kw),
                        f"{world}@{shards}")
    _assert_blocks_same(got, blocks_cuda(*args, **kw), f"{world}@1")
    assert merge_cuda.launches > m0 and round_sharded_cuda.launches > r0
    torch.cuda.synchronize()


@pytest.mark.parametrize("shards", [2, 8])
def test_blocks_merge_kernel_matches_plain(shards, card):
    """Shard lists with many equal scores and -inf entries merge into the
    unsharded top K (a stable sort of the whole row)."""
    rng = np.random.RandomState(shards)
    C, Nl = 256, 40
    N = shards * Nl
    score = rng.choice([1.0, 2.0, 2.5, -np.inf], size=(C, N)).astype(
        np.float32)
    full = torch.tensor(score)
    vals, idx = torch.sort(full, dim=1, descending=True, stable=True)
    parts = [torch.sort(full[:, s * Nl:(s + 1) * Nl], dim=1,
                        descending=True, stable=True) for s in range(shards)]
    K_loc = min(32, Nl)
    ps = torch.stack([v[:, :K_loc] for v, _ in parts]).contiguous()
    pc = torch.stack([i[:, :K_loc] for _, i in parts]).to(
        torch.int32).contiguous()
    K = min(32, N)
    want_s, want_i = merge_plain(ps, pc, Nl, K)
    assert torch.equal(want_i, idx[:, :K]) and torch.equal(want_s,
                                                           vals[:, :K])
    cand = torch.empty((C, K), dtype=torch.int32, device=card)
    cand_score = torch.empty((C, K), dtype=torch.float32, device=card)
    merge_cuda(pc.to(card), ps.to(card),
               torch.tensor([C], dtype=torch.int32, device=card), cand,
               cand_score, 0, C, Nl)
    assert torch.equal(cand.cpu().long(), want_i)
    assert torch.equal(cand_score.cpu(), want_s)


@pytest.mark.parametrize("shards", [2, 8])
@pytest.mark.parametrize("world", [*WALK_WORLDS, *PORT_WALK_WORLDS,
                                   "n2500"])
def test_walk_sharded_kernel_matches_plain(world, shards, card):
    """The walk as a cluster of 2 and 8 CTAs (node axis padded by
    victim-free rows) gives walk_plain's sharded form, which is the
    unsharded walk: task nodes, owners, quota verdicts, evaluated tasks."""
    worlds = {**WALK_WORLDS, **PORT_WALK_WORLDS, **CARD_WALK_WORLDS}
    inputs, kinds, sizes, gang = worlds[world]()
    d = to_device(pad_nodes(inputs, shards), card)
    before = walk_sharded_cuda.launches
    got = walk(d, kinds, sizes, gang, shards=shards)
    assert walk_sharded_cuda.launches == before + 1
    _assert_walk_same(got, walk_plain(d, kinds, sizes, gang, shards=shards),
                      f"{world}@{shards}")
    _assert_walk_same(got, walk_cuda(d, kinds, sizes, gang), f"{world}@1")
    torch.cuda.synchronize()


def test_callbacks_parallel_forks_after_cuda(card):
    """callbacks-parallel's pool forks from a process whose CUDA context
    is live (a tensor on the card, a session on the card): the cycle binds
    what the serial callbacks engine binds, and every worker reports no
    CUDA initialisation attempted."""
    from volcano_tpu_torch import Scheduler
    from volcano_tpu_torch.actions.callbacks_parallel import _ScanPool
    from volcano_tpu_torch.cache.synthetic import baseline_config
    from volcano_tpu_torch.framework import DEFAULT_SCHEDULER_CONF
    held = torch.ones(1024, device=card)        # a live context
    assert torch.cuda.is_initialized()
    conf = DEFAULT_SCHEDULER_CONF + ("configurations:\n- name: allocate\n"
                                     "  arguments:\n    engine: {}\n")
    probes = []
    real_stop = _ScanPool.stop

    def stop(self):
        probes.extend(self.cuda_attempts())
        real_stop(self)

    binds = {}
    _ScanPool.stop = stop
    try:
        for engine in ("callbacks-parallel", "callbacks"):
            cache, binder, _ = baseline_config("1k", seed=3)
            assert Scheduler(cache, conf.format(engine), device=card
                             ).run_once() == []
            binds[engine] = dict(binder.binds)
    finally:
        _ScanPool.stop = real_stop
    assert binds["callbacks-parallel"] == binds["callbacks"]
    assert len(binds["callbacks"]) == 1000
    assert probes and all(a == 0 for _, a, _ in probes)
    del held
