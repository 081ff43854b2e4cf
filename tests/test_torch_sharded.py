"""The tpu-sharded engine of the port against the JAX package's, on the CPU.

The node-sharded block auction (ops/blocks.py with ``shards``, over the
mesh of ops/unified.py) and the sharded walk (ops/evict.py::walk_plain with
``shards``) must give, at a mesh of 1, 2, 4 and 8 slots, the JAX package's
``place_blocks_unified(mesh, ...)`` and ``build_preempt_walk_sharded`` over
1, 2, 4 and 8 virtual CPU devices, bit for bit (tolerance 0), with the node
axis padded alike; the JAX reference runs in tests/torch_parity.py's child
process (no FMA contraction, 8 host devices). The allocate engine
``tpu-sharded`` at ``sharded-devices`` 1, 2, 4 and 8 must bind as the JAX
package's engine does, and preempt's ``tpu-sharded`` must evict what the
single walk evicts (tests/test_parallel.py's cases, and
tests/test_unified.py's blocks and engine cases).
"""

import numpy as np
import pytest
import torch

from volcano_tpu_torch.cache import cache_from_world
from volcano_tpu_torch.ops import blocks as B
from volcano_tpu_torch.ops import unified as U
from volcano_tpu_torch.ops.evict import pad_nodes, to_device, walk_plain
from volcano_tpu_torch.ops.scores import default_weights

from torch_parity import port_gc_windows  # noqa: F401 (autouse)
from torch_parity import one_torch_thread  # noqa: F401
from torch_parity import (BLOCK_WORLDS, ENGINE_CASES, ENGINE_WORLDS,
                          MESH_SIZES, WALK_WORLDS, jax_reference, outcome,
                          pad_blocks_nodes, run_allocate)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHARDED_BLOCKS = ["unified-0-ms-33", "unified-1-plain-54", "n-lt-32",
                  "one-node-40", "t300-padding", "lanes-split-256",
                  "static-classes", "max-tasks-exact"]
SHARDED_WALKS = ["gang-rollback", "intra-job", "drf", "drf-co-mask",
                 "random-0", "random-1", "tier-veto", "ties-across-warps",
                 "rollback-after-lazy-save"]
BLOCK_KEYS = [f"blocks-sharded:{w}@{d}" for w in SHARDED_BLOCKS
              for d in MESH_SIZES]
WALK_KEYS = [f"walk-sharded:{w}@{d}" for w in SHARDED_WALKS
             for d in MESH_SIZES]
ENGINE_KEYS = ([f"engines:tpu-sharded:{c}" for c in ENGINE_CASES]
               + [f"engines:tpu-sharded:1k-seed3-d{d}" for d in MESH_SIZES])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_reference("mixed", BLOCK_KEYS + WALK_KEYS + ENGINE_KEYS,
                         tmp_path_factory.mktemp("jax") / "sharded.pkl")


@pytest.fixture
def slots():
    """Eight CPU slots for the engines; the process default after."""
    U.set_devices(8, "cpu")
    yield
    U.set_devices(None)


def _mesh(d):
    return U.make_mesh([U.Slot(i, torch.device("cpu")) for i in range(d)])


@pytest.mark.parametrize("key", BLOCK_KEYS)
def test_blocks_sharded_matches_jax(key, reference):
    """Packed wire and final node state at mesh size D, padded nodes
    included, equal to the JAX package's over D devices."""
    world, d = key.split(":", 1)[1].split("@")
    d = int(d)
    w = pad_blocks_nodes(BLOCK_WORLDS[world](), d)

    def t(k):
        return torch.tensor(w[k])

    packed, nodes = B.place_blocks_unified(
        _mesh(d), B.NodeState(t("idle"), t("future_idle"), t("used"),
                              t("ntasks")),
        t("req"), t("valid"), t("job_ix"),
        B.JobMeta(t("min_available"), t("base_ready"), t("base_pipelined")),
        default_weights(w["req"].shape[1]), t("allocatable"),
        t("max_tasks"), chunk=w["chunk"], sweeps=w["sweeps"],
        passes=w["passes"],
        masked_static=None if w["ms"] is None else t("ms"))
    got = [packed.numpy()] + [a.numpy() for a in nodes]
    for label, g, want in zip(("packed", "idle", "future_idle", "used",
                               "ntasks"), got, reference[key]):
        assert g.dtype == want.dtype and np.array_equal(g, want), \
            f"{key}: {label}"


@pytest.mark.parametrize("key", WALK_KEYS)
def test_walk_sharded_matches_jax(key, reference):
    """Task nodes, slot owners (pad rows included) and quota verdicts of
    the walk over D shards equal the JAX package's sharded walk."""
    world, d = key.split(":", 1)[1].split("@")
    d = int(d)
    inputs, kinds, sizes, gang = WALK_WORLDS[world]()
    out = walk_plain(to_device(pad_nodes(inputs, d), "cpu"), kinds, sizes,
                     gang, shards=d)
    for label, g, want in zip(("task_node", "owner", "job_done"),
                              (out.task_node, out.owner, out.job_done),
                              reference[key]):
        assert np.array_equal(g.numpy(), np.asarray(want)), \
            f"{key}: {label}"


@pytest.mark.parametrize("key", ENGINE_KEYS)
def test_sharded_engine_matches_jax(key, reference, slots):
    """AllocateAction(engine="tpu-sharded") on the engine worlds and on
    baseline_config("1k", seed=3) at sharded-devices 1, 2, 4 and 8: binds,
    phases and pipelined tasks equal the JAX engine's (test_unified.py's
    engine cases)."""
    name = key.split(":", 1)[1]
    engine, world_name = name.split(":", 1)
    world, want, _ = reference[key]
    _, conf_text, arguments = ENGINE_WORLDS[world_name]
    cache = cache_from_world(world)
    ssn, _ = run_allocate(cache, engine, conf_text, arguments, True)
    assert outcome(ssn, cache) == want


def test_sharded_engine_collapses_and_records_mesh(slots):
    """A one-slot mesh runs tpu-blocks' own solve; eight slots solve over
    all eight, with the decisions of one (mesh-size invariance)."""
    from volcano_tpu_torch.actions import allocate
    from volcano_tpu_torch.cache.synthetic import baseline_config
    from volcano_tpu_torch.framework import (Arguments, Configuration,
                                             close_session, open_session,
                                             parse_scheduler_conf)
    binds = {}
    for d in (1, 8):
        cache, binder, _ = baseline_config("tiny", seed=1)
        conf = parse_scheduler_conf(None)
        ssn = open_session(cache, conf.tiers, [Configuration(
            "allocate", Arguments({"engine": "tpu-sharded",
                                   "sharded-devices": d}))],
            device="cpu")
        action = allocate.AllocateAction(engine="tpu-sharded")
        action.execute(ssn)
        assert action.last_stats["mesh_devices"] == d
        assert allocate.current_mesh_ids(ssn) == tuple(range(d))
        close_session(ssn)
        binds[d] = dict(binder.binds)
    assert binds[1] == binds[8] and len(binds[1]) == 3


def _sharded_preempt(conf_engine, slots_n):
    from volcano_tpu_torch import Scheduler
    from volcano_tpu_torch.cache.synthetic import preempt_mix_cache
    U.set_devices(slots_n, "cpu")
    conf = open("deploy/scheduler.conf").read().replace(
        "- name: preempt\n  arguments:\n    engine: tpu\n",
        f"- name: preempt\n  arguments:\n    engine: {conf_engine}\n")
    cache, binder, evictor = preempt_mix_cache(n_nodes=40, n_tasks=1000,
                                               n_jobs=40, seed=2)
    Scheduler(cache, conf_text=conf, device="cpu").run_once()
    return dict(binder.binds), list(evictor.evicts)


@pytest.mark.parametrize("d", [2, 8])
def test_sharded_preempt_matches_single_device_victims(d):
    """The deployed cycle with preempt on tpu-sharded over d slots evicts
    and binds exactly what preempt's tpu engine does
    (test_parallel.py:248)."""
    try:
        want = _sharded_preempt("tpu", 1)
        got = _sharded_preempt("tpu-sharded", d)
    finally:
        U.set_devices(None)
    assert got == want and got[1]


def test_sharded_respects_capacity_and_pipelines(slots):
    """No node oversubscribed, and a task that fits only releasing
    capacity pipelines (test_parallel.py:99-191): one node of 4 cpu with 3
    releasing, gangs of 2 x 2 cpu, over 8 slots (the node axis padded
    from 3 nodes)."""
    from volcano_tpu_torch.ops.unified import bucket_nodes_for_mesh
    assert bucket_nodes_for_mesh(3, 8) == 8
    N, R = 3, 2
    alloc = torch.tensor([[4000.0, 8.0]] * N)
    idle = alloc.clone()
    idle[0] = torch.tensor([1000.0, 8.0])        # node 0: 3 cpu releasing
    fidle = alloc.clone()
    used = alloc - idle
    pad = bucket_nodes_for_mesh(N, 8) - N

    def rows(x):
        return torch.nn.functional.pad(x, (0, 0, 0, pad))

    req = torch.tensor([[2000.0, 1.0]] * 6)
    packed, nodes = B.place_blocks_unified(
        _mesh(8), B.NodeState(rows(idle), rows(fidle), rows(used),
                              torch.zeros(N + pad, dtype=torch.int32)),
        req, torch.ones(6, dtype=torch.bool),
        torch.tensor([0, 0, 1, 1, 2, 2], dtype=torch.int32),
        B.JobMeta(torch.tensor([2, 2, 2]), torch.zeros(3, dtype=torch.int32),
                  torch.zeros(3, dtype=torch.int32)),
        default_weights(R), rows(alloc),
        torch.nn.functional.pad(torch.tensor([110] * N, dtype=torch.int32),
                                (0, pad)))
    Tp = B.padded_task_len(6)
    assign, pipe = packed[:6], packed[Tp:Tp + 6].bool()
    assert (assign >= 0).all() and (assign < N).all()
    assert (nodes.future_idle >= -0.1).all() and (nodes.idle >= -0.1).all()
    assert pipe.any()
    assert bool((assign[pipe] == 0).all())
