"""The block auction (B4) of the port against the JAX package's, on the CPU.

ops/blocks.py::blocks_plain, through place_blocks_unified, must give the
JAX package's ``place_blocks_unified(None, ...)`` packed row
``[assign | pipe | ready | kept]`` and final node state bit for bit on
every world of tests/torch_parity.py's BLOCK_WORLDS: tests/test_unified.py's
build(seed) worlds for seeds 0, 1 and 3 with and without a masked static
matrix at both budget tiers, the three blocks cases of
tests/test_ops_place.py, identical nodes, fewer than 32 nodes, 300 tasks
(padding to 512), 40 tasks of one chunk contending for one node,
fractional requests (where the order of the float sums decides bits), a
pass in which whole chunks have no work, rows with one request and
different static rows, a node that takes exactly its last pods, and a
solve with one chunk of each sum mode. The JAX reference runs in a child
process without FMA contraction (tests/torch_parity.py).

The CUDA kernels' per-solve helpers, ``task_classes`` (each row's class in
its chunk) and ``chunk_exact`` (each chunk's exactness flag), are held
against a direct NumPy computation.
"""

import numpy as np
import pytest
import torch

from volcano_tpu_torch.ops import blocks as B
from volcano_tpu_torch.ops.scores import default_weights

from torch_parity import BLOCK_WORLDS, blocks_args, jax_reference


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_reference("blocks", list(BLOCK_WORLDS),
                         tmp_path_factory.mktemp("jax") / "blocks.pkl")


def _solve(world, **override):
    """place_blocks_unified on the CPU: (packed, idle, future_idle, used,
    ntasks) as NumPy arrays."""
    def t(k):
        return torch.tensor(world[k])

    kw = {k: world[k] for k in ("chunk", "sweeps", "passes")}
    kw.update(override)
    packed, nodes = B.place_blocks_unified(
        None, B.NodeState(t("idle"), t("future_idle"), t("used"),
                          t("ntasks")),
        t("req"), t("valid"), t("job_ix"),
        B.JobMeta(t("min_available"), t("base_ready"), t("base_pipelined")),
        default_weights(world["req"].shape[1]), t("allocatable"),
        t("max_tasks"),
        masked_static=None if world["ms"] is None else t("ms"), **kw)
    return [packed.numpy()] + [a.numpy() for a in nodes]


@pytest.mark.parametrize("name", list(BLOCK_WORLDS))
def test_blocks_plain_matches_jax(name, reference):
    got = _solve(BLOCK_WORLDS[name]())
    want = reference[name]
    for label, g, w in zip(("packed", "idle", "future_idle", "used",
                            "ntasks"), got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), (
            f"{name}: {label} differs at "
            f"{np.flatnonzero(np.asarray(g != w).ravel())[:8].tolist()}")


def test_none_static_equals_zero_static(reference):
    """masked_static=None (the port's engine when no plugin gives a mask or
    a static score) gives the bits of an all-zero matrix with every pair
    feasible (what the JAX package's engine builds): x + 0.0 == x, and
    0 > NEG_TEST."""
    world = BLOCK_WORLDS["unified-0-plain-33"]()
    none = _solve(world)
    zeros = dict(world, ms=np.zeros((len(world["req"]),
                                     len(world["idle"])), np.float32))
    for g, w in zip(none, _solve(zeros)):
        assert np.array_equal(g, w)
    for g, w in zip(none, reference["unified-0-zeros-33"]):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_raising_the_caps_changes_nothing(seed):
    """The pass and sweep loops exit at their fixpoints exactly where the
    reference's do: budgets of 9 sweeps and 8 passes give what 5 and 4
    give (tests/test_unified.py:115-121)."""
    world = BLOCK_WORLDS[f"unified-{seed}-plain-54"]()
    for g, w in zip(_solve(world), _solve(world, sweeps=9, passes=8)):
        assert np.array_equal(g, w)


def test_place_blocks_wrappers():
    """place_blocks folds dense feasibility and static score matrices into
    a masked static one; place_blocks_packed packs its outputs with task
    spans of length T (auction.py)."""
    world = BLOCK_WORLDS["t300-padding"]()
    T, N = len(world["req"]), len(world["idle"])
    feas = world["ms"] > -1e29
    static = np.where(feas, world["ms"], 7.0).astype(np.float32)
    t = torch.tensor
    nodes = B.NodeState(t(world["idle"]), t(world["future_idle"]),
                        t(world["used"]), t(world["ntasks"]))
    jobs = B.JobMeta(t(world["min_available"]), t(world["base_ready"]),
                     t(world["base_pipelined"]))
    tasks = B.BlockTasks(t(world["req"]), t(world["job_ix"]),
                         t(world["valid"]), t(feas), t(static))
    w = default_weights(2)
    packed, _ = B.place_blocks_packed(nodes, tasks, jobs, w,
                                      t(world["allocatable"]),
                                      t(world["max_tasks"]))
    full = _solve(world)[0]
    Tp, J = B.padded_task_len(T), len(world["min_available"])
    assert np.array_equal(packed.numpy(), np.concatenate([
        full[:T], full[Tp:Tp + T], full[2 * Tp:]]))
    assert N == world["allocatable"].shape[0]


def test_sum_unit_and_the_exact_shortcut():
    """The plain version sums in any order only where the sum and all its
    partial sums are exact in f32: whole multiples of the requests' unit
    (the largest power of two dividing them) below 2^24 units."""
    gib = float(1 << 30)
    unit = B.sum_unit(torch.tensor([[500.0, 2 * gib], [250.0, 0.0]]))
    assert unit.tolist() == [2.0, 2.0 ** 31]
    assert B.sum_unit(torch.tensor([[0.0, 0.0]])).tolist() == [1.0, 1.0]
    assert B.sum_unit(torch.tensor([[-1.0, 1.0]])) is None
    assert B.sum_unit(torch.tensor([[float("inf"), 1.0]])) is None
    unit = B.sum_unit(torch.tensor([[1.0, 1.0]]))
    assert B._exact(torch.tensor([[2.0 ** 24 - 1, 3.0]], dtype=torch.float64),
                    unit)
    assert not B._exact(torch.tensor([[2.0 ** 24, 3.0]],
                                     dtype=torch.float64), unit)
    # past 2^24 the sums take the ordered path: 2^24 + 1 + 1 in order
    vals = torch.tensor([[2.0 ** 24], [1.0], [1.0]])
    node = torch.zeros(3, dtype=torch.long)
    got = B._node_sums(node, vals, 1, B.sum_unit(vals))
    assert got.item() == float(np.float32(np.float32(2.0 ** 24 + 1) + 1))


def test_blocks_dispatch_and_refusals():
    """CPU tensors take the plain version; blocks_cuda refuses them, and the
    node-sharded form (a mesh) is refused by name."""
    args, kw = blocks_args(BLOCK_WORLDS["n-lt-32"](), "cpu")
    stats = {}
    got = B.blocks(*args, stats=stats, **kw)
    want = B.blocks_plain(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert stats["sweeps"] >= 1 and stats["chunks"] >= 1
    with pytest.raises(ValueError, match="not a CUDA device"):
        B.blocks_cuda(*args, **kw)
    with pytest.raises(NotImplementedError, match="mesh"):
        B.place_blocks_unified(object(), *([None] * 8))


# ---------------------------------------------------------------------------
# the kernels' per-solve helpers: row classes and per-chunk exactness
# ---------------------------------------------------------------------------

def _classes_numpy(req, ms, chunk):
    """Each chunk's rows numbered by the first row with the same request
    bytes and static row bytes: (cls, first row of each class, classes)."""
    Tp = len(req)
    cls = np.zeros(Tp, np.int32)
    reps = np.zeros((Tp // chunk, chunk), np.int32)
    count = []
    for c in range(Tp // chunk):
        seen = {}
        for r in range(chunk):
            t = c * chunk + r
            key = req[t].tobytes() + (b"" if ms is None else ms[t].tobytes())
            if key not in seen:
                reps[c, len(seen)] = r
                seen[key] = len(seen)
            cls[t] = seen[key]
        count.append(len(seen))
    return cls, reps, np.array(count, np.int32)


@pytest.mark.parametrize("name", ["static-classes", "t300-padding",
                                  "unified-0-ms-33", "identical",
                                  "fractional-ms", "idle-chunks",
                                  "n-lt-32"])
def test_task_classes_match_numpy(name):
    """task_classes groups a chunk's rows exactly by request and static
    row bytes (-0 and +0 apart), classes numbered by their first row."""
    args, kw = blocks_args(BLOCK_WORLDS[name](), "cpu")
    req, ms = args[6], args[10]
    got = B.task_classes(req, ms, kw["chunk"])
    want = _classes_numpy(req.numpy(), None if ms is None else ms.numpy(),
                          kw["chunk"])
    for label, g, w in zip(("cls", "class_rep", "n_class"), got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w), label


def _exact_numpy(req, chunk):
    """Per chunk: every column total below 2^24 units, the unit the largest
    power of two dividing every nonzero request of the column, in exact
    rational arithmetic; all False when a request is negative (or -0),
    subnormal, infinite or NaN."""
    from fractions import Fraction
    flat = req.ravel()
    if (np.signbit(flat).any() | (~np.isfinite(flat)).any()
            | ((flat != 0) & (np.abs(flat) < np.finfo(np.float32).tiny)
               ).any()):
        return np.zeros(len(req) // chunk, bool)
    units = []
    for col in req.T:
        best = None
        for v in col[col != 0]:
            f = Fraction(float(v))
            num, val = f.numerator, -(f.denominator.bit_length() - 1)
            while num % 2 == 0:
                num //= 2
                val += 1
            best = val if best is None else min(best, val)
        units.append(Fraction(2) ** (best or 0))
    out = []
    for c in range(len(req) // chunk):
        block = req[c * chunk:(c + 1) * chunk]
        out.append(all(sum(Fraction(float(v)) for v in block[:, r])
                       < units[r] * 2 ** 24 for r in range(req.shape[1])))
    return np.array(out)


@pytest.mark.parametrize("name", ["mixed-exact", "fractional", "identical",
                                  "unified-0-plain-33", "lanes-wave-256",
                                  "one-node-40", "bad-requests"])
def test_chunk_exact_matches_numpy(name):
    """chunk_exact's flags are the direct rational computation's; the
    mixed world has one chunk of each kind."""
    if name == "bad-requests":
        world = BLOCK_WORLDS["identical"]()
        world["req"][3, 0] = -0.0
        world["req"][600 - 1, 1] = 1e-40            # subnormal
    else:
        world = BLOCK_WORLDS[name]()
    args, kw = blocks_args(world, "cpu")
    got = B.chunk_exact(args[6], kw["chunk"])
    assert got.dtype == torch.bool
    want = _exact_numpy(args[6].numpy(), kw["chunk"])
    assert got.tolist() == want.tolist()
    if name == "mixed-exact":
        assert want.tolist() == [True, False]
    if name == "bad-requests":
        assert not want.any()
