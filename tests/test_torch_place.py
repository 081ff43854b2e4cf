"""place_plain (the plain version of the CUDA placement kernel) against the
JAX package's place_scan, and against its Pallas kernel in interpret mode
where the two JAX programs agree (whole-number state: the Pallas kernel
tests fit as req <= idle, the scan as req < idle + 0.1).

Decisions must be equal and the final node state equal to the bit
(rtol=0, atol=0): both sides add and subtract the same f32 requests in the
same order. The JAX results come from tests/torch_parity.py's reference
process. The kernel itself runs only on the card (test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from volcano_tpu_torch.ops.place import (CLUSTER_SIZES, NEG, SMEM_MAX,
                                         fixed_bytes, launch_plan,
                                         node_bytes, place, place_plain,
                                         rowdiff_cuda, rowdiff_plain,
                                         scored_pairs, scratch_bytes,
                                         task_flags, task_rescores,
                                         tree_bytes)
from volcano_tpu_torch.ops.scores import default_weights

from torch_parity import (INTEGER_PLACE_WORLDS, PLACE_WORLDS, jax_place,
                          jax_reference)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_reference("place", list(PLACE_WORLDS),
                         tmp_path_factory.mktemp("jax") / "place.pkl")


def torch_place(inst):
    (idle, releasing, used, ntasks, cap, max_tasks, req, job_ix,
     feas, static, min_avail) = inst
    J = len(min_avail)
    t = torch.tensor
    res = place(t(idle), t(idle + releasing), t(used), t(ntasks), t(cap),
                t(max_tasks), t(req), job_ix,
                t(np.where(feas, static, NEG).astype(np.float32)),
                min_avail, np.zeros(J, np.int32), np.zeros(J, np.int32),
                default_weights(req.shape[1]))
    return (res.task_node, res.task_pipelined, res.job_ready, res.job_kept,
            res.idle.numpy(), res.future_idle.numpy(), res.used.numpy(),
            res.ntasks.numpy())


FIELDS = ("task_node", "pipelined", "job_ready", "job_kept", "idle",
          "future_idle", "used", "ntasks")


def assert_equal(got, want, label):
    for name, g, w in zip(FIELDS, got, want):
        np.testing.assert_array_equal(g, w, err_msg=f"{label}: {name}")


@pytest.mark.parametrize("world", list(PLACE_WORLDS))
def test_plain_matches_jax(world, reference):
    got = torch_place(PLACE_WORLDS[world]())
    assert_equal(got, reference[world]["scan"], "place_scan")
    if world in INTEGER_PLACE_WORLDS:
        assert_equal(got, reference[world]["pallas"], "place_pallas")
    assert (got[0] >= 0).any()


@pytest.mark.parametrize("kw", [dict(seed=3),
                                dict(seed=101, T=60, N=8, J=10, tight=True)])
def test_random_worlds_are_the_pallas_tests_worlds(kw):
    from test_pallas_place import _random_instance
    from torch_parity import _random
    for a, b in zip(_random(**kw), _random_instance(**kw)):
        np.testing.assert_array_equal(a, b)


def test_worlds_exercise_what_they_name(reference):
    """The tie, sub-epsilon and rollback worlds really take those paths."""
    ties = reference["ties"]["scan"]
    assert ties[3].all() and (ties[0] >= 0).all()
    sub = reference["sub-epsilon"]["scan"]
    placed = sub[0][sub[0] >= 0]
    assert len(placed) and (placed % 2 == 0).all()   # only the 0.05-short nodes
    rb = reference["rollback"]["scan"]
    assert not rb[3].all() and rb[3][-1]             # a rollback, then a fit
    assert rb[1].any()                               # and a pipeline
    rs = reference["rollback-then-same"]["scan"]
    assert list(rs[3]) == [True, True, False, False, True]
    wide = reference["wide-ties"]["scan"]
    assert wide[0].max() >= 3 * 64 // 2              # past a 2-CTA slice
    assert (np.diff(wide[0]) >= 0).all()             # lowest index first
    assert reference["runs"]["scan"][3].all()


def test_reference_is_the_compiled_scan():
    """In this process (XLA's default optimization) the compiled scan
    decides the tie world exactly as the reference does: the reference
    differs from it only in how XLA rounds, never in what it computes."""
    ref = jax_place(PLACE_WORLDS["ties"](), pallas=False)["scan"]
    assert_equal(torch_place(PLACE_WORLDS["ties"]()), ref, "place_scan")


def _plain_words(inst):
    """place_plain's packed words for a world, with its kernel inputs."""
    (idle, releasing, used, ntasks, cap, max_tasks, req, job_ix,
     feas, static, min_avail) = inst
    zeros = np.zeros(len(min_avail), np.int32)
    flags, ready_need, keep_need = task_flags(job_ix, min_avail, zeros, zeros)
    ms = np.where(feas, static, NEG).astype(np.float32)
    t = torch.tensor
    packed = place_plain(t(idle), t(idle + releasing), t(used), t(ntasks),
                         t(cap), t(max_tasks), t(req), t(flags),
                         t(ready_need), t(keep_need), t(ms),
                         default_weights(req.shape[1]))[0].numpy()
    return packed, flags, req, ms


@pytest.mark.parametrize("world,most", [("runs", 0.06), ("wide-ties", 0.01),
                                        ("static-one-node", 0.1)])
def test_cache_rescores_only_what_changed(world, most):
    """Inside a gang of one request and one static row, a task re-scores
    the node picked last; one changed static entry re-scores one node."""
    packed, flags, req, ms = _plain_words(PLACE_WORLDS[world]())
    T, N = ms.shape
    got = scored_pairs(packed, flags, req, ms, N)
    assert N <= got <= most * T * N


def test_scored_pairs_counts_each_stale_rule():
    """Three tasks of one gang on four nodes: the first scores all nodes, the
    second the node picked first plus the one static entry that moved, the
    third (a new request) all nodes again."""
    flags = np.array([3, 1, 5], np.int32)
    req = np.array([[1, 1], [1, 1], [2, 1]], np.float32)
    ms = np.zeros((3, 4), np.float32)
    ms[1:, 3] = 7.0
    packed = np.array([(2 << 4) | 1, (3 << 4) | 1, (1 << 4) | 1 | 8],
                      np.int32)
    assert scored_pairs(packed, flags, req, ms, 4) == 4 + 2 + 4
    assert scored_pairs(packed, flags, req, None, 4) == 4 + 1 + 4


def test_scored_pairs_counts_restored_nodes():
    """A rejected gang's nodes are stale for the next task; a broken job's
    later tasks are not evaluated."""
    flags = np.array([3, 1, 5, 7], np.int32)
    req = np.ones((4, 2), np.float32)
    packed = np.array([(1 << 4) | 1, 0, 0, (2 << 4) | 1 | 8], np.int32)
    # task 0 scores 5 nodes, task 1 (fails) node 0, task 2 is skipped, the
    # rollback restores node 0, task 3 re-scores it
    assert scored_pairs(packed, flags, req, None, 5) == 5 + 1 + 1


@pytest.mark.parametrize("R", [2, 8])
@pytest.mark.parametrize("N", [1, 31, 2000, 2048, 8192, 40000])
def test_launch_plan(N, R):
    """Every node belongs to exactly one (CTA, thread), a CTA's shared
    memory stays within Hopper's 232,448 bytes, and the planes go to device
    memory exactly when a slice does not fit beside the fixed part; at
    every cluster size, with and without a static matrix."""
    for has_static in (False, True):
        for cluster in (None, *CLUSTER_SIZES):
            plan = launch_plan(N, R, has_static, 16, cluster)
            # place.cu: CTA k owns [k*slice, (k+1)*slice) within [0, N);
            # its thread t the nodes lo + t, lo + t + threads, ...
            owners = np.zeros(N, np.int64)
            for k in range(plan.cluster):
                lo, hi = min(k * plan.slice, N), min((k + 1) * plan.slice, N)
                for t in range(plan.threads):
                    owners[lo + t:hi:plan.threads] += 1
            assert (owners == 1).all(), plan
            assert plan.smem_bytes <= SMEM_MAX, plan
            fits = (fixed_bytes(R) + plan.slice
                    * node_bytes(R, has_static, False)
                    + tree_bytes(plan.slice) <= SMEM_MAX)
            assert plan.in_smem == fits, plan
            assert (scratch_bytes(plan, N) > 0) == (not plan.in_smem)
            assert plan.ro_smem <= plan.in_smem
            # a thread a node of the slice, a multiple of 32, 64 to 512
            want = min(512, max(64, -(-plan.slice // 32) * 32))
            assert plan.threads == want, plan


def test_launch_plan_default_cluster():
    """The default is one CTA when every node fits its shared memory, else
    the largest cluster the card launches; past a 16-CTA cluster's shared
    memory the node arrays go to device memory."""
    assert launch_plan(2000, 2, True, 16).cluster == 1
    assert launch_plan(8192, 3, False, 16).cluster == 16
    assert launch_plan(8192, 3, False, 4).cluster == 4
    big = launch_plan(40000, 8, False, 16)
    assert (big.cluster, big.in_smem) == (16, False)
    assert launch_plan(40000, 8, False, 8).cluster == 8
    with pytest.raises(ValueError):
        launch_plan(2000, 2, False, 4, cluster=8)


@pytest.mark.parametrize("world", list(PLACE_WORLDS))
def test_task_rescores_one_count_per_evaluated_task(world):
    """One count per task the solve evaluated (placed, or the failed task
    that broke its job), each within [0, N]; the first is N, and the counts
    sum to scored_pairs."""
    packed, flags, req, ms = _plain_words(PLACE_WORLDS[world]())
    T, N = ms.shape
    counts = task_rescores(packed, flags, req, ms, N)
    placed = (packed & 1) != 0
    job_of = np.cumsum((flags & 2) != 0) - 1
    assert len(counts) == placed.sum() + len(np.unique(job_of[~placed]))
    assert counts[0] == N and ((counts >= 0) & (counts <= N)).all()
    assert counts.sum() == scored_pairs(packed, flags, req, ms, N)


@pytest.mark.parametrize("world", ["runs", "static-one-node",
                                   "rollback-then-same", "multi-chunk"])
def test_rowdiff_plain_marks_rows_that_differ(world):
    """The first row, and each row whose bits differ from the row before."""
    ms = _plain_words(PLACE_WORLDS[world]())[3]
    bits = ms.view(np.uint32)
    want = np.ones(len(ms), np.int32)
    want[1:] = (bits[1:] != bits[:-1]).any(axis=1)
    got = rowdiff_plain(torch.tensor(ms)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


def test_rowdiff_plain_compares_bits():
    """-0 and +0 are different rows; a row equal to the one before is not
    marked, NaN bits included."""
    nan = np.float32("nan")
    ms = np.array([[0.0, 1.0], [-0.0, 1.0], [-0.0, 1.0], [nan, 1.0],
                   [nan, 1.0]], np.float32)
    assert rowdiff_plain(torch.tensor(ms)).tolist() == [1, 1, 0, 1, 0]
    assert rowdiff_plain(torch.zeros(0, 3)).tolist() == []


def test_rowdiff_cuda_refuses_cpu_tensors():
    """The kernel's wrapper never computes on the CPU: a CPU tensor raises
    before anything is built or launched."""
    before = rowdiff_cuda.launches
    with pytest.raises(ValueError):
        rowdiff_cuda(torch.zeros(4, 3))
    assert rowdiff_cuda.launches == before
