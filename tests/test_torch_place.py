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

from volcano_tpu_torch.ops.place import NEG, place
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


def test_reference_is_the_compiled_scan():
    """In this process (XLA's default optimization) the compiled scan
    decides the tie world exactly as the reference does: the reference
    differs from it only in how XLA rounds, never in what it computes."""
    ref = jax_place(PLACE_WORLDS["ties"](), pallas=False)["scan"]
    assert_equal(torch_place(PLACE_WORLDS["ties"]()), ref, "place_scan")
