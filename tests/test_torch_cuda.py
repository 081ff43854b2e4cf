"""The CUDA placement kernel against its plain version, on the card.

These tests need an NVIDIA card and nvcc; without a card they skip. On the
card: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from volcano_tpu_torch.ops.place import (NEG, place, place_cuda, place_plain,
                                         task_flags)
from volcano_tpu_torch.ops.scores import default_weights

from torch_parity import PLACE_WORLDS

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


@pytest.mark.parametrize("world", list(PLACE_WORLDS))
def test_kernel_matches_plain(world, card):
    args = _args(PLACE_WORLDS[world](), card)
    got = place_cuda(*args)
    want = place_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_place_dispatches_cuda_tensors_to_the_kernel(card):
    inst = PLACE_WORLDS["ties"]()
    args = _args(inst, card)
    before = place_cuda.launches
    res = place(*args[:7], inst[7], args[10], inst[10],
                np.zeros(len(inst[10]), np.int32),
                np.zeros(len(inst[10]), np.int32), args[11])
    assert place_cuda.launches == before + 1
    assert (res.task_node >= 0).all()
