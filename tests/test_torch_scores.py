"""The port's dynamic scorers (volcano_tpu_torch/ops/scores.py) against the
JAX package's (volcano_tpu/ops/scores.py), on the same seeded inputs.

Exact equality (rtol=0): both run every f32 operation on its own, in the
same order. The JAX functions run op by op here, outside jit, as the JAX
package's own scorer tests call them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volcano_tpu.ops import scores as jax_scores
from volcano_tpu_torch.ops import scores as torch_scores


def _inputs(seed, R, batch):
    rng = np.random.RandomState(seed)
    N = 64
    alloc = rng.choice([0.0, 2000.0, 4000.0, 32000.0],
                       size=(N, R)).astype(np.float32)
    used = (alloc * rng.uniform(0, 1.1, size=(N, R))).astype(np.float32)
    shape = (5, R) if batch else (R,)
    req = rng.choice([0.0, 250.0, 1000.0, 3700.0], size=shape).astype(
        np.float32)
    res = rng.choice([0.0, 1.0, 2.0], size=R).astype(np.float32)
    return req, used, alloc, res


CASES = [(seed, R, batch) for seed in range(3) for R in (2, 3)
         for batch in (False, True)]


@pytest.mark.parametrize("seed, R, batch", CASES)
@pytest.mark.parametrize("scorer", ["binpack", "least", "most", "balanced",
                                    "combined"])
def test_scorer_matches_jax(scorer, seed, R, batch):
    req, used, alloc, res = _inputs(seed, R, batch)
    j = [jnp.asarray(a) for a in (req, used, alloc)]
    t = [torch.tensor(a) for a in (req, used, alloc)]
    if scorer == "binpack":
        want = jax_scores.binpack_score(*j, jnp.asarray(res), 2.0)
        got = torch_scores.binpack_score(*t, torch.tensor(res), 2.0)
    elif scorer == "combined":
        jw = jax_scores.ScoreWeights(1.0, jnp.asarray(res), 1.0, 2.0, 3.0)
        tw = torch_scores.ScoreWeights(1.0, res, 1.0, 2.0, 3.0)
        want = jax_scores.combined_dynamic_score(*j, jw)
        got = torch_scores.combined_dynamic_score(*t, tw)
    else:
        fn = f"{scorer}_allocated_score" if scorer != "balanced" \
            else "balanced_allocation_score"
        want = getattr(jax_scores, fn)(*j)
        got = getattr(torch_scores, fn)(*t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_default_weights_match_jax():
    jw = jax_scores.default_weights(3)
    tw = torch_scores.default_weights(3)
    np.testing.assert_array_equal(tw.binpack_res, np.asarray(jw.binpack_res))
    assert tw._replace(binpack_res=None) == jw._replace(binpack_res=None)
