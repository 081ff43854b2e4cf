"""Node-order scoring as tensor expressions.

Each scorer maps (task request ``f32[R]`` or batch ``f32[T,R]``, node state
``f32[N,R]``) → ``f32[N]``/``f32[T,N]``. These replace the per-(task,node)
callback scorers of the reference:

- binpack       pkg/scheduler/plugins/binpack/binpack.go:196-260
- least/most    k8s noderesources plugins wrapped by
                pkg/scheduler/plugins/nodeorder/nodeorder.go:179-269
- balanced      k8s NodeResourcesBalancedAllocation (same wrap)

Every operation is written out in the order the CUDA placement kernel
(ops/csrc/place.cu) performs it — sums over the resource axis left to
right, means as a sum then a division, a square as one product — so the
kernel and these functions round alike and pick the same node on a tie.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MAX_NODE_SCORE = 100.0


class ScoreWeights(NamedTuple):
    """Static weights for the dynamic (state-dependent) scorers.

    binpack_res: f32[R] per-resource binpack weights (binpack.go:89-155;
    defaults cpu=1, memory=1, others 0 unless configured).
    """

    binpack_weight: float = 1.0
    binpack_res: np.ndarray = None            # f32[R]
    least_req_weight: float = 1.0
    most_req_weight: float = 0.0
    balanced_weight: float = 1.0


def safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num/den with 0 where den == 0 (scores never divide by zero capacity)."""
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, 1.0), 0.0)


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the resource axis, left to right."""
    acc = x[..., 0]
    for r in range(1, x.shape[-1]):
        acc = acc + x[..., r]
    return acc


def _mean_cpu_mem(frac: torch.Tensor) -> torch.Tensor:
    """Mean of the cpu and memory columns."""
    return (frac[..., 0] + frac[..., 1]) / 2.0


def binpack_score(req: torch.Tensor, used: torch.Tensor,
                  allocatable: torch.Tensor, res_weights: torch.Tensor,
                  plugin_weight: float) -> torch.Tensor:
    """Best-fit score (BinPackingScore, binpack.go:196-260).

    Per resource r with request>0 and weight>0:
      score_r = (used_r + req_r) * w_r / allocatable_r   (0 if would overflow)
    total = sum_r score_r / sum_r w_r * 100 * plugin_weight
    """
    req_b = req[..., None, :]                      # [..., 1, R]
    used_finally = used + req_b                    # [..., N, R]
    active = (req_b > 0) & (res_weights > 0)       # dims that participate
    fits = used_finally <= allocatable             # inclusive (binpack.go:253)
    per_res = torch.where(active & fits & (allocatable > 0),
                          safe_div(used_finally * res_weights, allocatable),
                          0.0)
    weight_sum = _sum_last(torch.where(req_b > 0, res_weights, 0.0))
    score = safe_div(_sum_last(per_res), weight_sum)
    return score * MAX_NODE_SCORE * plugin_weight


def least_allocated_score(req: torch.Tensor, used: torch.Tensor,
                          allocatable: torch.Tensor) -> torch.Tensor:
    """k8s NodeResourcesLeastAllocated with cpu/memory weight 50/50
    (nodeorder.go:179-190): mean over {cpu,mem} of
    (alloc - used - req) * 100 / alloc."""
    req_b = req[..., None, :]
    frac = safe_div(allocatable - used - req_b, allocatable)
    frac = torch.clamp(frac, 0.0, 1.0)
    return _mean_cpu_mem(frac) * MAX_NODE_SCORE


def most_allocated_score(req: torch.Tensor, used: torch.Tensor,
                         allocatable: torch.Tensor) -> torch.Tensor:
    """k8s NodeResourcesMostAllocated, cpu/mem weights 1/1 (nodeorder.go:195-202)."""
    req_b = req[..., None, :]
    frac = safe_div(used + req_b, allocatable)
    frac = torch.where(frac > 1.0, 0.0, frac)      # over-capacity scores 0
    return _mean_cpu_mem(frac) * MAX_NODE_SCORE


def balanced_allocation_score(req: torch.Tensor, used: torch.Tensor,
                              allocatable: torch.Tensor) -> torch.Tensor:
    """k8s NodeResourcesBalancedAllocation (nodeorder.go:204-206):
    (1 - std(resource fractions)) * 100 over cpu/mem."""
    req_b = req[..., None, :]
    frac = torch.clamp(safe_div(used + req_b, allocatable), 0.0, 1.0)
    mean = _mean_cpu_mem(frac)
    d_cpu = frac[..., 0] - mean
    d_mem = frac[..., 1] - mean
    std = torch.sqrt((d_cpu * d_cpu + d_mem * d_mem) / 2.0)
    return (1.0 - std) * MAX_NODE_SCORE


def combined_dynamic_score(req: torch.Tensor, used: torch.Tensor,
                           allocatable: torch.Tensor,
                           w: ScoreWeights) -> torch.Tensor:
    """Weighted sum of all state-dependent scorers, mirroring how the session
    sums NodeOrderFn contributions (session_plugins.go NodeOrderFn)."""
    res = torch.as_tensor(w.binpack_res, dtype=torch.float32,
                          device=used.device)
    score = binpack_score(req, used, allocatable, res, w.binpack_weight)
    score = score + w.least_req_weight * least_allocated_score(req, used, allocatable)
    score = score + w.most_req_weight * most_allocated_score(req, used, allocatable)
    score = score + w.balanced_weight * balanced_allocation_score(req, used, allocatable)
    return score


def default_weights(num_res: int) -> ScoreWeights:
    """Default plugin weights: binpack cpu/mem = 1, others 0; nodeorder
    least=1, most=0, balanced=1 (nodeorder.go:71-138, binpack.go:89-155)."""
    res = np.zeros(num_res, np.float32)
    res[:2] = 1.0
    return ScoreWeights(binpack_weight=1.0, binpack_res=res,
                        least_req_weight=1.0, most_req_weight=0.0,
                        balanced_weight=1.0)
