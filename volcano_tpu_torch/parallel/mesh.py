"""Multi-slot scaling: the mesh plumbing of ops/unified.py re-exported
(the JAX package's parallel/mesh.py), and ``place_blocks_sharded``, the
5-tuple view over the unified solver's packed result."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.blocks import JobMeta, NodeState
from ..ops.scores import ScoreWeights
from ..ops.unified import (  # noqa: F401
    NODE_AXIS, make_mesh, padded_task_len, place_blocks_unified,
    place_scan_unified)

__all__ = ["NODE_AXIS", "make_mesh", "place_blocks_sharded",
           "place_blocks_unified", "place_scan_unified"]


def place_blocks_sharded(mesh, nodes: NodeState, req: torch.Tensor,
                         valid: torch.Tensor, job_ix: torch.Tensor,
                         jobs: JobMeta, weights: ScoreWeights,
                         allocatable: torch.Tensor, max_tasks: torch.Tensor,
                         chunk: int = 256, sweeps: int = 3, passes: int = 3,
                         masked_static: Optional[torch.Tensor] = None,
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor, NodeState]:
    """(task_node i32[T], pipelined bool[T], job_ready bool[J], job_kept
    bool[J], nodes): slices of ``place_blocks_unified``'s packed row, left
    on the device (parallel/mesh.py:30-49)."""
    T = req.shape[0]
    J = len(jobs.min_available)
    packed, out_nodes = place_blocks_unified(
        mesh, nodes, req, valid, job_ix, jobs, weights, allocatable,
        max_tasks, chunk=chunk, sweeps=sweeps, passes=passes,
        masked_static=masked_static)
    Tp = padded_task_len(T, chunk)
    return (packed[:T], packed[Tp:Tp + T].bool(),
            packed[2 * Tp:2 * Tp + J].bool(),
            packed[2 * Tp + J:2 * Tp + 2 * J].bool(), out_nodes)
