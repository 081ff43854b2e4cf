"""Snapshot → dense tensor marshaling for the allocate solve.

The reference's hot loops iterate (pending task × node) pairs through plugin
callbacks (util.PredicateNodes / PrioritizeNodes,
pkg/scheduler/util/scheduler_helper.go:71-192). Here the
session is materialized once per solve into:

- per-node state tensors f32[N,R] (idle/used/releasing/pipelined/
  allocatable) and i32[N] pod counts, on the session's device,
- per-task request rows f32[T,R],
- a static feasibility mask bool[T,N] and a static score matrix f32[T,N]
  from plugin contributions (None when every plugin abstains),
- ScoreWeights for the in-kernel dynamic scorers.

Rows are built in NumPy and copied to the device once.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..api import NodeInfo, Resource, ResourceNames, TaskInfo
from ..ops.scores import ScoreWeights

BIG_MAX_TASKS = 1 << 30


class NodeTensors:
    """Dense node-state tensors on ``device``, index-aligned with ``names``."""

    def __init__(self, nodes: Sequence[NodeInfo], rnames: ResourceNames,
                 device: torch.device):
        self.rnames = rnames
        self.names: List[str] = [n.name for n in nodes]
        self.index: Dict[str, int] = {n: i for i, n in enumerate(self.names)}
        N, R = len(nodes), len(rnames)
        host = {f: np.zeros((N, R), np.float32) for f in
                ("idle", "used", "releasing", "pipelined", "allocatable")}
        max_tasks = np.zeros(N, np.int32)
        ntasks = np.zeros(N, np.int32)
        for i, n in enumerate(nodes):
            host["idle"][i] = n.idle.to_vector(rnames)
            host["used"][i] = n.used.to_vector(rnames)
            host["releasing"][i] = n.releasing.to_vector(rnames)
            host["pipelined"][i] = n.pipelined.to_vector(rnames)
            host["allocatable"][i] = n.allocatable.to_vector(rnames)
            max_tasks[i] = n.max_task_num if n.max_task_num > 0 else BIG_MAX_TASKS
            ntasks[i] = len(n.tasks)
        # FutureIdle = Idle + Releasing - Pipelined (node_info.go), in f32
        # and in this order, like the JAX package's NodeState
        future_idle = host["idle"] + host["releasing"] - host["pipelined"]

        def put(a: np.ndarray) -> torch.Tensor:
            # torch.tensor copies: the tensor never aliases the host array
            return torch.tensor(a, device=device)

        self.idle = put(host["idle"])
        self.future_idle = put(future_idle)
        self.used = put(host["used"])
        self.allocatable = put(host["allocatable"])
        self.max_tasks = put(max_tasks)
        self.ntasks = put(ntasks)


def discover_resource_names(nodes: Sequence[NodeInfo],
                            tasks: Sequence[TaskInfo]) -> ResourceNames:
    rs: List[Resource] = [n.allocatable for n in nodes]
    rs += [t.resreq for t in tasks]
    return ResourceNames.discover(rs)


def task_requests(tasks: Sequence[TaskInfo], rnames: ResourceNames) -> np.ndarray:
    T, R = len(tasks), len(rnames)
    req = np.zeros((T, R), np.float32)
    for i, t in enumerate(tasks):
        req[i] = t.init_resreq.to_vector(rnames)
    return req


def assemble_feasibility(ssn, tasks: Sequence[TaskInfo],
                         node_t: NodeTensors) -> Optional[np.ndarray]:
    """AND of all plugin feasibility contributions. Returns None when every
    plugin abstained (the mask would be all-true) so the solve skips the
    [T,N] transfer entirely."""
    mask = None
    for fn in ssn.feasibility_fns.values():
        m = fn(ssn, tasks, node_t)
        if m is None:
            continue
        mask = m if mask is None else (mask & m)
    return mask


def assemble_static_score(ssn, tasks: Sequence[TaskInfo],
                          node_t: NodeTensors) -> Optional[np.ndarray]:
    """Sum of static score matrices; None when every plugin abstained (a
    constant-zero matrix) so the solve skips the [T,N] transfer."""
    score = None
    for fn in ssn.static_score_fns.values():
        s = fn(ssn, tasks, node_t)
        if s is None:
            continue
        s = s.astype(np.float32)
        score = s if score is None else (score + s)
    return score


def assemble_weights(ssn, rnames: ResourceNames) -> ScoreWeights:
    """Merge plugin weight contributions into one ScoreWeights. Plugins set
    e.g. {'binpack_weight': 1, 'binpack_res': {...}} or {'least_req_weight': 1}
    via ssn.set_dynamic_score_weights."""
    binpack_res = np.zeros(len(rnames), np.float32)
    vals = {"binpack_weight": 0.0, "least_req_weight": 0.0,
            "most_req_weight": 0.0, "balanced_weight": 0.0}
    for w in ssn.dynamic_score_weights.values():
        for k in vals:
            vals[k] += float(w.get(k, 0.0))
        for rname, rw in (w.get("binpack_res") or {}).items():
            if rname in rnames.index:
                binpack_res[rnames.index[rname]] += float(rw)
    return ScoreWeights(binpack_weight=vals["binpack_weight"],
                        binpack_res=binpack_res,
                        least_req_weight=vals["least_req_weight"],
                        most_req_weight=vals["most_req_weight"],
                        balanced_weight=vals["balanced_weight"])
