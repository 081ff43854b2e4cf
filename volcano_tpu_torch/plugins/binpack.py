"""Binpack plugin: best-fit node scoring.

Mirrors pkg/scheduler/plugins/binpack/binpack.go:60-260.
Contributes its per-resource weights to the in-kernel dynamic scorer
(ops/scores.binpack_score), which the placement kernel re-evaluates as node
usage mutates, and the host scorer ``score`` that preempt reads.
"""

from __future__ import annotations

from typing import Dict

from ..api import CPU, MEMORY
from .base import Plugin

MAX_NODE_SCORE = 100.0


class BinpackPlugin(Plugin):
    NAME = "binpack"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        args = self.arguments
        self.weight = args.get_int("binpack.weight", 1)
        # negative per-resource weights reset to 1 (binpack.go:123-147)
        self.res_weights: Dict[str, int] = {
            CPU: args.get_int("binpack.cpu", 1),
            MEMORY: args.get_int("binpack.memory", 1),
        }
        for rname in (CPU, MEMORY):
            if self.res_weights[rname] < 0:
                self.res_weights[rname] = 1
        # binpack.resources: "nvidia.com/gpu, example.com/foo" with
        # binpack.resources.<name> weights (binpack.go:89-155)
        for rname in str(args.get("binpack.resources", "")).split(","):
            rname = rname.strip()
            if rname:
                w = args.get_int(f"binpack.resources.{rname}", 1)
                self.res_weights[rname] = w if w >= 0 else 1

    def score(self, task, node) -> float:
        """BinPackingScore (binpack.go:196-244): the host scorer of preempt's
        callbacks rung and of its f64 rank replica."""
        score, weight_sum = 0.0, 0
        for rname in task.resreq.resource_names():
            request = task.resreq.get(rname)
            if request == 0:
                continue
            w = self.res_weights.get(rname)
            if w is None:
                continue
            allocatable = node.allocatable.get(rname)
            used = node.used.get(rname)
            if allocatable != 0 and w != 0 and used + request <= allocatable:
                score += (used + request) * w / allocatable
            weight_sum += w
        if weight_sum > 0:
            score /= weight_sum
        return score * MAX_NODE_SCORE * self.weight

    def on_session_open(self, ssn) -> None:
        if self.weight != 0:
            ssn.add_node_order_fn(self.NAME, self.score)
            ssn.set_dynamic_score_weights(
                self.NAME, binpack_weight=float(self.weight),
                binpack_res={k: float(v) for k, v in self.res_weights.items()})


def New(arguments):
    return BinpackPlugin(arguments)
