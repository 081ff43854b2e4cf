"""Binpack plugin: best-fit node scoring.

Mirrors pkg/scheduler/plugins/binpack/binpack.go:60-260.
Contributes its per-resource weights to the in-kernel dynamic scorer
(ops/scores.binpack_score), which the placement kernel re-evaluates as node
usage mutates.
"""

from __future__ import annotations

from typing import Dict

from ..api import CPU, MEMORY
from .base import Plugin


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

    def on_session_open(self, ssn) -> None:
        if self.weight != 0:
            ssn.set_dynamic_score_weights(
                self.NAME, binpack_weight=float(self.weight),
                binpack_res={k: float(v) for k, v in self.res_weights.items()})


def New(arguments):
    return BinpackPlugin(arguments)
