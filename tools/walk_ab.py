#!/usr/bin/env python3
"""Time this checkout's preempt walk kernel against another checkout's, on
the same CUDA tensors and the same card, in turns: other, this, this, other.
Both must give the same task nodes, slot owners, quota verdicts and
evaluated tasks.

    git archive REV | tar -x -C chip_archive/other     # chip_archive/ is
    python3 tools/walk_ab.py chip_archive/other         # not committed

(from the repository root, on a machine with a CUDA card and nvcc). The
other checkout's ``volcano_tpu_torch/ops`` package is imported under a name
of its own and called through its own ``walk_cuda``, so any revision whose
``walk_cuda`` takes ``walk_plain``'s four arguments will do; it builds its
kernels into its own ``ops/_build/``. The walks: the preempt world's phase
1 and its intra-job variant's phase 2 (recorded on this checkout's CPU
runs, as chip_smoke.py records them), the deployed tight mix's walk, and
the seeded worlds drf, w64, n2500, w64-n400 and n8192 of
tests/torch_parity.py.
Prints one JSON line per walk with each kernel's two times (CUDA events,
warm, median of 5), then the card's name and power limit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def other_evict_module(tree: str):
    """``ops/evict.py`` of the checkout at ``tree``, imported as the
    package ``walk_ab_other`` beside this checkout's own."""
    ops = os.path.join(os.path.abspath(tree), "volcano_tpu_torch", "ops")
    spec = importlib.util.spec_from_file_location(
        "walk_ab_other", os.path.join(ops, "__init__.py"),
        submodule_search_locations=[ops])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules["walk_ab_other"] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module("walk_ab_other.evict")


def recorded_walks():
    """(label, (inputs, kinds, sizes, gang)) for the walks the preempt
    world, its intra-job variant and the deployed tight mix run on the
    CPU."""
    import chip_smoke as cs
    from volcano_tpu_torch import Scheduler
    out = [("preempt-p1", cs.run_preempt("cpu")[5][0])]
    out += [("preempt-intra-p2", w) for w in
            cs.run_preempt("cpu", intra=True)[5] if not w[3]]
    tight = cs.record_walks(lambda: Scheduler(
        cs.deployed_world("tight-mix"), cs.deployed_conf(),
        device="cpu").run_once())
    out += [(f"tight-mix-walk-{k}", w) for k, w in enumerate(tight)]
    worlds = {**cs.walk_worlds(), **cs.walk_worlds(card=True)}
    out += [(name, worlds[name]()) for name in
            ("drf", "w64", "n2500", "w64-n400", "n8192")]
    return out


def main() -> int:
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    import chip_smoke as cs
    from volcano_tpu_torch.ops.evict import to_device, walk_cuda
    other = other_evict_module(sys.argv[1])
    dev = torch.device("cuda")
    for label, (inputs, kinds, sizes, gang) in recorded_walks():
        d = to_device(inputs, dev)
        theirs = other.walk_cuda(d, kinds, sizes, gang)
        ours = walk_cuda(d, kinds, sizes, gang)
        torch.cuda.synchronize()
        equal = (all(torch.equal(getattr(theirs, k), getattr(ours, k))
                     for k in ("task_node", "owner", "job_done"))
                 and theirs.steps == ours.steps)
        times = {"other_ms": [], "this_ms": []}
        for which in ("other_ms", "this_ms", "this_ms", "other_ms"):
            fn = other.walk_cuda if which == "other_ms" else walk_cuda
            times[which].append(cs.time_cuda_ms(
                lambda fn=fn: fn(d, kinds, sizes, gang)))
        print("ab", json.dumps({"world": label, "steps": ours.steps,
                                "equal": equal, **times}), flush=True)
        cs.check(equal, f"{label}: the two kernels disagree")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
