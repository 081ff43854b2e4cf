#!/usr/bin/env python3
"""Time this checkout's placement kernel against another checkout's, on the
same CUDA tensors and the same card, in turns: other, this, this, other.
Both must give the same packed words and final state.

    git archive REV | tar -x -C chip_archive/other     # chip_archive/ is
    python3 tools/place_ab.py chip_archive/other        # not committed

(from the repository root, on a machine with a CUDA card and nvcc). The
other checkout's ``volcano_tpu_torch/ops`` package is imported under a name
of its own and called through its own ``place_cuda``, so any revision whose
``place_cuda`` takes the twelve arguments of ``place_plain`` will do; it
builds its kernels into its own ``ops/_build/``. Prints one JSON line per
world (slice-10k and slice-10k-taints, and chip_smoke.py's r3-n8192,
tight-0, random-0 and identical-nodes) with each kernel's two times (CUDA
events, warm, median of 5), then the card's name and power limit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def other_place_module(tree: str):
    """``ops/place.py`` of the checkout at ``tree``, imported as the
    package ``place_ab_other`` beside this checkout's own."""
    ops = os.path.join(os.path.abspath(tree), "volcano_tpu_torch", "ops")
    spec = importlib.util.spec_from_file_location(
        "place_ab_other", os.path.join(ops, "__init__.py"),
        submodule_search_locations=[ops])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules["place_ab_other"] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module("place_ab_other.place")


def main() -> int:
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    import chip_smoke as cs
    from volcano_tpu_torch.cache.synthetic import baseline_config
    from volcano_tpu_torch.ops.place import place_cuda
    other = other_place_module(sys.argv[1])
    dev = torch.device("cuda")
    tainted = baseline_config("10k")[0]
    cs.taint_tenth(tainted)
    worlds = {
        "slice-10k": lambda: cs.slice_args(baseline_config("10k")[0]),
        "slice-10k-taints": lambda: cs.slice_args(tainted),
        "r3-n8192": lambda: cs.kernel_args(cs.random_world(
            7, T=4000, N=8192, J=100, R=3, tight=False, static=False), dev),
        "tight-0": lambda: cs.kernel_args(cs.random_world(
            100, T=600, N=64, J=60, R=2, tight=True), dev),
        "random-0": lambda: cs.kernel_args(cs.random_world(
            0, T=400, N=300, J=40, R=3, tight=False), dev),
        "identical-nodes": lambda: cs.kernel_args(
            cs.identical_world(4000, 2048, 40), dev),
    }
    for name, make in worlds.items():
        args = make()
        theirs = other.place_cuda(*args)
        ours = place_cuda(*args)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(theirs, ours))
        times = {"other_ms": [], "this_ms": []}
        for which in ("other_ms", "this_ms", "this_ms", "other_ms"):
            fn = other.place_cuda if which == "other_ms" else place_cuda
            times[which].append(cs.time_cuda_ms(lambda fn=fn: fn(*args)))
        print("ab", json.dumps({"world": name, "equal": equal, **times}),
              flush=True)
        cs.check(equal, f"{name}: the two kernels disagree")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
