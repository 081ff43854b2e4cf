#!/usr/bin/env python3
"""Time this checkout's block auction kernels (B4) against other
checkouts', on the same CUDA tensors and the same card, in turns: other,
this, this, other, for each other checkout. Each must give the same packed
row and final node state as this one.

    git archive REV | tar -x -C chip_archive/other     # chip_archive/ is
    python3 tools/blocks_ab.py chip_archive/other       # not committed
    python3 tools/blocks_ab.py chip_archive/other --in-order .

(from the repository root, on a machine with a CUDA card and nvcc). The
other checkout's ``volcano_tpu_torch/ops`` package is imported under a name
of its own and called through its own ``blocks_cuda``, so any revision whose
``blocks_cuda`` takes ``blocks_plain``'s arguments will do; it builds its
kernels into its own ``ops/_build/``. The solves: the tpu-blocks engine's
first solve of deploy/scheduler.conf (engine line changed) at
baseline_config("20k"), with taint_tenth, and at baseline_config("100k"),
recorded on this checkout's card runs as chip_smoke.py records them, and
tests/torch_parity.py's card world fractional-20k (every chunk in the
reference's sum order). A checkout given as ``--in-order TREE`` takes
every chunk in the reference's sum order (its exactness flags forced to
0), so ``--in-order .`` times this checkout's exact mode against its
in-order mode.

Prints one JSON line per solve and other checkout with the two solves'
times (CUDA events around the whole call, warm, median of 5) and each
kernel's two times in one solve (events around each launch, summed;
median of 5), in turns, and both sides' counts; then a torch.profiler pass
over one of this checkout's 20k
solves (device time by kernel or op, the solve's wall time and the device
busy time); then the card's name and power limit, and its clocks, power
draw and temperature before and after the solves.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

KERNELS = ("blocks_prep", "blocks_topk", "blocks_round", "blocks_free",
           "blocks_free_prep")


def other_blocks_module(tree: str, name: str):
    """``ops/blocks.py`` of the checkout at ``tree``, imported as the
    package ``name`` beside this checkout's own."""
    ops = os.path.join(os.path.abspath(tree), "volcano_tpu_torch", "ops")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ops, "__init__.py"),
        submodule_search_locations=[ops])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{name}.blocks")


def parse_others(argv):
    """[(label, tree, in_order)] from ``TREE`` and ``--in-order TREE``
    arguments, or None where they do not parse."""
    out, k = [], 0
    while k < len(argv):
        in_order = argv[k] == "--in-order"
        k += in_order
        if k == len(argv) or argv[k].startswith("--"):
            return None
        label = ("in-order:" if in_order else "") + argv[k]
        out.append((label, argv[k], in_order))
        k += 1
    return out or None


def force_in_order(blocks) -> None:
    """Make ``blocks.blocks_cuda`` take every chunk in the reference's sum
    order: its ``prep_cuda`` hands back no exact chunk."""
    prep = blocks.prep_cuda

    def in_order(*args, **kw):
        classes, exact = prep(*args, **kw)
        return classes, exact.zero_()

    in_order.launches = 0
    blocks.prep_cuda = in_order


def recorded_solves(dev):
    """(label, (args, kw)) for the solves of the module docstring, on the
    card."""
    import chip_smoke as cs
    from torch_parity import CARD_BLOCK_WORLDS, blocks_args
    out = []
    for name in ("20k", "20k-taints", "100k"):
        _, seen = cs.record_blocks_solves(lambda: cs.run_deployed(
            name, None, cs.engine_conf("tpu-blocks")))
        out.append((f"solve-{name}", seen[0]))
    out.append(("fractional-20k",
                blocks_args(CARD_BLOCK_WORLDS["fractional-20k"](), dev)))
    return out


def kernel_ms(solve, args, kw):
    """Each kernel's device ms in one solve, median of 5 solves."""
    runs = []
    for _ in range(5):
        timing = {}
        solve(*args, timing=timing, **kw)
        runs.append(timing)
    return {k: statistics.median(r.get(k, 0.0) * 1e3 for r in runs)
            for k in KERNELS}


def profile_solve(args, kw) -> dict:
    """torch.profiler over one warm blocks_cuda call: device µs and count
    by kernel or op name, the device's busy µs (the sum) and the call's
    host wall µs."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from volcano_tpu_torch.ops.blocks import blocks_cuda
    blocks_cuda(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        blocks_cuda(*args, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0.0)
        if dev_us and e.key and not e.key.startswith("aten::"):
            by_name[e.key] = {"device_us": dev_us, "count": e.count}
    busy = sum(v["device_us"] for v in by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1]["device_us"])
               [:12])
    return {"wall_us": wall, "device_busy_us": busy,
            "idle_share": 1.0 - busy / wall if wall else None, "top": top}


def main() -> int:
    import torch
    others = parse_others(sys.argv[1:])
    if others is None or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    import chip_smoke as cs
    from volcano_tpu_torch.ops.blocks import blocks_cuda
    modules = []
    for k, (label, tree, in_order) in enumerate(others):
        module = other_blocks_module(tree, f"blocks_ab_other{k}")
        if in_order:
            force_in_order(module)
        modules.append((label, module))
    dev = torch.device("cuda")
    print("clocks before", cs.clocks_line(), flush=True)
    for label, (args, kw) in recorded_solves(dev):
        for other_label, other in modules:
            stats, other_stats = {}, {}
            ours = blocks_cuda(*args, stats=stats, **kw)
            theirs = other.blocks_cuda(*args, stats=other_stats, **kw)
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(ours, theirs))
            times = {"other_ms": [], "this_ms": []}
            kernels = {k: {"other_ms": [], "this_ms": []} for k in KERNELS}
            for which in ("other_ms", "this_ms", "this_ms", "other_ms"):
                fn = other.blocks_cuda if which == "other_ms" else blocks_cuda
                times[which].append(cs.time_cuda_ms(
                    lambda fn=fn: fn(*args, **kw)))
                for k, v in kernel_ms(fn, args, kw).items():
                    kernels[k][which].append(v)
            print("ab", json.dumps({"solve": label, "other": other_label,
                                    "equal": equal, "counts": stats,
                                    "other_counts": other_stats, **times,
                                    "kernels": kernels}), flush=True)
            cs.check(equal, f"{label}: {other_label} disagrees")
            del ours, theirs
        if label == "solve-20k":
            print("profile", json.dumps({"solve": label,
                                         **profile_solve(args, kw)}),
                  flush=True)
        del args
    print("clocks after", cs.clocks_line(), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
