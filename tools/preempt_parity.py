#!/usr/bin/env python3
"""Hold the port's preempt engine against the JAX package's at full size,
on the CPU.

    JAX_PLATFORMS=cpu python tools/preempt_parity.py

Builds ``baseline_config("preempt")`` (5,000 running and 5,000 pending pods
on 1,000 nodes) and its intra-job variant in the JAX package, runs
``PreemptAction(engine="tpu")`` alone under deploy/scheduler.conf's tiers
there (in a child process without FMA contraction, as the tests do), carries
each world into the port and runs the same action on the CPU. Prints, per
world, whether the evictions and pipelined tasks are equal, and their
counts; exits non-zero on a difference. Too slow for the test suite (about
30 s), so it is a tool.
"""

from __future__ import annotations

import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import torch_parity as tp  # noqa: E402

WORLDS = {
    "preempt": (lambda: tp._baseline("preempt"), "preempt"),
    "preempt-intra": (lambda: tp.intra_variant(tp._baseline("preempt")),
                      "preempt"),
}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--jax":
        # the child: the JAX package's results
        tp.EVICT_WORLDS.update(WORLDS)
        tp._main("evict", sys.argv[2], list(WORLDS))
        return 0
    from volcano_tpu_torch.cache import cache_from_world
    with tempfile.TemporaryDirectory() as tmp:
        ref = tp.jax_reference_script(
            [os.path.abspath(__file__), "--jax"],
            os.path.join(tmp, "preempt.pkl"))
    ok = True
    for name, (world, want) in ref.items():
        cache = cache_from_world(world)
        got = tp.evict_outcome(tp.run_torch_action(cache, "preempt"), cache)
        same = got == want
        ok &= same
        print(f"{name}: equal={same} evictions={len(got['evicts'])}/"
              f"{len(want['evicts'])} pipelined={len(got['pipelined'])}/"
              f"{len(want['pipelined'])}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
