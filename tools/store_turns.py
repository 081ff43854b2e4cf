#!/usr/bin/env python3
"""Time baseline-10k under deploy/scheduler.conf with the cache fed
directly and fed by the object store's informers (``--store-wired``), in
turns on one card: direct, wired, wired, direct.

    python3 tools/store_turns.py

(from the repository root, on a machine with a CUDA card and nvcc). Each
run goes through the sim's entry point in this process, as chip_smoke.py's
store phase runs it, with 10,000 pods on 2,000 nodes over 31 cycles.
Prints one JSON line per run: its mode, pipeline_e2e_ms and schedule_ms
(p50, p95, p99, max and mean over the 31 cycles, so p99 is the single
largest cycle, cycle 0's 10,000 binds), its wall seconds, binds and the
sha256 of its decision plane; then the card's name and power limit. Fails
if a run binds other than 10,000 pods, counts an action failure or a
double bind, or if two runs of one mode differ in their decision plane.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TURNS = ("direct", "wired", "wired", "direct")
ARGS = ("--conf", "deploy/scheduler.conf")


def main() -> int:
    import torch
    if len(sys.argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    os.chdir(ROOT)
    import chip_smoke as cs
    from volcano_tpu_torch.ops import build
    build.build_all()
    planes = {}
    for mode in TURNS:
        args = ARGS + (("--store-wired",) if mode == "wired" else ())
        report, text, _, launches, wall_s = cs.run_sim("baseline-10k", args)
        sha = hashlib.sha256(text).hexdigest()
        cs.check(report["binds"] == 10000 and report["action_failures"] == 0
                 and report["double_binds"] == 0,
                 f"{mode}: {report['binds']} binds, "
                 f"{report['action_failures']} action failures, "
                 f"{report['double_binds']} double binds")
        cs.check(planes.setdefault(mode, sha) == sha,
                 f"{mode}: the decision plane differs between two runs")
        wall = report["wallclock"]
        print(json.dumps({"mode": mode, "cycles": report["cycles"],
                          "binds": report["binds"],
                          "pipeline_e2e_ms": wall["pipeline_e2e_ms"],
                          "schedule_ms": wall["schedule_ms"],
                          "wall_s": wall_s, "B1": launches["place"],
                          "decision_plane_sha256": sha}), flush=True)
    print("card:", cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
