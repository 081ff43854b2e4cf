"""Validators for the flight recorder's artifacts.

Usage::

    python -m volcano_tpu_torch.obs.validate trace.json        # schema-check
                                                               # a --trace-out
                                                               # file
    python -m volcano_tpu_torch.obs.validate --flows t.json    # + the
                                                               # flow-arc and
                                                               # lane contract

The trace check enforces the Chrome trace-event contract (required
fields, monotonic ts, matched/nested B/E pairs) via
``export.validate_chrome_trace``. The JAX package's ``--metrics-scrape``
serves and scrapes a Prometheus ``/metrics`` endpoint; this package has
no metrics server, so that mode is refused by name (exit 2).
"""

from __future__ import annotations

import json
import sys

# modes of the JAX package's validator this package refuses by name
REFUSED_MODES = ("--metrics-scrape",)


def check_trace(path: str, flows: bool = False) -> int:
    from .export import flow_summary, validate_chrome_trace
    with open(path) as f:
        obj = json.load(f)
    spans = validate_chrome_trace(obj)
    if spans == 0:
        print(f"{path}: no complete spans recorded", file=sys.stderr)
        return 1
    names = {ev["name"] for ev in obj["traceEvents"]}
    missing = {"cycle", "schedule", "open_session"} - names
    if missing:
        print(f"{path}: expected span names missing: {sorted(missing)}",
              file=sys.stderr)
        return 1
    if flows:
        # the merged-trace contract: the causal arcs exist (flow starts
        # AND finishes — an intent with no completion arc means the
        # flow_end wiring regressed), and the schedulers landed in
        # DISTINCT process lanes
        fs = flow_summary(obj["traceEvents"])
        problems = []
        if not fs["started"]:
            problems.append("no flow arcs started (s-phase events)")
        if not fs["finished"]:
            problems.append("no flow arcs finished (f-phase events)")
        if len(fs["lanes"]) < 2:
            problems.append(f"expected >=2 partition lanes, saw pids "
                            f"{sorted(fs['lanes'])}")
        if problems:
            for p in problems:
                print(f"{path}: {p}", file=sys.stderr)
            return 1
        print(f"{path}: flows OK — {fs['started']} started, "
              f"{fs['steps']} steps, {fs['finished']} finished, "
              f"lanes {sorted(fs['lanes'])}")
    print(f"{path}: OK — {spans} spans, {len(names)} distinct names, "
          f"{len(obj['traceEvents'])} events")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    refused = [a for a in argv if a in REFUSED_MODES]
    if refused:
        print(f"{refused[0]} is not in volcano_tpu_torch: it needs the "
              f"metrics HTTP server, which this package does not have",
              file=sys.stderr)
        return 2
    flows = False
    if argv and argv[0] == "--flows":
        flows = True
        argv = argv[1:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for path in argv:
        rc = max(rc, check_trace(path, flows=flows))
    return rc


if __name__ == "__main__":
    sys.exit(main())
