"""Validators for the flight recorder's artifacts.

Usage::

    python -m volcano_tpu_torch.obs.validate trace.json        # schema-check
                                                               # a --trace-out
                                                               # file
    python -m volcano_tpu_torch.obs.validate --flows t.json    # + the
                                                               # flow-arc and
                                                               # lane contract
    python -m volcano_tpu_torch.obs.validate --metrics-scrape  # serve and
                                                               # scrape
                                                               # /metrics

The trace check enforces the Chrome trace-event contract (required
fields, monotonic ts, matched/nested B/E pairs) via
``export.validate_chrome_trace``. ``--metrics-scrape`` seeds the metrics
mirror, starts ``metrics.start_metrics_server`` on a free port, scrapes
``/metrics`` and holds the body to the text exposition's line grammar
(every line a comment, blank or a well-formed sample) and to the seeded
series.
"""

from __future__ import annotations

import json
import re
import sys
import urllib.error
import urllib.request
from typing import Tuple


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


def fetch(server, path: str = "/metrics",
          timeout: float = 5.0) -> Tuple[int, bytes]:
    """(status, body) of a GET of ``path`` from a metrics server started
    on this host; an error status is returned, not raised."""
    port = server.server_address[1]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def scrape(server, path: str = "/metrics") -> str:
    """The body of a GET of ``path``, which must answer 200."""
    status, body = fetch(server, path)
    if status != 200:
        raise RuntimeError(f"GET {path}: HTTP {status}")
    return body.decode()


# one sample line of the text exposition: name{labels} value [timestamp]
_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? [0-9eE+.\-]+(?: [0-9.]+)?$')


def parse_sample_count(body: str) -> int:
    """The strict line-grammar check of an exposition body: every
    non-comment, non-blank line must be a well-formed sample. Returns the
    sample count; raises ValueError on a malformed line."""
    n = 0
    for line in body.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        if not _SAMPLE_RE.match(line):
            raise ValueError(f"malformed exposition line: {line!r}")
        n += 1
    return n


def check_metrics_scrape() -> int:
    from .. import metrics

    # seed the mirror so the exposition has labelled series to emit
    metrics.set_health(metrics.HEALTHY, 0)
    metrics.register_action_failure("ci-probe")
    metrics.update_queue_metrics("ci-q", 1000.0, share=0.5)
    metrics.update_action_duration("ci-probe", 0.001)
    server = metrics.start_metrics_server(0, "127.0.0.1")
    try:
        body = scrape(server)
    finally:
        server.shutdown()
        server.server_close()
    try:
        n_samples = parse_sample_count(body)
    except ValueError as exc:
        print(f"/metrics failed to parse: {exc}", file=sys.stderr)
        return 1
    if not n_samples:
        print("/metrics parsed to zero samples", file=sys.stderr)
        return 1
    # the exact series the probe seeded: a broken mapping that drops
    # labelled families would still parse to some samples
    for needle in ('volcano_action_failures_total{action="ci-probe"}',
                   'volcano_queue_allocated_milli_cpu{queue_name="ci-q"}',
                   "volcano_action_scheduling_latency_microseconds_count"):
        if needle not in body:
            print(f"seeded series missing from /metrics: {needle}",
                  file=sys.stderr)
            return 1
    print(f"/metrics OK — {n_samples} samples")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--metrics-scrape":
        return check_metrics_scrape()
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
