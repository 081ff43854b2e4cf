"""Chrome trace-event export + validation for the flight recorder.

``chrome_trace(events)`` wraps a recorder's flat ``B``/``E`` event list
into the Chrome trace-event JSON object format — loadable directly in
Perfetto (ui.perfetto.dev) or chrome://tracing. ``validate_chrome_trace``
is the schema check for every ``--trace-out`` artifact: required fields,
non-decreasing timestamps, and properly nested, fully matched ``B``/``E``
pairs per thread.

The artifact's ``producer`` names the trace format, which this package
shares with the JAX package, so a run of either writes the same bytes
for the same span sequence.
"""

from __future__ import annotations

from typing import Dict, List, Optional

_REQUIRED = ("ph", "name", "pid", "tid", "ts")


def chrome_trace(events: List[dict], enabled: bool = True,
                 logical: bool = False) -> dict:
    """The JSON object format: {"traceEvents": [...], ...metadata}."""
    return {
        "traceEvents": list(events),
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "volcano_tpu.obs",
            "enabled": bool(enabled),
            "clock": "logical" if logical else "perf_counter_us",
        },
    }


def validate_chrome_trace(obj: dict) -> int:
    """Raise ValueError on the first schema violation; return the number
    of complete spans otherwise. Checks: traceEvents is a list, every
    event carries the required fields with sane types, ``ts`` is
    non-decreasing in emission order, per (pid, tid) the ``B``/``E``
    events nest and match exactly (every B closed by an E of the same
    name, no stray E), and flow events (``s``/``t``/``f``) carry an
    ``id`` and sequence legally per id (``s`` opens, ``t`` continues an
    open arc, ``f`` closes it)."""
    if not isinstance(obj, dict) or not isinstance(
            obj.get("traceEvents"), list):
        raise ValueError("not a Chrome trace object: no traceEvents list")
    events = obj["traceEvents"]
    last_ts = None
    stacks: Dict[tuple, List[dict]] = {}
    flows_open: set = set()
    spans = 0
    for i, ev in enumerate(events):
        for field in _REQUIRED:
            if field not in ev:
                raise ValueError(f"event {i} missing field {field!r}: {ev}")
        if ev["ph"] not in ("B", "E", "s", "t", "f"):
            raise ValueError(f"event {i} has unsupported ph {ev['ph']!r}")
        if not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"event {i} ts is not numeric: {ev['ts']!r}")
        if not isinstance(ev["name"], str) or not ev["name"]:
            raise ValueError(f"event {i} has no usable name: {ev}")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"event {i} args is not an object")
        if last_ts is not None and ev["ts"] < last_ts:
            raise ValueError(
                f"event {i} ts went backwards: {ev['ts']} < {last_ts}")
        last_ts = ev["ts"]
        key = (ev["pid"], ev["tid"])
        if ev["ph"] in ("s", "t", "f"):
            if "id" not in ev:
                raise ValueError(f"event {i}: flow {ev['ph']!r} without id")
            fid = (ev.get("cat"), ev["id"])
            if ev["ph"] == "s":
                if fid in flows_open:
                    raise ValueError(
                        f"event {i}: flow s re-opens open id {fid}")
                flows_open.add(fid)
            elif fid not in flows_open:
                raise ValueError(
                    f"event {i}: flow {ev['ph']!r} on id {fid} with no "
                    f"open s")
            elif ev["ph"] == "f":
                flows_open.discard(fid)
            continue
        stack = stacks.setdefault(key, [])
        if ev["ph"] == "B":
            stack.append(ev)
        else:
            if not stack:
                raise ValueError(
                    f"event {i}: E {ev['name']!r} with no open B on "
                    f"pid/tid {key}")
            top = stack.pop()
            if top["name"] != ev["name"]:
                raise ValueError(
                    f"event {i}: E {ev['name']!r} closes B "
                    f"{top['name']!r} (improper nesting) on pid/tid {key}")
            spans += 1
    for key, stack in stacks.items():
        if stack:
            raise ValueError(
                f"unclosed B events on pid/tid {key}: "
                f"{[ev['name'] for ev in stack]}")
    # an arc still open at dump time is legal (the job was mid-journey
    # when the ring was cut); only ILLEGAL sequencing raises above
    return spans


def flow_summary(events: List[dict]) -> Dict[str, object]:
    """Flow-event accounting: how many arcs started, how many fully
    matched (closed by ``f``), and which lanes (pids) the flows touched —
    what ``validate --flows`` asserts on."""
    started = finished = steps = 0
    pids: set = set()
    for ev in events:
        ph = ev.get("ph")
        if ph not in ("s", "t", "f"):
            continue
        pids.add(ev.get("pid"))
        if ph == "s":
            started += 1
        elif ph == "t":
            steps += 1
        else:
            finished += 1
    return {"started": started, "steps": steps, "finished": finished,
            "lanes": sorted(pids)}


def span_totals_ms(events: List[dict],
                   names: Optional[List[str]] = None) -> Dict[str, float]:
    """Total wall-clock per span name (summed across all matched B/E
    pairs), in ms — a per-stage breakdown of a wall-clock trace. A
    single-lane trace keys by bare span name (the
    historical shape); a merged multi-partition artifact splits per lane
    (``p<pid>/<name>``) instead of silently summing partitions together.
    Meaningless for logical-clock traces (durations are event counts
    there)."""
    stacks: Dict[tuple, List[dict]] = {}
    totals: Dict[tuple, float] = {}
    pids: set = set()
    for ev in events:
        if ev.get("ph") not in ("B", "E"):
            continue
        pid = ev.get("pid")
        pids.add(pid)
        key = (pid, ev.get("tid"))
        stack = stacks.setdefault(key, [])
        if ev["ph"] == "B":
            stack.append(ev)
        elif stack:
            top = stack.pop()
            if top.get("name") == ev.get("name"):
                name = top["name"]
                if names is None or name in names:
                    totals[(pid, name)] = totals.get((pid, name), 0.0) \
                        + (ev["ts"] - top["ts"]) / 1e3
    split = len(pids) > 1
    out: Dict[str, float] = {}
    for (pid, name), v in totals.items():
        label = f"p{pid}/{name}" if split else name
        out[label] = out.get(label, 0.0) + v
    return {k: round(v, 3) for k, v in sorted(out.items())}
