"""Span tracing: the timing layer of the cycle flight recorder.

``span(name, **attrs)`` is a context manager producing one hierarchical
span per enter/exit pair. Hierarchy is implicit: spans emit Chrome
trace-event ``B``/``E`` pairs, and nesting within a thread IS the tree —
no parent pointers are maintained on the hot path. The scheduler shell
brackets every ``run_once`` with ``begin_cycle``/``end_cycle``, so the
recorder keeps a bounded ring of the last N *completed* cycles (the
flight-recorder contract: always the recent past, never unbounded).

Overhead contract:

- **disabled** (the default): ``span()`` still returns a live ``Span`` —
  two ``perf_counter`` calls and one slotted object per span, nothing
  else. That keeps ``Span.dur_s`` always valid, which is how spans FEED
  the existing metrics histograms (scheduler/framework read ``sp.dur_s``
  instead of timing the same window twice) while event recording costs
  nothing. Per cycle the scheduler opens ~10 spans; two clock reads each
  is noise against a multi-ms cycle.
- **enabled**: each span appends two small dicts under one lock.

The pipelined cycle adds the spans ``conflict_check`` (the commit
boundary), ``speculate`` (the next cycle's dispatch, with its engine),
``speculate_commit`` (with the verdict) and ``fast_admit``; the speculative
session's ``snapshot_clone``, ``order`` and ``solve`` spans carry
``speculative=True``.

Determinism: event timestamps come from the recorder's ``time_fn``
(wall ``perf_counter`` by default). In ``logical=True`` mode the clock is
a per-recorder event counter instead, so the same span sequence produces
a byte-identical event list. ``Span.dur_s`` stays wall time in every mode
(metrics keep measuring the host); only the event timeline switches.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, Optional

DEFAULT_MAX_CYCLES = 64


def _env_enabled() -> bool:
    return os.environ.get("VOLCANO_TPU_TRACE", "") not in ("", "0", "false")


class Span:
    """One timed window. Always times (``dur_s`` after exit); records
    trace events only while the owning recorder is enabled."""

    __slots__ = ("_rec", "name", "attrs", "_t0", "dur_s")

    def __init__(self, rec: "TraceRecorder", name: str, attrs: dict):
        self._rec = rec
        self.name = name
        self.attrs = attrs
        self.dur_s = 0.0

    def __enter__(self) -> "Span":
        rec = self._rec
        if rec._recording:
            rec._emit("B", self.name, self.attrs)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.dur_s = time.perf_counter() - self._t0
        rec = self._rec
        if rec._recording:
            rec._emit("E", self.name, None)
        return False


class TraceRecorder:
    def __init__(self, max_cycles: int = DEFAULT_MAX_CYCLES,
                 logical: bool = False, time_fn=None):
        self._lock = threading.Lock()
        self._recording = _env_enabled()
        self._logical = logical
        self._time_fn = time_fn
        self._seq = 0
        self._last_ts = 0.0
        self._tids: Dict[int, int] = {}
        self._cycles: collections.deque = collections.deque(
            maxlen=max_cycles or None)
        self._current: Optional[List[dict]] = None
        # process lane: the pid stamped on every event. Standalone stays
        # 1 (the historical shape); a federated sim sets the partition id
        # at each cycle boundary so a merged trace renders one process
        # lane per partition (docs/observability.md).
        self._pid = 1
        # flow-event state (s/t/f phases connecting events across lanes):
        # insertion-ordered key -> id map keeps flow ids deterministic,
        # the open set guarantees s/t/f validity by construction
        self._flow_ids: Dict[str, int] = {}
        self._flow_open: set = set()

    # -- lifecycle ----------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._recording

    def enable(self) -> None:
        with self._lock:
            self._recording = True

    def disable(self) -> None:
        with self._lock:
            self._recording = False

    def configure(self, max_cycles: Optional[int] = None,
                  logical: Optional[bool] = None, time_fn=None) -> None:
        """Re-shape the recorder (ring size 0 = unbounded, logical clock
        for deterministic artifacts). Clears recorded cycles — a trace
        must not mix clock domains."""
        with self._lock:
            if max_cycles is not None:
                self._cycles = collections.deque(maxlen=max_cycles or None)
            if logical is not None:
                self._logical = logical
            if time_fn is not None:
                self._time_fn = time_fn
            self._clear_locked()

    def clear(self) -> None:
        with self._lock:
            self._clear_locked()

    def _clear_locked(self) -> None:
        self._cycles.clear()
        self._current = None
        self._seq = 0
        self._last_ts = 0.0
        self._pid = 1
        self._flow_ids.clear()
        self._flow_open.clear()

    # -- hot path -----------------------------------------------------------

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def _now_us_locked(self) -> float:
        if self._logical:
            self._seq += 1
            return float(self._seq)
        fn = self._time_fn or time.perf_counter
        ts = fn() * 1e6
        # monotonic by construction (perf_counter) or by clamping (a
        # virtual/exotic time_fn may repeat values; Chrome trace viewers
        # require non-decreasing ts)
        if ts <= self._last_ts:
            ts = self._last_ts + 1e-3
        self._last_ts = ts
        return ts

    def _emit(self, ph: str, name: str, attrs: Optional[dict]) -> None:
        with self._lock:
            self._emit_locked(ph, name, attrs)

    def _emit_locked(self, ph: str, name: str, attrs: Optional[dict],
                     cat: str = "scheduler",
                     extra: Optional[dict] = None) -> None:
        ident = threading.get_ident()
        tid = self._tids.setdefault(ident, len(self._tids) + 1)
        ev = {"ph": ph, "name": name, "cat": cat,
              "pid": self._pid, "tid": tid, "ts": self._now_us_locked()}
        if extra:
            ev.update(extra)
        if attrs:
            ev["args"] = attrs
        if self._current is None:            # ambient span outside a cycle
            self._current = []
        self._current.append(ev)

    # -- flow events (cross-lane causality) ---------------------------------

    def flow_step(self, name: str, key: str, **attrs) -> None:
        """One hop of a cross-lane causal arc (bind intent → ack → move →
        re-bind): emits a flow-start ``s`` the first time ``key`` is
        seen (or after an end), a flow-step ``t`` afterwards. Flow ids
        are minted from an insertion-ordered map, so a deterministic
        event sequence produces a byte-identical artifact."""
        with self._lock:
            if not self._recording:
                return
            fid = self._flow_ids.setdefault(key, len(self._flow_ids) + 1)
            ph = "t" if key in self._flow_open else "s"
            self._flow_open.add(key)
            self._emit_locked(ph, name, attrs or None, cat="flow",
                              extra={"id": fid})

    def flow_end(self, name: str, key: str, **attrs) -> None:
        """Close ``key``'s causal arc with a flow-finish ``f``. A no-op
        unless the arc is open, so emission is valid by construction
        (every ``f`` has its ``s``; never two ``f``)."""
        with self._lock:
            if not self._recording or key not in self._flow_open:
                return
            fid = self._flow_ids[key]
            self._flow_open.discard(key)
            self._emit_locked("f", name, attrs or None, cat="flow",
                              extra={"id": fid, "bp": "e"})

    # -- cycle ring ---------------------------------------------------------

    def begin_cycle(self, cycle: int) -> None:
        with self._lock:
            self._push_current_locked()
            self._current = []

    def end_cycle(self) -> None:
        with self._lock:
            self._push_current_locked()

    def _push_current_locked(self) -> None:
        if self._current:
            self._cycles.append(self._current)
        self._current = None

    # -- export -------------------------------------------------------------

    def chrome_events(self) -> List[dict]:
        """Flat event list of every COMPLETED cycle in the ring (the
        in-flight cycle is excluded so every exported ``B`` has its
        ``E``)."""
        with self._lock:
            return [dict(ev) for bucket in self._cycles for ev in bucket]

    def cycles_recorded(self) -> int:
        with self._lock:
            return len(self._cycles)


# The process-wide recorder every wiring point uses. VOLCANO_TPU_TRACE=1
# enables it at import; runtime callers call TRACE.enable()/disable().
TRACE = TraceRecorder()


def span(name: str, **attrs) -> Span:
    return TRACE.span(name, **attrs)
