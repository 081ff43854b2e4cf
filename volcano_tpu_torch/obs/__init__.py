"""Cycle flight recorder.

- ``trace``  — hierarchical span tracing per scheduling cycle
  (``span(name, **attrs)``) through the scheduler shell, session open and
  close, every action and the solver stages; the per-action and
  end-to-end metrics are fed from the spans, so timing is recorded once.
- ``audit``  — per-cycle records of every admission, denial and
  eviction in a bounded ring of the last N cycles, with ``why(job)``.
- ``export`` — Chrome trace-event JSON (Perfetto-loadable), written by
  the sim's ``--trace-out`` and checked by ``python -m
  volcano_tpu_torch.obs.validate``.
- ``lifecycle`` — per-job timelines stitched from correlation contexts
  carried in the durable records (journal intents, feedback verdicts,
  elastic control records).
- ``slo``    — declarative objectives with multi-window burn rates over
  the timeline store.
"""

from .audit import AUDIT, AuditLog
from .export import (chrome_trace, flow_summary, span_totals_ms,
                     validate_chrome_trace)
from .lifecycle import TIMELINE, TimelineStore
from .slo import ENGINE as SLO_ENGINE
from .slo import SLO, SLOEngine, default_slos
from .trace import TRACE, TraceRecorder, span

__all__ = [
    "AUDIT", "AuditLog",
    "TRACE", "TraceRecorder", "span",
    "TIMELINE", "TimelineStore",
    "SLO", "SLOEngine", "SLO_ENGINE", "default_slos",
    "chrome_trace", "flow_summary", "span_totals_ms",
    "validate_chrome_trace",
]
