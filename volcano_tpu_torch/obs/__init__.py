"""Cycle flight recorder: span tracing (``trace``). The scheduler shell
brackets every ``run_once`` with spans, and the per-action and end-to-end
metrics are fed from those spans."""

from .trace import TRACE, TraceRecorder, span

__all__ = ["TRACE", "TraceRecorder", "span"]
