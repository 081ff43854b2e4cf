"""SLO engine: declarative objectives over the lifecycle timeline store
with multi-window burn-rate math.

An ``SLO`` names a latency metric the timelines attribute per job
(``ttfb`` / ``admission_wait`` / ``ack_latency`` / ``jct``), a threshold,
a compliance target and a set of look-back windows. The engine scans the
timeline store, classifies every attributed job as within/over threshold,
and reports

- **compliance**: good / total over every retained sample,
- **burn rate** per window: (error rate inside the window) divided by
  the error budget ``1 - target`` — the standard multi-window burn-rate
  alerting quantity (burn 1.0 = exactly spending the budget; >> 1 = the
  budget disappears in a fraction of the period).

Everything is computed from logical/virtual timestamps already in the
store, so a deterministic sim evaluates to byte-identical results.
Published as the in-process ``slo_compliance{slo}`` /
``slo_burn_rate{slo,window}`` gauges, the ``slo`` section of
``metrics.health_detail()``, and the sim report's ``slo`` section
(flag-gated: fault-free decision planes stay byte-identical).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .lifecycle import TIMELINE, TimelineStore, job_latency

# metric name -> (timeline latency key, timeline event whose t anchors
# the sample in a burn window)
_METRICS = {
    "ttfb": ("ttfb_s", "bind"),
    "admission_wait": ("admission_wait_s", "admitted"),
    "ack_latency": ("ack_latency_s", "running"),
    "jct": ("jct_s", "complete"),
}


class SLO:
    """One declarative objective. ``queue=None`` aggregates every class;
    ``queue="*"`` expands to one reported objective per observed class
    (the "JCT by queue class" shape)."""

    __slots__ = ("name", "metric", "queue", "threshold_s", "target",
                 "windows")

    def __init__(self, name: str, metric: str, threshold_s: float,
                 target: float = 0.99,
                 windows: Tuple[float, ...] = (60.0, 300.0),
                 queue: Optional[str] = None):
        if metric not in _METRICS:
            raise ValueError(f"unknown SLO metric {metric!r} "
                             f"(know {sorted(_METRICS)})")
        self.name = name
        self.metric = metric
        self.queue = queue
        self.threshold_s = float(threshold_s)
        self.target = float(target)
        self.windows = tuple(float(w) for w in windows)


def default_slos(period: float = 1.0) -> List[SLO]:
    """The stock objective set, scaled to the scheduling period (the
    sim passes its virtual period; a live process its configured one)."""
    return [
        SLO("ttfb_p99", "ttfb", threshold_s=10.0 * period, target=0.99,
            windows=(32.0 * period, 128.0 * period)),
        SLO("admission_p95", "admission_wait", threshold_s=16.0 * period,
            target=0.95, windows=(32.0 * period, 128.0 * period)),
        SLO("jct_by_class", "jct", threshold_s=120.0 * period, target=0.95,
            windows=(64.0 * period, 256.0 * period), queue="*"),
    ]


class SLOEngine:
    def __init__(self, objectives: Optional[List[SLO]] = None,
                 period: float = 1.0):
        self.objectives = list(objectives) if objectives is not None \
            else default_slos(period)

    # -- sample harvest ------------------------------------------------------

    @staticmethod
    def _samples(store: TimelineStore, metric: str
                 ) -> Dict[str, List[Tuple[float, float]]]:
        """Per queue class: (anchor t, value) samples for ``metric``
        across every job the store retains."""
        key, anchor_ev = _METRICS[metric]
        out: Dict[str, List[Tuple[float, float]]] = {}
        for job in store.jobs():
            events = store.events(job)
            lat = job_latency(events)
            if key not in lat:
                continue
            anchor = next((ev for ev in events if ev["ev"] == anchor_ev),
                          None)
            arrival = next((ev for ev in events if ev["ev"] == "arrival"),
                           None)
            if anchor is None or arrival is None:
                continue
            cls = arrival.get("queue", "")
            out.setdefault(cls, []).append((anchor["t"], lat[key]))
        return out

    def _evaluate_one(self, slo: SLO, name: str,
                      samples: List[Tuple[float, float]],
                      now: float) -> dict:
        total = len(samples)
        good = sum(1 for _, v in samples if v <= slo.threshold_s + 1e-9)
        compliance = round(good / total, 6) if total else 1.0
        budget = max(1.0 - slo.target, 1e-9)
        burns: Dict[str, float] = {}
        for w in slo.windows:
            inside = [(t, v) for t, v in samples if t >= now - w - 1e-9]
            if not inside:
                burns[f"{w:g}"] = 0.0
                continue
            bad = sum(1 for _, v in inside if v > slo.threshold_s + 1e-9)
            burns[f"{w:g}"] = round((bad / len(inside)) / budget, 6)
        return {"slo": name, "metric": slo.metric,
                "threshold_s": round(slo.threshold_s, 6),
                "target": slo.target, "samples": total,
                "compliance": compliance,
                "ok": compliance + 1e-9 >= slo.target,
                "burn_rate": burns}

    def evaluate(self, store: Optional[TimelineStore] = None,
                 now: float = 0.0) -> List[dict]:
        """Deterministic objective evaluation at virtual/logical time
        ``now``, sorted by reported objective name."""
        store = TIMELINE if store is None else store
        out: List[dict] = []
        for slo in self.objectives:
            per_class = self._samples(store, slo.metric)
            if slo.queue == "*":
                for cls in sorted(per_class):
                    out.append(self._evaluate_one(
                        slo, f"{slo.name}/{cls}", per_class[cls], now))
                continue
            if slo.queue is None:
                samples = [s for v in per_class.values() for s in v]
            else:
                samples = per_class.get(slo.queue, [])
            out.append(self._evaluate_one(slo, slo.name, samples, now))
        out.sort(key=lambda d: d["slo"])
        return out

    def publish(self, store: Optional[TimelineStore] = None,
                now: float = 0.0) -> List[dict]:
        """Evaluate and push the result to metrics: the compliance /
        burn-rate gauges plus the ``slo`` section of the health detail."""
        from .. import metrics
        status = self.evaluate(store, now)
        metrics.set_slo_status(status)
        return status


# The process-wide engine; reconfigure by replacing .objectives (tests) or constructing your own.
ENGINE = SLOEngine()
