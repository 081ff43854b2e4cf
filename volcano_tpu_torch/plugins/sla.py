"""SLA plugin: a job past its waiting-time SLA sorts by its deadline and is
permitted to enqueue and to pipeline.

Mirrors pkg/scheduler/plugins/sla/sla.go:60-150.
"""

from __future__ import annotations

import re
from typing import Optional

from ..framework.session import ABSTAIN, PERMIT
from .base import Plugin

JOB_WAITING_TIME = "sla-waiting-time"

# the units longest first: "1500ms" is 1.5 s, as Go's time.ParseDuration
# reads it (the JAX package's alternation tries "m" first and reads 1,500
# minutes)
_DUR_RE = re.compile(r"(\d+(?:\.\d+)?)(ms|us|µs|ns|h|m|s)")
_UNITS = {"h": 3600.0, "m": 60.0, "s": 1.0, "ms": 1e-3, "us": 1e-6,
          "µs": 1e-6, "ns": 1e-9}


def parse_duration(text: str) -> Optional[float]:
    """A Go duration ('1h2m3s') in seconds, or None."""
    if not text:
        return None
    total, matched = 0.0, False
    for num, unit in _DUR_RE.findall(str(text)):
        total += float(num) * _UNITS[unit]
        matched = True
    return total if matched else None


class SLAPlugin(Plugin):
    NAME = "sla"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.job_waiting_time: Optional[float] = None
        jwt = parse_duration(self.arguments.get(JOB_WAITING_TIME, ""))
        if jwt and jwt > 0:
            self.job_waiting_time = jwt

    def _jwt(self, job) -> Optional[float]:
        """The job's waiting time: its own, then its podgroup's annotation,
        then the plugin's argument (sla.go:50-65)."""
        if job.waiting_time is not None:
            return job.waiting_time
        ann = (job.podgroup.annotations.get(JOB_WAITING_TIME)
               if job.podgroup else None)
        if ann:
            return parse_duration(ann)
        return self.job_waiting_time

    def on_session_open(self, ssn) -> None:
        def job_order(l, r) -> int:
            ljwt, rjwt = self._jwt(l), self._jwt(r)
            if ljwt is None:
                return 0 if rjwt is None else 1
            if rjwt is None:
                return -1
            ldeadline = l.creation_timestamp + ljwt
            rdeadline = r.creation_timestamp + rjwt
            if ldeadline < rdeadline:
                return -1
            if ldeadline > rdeadline:
                return 1
            return 0

        ssn.add_job_order_fn(self.NAME, job_order)

        def permitable(job) -> int:
            jwt = self._jwt(job)
            if jwt is None:
                return ABSTAIN
            # the session clock, in the timebase of the jobs' creation
            # timestamps
            if ssn.now() - job.creation_timestamp < jwt:
                return ABSTAIN
            return PERMIT

        ssn.add_job_enqueueable_fn(self.NAME, permitable)
        ssn.add_job_pipelined_fn(self.NAME, permitable)


def New(arguments):
    return SLAPlugin(arguments)
