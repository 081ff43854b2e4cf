"""Overcommit plugin: enqueue admits jobs while their minimum resources fit
the cluster's idle resources times an overcommit factor.

Mirrors pkg/scheduler/plugins/overcommit/overcommit.go:50-125.
"""

from __future__ import annotations

from ..api import PodGroupPhase, Resource
from ..framework.session import PERMIT, REJECT
from .base import Plugin

DEFAULT_OVERCOMMIT_FACTOR = 1.2


class OvercommitPlugin(Plugin):
    NAME = "overcommit"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.factor = self.arguments.get_float("overcommit-factor",
                                               DEFAULT_OVERCOMMIT_FACTOR)
        # a factor below 1.0 would admit less than the cluster holds
        if self.factor < 1.0:
            self.factor = DEFAULT_OVERCOMMIT_FACTOR
        self.idle = Resource()
        self.inqueue = Resource()

    def on_session_open(self, ssn) -> None:
        total, used = Resource(), Resource()
        for node in ssn.nodes.values():
            total.add(node.allocatable)
            used.add(node.used)
        self.idle = total.clone().multi(self.factor).sub(used)

        self.inqueue = Resource()
        for job in ssn.jobs.values():
            if (job.podgroup.phase == PodGroupPhase.INQUEUE
                    and job.podgroup.min_resources is not None):
                self.inqueue.add(job.get_min_resources())

        def job_enqueueable(job) -> int:
            if job.podgroup.min_resources is None:
                return PERMIT
            job_min = job.get_min_resources()
            if self.inqueue.clone().add(job_min).less_equal(self.idle):
                self.inqueue.add(job_min)
                return PERMIT
            return REJECT

        ssn.add_job_enqueueable_fn(self.NAME, job_enqueueable)

    def on_session_close(self, ssn) -> None:
        self.idle = Resource()
        self.inqueue = Resource()


def New(arguments):
    return OvercommitPlugin(arguments)
