"""Proportion plugin: weighted queue fair-share (deserved) via water-filling.

Mirrors pkg/scheduler/plugins/proportion/proportion.go:69-325.
The deserved computation is the vectorized form of the reference's
iterate-until-stable loop (proportion.go:132-196) over f32[Q,R] arrays:
ops.fairness.proportion_deserved_numpy below 64 queues, and
ops.fairness.proportion_deserved (torch ops on the session's device) at 64
or more.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .. import metrics
from ..api import (PodGroupPhase, Resource, ResourceNames, TaskStatus,
                   allocated_status)
from ..framework.session import PERMIT, REJECT, EventHandler
from .base import Plugin


class _QueueAttr:
    """share is recomputed lazily: allocate/deallocate events are hot (one
    per task per cycle) while share is only read when queues are ordered."""

    def __init__(self, uid: str, name: str, weight: int):
        self.uid = uid
        self.name = name
        self.weight = weight
        self.deserved = Resource()
        self.allocated = Resource()
        self.request = Resource()
        self.inqueue = Resource()
        self.capability: Resource = None
        self._share = 0.0
        self._share_dirty = True

    @property
    def share(self) -> float:
        if self._share_dirty:
            self._share = _share(self.allocated, self.deserved)
            self._share_dirty = False
        return self._share


def _share(allocated: Resource, deserved: Resource) -> float:
    res = 0.0
    for name in deserved.resource_names():
        d, a = deserved.get(name), allocated.get(name)
        if d > 0:
            res = max(res, a / d)
        elif a > 0:
            res = max(res, 1.0)
    return res


class ProportionPlugin(Plugin):
    NAME = "proportion"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.total = Resource()
        self.queue_opts: Dict[str, _QueueAttr] = {}

    # below this queue count the numpy twin of the water-filling is used —
    # identical semantics, as the JAX package chooses
    DEVICE_MIN_QUEUES = 64

    def on_session_open(self, ssn) -> None:
        from ..ops.fairness import (proportion_deserved,
                                    proportion_deserved_numpy)

        for node in ssn.nodes.values():
            self.total.add(node.allocatable)

        for job in ssn.jobs.values():
            if job.queue not in ssn.queues:
                continue
            queue = ssn.queues[job.queue]
            attr = self.queue_opts.get(job.queue)
            if attr is None:
                attr = _QueueAttr(queue.uid, queue.name, queue.weight)
                attr.capability = queue.capability
                self.queue_opts[job.queue] = attr
            for status, tasks in job.task_status_index.items():
                if allocated_status(status):
                    for t in tasks.values():
                        attr.allocated.add(t.resreq)
                        attr.request.add(t.resreq)
                elif status == TaskStatus.PENDING:
                    for t in tasks.values():
                        attr.request.add(t.resreq)
            if job.podgroup.phase == PodGroupPhase.INQUEUE:
                attr.inqueue.add(job.get_min_resources())

        # -- deserved water-filling on device (proportion.go:132-196) -------
        if self.queue_opts:
            attrs = list(self.queue_opts.values())
            rnames = ResourceNames.discover(
                [self.total] + [a.request for a in attrs]
                + [a.capability for a in attrs if a.capability is not None])
            Q, R = len(attrs), len(rnames)
            total_v = self.total.to_vector(rnames)
            weight_v = np.asarray([a.weight for a in attrs], np.float32)
            request_v = np.stack([a.request.to_vector(rnames) for a in attrs])
            cap_v = np.stack([
                a.capability.to_vector_inf_fill(rnames) if a.capability is not None
                else np.full(R, np.inf, np.float32) for a in attrs])
            alloc_v = np.stack([a.allocated.to_vector(rnames) for a in attrs])
            if len(attrs) < self.DEVICE_MIN_QUEUES:
                res = proportion_deserved_numpy(total_v, weight_v, request_v,
                                                cap_v, alloc_v)
                deserved = res.deserved
            else:
                res = proportion_deserved(total_v, weight_v, request_v,
                                          cap_v, alloc_v, device=ssn.device)
                deserved = res.deserved.cpu().numpy()
            for i, attr in enumerate(attrs):
                attr.deserved = Resource.from_vector(deserved[i], rnames)
                attr._share_dirty = True
                # expose deserved to the reclaim screener's over-deserved
                # gate (actions/evict_tpu.py)
                ssn.queue_deserved[attr.name] = attr.deserved
                metrics.update_queue_metrics(attr.name, attr.allocated.cpu,
                                             share=attr.share)

        def queue_order(l, r) -> int:
            la = self.queue_opts.get(l.uid)
            ra = self.queue_opts.get(r.uid)
            ls = la.share if la else 0.0
            rs = ra.share if ra else 0.0
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        ssn.add_queue_order_fn(self.NAME, queue_order)

        def reclaimable(reclaimer, reclaimees):
            """Victims from queues allocated above deserved
            (proportion.go:246-271)."""
            victims = []
            allocations: Dict[str, Resource] = {}
            for reclaimee in reclaimees:
                job = ssn.jobs[reclaimee.job]
                attr = self.queue_opts.get(job.queue)
                if attr is None:
                    continue
                if job.queue not in allocations:
                    allocations[job.queue] = attr.allocated.clone()
                allocated = allocations[job.queue]
                if allocated.less(reclaimee.resreq):
                    continue
                if not allocated.less_equal(attr.deserved):
                    allocated.sub(reclaimee.resreq)
                    victims.append(reclaimee)
            return victims, PERMIT

        ssn.add_reclaimable_fn(self.NAME, reclaimable)

        def overused(queue) -> bool:
            """allocated exceeds deserved in ANY dimension
            (proportion.go:244: !allocated.LessEqualInAllDimension(deserved))."""
            attr = self.queue_opts.get(queue.uid)
            if attr is None:
                return False
            return not attr.allocated.less_equal(attr.deserved)

        ssn.add_overused_fn(self.NAME, overused)

        def job_enqueueable(job) -> int:
            """minResources-vs-capability gate (proportion.go:273-299)."""
            queue = ssn.queues.get(job.queue)
            attr = self.queue_opts.get(job.queue)
            if queue is None or attr is None:
                return PERMIT
            if queue.capability is None:
                return PERMIT
            if job.podgroup.min_resources is None:
                return PERMIT
            min_req = job.get_min_resources()
            total_would = min_req.clone().add(attr.allocated).add(attr.inqueue)
            from ..api.resource import INFINITY
            if total_would.less_equal(queue.capability, INFINITY):
                attr.inqueue.add(job.get_min_resources())
                return PERMIT
            return REJECT

        ssn.add_job_enqueueable_fn(self.NAME, job_enqueueable)

        def on_allocate(event):
            job = ssn.jobs[event.task.job]
            attr = self.queue_opts.get(job.queue)
            if attr is None:
                return
            attr.allocated.add(event.task.resreq)
            attr._share_dirty = True

        def on_deallocate(event):
            job = ssn.jobs[event.task.job]
            attr = self.queue_opts.get(job.queue)
            if attr is None:
                return
            attr.allocated.sub(event.task.resreq)
            attr._share_dirty = True

        ssn.add_event_handler(EventHandler(allocate_func=on_allocate,
                                           deallocate_func=on_deallocate,
                                           aggregatable=True))

    def on_session_close(self, ssn) -> None:
        # the queue gauges once a cycle (the reference updates them on
        # every event; the end-of-cycle values are the same)
        for attr in self.queue_opts.values():
            metrics.update_queue_metrics(attr.name, attr.allocated.cpu,
                                         share=attr.share)
        self.total = Resource()
        self.queue_opts = {}


def New(arguments):
    return ProportionPlugin(arguments)
