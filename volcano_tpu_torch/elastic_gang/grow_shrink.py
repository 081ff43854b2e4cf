"""grow-shrink: the elastic stage between allocate and preempt.

Runs after allocate (admission at min is settled for the cycle) and
before preempt and reclaim (so capacity given back is visible before
anyone picks forced victims). Four passes, in order:

1. suspend drain: a suspended gang gives up every member, the one
   full-gang decision, where below-min is legal;
2. scale shrink: a gang bound above its (possibly just rewritten)
   desired count sheds the excess, highest uid first;
3. pressure shrink: while an unadmitted gang starves, shed a bounded
   number of above-min members a cycle (``max-pressure-shrinks``, 2 by
   default) from the most inflated elastic gangs;
4. grow: only when no gang starves, place pending members of admitted
   elastic gangs toward desired through the host placer (predicates and
   node order, so the elastic-gang plugin's zone bonus steers them into
   the gang's zone), binding through ``ssn.allocate``, the journaled
   funnel (``max-grows-per-cycle``, 0 for no cap).

Every grow and shrink also journals an ``elastic_grow`` /
``elastic_shrink`` control record stamped with the fencing epoch.
"""

from __future__ import annotations

import logging

from ..actions.base import Action
from ..api import TaskStatus
from ..metrics import (register_below_min_eviction, register_gang_growth,
                       register_gang_shrink, set_elastic_members,
                       set_topology_spread)
from ..obs import trace as obs_trace
from ..obs.lifecycle import TIMELINE
from ..utils.scheduler_helper import (predicate_nodes, prioritize_nodes,
                                      select_best_node)
from .membership import (active_members, desired_members, grow_candidates,
                         is_elastic, is_suspended, shrink_allowance,
                         shrink_candidates)

log = logging.getLogger(__name__)


def _conf_int(ssn, key: str, default: int) -> int:
    for conf in getattr(ssn, "configurations", []) or []:
        if getattr(conf, "name", "") == "grow-shrink":
            try:
                return int((conf.arguments or {}).get(key, default))
            except (TypeError, ValueError):
                return default
    return default


class GrowShrinkAction(Action):
    NAME = "grow-shrink"

    def __init__(self):
        # the last execute's counts (reset at entry)
        self.last_stats = {}

    def execute(self, ssn) -> None:
        with obs_trace.span("grow_shrink"):
            self._execute(ssn)

    def _journal_elastic(self, ssn, kind: str, task, reason: str) -> None:
        """A durable, epoch-stamped control record of an elastic mutation,
        beside the bind or evict intent the session funnel wrote. It
        carries a lifecycle ctx stamp, so a reader of the journal continues
        the job's timeline; the local store records the same event first
        and dedupes the replay."""
        cache = ssn.cache
        epoch = cache.fencing_epoch()
        ctx = TIMELINE.stamp(part=getattr(cache, "obs_part", None),
                             epoch=epoch)
        if ctx is not None:
            ev = "grow" if kind == "elastic_grow" else "shrink"
            TIMELINE.record(task.job, ev, ctx=ctx,
                            node=task.node_name or None,
                            reason=reason or None)
        journal = getattr(cache, "journal", None)
        if journal is None:
            return
        fields = {
            "job": task.job, "task": task.uid, "node": task.node_name,
            "reason": reason, "epoch": epoch}
        if ctx is not None:
            fields["ctx"] = ctx
        journal.record_control(kind, fields)

    def _shrink_one(self, ssn, job, task, reason: str,
                    full_gang: bool = False) -> bool:
        """Evict one member through the session funnel. Refuses to go
        below min outside a full-gang decision (the suspend drain), and
        counts the refusal: the below-min counter must stay 0."""
        if not full_gang and active_members(job) - 1 < job.min_available:
            register_below_min_eviction()
            log.error("refusing below-min shrink of %s (%s)", job.uid, reason)
            return False
        if task.node_name not in ssn.nodes:
            # the member's node left the snapshot: nothing to release this
            # cycle (a restore brings it back, a death requeues the member)
            return False
        ssn.evict(task, f"elastic-{reason}")
        self._journal_elastic(ssn, "elastic_shrink", task, reason)
        register_gang_shrink(reason)
        self.last_stats["shrinks"] = self.last_stats.get("shrinks", 0) + 1
        return True

    def _grow_one(self, ssn, job, task) -> bool:
        """Place one pending member of an admitted gang; the gang is
        ready, so ``ssn.allocate`` dispatches the bind at once."""
        fit = [n for n in ssn.nodes.values()
               if task.resreq.less_equal(n.idle) and n.ready]
        if not fit:
            return False
        feasible, _ = predicate_nodes(task, fit, ssn.predicate_fn)
        if not feasible:
            return False
        scores = prioritize_nodes(task, feasible, ssn.batch_node_order_fn,
                                  ssn.node_order_fn)
        node = select_best_node(scores)
        if node is None:
            return False
        ssn.allocate(task, node)
        self._journal_elastic(ssn, "elastic_grow", task, "grow")
        register_gang_growth()
        self.last_stats["grows"] = self.last_stats.get("grows", 0) + 1
        return True

    def _execute(self, ssn) -> None:
        self.last_stats = {"grows": 0, "shrinks": 0, "suspended_drained": 0}
        elastic = sorted((j for j in ssn.jobs.values() if is_elastic(j)),
                         key=lambda j: j.uid)
        if not elastic:
            self._publish_gauges(ssn, elastic)
            return

        # 1. suspend drain: the full-gang decision
        for job in elastic:
            if not is_suspended(job):
                continue
            drained = 0
            for task in shrink_candidates(job):
                if self._shrink_one(ssn, job, task, "suspend",
                                    full_gang=True):
                    drained += 1
            if drained:
                self.last_stats["suspended_drained"] += 1

        # 2. scale shrink: above the (possibly freshly scaled) desired
        for job in elastic:
            if is_suspended(job):
                continue
            excess = active_members(job) - desired_members(job)
            if excess <= 0:
                continue
            excess = min(excess, shrink_allowance(job))
            for task in shrink_candidates(job)[:excess]:
                self._shrink_one(ssn, job, task, "scale")

        # 3/4. pressure shrink or grow: starving gangs come first
        if self._starving_exists(ssn):
            budget = _conf_int(ssn, "max-pressure-shrinks", 2)
            donors = sorted((j for j in elastic
                             if not is_suspended(j)
                             and shrink_allowance(j) > 0),
                            key=lambda j: (-shrink_allowance(j), j.uid))
            for job in donors:
                if budget <= 0:
                    break
                take = min(shrink_allowance(job), budget)
                for task in shrink_candidates(job)[:take]:
                    if self._shrink_one(ssn, job, task, "pressure"):
                        budget -= 1
        else:
            max_grows = _conf_int(ssn, "max-grows-per-cycle", 0)
            grown = 0
            for job in elastic:
                if is_suspended(job) or not job.ready():
                    continue
                need = desired_members(job) - active_members(job)
                for task in grow_candidates(job)[:max(need, 0)]:
                    if max_grows and grown >= max_grows:
                        break
                    if self._grow_one(ssn, job, task):
                        grown += 1

        self._publish_gauges(ssn, elastic)

    @staticmethod
    def _starving_exists(ssn) -> bool:
        """A valid, unadmitted gang with real pending requests waits for
        capacity: elastic surplus must not outbid admission."""
        for job in ssn.jobs.values():
            if job.ready():
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.passed:
                continue
            pend = job.task_status_index.get(TaskStatus.PENDING, {})
            if any(not t.init_resreq.is_empty() for t in pend.values()):
                return True
        return False

    def _publish_gauges(self, ssn, elastic) -> None:
        above_min = sum(max(active_members(j) - j.min_available, 0)
                        for j in elastic)
        set_elastic_members(above_min)
        spread = 0
        for job in ssn.jobs.values():
            zones = set()
            for status in (TaskStatus.BOUND, TaskStatus.RUNNING,
                           TaskStatus.BINDING, TaskStatus.ALLOCATED):
                for t in job.task_status_index.get(status, {}).values():
                    node = ssn.nodes.get(t.node_name)
                    if node is not None and node.topology_zone:
                        zones.add(node.topology_zone)
            if len(zones) > 1:
                spread += 1
        set_topology_spread(spread)
        self.last_stats["above_min_members"] = above_min
        self.last_stats["topology_spread"] = spread
