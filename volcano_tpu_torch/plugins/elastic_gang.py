"""elastic-gang plugin: session policy for min/desired gangs.

Installs the host-side hooks that make elastic membership a policy every
engine respects (the device path's victim tier is in
actions/evict_tpu.py; the lifecycle funnel in elastic_gang/commands.py):

- ``ssn.elastic_pending_filter``: narrows the pending set the allocate
  engines (and preempt's pending collection) see, so an elastic gang bids
  for exactly ``min`` at admission (allocate._pending_tasks reads it);
- job_valid: a suspended gang is not schedulable this cycle;
- preemptable/reclaimable: an elastic gang's members are offered as
  victims only up to its shrink allowance, highest uid first, so no
  preempt or reclaim decision takes a gang below min;
- node_order: a bonus for nodes in a zone where the task's gang already
  holds members, the host side of the placement kernel's anchor term
  (ops/place.py::place_topo_plain), which steers grow-shrink's placer into
  the gang's zone.

Arguments: ``topology-weight`` (float, default 10.0) scales the node_order
bonus; 0 turns it off.
"""

from __future__ import annotations

from ..api import TaskStatus
from ..elastic_gang.membership import (allocate_pending_filter, is_elastic,
                                       is_suspended, shrink_allowance)
from ..framework.session import PERMIT, ValidateResult
from .base import Plugin

SUSPENDED = "Suspended"


def _member_zones(ssn, job) -> set:
    """The zones where the gang holds capacity."""
    zones = set()
    for status in (TaskStatus.BOUND, TaskStatus.RUNNING,
                   TaskStatus.BINDING, TaskStatus.ALLOCATED):
        for t in job.task_status_index.get(status, {}).values():
            node = ssn.nodes.get(t.node_name)
            if node is not None and node.topology_zone:
                zones.add(node.topology_zone)
    return zones


class ElasticGangPlugin(Plugin):
    NAME = "elastic-gang"

    def on_session_open(self, ssn) -> None:
        try:
            topo_weight = float(self.arguments.get("topology-weight", 10.0))
        except (TypeError, ValueError):
            topo_weight = 10.0

        ssn.elastic_pending_filter = allocate_pending_filter

        def job_valid(job):
            if is_elastic(job) and is_suspended(job):
                return ValidateResult(
                    False, SUSPENDED,
                    "gang is suspended by lifecycle command")
            return None

        ssn.add_job_valid_fn(self.NAME, job_valid)

        def preemptable(preemptor, preemptees):
            """Each elastic gang offers at most its shrink allowance of
            victims, highest uid first (grow-shrink's shedding order); a
            suspended gang offers none, since its drain is under way."""
            by_job = {}
            for t in preemptees:
                by_job.setdefault(t.job, []).append(t)
            victims = []
            for uid, tasks in by_job.items():
                job = ssn.jobs.get(uid)
                if job is None or not is_elastic(job):
                    victims.extend(tasks)
                    continue
                if is_suspended(job):
                    continue
                allow = shrink_allowance(job)
                if allow <= 0:
                    continue
                tasks = sorted(tasks, key=lambda t: t.uid, reverse=True)
                victims.extend(tasks[:allow])
            return victims, PERMIT

        ssn.add_preemptable_fn(self.NAME, preemptable)
        ssn.add_reclaimable_fn(self.NAME, preemptable)

        if topo_weight > 0.0:
            # on the node-order scale (each nodeorder term spans about
            # 0-100): the default weight 10 gives a 1000-point pull
            bonus = topo_weight * 100.0

            def node_order(task, node):
                if not node.topology_zone:
                    return 0.0
                job = ssn.jobs.get(task.job)
                if job is None:
                    return 0.0
                zones = _member_zones(ssn, job)
                if not zones:
                    return 0.0
                return bonus if node.topology_zone in zones else 0.0

            ssn.add_node_order_fn(self.NAME, node_order)


def New(arguments):
    return ElasticGangPlugin(arguments)
