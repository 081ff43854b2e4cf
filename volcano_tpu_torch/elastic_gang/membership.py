"""Elastic gang membership: the min/desired decision class.

An elastic gang admits at ``min_available`` and expands toward a
``desired`` member count as capacity frees; under pressure its above-min
members are the cheapest victims in the cluster. The decision class is
count-based, not identity-based: any ``active - min`` surplus is
shrinkable and any pending member of an admitted gang is growable, so a
core member lost under churn is re-placed by the next grow pass. Identity
enters only as a deterministic tie order (task uid).

Annotations (PodGroup):

- ``volcano.sh/elastic-desired``: presence marks the gang elastic; the
  integer value is the target member count (clamped to >= min_available).
- ``volcano.sh/suspend``: ``"true"`` parks the gang: grow-shrink drains
  every member (a full-gang decision, so below-min is legal there and only
  there) and the allocate engines see an empty pending set until a
  ``resume`` command clears the mark.

Both annotations are rewritten only by the command funnel (commands.py)
at the cycle boundary, never mid-cycle.
"""

from __future__ import annotations

from typing import List

from ..api import TaskStatus

ELASTIC_DESIRED_ANNOTATION = "volcano.sh/elastic-desired"
SUSPEND_ANNOTATION = "volcano.sh/suspend"
# the node label naming its interconnect locality group (NodeInfo reads it
# into .topology_zone; cache/snapshot.py hashes it into zone_code)
TOPOLOGY_ZONE_LABEL = "volcano.sh/topology-zone"


def _annotations(job) -> dict:
    pg = getattr(job, "podgroup", None)
    if pg is None:
        return {}
    return getattr(pg, "annotations", None) or {}


def is_elastic(job) -> bool:
    """The elastic-desired annotation is the membership switch: absent
    means a rigid gang, and every elastic path leaves it as it was."""
    return ELASTIC_DESIRED_ANNOTATION in _annotations(job)


def is_suspended(job) -> bool:
    return _annotations(job).get(SUSPEND_ANNOTATION, "") == "true"


def desired_members(job) -> int:
    """The target member count: the annotation's value clamped to
    min_available (a stale object may carry a desired below min)."""
    try:
        d = int(_annotations(job).get(ELASTIC_DESIRED_ANNOTATION, 0))
    except (TypeError, ValueError):
        d = 0
    return max(d, job.min_available)


def active_members(job) -> int:
    """Members holding (or pledged) capacity: the count gang admission
    reads (JobInfo.ready_task_num)."""
    return job.ready_task_num()


def shrink_allowance(job) -> int:
    """How many members an elastic decision (the preempt victim tier, a
    scale verb, a pressure shrink) may take without a full-gang decision:
    ``active - min``, floored at 0; 0 for a rigid gang."""
    if not is_elastic(job):
        return 0
    return max(active_members(job) - job.min_available, 0)


def shrink_candidates(job) -> List:
    """Bound and running members in eviction order, highest task uid
    first. Callers cap the slice they take at shrink_allowance (or drain
    all of it for the suspend decision)."""
    out: List = []
    for status in (TaskStatus.BOUND, TaskStatus.RUNNING):
        out.extend(job.task_status_index.get(status, {}).values())
    out.sort(key=lambda t: t.uid, reverse=True)
    return out


def grow_candidates(job) -> List:
    """Pending members with a real request, lowest uid first: the order
    grow fills them."""
    pending = [t for t in job.task_status_index.get(TaskStatus.PENDING,
                                                    {}).values()
               if not t.init_resreq.is_empty()]
    pending.sort(key=lambda t: t.uid)
    return pending


def allocate_pending_filter(job, tasks):
    """The pending set the allocate engines see of ``job``
    (``ssn.elastic_pending_filter``, installed by the elastic-gang plugin;
    read by allocate._pending_tasks):

    - rigid gang: unchanged;
    - suspended: empty;
    - admitted (active >= min): empty, since growth toward desired belongs
      to the grow-shrink stage;
    - not yet admitted: the first ``min - active`` pending tasks by uid, so
      the gang vote fires exactly at min.
    """
    if not tasks or not is_elastic(job):
        return tasks
    if is_suspended(job):
        return []
    need = job.min_available - active_members(job)
    if need <= 0:
        return []
    return sorted(tasks, key=lambda t: t.uid)[:need]
