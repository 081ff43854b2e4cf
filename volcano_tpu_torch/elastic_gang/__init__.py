"""Elastic gangs: min/desired membership as a scheduler decision class.

- membership.py: annotations, counts, the allocate pending filter;
- commands.py: the journaled and fenced suspend/resume/scale funnel;
- grow_shrink.py: the elastic stage between allocate and preempt.

The plugin half (the pending filter, the victim caps, the zone node-order
bonus) is plugins/elastic_gang.py; the device path's victim tier is in
actions/evict_tpu.py.
"""

from .commands import VERBS, CommandFunnel
from .membership import (ELASTIC_DESIRED_ANNOTATION, SUSPEND_ANNOTATION,
                         TOPOLOGY_ZONE_LABEL, active_members,
                         allocate_pending_filter, desired_members,
                         grow_candidates, is_elastic, is_suspended,
                         shrink_allowance, shrink_candidates)

__all__ = [
    "CommandFunnel", "VERBS", "GrowShrinkAction",
    "ELASTIC_DESIRED_ANNOTATION", "SUSPEND_ANNOTATION",
    "TOPOLOGY_ZONE_LABEL",
    "active_members", "allocate_pending_filter", "desired_members",
    "grow_candidates", "is_elastic", "is_suspended", "shrink_allowance",
    "shrink_candidates",
]


def __getattr__(name):
    # grow_shrink imports actions.base; exported lazily so that importing
    # this package never starts the actions package half way
    if name == "GrowShrinkAction":
        from .grow_shrink import GrowShrinkAction
        return GrowShrinkAction
    raise AttributeError(name)
