"""Elastic gang membership: the annotation that marks a gang elastic.

An elastic gang admits at ``min_available`` and may grow toward a
``desired`` member count (PodGroup annotation
``volcano.sh/elastic-desired``). This package keeps the annotations and
the membership test; a job without the annotation is a classic rigid
gang.
"""

from __future__ import annotations

ELASTIC_DESIRED_ANNOTATION = "volcano.sh/elastic-desired"
# the node label naming its interconnect locality group
TOPOLOGY_ZONE_LABEL = "volcano.sh/topology-zone"


def _annotations(job) -> dict:
    pg = getattr(job, "podgroup", None)
    if pg is None:
        return {}
    return getattr(pg, "annotations", None) or {}


def is_elastic(job) -> bool:
    """The elastic-desired annotation is the membership switch: absent
    means a rigid gang."""
    return ELASTIC_DESIRED_ANNOTATION in _annotations(job)
