"""Elastic gangs: only the membership constants and ``is_elastic`` so far,
which the sim's requeue bookkeeping reads. The grow-shrink stage, its
plugin and the command funnel are not in this package yet."""

from .membership import (ELASTIC_DESIRED_ANNOTATION, TOPOLOGY_ZONE_LABEL,
                         is_elastic)

__all__ = ["ELASTIC_DESIRED_ANNOTATION", "TOPOLOGY_ZONE_LABEL", "is_elastic"]
