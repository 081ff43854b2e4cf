"""Policy plugins (mirrors pkg/scheduler/plugins/factory.go:38-56).

Importing this package registers the plugins this package has: priority,
gang, drf, predicates, proportion, nodeorder and binpack — the plugins of
deploy/scheduler.conf — and elastic-gang, conformance, numa-aware, tdm,
sla, overcommit, reservation and task-topology: every plugin of the JAX
package.
"""

from ..framework.registry import register_plugin_builder
from .base import Plugin
from . import (binpack, conformance, drf, elastic_gang, gang, nodeorder,
               numaaware, overcommit, predicates, priority, proportion,
               reservation, sla, task_topology, tdm)

register_plugin_builder("gang", gang.New)
register_plugin_builder("priority", priority.New)
register_plugin_builder("binpack", binpack.New)
register_plugin_builder("nodeorder", nodeorder.New)
register_plugin_builder("drf", drf.New)
register_plugin_builder("predicates", predicates.New)
register_plugin_builder("proportion", proportion.New)
register_plugin_builder("elastic-gang", elastic_gang.New)
register_plugin_builder("conformance", conformance.New)
register_plugin_builder("numa-aware", numaaware.New)
register_plugin_builder("overcommit", overcommit.New)
register_plugin_builder("sla", sla.New)
register_plugin_builder("tdm", tdm.New)
register_plugin_builder("reservation", reservation.New)
register_plugin_builder("task-topology", task_topology.New)

__all__ = ["Plugin"]
