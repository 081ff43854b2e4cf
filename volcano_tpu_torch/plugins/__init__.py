"""Policy plugins (mirrors pkg/scheduler/plugins/factory.go:38-56).

Importing this package registers the plugins this package has: priority,
gang, drf, predicates, proportion, nodeorder and binpack — the plugins of
deploy/scheduler.conf — and elastic-gang, conformance and numa-aware.
"""

from ..framework.registry import register_plugin_builder
from .base import Plugin
from . import (binpack, conformance, drf, elastic_gang, gang, nodeorder,
               numaaware, predicates, priority, proportion)

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

__all__ = ["Plugin"]
