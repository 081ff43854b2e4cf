"""Policy plugins (mirrors pkg/scheduler/plugins/factory.go:38-56).

Importing this package registers the plugins this package has: priority,
gang, drf, predicates, proportion, nodeorder and binpack — the plugins of
deploy/scheduler.conf.
"""

from ..framework.registry import register_plugin_builder
from .base import Plugin
from . import (binpack, drf, gang, nodeorder, predicates, priority,
               proportion)

register_plugin_builder("gang", gang.New)
register_plugin_builder("priority", priority.New)
register_plugin_builder("binpack", binpack.New)
register_plugin_builder("nodeorder", nodeorder.New)
register_plugin_builder("drf", drf.New)
register_plugin_builder("predicates", predicates.New)
register_plugin_builder("proportion", proportion.New)

__all__ = ["Plugin"]
