"""Policy plugins (mirrors pkg/scheduler/plugins/factory.go:38-56).

Importing this package registers the plugins this package has: priority,
gang, nodeorder and binpack.
"""

from ..framework.registry import register_plugin_builder
from .base import Plugin
from . import binpack, gang, nodeorder, priority

register_plugin_builder("gang", gang.New)
register_plugin_builder("priority", priority.New)
register_plugin_builder("binpack", binpack.New)
register_plugin_builder("nodeorder", nodeorder.New)

__all__ = ["Plugin"]
