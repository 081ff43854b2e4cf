"""Plugin and action registries.

Mirrors pkg/scheduler/framework/plugins.go:38-119. A name
that is not registered is refused by the caller, never skipped: the
reference's plugins and actions that this package does not have yet must
not silently drop out of a conf.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

_lock = threading.Lock()
_plugin_builders: Dict[str, Callable] = {}
_actions: Dict[str, object] = {}


def register_plugin_builder(name: str, builder: Callable) -> None:
    with _lock:
        _plugin_builders[name] = builder


def get_plugin_builder(name: str) -> Callable:
    with _lock:
        builder = _plugin_builders.get(name)
    if builder is None:
        raise ValueError(f"plugin {name!r} is not in volcano_tpu_torch "
                         f"(has: {sorted(_plugin_builders)})")
    return builder


def register_action(action) -> None:
    with _lock:
        _actions[action.name()] = action


def get_action(name: str):
    with _lock:
        action = _actions.get(name)
    if action is None:
        raise ValueError(f"action {name!r} is not in volcano_tpu_torch "
                         f"(has: {sorted(_actions)})")
    return action
