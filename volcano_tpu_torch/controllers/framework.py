"""Controller framework: interface + registry.

Mirrors Volcano's pkg/controllers/framework/{interface.go:25-43,
factory.go:24-43}.
"""

from __future__ import annotations

from typing import Callable, Dict

_controllers: Dict[str, Callable] = {}


class Controller:
    NAME = "controller"

    def name(self) -> str:
        return self.NAME

    def initialize(self, store, **options) -> None:
        raise NotImplementedError

    def run(self) -> None:
        """Register watches; in-process controllers are event-driven so run
        is synchronous wiring, not a goroutine loop."""


def register_controller(factory: Callable) -> None:
    _controllers[factory().NAME if hasattr(factory, "NAME")
                 else str(factory)] = factory


def foreach_controller(fn: Callable) -> None:
    for factory in _controllers.values():
        fn(factory)
