"""Plugin base interface (mirrors
pkg/scheduler/framework/interface.go:34-41)."""

from __future__ import annotations

from ..framework.arguments import Arguments


class Plugin:
    NAME = "base"

    def __init__(self, arguments: Arguments = None):
        self.arguments = arguments or Arguments()

    def name(self) -> str:
        return self.NAME

    def on_session_open(self, ssn) -> None:
        raise NotImplementedError

    def on_session_close(self, ssn) -> None:
        pass
