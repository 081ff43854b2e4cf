"""Action interface (mirrors
pkg/scheduler/framework/interface.go:20-32)."""

from __future__ import annotations


class Action:
    NAME = "action"

    def name(self) -> str:
        return self.NAME

    def initialize(self) -> None:
        pass

    def execute(self, ssn) -> None:
        raise NotImplementedError

    def uninitialize(self) -> None:
        pass
