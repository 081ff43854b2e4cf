"""Action interface (mirrors
pkg/scheduler/framework/interface.go:20-32)."""

from __future__ import annotations


class Action:
    NAME = "action"

    def name(self) -> str:
        return self.NAME

    def initialize(self) -> None:
        pass

    def check_conf(self, configurations) -> None:
        """Refuse, when the conf is loaded, a configuration block this
        action cannot run (an engine or argument this package lacks), so
        the refusal never becomes a failure isolated inside a cycle."""

    def execute(self, ssn) -> None:
        raise NotImplementedError

    def uninitialize(self) -> None:
        pass
