"""Per-plugin argument map with typed getters.

Mirrors pkg/scheduler/framework/arguments.go:1-99.
"""

from __future__ import annotations

from typing import Dict, Optional


class Arguments(dict):
    """map[string]string with GetBool/GetInt/GetFloat helpers."""

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key)
        if v is None:
            return default
        return str(v).strip().lower() in ("1", "t", "true", "yes", "y")

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key)
        if v is None:
            return default
        try:
            return int(str(v).strip())
        except ValueError:
            return default
