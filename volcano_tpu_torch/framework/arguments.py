"""Per-plugin argument map with typed getters.

Mirrors pkg/scheduler/framework/arguments.go:1-99.
"""

from __future__ import annotations

from typing import Dict, Optional


class Arguments(dict):
    """map[string]string with GetBool/GetInt/GetFloat helpers."""

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key)
        if v is None:
            return default
        try:
            return int(str(v).strip())
        except ValueError:
            return default
