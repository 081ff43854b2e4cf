"""Shared plugin helpers.

Mirrors pkg/scheduler/plugins/util/util.go (Permit/Abstain/Reject live in
framework.session; NormalizeScore here).
"""

from __future__ import annotations

from typing import Dict


def normalize_score(max_priority: int, reverse: bool,
                    scores: Dict[str, int]) -> Dict[str, int]:
    """util.go NormalizeScore:276-301 — scale to [0, max_priority] by the
    max entry; with ``reverse`` smaller raw scores map to larger results.
    Returns a new dict (the reference mutates in place)."""
    max_count = max(scores.values(), default=0)
    if max_count == 0:
        return {k: max_priority if reverse else v for k, v in scores.items()}
    out = {}
    for key, score in scores.items():
        score = max_priority * score // max_count
        if reverse:
            score = max_priority - score
        out[key] = score
    return out
