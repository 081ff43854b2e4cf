"""CycleBudget: the per-cycle work bound of the overload failure model.

Under sustained overload the scheduling cycle's natural cost grows with
the backlog — an unbounded cycle stretches the schedule period, which
grows the backlog further, which stretches the cycle: the collapse
spiral. The budget breaks it: ``Scheduler(cycle_budget_s=...)`` threads
one ``CycleBudget`` through ``run_once``; every action consults the
remaining budget before it dispatches, and when the budget is exhausted
the remaining actions DEFER to the next cycle with carry-over ordering
(a round-robin cursor persisted across cycles, so a deferred action is
the FIRST to run next cycle and no queue's action starves behind an
expensive neighbor).

Two spending meters compose:

- **elapsed time** on the injectable clock (``time_fn``) — the
  production meter: a slow device solve or a fat replay eats budget by
  simply taking wall time (the sim's VirtualClock does not advance
  inside a cycle, so this meter reads 0 under replay);
- **charged cost** (``charge``) — an explicit, deterministic work model:
  the shell charges ``budget_cost_fn(action, session)`` seconds-
  equivalent per action. The simulator prices actions by backlog size,
  which makes budget exhaustion a pure function of the decision plane —
  the overload soaks replay byte-identically.

The budget bounds work BETWEEN actions, not inside one — a single
action that overshoots finishes (nothing is half-applied), which is why
the acceptance bound is "p99 cycle spend within 2x the budget", not 1x.
"""

from __future__ import annotations

from typing import Callable, Optional


class CycleBudget:
    """One cycle's spending record. Construct at cycle start; ``spent``
    is elapsed clock time since construction plus everything charged."""

    __slots__ = ("budget_s", "time_fn", "started", "charged")

    def __init__(self, budget_s: Optional[float],
                 time_fn: Callable[[], float]):
        self.budget_s = float(budget_s) if budget_s else None
        self.time_fn = time_fn
        self.started = time_fn()
        self.charged = 0.0

    def charge(self, cost_s: float) -> None:
        """Add deterministic modelled work (seconds-equivalent) to the
        cycle's spend; negative charges are ignored."""
        if cost_s > 0:
            self.charged += float(cost_s)

    def spent(self) -> float:
        return (self.time_fn() - self.started) + self.charged

    def remaining(self) -> float:
        """Seconds of budget left; +inf when unbounded."""
        if self.budget_s is None:
            return float("inf")
        return self.budget_s - self.spent()

    def exhausted(self) -> bool:
        """True once the cycle has spent its whole budget — the check
        every action runs BEFORE dispatch (a started action always
        finishes; the budget bounds work between actions)."""
        return self.budget_s is not None and self.remaining() <= 0.0
