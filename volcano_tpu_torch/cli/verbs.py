"""The standalone verb entry points, the JAX package's ``cli/verbs.py``:
vsub, vcancel, vsuspend, vresume, vscale, vjobs, vqueues and vredrive.

Volcano builds one binary a verb around the same pkg/cli
(Makefile:172-180 ``command-lines``); here each is a function wrapping
vcctl's parser with the verb applied. The in-process CLI talks to a store,
so a standalone call has none and vcctl's main says so; the snapshot RPC
that would reach a running deployment is not in this package yet (ROADMAP
item 9f′).
"""

from __future__ import annotations

import sys
from typing import List, Optional

from .vcctl import main


def _run(prefix: List[str], argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    return main(prefix + list(argv))


def vsub(argv=None) -> int:
    """vsub == vcctl job run."""
    return _run(["job", "run"], argv)


def vcancel(argv=None) -> int:
    return _run(["job", "delete"], argv)


def vsuspend(argv=None) -> int:
    return _run(["job", "suspend"], argv)


def vresume(argv=None) -> int:
    return _run(["job", "resume"], argv)


def vscale(argv=None) -> int:
    """vscale == vcctl job scale: rewrite an elastic gang's desired
    member count through the scheduler's journaled Command funnel
    (docs/design/elastic-gangs.md). In-process callers pass the running
    scheduler's funnel via vcctl.main(..., funnel=...)."""
    return _run(["job", "scale"], argv)


def vjobs(argv=None) -> int:
    return _run(["job", "list"], argv)


def vqueues(argv=None) -> int:
    return _run(["queue", "list"], argv)


def redrive_dead_letter(argv=None) -> int:
    """vredrive == vcctl cache redrive-dead-letter: re-queue every
    dead-lettered side effect with a fresh retry budget once the
    underlying fault (bad node, apiserver outage) is fixed
    (docs/robustness.md). In-process callers pass the running
    scheduler's cache via vcctl.main(..., cache=...)."""
    return _run(["cache", "redrive-dead-letter"], argv)
