"""Priority queue on a less-fn, mirroring
pkg/scheduler/util/priority_queue.go.

The queue is stable for equal-priority items only up to heap order, exactly
like the reference (container/heap); callers that need determinism must make
their less-fn total (the session order fns fall back to creation time + uid).
"""

from __future__ import annotations

import heapq
import itertools
from typing import Any, Callable, List


class PriorityQueue:
    def __init__(self, less_fn: Callable[[Any, Any], bool]):
        self._less = less_fn
        self._heap: List["_Item"] = []
        self._counter = itertools.count()

    def push(self, it: Any) -> None:
        heapq.heappush(self._heap, _Item(it, self._less, next(self._counter)))

    def clone(self) -> "PriorityQueue":
        """A copy that pops in exactly the original's order, insertion
        tie-breaks included (the strict engine's pop prediction)."""
        out = PriorityQueue(self._less)
        out._heap = list(self._heap)          # _Item is never mutated
        next_seq = max((it._seq for it in self._heap), default=-1) + 1
        out._counter = itertools.count(next_seq)
        return out

    def pop(self) -> Any:
        if not self._heap:
            return None
        return heapq.heappop(self._heap).value

    def empty(self) -> bool:
        return not self._heap


class _Item:
    __slots__ = ("value", "_less", "_seq")

    def __init__(self, value, less_fn, seq):
        self.value = value
        self._less = less_fn
        self._seq = seq

    def __lt__(self, other: "_Item") -> bool:
        if self._less(self.value, other.value):
            return True
        if self._less(other.value, self.value):
            return False
        return self._seq < other._seq
