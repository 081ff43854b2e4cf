"""Host-side resource vector model.

Mirrors the semantics of the reference's ``Resource`` type
(pkg/scheduler/api/resource_info.go:49-487) — milli-CPU +
memory + arbitrary scalar resources, epsilon-tolerant comparisons with
Zero/Infinity defaults for missing dimensions — and round-trips into
fixed-width ``float32`` rows (see :class:`ResourceNames`), because the
placement kernel keeps every resource as one column of an ``f32[N, R]``
tensor.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

# Epsilon used by the reference for all comparisons
# (resource_info.go:36 `minResource float64 = 0.1`).
MIN_RESOURCE = 0.1

# DimensionDefaultValue (resource_info.go:40-48): how a dimension that is
# absent from a Resource's scalar map is treated during comparisons.
ZERO = "Zero"
INFINITY = "Infinity"

CPU = "cpu"
MEMORY = "memory"

_INF = math.inf


def _le_eps(l: float, r: float) -> bool:
    """l <= r with the reference's epsilon (resource_info.go:311-316)."""
    return l < r or abs(l - r) < MIN_RESOURCE


class Resource:
    """A resource vector: milli-CPU, memory (bytes), scalar resources.

    ``max_task_num`` mirrors ``MaxTaskNum`` (resource_info.go:57-59): only used
    by predicates (pod-count capacity), never part of arithmetic.

    Task requests and node allocatables are shared between the live cache
    and every snapshot clone (TaskInfo.clone, NodeInfo.clone), so they are
    never mutated after construction: arithmetic happens only on the
    aggregates (idle, used, releasing, pipelined, allocated), which clones
    copy.
    """

    __slots__ = ("cpu", "memory", "scalars", "max_task_num")

    def __init__(self, cpu: float = 0.0, memory: float = 0.0,
                 scalars: Optional[Dict[str, float]] = None,
                 max_task_num: Optional[int] = None):
        self.cpu = float(cpu)
        self.memory = float(memory)
        self.scalars: Dict[str, float] = dict(scalars) if scalars else {}
        self.max_task_num = max_task_num

    def clone(self) -> "Resource":
        r = Resource.__new__(Resource)
        r.cpu = self.cpu
        r.memory = self.memory
        r.scalars = dict(self.scalars)
        r.max_task_num = self.max_task_num
        return r

    # -- accessors ----------------------------------------------------------

    def get(self, name: str) -> float:
        if name == CPU:
            return self.cpu
        if name == MEMORY:
            return self.memory
        return self.scalars.get(name, 0.0)

    def is_empty(self) -> bool:
        """True iff every dimension is below epsilon (resource_info.go:142-155)."""
        if not (self.cpu < MIN_RESOURCE and self.memory < MIN_RESOURCE):
            return False
        return all(q < MIN_RESOURCE for q in self.scalars.values())

    # -- arithmetic (in place, returning self, like the reference) ----------

    def add(self, rr: "Resource") -> "Resource":
        self.cpu += rr.cpu
        self.memory += rr.memory
        for n, q in rr.scalars.items():
            self.scalars[n] = self.scalars.get(n, 0.0) + q
        return self

    def sub(self, rr: "Resource") -> "Resource":
        """Subtract; refuses an insufficient minuend like the reference
        (resource_info.go:191-206)."""
        if not rr.less_equal(self, ZERO):
            raise ValueError(f"resource is not sufficient to do operation: "
                             f"<{self}> sub <{rr}>")
        self.cpu -= rr.cpu
        self.memory -= rr.memory
        for n, q in rr.scalars.items():
            if n in self.scalars:
                self.scalars[n] -= q
        return self

    # -- comparisons --------------------------------------------------------

    def _paired_dims(self, rr: "Resource", default: str) -> Iterable[Tuple[float, float]]:
        """Yield (left, right) for every scalar dimension of the union, with
        missing dimensions replaced by the default (0 or infinity), mirroring
        setDefaultValue (resource_info.go:457-487)."""
        fill = 0.0 if default == ZERO else _INF
        for n in set(self.scalars) | set(rr.scalars):
            yield (self.scalars.get(n, fill), rr.scalars.get(n, fill))

    def less_equal(self, rr: "Resource", default: str = ZERO) -> bool:
        """LessEqualInAllDimension (resource_info.go:310-343)."""
        if not (_le_eps(self.cpu, rr.cpu) and _le_eps(self.memory, rr.memory)):
            return False
        for lv, rv in self._paired_dims(rr, default):
            if rv == _INF:
                continue
            if lv == _INF or not _le_eps(lv, rv):
                return False
        return True

    def __repr__(self) -> str:
        s = f"cpu {self.cpu:0.2f}, memory {self.memory:0.2f}"
        for n, q in sorted(self.scalars.items()):
            s += f", {n} {q:0.2f}"
        return s

    # -- dense-vector bridge ------------------------------------------------

    def to_vector(self, names: "ResourceNames") -> np.ndarray:
        v = np.zeros(len(names), dtype=np.float32)
        for i, n in enumerate(names.names):
            v[i] = self.get(n)
        return v


class ResourceNames:
    """Fixed dimension registry for one snapshot: resource name → column.

    Columns 0/1 are always cpu/memory; scalar resources discovered in the
    snapshot follow in sorted order, so every tensor built from the same
    snapshot agrees on the layout.
    """

    def __init__(self, scalar_names: Iterable[str] = ()):
        self.names: List[str] = [CPU, MEMORY] + sorted(set(scalar_names) - {CPU, MEMORY})
        self.index: Dict[str, int] = {n: i for i, n in enumerate(self.names)}

    def __len__(self) -> int:
        return len(self.names)

    @classmethod
    def discover(cls, resources: Iterable[Resource]) -> "ResourceNames":
        scalars = set()
        for r in resources:
            scalars.update(r.scalars)
        return cls(scalars)
