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
PODS = "pods"

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

    @classmethod
    def from_dict(cls, rl: Dict[str, object]) -> "Resource":
        """Build from a resource-list style dict, e.g. ``{"cpu": "2",
        "memory": "4Gi", "nvidia.com/gpu": 1, "pods": 110}`` (NewResource,
        resource_info.go:68-87); scalar resources are kept in milli-units,
        as CPU is."""
        r = cls()
        for name, q in rl.items():
            if name == CPU:
                r.cpu += parse_quantity(q) * 1000.0
            elif name == MEMORY:
                r.memory += parse_quantity(q)
            elif name == PODS:
                r.max_task_num = int(parse_quantity(q)) \
                    + (r.max_task_num or 0)
            else:
                r.scalars[name] = r.scalars.get(name, 0.0) \
                    + parse_quantity(q) * 1000.0
        return r

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

    def set(self, name: str, value: float) -> None:
        if name == CPU:
            self.cpu = value
        elif name == MEMORY:
            self.memory = value
        else:
            self.scalars[name] = value

    def resource_names(self) -> List[str]:
        return [CPU, MEMORY] + list(self.scalars)

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

    def multi(self, ratio: float) -> "Resource":
        self.cpu *= ratio
        self.memory *= ratio
        for n in self.scalars:
            self.scalars[n] *= ratio
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

    def less(self, rr: "Resource", default: str = ZERO) -> bool:
        """LessInAllDimension — strict, no epsilon (resource_info.go:278-308)."""
        if not (self.cpu < rr.cpu and self.memory < rr.memory):
            return False
        for lv, rv in self._paired_dims(rr, default):
            if rv == _INF:
                continue
            if lv == _INF or not lv < rv:
                return False
        return True

    def less_in_some_dimension(self, rr: "Resource") -> bool:
        """True if any dimension of self is below rr
        (resource_info.go:345-370)."""
        if self.cpu < rr.cpu or self.memory < rr.memory:
            return True
        for n, q in self.scalars.items():
            if n in rr.scalars and q < rr.scalars[n]:
                return True
        for n, q in rr.scalars.items():
            if n not in self.scalars and q > MIN_RESOURCE:
                return True
        return False

    def __eq__(self, rr: object) -> bool:
        """Equal in every dimension within 1e-9 (the drift verifier's
        comparison of a cached clone with the live node)."""
        if not isinstance(rr, Resource):
            return NotImplemented
        names = set(self.resource_names()) | set(rr.resource_names())
        return all(abs(self.get(n) - rr.get(n)) < 1e-9 for n in names)

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

    def to_vector_inf_fill(self, names: "ResourceNames") -> np.ndarray:
        """Like to_vector but missing scalar dims become +inf — used for queue
        capabilities, where an unspecified dimension means unlimited."""
        v = np.full(len(names), np.inf, dtype=np.float32)
        v[0] = self.cpu
        v[1] = self.memory
        for i, n in enumerate(names.names):
            if n in self.scalars:
                v[i] = self.scalars[n]
        return v

    @classmethod
    def from_vector(cls, v: np.ndarray, names: "ResourceNames") -> "Resource":
        r = cls()
        for i, n in enumerate(names.names):
            if float(v[i]) != 0.0:
                r.set(n, float(v[i]))
        r.cpu = float(v[0])
        r.memory = float(v[1])
        return r


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


_SUFFIXES = {
    "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50,
    "Ei": 2**60,
}


def parse_quantity(q: object) -> float:
    """Parse a Kubernetes quantity ('100m', '4Gi', '2', 1.5) to a float.
    The 'm' suffix is milli, so '100m' is 0.1; a caller that wants
    milli-CPU multiplies by 1000."""
    if isinstance(q, (int, float)):
        return float(q)
    s = str(q).strip()
    if s.endswith("m") and s[:-1].replace(".", "").replace("-", "").isdigit():
        return float(s[:-1]) / 1000.0
    for suf in sorted(_SUFFIXES, key=len, reverse=True):
        if s.endswith(suf):
            return float(s[: -len(suf)]) * _SUFFIXES[suf]
    return float(s)
