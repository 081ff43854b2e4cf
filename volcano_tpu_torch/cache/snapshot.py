"""Snapshot → dense tensor marshaling for the allocate solve.

The reference's hot loops iterate (pending task × node) pairs through plugin
callbacks (util.PredicateNodes / PrioritizeNodes,
pkg/scheduler/util/scheduler_helper.go:71-192). Here the
session is materialized once per solve into:

- per-node state tensors f32[N,R] (idle/used/releasing/pipelined/
  allocatable) and i32[N] pod counts, limits and zone codes, on the
  session's device,
- per-task request rows f32[T,R],
- a static feasibility mask bool[T,N] and a static score matrix f32[T,N]
  from plugin contributions (None when every plugin abstains),
- ScoreWeights for the in-kernel dynamic scorers.

Node rows come either from a fresh ``NodeTensors`` (rows built in NumPy,
copied to the device once, in snapshot order) or from the cache's
``PersistentNodeTensors``, which survive across cycles: host mirrors
updated row by row from the snapshot's dirty set, device rows replaced by
an out-of-place ``index_copy`` of the changed rows, and a stable row per
node with holes where nodes left.
"""

from __future__ import annotations

import heapq
import time
import zlib
from typing import Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from .. import metrics
from ..api import NodeInfo, Resource, ResourceNames, TaskInfo
from ..ops.scores import ScoreWeights

BIG_MAX_TASKS = 1 << 30

# the per-node row fields, host and device alike: five f32[N,R] resource
# planes, then the i32[N] pod limit, pod count and zone code
RES_FIELDS = ("idle", "used", "releasing", "pipelined", "allocatable")
ROW_FIELDS = RES_FIELDS + ("max_tasks", "ntasks", "zone_code")


def zone_code(zone: str) -> int:
    """Stable i32 code for a topology-zone name (0 = unzoned): crc32 is
    content-addressed, so codes survive restarts and row churn; consumers
    compare codes for equality only."""
    if not zone:
        return 0
    return (zlib.crc32(zone.encode("utf-8")) & 0x7FFFFFFF) or 1


def _empty_rows(N: int, R: int) -> Dict[str, np.ndarray]:
    rows = {f: np.zeros((N, R), np.float32) for f in RES_FIELDS}
    for f in ("max_tasks", "ntasks", "zone_code"):
        rows[f] = np.zeros(N, np.int32)
    return rows


def _write_row(rows: Dict[str, np.ndarray], i: int, node: NodeInfo,
               rnames: ResourceNames) -> None:
    rows["idle"][i] = node.idle.to_vector(rnames)
    rows["used"][i] = node.used.to_vector(rnames)
    rows["releasing"][i] = node.releasing.to_vector(rnames)
    rows["pipelined"][i] = node.pipelined.to_vector(rnames)
    rows["allocatable"][i] = node.allocatable.to_vector(rnames)
    rows["max_tasks"][i] = (node.max_task_num if node.max_task_num > 0
                            else BIG_MAX_TASKS)
    rows["ntasks"][i] = len(node.tasks)
    rows["zone_code"][i] = zone_code(node.topology_zone)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    # a copy that never aliases the host array, which PersistentNodeTensors
    # mutates in place on every refresh; on the card through pinned memory
    # and without synchronizing the host, so a speculative refresh queues
    # its scatter behind the solve it feeds
    from ..ops.place import upload
    return upload(a, torch.device(device))


def _row_property(field: str) -> property:
    return property(lambda self: self._rows()[field],
                    doc=f"the device rows of ``{field}``")


class _DeviceRows:
    """The device surface every solve reads (NodeTensors' attributes):
    one tensor a row field, plus ``future_idle``."""

    idle = _row_property("idle")
    used = _row_property("used")
    releasing = _row_property("releasing")
    pipelined = _row_property("pipelined")
    allocatable = _row_property("allocatable")
    max_tasks = _row_property("max_tasks")
    ntasks = _row_property("ntasks")
    zone_code = _row_property("zone_code")
    _device: Optional[Dict[str, torch.Tensor]] = None
    _future_idle: Optional[torch.Tensor] = None

    def _rows(self) -> Dict[str, torch.Tensor]:
        return self._device

    @property
    def future_idle(self) -> torch.Tensor:
        if self._future_idle is None:
            rows = self._rows()
            # FutureIdle = Idle + Releasing - Pipelined (node_info.go), in
            # f32 and in this order, like the JAX package's NodeState
            self._future_idle = (rows["idle"] + rows["releasing"]
                                 - rows["pipelined"])
        return self._future_idle


class NodeTensors(_DeviceRows):
    """Dense node-state tensors on ``device``, index-aligned with ``names``
    (snapshot order), built fresh for one solve."""

    def __init__(self, nodes: Sequence[NodeInfo], rnames: ResourceNames,
                 device: torch.device):
        self.rnames = rnames
        self.names: List[str] = [n.name for n in nodes]
        self.index: Dict[str, int] = {n: i for i, n in enumerate(self.names)}
        host = _empty_rows(len(nodes), len(rnames))
        for i, n in enumerate(nodes):
            _write_row(host, i, n, rnames)
        self._device = {f: _upload(a, device) for f, a in host.items()}


class TensorEpochView(_DeviceRows):
    """One pinned epoch of the persistent tensors: the device rows as they
    were when pinned (later scatters publish new tensors, out of place, so
    these stay), copies of the host mirrors and the row maps. Duck-types
    the ``NodeTensors`` surface a solve reads. Release it through
    ``PersistentNodeTensors.retire_epoch``."""

    def __init__(self, owner: "PersistentNodeTensors", epoch: int,
                 device: Dict[str, torch.Tensor], names: List[str],
                 index: Dict[str, int], rnames: ResourceNames,
                 host: Dict[str, np.ndarray]):
        self._owner = owner
        self.epoch = epoch
        self._device = device
        self.names = names
        self.index = index
        self.rnames = rnames
        self.host = host
        self.retired = False


class PersistentNodeTensors(_DeviceRows):
    """NodeTensors that survive across scheduling cycles.

    The host NumPy mirrors (``host``) stay authoritative and are updated
    row by row from the dirty set; the device rows are replaced by an
    out-of-place ``index_copy`` of the changed rows instead of a re-upload
    of f32[N,R] every cycle. A node keeps a STABLE row: a removed node
    leaves a neutralized hole (all-zero row, ``max_tasks`` 0, name ""),
    which the solves can never select (``ntasks < max_tasks`` fails), and
    the next added node takes the lowest hole. Row order, and with it the
    argmax tie-break among equal scores, therefore follows the holes, not
    the snapshot order: decisions equal the JAX package's
    ``PersistentNodeTensors`` (``volcano_tpu/cache/snapshot.py``), which
    this class ports.

    A refresh rebuilds every row in snapshot order when the delta exceeds
    ``rebuild_ratio`` of the rows or more nodes arrive than holes exist.

    ``epoch`` counts device publishes (every scatter or full rebuild);
    ``pin_epoch`` hands a caller a frozen ``TensorEpochView``, and later
    publishes leave the pinned tensors untouched."""

    def __init__(self, rnames: ResourceNames, device: torch.device,
                 rebuild_ratio: float = 0.5):
        self.rnames = rnames
        self.device = torch.device(device)
        self.rebuild_ratio = rebuild_ratio
        self.names: List[str] = []
        self.index: Dict[str, int] = {}
        self._free: List[int] = []           # heap of hole rows
        self.host = _empty_rows(0, len(rnames))
        self._device: Optional[Dict[str, torch.Tensor]] = None
        self.last_refresh: Dict[str, object] = {}
        self.epoch = 0
        self.live_pins = 0

    def _clear_row(self, i: int) -> None:
        for a in self.host.values():
            a[i] = 0                         # max_tasks 0: never selectable

    def full_build(self, nodes: Dict[str, NodeInfo]) -> None:
        """Rebuild every row in snapshot order, equal to a fresh
        ``NodeTensors(list(nodes.values()), rnames, device)``."""
        self.names = list(nodes)
        self.index = {n: i for i, n in enumerate(self.names)}
        self._free = []
        self.host = _empty_rows(len(self.names), len(self.rnames))
        for i, node in enumerate(nodes.values()):
            _write_row(self.host, i, node, self.rnames)
        self._device = None
        self._future_idle = None
        self.epoch += 1                      # publish: the next upload

    def refresh(self, nodes: Dict[str, NodeInfo],
                changed: Set[str]) -> Dict[str, object]:
        """Apply one snapshot delta. ``nodes`` is the snapshot's node dict
        (ready nodes only); ``changed`` the names whose rows may differ.
        Returns the refresh stats ({"full": bool, "rows": int, "host_s"})."""
        t0 = time.perf_counter()
        removed = [n for n in self.index if n not in nodes]
        added = [n for n in nodes if n not in self.index]
        touch = [n for n in changed if n in self.index]
        delta = len(removed) + len(added) + len(touch)
        base = len(self.index)
        full = (base == 0
                or delta / base > self.rebuild_ratio
                or len(added) > len(removed) + len(self._free))
        if full:
            self.full_build(nodes)
            self.last_refresh = {"full": True, "rows": len(self.names),
                                 "host_s": time.perf_counter() - t0}
            return self.last_refresh
        rows: List[int] = []
        for name in removed:
            i = self.index.pop(name)
            self.names[i] = ""
            heapq.heappush(self._free, i)
            self._clear_row(i)
            rows.append(i)
        for name in added:
            i = heapq.heappop(self._free)
            self.index[name] = i
            self.names[i] = name
            _write_row(self.host, i, nodes[name], self.rnames)
            rows.append(i)
        for name in touch:
            if name not in nodes:
                # changed, then removed before this refresh: its row is a
                # hole now. The JAX package indexes it anyway, and its
                # KeyError leaves the rows half applied (ROADMAP §3); the
                # rebuild test above still counts it as the JAX one does.
                continue
            i = self.index[name]
            _write_row(self.host, i, nodes[name], self.rnames)
            rows.append(i)
        host_s = time.perf_counter() - t0
        if rows:
            self._scatter_device(np.asarray(sorted(rows), np.int64))
        self.last_refresh = {"full": False, "rows": len(rows),
                             "host_s": host_s}
        return self.last_refresh

    # -- device residency ---------------------------------------------------

    def _scatter_device(self, rows: np.ndarray) -> None:
        """Publish the host rows ``rows`` to the device. ``index_copy`` is
        out of place: every field gets a NEW tensor, so a pinned
        ``TensorEpochView`` keeps reading the epoch before the scatter."""
        if self._device is None:
            return                           # the first read uploads
        idx = _upload(rows, self.device)
        dev = self._device
        for f in ROW_FIELDS:
            dev[f] = dev[f].index_copy(0, idx,
                                       _upload(self.host[f][rows],
                                               self.device))
        self._future_idle = None
        self.epoch += 1

    def _ensure_device(self) -> Dict[str, torch.Tensor]:
        if self._device is None:
            self._device = {f: _upload(a, self.device)
                            for f, a in self.host.items()}
            self._future_idle = None
        return self._device

    _rows = _ensure_device

    # -- epoch pair ---------------------------------------------------------

    def pin_epoch(self) -> TensorEpochView:
        """Freeze the current epoch: the device tensors (later publishes
        replace them, out of place), copies of the host mirrors, and the
        row maps. Pair every pin with ``retire_epoch``."""
        view = TensorEpochView(
            self, self.epoch, dict(self._ensure_device()), list(self.names),
            dict(self.index), self.rnames,
            {f: a.copy() for f, a in self.host.items()})
        self.live_pins += 1
        metrics.set_tensor_epochs_live(self.live_pins)
        return view

    def retire_epoch(self, view: Optional[TensorEpochView]) -> None:
        """Release one pinned epoch (idempotent per view)."""
        if view is None or view.retired:
            return
        view.retired = True
        self.live_pins = max(self.live_pins - 1, 0)
        metrics.set_tensor_epochs_live(self.live_pins)

    def prewarm_epoch_pair(self) -> None:
        """Pay the epoch pair's cold costs before the first pipelined
        cycle: the first device upload, the pinned view's host copies and
        its future-idle rows allocate here, so ``pin_epoch`` on the live
        path is bookkeeping and copies of warm sizes. A no-op without
        rows."""
        if not self.names:
            return
        view = self.pin_epoch()
        try:
            view.future_idle
        finally:
            self.retire_epoch(view)


# what a hole row of the persistent tensors stands for: unschedulable, empty
_HOLE_NODE = NodeInfo(name="", unschedulable=True)


def sharded_node_layout(node_t, D: int):
    """The node rows of a solve padded on their device to a multiple of
    the mesh size ``D`` (the JAX package's snapshot.py:103): the sharded
    solve splits the node axis into D equal blocks of rows, shard s owning
    rows s*N/D ... (ops/blocks.py). Pad rows have zero capacity and
    ``max_tasks`` 0, so no solve selects them, at any D. A mesh change (a
    heal or a readmission) retires the tensor epoch first, and the next
    solve re-pads the rebuilt rows at the new D. Returns ``(NodeState,
    allocatable, max_tasks, n_pad)``; with no padding the tensors are the
    node rows themselves."""
    from ..ops.blocks import NodeState
    state = NodeState(node_t.idle, node_t.future_idle, node_t.used,
                      node_t.ntasks)
    alloc, maxt = node_t.allocatable, node_t.max_tasks
    n_pad = (-state.idle.shape[0]) % D
    if n_pad:
        rows = torch.nn.functional.pad
        state = NodeState(rows(state.idle, (0, 0, 0, n_pad)),
                          rows(state.future_idle, (0, 0, 0, n_pad)),
                          rows(state.used, (0, 0, 0, n_pad)),
                          rows(state.ntasks, (0, n_pad)))
        alloc = rows(alloc, (0, 0, 0, n_pad))
        maxt = rows(maxt, (0, n_pad))
    return state, alloc, maxt, n_pad


def node_infos_for(ssn, node_t) -> List[NodeInfo]:
    """Session NodeInfos row-aligned with ``node_t.names`` — what plugin
    mask and score builders iterate. Persistent rows freed by node removal
    are holes (name ""); they map to one shared inert NodeInfo, so builders
    stay index-aligned without hole handling of their own. A hole column is
    unselectable in the solve regardless: its row is zeroed with
    ``max_tasks`` 0."""
    nodes = ssn.nodes
    return [nodes.get(name, _HOLE_NODE) for name in node_t.names]


def discover_resource_names(nodes: Sequence[NodeInfo],
                            tasks: Sequence[TaskInfo]) -> ResourceNames:
    rs: List[Resource] = [n.allocatable for n in nodes]
    rs += [t.resreq for t in tasks]
    return ResourceNames.discover(rs)


def task_requests(tasks: Sequence[TaskInfo], rnames: ResourceNames) -> np.ndarray:
    T, R = len(tasks), len(rnames)
    req = np.zeros((T, R), np.float32)
    for i, t in enumerate(tasks):
        req[i] = t.init_resreq.to_vector(rnames)
    return req


def assemble_feasibility(ssn, tasks: Sequence[TaskInfo],
                         node_t: NodeTensors) -> Optional[np.ndarray]:
    """AND of all plugin feasibility contributions. Returns None when every
    plugin abstained (the mask would be all-true) so the solve skips the
    [T,N] transfer entirely."""
    mask = None
    for fn in ssn.feasibility_fns.values():
        m = fn(ssn, tasks, node_t)
        if m is None:
            continue
        mask = m if mask is None else (mask & m)
    return mask


def assemble_static_score(ssn, tasks: Sequence[TaskInfo],
                          node_t: NodeTensors) -> Optional[np.ndarray]:
    """Sum of static score matrices; None when every plugin abstained (a
    constant-zero matrix) so the solve skips the [T,N] transfer."""
    score = None
    for fn in ssn.static_score_fns.values():
        s = fn(ssn, tasks, node_t)
        if s is None:
            continue
        s = s.astype(np.float32)
        score = s if score is None else (score + s)
    return score


def assemble_weights(ssn, rnames: ResourceNames) -> ScoreWeights:
    """Merge plugin weight contributions into one ScoreWeights. Plugins set
    e.g. {'binpack_weight': 1, 'binpack_res': {...}} or {'least_req_weight': 1}
    via ssn.set_dynamic_score_weights."""
    binpack_res = np.zeros(len(rnames), np.float32)
    vals = {"binpack_weight": 0.0, "least_req_weight": 0.0,
            "most_req_weight": 0.0, "balanced_weight": 0.0}
    for w in ssn.dynamic_score_weights.values():
        for k in vals:
            vals[k] += float(w.get(k, 0.0))
        for rname, rw in (w.get("binpack_res") or {}).items():
            if rname in rnames.index:
                binpack_res[rnames.index[rname]] += float(rw)
    return ScoreWeights(binpack_weight=vals["binpack_weight"],
                        binpack_res=binpack_res,
                        least_req_weight=vals["least_req_weight"],
                        most_req_weight=vals["most_req_weight"],
                        balanced_weight=vals["balanced_weight"])
