"""Host side of the eviction engines (engine ``tpu`` of preempt and
reclaim).

PREEMPT assembles victim/preemptor tensors, precomputes per-tier
per-plugin veto masks through the real plugin callbacks, runs the victim
walk (ops/evict.py: the CUDA kernel on the card, its plain version on the
CPU) with one upload and one packed fetch, and replays the proposals on the
host — through genuine Statements with live-chain re-validation for
custom-plugin confs, or the batched fast replay (aggregated deltas plus the
live gang job_pipelined gate) for stock confs. Victims ship in a dense
node-major ``[N, W]`` slot layout; every resource quantity is gcd-scaled to
exact small integers and node preferences travel as dense ranks of host-f64
scores, which is what makes the walk's decisions equal the callback
engine's.

Preempt's fixed-order caveat: queue/job order is computed once per action
on the opening snapshot — exact for the reference's preempt, whose
per-queue loop processes each starving job's tasks contiguously.

RECLAIM runs the literal callback rotation (reclaim.py) through the
conservative vectorized node screener below (_ReclaimScreener): the
reference's one-task-per-queue-pop rotation re-orders jobs and queues
between pops, which no fixed-order device batching reproduces, so reclaim
keeps the rotation on the host and vectorizes only the per-attempt node
walk. Exact by construction.

Mirrors volcano_tpu/actions/evict_tpu.py without its node-sharded walk,
its compile prewarm and its pow2 shape padding (which existed only for
XLA's compile cache). The conformance plugin's victim rule (no critical
pod is a victim of its tier) is one of the tier stack's fast paths, and
the tiered dispatch is upstream's, not the JAX package's: once a plugin
returned victims, a later veto leaves the node none (ROADMAP §3). The elastic
gangs' victim tier is in: an elastic gang's above-min members lead the
eviction order (``_elastic_victims_first``).
"""

from __future__ import annotations

import time
from functools import cmp_to_key
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import metrics
from ..api import PodGroupPhase, Resource, TaskInfo, TaskStatus
from ..cache.snapshot import (NodeTensors, assemble_feasibility,
                              assemble_static_score, assemble_weights,
                              discover_resource_names)
from ..elastic_gang.membership import is_elastic, shrink_allowance
from ..framework.session import ABSTAIN
from ..obs import trace as obs_trace
from ..ops.evict import (BIG, MAX_R, MAX_W, NO_NODE, EvictNW, WalkInputs,
                         pad_nodes, to_device, walk)
from ..ops.scores import combined_dynamic_score
from ..utils import PriorityQueue

# transient-memory budget of the dense layout, as in the JAX package: the
# reference materializes [N, W, W] and [N, W, W, R] tensors in its drf
# dispatch; the same shape rule picks the callbacks rung here
MAX_NWWR_ELEMS = 256 << 20


class _NodeAxis:
    """Node names and their row index: what the plugins' feasibility and
    static-score builders read of a node tensor set."""

    def __init__(self, nodes):
        self.names: List[str] = [n.name for n in nodes]
        self.index: Dict[str, int] = {n: i for i, n in enumerate(self.names)}


def _device_shape_ok(n_nodes: int, victims, n_res: int) -> bool:
    """The JAX package's shape rule (its slot width padded to a power of
    two, at least 8, as its budget counts it), plus the kernel's resource
    limit."""
    w = 8
    while w < _max_per_node(victims):
        w *= 2
    return (w <= MAX_W and n_res <= MAX_R
            and n_nodes * w * w * max(n_res, 1) <= MAX_NWWR_ELEMS)


def _res_rows_f64(resources, rnames) -> np.ndarray:
    """[M, R] float64 straight from the Resource doubles (to_vector would
    round through f32 first, destroying the integer exactness the scaled
    device arithmetic depends on)."""
    out = np.empty((len(resources), len(rnames)), np.float64)
    for k, n in enumerate(rnames.names):
        if n == "cpu":
            out[:, k] = [r.cpu for r in resources]
        elif n == "memory":
            out[:, k] = [r.memory for r in resources]
        else:
            out[:, k] = [r.scalars.get(n, 0.0) for r in resources]
    return out


def _dim_scale(vals: np.ndarray) -> np.ndarray:
    """Per-dimension GCD of every quantity the device will see.

    Dividing by it turns memory-scale values (~1e11 bytes, f32 ULP ~8e3 —
    far above the 0.1 epsilon the host Resource comparisons use) into small
    exact f32 integers, so every sum and fit comparison in the walk is exact
    rational arithmetic and decisions match the callback engine's f64.
    Dimensions with non-integral or overflowing values keep scale 1."""
    R = vals.shape[1]
    scale = np.ones(R, np.float64)
    for r in range(R):
        v = vals[:, r]
        v = v[np.isfinite(v) & (v != 0)]
        if v.size == 0:
            continue
        if not np.all(v == np.floor(v)) or np.any(np.abs(v) >= 2 ** 62):
            continue
        g = float(np.gcd.reduce(np.abs(v).astype(np.int64)))
        if g > 1:
            scale[r] = g
    return scale


class _EvictTensors:
    """The walk's resource inputs, including the [N, W] node-major victim
    slot layout, all divided by the per-dimension GCD ``self.scale``."""

    def __init__(self, ssn, victims: List[TaskInfo],
                 preemptors: List[TaskInfo]):
        self.victims = victims
        nodes = list(ssn.nodes.values())
        self.rnames = discover_resource_names(nodes, victims + preemptors)
        self.nodes = nodes
        self.node_t = _NodeAxis(nodes)
        idle64 = _res_rows_f64([n.idle for n in nodes], self.rnames)
        rel64 = _res_rows_f64([n.releasing for n in nodes], self.rnames)
        pip64 = _res_rows_f64([n.pipelined for n in nodes], self.rnames)
        alloc64 = _res_rows_f64([n.allocatable for n in nodes], self.rnames)
        vreq64 = _res_rows_f64([t.resreq for t in victims], self.rnames)
        preq64 = _res_rows_f64([t.init_resreq for t in preemptors],
                               self.rnames)
        self._jobs_order = list(ssn.jobs)
        jalloc64 = _res_rows_f64(
            [j.allocated for j in ssn.jobs.values()], self.rnames)
        self.scale = _dim_scale(np.vstack(
            [idle64, rel64, pip64, alloc64, vreq64, preq64, jalloc64]))
        self._fidle0 = ((idle64 + rel64 - pip64) / self.scale) \
            .astype(np.float32)
        self.alloc_total = (alloc64 / self.scale).sum(axis=0) \
            .astype(np.float32)
        self.jalloc_scaled = (jalloc64 / self.scale).astype(np.float32)
        self.preq = (preq64 / self.scale).astype(np.float32)
        self.vreq = (vreq64 / self.scale).astype(np.float32)
        self.vnode = np.asarray(
            [self.node_t.index[t.node_name] for t in victims], np.int32)
        V = len(victims)
        N = len(self.node_t.names)
        counts = np.bincount(self.vnode, minlength=N) if V else \
            np.zeros(N, np.int64)
        W = max(1, int(counts.max()) if V else 1)
        self.W = W
        # slot table: victims grouped per node, keeping list (eviction)
        # order within each row; V is the pad sentinel
        self.vslot = np.full((N, W), V, np.int32)
        if V:
            order = np.argsort(self.vnode, kind="stable")
            starts = np.r_[0, np.cumsum(counts)[:-1]]
            col = np.arange(V) - starts[self.vnode[order]]
            self.vslot[self.vnode[order], col] = order.astype(np.int32)
        self.valid_nw = self.vslot < V
        vreq_pad = np.vstack([self.vreq,
                              np.zeros((1, len(self.rnames)), np.float32)])
        self.vreq_nw = vreq_pad[self.vslot]

    def future_idle0(self):
        return self._fidle0

    def nw_inputs(self, vgroup: np.ndarray, n_groups: int,
                  vrank: Optional[np.ndarray]) -> EvictNW:
        """The EvictNW layout (host numpy). ``vgroup``: per-victim alloc
        group; pads point at the zeroed extra row ``n_groups``. ``vrank``:
        per-victim candidate-list rank for drf's subtraction order, None
        when no drf tier reads it."""
        N, W = self.vslot.shape
        group_pad = np.r_[vgroup.astype(np.int64), n_groups]
        group_nw = group_pad[self.vslot].astype(np.int32)
        if vrank is None:
            rank_nw = np.zeros((N, W), np.int32)
        else:
            rank_pad = np.r_[np.minimum(vrank.astype(np.int64), BIG), BIG]
            rank_nw = rank_pad[self.vslot].astype(np.int32)
        return EvictNW(vslot=self.vslot, valid=self.valid_nw,
                       vreq=self.vreq_nw, vgroup=group_nw, rank=rank_nw)

    def owner_nw_to_victims(self, owner_nw: np.ndarray) -> Dict[int, list]:
        """owner [N, W] (task index or -1) -> task index -> victims."""
        out: Dict[int, list] = {}
        flat_owner = owner_nw.reshape(-1)
        flat_slot = self.vslot.reshape(-1)
        V = len(self.victims)
        for k in np.flatnonzero(flat_owner >= 0):
            v = flat_slot[k]
            if v < V:
                out.setdefault(int(flat_owner[k]), []).append(
                    self.victims[v])
        return out


def _max_per_node(victims: List[TaskInfo]) -> int:
    """Largest victim count on any one node — the W of the [N, W] layout."""
    counts: Dict[str, int] = {}
    for t in victims:
        counts[t.node_name] = counts.get(t.node_name, 0) + 1
    return max(counts.values(), default=0)


def _segment_ends(is_last: np.ndarray) -> np.ndarray:
    """For each position, the index of its segment's last element, given a
    bool[P] marking segment-final positions."""
    ends = np.flatnonzero(is_last)
    return ends[np.searchsorted(ends, np.arange(len(is_last)))] \
        .astype(np.int32)


def _task_order_chain(ssn) -> List[str]:
    return [name for tier in ssn.tiers for opt in tier.plugins
            if opt.is_enabled("enabledTaskOrder")
            and (name := opt.name) in ssn.task_order_fns]


def _eviction_order(ssn, victims: List[TaskInfo]) -> List[TaskInfo]:
    """Reversed TaskOrderFn — lowest priority first (preempt.go:237-244),
    then the elastic victim tier moved to the front. Key sort when only the
    priority plugin orders tasks (Python's reverse=True is stable, so tie
    order matches the stable comparator sort); comparator sort
    otherwise."""
    chain = _task_order_chain(ssn)
    if chain == ["priority"]:
        return _elastic_victims_first(ssn, sorted(
            victims, key=lambda t: (-t.priority, t.creation_timestamp,
                                    t.uid), reverse=True))
    if not chain:
        return _elastic_victims_first(ssn, list(victims))

    def cmp(l, r):
        if ssn.task_order_fn(l, r):
            return 1
        if ssn.task_order_fn(r, l):
            return -1
        return 0
    return _elastic_victims_first(ssn, sorted(victims, key=cmp_to_key(cmp)))


def _elastic_victims_first(ssn, ordered: List[TaskInfo]) -> List[TaskInfo]:
    """The elastic victim tier: an elastic gang's above-min members are the
    cheapest victims, so they move to the front of the eviction order, each
    gang's highest-uid victims up to its shrink allowance (never a path
    below min: the live chain re-validates allowances on every attempt).
    The list comes back as it was when no elastic gang has an allowance."""
    allow: Dict[str, int] = {}
    for t in ordered:
        if t.job in allow:
            continue
        job = ssn.jobs.get(t.job)
        allow[t.job] = shrink_allowance(job) \
            if job is not None and is_elastic(job) else 0
    if not any(allow.values()):
        return ordered
    surplus = set()
    by_job: Dict[str, List[TaskInfo]] = {}
    for t in ordered:
        by_job.setdefault(t.job, []).append(t)
    for uid, ts in by_job.items():
        a = allow[uid]
        if a <= 0:
            continue
        for t in sorted(ts, key=lambda x: x.uid, reverse=True)[:a]:
            surplus.add(t.uid)
    front = [t for t in ordered if t.uid in surplus]
    rest = [t for t in ordered if t.uid not in surplus]
    return front + rest


def _collect_victims(ssn) -> List[TaskInfo]:
    """RUNNING victim candidates in node-iteration x node.tasks order — the
    candidate-list order every plugin dispatch sees."""
    out = []
    for node in ssn.nodes.values():
        for t in node.tasks.values():
            if t.status != TaskStatus.RUNNING or t.resreq.is_empty():
                continue
            if t.job in ssn.jobs and t.uid in ssn.jobs[t.job].tasks:
                out.append(ssn.jobs[t.job].tasks[t.uid])
    return out


def _rep_task(job) -> Optional[TaskInfo]:
    pend = job.task_status_index.get(TaskStatus.PENDING, {})
    for t in pend.values():
        if not t.resreq.is_empty():
            return t
    return None


def _is_critical(task) -> bool:
    from ..plugins.conformance import _is_critical as crit
    return crit(task)


class _TierStack:
    """Per-tier plugin veto masks for the walk's dispatch replay.

    kinds[i]: "static" | "drf" | "drf@k" (drf follows only the tier's
    first k static masks in conf order; ops/evict.py::tier_layout).
    masks[i]: tuple of (mask [PJ,V] bool, part [PJ] bool) for the STATIC
    plugins of tier i — drf's dynamic dominant-share verdict is computed in
    the walk from tracked state.

    The stock priority/gang/conformance callbacks have vectorized fast
    paths (they filter on per-victim attributes only: the owning job's
    priority — priority.go:44-117, gang.go:83-101 — and the critical-pod
    namespace and priority class, conformance.go:45-66); any other plugin
    runs the generic per-job dispatch through its real registered
    callback.

    cand_kind selects the candidate filter: "inter-queue" (preempt phase 1:
    same queue, different job — preempt.go:120) or "intra-job" (phase 2).
    """

    FAST = {"priority", "gang", "conformance"}

    def __init__(self, ssn, pjobs, victims, registry, flag, dynamic_name,
                 cand_kind: str):
        PJ, V = len(pjobs), len(victims)
        vjob_prio = np.asarray(
            [ssn.jobs[t.job].priority for t in victims], np.int64)
        jprio = np.asarray([j.priority for j in pjobs], np.int64)
        qnames = {name: i for i, name in enumerate(ssn.queues)}
        vqueue = np.asarray(
            [qnames.get(ssn.jobs[t.job].queue, -1) for t in victims],
            np.int64)
        jqueue = np.asarray([qnames.get(j.queue, -2) for j in pjobs],
                            np.int64)
        juids = {uid: i for i, uid in
                 enumerate(dict.fromkeys([t.job for t in victims]))}
        vjob_code = np.asarray([juids[t.job] for t in victims], np.int64)
        jjob_code = np.asarray([juids.get(j.uid, -1) for j in pjobs],
                               np.int64)

        if cand_kind == "inter-queue":
            self.cand_mask = ((vqueue[None, :] == jqueue[:, None])
                              & (vjob_code[None, :] != jjob_code[:, None]))
        elif cand_kind == "intra-job":
            self.cand_mask = vjob_code[None, :] == jjob_code[:, None]
        else:
            raise ValueError(cand_kind)

        reps = [_rep_task(j) for j in pjobs]
        has_rep = np.asarray([r is not None for r in reps], bool)

        def is_fast(name: str) -> bool:
            """Fast path only for the STOCK callbacks — a custom plugin
            registered under the same conf name must go through its real
            callback (identity check via the defining module)."""
            if name not in self.FAST:
                return False
            fn = registry.get(name)
            return getattr(fn, "__module__", "") == \
                f"volcano_tpu_torch.plugins.{name}"

        generic_names = [
            opt.name for tier in ssn.tiers for opt in tier.plugins
            if opt.is_enabled(flag) and opt.name in registry
            and opt.name != dynamic_name and not is_fast(opt.name)]
        cands_per_job = None
        vix = {t.uid: i for i, t in enumerate(victims)}
        if generic_names:
            cands_per_job = [
                [victims[v] for v in np.flatnonzero(self.cand_mask[j])]
                for j in range(PJ)]

        kinds: List[str] = []
        masks: List[tuple] = []
        for tier in ssn.tiers:
            entries = []
            has_dynamic = False
            dynamic_at = 0          # static entries before the dynamic
            for opt in tier.plugins:
                if not opt.is_enabled(flag):
                    continue
                if opt.name not in registry:
                    continue
                if opt.name == dynamic_name:
                    has_dynamic = True
                    dynamic_at = len(entries)
                else:
                    entries.append(opt.name)
            if not entries and not has_dynamic:
                continue
            tier_masks = []
            for name in entries:
                if not is_fast(name):
                    fn = registry[name]
                    m = np.zeros((PJ, V), bool)
                    part = np.zeros(PJ, bool)
                    for j in range(PJ):
                        if reps[j] is None:
                            continue
                        returned, vote = fn(reps[j], cands_per_job[j])
                        if vote == ABSTAIN:
                            continue
                        part[j] = True
                        for v in returned:
                            if v.uid in vix:
                                m[j, vix[v.uid]] = True
                elif name == "priority" or name == "gang":
                    # victims only from lower-priority jobs
                    m = (vjob_prio[None, :] < jprio[:, None]) \
                        & has_rep[:, None]
                    part = has_rep.copy()
                else:                       # conformance
                    crit = np.asarray([_is_critical(t) for t in victims],
                                      bool)
                    m = np.broadcast_to(~crit[None, :], (PJ, V)).copy() \
                        & has_rep[:, None]
                    part = has_rep.copy()
                tier_masks.append((m, part))
            # identical masks with the same participants in one tier merge
            # exactly: the intersection, the per-plugin non-empty counts and
            # the tier's first participant's verdict all coincide — the
            # deployed conf's priority and gang callbacks produce the same
            # lower-priority-job filter
            merged: List[tuple] = []
            lead = 0                # merged entries before the dynamic
            for e, (m, part) in enumerate(tier_masks):
                for m2, part2 in merged:
                    if (m2.shape == m.shape and np.array_equal(m2, m)
                            and np.array_equal(part2, part)):
                        break
                else:
                    merged.append((m, part))
                    lead += e < dynamic_at
            kind = "static"
            if has_dynamic:
                kind = (dynamic_name if lead == len(merged)
                        else f"{dynamic_name}@{lead}")
            kinds.append(kind)
            masks.append(tuple(merged))
        self.kinds = tuple(kinds)
        self.sizes = tuple(len(m) for m in masks)
        self.masks = tuple(masks)
        self.has_dynamic = any(
            k.partition("@")[0] == dynamic_name for k in self.kinds)
        # custom (non-stock) plugins participated: their live callbacks must
        # re-validate every proposal at replay (no batched fast replay)
        self.generic = bool(generic_names)

    def stacked(self):
        """(masks bool[M, PJ, V+1], part bool[M, PJ]) over all tiers in
        order; column V is the pad victim (always False)."""
        PJ, V = self.cand_mask.shape
        flat = [mp for tier in self.masks for mp in tier]
        if not flat:
            return (np.zeros((0, PJ, V + 1), bool), np.zeros((0, PJ), bool))
        return (np.stack([np.pad(m, ((0, 0), (0, 1))) for m, _ in flat]),
                np.stack([p for _, p in flat]))

    def padded_cand_mask(self):
        return np.pad(self.cand_mask, ((0, 0), (0, 1)))


def _drf_inputs(ssn, tensors: _EvictTensors, victims, need_group: bool):
    """(vjob, jalloc0 [AJ+1,R], total, vrank, job_index): the global job
    table for drf's share tracking in the walk; jalloc carries a zeroed pad
    row for pad slots. vrank is the candidate-list order rank
    (drf.go:308-330 within-dispatch subtraction order)."""
    job_index = {uid: i for i, uid in enumerate(tensors._jobs_order)}
    R = len(tensors.rnames)
    jalloc = np.vstack([tensors.jalloc_scaled,
                        np.zeros((1, R), np.float32)])
    total = tensors.alloc_total
    vjob = np.asarray([job_index[t.job] for t in victims], np.int32)
    vrank = None
    if need_group and victims:
        rank = {t.uid: i for i, t in enumerate(_collect_victims(ssn))}
        vrank = np.asarray([rank.get(t.uid, 0) for t in victims],
                           np.int64)
    return vjob, jalloc, total, vrank, job_index


def _stock_node_order_chain(ssn):
    """The enabled node-order chain when EVERY entry is a stock scorer with
    an exact f64 vectorization below — [(kind, plugin), ...] in tier order,
    or None when an unknown scorer participates. Matched by this package's
    own module names."""
    out = []
    for fn in ssn._enabled_fns(ssn.node_order_fns, "enabledNodeOrder"):
        mod = getattr(fn, "__module__", "")
        qn = getattr(fn, "__qualname__", "")
        owner = getattr(fn, "__self__", None)
        if mod == "volcano_tpu_torch.plugins.nodeorder" and \
                qn.endswith("._score") and owner is not None:
            out.append(("nodeorder", owner))
        elif mod == "volcano_tpu_torch.plugins.binpack" and \
                qn.endswith(".score") and owner is not None:
            out.append(("binpack", owner))
        else:
            return None
    return out


def _f64_rank_scores(ssn, rep_tasks, node_t) -> Optional[np.ndarray]:
    """f32[G, N] DENSE RANKS of the exact f64 node scores the callback
    engine computes.

    The callback path scores per (task, node) in Python doubles; shipping
    f32 scores flips near-ties, which picks a different (equal-fitness)
    node and therefore different victims. Ranks sidestep precision: the
    host replicates the stock scorers' arithmetic in f64, adds the live
    batch-scorer contributions and dense-ranks each row with NumPy (f64
    order; a torch.unique over f32 would lose it); the walk's argmax over
    ranks reproduces the exact f64 ordering with the same first-index
    tie-break as sort_nodes/select_best_node. Ranks < 2^24 are exact in
    f32. Returns None when a non-stock scorer or a preferred node-affinity
    term participates (callers use f32 scores)."""
    total = _f64_scores(ssn, rep_tasks, node_t)
    if total is None:
        return None
    G, N = total.shape
    ranks = np.empty((G, N), np.float32)
    for g in range(G):
        _, inv = np.unique(total[g], return_inverse=True)
        ranks[g] = inv.astype(np.float32)
    return ranks


def _f64_scores(ssn, rep_tasks, node_t) -> Optional[np.ndarray]:
    """f64[G, N] bit-exact replica of the callback scorer chain (see
    _f64_rank_scores)."""
    chain = _stock_node_order_chain(ssn)
    if chain is None:
        return None
    for task in rep_tasks:
        if (task.affinity.get("nodeAffinity", {})
                .get("preferredDuringSchedulingIgnoredDuringExecution")):
            return None            # per-node python term; no exact replica
    from ..plugins.podaffinity import session_has_pod_affinity
    if session_has_pod_affinity(ssn):
        # the batch pod-affinity scorer normalizes over the candidate
        # list, which differs per attempt — no exact replica
        return None
    nodes = [ssn.nodes[name] for name in node_t.names]
    N, G = len(nodes), len(rep_tasks)
    # a non-stock batch scorer may depend on the node LIST it is handed;
    # the stock taint scorer is per-node independent
    stock_batch = all(
        getattr(fn, "__module__", "") == "volcano_tpu_torch.plugins.nodeorder"
        for fn in ssn._enabled_fns(ssn.batch_node_order_fns,
                                   "enabledNodeOrder"))
    if not stock_batch:
        return None
    need_batch = any(n.taints for n in nodes)
    alloc_c = np.asarray([n.allocatable.cpu for n in nodes], np.float64)
    alloc_m = np.asarray([n.allocatable.memory for n in nodes], np.float64)
    used_c0 = np.asarray([n.used.cpu for n in nodes], np.float64)
    used_m0 = np.asarray([n.used.memory for n in nodes], np.float64)
    sc_safe = np.where(alloc_c != 0, alloc_c, 1.0)
    sm_safe = np.where(alloc_m != 0, alloc_m, 1.0)
    MAXS = 100.0                   # MAX_NODE_SCORE

    res_cache: Dict[str, tuple] = {}

    def res_vecs(rname):
        if rname not in res_cache:
            res_cache[rname] = (
                np.asarray([n.allocatable.get(rname) for n in nodes],
                           np.float64),
                np.asarray([n.used.get(rname) for n in nodes], np.float64))
        return res_cache[rname]

    total = np.zeros((G, N), np.float64)
    for g, task in enumerate(rep_tasks):
        row = np.zeros(N, np.float64)
        for kind, plugin in chain:
            if kind == "nodeorder":
                # NodeOrderPlugin._score in f64, same op order; the
                # node-affinity term is 0.0 here and x + 0.0 keeps every bit
                uc = used_c0 + task.resreq.cpu
                um = used_m0 + task.resreq.memory
                s = np.zeros(N, np.float64)
                if plugin.least_req_weight:
                    fc = np.where(alloc_c != 0,
                                  np.maximum(0.0, (alloc_c - uc) / sc_safe),
                                  0.0)
                    fm = np.where(alloc_m != 0,
                                  np.maximum(0.0, (alloc_m - um) / sm_safe),
                                  0.0)
                    s = s + plugin.least_req_weight * (fc + fm) / 2 * MAXS
                if plugin.most_req_weight:
                    fc = np.where(alloc_c != 0, uc / sc_safe, 0.0)
                    fm = np.where(alloc_m != 0, um / sm_safe, 0.0)
                    fc = np.where(fc > 1, 0.0, fc)
                    fm = np.where(fm > 1, 0.0, fm)
                    s = s + plugin.most_req_weight * (fc + fm) / 2 * MAXS
                if plugin.balanced_weight:
                    fc = np.where(alloc_c != 0,
                                  np.minimum(1.0, uc / sc_safe), 0.0)
                    fm = np.where(alloc_m != 0,
                                  np.minimum(1.0, um / sm_safe), 0.0)
                    mean = (fc + fm) / 2
                    std = (((fc - mean) ** 2 + (fm - mean) ** 2) / 2) ** 0.5
                    s = s + plugin.balanced_weight * (1.0 - std) * MAXS
                row = row + s
            else:                  # BinpackPlugin.score in f64
                s = np.zeros(N, np.float64)
                weight_sum = 0
                for rname in task.resreq.resource_names():
                    request = task.resreq.get(rname)
                    if request == 0:
                        continue
                    w = plugin.res_weights.get(rname)
                    if w is None:
                        continue
                    allocatable, used = res_vecs(rname)
                    ok = ((allocatable != 0) & bool(w != 0)
                          & (used + request <= allocatable))
                    safe = np.where(allocatable != 0, allocatable, 1.0)
                    s = s + np.where(ok, (used + request) * w / safe, 0.0)
                    weight_sum += w
                if weight_sum > 0:
                    s = s / weight_sum
                row = row + s * MAXS * plugin.weight
        # the batch taint scorer runs as the live python fn; skipped when
        # provably rank-constant (a taint-free cluster gets the same score
        # on every node)
        if need_batch:
            for name, s in (ssn.batch_node_order_fn(task, nodes)
                            or {}).items():
                ix = node_t.index.get(name)
                if ix is not None:
                    row[ix] = row[ix] + s
        total[g] = row
    return total


def _score_rows(ssn, ptasks, tensors: _EvictTensors, pjob_arr: np.ndarray):
    """One score row per same-request RUN instead of the full [P,N] matrix.

    Tasks are grouped into maximal runs with identical (job, request,
    feasibility row, static-score row): within a run every task's score row
    is identical, so the walk reads ``score_g`` f32[G,N] through ``run_id``
    i32[P]. Returns (preq, score_g — NumPy ranks, or a tensor on the
    session's device for the f32 path —, run_id, run_end)."""
    node_t = tensors.node_t
    preq = tensors.preq               # gcd-scaled exact integers
    feas = assemble_feasibility(ssn, ptasks, node_t)
    static = assemble_static_score(ssn, ptasks, node_t)

    P = len(ptasks)
    same = np.zeros(P, bool)
    if P > 1:
        same[1:] = np.all(preq[1:] == preq[:-1], axis=-1)
        same[1:] &= pjob_arr[1:] == pjob_arr[:-1]
        for arr in (feas, static):
            if arr is not None:
                same[1:] &= np.all(arr[1:] == arr[:-1], axis=-1)
    run_id = (np.cumsum(~same) - 1).astype(np.int32)
    rep = np.flatnonzero(~same)                      # run-start indices
    run_end = _segment_ends(np.r_[~same[1:], True])

    ranks = None
    if static is None:
        ranks = _f64_rank_scores(ssn, [ptasks[i] for i in rep], node_t)
    if ranks is not None:
        if feas is not None:
            ranks = np.where(feas[rep], ranks, -np.inf).astype(np.float32)
        return preq, ranks, run_id, run_end

    # the f32 path: the dynamic scorers on the device, plus the static rows
    dev = ssn.device
    full_t = NodeTensors(tensors.nodes, tensors.rnames, dev)
    weights = assemble_weights(ssn, tensors.rnames)
    # the scorers want the original units
    preq_units = (preq[rep].astype(np.float64)
                  * tensors.scale[None, :]).astype(np.float32)
    score_g = combined_dynamic_score(torch.tensor(preq_units, device=dev),
                                     full_t.used, full_t.allocatable, weights)
    if feas is not None or static is not None:
        N = len(node_t.names)
        s = (np.zeros((len(rep), N), np.float32) if static is None
             else static[rep].astype(np.float32))
        ms = s if feas is None else np.where(feas[rep], s, -np.inf) \
            .astype(np.float32)
        score_g = score_g + torch.tensor(ms, device=dev)
    return preq, score_g, run_id, run_end


def _starving_jobs(ssn):
    """(phase1_order, under_request): starving jobs grouped per queue in job
    order for the inter-job phase, plus the same jobs in plain ssn.jobs
    iteration order — the reference's ``underRequest`` list that drives the
    intra-job pass (preempt.go:46-81,146)."""
    per_queue: Dict[str, PriorityQueue] = {}
    under_request = []
    for job in ssn.jobs.values():
        if job.podgroup.phase == PodGroupPhase.PENDING:
            continue
        vr = ssn.job_valid(job)
        if vr is not None and not vr.passed:
            continue
        if job.queue not in ssn.queues:
            continue
        if ssn.job_starving(job):
            per_queue.setdefault(job.queue,
                                 PriorityQueue(ssn.job_order_fn)).push(job)
            under_request.append(job)
    ordered = []
    for q in per_queue.values():
        while not q.empty():
            ordered.append(q.pop())
    return ordered, under_request


def _pending_in_order(ssn, job) -> List[TaskInfo]:
    """Pending tasks in TaskOrderFn order — the allocate engine's
    _pending_tasks."""
    from .allocate import _pending_tasks
    return _pending_tasks(ssn, job)


def execute_preempt_tpu(ssn, sharded: bool = False) -> Dict[str, float]:
    """Device preempt: phase 1 inter-job (gang statements), phase 2
    intra-job, then the host victim_tasks pass. ``sharded`` (engine
    tpu-sharded) runs each walk node-sharded over the health-filtered mesh
    of slots (``_walk_shards``); its decisions are the single walk's. A
    shape the dense layout cannot hold (more than MAX_W victims on one
    node, more than MAX_R resources, or past the N·W²·R budget) runs the
    callbacks engine — a decision by shape, as the JAX package makes it.

    Returns each walked phase's ("p1", "p2") host wall seconds — assemble,
    solve (upload, walk, one packed fetch), replay — and its evaluated
    tasks ("p1_steps")."""
    victims = _eviction_order(ssn, _collect_victims(ssn))
    # R for the shape gate is the UNION of resource names the walk will
    # see; pending tasks over-approximate preemptors
    names = set()
    for n in ssn.nodes.values():
        names.update(n.allocatable.resource_names())
    for v in victims:
        names.update(v.resreq.resource_names())
    for job in ssn.jobs.values():
        for t in job.task_status_index.get(TaskStatus.PENDING, {}).values():
            names.update(t.resreq.resource_names())
    stats: Dict[str, float] = {}
    if not _device_shape_ok(len(ssn.nodes), victims, len(names)):
        from .preempt import PreemptAction
        PreemptAction(engine="callbacks")._execute_callbacks(ssn)
        return stats
    pjobs, under_request = _starving_jobs(ssn)
    # a job with NO same-queue foreign victim can never preempt: its
    # candidate row is empty for every tier, so pruning it is exact
    vq_count: Dict[str, int] = {}
    vq_own: Dict[tuple, int] = {}
    for v in victims:
        q = ssn.jobs[v.job].queue
        vq_count[q] = vq_count.get(q, 0) + 1
        vq_own[(q, v.job)] = vq_own.get((q, v.job), 0) + 1
    pjobs = [j for j in pjobs
             if vq_count.get(j.queue, 0)
             - vq_own.get((j.queue, j.uid), 0) > 0]
    if pjobs and victims:
        _preempt_phase(ssn, pjobs, victims, True, stats, sharded)
    # phase 2: within-job preemption, one pass in underRequest order
    # (preempt.go:146-183) — only jobs that still have pending tasks AND
    # own running victims can act (victims re-collected: phase 1 may have
    # flipped RUNNING tasks to RELEASING)
    pjobs2 = [j for j in under_request
              if j.task_status_index.get(TaskStatus.PENDING)
              and j.task_status_index.get(TaskStatus.RUNNING)]
    if pjobs2:
        victims2 = _eviction_order(ssn, _collect_victims(ssn))
        if victims2:
            _preempt_phase(ssn, pjobs2, victims2, False, stats, sharded)
    _victim_tasks_host(ssn)
    return stats


def _walk_shards(ssn) -> int:
    """The sharded walk's shard count: the process's slots on the
    session's device that the health lattice has not quarantined (preempt
    rides allocate's health-filtered mesh, evict_tpu.py:1005-1024); 1 when
    one or none is left, where the single walk runs, with the same
    decisions."""
    from ..device_health import DEVICE_HEALTH
    from ..ops.unified import devices, make_mesh
    slots = list(devices(ssn.device))
    live = set(DEVICE_HEALTH.healthy_devices([s.id for s in slots]))
    healthy = [s for s in slots if s.id in live]
    return make_mesh(healthy or slots[:1]).size


def _preempt_phase(ssn, pjobs, victims, inter_job: bool,
                   stats: Dict[str, float], sharded: bool = False) -> None:
    t0 = time.perf_counter()
    ptasks: List[TaskInfo] = []
    pjob_ix: List[int] = []
    first: List[bool] = []
    kept_jobs = []
    for job in pjobs:
        tasks = _pending_in_order(ssn, job)
        if not tasks:
            continue
        jx = len(kept_jobs)
        kept_jobs.append(job)
        for k, t in enumerate(tasks):
            ptasks.append(t)
            pjob_ix.append(jx)
            first.append(k == 0)
    if not ptasks:
        return

    if inter_job:
        cand_kind = "inter-queue"
        needed_j = np.asarray(
            [max(0, j.min_available - j.ready_task_num()
                 - j.waiting_task_num()) for j in kept_jobs], np.int32)
    else:
        cand_kind = "intra-job"
        needed_j = np.full(len(kept_jobs), BIG, np.int32)

    stack = _TierStack(ssn, kept_jobs, victims, ssn.preemptable_fns,
                       "enabledPreemptable", "drf", cand_kind)
    tensors = _EvictTensors(ssn, victims, ptasks)
    pjob_arr = np.asarray(pjob_ix, np.int32)
    preq, score_g, run_id, run_end = _score_rows(ssn, ptasks, tensors,
                                                 pjob_arr)
    first_np = np.asarray(first, bool)
    job_end = _segment_ends(np.r_[first_np[1:], True])
    vjob, jalloc0, total, vrank, job_index = _drf_inputs(
        ssn, tensors, victims, need_group=stack.has_dynamic)
    nw = tensors.nw_inputs(vjob, len(job_index), vrank)
    pjg_job = np.asarray([job_index[j.uid] for j in kept_jobs], np.int32)
    pjg = pjg_job[pjob_arr]
    # pipeline quota keyed by alloc-group index
    needed = np.zeros(len(job_index) + 1, np.float32)
    needed[pjg_job] = needed_j
    masks, part = stack.stacked()
    inputs = WalkInputs(
        fidle0=tensors.future_idle0(), nw=nw,
        cand_mask=stack.padded_cand_mask(), tier_masks=masks, tier_part=part,
        preq=preq, pjob=pjob_arr, pjg=pjg, first=first_np, run_id=run_id,
        run_end=run_end, job_end=job_end, score_g=score_g, needed=needed,
        jalloc0=jalloc0, total=total)
    key = "p1" if inter_job else "p2"
    t1 = time.perf_counter()
    stats[key + "_assemble_s"] = t1 - t0

    P = len(ptasks)
    N, W = tensors.vslot.shape
    shards = _walk_shards(ssn) if sharded else 1
    if shards > 1:
        # victim-free pad rows up to a multiple of the mesh size
        inputs = pad_nodes(inputs, shards)
        stats[key + "_shards"] = shards
    Np = inputs.fidle0.shape[0]
    with obs_trace.span("upload", phase=key):
        dev_inputs = to_device(inputs, ssn.device)          # one upload
    with obs_trace.span("solve", phase=key):
        # the shard count only when sharded: the single walk's call is
        # the one its recorders (chip_smoke.py, tools/) wrap
        out = walk(dev_inputs, stack.kinds, stack.sizes,
                   gang_commit=inter_job,
                   **({"shards": shards} if shards > 1 else {}))
        packed = torch.cat([out.task_node, out.owner.reshape(-1),
                            out.job_done.to(torch.int32)]).cpu().numpy()
    task_node = packed[:P]                                  # one fetch
    owner_nw = packed[P:P + Np * W].reshape(Np, W)[:N]
    # per-group verdicts -> per kept job via its alloc-group index
    job_done = packed[P + Np * W:].astype(bool)[pjg_job]
    if task_node.size and (task_node.min() < NO_NODE
                           or task_node.max() >= N):
        raise RuntimeError("preempt walk returned node indices outside "
                           f"[{NO_NODE}, {N})")
    t2 = time.perf_counter()
    stats[key + "_solve_s"] = t2 - t1
    stats[key + "_steps"] = out.steps
    with obs_trace.span("replay", phase=key) as sp:
        _replay_preempt(ssn, ptasks, pjob_ix, kept_jobs, tensors,
                        task_node, owner_nw, job_done, inter_job, stack)
    stats[key + "_replay_s"] = sp.dur_s


def _fast_evict_ok(ssn, stack: "_TierStack") -> bool:
    """Batched eviction replay skips the per-task Statement machinery and
    the live preemptable re-validation. Sound only when every participating
    eviction plugin is a stock fast-path one (the walk replays exactly their
    semantics, so the live chain could never veto a walk verdict), plus
    allocate's batched-replay conditions."""
    from .allocate import _fast_replay_ok
    return not stack.generic and _fast_replay_ok(ssn)


def _fast_pipeline(ssn, task: TaskInfo, host: str) -> None:
    """PENDING -> PIPELINED bookkeeping, identical end-state to
    Statement.pipeline minus the per-task event fire (aggregated by the
    caller; handlers are additive under _fast_evict_ok)."""
    ssn.jobs[task.job].update_task_status(task, TaskStatus.PIPELINED)
    task.node_name = host
    node = ssn.nodes[host]
    node._touched = True       # direct mutation: the snapshot's witness
    ti = task.clone()
    node.tasks[task.uid] = ti
    for port in ti.host_ports:
        node.used_ports[port] = node.used_ports.get(port, 0) + 1
    node.pipelined.add(task.resreq)


def _fast_unpipeline(ssn, task: TaskInfo) -> None:
    """Exact reverse of _fast_pipeline (Statement._undo analogue)."""
    ssn.jobs[task.job].update_task_status(task, TaskStatus.PENDING)
    node = ssn.nodes.get(task.node_name)
    if node is not None:
        node._touched = True
        node.tasks.pop(task.uid, None)
        for port in task.host_ports:
            left = node.used_ports.get(port, 0) - 1
            if left > 0:
                node.used_ports[port] = left
            else:
                node.used_ports.pop(port, None)
        node.pipelined.sub(task.resreq)
    task.node_name = ""


def _fast_evict(ssn, vt: TaskInfo) -> TaskInfo:
    """RUNNING -> RELEASING bookkeeping, identical end-state to
    Statement.evict minus the event fire and the cache side effect (both
    done by the caller after the gang gate)."""
    job = ssn.jobs[vt.job]
    own = job.tasks[vt.uid]
    job.update_task_status(own, TaskStatus.RELEASING)
    node = ssn.nodes.get(own.node_name)
    if node is not None:
        node._touched = True
        mirror = node.tasks.get(own.uid)
        if mirror is not None:
            mirror.status = TaskStatus.RELEASING
            node.releasing.add(own.resreq)
    return own


def _fast_unevict(ssn, own: TaskInfo) -> None:
    """Exact reverse of _fast_evict (Statement._unevict analogue)."""
    ssn.jobs[own.job].update_task_status(own, TaskStatus.RUNNING)
    node = ssn.nodes.get(own.node_name)
    if node is not None:
        node._touched = True
        mirror = node.tasks.get(own.uid)
        if mirror is not None:
            mirror.status = TaskStatus.RUNNING
            node.releasing.sub(own.resreq)


def _replay_preempt_fast(ssn, ptasks, pjob_ix, kept_jobs, tensors,
                         task_node, victims_by_step,
                         inter_job: bool) -> None:
    """Batched preempt replay: dict bookkeeping + aggregated event fires,
    no Statements. The walk already enforced gang atomicity (task_node is
    NO_NODE for rolled-back jobs) and fit.

    One live gate survives from the slow path: a preemptor job can itself
    LOSE RUNNING tasks to an earlier same-queue preemptor in this action,
    dropping its ready count below what the walk's snapshot-time quota
    assumed — so phase 1 re-checks gang's job_pipelined vote after applying
    each job and rolls that job back (pipelines AND its evictions) exactly
    as Statement.discard would. Event fires and cache.evict side effects
    happen only for committed jobs."""
    from .allocate import _AggTask

    names = tensors.node_t.names
    per_job: Dict[int, List[int]] = {}
    for i, jx in enumerate(pjob_ix):
        per_job.setdefault(jx, []).append(i)

    alloc_agg: Dict[int, Resource] = {}
    dealloc_agg: Dict[str, Resource] = {}
    cache_evicts: List[TaskInfo] = []
    rolled_back = False
    n_attempts = last_victims = 0
    for jx, ids in per_job.items():
        job = kept_jobs[jx]
        applied_p: List[TaskInfo] = []
        applied_v: List[TaskInfo] = []
        for i in ids:
            if task_node[i] == NO_NODE:
                continue
            evicted = victims_by_step.get(i, [])
            for vt in evicted:
                applied_v.append(_fast_evict(ssn, vt))
            n_attempts += 1
            last_victims = len(evicted)
            host = names[task_node[i]]
            # after a host-side rollback an earlier job's un-done evictions
            # can leave a node below what the walk assumed: re-check the
            # slow path's pre-pipeline fit gate (preempt.go:263-267)
            if rolled_back and not ptasks[i].init_resreq.less_equal(
                    ssn.nodes[host].future_idle()):
                continue
            _fast_pipeline(ssn, ptasks[i], host)
            applied_p.append(ptasks[i])
        if not applied_p and not applied_v:
            continue
        if inter_job and not ssn.job_pipelined(job):
            for t in reversed(applied_p):
                _fast_unpipeline(ssn, t)
            for v in reversed(applied_v):
                _fast_unevict(ssn, v)
            rolled_back = True
            continue
        for t in applied_p:
            alloc_agg.setdefault(jx, Resource()).add(t.resreq)
        for v in applied_v:
            dealloc_agg.setdefault(v.job, Resource()).add(v.resreq)
            cache_evicts.append(v)

    # the slow replay's per-attempt gauge, last write wins; no attempt
    # leaves it untouched
    if n_attempts:
        metrics.update_preemption_victims(last_victims)
        metrics.register_preemption_attempt(n_attempts)
    for jx, r in alloc_agg.items():
        ssn._fire_allocate(_AggTask(kept_jobs[jx].uid, r))
    for uid, r in dealloc_agg.items():
        ssn._fire_deallocate(_AggTask(uid, r))
    for v in cache_evicts:
        ssn._audit_event("evict", v, "preempt")
        ssn.cache.evict(v, "preempt")


def _replay_preempt(ssn, ptasks, pjob_ix, kept_jobs, tensors,
                    task_node, owner_nw, job_done, inter_job: bool,
                    stack: "_TierStack") -> None:
    victims_by_step = tensors.owner_nw_to_victims(owner_nw)

    if _fast_evict_ok(ssn, stack):
        _replay_preempt_fast(ssn, ptasks, pjob_ix, kept_jobs, tensors,
                             task_node, victims_by_step, inter_job)
        return

    per_job: Dict[int, List[int]] = {}
    for i, jx in enumerate(pjob_ix):
        per_job.setdefault(jx, []).append(i)

    for jx, ids in per_job.items():
        job = kept_jobs[jx]
        if inter_job and not job_done[jx]:
            continue
        stmt = ssn.statement()
        for i in ids:
            n = int(task_node[i])
            if n == NO_NODE:
                continue
            node_name = tensors.node_t.names[n]
            evicted = victims_by_step.get(i, [])
            # final live validation through the real tiered chain
            validated = {t.uid for t in ssn.preemptable(ptasks[i], evicted)} \
                if evicted else set()
            for vt in evicted:
                if vt.uid in validated and vt.uid in ssn.jobs[vt.job].tasks:
                    stmt.evict(ssn.jobs[vt.job].tasks[vt.uid], "preempt")
            metrics.update_preemption_victims(len(validated))
            metrics.register_preemption_attempt()
            # pipeline only if the node fits after the validated evictions
            # (preempt.go:263-267)
            node = ssn.nodes[node_name]
            if ptasks[i].init_resreq.less_equal(node.future_idle()):
                stmt.pipeline(ptasks[i], node_name)
        if inter_job:
            if ssn.job_pipelined(job):
                stmt.commit()
            else:
                stmt.discard()
        else:
            stmt.commit()


def _victim_tasks_host(ssn) -> None:
    """Plugin-driven eviction pass (VictimTasksFn, preempt.go:272-284)."""
    stmt = ssn.statement()
    for victim in ssn.victim_tasks():
        job = ssn.jobs.get(victim.job)
        if job is None or victim.uid not in job.tasks:
            continue
        stmt.evict(job.tasks[victim.uid], "evict")
    stmt.commit()


class _ReclaimScreener:
    """Conservative node pre-filter for the EXACT reclaim rotation.

    The reference's reclaim is a serial one-task-per-queue-pop rotation
    whose job/queue ordering re-evaluates between pops
    (reclaim.go:128-185). So reclaim runs the literal callback rotation
    (ReclaimAction._execute_callbacks — live PriorityQueues, live
    comparators, the real per-node body) and this screener only shrinks the
    per-attempt node walk from O(N) Python to a vectorized f64 mask.

    Superset proof (the body can only ACT on a screened node — evict or
    pipeline — so screening never changes a decision):
    - the body needs at least one cross-queue reclaimable-queue RUNNING
      victim and future_idle + all victims to cover init_resreq; it evicts
      even when the victims alone cannot cover the request (only the
      pipeline is skipped then), so the screen must NOT require pool-alone
      coverage;
    - the screen tests exactly that necessary condition, widened by
      MIN_RESOURCE per dimension, against LIVE totals: the rotation body
      reports every eviction and every pipeline through note_evict /
      note_pipeline, so head + pool equals the body's own
      future_idle-plus-victims test at every attempt;
    - feasibility rows come from the same plugin feasibility fns the
      device engines use as predicate-equivalents, assembled once per job.
    """

    MINR = 0.1      # api/resource.py MIN_RESOURCE — widens the screen

    def __init__(self, ssn):
        self.ssn = ssn
        self.nodes = list(ssn.nodes.values())
        self.names = [n.name for n in self.nodes]
        self.node_index = {n: i for i, n in enumerate(self.names)}
        tasks = [t for j in ssn.jobs.values() for t in j.tasks.values()]
        self.rnames = discover_resource_names(self.nodes, tasks)
        self.node_t = _NodeAxis(self.nodes)
        N, R = len(self.nodes), len(self.rnames)
        self.queue_ix = {uid: i for i, uid in enumerate(ssn.queues)}
        Q = len(self.queue_ix)
        self.head = _res_rows_f64(
            [n.future_idle() for n in self.nodes], self.rnames)
        # victim pools binned by (node, queue, victim-job priority): a first
        # reclaimable tier of stock priority/gang rules with exactly the
        # lower-priority victim set whenever that set is non-empty, so the
        # screen tests coverage against the lower-priority pool when one
        # exists on the node and the full pool otherwise
        self.tier1_priority = self._tier1_is_priority(ssn)
        self.tier2_proportion = self._tier2_is_proportion(ssn)
        # live queue allocations mirror proportion's attrs: evictions
        # subtract, pipelines add to the reclaimer's queue
        self.qalloc = np.zeros((Q, R), np.float64)
        for job in ssn.jobs.values():
            qx = self.queue_ix.get(job.queue)
            if qx is not None:
                self.qalloc[qx] += _res_rows_f64([job.allocated],
                                                 self.rnames)[0]
        self.qdeserved = np.full((Q, R), np.inf, np.float64)
        self.q_has_attr = np.zeros(Q, bool)
        for name, r in ssn.queue_deserved.items():
            qx = self.queue_ix.get(name)
            if qx is not None:
                self.qdeserved[qx] = _res_rows_f64([r], self.rnames)[0]
                self.q_has_attr[qx] = True
        # the BODY's candidate filter: the rotation includes empty-resreq
        # RUNNING tasks too, so they keep nodes in the walk
        victims = [t for node in self.nodes for t in node.tasks.values()
                   if t.status == TaskStatus.RUNNING and t.job in ssn.jobs]
        prios = sorted({ssn.jobs[t.job].priority for t in victims} | {0})
        self.pr_vals = np.asarray(prios, np.int64)
        self.pr_ix = {p: i for i, p in enumerate(prios)}
        P = len(prios)
        vrows = _res_rows_f64([t.resreq for t in victims], self.rnames)
        self._row_cache: Dict[str, np.ndarray] = {
            t.uid: vrows[i] for i, t in enumerate(victims)}
        pools = np.zeros((N, Q, P, R), np.float64)
        counts = np.zeros((N, Q, P), np.float64)
        for i, t in enumerate(victims):
            vq = ssn.jobs[t.job].queue
            queue = ssn.queues.get(vq)
            if queue is None or not queue.reclaimable:
                continue
            qx = self.queue_ix.get(vq)
            n = self.node_index.get(t.node_name)
            if qx is None or n is None:
                continue
            px = self.pr_ix[ssn.jobs[t.job].priority]
            pools[n, qx, px] += vrows[i]
            counts[n, qx, px] += 1
        # aggregates maintained incrementally: cumulative-over-priority
        # pools for the tier-1 lower-priority test, over-deserved-queue
        # pools for tier 2
        self.cumP = np.concatenate(
            [np.zeros((N, Q, 1, R)), np.cumsum(pools, axis=2)], axis=2)
        self.cumP_all = self.cumP.sum(axis=1)            # [N, P+1, R]
        self.ccntP = np.concatenate(
            [np.zeros((N, Q, 1)), np.cumsum(counts, axis=2)], axis=2)
        self.ccntP_all = self.ccntP.sum(axis=1)          # [N, P+1]
        self.pool_q = pools.sum(axis=2)                  # [N, Q, R]
        self.cnt_q = counts.sum(axis=2)                  # [N, Q]
        self.pool_all = self.pool_q.sum(axis=1)          # [N, R]
        self.cnt_all = self.cnt_q.sum(axis=1)            # [N]
        self.over = self._over_now()
        overf = self.over.astype(np.float64)
        self.pool_over = np.einsum("nqr,q->nr", self.pool_q, overf)
        self.cnt_over = self.cnt_q @ overf
        self._feas_cache: Dict[str, np.ndarray] = {}
        self._all_true = np.ones(N, bool)

    def _over_now(self) -> np.ndarray:
        """Queues possibly allocated above deserved (conservative: only a
        queue with EVERY dimension below deserved - eps is certainly not
        over)."""
        return self.q_has_attr & np.any(
            self.qalloc >= self.qdeserved - self.MINR, axis=-1)

    def _refresh_over(self, qx: int) -> None:
        now = bool(self.q_has_attr[qx] and np.any(
            self.qalloc[qx] >= self.qdeserved[qx] - self.MINR))
        if now == bool(self.over[qx]):
            return
        sign = 1.0 if now else -1.0
        self.pool_over += sign * self.pool_q[:, qx]
        self.cnt_over += sign * self.cnt_q[:, qx]
        self.over[qx] = now

    @staticmethod
    def _tier1_is_priority(ssn) -> bool:
        """True when the FIRST tier with reclaimable participants consists
        only of the stock priority/gang lower-priority filters."""
        for tier in ssn.tiers:
            entries = [opt.name for opt in tier.plugins
                       if opt.is_enabled("enabledReclaimable")
                       and opt.name in ssn.reclaimable_fns]
            if not entries:
                continue
            return all(
                name in ("priority", "gang")
                and getattr(ssn.reclaimable_fns[name], "__module__", "")
                == f"volcano_tpu_torch.plugins.{name}" for name in entries)
        return False

    @staticmethod
    def _tier2_is_proportion(ssn) -> bool:
        """True when the SECOND tier with reclaimable participants is
        exactly the stock proportion plugin AND no later tier participates."""
        per_tier = []
        for tier in ssn.tiers:
            entries = [opt.name for opt in tier.plugins
                       if opt.is_enabled("enabledReclaimable")
                       and opt.name in ssn.reclaimable_fns]
            if entries:
                per_tier.append(entries)
        return (len(per_tier) == 2 and per_tier[1] == ["proportion"]
                and getattr(ssn.reclaimable_fns["proportion"],
                            "__module__", "")
                == "volcano_tpu_torch.plugins.proportion")

    def _feas_row(self, task) -> np.ndarray:
        if self.ssn.stateful_predicates:
            # stateful predicates can LOOSEN as the rotation pipelines and
            # evicts, so a cached static row is not a superset — the body's
            # live predicate_fn decides alone
            return self._all_true
        row = self._feas_cache.get(task.uid)
        if row is not None:
            return row
        job = self.ssn.jobs.get(task.job)
        pend = list(job.task_status_index.get(TaskStatus.PENDING,
                                              {}).values()) if job else []
        if task.uid not in {t.uid for t in pend}:
            pend.append(task)
        feas = assemble_feasibility(self.ssn, pend, self.node_t)
        for i, t in enumerate(pend):
            self._feas_cache[t.uid] = (self._all_true if feas is None
                                       else feas[i])
        return self._feas_cache[task.uid]

    def note_evict(self, victim) -> None:
        """Rotation callback: victim left the pool, its resreq joined the
        node's future idle (session.evict's releasing bump)."""
        n = self.node_index.get(victim.node_name)
        qx = self.queue_ix.get(self.ssn.jobs[victim.job].queue)
        if n is None:
            return
        r = self._row_cache.get(victim.uid)
        if r is None:
            r = _res_rows_f64([victim.resreq], self.rnames)[0]
        self.head[n] += r
        px = self.pr_ix.get(self.ssn.jobs[victim.job].priority)
        if qx is not None and px is not None:
            self.cumP[n, qx, px + 1:] -= r
            self.cumP_all[n, px + 1:] -= r
            self.ccntP[n, qx, px + 1:] -= 1
            self.ccntP_all[n, px + 1:] -= 1
            self.pool_q[n, qx] -= r
            self.cnt_q[n, qx] -= 1
            self.pool_all[n] -= r
            self.cnt_all[n] -= 1
            if self.over[qx]:
                self.pool_over[n] -= r
                self.cnt_over[n] -= 1
        if qx is not None:
            self.qalloc[qx] -= r
            self._refresh_over(qx)

    def note_pipeline(self, task, node) -> None:
        """Rotation callback: the pipelined reclaimer reserves the node's
        future idle and grows its queue's allocation."""
        n = self.node_index.get(node.name)
        r = self._row_cache.get(task.uid)
        if r is None:
            r = _res_rows_f64([task.resreq], self.rnames)[0]
            self._row_cache[task.uid] = r
        if n is not None:
            self.head[n] -= r
        qx = self.queue_ix.get(self.ssn.jobs[task.job].queue)
        if qx is not None:
            self.qalloc[qx] += r
            self._refresh_over(qx)

    def nodes_for(self, task) -> List:
        qx = self.queue_ix.get(self.ssn.jobs[task.job].queue)
        if qx is None:
            return self.nodes
        req = self._row_cache.get(task.uid)
        if req is None:
            req = _res_rows_f64([task.init_resreq], self.rnames)[0]
            self._row_cache[task.uid] = req
        pool_full = self.pool_all - self.pool_q[:, qx]
        cnt_full = self.cnt_all - self.cnt_q[:, qx]
        # NO pool-alone-covers clause: the body evicts even when the
        # victims cannot cover the request (it only skips the PIPELINE)
        if self.tier1_priority:
            p = self.ssn.jobs[task.job].priority
            pix = int(np.searchsorted(self.pr_vals, p))  # #priorities < p
            pool_lp = self.cumP_all[:, pix] - self.cumP[:, qx, pix]
            cnt_lp = self.ccntP_all[:, pix] - self.ccntP[:, qx, pix]
            if self.tier2_proportion:
                # tier 2 (proportion) only ever accepts victims of queues
                # allocated above deserved
                if self.over[qx]:
                    pool_t2 = self.pool_over - self.pool_q[:, qx]
                    cnt_t2 = self.cnt_over - self.cnt_q[:, qx]
                else:
                    pool_t2, cnt_t2 = self.pool_over, self.cnt_over
            else:
                pool_t2, cnt_t2 = pool_full, cnt_full
            # lower-priority victims present -> tier 1 RULES with exactly
            # that set; otherwise tier 1 abstains and tier 2 rules
            pool = np.where((cnt_lp > 0)[:, None], pool_lp, pool_t2)
            cnt = np.where(cnt_lp > 0, cnt_lp, cnt_t2)
        else:
            pool, cnt = pool_full, cnt_full
        ok = ((cnt > 0)
              & np.all(self.head + pool + self.MINR >= req, axis=-1)
              & self._feas_row(task))
        return [self.nodes[i] for i in np.flatnonzero(ok)]


def execute_reclaim_tpu(ssn) -> None:
    """Reclaim engine: the exact reference rotation through the screener.
    Decisions are the callback engine's by construction; the screener only
    removes provably hopeless nodes from each attempt's walk."""
    from .reclaim import ReclaimAction
    ReclaimAction(engine="callbacks")._execute_callbacks(
        ssn, screener=_ReclaimScreener(ssn))
