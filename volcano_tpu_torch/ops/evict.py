"""The preempt victim walk (kernel B3), as a plain PyTorch loop and as the
hand-written CUDA kernel ``csrc/evict.cu``.

The reference's eviction hot loop is per (preemptor, node, running task)
Python callbacks (pkg/scheduler/actions/preempt/preempt.go:190-269 with the
tiered Preemptable dispatch of session_plugins.go:187-236). The walk runs
that search over one fixed task order, with the full tier semantics, in a
dense per-node victim layout:

- victims live in ``[N, W]`` node-major slots (W = max victims on any node,
  row order = the host's eviction order), so per-node reductions are sums
  over at most W slots;
- each task replays the tiered dispatch on every node: a tier's verdict
  stands only if EVERY participating plugin returns a non-empty candidate
  set on that node; an empty set vetoes the tier. The next tier rules only
  if the tier's first participating plugin returned none, as upstream's
  ``init`` spans the tiers: a veto after some plugin's victims leaves the
  node with none (the JAX walk lets the next tier rule; ROADMAP §3). A
  tier kind ``drf@k`` says that drf follows only the tier's first k static
  masks in conf order (plain ``drf``: all of them), which decides the
  first participant. Static plugin verdicts are host-computed ``[PJ, V]`` masks; the
  drf tier is dynamic — job allocations are tracked as drf's event
  handlers would (allocate on pipeline, deallocate on evict), including
  the within-dispatch subtraction of earlier candidates of the same job
  (drf.go:308-330);
- the task takes the best-scoring node on which it fits after evicting the
  eligible victims (the lowest index wins ties), evicts the minimal
  row-order prefix of them that makes it fit, and updates the node's
  future idle, the job allocations and its job's pipeline quota count;
- job boundaries carry gang statement semantics (phase 1): a snapshot at a
  job's first task, and a rollback when the job misses its pipeline quota
  — Statement.Commit/Discard on the device. Phase 2 (intra-job) commits
  every placement and stops a job at its first failure.

Every quantity is a small exact integer in f32 (the host divides each
resource dimension by its GCD, actions/evict_tpu.py::_dim_scale), so every
sum is exact in any order; the kernel still keeps the plain version's
operation order, and no sum goes through a matrix unit.

This computes what ``volcano_tpu/ops/evict.py::build_preempt_walk`` (a JAX
``lax.while_loop``) computes. That walk's same-request runs, closed-form
fill schedule and ``allow_cheap`` switch are shortcuts of its XLA design;
the outputs are the per-task algorithm's, which is what both forms here
run.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build
from .build import KernelError

NO_NODE = -1
BIG = 1 << 30
SHARE_DELTA = 1e-6          # plugins/drf.py SHARE_DELTA (drf.go:37)
EPS = 0.1                   # resource_info.go:36 minResource
MAX_W = 64                  # victim slots a node (one 64-bit mask)
MAX_R = 8                   # resource columns the kernel takes
MAX_MASKS = 64              # static plugin masks over all tiers
MAX_TIERS = 16


class EvictNW(NamedTuple):
    """The [N, W] victim layout. ``vslot`` indexes the compact victim axis
    (V = pad sentinel, so per-victim tables carry one trailing pad
    entry)."""

    vslot: object               # i32[N, W] -> victim index (V = pad)
    valid: object               # bool[N, W]
    vreq: object                # f32[N, W, R]
    vgroup: object              # i32[N, W] victim job's alloc-group; pads
    #                             point at the zeroed last row of jalloc
    rank: object                # i32[N, W] candidate-list rank (pads BIG):
    #                             drf's within-dispatch subtraction order


class WalkInputs(NamedTuple):
    """Everything one walk reads (numpy arrays on the host, or tensors on
    one device after ``to_device``). P preemptor tasks in job-contiguous
    order; PJ preemptor jobs; AJ1 alloc-groups (every job of the session
    plus one zeroed pad row); G score rows."""

    fidle0: object              # f32[N, R] future idle at the phase's start
    nw: EvictNW
    cand_mask: object           # bool[PJ, V+1] candidate filter per job
    tier_masks: object          # bool[M, PJ, V+1] static masks, tier order
    tier_part: object           # bool[M, PJ] plugin participates (voted)
    preq: object                # f32[P, R]
    pjob: object                # i32[P] preemptor-job index
    pjg: object                 # i32[P] the job's alloc-group
    first: object               # bool[P] first task of its job
    run_id: object              # i32[P] score row
    run_end: object             # i32[P] last task of its same-request run
    job_end: object             # i32[P] last task of its job
    score_g: object             # f32[G, N] node scores, -inf infeasible
    needed: object              # f32[AJ1] pipeline quota per alloc-group
    jalloc0: object             # f32[AJ1, R] job allocations
    total: object               # f32[R] cluster allocatable


class WalkOutput(NamedTuple):
    task_node: torch.Tensor     # i32[P] node or NO_NODE
    owner: torch.Tensor         # i32[N, W] task that evicted the slot, or -1
    job_done: torch.Tensor      # bool[AJ1] quota met
    steps: int                  # tasks the walk evaluated (diagnostics)
    redispatched: Optional[int] = None   # walk_cuda: node dispatches
    bulks: Optional[int] = None          # walk_cuda: all-warp operations
    plan: Optional["WalkPlan"] = None    # walk_cuda: the plan it launched


def to_device(inp: WalkInputs, device) -> WalkInputs:
    """The inputs as tensors on ``device``: NumPy arrays are copied (never
    aliased), tensors already there are kept."""
    def t(a):
        if isinstance(a, torch.Tensor):
            return a.to(device).contiguous()
        return torch.tensor(np.ascontiguousarray(a), device=device)
    return WalkInputs(*(EvictNW(*(t(x) for x in v)) if isinstance(v, EvictNW)
                        else t(v) for v in inp))


def _share(alloc: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """drf's calculate_share over the trailing resource dim: max over dims
    of alloc/total (1.0 when total == 0 but alloc > 0)."""
    pos = total > 0
    one = torch.ones((), dtype=alloc.dtype, device=alloc.device)
    zero = torch.zeros((), dtype=alloc.dtype, device=alloc.device)
    ratio = torch.where(pos, alloc / torch.where(pos, total, one),
                        torch.where(alloc > 0, one, zero))
    return ratio.max(dim=-1).values


def tier_layout(tier_kinds: Sequence[str], tier_sizes: Sequence[int],
                M: int) -> Tuple[Tuple[bool, int], ...]:
    """(drf, lead) per tier, checked against M masks: whether drf is in
    the tier, and how many of its static masks come before drf in conf
    order (the tier's size without drf or with drf last), of which the
    first participating one, else drf, leads the tier."""
    if len(tier_kinds) != len(tier_sizes) or sum(tier_sizes) != M:
        raise ValueError(f"walk: tiers {tier_kinds}/{tier_sizes} do not "
                         f"describe {M} masks")
    out = []
    for kind, size in zip(tier_kinds, tier_sizes):
        base, _, pos = kind.partition("@")
        if (base not in ("static", "drf") or (pos and base != "drf")
                or (pos and not (pos.isdigit() and int(pos) < size))):
            raise ValueError(f"walk: unknown tier kind {kind!r}")
        out.append((base == "drf", int(pos) if pos else size))
    return tuple(out)


def walk_plain(inp: WalkInputs, tier_kinds: Tuple[str, ...],
               tier_sizes: Tuple[int, ...], gang_commit: bool,
               observe=None, shards: int = 1) -> WalkOutput:
    """The walk as PyTorch ops on the inputs' device, one task at a time:
    the plain version of ``walk_cuda``. ``observe``, if given, is called
    after each evaluated task's dispatch as ``observe(i, ls, min_kept,
    best, changed)``: the preemptor's drf share (0.0 without a drf tier),
    each node's smallest drf-kept share (f32[N], inf where drf keeps none),
    the node taken (-1 if none fits) and the alloc-groups whose allocation
    the eviction changed (its victims' and the preemptor's own).

    ``shards`` > 1 is the plain version of ``walk_sharded_cuda`` (the JAX
    package's walk with ``axis``, volcano_tpu/ops/evict.py:253-303): the
    node axis (N a multiple of it) in equal shards, each shard's best
    (score, global node) taken on its own rows, one after another, and the
    largest gathered in shard order (the lowest global node wins a tie);
    the owner shard evicts. Its outputs are the unsharded walk's."""
    nw = inp.nw
    N, W, R = nw.vreq.shape
    if shards < 1 or N % shards:
        raise ValueError(f"walk_plain: {N} nodes do not split into "
                         f"{shards} shards")
    Nl = N // shards
    P = inp.preq.shape[0]
    AJ1 = inp.jalloc0.shape[0]
    dev = inp.fidle0.device
    f32 = torch.float32
    layout = tier_layout(tier_kinds, tier_sizes, inp.tier_masks.shape[0])
    has_drf = any(drf for drf, _ in layout)
    neg_inf = torch.tensor(-float("inf"), dtype=f32, device=dev)

    fidle = inp.fidle0.clone()
    alive = torch.ones((N, W), dtype=torch.bool, device=dev)
    owner = torch.full((N, W), -1, dtype=torch.int32, device=dev)
    jalloc = inp.jalloc0.clone()
    count = [0.0] * AJ1                        # pipeline quota counts
    needed = inp.needed.tolist()
    snap = (fidle.clone(), alive.clone(), owner.clone(), jalloc.clone(),
            list(count))
    task_node = torch.full((P,), NO_NODE, dtype=torch.int32, device=dev)
    pjob, pjg = inp.pjob.tolist(), inp.pjg.tolist()
    first = inp.first.tolist()
    run_id, run_end = inp.run_id.tolist(), inp.run_end.tolist()
    job_end = inp.job_end.tolist()
    if has_drf:
        # before[n, u, w]: slot u shares w's group and precedes it in
        # candidate-list order
        before = ((nw.vgroup[:, :, None] == nw.vgroup[:, None, :])
                  & (nw.rank[:, :, None] < nw.rank[:, None, :])
                  & nw.valid[:, :, None]).to(f32)

    def rollback_if_failed(prev):
        nonlocal fidle, alive, owner, jalloc, count
        if prev >= 0 and count[prev] < needed[prev]:
            fidle, alive, owner, jalloc = (x.clone() for x in snap[:4])
            count = list(snap[4])
            count[prev] = float(-BIG)

    cur_cand = cur_masks = cur_part = None
    last_g = -1
    steps = 0
    i = 0
    while i < P:
        pj, g = pjob[i], pjg[i]
        if first[i]:
            if gang_commit:
                rollback_if_failed(last_g)
                snap = (fidle.clone(), alive.clone(), owner.clone(),
                        jalloc.clone(), list(count))
            cur_cand = inp.cand_mask[pj][nw.vslot] & nw.valid
            cur_masks = inp.tier_masks[:, pj][:, nw.vslot]      # [M, N, W]
            cur_part = inp.tier_part[:, pj].tolist()
        last_g = g
        if count[g] >= needed[g]:
            # quota met: every remaining task of the job is inactive too
            i = job_end[i] + 1
            continue
        steps += 1
        req = inp.preq[i]
        cand = alive & cur_cand

        # -- the tiered dispatch on every node --------------------------
        if has_drf:
            ls = _share(jalloc[g] + req, inp.total)
            masked = nw.vreq * cand[..., None].to(f32)
            # explicit broadcast-sum, not a matrix product: no TF32
            prior = (before[..., None] * masked[:, :, None, :]).sum(dim=1)
            rs = _share(jalloc[nw.vgroup] - prior - nw.vreq, inp.total)
            dset = cand & ((ls < rs) | ((ls - rs).abs() <= SHARE_DELTA))
        decided = torch.zeros(N, dtype=torch.bool, device=dev)
        elig = torch.zeros((N, W), dtype=torch.bool, device=dev)
        off = 0
        for size, (drf, lead_span) in zip(tier_sizes, layout):
            parts = cur_part[off:off + size]
            tset = cand
            ok = torch.ones(N, dtype=torch.bool, device=dev)
            lead = None         # the first participant returned victims
            for k, p in enumerate(parts):
                if p:
                    m = cur_masks[off + k]
                    tset = tset & m
                    some = (cand & m).any(dim=-1)
                    ok = ok & some
                    if lead is None and k < lead_span:
                        lead = some
            if drf:
                tset = tset & dset
                ok = ok & dset.any(dim=-1)
                if lead is None:
                    lead = dset.any(dim=-1)
            if lead is not None:
                elig = elig | (tset & (ok & ~decided)[:, None])
                decided = decided | lead
            off += size

        evictable = (nw.vreq * elig[..., None].to(f32)).sum(dim=1)
        fits = (torch.all(req < fidle + evictable + EPS, dim=-1)
                & elig.any(dim=-1))
        row = torch.where(fits, inp.score_g[run_id[i]], neg_inf)
        best, top = 0, None
        for s in range(shards):
            part = row[s * Nl:(s + 1) * Nl]
            b = int(torch.argmax(part))
            if top is None or bool(part[b] > top):
                best, top = s * Nl + b, part[b]
        found = bool(row[best] > neg_inf)
        if observe is not None:
            inf = torch.tensor(float("inf"), dtype=f32, device=dev)
            min_kept = (torch.where(dset, rs, inf).min(dim=1).values
                        if has_drf else inf.expand(N))
            seen = (i, float(ls) if has_drf else 0.0, min_kept)
        if not found:
            if observe is not None:
                observe(*seen, -1, [])
            # phase 1: the rest of the run fails alike (nothing changed);
            # phase 2 stops the job at its first failure
            i = (run_end[i] if gang_commit else job_end[i]) + 1
            continue

        # -- evict the minimal row-order prefix on the chosen node ------
        b_elig = elig[best]
        vr = nw.vreq[best]
        masked_b = vr * b_elig[:, None].to(f32)
        cum_excl = torch.cumsum(masked_b, dim=0) - masked_b
        fit_w = torch.all(req < fidle[best] + cum_excl + EPS, dim=-1)
        evicted = b_elig & ~fit_w
        ev_req = vr * evicted[:, None].to(f32)
        fidle[best] = fidle[best] + (ev_req.sum(dim=0) - req)
        alive[best] = alive[best] & ~evicted
        owner[best] = torch.where(evicted, torch.full_like(owner[best], i),
                                  owner[best])
        delta = torch.zeros((AJ1, R), dtype=f32, device=dev).index_add_(
            0, nw.vgroup[best].long(), ev_req)
        jalloc = jalloc - delta
        jalloc[g] = jalloc[g] + req
        count[g] += 1.0
        task_node[i] = best
        if observe is not None:
            observe(*seen, best,
                    sorted(set(nw.vgroup[best][evicted].tolist()) | {g}))
        i += 1

    if gang_commit:
        rollback_if_failed(last_g)
    job_done = torch.tensor([c >= n for c, n in zip(count, needed)],
                            dtype=torch.bool, device=dev)
    if gang_commit:
        task_node = torch.where(job_done[inp.pjg.long()], task_node,
                                torch.full_like(task_node, NO_NODE))
    return WalkOutput(task_node, owner, job_done, steps)


class WalkDispatches(NamedTuple):
    per_task: np.ndarray        # i64[steps] nodes dispatched, task by task
    per_node: np.ndarray        # i64[N] dispatches of each node


def walk_dispatches(inp: WalkInputs, tier_kinds: Tuple[str, ...],
                    tier_sizes: Tuple[int, ...],
                    gang_commit: bool) -> WalkDispatches:
    """The node dispatches that ``csrc/evict.cu``'s verdict cache needs on
    these inputs, counted from ``walk_plain``'s own per-task verdicts (not
    from the kernel). An evaluated task dispatches every node when it is the
    first since a job opened, when its score row or request differs from
    the last evaluated task's, or when the preemptor's drf share fell;
    else the last pick, under a drf tier every node with a slot of a group
    whose allocation the last eviction changed, and every node whose
    smallest drf-kept share at its last dispatch fails keep with the new
    share. Raises if a node the rule leaves out has a kept share other than
    its last dispatch's."""
    nw = inp.nw
    N = nw.vreq.shape[0]
    dev = inp.fidle0.device
    has_drf = any(drf for drf, _ in tier_layout(
        tier_kinds, tier_sizes, inp.tier_masks.shape[0]))
    opens = np.cumsum(inp.first.cpu().numpy())
    run_id = inp.run_id.cpu().numpy()
    req_bits = inp.preq.cpu().numpy().view(np.uint32)
    cached = torch.full((N,), float("inf"), device=dev)
    per_node = torch.zeros(N, dtype=torch.int64, device=dev)
    per_task = []
    last = {"i": -1, "ls": 0.0, "best": -1, "changed": []}

    def observe(i, ls, min_kept, best, changed):
        p = last["i"]
        if (p < 0 or opens[i] != opens[p] or run_id[i] != run_id[p]
                or (req_bits[i] != req_bits[p]).any()
                or (has_drf and ls < last["ls"])):
            stale = torch.ones(N, dtype=torch.bool, device=dev)
        else:
            ls_t = torch.tensor(ls, dtype=torch.float32, device=dev)
            stale = ~((ls_t < cached)
                      | ((ls_t - cached).abs() <= SHARE_DELTA))
            if last["best"] >= 0:
                stale[last["best"]] = True
                if has_drf:
                    grp = torch.tensor(last["changed"], dtype=nw.vgroup.dtype,
                                       device=dev)
                    stale |= (torch.isin(nw.vgroup, grp) & nw.valid).any(1)
            if not torch.equal(min_kept[~stale], cached[~stale]):
                raise RuntimeError(f"walk_dispatches: task {i} left out a "
                                   f"node whose kept share changed")
        cached[stale] = min_kept[stale]
        per_node.add_(stale.long())
        per_task.append(int(stale.sum()))
        last.update(i=i, ls=ls, best=best, changed=changed)

    walk_plain(inp, tier_kinds, tier_sizes, gang_commit, observe=observe)
    return WalkDispatches(np.asarray(per_task, np.int64),
                          per_node.cpu().numpy())


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_PTRS = 25
_INTS = 14 + 3 * MAX_TIERS
SMEM_MAX = 232_448          # dynamic shared memory a Hopper CTA may use
MIN_THREADS, MAX_THREADS = 64, 512
# csrc/evict.cu's layout: the fixed part, then five blocks, each in shared
# memory when the plan's bit is set (kGroups ... kCsr), in this order of
# priority
GROUPS, NODES, TABLES, MASKS, CSR = 1, 2, 4, 8, 16
BLOCK_NAMES = ("groups", "nodes", "tables", "masks", "csr")


def _al16(b: int) -> int:
    return (b + 15) // 16 * 16


FIXED_BYTES = 128 + _al16(4 * (MAX_W + 1))


def block_bytes(N: int, W: int, R: int, M: int, AJ1: int) -> Tuple[int, ...]:
    """Bytes of each block of csrc/evict.cu's layout, in plan-bit order:
    group allocations, counts, needs, tags and the CSR offsets; node state,
    the verdict cache (with each 32 nodes' best key and smallest kept
    share) and two score rows; the victim tables; the job's mask words; the
    group -> nodes CSR."""
    groups = _al16(4 * AJ1 * R) + 3 * _al16(4 * AJ1) + _al16(4 * (AJ1 + 1))
    G32 = -(-N // 32)
    nodes = (4 * _al16(8 * N) + _al16(8 * G32) + _al16(4 * G32)
             + _al16(4 * N * R) + 4 * _al16(4 * N))
    tables = _al16(8 * N * W) + _al16(4 * N * W * R) + _al16(4 * N * W)
    return groups, nodes, tables, _al16(8 * M * N), _al16(4 * N * W)


class WalkPlan(NamedTuple):
    threads: int        # one CTA; a warp owns whole groups of 32 nodes
    smem: int           # dynamic shared memory bytes
    blocks: int         # plan bits: the blocks kept in shared memory
    scratch: int        # device-memory bytes: every block, plus gang saves

    @property
    def in_smem(self) -> bool:
        """Every block in shared memory."""
        return self.blocks == GROUPS | NODES | TABLES | MASKS | CSR

    def where(self) -> dict:
        return {name: bool(self.blocks & (1 << k))
                for k, name in enumerate(BLOCK_NAMES)}


def launch_plan(N: int, W: int, R: int, M: int, AJ1: int) -> WalkPlan:
    """Where the walk runs: one CTA of one thread a node (a multiple of 32,
    64 to 512). Each block of the layout joins shared memory, in priority
    order, when it fits beside the fixed part and the blocks before it; the
    others stay in device memory, read through the same pointers."""
    threads = min(MAX_THREADS, max(MIN_THREADS, -(-N // 32) * 32))
    sizes = block_bytes(N, W, R, M, AJ1)
    smem, blocks = FIXED_BYTES, 0
    for bit, size in enumerate(sizes):
        if smem + size <= SMEM_MAX:
            smem += size
            blocks |= 1 << bit
    saves = _al16(8 * N) + _al16(4 * N * R) + _al16(4 * AJ1 * R)
    return WalkPlan(threads, smem, blocks, sum(sizes) + saves)


def _lib():
    lib = build.load("evict")
    lib.vt_evict_walk.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p]
    lib.vt_evict_walk.restype = ctypes.c_int
    lib.vt_evict_walk_sharded.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_void_p]
    lib.vt_evict_walk_sharded.restype = ctypes.c_int
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"walk_cuda: {name} must be a contiguous {dtype} "
                         f"{shape} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def walk_cuda(inp: WalkInputs, tier_kinds: Tuple[str, ...],
              tier_sizes: Tuple[int, ...], gang_commit: bool) -> WalkOutput:
    """The walk as one launch of ``csrc/evict.cu`` on the current stream:
    same inputs and outputs as ``walk_plain``, every tensor on one CUDA
    device. Raises on an input it does not take, a failed build or a failed
    launch. The output also carries the kernel's count of node dispatches
    (``redispatched``), of bulk operations (``bulks``) and the plan it
    launched with."""
    nw = inp.nw
    device = inp.fidle0.device
    if device.type != "cuda":
        raise ValueError(f"walk_cuda: tensors are on {device}, not a CUDA "
                         f"device")
    N, W, R = nw.vreq.shape
    P = inp.preq.shape[0]
    PJ, V1 = inp.cand_mask.shape
    M = inp.tier_masks.shape[0]
    AJ1 = inp.jalloc0.shape[0]
    G = inp.score_g.shape[0]
    layout = tier_layout(tier_kinds, tier_sizes, M)
    if not (1 <= W <= MAX_W and 1 <= R <= MAX_R and M <= MAX_MASKS
            and len(tier_kinds) <= MAX_TIERS):
        raise ValueError(f"walk_cuda: W={W} R={R} masks={M} tiers="
                         f"{len(tier_kinds)} exceed the kernel's "
                         f"{MAX_W}/{MAX_R}/{MAX_MASKS}/{MAX_TIERS}")
    if N < 1 or AJ1 < 1:
        raise ValueError(f"walk_cuda: {N} nodes and {AJ1} alloc-groups; the "
                         f"kernel needs at least one of each")
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    for name, t, dtype, shape in (
            ("fidle0", inp.fidle0, f32, (N, R)),
            ("vslot", nw.vslot, i32, (N, W)), ("valid", nw.valid, b8, (N, W)),
            ("vreq", nw.vreq, f32, (N, W, R)),
            ("vgroup", nw.vgroup, i32, (N, W)), ("rank", nw.rank, i32, (N, W)),
            ("cand_mask", inp.cand_mask, b8, (PJ, V1)),
            ("tier_masks", inp.tier_masks, b8, (M, PJ, V1)),
            ("tier_part", inp.tier_part, b8, (M, PJ)),
            ("preq", inp.preq, f32, (P, R)), ("pjob", inp.pjob, i32, (P,)),
            ("pjg", inp.pjg, i32, (P,)), ("first", inp.first, b8, (P,)),
            ("run_id", inp.run_id, i32, (P,)),
            ("run_end", inp.run_end, i32, (P,)),
            ("job_end", inp.job_end, i32, (P,)),
            ("score_g", inp.score_g, f32, (G, N)),
            ("needed", inp.needed, f32, (AJ1,)),
            ("jalloc0", inp.jalloc0, f32, (AJ1, R)),
            ("total", inp.total, f32, (R,))):
        _check(name, t, dtype, shape, device)

    plan = launch_plan(N, W, R, M, AJ1)
    scratch = torch.empty((plan.scratch,), dtype=torch.uint8, device=device)
    owner = torch.empty((N, W), dtype=i32, device=device)
    task_node = torch.empty((P,), dtype=i32, device=device)
    job_done = torch.empty((AJ1,), dtype=i32, device=device)
    stats = torch.empty((3,), dtype=i32, device=device)
    ins = [inp.fidle0, nw.vslot, nw.valid, nw.vreq, nw.vgroup, nw.rank,
           inp.cand_mask, inp.tier_masks, inp.tier_part, inp.preq, inp.pjob,
           inp.pjg, inp.first, inp.run_id, inp.run_end, inp.job_end,
           inp.score_g, inp.needed, inp.jalloc0, inp.total]
    ptrs = (ctypes.c_int64 * _PTRS)(*[t.data_ptr() for t in
                                      ins + [scratch, owner, task_node,
                                             job_done, stats]])
    kinds = [int(drf) for drf, _ in layout]
    leads = [lead for _, lead in layout]
    ints = [N, W, R, P, PJ, V1, AJ1, G, len(tier_kinds), M,
            int(gang_commit), plan.threads, plan.blocks, plan.smem]
    ints += kinds + [0] * (MAX_TIERS - len(kinds))
    ints += list(tier_sizes) + [0] * (MAX_TIERS - len(tier_sizes))
    ints += leads + [0] * (MAX_TIERS - len(leads))
    cints = (ctypes.c_int * _INTS)(*ints)
    with torch.cuda.device(device):
        err = _lib().vt_evict_walk(
            ptrs, cints, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise KernelError(f"walk_cuda: kernel launch failed with "
                          f"cudaError_t {err}" if err > 0 else
                          f"walk_cuda: the kernel refused plan {plan} "
                          f"({err})")
    walk_cuda.launches += 1
    steps, redispatched, bulks = stats.tolist()
    return WalkOutput(task_node, owner, job_done.to(b8), steps,
                      redispatched, bulks, plan)


MAX_SHARDS = 8          # the sharded walk's cluster: a CTA a shard
PAD_SCORE = -1e30       # a pad node's score (evict_tpu.py:1045-1048)


def pad_nodes(inp: WalkInputs, shards: int) -> WalkInputs:
    """The inputs with the node axis padded to a multiple of ``shards``
    by victim-free rows (the JAX package's evict_tpu.py:1025-1048): no
    future idle, every slot the pad victim and invalid, group the zeroed
    last alloc-group, rank BIG, score PAD_SCORE. A pad node never has an
    eligible victim, so it is never chosen. NumPy or tensor inputs."""
    N = inp.nw.vslot.shape[0]
    pad = (-N) % shards
    if not pad:
        return inp
    V = inp.cand_mask.shape[1] - 1
    AJ1 = inp.jalloc0.shape[0]

    def rows(a, value=0):
        if isinstance(a, torch.Tensor):
            extra = torch.full((pad,) + tuple(a.shape[1:]), value,
                               dtype=a.dtype, device=a.device)
            return torch.cat([a, extra])
        width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, width, constant_values=value)

    def cols(a, value):
        if isinstance(a, torch.Tensor):
            extra = torch.full((a.shape[0], pad), value, dtype=a.dtype,
                               device=a.device)
            return torch.cat([a, extra], dim=1)
        return np.pad(a, ((0, 0), (0, pad)), constant_values=value)

    nw = inp.nw
    return inp._replace(
        fidle0=rows(inp.fidle0),
        nw=EvictNW(vslot=rows(nw.vslot, V), valid=rows(nw.valid, False),
                   vreq=rows(nw.vreq), vgroup=rows(nw.vgroup, AJ1 - 1),
                   rank=rows(nw.rank, BIG)),
        score_g=cols(inp.score_g, PAD_SCORE))


def walk_sharded_cuda(inp: WalkInputs, tier_kinds: Tuple[str, ...],
                      tier_sizes: Tuple[int, ...], gang_commit: bool,
                      shards: int) -> WalkOutput:
    """The walk over ``shards`` (2 to 8) equal shards of the node axis as
    one launch of ``walk_sharded_kernel`` (csrc/evict.cu): a cluster of a
    CTA a shard, each dispatching its own nodes every task, the shards'
    best keys gathered and the owner's eviction broadcast through
    distributed shared memory. Same inputs and outputs as ``walk_plain``
    with ``shards``; ``redispatched`` counts the node dispatches, ``bulks``
    the job openings. Raises on an input it does not take, a failed build
    or a failed launch."""
    nw = inp.nw
    device = inp.fidle0.device
    if device.type != "cuda":
        raise ValueError(f"walk_sharded_cuda: tensors are on {device}, not "
                         f"a CUDA device")
    N, W, R = nw.vreq.shape
    P = inp.preq.shape[0]
    PJ, V1 = inp.cand_mask.shape
    M = inp.tier_masks.shape[0]
    AJ1 = inp.jalloc0.shape[0]
    G = inp.score_g.shape[0]
    layout = tier_layout(tier_kinds, tier_sizes, M)
    if not (2 <= shards <= MAX_SHARDS and N % shards == 0):
        raise ValueError(f"walk_sharded_cuda: {N} nodes in {shards} shards; "
                         f"the kernel takes 2..{MAX_SHARDS} equal shards")
    if not (1 <= W <= MAX_W and 1 <= R <= MAX_R and M <= MAX_MASKS
            and len(tier_kinds) <= MAX_TIERS):
        raise ValueError(f"walk_sharded_cuda: W={W} R={R} masks={M} tiers="
                         f"{len(tier_kinds)} exceed the kernel's "
                         f"{MAX_W}/{MAX_R}/{MAX_MASKS}/{MAX_TIERS}")
    if AJ1 < 1:
        raise ValueError("walk_sharded_cuda: no alloc-group")
    i32, f32, b8, i64 = torch.int32, torch.float32, torch.bool, torch.int64
    for name, t, dtype, shape in (
            ("fidle0", inp.fidle0, f32, (N, R)),
            ("vslot", nw.vslot, i32, (N, W)), ("valid", nw.valid, b8, (N, W)),
            ("vreq", nw.vreq, f32, (N, W, R)),
            ("vgroup", nw.vgroup, i32, (N, W)), ("rank", nw.rank, i32, (N, W)),
            ("cand_mask", inp.cand_mask, b8, (PJ, V1)),
            ("tier_masks", inp.tier_masks, b8, (M, PJ, V1)),
            ("tier_part", inp.tier_part, b8, (M, PJ)),
            ("preq", inp.preq, f32, (P, R)), ("pjob", inp.pjob, i32, (P,)),
            ("pjg", inp.pjg, i32, (P,)), ("first", inp.first, b8, (P,)),
            ("run_id", inp.run_id, i32, (P,)),
            ("run_end", inp.run_end, i32, (P,)),
            ("job_end", inp.job_end, i32, (P,)),
            ("score_g", inp.score_g, f32, (G, N)),
            ("needed", inp.needed, f32, (AJ1,)),
            ("jalloc0", inp.jalloc0, f32, (AJ1, R)),
            ("total", inp.total, f32, (R,))):
        _check(name, t, dtype, shape, device)

    def buf(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    # ShardArgs' order: the job state a CTA (live, snapshot), node state,
    # its snapshot, the verdict words, drf's precedence words, mask words
    work = [buf((shards, AJ1, R), f32), buf((shards, AJ1), f32),
            buf((shards, AJ1, R), f32), buf((shards, AJ1), f32),
            buf((N, R), f32), buf((N, R), f32), buf((N,), f32),
            buf((N,), i64), buf((N,), i64), buf((N,), i64), buf((N,), i64),
            buf((N,), i64), buf((N, W), i64), buf((max(M, 1), N), i64)]
    owner = torch.empty((N, W), dtype=i32, device=device)
    task_node = torch.empty((P,), dtype=i32, device=device)
    job_done = torch.empty((AJ1,), dtype=i32, device=device)
    stats = torch.empty((3,), dtype=i32, device=device)
    ins = [inp.fidle0, nw.vslot, nw.valid, nw.vreq, nw.vgroup, nw.rank,
           inp.cand_mask, inp.tier_masks, inp.tier_part, inp.preq, inp.pjob,
           inp.pjg, inp.first, inp.run_id, inp.run_end, inp.job_end,
           inp.score_g, inp.needed, inp.jalloc0, inp.total]
    ptrs = (ctypes.c_int64 * _PTRS)(*([t.data_ptr() for t in ins] + [0] + [
        t.data_ptr() for t in (owner, task_node, job_done, stats)]))
    sptrs = (ctypes.c_int64 * len(work))(*[t.data_ptr() for t in work])
    kinds = [int(drf) for drf, _ in layout]
    leads = [lead for _, lead in layout]
    ints = [N, W, R, P, PJ, V1, AJ1, G, len(tier_kinds), M,
            int(gang_commit), 0, 0, 0]
    ints += kinds + [0] * (MAX_TIERS - len(kinds))
    ints += list(tier_sizes) + [0] * (MAX_TIERS - len(tier_sizes))
    ints += leads + [0] * (MAX_TIERS - len(leads))
    cints = (ctypes.c_int * _INTS)(*ints)
    with torch.cuda.device(device):
        err = _lib().vt_evict_walk_sharded(
            ptrs, cints, sptrs, shards,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise KernelError(f"walk_sharded_cuda: kernel launch failed with "
                          f"cudaError_t {err}")
    walk_sharded_cuda.launches += 1
    steps, dispatches, opens = stats.tolist()
    return WalkOutput(task_node, owner, job_done.to(b8), steps, dispatches,
                      opens)


# kernel launches since each count was last reset (chip_smoke.py reads them)
walk_cuda.launches = 0
walk_sharded_cuda.launches = 0


def walk(inp: WalkInputs, tier_kinds: Tuple[str, ...],
         tier_sizes: Tuple[int, ...], gang_commit: bool,
         shards: int = 1) -> WalkOutput:
    """The walk on the inputs' device over ``shards`` shards of the node
    axis: the CUDA kernel for CUDA tensors (``walk_sharded_cuda`` for more
    than one shard), the plain version for CPU tensors."""
    device = inp.fidle0.device
    if device.type == "cuda":
        if shards > 1:
            return walk_sharded_cuda(inp, tier_kinds, tier_sizes,
                                     gang_commit, shards)
        return walk_cuda(inp, tier_kinds, tier_sizes, gang_commit)
    if device.type == "cpu":
        return walk_plain(inp, tier_kinds, tier_sizes, gang_commit,
                          shards=shards)
    raise ValueError(f"walk: no walk kernel for device {device}")
