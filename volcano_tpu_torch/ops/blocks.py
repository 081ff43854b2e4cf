"""The block auction (B4): the ``tpu-blocks`` allocate engine's solve, as
three CUDA kernels (``blocks_cuda``, csrc/blocks.cu) and as their plain
PyTorch version (``blocks_plain``).

Replaces the XLA program volcano_tpu/ops/unified.py::_chunk_step and
_make_blocks_solve (the unsharded ``place_blocks_unified``), itself the
block-greedy form of the reference's allocate loop
(actions/allocate/allocate.go:42-277). Tasks go in chunks of C (256): a
chunk scores all its tasks against the current node state at once, each
task keeps its best K = min(32, N) nodes, and up to K bidding rounds let a
task rejected at its r-th choice fall to its (r+1)-th; contention for a
node is settled in three waves of exclusive same-node request sums, then
nine steps split the accepted tasks into allocations (Idle) and pipelines
(FutureIdle). Passes repeat the chunks for the tasks left over, and a
sweep ends with the gang vote, which frees every task of a job that missed
its minAvailable. Every loop exits at its fixpoint, exactly where the
reference's does.

Float sums over tasks round in the reference's order — XLA:CPU's, which
the CPU tests compare against: a [C,N]-one-hot sum (claims, deltas) adds
tasks in index order, a [C,C] product (the waves' and the split's request
sums) adds them in four lanes by index mod 4, joined as
``(l0 + l1) + (l2 + l3)``, and the sweep's frees add each block of 256
tasks in order and the blocks' sums in order. XLA:CPU picks its order by
shape and buffer placement; this is the one it gives the production chunk
of 256 (at a chunk of 8 it sums the split in order, and it blocks frees
over 1,280 tasks otherwise). ``blocks_plain`` computes
each sum in that order, unless the sum and every partial sum of it are
exact in f32 (the requests' bits and the sum's total show it: ``sum_unit``),
when no order can change a bit and it sums any way. The round kernel sums
in that order too, except in a chunk whose requests' column totals stay
below 2^24 units (``chunk_exact``), where it sums in parallel.

Over a node mesh of D shards (``shards``, unified.py's ``axis``; ops/unified.py
holds the mesh) the same solve runs node-sharded: each shard takes the K_loc =
min(32, N/D) best of its own nodes, the shards' lists merge into the global
K (``merge_plain``: a stable sort of the shard-major concatenation, so equal
scores go to the lowest global node), a node's contention is decided by the
shard that owns it and the shards' verdicts are OR-ed each round, and each
shard applies deltas and frees to its own rows only. Every decision is the
unsharded solve's (a node's sums involve only its own tasks, and the merged
list is the unsharded one), so the packed wire and node state are equal to
the bit at every D. On the card this is the candidate kernel once a shard
over its own rows, ``blocks_merge_kernel``, and the round kernel as a
thread-block cluster of D CTAs (``round_sharded_cuda``).

``blocks`` picks the version by the tensors' device: the plain one only
for CPU tensors.
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import build
from .build import KernelError
from .place import EPS, MAX_R, NEG, NEG_TEST, NO_NODE
from .scores import ScoreWeights, combined_dynamic_score

K_CAND = 32          # candidate nodes a task bids for
CHUNK = 256          # tasks a chunk scores at once
MAX_CHUNK = 256      # the round kernel runs one thread a task of a chunk
MAX_SHARDS = 8       # the sharded round kernel's cluster: a CTA a shard
ALLOC_STEPS = 9      # alloc-vs-pipeline split steps (unified.py:293)
FREE_BLOCK = 256     # the sweep's frees sum blocks of this many tasks


class NodeState(NamedTuple):
    idle: torch.Tensor          # f32[N,R]
    future_idle: torch.Tensor   # f32[N,R] = idle + releasing - pipelined
    used: torch.Tensor          # f32[N,R]
    ntasks: torch.Tensor        # i32[N]


class JobMeta(NamedTuple):
    min_available: torch.Tensor  # i32[J]
    base_ready: torch.Tensor     # i32[J] allocated before this action
    base_pipelined: torch.Tensor  # i32[J] pipelined before this action


class BlockTasks(NamedTuple):
    """Pending tasks in priority order."""

    req: torch.Tensor           # f32[T,R]
    job_ix: torch.Tensor        # i32[T]
    valid: torch.Tensor         # bool[T]
    feas: torch.Tensor          # bool[T,N]
    static_score: torch.Tensor  # f32[T,N]


BlocksOutput = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                     torch.Tensor]


def padded_task_len(T: int, chunk: int = CHUNK) -> int:
    """Padded task-axis length of the packed layout."""
    return T + (-T) % chunk


# ---------------------------------------------------------------------------
# sums over tasks, in the reference's order
# ---------------------------------------------------------------------------

def _unit_and_ok(req: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sum_unit``'s unit (f64[R]) and whether it holds (a bool tensor:
    no request negative, subnormal, infinite or NaN), with no read back to
    the host."""
    bits = req.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    expo = (bits >> 23) & 0xFF
    nonzero = bits != 0
    ok = ~(((bits >> 31) != 0).any()
           | (nonzero & ((expo == 0) | (expo == 0xFF))).any())
    mant = (bits & 0x7FFFFF) | 0x800000
    low = mant & -mant                       # the lowest set bit, <= 2^23
    # log2 of that power of two, exactly: the exponent field of it as f32
    log2_low = ((low.to(torch.int32).float().view(torch.int32) >> 23)
                - 127).long()
    valuation = expo - 150 + log2_low
    big = 1 << 20
    unit = torch.where(nonzero, valuation, big).min(dim=0).values
    unit = torch.where(unit == big, 0, unit)
    # 2^unit as f64, exactly: its exponent field
    return ((unit + 1023) << 52).view(torch.float64), ok


def sum_unit(req: torch.Tensor) -> Optional[torch.Tensor]:
    """f64[R]: per column, the largest power of two dividing every nonzero
    request (1 for an all-zero column); None when a request is negative,
    subnormal, infinite or NaN. A sum of such requests whose total stays
    below 2^24 units has every partial sum, in any order, an integer
    number of units below 2^24: exact in f32, so no order changes a bit."""
    unit, ok = _unit_and_ok(req)
    return unit if bool(ok) else None


def chunk_exact(req: torch.Tensor, chunk: int) -> torch.Tensor:
    """bool[Tp/chunk]: whether every sum over a subset of the chunk's
    requests is exact in f32 — the chunk's column totals below 2^24 units
    of ``sum_unit(req)`` (the solve's unit). Then no order of the round
    kernel's sums (claims, waves, split, deltas: all over tasks of one
    chunk) can change a bit. Tensor ops on ``req``'s device, no read back."""
    unit, ok = _unit_and_ok(req)
    R = req.shape[1]
    total = req.double().reshape(-1, chunk, R).sum(dim=1)
    return ok & (total < unit * 2.0 ** 24).all(dim=1)


def task_classes(req: torch.Tensor, masked_static: Optional[torch.Tensor],
                 chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rows of each chunk grouped by what their candidates depend on:
    the request's bits and the masked static row's bits (or no static
    row). Returns ``(cls i32[Tp], class_rep i32[Tp/chunk, chunk], n_class
    i32[Tp/chunk])``: each row's class in its chunk (classes numbered in
    the order of their first row), each class's first row (chunk-local;
    unused entries 0) and the number of classes. The plain version of
    ``prep_cuda``'s class kernel, one chunk at a time."""
    Tp = req.shape[0]
    dev = req.device
    words = req.contiguous().view(torch.int32)
    if masked_static is not None:
        words = torch.cat([words, masked_static.contiguous().view(
            torch.int32)], dim=1)
    n = Tp // chunk
    cls = torch.empty(Tp, dtype=torch.int32, device=dev)
    class_rep = torch.zeros((n, chunk), dtype=torch.int32, device=dev)
    n_class = torch.empty(n, dtype=torch.int32, device=dev)
    rows = torch.arange(chunk, device=dev)
    for c in range(n):
        _, same = torch.unique(words[c * chunk:(c + 1) * chunk], dim=0,
                               return_inverse=True)
        first = torch.full((chunk,), chunk, device=dev).scatter_reduce(
            0, same, rows, "amin")[same]          # each row's first twin
        is_first = first == rows
        local = is_first.cumsum(dim=0) - 1
        cls[c * chunk:(c + 1) * chunk] = local[first].to(torch.int32)
        class_rep[c, local[is_first]] = rows[is_first].to(torch.int32)
        n_class[c] = is_first.sum()
    return cls, class_rep, n_class


def _exact(total: torch.Tensor, unit: Optional[torch.Tensor]) -> bool:
    """Every partial sum behind these f64 totals (of nonnegative terms,
    multiples of ``unit``) is exact in f32."""
    return unit is not None and bool((total < unit * 2.0 ** 24).all())


def _node_sums(node: torch.Tensor, vals: torch.Tensor, N: int,
               unit: Optional[torch.Tensor]) -> torch.Tensor:
    """f32[N,R]: for each node, the rows of ``vals`` whose ``node`` is it
    (-1: none), added in row order."""
    R = vals.shape[1]
    pick = node >= 0
    node, vals = node[pick], vals[pick]
    if unit is not None:
        out = torch.zeros(N, R, dtype=torch.float64, device=vals.device)
        out.index_add_(0, node, vals.double())
        if _exact(out, unit):
            return out.float()
    out = torch.zeros(N, R, dtype=torch.float32, device=vals.device)
    if node.numel() == 0:
        return out
    order = torch.sort(node, stable=True).indices
    node, vals = node[order], vals[order]
    count = torch.bincount(node, minlength=N)
    start = torch.cumsum(count, 0) - count
    rank = torch.arange(node.numel(), device=node.device) - start[node]
    for k in range(int(count.max())):
        at = rank == k                       # one row per node
        out[node[at]] = out[node[at]] + vals[at]
    return out


def _lane_prefix(node: torch.Tensor, live: torch.Tensor, vals: torch.Tensor,
                 unit: Optional[torch.Tensor]) -> torch.Tensor:
    """f32[C,R]: for each row i, the sum over rows j < i on the same node
    with ``live[j]`` of ``vals[j]`` — the [C,C] product's order: four
    lanes by j mod 4, each in order, joined as (l0 + l1) + (l2 + l3)."""
    C = node.shape[0]
    ar = torch.arange(C, device=node.device)
    m = ((node[:, None] == node[None, :]) & (ar[:, None] > ar[None, :])
         & live[None, :])
    if unit is not None:
        out = m.double() @ vals.double()
        if _exact(out, unit):
            return out.float()
    lanes = torch.zeros(4, C, vals.shape[1], dtype=torch.float32,
                        device=vals.device)
    for j in range(C):
        rows = m[:, j]
        lanes[j % 4, rows] = lanes[j % 4, rows] + vals[j]
    return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


def _block_node_sums(node: torch.Tensor, vals: torch.Tensor, N: int,
                     unit: Optional[torch.Tensor]) -> torch.Tensor:
    """``_node_sums`` over the whole task axis as the sweep's einsum adds
    it: each block of FREE_BLOCK rows in order, then the blocks' sums in
    order."""
    if unit is not None:
        pick = node >= 0
        total = torch.zeros(N, vals.shape[1], dtype=torch.float64,
                            device=vals.device)
        total.index_add_(0, node[pick], vals[pick].double())
        if _exact(total, unit):
            return total.float()
    out = torch.zeros(N, vals.shape[1], dtype=torch.float32,
                      device=vals.device)
    for lo in range(0, node.shape[0], FREE_BLOCK):
        hi = lo + FREE_BLOCK
        if bool((node[lo:hi] >= 0).any()):
            out = out + _node_sums(node[lo:hi], vals[lo:hi], N, None)
    return out


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def masked_scores(fidle: torch.Tensor, used: torch.Tensor,
                  ntasks: torch.Tensor, allocatable: torch.Tensor,
                  max_tasks: torch.Tensor, req_c: torch.Tensor,
                  ms_c: Optional[torch.Tensor],
                  weights: ScoreWeights) -> torch.Tensor:
    """f32[C,N]: each task's dynamic (+ masked static) score on each node,
    -inf where the node does not fit (FutureIdle, pod count, static
    mask): what a chunk's candidates are chosen from (unified.py:175-186)."""
    fit = ((req_c[:, None, :] < fidle[None] + EPS).all(dim=-1)
           & (ntasks < max_tasks)[None])
    score = combined_dynamic_score(req_c, used, allocatable, weights)
    if ms_c is not None:
        fit = fit & (ms_c > NEG_TEST)
        score = score + ms_c
    return torch.where(fit, score, -torch.inf)


def topk_plain(fidle: torch.Tensor, used: torch.Tensor, ntasks: torch.Tensor,
               allocatable: torch.Tensor, max_tasks: torch.Tensor,
               req_c: torch.Tensor, ms_c: Optional[torch.Tensor],
               weights: ScoreWeights, K: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A chunk's candidates (unified.py:175-204): each task's K best nodes
    by ``masked_scores``, highest first, equal scores in node order; unfit
    nodes score -inf and fill the list in node order when fewer than K
    fit."""
    masked = masked_scores(fidle, used, ntasks, allocatable, max_tasks,
                           req_c, ms_c, weights)
    vals, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    return vals[:, :K].contiguous(), idx[:, :K].contiguous()


def merge_plain(part_score: torch.Tensor, part_cand: torch.Tensor, Nl: int,
                K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global candidates from D shards' lists (unified.py:195-204):
    ``part_score``/``part_cand`` [D,C,Kl] (shard-local nodes, shard s
    owning global nodes s*Nl ...), concatenated shard-major and sorted
    stably by score, highest first; the first K. The plain version of
    ``merge_cuda``."""
    D, C, Kl = part_score.shape
    gid = part_cand.long() + (torch.arange(D, device=part_cand.device)
                              * Nl)[:, None, None]
    flat_s = part_score.permute(1, 0, 2).reshape(C, D * Kl)
    flat_i = gid.permute(1, 0, 2).reshape(C, D * Kl)
    vals, pos = torch.sort(flat_s, dim=1, descending=True, stable=True)
    return (vals[:, :K].contiguous(),
            flat_i.gather(1, pos[:, :K]).contiguous())


def _shard(state: NodeState, s: int, Nl: int) -> NodeState:
    """Shard s's rows of the node state (views)."""
    return NodeState(*(x[s * Nl:(s + 1) * Nl] for x in state))


def _join(parts) -> NodeState:
    """The shards' node states as one."""
    return NodeState(*(torch.cat(xs) for xs in zip(*parts)))


def _round_shard(fidle, nt, max_tasks, off: int, Nl: int,
                 accept: torch.Tensor, choice: torch.Tensor,
                 bid: torch.Tensor, bidding: torch.Tensor,
                 req_c: torch.Tensor, unit: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """One bidding round's accept verdicts for the bidders on one shard's
    nodes ``[off, off + Nl)`` (unified.py:211-242): claims of the tasks
    accepted there, then the three waves."""
    C = req_c.shape[0]
    dev = req_c.device
    own = (bid >= off) & (bid < off + Nl)
    bid_l = torch.clamp(bid - off, 0, Nl - 1)
    bidding_l = bidding & own
    held_ok = accept & (choice >= off) & (choice < off + Nl)
    held = torch.where(held_ok, choice - off, -1)
    claimed = _node_sums(held, req_c, Nl, unit)
    claimed_cnt = torch.bincount(choice[held_ok] - off, minlength=Nl)
    avail = fidle[bid_l] - claimed[bid_l]
    base_cnt = nt[bid_l].long() + claimed_cnt[bid_l]
    maxt = max_tasks[bid_l].long()
    ar = torch.arange(C, device=dev)
    same = (bid_l[:, None] == bid_l[None, :]) & (ar[:, None] > ar[None, :])

    def wave(mask):
        live = mask & bidding_l
        cum = _lane_prefix(bid_l, live, req_c, unit)
        cnt = (same & live[None, :]).sum(dim=1)
        room = (req_c + cum < avail + EPS).all(dim=-1)
        return bidding_l & room & (base_cnt + cnt < maxt)

    acc = wave(torch.ones(C, dtype=torch.bool, device=dev))
    acc = acc | wave(acc)
    return wave(acc)


def round_plain(state: NodeState, max_tasks: torch.Tensor,
                req_c: torch.Tensor, todo_c: torch.Tensor,
                cand_score: torch.Tensor, cand: torch.Tensor,
                unit: Optional[torch.Tensor],
                stats: Optional[Dict[str, int]] = None, shards: int = 1
                ) -> Tuple[NodeState, torch.Tensor, torch.Tensor]:
    """Everything of a chunk after scoring (unified.py:206-308): the
    bidding rounds to their fixpoint or K, the alloc/pipe split, the
    deltas. Returns the new node state and each task's (node or NO_NODE,
    pipelined). Over ``shards`` equal shards of the node axis, each shard
    decides the bids for its own nodes and the verdicts are OR-ed, the
    split runs on each task's owner shard and its alloc verdicts are
    OR-ed, and each shard applies its own deltas (unified.py:243-305)."""
    idle, fidle, used, nt = state
    C = req_c.shape[0]
    N = idle.shape[0]
    Nl = N // shards
    K = cand.shape[1]
    dev = req_c.device
    accept = torch.zeros(C, dtype=torch.bool, device=dev)
    choice = torch.full((C,), -1, dtype=torch.long, device=dev)
    slot = torch.zeros(C, dtype=torch.long, device=dev)
    rounds = 0
    changed = True
    while rounds < K and changed:
        bid = cand.gather(1, slot[:, None])[:, 0].long()
        bscore = cand_score.gather(1, slot[:, None])[:, 0]
        bidding = ~accept & todo_c & (bscore > -torch.inf)
        acc = torch.zeros(C, dtype=torch.bool, device=dev)
        for s in range(shards):
            sl = slice(s * Nl, (s + 1) * Nl)
            acc = acc | _round_shard(fidle[sl], nt[sl], max_tasks[sl],
                                     s * Nl, Nl, accept, choice, bid,
                                     bidding, req_c, unit)
        new_choice = torch.where(acc, bid, choice)
        new_accept = accept | acc
        new_slot = torch.where(bidding & ~acc,
                               torch.clamp(slot + 1, max=K - 1), slot)
        changed = bool((new_accept != accept).any()
                       | (new_choice != choice).any()
                       | (new_slot != slot).any())
        accept, choice, slot = new_accept, new_choice, new_slot
        rounds += 1
    if stats is not None:
        stats["rounds"] = stats.get("rounds", 0) + rounds

    # alloc-vs-pipeline split: nine steps of the antitone fit map, on each
    # task's owner shard
    alloc = torch.zeros(C, dtype=torch.bool, device=dev)
    parts = []
    for s in range(shards):
        off = s * Nl
        mine = accept & (choice >= off) & (choice < off + Nl)
        sh = _shard(state, s, Nl)
        node = torch.where(mine, choice - off, 0)
        idle_bid = sh.idle[node]
        alloc_l = mine.clone()
        for _ in range(ALLOC_STEPS):
            cum = _lane_prefix(node, alloc_l & mine, req_c, unit)
            alloc_l = mine & (req_c + cum < idle_bid + EPS).all(dim=-1)
        alloc = alloc | alloc_l
        delta_alloc = _node_sums(torch.where(alloc_l, choice - off, -1),
                                 req_c, Nl, unit)
        delta_all = _node_sums(torch.where(mine, choice - off, -1), req_c,
                               Nl, unit)
        placed = torch.bincount(choice[mine] - off,
                                minlength=Nl).to(nt.dtype)
        parts.append(NodeState(sh.idle - delta_alloc,
                               sh.future_idle - delta_all,
                               sh.used + delta_alloc, sh.ntasks + placed))
    pipe = accept & ~alloc
    out = torch.where(accept, choice, NO_NODE).to(torch.int32)
    return _join(parts), out, pipe


def free_plain(state: NodeState, assign: torch.Tensor, pipe: torch.Tensor,
               drop: torch.Tensor, req: torch.Tensor,
               unit: Optional[torch.Tensor]
               ) -> NodeState:
    """The sweep's gang rollback on the node state (unified.py:413-428):
    every dropped task's request back on its node, Idle too where it had
    allocated."""
    idle, fidle, used, nt = state
    N = idle.shape[0]
    node = assign.long()
    freed_alloc = _block_node_sums(torch.where(drop & ~pipe, node, -1), req,
                                   N, unit)
    freed_all = _block_node_sums(torch.where(drop, node, -1), req, N, unit)
    count = torch.bincount(node[drop], minlength=N).to(nt.dtype)
    return NodeState(idle + freed_alloc, fidle + freed_all,
                     used - freed_alloc, nt - count)


def _segment_count(job_ix: torch.Tensor, mask: torch.Tensor,
                   J: int) -> torch.Tensor:
    return torch.zeros(J, dtype=torch.int32, device=job_ix.device).index_add_(
        0, job_ix.long(), mask.to(torch.int32))


def gang_vote(assign: torch.Tensor, pipe: torch.Tensor, job_ix: torch.Tensor,
              jobs: JobMeta):
    """(ready, kept, drop) of a sweep's gang vote (unified.py:401-412):
    ready counts allocations only; a merely pipelined gang is kept; a task
    of a job not kept is dropped."""
    J = jobs.min_available.shape[0]
    placed = assign != NO_NODE
    alloc_cnt = _segment_count(job_ix, placed & ~pipe, J)
    pipe_cnt = _segment_count(job_ix, placed & pipe, J)
    ready = alloc_cnt + jobs.base_ready >= jobs.min_available
    kept = (alloc_cnt + pipe_cnt + jobs.base_ready + jobs.base_pipelined
            >= jobs.min_available)
    drop = placed & ~kept[job_ix.long()]
    dead = ~kept & (alloc_cnt + pipe_cnt > 0)
    return ready, kept, drop, dead


def _time(timing, name, fn):
    """Run ``fn``; with a ``timing`` dict, add its host wall seconds (the
    device synchronised before and after) under ``name``."""
    if timing is None:
        return fn()
    sync = (torch.cuda.synchronize if torch.cuda.is_available()
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    timing[name] = timing.get(name, 0.0) + time.perf_counter() - t0
    return out


def blocks_plain(idle: torch.Tensor, future_idle: torch.Tensor,
                 used: torch.Tensor, ntasks: torch.Tensor,
                 allocatable: torch.Tensor, max_tasks: torch.Tensor,
                 req: torch.Tensor, valid: torch.Tensor,
                 job_ix: torch.Tensor, jobs: JobMeta,
                 masked_static: Optional[torch.Tensor],
                 weights: ScoreWeights, chunk: int = CHUNK, sweeps: int = 3,
                 passes: int = 3, timing: Optional[Dict[str, float]] = None,
                 stats: Optional[Dict[str, int]] = None,
                 shards: int = 1) -> BlocksOutput:
    """The solve with tensor ops on any device (unified.py:313-446). The
    task axis is padded: ``req [Tp,R]``, ``valid [Tp]`` bool, ``job_ix
    [Tp]`` i32, ``masked_static [Tp,N]`` or None, Tp a multiple of
    ``chunk``. Returns ``(packed, idle, future_idle, used, ntasks)`` with
    ``packed`` the i32 row ``[assign Tp | pipe Tp | ready J | kept J]``;
    the inputs are not modified. ``timing`` collects the host seconds of
    the parts the kernels do, by kernel name ("blocks_topk",
    "blocks_round", "blocks_free"; sharded also "blocks_merge" and
    "blocks_round_sharded"); ``stats`` counts the chunks and rows with
    work, the rounds, passes and sweeps run and the tasks the sweeps
    dropped. ``shards`` > 1 runs the node-sharded form over that many
    equal shards of the node axis (N a multiple of it), one shard after
    another and gathered in shard order; its outputs are the unsharded
    solve's."""
    Tp = req.shape[0]
    N = idle.shape[0]
    J = jobs.min_available.shape[0]
    if shards < 1 or N % shards:
        raise ValueError(f"blocks_plain: {N} nodes do not split into "
                         f"{shards} shards")
    Nl = N // shards
    K = min(K_CAND, N)
    K_loc = min(K_CAND, Nl)
    dev = req.device
    unit = sum_unit(req)
    stats = {} if stats is None else stats
    state = NodeState(idle.clone(), future_idle.clone(), used.clone(),
                      ntasks.clone())
    assign = torch.full((Tp,), NO_NODE, dtype=torch.int32, device=dev)
    pipe = torch.zeros(Tp, dtype=torch.bool, device=dev)
    job_dead = torch.zeros(J, dtype=torch.bool, device=dev)
    ready = torch.zeros(J, dtype=torch.bool, device=dev)
    kept = torch.zeros(J, dtype=torch.bool, device=dev)
    jx = job_ix.long()

    def todo_of(assign, job_dead):
        return (assign == NO_NODE) & valid & ~job_dead[jx]

    def one_pass(state, assign, pipe, job_dead):
        todo = todo_of(assign, job_dead)
        fresh = assign == NO_NODE
        out = torch.full((Tp,), NO_NODE, dtype=torch.int32, device=dev)
        out_pipe = torch.zeros(Tp, dtype=torch.bool, device=dev)
        for lo in range(0, Tp, chunk):
            hi = lo + chunk
            if not bool(todo[lo:hi].any()):
                continue                  # the identity (guarded_step)
            stats["chunks"] = stats.get("chunks", 0) + 1
            stats["rows"] = stats.get("rows", 0) + int(todo[lo:hi].sum())
            ms_c = None if masked_static is None else masked_static[lo:hi]
            if shards == 1:
                cs, cand = _time(timing, "blocks_topk", lambda: topk_plain(
                    state.future_idle, state.used, state.ntasks, allocatable,
                    max_tasks, req[lo:hi], ms_c, weights, K))
            else:
                lists = []
                for s in range(shards):
                    sl = slice(s * Nl, (s + 1) * Nl)
                    lists.append(_time(
                        timing, "blocks_topk", lambda: topk_plain(
                            state.future_idle[sl], state.used[sl],
                            state.ntasks[sl], allocatable[sl],
                            max_tasks[sl], req[lo:hi],
                            None if ms_c is None else ms_c[:, sl],
                            weights, K_loc)))
                cs, cand = _time(timing, "blocks_merge", lambda: merge_plain(
                    torch.stack([v for v, _ in lists]),
                    torch.stack([i for _, i in lists]), Nl, K))
            state, out[lo:hi], out_pipe[lo:hi] = _time(
                timing, "blocks_round" if shards == 1
                else "blocks_round_sharded", lambda: round_plain(
                    state, max_tasks, req[lo:hi], todo[lo:hi], cs, cand,
                    unit, stats, shards))
        assign = torch.where(fresh, out, assign)
        pipe = torch.where(fresh, out_pipe, pipe)
        return state, assign, pipe

    s, changed_s = 0, True
    while s < sweeps and changed_s:
        assign_in, dead_in = assign, job_dead
        k = 0
        changed_p = bool(todo_of(assign, job_dead).any())
        while k < passes and changed_p:
            state, assign2, pipe = one_pass(state, assign, pipe, job_dead)
            changed_p = bool((assign2 != assign).any()
                             & todo_of(assign2, job_dead).any())
            assign = assign2
            k += 1
            stats["passes"] = stats.get("passes", 0) + 1
        ready, kept, drop, dead = gang_vote(assign, pipe, job_ix, jobs)
        stats["dropped"] = stats.get("dropped", 0) + int(drop.sum())
        state = _time(timing, "blocks_free", lambda: _join([
            free_plain(_shard(state, s, Nl),
                       torch.where(drop & own, assign - s * Nl, NO_NODE),
                       pipe, drop & own, req, unit)
            for s in range(shards)
            for own in [(assign >= s * Nl) & (assign < (s + 1) * Nl)]]))
        assign = torch.where(drop, NO_NODE, assign)
        job_dead = job_dead | dead
        changed_s = bool((assign != assign_in).any()
                         | (job_dead != dead_in).any())
        s += 1
        stats["sweeps"] = stats.get("sweeps", 0) + 1
    packed = torch.cat([assign, pipe.to(torch.int32), ready.to(torch.int32),
                        kept.to(torch.int32)])
    return (packed, *state)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

# device counters (i32, one solve): rows with work the candidate kernel
# served, chunks the round kernel worked on, bidding rounds they ran, tasks
# accepted in the current pass (the kernels add to these), tasks the sweeps
# dropped, candidate lists the candidate kernel computed (one a class with
# work), and chunks the round kernel summed in its exact mode
ROWS, CHUNKS, ROUNDS, ACCEPTED, DROPPED, CLASSES, EXACT_CHUNKS = range(7)


def _lib():
    lib = build.load("blocks")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vt_blocks_topk.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, f, f,
                                   f, f, p, p, p, p, i, p, i, p, p, p, i, i,
                                   i, i, i, i, i, p]
    lib.vt_blocks_topk_scratch.argtypes = [i, p, p]
    lib.vt_blocks_topk_scratch.restype = None
    lib.vt_blocks_round.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, p, p,
                                    p, p, i, i, i, i, i, p]
    lib.vt_blocks_free.argtypes = [p, p, p, p, p, p, p, p, p, i, i, p]
    lib.vt_blocks_prep.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.vt_blocks_round_sharded.argtypes = [p, p, p, p, p, p, p, p, p, p, p,
                                            p, p, p, p, p, i, i, i, i, i, i,
                                            p]
    lib.vt_blocks_merge.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    for fn in (lib.vt_blocks_topk, lib.vt_blocks_round, lib.vt_blocks_free,
               lib.vt_blocks_prep, lib.vt_blocks_round_sharded,
               lib.vt_blocks_merge):
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"blocks_cuda: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"blocks_cuda: {name} is {t.dtype}, not {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"blocks_cuda: {name} has shape {tuple(t.shape)}, "
                         f"not {shape}")
    if not t.is_contiguous():
        raise ValueError(f"blocks_cuda: {name} is not contiguous")


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise KernelError(f"blocks_cuda: {name} kernel launch failed with "
                          f"cudaError_t {err}")


class _Events:
    """CUDA event pairs around each launch, summed by kernel at the end."""

    def __init__(self, timing: Optional[Dict[str, float]]):
        self.timing = timing
        self.pairs = []

    def run(self, name: str, launch):
        if self.timing is None:
            return launch()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch()
        end.record()
        self.pairs.append((name, start, end))
        return out

    def close(self):
        if self.timing is None:
            return
        torch.cuda.synchronize()
        for name, start, end in self.pairs:
            self.timing[name] = (self.timing.get(name, 0.0)
                                 + start.elapsed_time(end) / 1e3)


def blocks_cuda(idle: torch.Tensor, future_idle: torch.Tensor,
                used: torch.Tensor, ntasks: torch.Tensor,
                allocatable: torch.Tensor, max_tasks: torch.Tensor,
                req: torch.Tensor, valid: torch.Tensor,
                job_ix: torch.Tensor, jobs: JobMeta,
                masked_static: Optional[torch.Tensor],
                weights: ScoreWeights, chunk: int = CHUNK, sweeps: int = 3,
                passes: int = 3, timing: Optional[Dict[str, float]] = None,
                stats: Optional[Dict[str, int]] = None,
                shards: int = 1) -> BlocksOutput:
    """The solve through the kernels of ``csrc/blocks.cu`` on the current
    stream: once, each row's class (``task_classes``) and each chunk's
    exactness flag (``chunk_exact``) by ``blocks_prep``; per pass, for each
    chunk, one launch of the candidate kernel (``blocks_topk``, a list a
    class with work, on a grid of two blocks an SM) and one of the round
    kernel (``blocks_round``, one block, a thread a task); per sweep, the
    gang vote's counts and the frees' grouping by node as tensor ops and one
    launch of ``blocks_free`` (a thread a node) for the frees. The host
    reads one flag per pass (none after a sweep's last allowed pass) and one
    per sweep (none after the last). Same inputs and outputs as
    ``blocks_plain``; every tensor must lie on one CUDA device. ``timing``
    collects each kernel's device seconds (CUDA events around every launch),
    the classes' and flags' as "blocks_prep" and the frees' grouping's as
    "blocks_free_prep"; ``stats`` the chunks and rows with work, the
    candidate lists computed ("classes"), the chunks summed in the exact
    mode ("chunks_exact"), the rounds, passes and sweeps run and the tasks
    the sweeps dropped. With ``shards`` D of 2 to 8 (the portable cluster
    size) it runs the node-sharded form: a chunk launches the candidate
    kernel once a shard over the shard's rows (its K_loc best into slot s of
    a [D, chunk, K_loc] buffer), ``blocks_merge`` and one cluster of D CTAs
    of ``blocks_round_sharded``; the frees launch once a shard.
    Raises on a tensor it does not take, a failed build or a failed
    launch."""
    device = idle.device
    if device.type != "cuda":
        raise ValueError(f"blocks_cuda: tensors are on {device}, not a CUDA "
                         f"device")
    N, R = idle.shape
    Tp = req.shape[0]
    J = jobs.min_available.shape[0]
    if not 2 <= R <= MAX_R:
        raise ValueError(f"blocks_cuda: {R} resource columns; the kernels "
                         f"take 2..{MAX_R}")
    if not 1 <= chunk <= MAX_CHUNK or Tp % chunk:
        raise ValueError(f"blocks_cuda: chunk {chunk} must be 1..{MAX_CHUNK} "
                         f"and divide the {Tp} tasks")
    if N >= 1 << 31 or N < 1:
        raise ValueError(f"blocks_cuda: {N} nodes")
    if not 1 <= shards <= MAX_SHARDS or N % shards:
        raise ValueError(f"blocks_cuda: {N} nodes in {shards} shards; the "
                         f"kernels take 1..{MAX_SHARDS} equal shards")
    for name, t, dtype, shape in (
            ("idle", idle, torch.float32, (N, R)),
            ("future_idle", future_idle, torch.float32, (N, R)),
            ("used", used, torch.float32, (N, R)),
            ("ntasks", ntasks, torch.int32, (N,)),
            ("allocatable", allocatable, torch.float32, (N, R)),
            ("max_tasks", max_tasks, torch.int32, (N,)),
            ("req", req, torch.float32, (Tp, R)),
            ("valid", valid, torch.bool, (Tp,)),
            ("job_ix", job_ix, torch.int32, (Tp,)),
            ("min_available", jobs.min_available, torch.int32, (J,)),
            ("base_ready", jobs.base_ready, torch.int32, (J,)),
            ("base_pipelined", jobs.base_pipelined, torch.int32, (J,))):
        _check(name, t, dtype, shape, device)
    if masked_static is not None:
        _check("masked_static", masked_static, torch.float32, (Tp, N), device)
    res = torch.as_tensor(weights.binpack_res, dtype=torch.float32,
                          device=device).contiguous()
    if tuple(res.shape) != (R,):
        raise ValueError(f"blocks_cuda: binpack_res has shape "
                         f"{tuple(res.shape)}, not ({R},)")
    with torch.cuda.device(device):
        return _drive(idle, future_idle, used, ntasks, allocatable,
                      max_tasks, req, valid, job_ix, jobs, masked_static,
                      weights, res, chunk, sweeps, passes, timing, stats,
                      shards)


def _drive(idle, future_idle, used, ntasks, allocatable, max_tasks, req,
           valid, job_ix, jobs, masked_static, weights, res, chunk, sweeps,
           passes, timing, stats, shards) -> BlocksOutput:
    """blocks_cuda's loops over sweeps, passes and chunks, on checked
    tensors."""
    N = idle.shape[0]
    Tp = req.shape[0]
    J = jobs.min_available.shape[0]
    device = idle.device
    K = min(K_CAND, N)
    Nl = N // shards
    K_loc = min(K_CAND, Nl)
    state = NodeState(idle.clone(), future_idle.clone(), used.clone(),
                      ntasks.clone())
    if allocatable.data_ptr() % 16:
        allocatable = allocatable.clone()    # the 16-byte row loads
    assign = torch.full((Tp,), NO_NODE, dtype=torch.int32, device=device)
    pipe = torch.zeros(Tp, dtype=torch.int32, device=device)
    job_dead = torch.zeros(J, dtype=torch.bool, device=device)
    ready = torch.zeros(J, dtype=torch.bool, device=device)
    kept = torch.zeros(J, dtype=torch.bool, device=device)
    cand = torch.empty((chunk, K), dtype=torch.int32, device=device)
    cand_score = torch.empty((chunk, K), dtype=torch.float32, device=device)
    counters = torch.zeros(7, dtype=torch.int32, device=device)
    if shards > 1:
        # each shard's lists, and counters for the shards past the first
        # (the rows and classes count once)
        part_cand = torch.zeros((shards, chunk, K_loc), dtype=torch.int32,
                                device=device)
        part_score = torch.zeros((shards, chunk, K_loc), dtype=torch.float32,
                                 device=device)
        spare = torch.zeros(7, dtype=torch.int32, device=device)
    jx = job_ix.long()
    stats = {} if stats is None else stats
    events = _Events(timing)
    classes, exact = events.run("blocks_prep", lambda: prep_cuda(
        req, masked_static, chunk))
    scratch = topk_scratch(
        2 * torch.cuda.get_device_properties(device).multi_processor_count,
        device)

    def todo_any(assign, job_dead):
        return ((assign == NO_NODE) & valid & ~job_dead[jx]).any()

    def one_pass():
        counters[ACCEPTED] = 0
        for lo in range(0, Tp, chunk):
            if shards == 1:
                events.run("blocks_topk", lambda: topk_cuda(
                    state, allocatable, max_tasks, res, weights, req, valid,
                    job_ix, job_dead, assign, masked_static, classes,
                    scratch, lo, chunk, cand, cand_score, counters))
                events.run("blocks_round", lambda: round_cuda(
                    state, max_tasks, req, valid, job_ix, job_dead, assign,
                    pipe, classes[0], exact, cand, cand_score, lo, chunk,
                    counters))
                continue
            for s in range(shards):
                sl = slice(s * Nl, (s + 1) * Nl)
                events.run("blocks_topk", lambda: topk_cuda(
                    _shard(state, s, Nl), allocatable[sl], max_tasks[sl],
                    res, weights, req, valid, job_ix, job_dead, assign,
                    masked_static, classes, scratch, lo, chunk,
                    part_cand[s], part_score[s],
                    counters if s == 0 else spare, col0=s * Nl))
            events.run("blocks_merge", lambda: merge_cuda(
                part_cand, part_score, classes[2], cand, cand_score, lo,
                chunk, Nl))
            events.run("blocks_round_sharded", lambda: round_sharded_cuda(
                state, max_tasks, req, valid, job_ix, job_dead, assign, pipe,
                classes[0], exact, cand, cand_score, lo, chunk, counters,
                shards))

    # a sweep's pass loop starts on any(todo): read here for the first,
    # with the sweep's changed flag for the others
    s, changed_s = 0, True
    todo_next = bool(todo_any(assign, job_dead))
    while s < sweeps and changed_s:
        assign_in, dead_in = assign.clone(), job_dead
        k, changed_p = 0, todo_next
        while k < passes and changed_p:
            one_pass()
            k += 1
            stats["passes"] = stats.get("passes", 0) + 1
            if k < passes:
                changed_p = bool((counters[ACCEPTED] > 0)
                                 & todo_any(assign, job_dead))
        ready, kept, drop, dead = gang_vote(assign, pipe.bool(), job_ix,
                                            jobs)
        groups = events.run("blocks_free_prep",
                            lambda: free_groups(assign, drop, N))
        for sh in range(shards):
            sl = slice(sh * Nl, (sh + 1) * Nl)
            events.run("blocks_free", lambda: free_cuda(
                _shard(state, sh, Nl), req, pipe, groups[0], groups[1][sl],
                groups[2][sl]))
        counters[DROPPED] += drop.sum(dtype=torch.int32)
        assign.masked_fill_(drop, NO_NODE)
        job_dead = job_dead | dead
        s += 1
        stats["sweeps"] = stats.get("sweeps", 0) + 1
        if s < sweeps:
            changed_s, todo_next = torch.stack([
                (assign != assign_in).any() | (job_dead != dead_in).any(),
                todo_any(assign, job_dead)]).tolist()
    events.close()
    counts = counters.tolist()
    stats["rows"] = stats.get("rows", 0) + counts[ROWS]
    stats["chunks"] = stats.get("chunks", 0) + counts[CHUNKS]
    stats["rounds"] = stats.get("rounds", 0) + counts[ROUNDS]
    stats["dropped"] = stats.get("dropped", 0) + counts[DROPPED]
    stats["classes"] = stats.get("classes", 0) + counts[CLASSES]
    stats["chunks_exact"] = (stats.get("chunks_exact", 0)
                             + counts[EXACT_CHUNKS])
    packed = torch.cat([assign, pipe, ready.to(torch.int32),
                        kept.to(torch.int32)])
    return (packed, *state)


def prep_cuda(req: torch.Tensor, masked_static: Optional[torch.Tensor],
              chunk: int) -> Tuple[Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor], torch.Tensor]:
    """One call of ``vt_blocks_prep`` (the class kernel, a block a chunk,
    then the exactness kernel, one block): ``(task_classes(req,
    masked_static, chunk), chunk_exact(req, chunk))`` computed on the card,
    the flags as u8. Arguments as ``blocks_cuda`` checked them."""
    Tp, R = req.shape
    n = Tp // chunk
    dev = req.device
    cls = torch.empty(Tp, dtype=torch.int32, device=dev)
    class_rep = torch.zeros((n, chunk), dtype=torch.int32, device=dev)
    n_class = torch.empty(n, dtype=torch.int32, device=dev)
    total = torch.empty((n, R), dtype=torch.float64, device=dev)
    valuation = torch.empty((n, R), dtype=torch.int32, device=dev)
    bad = torch.empty(n, dtype=torch.int32, device=dev)
    exact = torch.empty(n, dtype=torch.uint8, device=dev)
    N = 1 if masked_static is None else masked_static.shape[1]
    err = _lib().vt_blocks_prep(
        req.data_ptr(),
        None if masked_static is None else masked_static.data_ptr(),
        cls.data_ptr(), class_rep.data_ptr(), n_class.data_ptr(),
        total.data_ptr(), valuation.data_ptr(), bad.data_ptr(),
        exact.data_ptr(), Tp, chunk, N, R,
        torch.cuda.current_stream().cuda_stream)
    _launched("blocks_prep", err)
    prep_cuda.launches += 1
    return (cls, class_rep, n_class), exact


def topk_scratch(grid: int, device: torch.device
                 ) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """``(grid, part, done)`` for ``topk_cuda`` on ``grid`` blocks: the
    splits' lists and the groups' counters (zero), sized by
    ``vt_blocks_topk_scratch``."""
    part_n, done_n = ctypes.c_int(), ctypes.c_int()
    _lib().vt_blocks_topk_scratch(grid, ctypes.byref(part_n),
                                  ctypes.byref(done_n))
    return (grid,
            torch.empty(part_n.value, dtype=torch.int64, device=device),
            torch.zeros(done_n.value, dtype=torch.int32, device=device))


def topk_cuda(state: NodeState, allocatable: torch.Tensor,
              max_tasks: torch.Tensor, res: torch.Tensor,
              weights: ScoreWeights, req: torch.Tensor, valid: torch.Tensor,
              job_ix: torch.Tensor, job_dead: torch.Tensor,
              assign: torch.Tensor, masked_static: Optional[torch.Tensor],
              classes: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
              scratch: Tuple[int, torch.Tensor, torch.Tensor], lo: int,
              chunk: int, cand: torch.Tensor, cand_score: torch.Tensor,
              counters: torch.Tensor, col0: int = 0) -> None:
    """One launch of ``blocks_topk_kernel`` for the chunk of tasks
    ``[lo, lo + chunk)``: the K candidates of each class (``task_classes``)
    with a row that still has work, into row ``class`` of
    ``cand``/``cand_score``, on the grid and scratch of ``topk_scratch``.
    The node state may be a shard's rows: its static scores are then the
    columns ``col0 ...`` of ``masked_static``, and its nodes shard-local.
    Arguments as ``blocks_cuda`` checked them."""
    N, R = state.idle.shape
    cls, class_rep, n_class = classes
    grid, part, done = scratch
    ms_ld = N if masked_static is None else masked_static.shape[1]
    err = _lib().vt_blocks_topk(
        state.future_idle.data_ptr(), state.used.data_ptr(),
        state.ntasks.data_ptr(), allocatable.data_ptr(),
        max_tasks.data_ptr(), res.data_ptr(), req.data_ptr(),
        valid.data_ptr(), job_ix.data_ptr(), job_dead.data_ptr(),
        assign.data_ptr(),
        None if masked_static is None
        else masked_static.data_ptr() + 4 * col0,
        weights.binpack_weight, weights.least_req_weight,
        weights.most_req_weight, weights.balanced_weight, cls.data_ptr(),
        class_rep.data_ptr(), n_class.data_ptr(), part.data_ptr(),
        part.numel(), done.data_ptr(), done.numel(), cand.data_ptr(),
        cand_score.data_ptr(), counters.data_ptr(), lo, chunk, N, R,
        cand.shape[1], ms_ld, grid, torch.cuda.current_stream().cuda_stream)
    _launched("blocks_topk", err)
    topk_cuda.launches += 1


def merge_cuda(part_cand: torch.Tensor, part_score: torch.Tensor,
               n_class: torch.Tensor, cand: torch.Tensor,
               cand_score: torch.Tensor, lo: int, chunk: int,
               Nl: int) -> None:
    """One launch of ``blocks_merge_kernel``: each class's global K
    candidates of the chunk ``[lo, lo + chunk)`` (``cand``/``cand_score``
    [chunk, K], global nodes) from the shards' lists ``part_*`` [D, chunk,
    K_loc] (shard-local nodes, Nl a shard): ``merge_plain``'s function, a
    warp a class."""
    D, _, K_loc = part_cand.shape
    err = _lib().vt_blocks_merge(
        part_cand.data_ptr(), part_score.data_ptr(), n_class.data_ptr(),
        cand.data_ptr(), cand_score.data_ptr(), lo, chunk, D, Nl, K_loc,
        cand.shape[1], torch.cuda.current_stream().cuda_stream)
    _launched("blocks_merge", err)
    merge_cuda.launches += 1


def round_sharded_cuda(state: NodeState, max_tasks: torch.Tensor,
                       req: torch.Tensor, valid: torch.Tensor,
                       job_ix: torch.Tensor, job_dead: torch.Tensor,
                       assign: torch.Tensor, pipe: torch.Tensor,
                       cls: torch.Tensor, exact: torch.Tensor,
                       cand: torch.Tensor, cand_score: torch.Tensor, lo: int,
                       chunk: int, counters: torch.Tensor,
                       shards: int) -> None:
    """One launch of the sharded ``blocks_round_kernel``, a cluster of
    ``shards`` CTAs over the whole node state (CTA s owning rows s*Nl ...):
    ``round_cuda``'s function, each node's contention and split decided by
    its owner CTA and the verdicts OR-ed through distributed shared
    memory."""
    N, R = state.idle.shape
    err = _lib().vt_blocks_round_sharded(
        state.idle.data_ptr(), state.future_idle.data_ptr(),
        state.used.data_ptr(), state.ntasks.data_ptr(), max_tasks.data_ptr(),
        req.data_ptr(), valid.data_ptr(), job_ix.data_ptr(),
        job_dead.data_ptr(), assign.data_ptr(), pipe.data_ptr(),
        cls.data_ptr(), exact.data_ptr(), cand.data_ptr(),
        cand_score.data_ptr(), counters.data_ptr(), lo, chunk, N // shards,
        R, cand.shape[1], shards, torch.cuda.current_stream().cuda_stream)
    _launched("blocks_round_sharded", err)
    round_sharded_cuda.launches += 1


def round_cuda(state: NodeState, max_tasks: torch.Tensor, req: torch.Tensor,
               valid: torch.Tensor, job_ix: torch.Tensor,
               job_dead: torch.Tensor, assign: torch.Tensor,
               pipe: torch.Tensor, cls: torch.Tensor, exact: torch.Tensor,
               cand: torch.Tensor, cand_score: torch.Tensor, lo: int,
               chunk: int, counters: torch.Tensor) -> None:
    """One launch of ``blocks_round_kernel`` for the chunk ``[lo, lo +
    chunk)``: its bidding rounds, the alloc/pipe split, the deltas on the
    node state and the chunk's fresh tasks' assignments; a row reads its
    class's candidates (``cls``), and the chunk sums in the exact mode
    where ``exact`` (``chunk_exact``, u8) says so."""
    N, R = state.idle.shape
    err = _lib().vt_blocks_round(
        state.idle.data_ptr(), state.future_idle.data_ptr(),
        state.used.data_ptr(), state.ntasks.data_ptr(), max_tasks.data_ptr(),
        req.data_ptr(), valid.data_ptr(), job_ix.data_ptr(),
        job_dead.data_ptr(), assign.data_ptr(), pipe.data_ptr(),
        cls.data_ptr(), exact.data_ptr(), cand.data_ptr(),
        cand_score.data_ptr(), counters.data_ptr(), lo, chunk, N, R,
        cand.shape[1], torch.cuda.current_stream().cuda_stream)
    _launched("blocks_round", err)
    round_cuda.launches += 1


def free_groups(assign: torch.Tensor, drop: torch.Tensor, N: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dropped tasks grouped by node in task order, with integer tensor
    ops (a stable sort of node keys, counts by index_add_ of ones):
    (order i32[Tp], start i32[N+1], count i32[N+1]); node n's dropped tasks
    are order[start[n] : start[n] + count[n]]."""
    key = torch.where(drop, assign.long(), N)
    order = torch.sort(key, stable=True).indices.to(torch.int32)
    count = torch.zeros(N + 1, dtype=torch.int32, device=key.device)
    count.index_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    start = (torch.cumsum(count, 0, dtype=torch.int32) - count).contiguous()
    return order, start, count


def free_cuda(state: NodeState, req: torch.Tensor, pipe: torch.Tensor,
              order: torch.Tensor, start: torch.Tensor,
              count: torch.Tensor) -> None:
    """One launch of ``blocks_free_kernel``: every dropped task's request
    back on its node, in the sweep's block order, from ``free_groups``'
    grouping."""
    N, R = state.idle.shape
    err = _lib().vt_blocks_free(
        state.idle.data_ptr(), state.future_idle.data_ptr(),
        state.used.data_ptr(), state.ntasks.data_ptr(), req.data_ptr(),
        pipe.data_ptr(), order.data_ptr(), start.data_ptr(),
        count.data_ptr(), N, R,
        torch.cuda.current_stream().cuda_stream)
    _launched("blocks_free", err)
    free_cuda.launches += 1


# kernel launches since each count was last reset (chip_smoke.py reads them)
prep_cuda.launches = 0
topk_cuda.launches = 0
round_cuda.launches = 0
free_cuda.launches = 0
merge_cuda.launches = 0
round_sharded_cuda.launches = 0


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def blocks(idle: torch.Tensor, future_idle: torch.Tensor, used: torch.Tensor,
           ntasks: torch.Tensor, allocatable: torch.Tensor,
           max_tasks: torch.Tensor, req: torch.Tensor, valid: torch.Tensor,
           job_ix: torch.Tensor, jobs: JobMeta,
           masked_static: Optional[torch.Tensor], weights: ScoreWeights,
           chunk: int = CHUNK, sweeps: int = 3, passes: int = 3,
           stats: Optional[Dict[str, int]] = None,
           shards: int = 1) -> BlocksOutput:
    """The solve on the tensors' device, over ``shards`` shards of the
    node axis: the kernels for CUDA tensors, the plain version for CPU
    tensors."""
    device = idle.device
    if device.type == "cuda":
        solve = blocks_cuda
    elif device.type == "cpu":
        solve = blocks_plain
    else:
        raise ValueError(f"blocks: no block-auction kernel for device "
                         f"{device}")
    return solve(idle, future_idle, used, ntasks, allocatable, max_tasks, req,
                 valid, job_ix, jobs, masked_static, weights, chunk=chunk,
                 sweeps=sweeps, passes=passes, stats=stats, shards=shards)


def _device_meta(jobs: JobMeta, device) -> JobMeta:
    return JobMeta(*(torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                     device=device).contiguous()
                     if not isinstance(a, torch.Tensor)
                     else a.to(device=device, dtype=torch.int32).contiguous()
                     for a in jobs))


def place_blocks_unified(mesh, nodes: NodeState, req: torch.Tensor,
                         valid: torch.Tensor, job_ix: torch.Tensor,
                         jobs: JobMeta, weights: ScoreWeights,
                         allocatable: torch.Tensor, max_tasks: torch.Tensor,
                         chunk: int = CHUNK, sweeps: int = 3, passes: int = 3,
                         masked_static: Optional[torch.Tensor] = None,
                         stats: Optional[Dict[str, int]] = None
                         ) -> Tuple[torch.Tensor, NodeState]:
    """Blocks-mode placement (unified.py:497-540), unsharded (``mesh``
    None) or node-sharded over ``mesh`` (ops/unified.py's Mesh; the node
    axis N must be a multiple of its size). Pads the task axis to a
    multiple of ``chunk`` (``valid`` false, static rows ``NEG``) and
    returns ``(packed, nodes)``: the i32 row ``[assign Tp | pipe Tp | ready
    J | kept J]``, Tp = ``padded_task_len(T, chunk)``, and the final node
    state, both on the device. A one-slot mesh runs the unsharded solve
    (unified.py:518-519): the sharded one gives the same bits, so this
    changes no decision."""
    shards = 1 if mesh is None else mesh.size
    N = allocatable.shape[0]
    if N % shards:
        raise ValueError(f"place_blocks_unified: node count {N} not "
                         f"divisible by mesh size {shards}")
    req, valid, job_ix, masked_static = pad_tasks(req, valid, job_ix,
                                                  masked_static, chunk)
    out = blocks(nodes.idle, nodes.future_idle, nodes.used, nodes.ntasks,
                 allocatable, max_tasks, req, valid, job_ix,
                 _device_meta(jobs, req.device), masked_static, weights,
                 chunk=chunk, sweeps=sweeps, passes=passes, stats=stats,
                 shards=shards)
    return out[0], NodeState(*out[1:])


def pad_tasks(req: torch.Tensor, valid: torch.Tensor, job_ix: torch.Tensor,
              masked_static: Optional[torch.Tensor], chunk: int = CHUNK):
    """The task axis padded to a multiple of ``chunk``, contiguous and in
    the solve's types: ``valid`` false and static rows ``NEG`` on the
    padding (unified.py:525-532)."""
    pad = (-req.shape[0]) % chunk
    valid = valid.to(torch.bool)
    job_ix = job_ix.to(torch.int32)
    if pad:
        req = torch.nn.functional.pad(req, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
        job_ix = torch.nn.functional.pad(job_ix, (0, pad))
        if masked_static is not None:
            masked_static = torch.nn.functional.pad(
                masked_static, (0, 0, 0, pad), value=NEG)
    return (req.contiguous(), valid.contiguous(), job_ix.contiguous(),
            None if masked_static is None else masked_static.contiguous())


def place_blocks(nodes: NodeState, tasks: BlockTasks, jobs: JobMeta,
                 weights: ScoreWeights, allocatable: torch.Tensor,
                 max_tasks: torch.Tensor, chunk: int = CHUNK,
                 sweeps: int = 3, passes: int = 3):
    """Place tasks with dense feasibility and static score matrices
    (auction.py:50-76); returns (task_node i32[T], task_pipelined bool[T],
    job_ready bool[J], job_kept bool[J], nodes), on the device. The
    matrices fold into ``where(feas, static, NEG)``, which carries the same
    fit mask and, where feasible, the same score."""
    T = tasks.req.shape[0]
    J = jobs.min_available.shape[0]
    ms = torch.where(tasks.feas, tasks.static_score.float(),
                     torch.tensor(NEG, dtype=torch.float32,
                                  device=tasks.req.device))
    packed, out_nodes = place_blocks_unified(
        None, nodes, tasks.req, tasks.valid, tasks.job_ix, jobs, weights,
        allocatable, max_tasks, chunk=chunk, sweeps=sweeps, passes=passes,
        masked_static=ms)
    Tp = padded_task_len(T, chunk)
    return (packed[:T], packed[Tp:Tp + T].bool(),
            packed[2 * Tp:2 * Tp + J].bool(),
            packed[2 * Tp + J:2 * Tp + 2 * J].bool(), out_nodes)


def place_blocks_packed(nodes: NodeState, tasks: BlockTasks, jobs: JobMeta,
                        weights: ScoreWeights, allocatable: torch.Tensor,
                        max_tasks: torch.Tensor, chunk: int = CHUNK,
                        sweeps: int = 3, passes: int = 3):
    """place_blocks in the layout ``[task_node T | pipelined T | ready J |
    kept J]`` (auction.py:79-97), task spans of length T."""
    assign, pipe, ready, kept, nodes = place_blocks(
        nodes, tasks, jobs, weights, allocatable, max_tasks, chunk=chunk,
        sweeps=sweeps, passes=passes)
    packed = torch.cat([assign, pipe.to(torch.int32), ready.to(torch.int32),
                        kept.to(torch.int32)])
    return packed, nodes
