"""The placement solve: Volcano's allocate loop over every pending task of a
cycle, as one CUDA kernel (``place_cuda``) and as its plain PyTorch version
(``place_plain``).

The reference allocates task-by-task (actions/allocate/allocate.go:42-277),
mutating node Idle as it goes, and wraps each job's placements in a Statement
that commits only if the gang is Ready (statement.go:229-289,352-395). Per
task, in the given order:

- feasibility = resource fit vs FutureIdle with the reference's 0.1 epsilon
  (allocate.go:111-118), the pod-count cap, and the static mask (a ``NEG``
  entry of the masked static score matrix);
- score = static score + the dynamic scorers of ops/scores.py; best node by
  argmax, lowest node index on a tie (the reference breaks ties randomly,
  scheduler_helper.go:210-225);
- allocate if the task fits Idle, else pipeline onto FutureIdle
  (allocate.go:232-256); a task with no feasible node latches the job
  "broken" and the job's later tasks are skipped (allocate.go:206-210);
- at a job's last task the gang vote (gang.go jobReadyFn) commits the job,
  keeps it pipelined, or rolls the node state back to its first task's.

Both versions emit one packed i32 word per task, ``(node+1)<<4 | flags``,
and the final node state. ``place`` picks the version by the tensors'
device — the plain one only for CPU tensors — and decodes the words after
one device-to-host copy.

B6, the zone-anchor solve (the JAX package's ``place_scan_topo``), is a
mode of the same kernel (``place_topo_cuda``) and of the same plain loop
(``place_topo_plain``): every node whose zone code equals the job's anchor
zone scores ``+topo_weight``, the anchor being the zone of the job's first
placement.
``place`` takes it when given zone codes and a positive weight, and B1
otherwise, as the JAX package dispatches ``place_scan`` at weight 0.

The pipelined cycle's speculative solve decodes on the device instead:
``place_dispatch`` launches the solve and the decode (``decode_packed_cuda``,
B7, beside its plain version ``decode_packed_plain``) on a stream the caller
gives and returns without synchronizing the host; ``fetch_packed`` is its one
device-to-host copy.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import build
from .build import KernelError
from .scores import ScoreWeights, combined_dynamic_score

EPS = 0.1            # resource_info.go minResource: l <= r is l < r + 0.1
NEG = -1e30          # masked static score of a statically infeasible pair
NEG_TEST = -1e29     # anything below this is infeasible
NO_NODE = -1

# packed output flags
F_PLACE = 1
F_PIPE = 2
F_READY = 4
F_KEEP = 8

# input flags
VALID = 1
FIRST = 2
LAST = 4

MAX_R = 8            # resource columns the kernel is built for (2..8)

PlaceOutput = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                    torch.Tensor]


class PlacementResult(NamedTuple):
    task_node: np.ndarray       # i32[T] chosen node, NO_NODE unless kept
    task_pipelined: np.ndarray  # bool[T] pipelined (vs allocated)
    job_ready: np.ndarray       # bool[J] gang Ready -> committed (bind)
    job_kept: np.ndarray        # bool[J] state kept (ready or pipelined)
    idle: torch.Tensor          # f32[N,R] final committed node state
    future_idle: torch.Tensor
    used: torch.Tensor
    ntasks: torch.Tensor        # i32[N]


def task_flags(job_ix: np.ndarray, min_available: np.ndarray,
               base_ready: np.ndarray, base_pipelined: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-task inputs of the solve for a job-contiguous task list: the
    VALID/FIRST/LAST flags, and the allocations (``ready_need``) or
    allocations plus pipelines (``keep_need``) the task's job still needs
    for its gang vote."""
    T = len(job_ix)
    job_ix = np.asarray(job_ix, np.int32)
    first = np.zeros(T, bool)
    last = np.zeros(T, bool)
    if T:
        first[0] = True
        first[1:] = job_ix[1:] != job_ix[:-1]
        last[:-1] = job_ix[1:] != job_ix[:-1]
        last[-1] = True
    flags = (VALID + first * FIRST + last * LAST).astype(np.int32)
    ready_need = (min_available - base_ready)[job_ix].astype(np.int32)
    keep_need = (min_available - base_ready - base_pipelined)[job_ix].astype(
        np.int32)
    return flags, ready_need, keep_need


def place_plain(idle: torch.Tensor, future_idle: torch.Tensor,
                used: torch.Tensor, ntasks: torch.Tensor,
                allocatable: torch.Tensor, max_tasks: torch.Tensor,
                req: torch.Tensor, flags: torch.Tensor,
                ready_need: torch.Tensor, keep_need: torch.Tensor,
                masked_static: Optional[torch.Tensor],
                weights: ScoreWeights) -> PlaceOutput:
    """The solve as a Python loop over tasks with tensor ops over nodes, on
    any device. Same inputs and outputs as ``place_cuda``: node state
    ``[N,R]`` f32 and ``[N]`` i32, ``req [T,R]``, ``flags``/``ready_need``/
    ``keep_need [T]`` i32, ``masked_static [T,N]`` or None. Returns
    ``(packed [T] i32, idle, future_idle, used, ntasks)``; the inputs are
    not modified."""
    return _plain_loop(idle, future_idle, used, ntasks, allocatable,
                       max_tasks, req, flags, ready_need, keep_need,
                       masked_static, weights, None, 0.0)


def place_topo_plain(idle: torch.Tensor, future_idle: torch.Tensor,
                     used: torch.Tensor, ntasks: torch.Tensor,
                     allocatable: torch.Tensor, max_tasks: torch.Tensor,
                     req: torch.Tensor, flags: torch.Tensor,
                     ready_need: torch.Tensor, keep_need: torch.Tensor,
                     masked_static: Optional[torch.Tensor],
                     weights: ScoreWeights, zone_code: torch.Tensor,
                     topo_weight: float) -> PlaceOutput:
    """B6's plain version: ``place_plain`` with the anchor term of the JAX
    package's ``place_scan_topo`` step. ``zone_code`` i32 ``[N]`` (0 for an
    unzoned node or a hole row); ``topo_weight`` rounds to f32. A job's
    anchor is 0 at its first task and becomes the zone code of its first
    placement; while it is not 0, each node's score is
    ``(static + dynamic) + topo_weight * (zone_code == anchor)``."""
    return _plain_loop(idle, future_idle, used, ntasks, allocatable,
                       max_tasks, req, flags, ready_need, keep_need,
                       masked_static, weights, zone_code, topo_weight)


def _plain_loop(idle, future_idle, used, ntasks, allocatable, max_tasks,
                req, flags, ready_need, keep_need, masked_static, weights,
                zone_code: Optional[torch.Tensor],
                topo_weight: float) -> PlaceOutput:
    state = [idle.clone(), future_idle.clone(), used.clone(), ntasks.clone()]
    if zone_code is not None:
        tw = torch.tensor(topo_weight, dtype=torch.float32,
                          device=idle.device)
        zone_h = zone_code.tolist()
    anchor = 0
    flags_h = flags.tolist()
    ready_h = ready_need.tolist()
    keep_h = keep_need.tolist()
    out = [0] * len(flags_h)
    saved = None
    cnt_alloc = cnt_pipe = 0
    broken = False
    for i, f in enumerate(flags_h):
        if f & FIRST:
            saved = [t.clone() for t in state]
            cnt_alloc = cnt_pipe = 0
            broken = False
            anchor = 0
        word = 0
        if f & VALID and not broken:
            tidle, tfidle, tused, tnt = state
            q = req[i]
            fit = (q < tfidle + EPS).all(dim=1) & (tnt < max_tasks)
            score = combined_dynamic_score(q, tused, allocatable, weights)
            if masked_static is not None:
                fit = fit & (masked_static[i] > NEG_TEST)
                score = masked_static[i] + score
            if zone_code is not None:
                same = (zone_code == anchor) & (anchor != 0)
                score = score + tw * same.to(score.dtype)
            best = int(torch.argmax(torch.where(fit, score, -torch.inf)))
            if not bool(fit[best]):
                broken = True
            else:
                on_idle = bool((q < tidle[best] + EPS).all())
                if zone_code is not None and anchor == 0:
                    anchor = zone_h[best]
                tfidle[best] = tfidle[best] - q
                tnt[best] = tnt[best] + 1
                if on_idle:
                    tidle[best] = tidle[best] - q
                    tused[best] = tused[best] + q
                    cnt_alloc += 1
                else:
                    cnt_pipe += 1
                word = ((best + 1) << 4) | F_PLACE | (0 if on_idle else F_PIPE)
        if f & VALID and f & LAST:
            ready = cnt_alloc >= ready_h[i]
            keep = ready or cnt_alloc + cnt_pipe >= keep_h[i]
            word |= (F_READY if ready else 0) | (F_KEEP if keep else 0)
            if not keep:
                state = [t.clone() for t in saved]
        out[i] = word
    packed = torch.tensor(out, dtype=torch.int32, device=idle.device)
    return (packed, *state)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device, fn: str = "place_cuda") -> None:
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} is {t.dtype}, not {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"not {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} is not contiguous")


def upload(a, device: torch.device) -> torch.Tensor:
    """A host array as a new tensor on ``device``, without synchronizing
    the host: on a CUDA device the copy goes through pinned memory,
    non-blocking on the current stream (the caching host allocator keeps
    the pinned block until the copy is done)."""
    t = torch.from_numpy(np.array(a, copy=True, order="C"))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


# Launch plan of the kernel (csrc/place.cu): a cluster of CTAs over the
# node axis, each owning a contiguous slice; its node arrays in shared memory
# when the slice fits. The byte counts mirror place.cu's fixed_bytes,
# node_bytes and tree_bytes, and the C entry refuses a plan whose bytes
# differ.
SMEM_MAX = 232_448          # dynamic shared memory a Hopper CTA may use
CLUSTER_SIZES = (1, 2, 4, 8, 16)
CHUNK = 32                  # tasks staged per chunk (place.cu kChunk)
# A node a thread, at most 512: a bulk re-score was fastest so, and a
# one-node step does not depend on the thread count (PERF.md, PR 2).
MIN_THREADS, MAX_THREADS = 64, 512


class LaunchPlan(NamedTuple):
    cluster: int        # CTAs in the cluster (the grid is one cluster)
    threads: int        # threads per CTA
    slice: int          # nodes per CTA: CTA k owns [k*slice, (k+1)*slice)
    smem_bytes: int     # dynamic shared memory per CTA
    in_smem: bool       # node state, key cache, group keys in shared memory
    ro_smem: bool       # alloc and max_tasks in shared memory too


def fixed_bytes(R: int) -> int:
    """Shared memory of a CTA besides its nodes: the cluster exchange's two
    mbarriers and key slots, the bulk command, two staged chunks of the
    task stream."""
    return 2 * 8 + 2 * 16 * 8 + 64 + 2 * CHUNK * (4 + R) * 4


def node_bytes(R: int, has_static: bool, ro: bool,
               topo: bool = False) -> int:
    """Shared memory per node of a slice: the cached key (8), the mutable
    planes and pod count, the job tag, the stale flag; with a static matrix
    the cached static value; with ``ro`` alloc and max_tasks; in B6's mode
    (``topo``) the zone code."""
    return (8 + (3 * R + 1) * 4 + 4 + 1 + (4 if has_static else 0)
            + (R * 4 + 4 if ro else 0) + (4 if topo else 0))


def tree_bytes(slice_: int) -> int:
    """The best key of each 32 nodes of a slice."""
    return 8 * -(-slice_ // 32)


def _smem(R: int, has_static: bool, ro: bool, slice_: int,
          topo: bool) -> int:
    return (fixed_bytes(R) + slice_ * node_bytes(R, has_static, ro, topo)
            + tree_bytes(slice_))


def launch_plan(N: int, R: int, has_static: bool, max_cluster: int = 16,
                cluster: Optional[int] = None,
                topo: bool = False) -> LaunchPlan:
    """Where the solve runs: ``cluster`` CTAs of one thread a node of the
    slice (a multiple of 32, 64 to 512). The node arrays live in shared
    memory exactly when a slice's fit beside the fixed part; alloc and
    max_tasks join them when they fit too.

    The default cluster is one CTA when all N nodes fit its shared memory,
    else the largest size up to ``max_cluster``. A task that re-scores one
    node is fastest on one CTA, where no cluster exchange sits on the
    chain; a task that re-scores every node (a new request) divides that
    work by the cluster size. chip_smoke.py times every size on the
    10k-pod / 2k-node solve (one CTA's worth of nodes, fastest at C=1), on
    R=3 at 8,192 nodes with a new request every task, and on gangs of one
    request at 8,192 and 16,384 nodes (both fastest at C=16); PERF.md has
    the H100 numbers. ``topo``: B6's mode, which keeps a zone code a node
    beside the rest."""
    sizes = [c for c in CLUSTER_SIZES if c <= max_cluster]
    if not sizes:
        raise ValueError(f"launch_plan: no cluster size within {max_cluster}")
    if cluster is None:
        one = _smem(R, has_static, False, max(1, N), topo) <= SMEM_MAX
        cluster = 1 if one else sizes[-1]
    if cluster not in sizes:
        raise ValueError(f"launch_plan: cluster {cluster} not in {sizes}")
    slice_ = max(1, -(-N // cluster))
    threads = min(MAX_THREADS, max(MIN_THREADS, -(-slice_ // 32) * 32))
    if _smem(R, has_static, True, slice_, topo) <= SMEM_MAX:
        in_smem, ro = True, True
    elif _smem(R, has_static, False, slice_, topo) <= SMEM_MAX:
        in_smem, ro = True, False
    else:
        in_smem, ro = False, False
    smem = (_smem(R, has_static, ro, slice_, topo) if in_smem
            else fixed_bytes(R))
    return LaunchPlan(cluster, threads, slice_, smem, in_smem, ro)


def scratch_bytes(plan: LaunchPlan, N: int) -> int:
    """Device memory for the node arrays a plan keeps out of shared memory:
    keys, every CTA's group keys, job tags, cached static values, stale
    flags."""
    if plan.in_smem:
        return 0
    return 17 * N + plan.cluster * tree_bytes(plan.slice)


def _lib():
    lib = build.load("place")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vt_place.argtypes = [p, p, p, p, p, p, p, p, p, f, f, f, f, p, f, p,
                             p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.vt_place.restype = ctypes.c_int
    lib.vt_place_active_clusters.argtypes = [i, i, i, i, i,
                                             ctypes.POINTER(ctypes.c_int)]
    lib.vt_place_active_clusters.restype = ctypes.c_int
    lib.vt_rowdiff.argtypes = [p, i, i, p, p]
    lib.vt_rowdiff.restype = ctypes.c_int
    lib.vt_decode_packed.argtypes = [p, p, i, i, p, p]
    lib.vt_decode_packed.restype = ctypes.c_int
    return lib


def active_clusters(R: int, plan: LaunchPlan, topo: bool = False) -> int:
    """How many clusters of this plan the card holds at once (of B6's mode
    with ``topo``); 0 means the launch would be refused. Raises if the
    query itself fails."""
    count = ctypes.c_int(0)
    err = _lib().vt_place_active_clusters(R, int(topo), plan.cluster,
                                          plan.threads, plan.smem_bytes,
                                          ctypes.byref(count))
    if err != 0:
        raise KernelError(f"place_cuda: cluster query failed with "
                          f"cudaError_t {err}")
    return count.value


_max_cluster: Optional[int] = None


def max_cluster() -> int:
    """The largest cluster size the card launches with a full CTA
    (MAX_THREADS threads, all of its shared memory), asked once."""
    global _max_cluster
    if _max_cluster is None:
        full = [LaunchPlan(c, MAX_THREADS, 1, SMEM_MAX, True, True)
                for c in CLUSTER_SIZES]
        ok = [p.cluster for p in full if active_clusters(2, p) > 0]
        if not ok:
            raise KernelError("place_cuda: the card launches no cluster")
        _max_cluster = max(ok)
    return _max_cluster


def place_cuda(idle: torch.Tensor, future_idle: torch.Tensor,
               used: torch.Tensor, ntasks: torch.Tensor,
               allocatable: torch.Tensor, max_tasks: torch.Tensor,
               req: torch.Tensor, flags: torch.Tensor,
               ready_need: torch.Tensor, keep_need: torch.Tensor,
               masked_static: Optional[torch.Tensor],
               weights: ScoreWeights,
               cluster: Optional[int] = None) -> PlaceOutput:
    """The solve as one launch of the CUDA kernel ``csrc/place.cu`` on the
    current stream, after ``rowdiff_cuda`` when there is a static matrix.
    Same inputs and outputs as ``place_plain``; every tensor must lie on one
    CUDA device. ``cluster`` overrides the launch plan's cluster size (tests
    and chip_smoke.py run every size). Raises on a tensor it does not take,
    a cluster the card cannot launch, a failed build or a failed launch."""
    return _place_launch(place_cuda, idle, future_idle, used, ntasks,
                         allocatable, max_tasks, req, flags, ready_need,
                         keep_need, masked_static, weights, cluster, None,
                         0.0)


def place_topo_cuda(idle: torch.Tensor, future_idle: torch.Tensor,
                    used: torch.Tensor, ntasks: torch.Tensor,
                    allocatable: torch.Tensor, max_tasks: torch.Tensor,
                    req: torch.Tensor, flags: torch.Tensor,
                    ready_need: torch.Tensor, keep_need: torch.Tensor,
                    masked_static: Optional[torch.Tensor],
                    weights: ScoreWeights, zone_code: torch.Tensor,
                    topo_weight: float,
                    cluster: Optional[int] = None) -> PlaceOutput:
    """B6: ``place_topo_plain`` as one launch of ``csrc/place.cu``'s
    zone-anchor mode, with ``place_cuda``'s inputs, outputs, launch plan
    and checks, and ``zone_code`` an i32 ``[N]`` tensor on the same
    device."""
    return _place_launch(place_topo_cuda, idle, future_idle, used, ntasks,
                         allocatable, max_tasks, req, flags, ready_need,
                         keep_need, masked_static, weights, cluster,
                         zone_code, topo_weight)


def _place_launch(wrapper, idle, future_idle, used, ntasks, allocatable,
                  max_tasks, req, flags, ready_need, keep_need,
                  masked_static, weights, cluster, zone_code,
                  topo_weight) -> PlaceOutput:
    """One launch of the placement kernel, B6's mode with ``zone_code``;
    counts it in ``wrapper.launches``."""
    device = idle.device
    if device.type != "cuda":
        raise ValueError(f"place_cuda: tensors are on {device}, not a CUDA "
                         f"device")
    N, R = idle.shape
    T = req.shape[0]
    if not 2 <= R <= MAX_R:
        raise ValueError(f"place_cuda: {R} resource columns; the kernel "
                         f"takes 2..{MAX_R}")
    if N >= 1 << 26:
        raise ValueError(f"place_cuda: {N} nodes overflow the packed word")
    for name, t, dtype, shape in (
            ("idle", idle, torch.float32, (N, R)),
            ("future_idle", future_idle, torch.float32, (N, R)),
            ("used", used, torch.float32, (N, R)),
            ("ntasks", ntasks, torch.int32, (N,)),
            ("allocatable", allocatable, torch.float32, (N, R)),
            ("max_tasks", max_tasks, torch.int32, (N,)),
            ("req", req, torch.float32, (T, R)),
            ("flags", flags, torch.int32, (T,)),
            ("ready_need", ready_need, torch.int32, (T,)),
            ("keep_need", keep_need, torch.int32, (T,))):
        _check(name, t, dtype, shape, device)
    if masked_static is not None:
        _check("masked_static", masked_static, torch.float32, (T, N), device)
    topo = zone_code is not None
    if topo:
        _check("zone_code", zone_code, torch.int32, (N,), device)

    # node-major [N,R] -> resource-major [R,N]: a CTA copies each resource
    # row of its slice coalesced
    state = torch.stack([idle.t(), future_idle.t(), used.t()]).contiguous()
    nt = ntasks.clone()
    alloc_rn = allocatable.t().contiguous()
    res = upload(np.asarray(weights.binpack_res, np.float32), device)
    if tuple(res.shape) != (R,):
        raise ValueError(f"place_cuda: binpack_res has shape "
                         f"{tuple(res.shape)}, not ({R},)")
    saved = torch.empty_like(state)
    saved_nt = torch.empty_like(nt)
    packed = torch.empty(T, dtype=torch.int32, device=device)
    if T:
        with torch.cuda.device(device):
            plan = launch_plan(N, R, masked_static is not None,
                               max_cluster(), cluster, topo)
            if cluster is not None and active_clusters(R, plan, topo) == 0:
                raise KernelError(f"place_cuda: the card cannot launch "
                                  f"{plan}")
            scratch = torch.empty(scratch_bytes(plan, N), dtype=torch.uint8,
                                  device=device)
            rowdiff = (None if masked_static is None
                       else rowdiff_cuda(masked_static))
            stream = torch.cuda.current_stream(device).cuda_stream
            err = _lib().vt_place(
                req.data_ptr(), flags.data_ptr(), ready_need.data_ptr(),
                keep_need.data_ptr(),
                None if masked_static is None else masked_static.data_ptr(),
                None if rowdiff is None else rowdiff.data_ptr(),
                alloc_rn.data_ptr(), max_tasks.data_ptr(), res.data_ptr(),
                weights.binpack_weight, weights.least_req_weight,
                weights.most_req_weight, weights.balanced_weight,
                zone_code.data_ptr() if topo else None, float(topo_weight),
                state.data_ptr(), nt.data_ptr(), saved.data_ptr(),
                saved_nt.data_ptr(), scratch.data_ptr() or None,
                packed.data_ptr(), T, N, R, plan.cluster, plan.threads,
                plan.slice, int(plan.in_smem), int(plan.ro_smem),
                plan.smem_bytes, stream)
        if err != 0:
            raise KernelError(f"place_cuda: kernel launch failed with "
                              f"cudaError_t {err} ({plan})")
        wrapper.launches += 1
    return (packed, state[0].t().contiguous(), state[1].t().contiguous(),
            state[2].t().contiguous(), nt)


# kernel launches since the count was last reset (chip_smoke.py reads it)
place_cuda.launches = 0
place_topo_cuda.launches = 0


def rowdiff_plain(masked_static: torch.Tensor) -> torch.Tensor:
    """i32[T]: 1 where a task's static row differs bitwise from the row
    before it (the first row always), else 0; any device."""
    bits = masked_static.view(torch.int32)
    out = torch.ones(bits.shape[0], dtype=torch.int32, device=bits.device)
    if bits.shape[0] > 1:
        out[1:] = (bits[1:] != bits[:-1]).any(dim=1).to(torch.int32)
    return out


def rowdiff_cuda(masked_static: torch.Tensor) -> torch.Tensor:
    """``rowdiff_plain`` as one launch of ``csrc/place.cu``'s rowdiff
    kernel on the current stream; ``masked_static`` a contiguous f32
    ``[T,N]`` CUDA tensor. place_cuda runs it before the solve, which reads
    a task's static row only where it is marked. Raises on a tensor it does
    not take, a failed build or a failed launch."""
    device = masked_static.device
    if device.type != "cuda":
        raise ValueError(f"rowdiff_cuda: the matrix is on {device}, not a "
                         f"CUDA device")
    _check("masked_static", masked_static, torch.float32,
           tuple(masked_static.shape), device)
    T, N = masked_static.shape
    out = torch.empty(T, dtype=torch.int32, device=device)
    if T:
        with torch.cuda.device(device):
            err = _lib().vt_rowdiff(
                masked_static.data_ptr(), T, N, out.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise KernelError(f"rowdiff_cuda: kernel launch failed with "
                              f"cudaError_t {err}")
        rowdiff_cuda.launches += 1
    return out


rowdiff_cuda.launches = 0


def task_rescores(packed: np.ndarray, flags: np.ndarray, req: np.ndarray,
                  masked_static: Optional[np.ndarray], N: int,
                  zone_code: Optional[np.ndarray] = None) -> np.ndarray:
    """The nodes the kernel's cache rule re-scores for each task the solve
    evaluated (valid, its job not yet broken), in task order, given these
    inputs and this solve's packed words: every node when the task's
    request differs from the last evaluated task's, else only the nodes
    whose static entry differs from that task's, that were picked since, or
    that a rejected gang restored since (the nodes its tasks' words
    name). With ``zone_code`` (B6), also the nodes of the old and the new
    anchor zone when the job's anchor moved since the last evaluated
    task."""
    packed = np.asarray(packed)
    flags = np.asarray(flags)
    req = np.asarray(req, np.float32).view(np.uint32)
    ms = (None if masked_static is None
          else np.asarray(masked_static, np.float32).view(np.uint32))
    zone = None if zone_code is None else np.asarray(zone_code)
    counts = []
    last = -1
    dirty = set()
    job_nodes = []
    broken = False
    anchor = scored = 0
    for i, f in enumerate(flags.tolist()):
        w = int(packed[i])
        if f & FIRST:
            job_nodes = []
            broken = False
            anchor = 0
        if f & VALID and not broken:
            if last < 0 or (req[i] != req[last]).any():
                counts.append(N)
            else:
                stale = set(dirty)
                if ms is not None:
                    stale.update(np.flatnonzero(ms[i] != ms[last]).tolist())
                if zone is not None and anchor != scored:
                    stale.update(np.flatnonzero(
                        (zone != 0) & ((zone == anchor) | (zone == scored))
                    ).tolist())
                counts.append(len(stale))
            dirty = set()
            last = i
            scored = anchor
            if w & F_PLACE:
                node = (w >> 4) - 1
                dirty.add(node)
                job_nodes.append(node)
                if zone is not None and anchor == 0:
                    anchor = int(zone[node])
            else:
                broken = True
        if f & VALID and f & LAST and not w & F_KEEP:
            dirty.update(job_nodes)
    return np.asarray(counts, np.int64)


def scored_pairs(packed: np.ndarray, flags: np.ndarray, req: np.ndarray,
                 masked_static: Optional[np.ndarray], N: int) -> int:
    """The (task, node) scorings the kernel's cache rule requires for these
    inputs and this solve's packed words (``task_rescores`` summed)."""
    return int(task_rescores(packed, flags, req, masked_static, N).sum())


def unpack_placement(packed: np.ndarray, job_ix: np.ndarray, J: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Decode the packed words into (task_node, task_pipelined, job_ready,
    job_kept). A job's verdict rides its last task's word; a task keeps its
    node only if its job was kept."""
    job_ix = np.asarray(job_ix, np.int32)
    node = (packed >> 4) - 1
    flags = packed & 0xF
    job_ready = np.zeros(J, bool)
    job_kept = np.zeros(J, bool)
    boundary = (flags & (F_READY | F_KEEP)) != 0
    job_ready[job_ix[boundary]] = (flags[boundary] & F_READY) != 0
    job_kept[job_ix[boundary]] = (flags[boundary] & F_KEEP) != 0
    task_node = np.where(job_kept[job_ix] & ((flags & F_PLACE) != 0),
                         node, NO_NODE).astype(np.int32)
    return task_node, (flags & F_PIPE) != 0, job_ready, job_kept


def _solver(device: torch.device, zone_code: Optional[torch.Tensor],
            topo_weight: float, fn: str):
    """The solve for tensors on ``device``, a callable of place_plain's
    arguments: the CUDA kernel, or the plain version on the CPU; B6's mode
    when there are zone codes and a positive weight, else B1."""
    topo = zone_code is not None and topo_weight > 0.0
    if device.type == "cuda":
        if not topo:
            return place_cuda
        return lambda *a: place_topo_cuda(*a, zone_code, topo_weight)
    if device.type == "cpu":
        if not topo:
            return place_plain
        return lambda *a: place_topo_plain(*a, zone_code, topo_weight)
    raise ValueError(f"{fn}: no placement kernel for device {device}")


def place(idle: torch.Tensor, future_idle: torch.Tensor, used: torch.Tensor,
          ntasks: torch.Tensor, allocatable: torch.Tensor,
          max_tasks: torch.Tensor, req: torch.Tensor, job_ix: np.ndarray,
          masked_static: Optional[torch.Tensor], min_available: np.ndarray,
          base_ready: np.ndarray, base_pipelined: np.ndarray,
          weights: ScoreWeights, zone_code: Optional[torch.Tensor] = None,
          topo_weight: float = 0.0) -> PlacementResult:
    """Solve a job-contiguous task list on the node tensors' device: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors; with
    zone codes and a positive ``topo_weight``, B6's zone-anchor mode."""
    device = idle.device
    solve = _solver(device, zone_code, topo_weight, "place")
    flags, ready_need, keep_need = (
        torch.tensor(a, device=device) for a in task_flags(
            job_ix, min_available, base_ready, base_pipelined))
    packed, f_idle, f_fidle, f_used, f_nt = solve(
        idle, future_idle, used, ntasks, allocatable, max_tasks, req, flags,
        ready_need, keep_need, masked_static, weights)
    task_node, pipelined, job_ready, job_kept = unpack_placement(
        packed.cpu().numpy(), job_ix, len(min_available))
    return PlacementResult(task_node, pipelined, job_ready, job_kept,
                           f_idle, f_fidle, f_used, f_nt)


# ---------------------------------------------------------------------------
# the speculative solve: B7 and the non-blocking dispatch
# ---------------------------------------------------------------------------

def decode_packed_plain(packed: torch.Tensor, job_ix: torch.Tensor,
                        J: int) -> torch.Tensor:
    """B1's words decoded into the wire ``[task_node | pipelined | ready |
    kept]``, i32 ``[2T + 2J]``, on any device: a job is ready (kept) when
    any of its boundary rows (a row whose word carries READY or KEEP)
    carries READY (KEEP); a task keeps its node when it was placed and its
    job was kept, else ``NO_NODE``. ``job_ix`` i32 ``[T]`` in ``[0, J)``.
    B1 gives each job one boundary row, its last task's, where this equals
    ``unpack_placement``."""
    node = (packed >> 4) - 1
    flags = packed & 0xF
    boundary = (flags & (F_READY | F_KEEP)) != 0
    jix = job_ix.long()
    ready = torch.zeros(J, dtype=torch.int32, device=packed.device)
    ready.index_add_(0, jix, (boundary & ((flags & F_READY) != 0)).int())
    kept = torch.zeros(J, dtype=torch.int32, device=packed.device)
    kept.index_add_(0, jix, (boundary & ((flags & F_KEEP) != 0)).int())
    ready, kept = ready > 0, kept > 0
    placed = kept[jix] & ((flags & F_PLACE) != 0)
    task_node = torch.where(placed, node, torch.full_like(node, NO_NODE))
    pipe = (flags & F_PIPE) != 0
    return torch.cat([task_node.int(), pipe.int(), ready.int(), kept.int()])


def decode_packed_cuda(packed: torch.Tensor, job_ix: torch.Tensor,
                       J: int) -> torch.Tensor:
    """``decode_packed_plain`` as ``csrc/place.cu``'s decode kernels (one
    memset and two launches) on the current stream; ``packed`` and
    ``job_ix`` contiguous i32 ``[T]`` CUDA tensors on one device. Raises
    on a tensor it does not take, a failed build or a failed launch."""
    device = packed.device
    if device.type != "cuda":
        raise ValueError(f"decode_packed_cuda: the words are on {device}, "
                         f"not a CUDA device")
    T = packed.shape[0] if packed.dim() == 1 else -1
    _check("packed", packed, torch.int32, (T,), device, "decode_packed_cuda")
    _check("job_ix", job_ix, torch.int32, (T,), device, "decode_packed_cuda")
    if J < 0:
        raise ValueError(f"decode_packed_cuda: J = {J}")
    wire = torch.empty(2 * T + 2 * J, dtype=torch.int32, device=device)
    if T or J:
        with torch.cuda.device(device):
            err = _lib().vt_decode_packed(
                packed.data_ptr() or None, job_ix.data_ptr() or None, T, J,
                wire.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise KernelError(f"decode_packed_cuda: kernel launch failed "
                              f"with cudaError_t {err}")
        decode_packed_cuda.launches += 1
    return wire


decode_packed_cuda.launches = 0


def place_dispatch(idle: torch.Tensor, future_idle: torch.Tensor,
                   used: torch.Tensor, ntasks: torch.Tensor,
                   allocatable: torch.Tensor, max_tasks: torch.Tensor,
                   req: torch.Tensor, job_ix: np.ndarray,
                   masked_static: Optional[torch.Tensor],
                   min_available: np.ndarray, base_ready: np.ndarray,
                   base_pipelined: np.ndarray, weights: ScoreWeights,
                   stream=None, zone_code: Optional[torch.Tensor] = None,
                   topo_weight: float = 0.0):
    """``place``'s solve with the decode on the device, without
    synchronizing the host: on CUDA tensors the rowdiff pre-pass (with a
    static matrix), ``place_cuda`` and ``decode_packed_cuda`` launch on
    ``stream`` after it waits for the current stream (whose work wrote the
    inputs), and every input is marked as used there, so the caching
    allocator reuses none of them before the stream is done with it.
    Returns ``(wire, event)``: the device wire of ``decode_packed_plain``
    and a ``torch.cuda.Event`` recorded after the decode. On CPU tensors it
    runs ``place_plain`` and ``decode_packed_plain`` at once and the event
    is None. With zone codes and a positive ``topo_weight`` the solve is
    B6's mode, as in ``place``. ``fetch_packed`` reads the wire."""
    device = idle.device
    J = len(min_available)
    solve = _solver(device, zone_code, topo_weight, "place_dispatch")
    if device.type == "cpu":
        flags, ready_need, keep_need = (
            torch.from_numpy(a) for a in task_flags(
                job_ix, min_available, base_ready, base_pipelined))
        packed = solve(idle, future_idle, used, ntasks, allocatable,
                       max_tasks, req, flags, ready_need, keep_need,
                       masked_static, weights)[0]
        return decode_packed_plain(
            packed, torch.from_numpy(np.asarray(job_ix, np.int32)), J), None
    if stream is None:
        raise ValueError("place_dispatch: a CUDA solve needs a stream")
    flags, ready_need, keep_need = (
        upload(a, device) for a in task_flags(
            job_ix, min_available, base_ready, base_pipelined))
    jix = upload(np.asarray(job_ix, np.int32), device)
    inputs = [idle, future_idle, used, ntasks, allocatable, max_tasks, req,
              flags, ready_need, keep_need, jix]
    if masked_static is not None:
        inputs.append(masked_static)
    if zone_code is not None:
        inputs.append(zone_code)
    stream.wait_stream(torch.cuda.current_stream(device))
    for t in inputs:
        t.record_stream(stream)
    with torch.cuda.stream(stream):
        packed = solve(idle, future_idle, used, ntasks, allocatable,
                       max_tasks, req, flags, ready_need, keep_need,
                       masked_static, weights)[0]
        wire = decode_packed_cuda(packed, jix, J)
        event = torch.cuda.Event()
        event.record(stream)
    return wire, event


def fetch_packed(wire: torch.Tensor, event, T: int, J: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The dispatched solve's one device-to-host copy: waits on ``event``
    (None for a wire already on the CPU), copies the wire into pinned
    memory and slices it into (task_node, task_pipelined, job_ready,
    job_kept), as ``unpack_placement`` returns them."""
    if wire.numel() != 2 * T + 2 * J:
        raise ValueError(f"fetch_packed: a wire of {wire.numel()} words is "
                         f"not one of T={T} tasks and J={J} jobs")
    if event is not None:
        event.synchronize()
    if wire.device.type == "cuda":
        host = torch.empty(wire.shape, dtype=torch.int32, pin_memory=True)
        host.copy_(wire)
    else:
        host = wire
    w = host.numpy()
    return (w[:T].copy(), w[T:2 * T] != 0, w[2 * T:2 * T + J] != 0,
            w[2 * T + J:] != 0)
