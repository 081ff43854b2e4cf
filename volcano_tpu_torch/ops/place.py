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
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import build
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
    state = [idle.clone(), future_idle.clone(), used.clone(), ntasks.clone()]
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
        word = 0
        if f & VALID and not broken:
            tidle, tfidle, tused, tnt = state
            q = req[i]
            fit = (q < tfidle + EPS).all(dim=1) & (tnt < max_tasks)
            score = combined_dynamic_score(q, tused, allocatable, weights)
            if masked_static is not None:
                fit = fit & (masked_static[i] > NEG_TEST)
                score = masked_static[i] + score
            best = int(torch.argmax(torch.where(fit, score, -torch.inf)))
            if not bool(fit[best]):
                broken = True
            else:
                on_idle = bool((q < tidle[best] + EPS).all())
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
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"place_cuda: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"place_cuda: {name} is {t.dtype}, not {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"place_cuda: {name} has shape {tuple(t.shape)}, "
                         f"not {shape}")
    if not t.is_contiguous():
        raise ValueError(f"place_cuda: {name} is not contiguous")


def _vt_place():
    fn = build.load("place").vt_place
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, p, p, p, p, f, f, f, f, p, p, p, p, p,
                   i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def place_cuda(idle: torch.Tensor, future_idle: torch.Tensor,
               used: torch.Tensor, ntasks: torch.Tensor,
               allocatable: torch.Tensor, max_tasks: torch.Tensor,
               req: torch.Tensor, flags: torch.Tensor,
               ready_need: torch.Tensor, keep_need: torch.Tensor,
               masked_static: Optional[torch.Tensor],
               weights: ScoreWeights) -> PlaceOutput:
    """The solve as one launch of the CUDA kernel ``csrc/place.cu`` on the
    current stream. Same inputs and outputs as ``place_plain``; every tensor
    must lie on one CUDA device. Raises on a tensor it does not take, a
    failed build or a failed launch."""
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

    # node-major [N,R] -> resource-major [R,N]: neighbouring threads own
    # neighbouring nodes, so each resource row is read coalesced
    state = torch.stack([idle.t(), future_idle.t(), used.t()]).contiguous()
    nt = ntasks.clone()
    alloc_rn = allocatable.t().contiguous()
    res = torch.as_tensor(weights.binpack_res, dtype=torch.float32,
                          device=device).contiguous()
    if tuple(res.shape) != (R,):
        raise ValueError(f"place_cuda: binpack_res has shape "
                         f"{tuple(res.shape)}, not ({R},)")
    saved = torch.empty_like(state)
    saved_nt = torch.empty_like(nt)
    packed = torch.empty(T, dtype=torch.int32, device=device)
    if T:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _vt_place()(
            req.data_ptr(), flags.data_ptr(), ready_need.data_ptr(),
            keep_need.data_ptr(),
            None if masked_static is None else masked_static.data_ptr(),
            alloc_rn.data_ptr(), max_tasks.data_ptr(), res.data_ptr(),
            weights.binpack_weight, weights.least_req_weight,
            weights.most_req_weight, weights.balanced_weight,
            state.data_ptr(), nt.data_ptr(), saved.data_ptr(),
            saved_nt.data_ptr(), packed.data_ptr(), T, N, R, stream)
        if err != 0:
            raise RuntimeError(f"place_cuda: kernel launch failed with "
                               f"cudaError_t {err}")
        place_cuda.launches += 1
    return (packed, state[0].t().contiguous(), state[1].t().contiguous(),
            state[2].t().contiguous(), nt)


# kernel launches since the count was last reset (chip_smoke.py reads it)
place_cuda.launches = 0


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


def place(idle: torch.Tensor, future_idle: torch.Tensor, used: torch.Tensor,
          ntasks: torch.Tensor, allocatable: torch.Tensor,
          max_tasks: torch.Tensor, req: torch.Tensor, job_ix: np.ndarray,
          masked_static: Optional[torch.Tensor], min_available: np.ndarray,
          base_ready: np.ndarray, base_pipelined: np.ndarray,
          weights: ScoreWeights) -> PlacementResult:
    """Solve a job-contiguous task list on the node tensors' device: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    device = idle.device
    if device.type == "cuda":
        solve = place_cuda
    elif device.type == "cpu":
        solve = place_plain
    else:
        raise ValueError(f"place: no placement kernel for device {device}")
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
