"""Allocate (``allocate-tpu``, engine ``tpu-fused``): the whole action as one
device solve.

Control flow mirrors pkg/scheduler/actions/allocate/
allocate.go:42-277 — namespace → queue (overused-filtered) → job → task
priority interleave, per-task predicate/score/select, Statement commit iff
the gang is Ready — with the job order fixed up front: the interleave is
simulated with every popped job assumed admitted, all pending tasks solve in
one placement kernel launch (ops/place.py), the order is re-simulated with
the actually admitted set until it stops changing, and the final solve
replays through the session.

This is the only engine here. A conf that asks for another one is refused;
a solve that fails raises — there is no fallback placer.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..api import PodGroupPhase, Resource, TaskInfo, TaskStatus
from ..cache.snapshot import (NodeTensors, assemble_feasibility,
                              assemble_static_score, assemble_weights,
                              discover_resource_names, task_requests)
from ..ops.place import NEG, NO_NODE, place
from ..ops.scores import ScoreWeights
from ..utils import PriorityQueue
from .base import Action

ENGINE = "tpu-fused"


class SolverFault(RuntimeError):
    """The device solve produced an unusable result (a node index out of
    range, non-finite inputs)."""


class _AggTask:
    """Lightweight task stand-in carrying a summed resreq, used to fire one
    aggregated allocate event per job during order simulation."""

    __slots__ = ("job", "resreq")

    def __init__(self, job: str, resreq):
        self.job = job
        self.resreq = resreq


class AllocateTPUAction(Action):
    NAME = "allocate-tpu"

    def __init__(self):
        # the last execute's phases in host wall seconds (_execute_fused)
        self.last_stats: Dict[str, float] = {}

    def execute(self, ssn) -> None:
        engine = ENGINE
        for conf in ssn.configurations:
            if conf.name in (self.NAME, "allocate"):
                engine = conf.arguments.get("engine", engine)
        if engine != ENGINE:
            raise ValueError(f"allocate engine {engine!r} is not in "
                             f"volcano_tpu_torch (has: {ENGINE!r})")
        self.last_stats = _execute_fused(ssn)


# ---------------------------------------------------------------------------
# job and task order (allocate.go:123-180)
# ---------------------------------------------------------------------------

def _eligible_jobs(ssn):
    for job in ssn.jobs.values():
        if job.podgroup.phase == PodGroupPhase.PENDING:
            continue
        vr = ssn.job_valid(job)
        if vr is not None and not vr.passed:
            continue
        if job.queue not in ssn.queues:
            continue
        yield job


def _pending_tasks(ssn, job) -> List[TaskInfo]:
    """Pending, non-best-effort tasks in TaskOrderFn order. When only the
    priority plugin registers a task order, a key sort replaces the
    comparator heap — same order, ~10x cheaper at 10k tasks."""
    tasks = [t for t in job.task_status_index.get(TaskStatus.PENDING,
                                                  {}).values()
             if not t.resreq.is_empty()]
    # the ENABLED comparator chain decides whether a key sort is equivalent
    enabled = [name for tier in ssn.tiers for opt in tier.plugins
               if opt.is_enabled("enabledTaskOrder")
               and (name := opt.name) in ssn.task_order_fns]
    if enabled == ["priority"]:
        tasks.sort(key=lambda t: (-t.priority, t.creation_timestamp, t.uid))
        return tasks
    if not enabled:
        tasks.sort(key=lambda t: (t.creation_timestamp, t.uid))
        return tasks
    pq = PriorityQueue(ssn.task_order_fn)
    for task in tasks:
        pq.push(task)
    out = []
    while not pq.empty():
        out.append(pq.pop())
    return out


def _fixed_job_order(ssn, assumed_admitted: Optional[set] = None) -> List:
    """Precompute the namespace→queue→job interleave for the fused solve.

    Runs the reference's popping loop (allocate.go:123-180) with one
    assumption: every popped job in ``assumed_admitted`` (all jobs when None)
    allocates all of its pending tasks. Plugin allocate-events fire during
    the simulation so mid-cycle share updates and overused gating order
    queues exactly as the live loop would; all events are undone before
    returning. The fused executor iterates this to a fixed point on the
    actually-admitted set, so gang failures feed back into the ordering.
    """
    namespaces = PriorityQueue(ssn.namespace_order_fn)
    jobs_map: Dict[str, Dict[str, PriorityQueue]] = {}
    for job in _eligible_jobs(ssn):
        ns = job.namespace
        if ns not in jobs_map:
            namespaces.push(ns)
            jobs_map[ns] = {}
        if job.queue not in jobs_map[ns]:
            jobs_map[ns][job.queue] = PriorityQueue(ssn.job_order_fn)
        jobs_map[ns][job.queue].push(job)

    ordered: List = []
    simulated: List[_AggTask] = []
    try:
        while not namespaces.empty():
            ns = namespaces.pop()
            queue_jobs = jobs_map[ns]
            queue = None
            for qid in list(queue_jobs):
                q = ssn.queues[qid]
                if ssn.overused(q):
                    del queue_jobs[qid]
                    continue
                if queue_jobs[qid].empty():
                    continue
                if queue is None or ssn.queue_order_fn(q, queue):
                    queue = q
            if queue is None:
                continue
            jobs = queue_jobs[queue.uid]
            if jobs.empty():
                del queue_jobs[queue.uid]
                namespaces.push(ns)
                continue
            job = jobs.pop()
            ordered.append(job)
            if assumed_admitted is None or job.uid in assumed_admitted:
                # one aggregated pseudo-event per job: allocate-event
                # handlers are additive in task.resreq, so summing the
                # job's pending requests into a single event is equivalent
                # and O(jobs) instead of O(tasks)
                total = Resource()
                count = 0
                for task in job.task_status_index.get(TaskStatus.PENDING,
                                                      {}).values():
                    if task.resreq.is_empty():
                        continue
                    total.add(task.resreq)
                    count += 1
                if count:
                    agg = _AggTask(job.uid, total)
                    ssn._fire_allocate(agg)
                    simulated.append(agg)
            namespaces.push(ns)
    finally:
        # always undo the simulated events: the replay runs in this same
        # session and must not see phantom queue shares
        for task in reversed(simulated):
            ssn._fire_deallocate(task)
    return ordered


# ---------------------------------------------------------------------------
# the fused solve
# ---------------------------------------------------------------------------

def _execute_fused(ssn, max_order_iters: int = 4) -> Dict[str, float]:
    """Iterate (order simulation → one device solve) until the admitted-job
    set stabilizes, then replay the final solve. Convergence is usually
    immediate; gang rollbacks trigger one extra iteration because a failed
    job must stop influencing queue shares and overused gating.

    Returns the phases' host wall seconds: "order" (the order simulation),
    "assemble" (the solve's tensors, built and copied to the device),
    "solve" (the kernel, the one device-to-host copy and the decode),
    "replay", and "solves", the number of solves."""
    stats = {"order": 0.0, "assemble": 0.0, "solve": 0.0, "replay": 0.0,
             "solves": 0}
    assumed: Optional[set] = None
    solution = None
    for _ in range(max_order_iters):
        t0 = time.perf_counter()
        ordered_jobs = _fixed_job_order(ssn, assumed)
        t1 = time.perf_counter()
        stats["order"] += t1 - t0
        inputs = placement_inputs(ssn, ordered_jobs)
        t2 = time.perf_counter()
        stats["assemble"] += t2 - t1
        if inputs is None:
            return stats
        solution = _fused_solution(inputs)
        stats["solve"] += time.perf_counter() - t2
        stats["solves"] += 1
        kept_uids = {solution.jobs_list[jx].uid
                     for jx in range(len(solution.jobs_list))
                     if solution.job_kept[jx]}
        # assumed=None simulated "all jobs admitted" — if the solve indeed
        # kept every job the premise held; no re-solve needed.
        if kept_uids == assumed or (
                assumed is None
                and kept_uids == {j.uid for j in ordered_jobs}):
            break
        assumed = kept_uids
    t0 = time.perf_counter()
    _replay_fused(ssn, solution)
    stats["replay"] = time.perf_counter() - t0
    return stats


def _collect_pending_ordered(ssn, ordered_jobs):
    """Flatten the ordered jobs' pending tasks into the solver's task
    axis: (tasks, per-task job index, jobs_list)."""
    tasks: List[TaskInfo] = []
    job_ix: List[int] = []
    job_index: Dict[str, int] = {}
    jobs_list: List = []
    for job in ordered_jobs:
        jtasks = _pending_tasks(ssn, job)
        if not jtasks:
            continue
        if job.uid not in job_index:
            job_index[job.uid] = len(jobs_list)
            jobs_list.append(job)
        tasks.extend(jtasks)
        job_ix.extend([job_index[job.uid]] * len(jtasks))
    return tasks, job_ix, jobs_list


def _gang_meta(jobs_list):
    """(min_available, base_ready, base_pipelined) i32[J]: each gang's
    target and what it already holds before this action."""
    min_av = np.asarray([j.min_available for j in jobs_list], np.int32)
    base_r = np.asarray([j.ready_task_num() for j in jobs_list], np.int32)
    base_p = np.asarray([j.waiting_task_num() for j in jobs_list], np.int32)
    return min_av, base_r, base_p


class PlacementInputs(NamedTuple):
    """Everything one fused solve hands the placement kernel, on the
    session's device (the host-side job index and gang meta aside)."""

    tasks: List[TaskInfo]
    jobs_list: List
    node_t: NodeTensors
    req: torch.Tensor               # f32[T,R]
    job_ix: np.ndarray              # i32[T], job-contiguous
    masked_static: Optional[torch.Tensor]  # f32[T,N], NEG = infeasible
    min_available: np.ndarray       # i32[J]
    base_ready: np.ndarray
    base_pipelined: np.ndarray
    weights: ScoreWeights


def placement_inputs(ssn, ordered_jobs) -> Optional[PlacementInputs]:
    """Assemble the solve's tensors for ``ordered_jobs``; None when there
    is nothing to place."""
    tasks, job_ix, jobs_list = _collect_pending_ordered(ssn, ordered_jobs)
    if not tasks or not ssn.nodes:
        return None
    rnames = discover_resource_names(list(ssn.nodes.values()), tasks)
    node_t = NodeTensors(list(ssn.nodes.values()), rnames, ssn.device)
    req = task_requests(tasks, rnames)
    feas = assemble_feasibility(ssn, tasks, node_t)
    static = assemble_static_score(ssn, tasks, node_t)
    weights = assemble_weights(ssn, rnames)
    # Non-finite values would flow through the kernel into silently wrong
    # placements (an inf score times a zero weight is NaN) — refuse them.
    if not np.isfinite(req).all() or (
            static is not None and not np.isfinite(static).all()):
        raise SolverFault("non-finite task requests or static scores")
    if not (np.isfinite(weights.binpack_res).all()
            and all(np.isfinite(w) for w in (
                weights.binpack_weight, weights.least_req_weight,
                weights.most_req_weight, weights.balanced_weight))):
        raise SolverFault("non-finite score weights")
    masked = None
    if feas is not None or static is not None:
        T, N = len(tasks), len(node_t.names)
        f = np.ones((T, N), bool) if feas is None else feas
        s = np.zeros((T, N), np.float32) if static is None else static
        masked = torch.tensor(np.where(f, s, NEG).astype(np.float32),
                              device=ssn.device)
    min_av, base_r, base_p = _gang_meta(jobs_list)
    return PlacementInputs(
        tasks=tasks, jobs_list=jobs_list, node_t=node_t,
        req=torch.tensor(req, device=ssn.device),
        job_ix=np.asarray(job_ix, np.int32), masked_static=masked,
        min_available=min_av, base_ready=base_r, base_pipelined=base_p,
        weights=weights)


def solve(inputs: PlacementInputs):
    """One placement solve of ``inputs`` (ops/place.place)."""
    nt = inputs.node_t
    return place(nt.idle, nt.future_idle, nt.used, nt.ntasks,
                 nt.allocatable, nt.max_tasks, inputs.req, inputs.job_ix,
                 inputs.masked_static, inputs.min_available,
                 inputs.base_ready, inputs.base_pipelined, inputs.weights)


class _FusedSolution:
    def __init__(self, tasks, job_ix, jobs_list, node_t, task_node,
                 pipelined, job_ready, job_kept):
        # garbage-output guard: an out-of-range node index here would
        # corrupt host accounting at replay
        tn = np.asarray(task_node)
        if tn.size and (int(tn.min()) < NO_NODE
                        or int(tn.max()) >= len(node_t.names)):
            raise SolverFault(
                f"device solve returned node indices outside "
                f"[{NO_NODE}, {len(node_t.names)})")
        self.tasks = tasks
        self.job_ix = job_ix
        self.jobs_list = jobs_list
        self.node_t = node_t
        self.task_node = task_node
        self.pipelined = pipelined
        self.job_ready = job_ready
        self.job_kept = job_kept


def _fused_solution(inputs: PlacementInputs) -> _FusedSolution:
    res = solve(inputs)
    return _FusedSolution(inputs.tasks, inputs.job_ix, inputs.jobs_list,
                          inputs.node_t, res.task_node, res.task_pipelined,
                          res.job_ready, res.job_kept)


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

def _fast_replay_ok(ssn) -> bool:
    """The batched replay skips the per-task Statement machinery; it is
    sound only when (a) every event handler declared itself additive per
    job and (b) the gang plugin alone decides job readiness/pipelining, so
    the kernel's gang verdicts (gang.go's formula) are authoritative."""
    if any(not eh.aggregatable for eh in ssn.event_handlers):
        return False
    for reg, flag in ((ssn.job_ready_fns, "enabledJobReady"),
                      (ssn.job_pipelined_fns, "enabledJobPipelined")):
        owners = [opt.name for tier in ssn.tiers for opt in tier.plugins
                  if opt.name in reg and opt.is_enabled(flag)]
        if any(name != "gang" for name in owners):
            return False
    return True


def _replay_fused_fast(ssn, sol: _FusedSolution) -> None:
    """Batched replay: identical end-state to the Statement path. The Python
    loop does only dict bookkeeping (status-index bucket moves + node task
    mirrors) and exact Resource aggregation per node/job — aggregates use
    task.resreq doubles, NOT the solve's f32 requests, so node accounting
    stays bit-identical to the Statement path. Committed tasks end BINDING
    on the session model and BOUND on the live cache (session.dispatch ->
    cache.bind), pipelined tasks end PIPELINED session-only."""
    task_node = np.asarray(sol.task_node)
    pipelined = np.asarray(sol.pipelined, bool)
    job_ix = np.asarray(sol.job_ix)
    kept_t = np.asarray(sol.job_kept, bool)[job_ix]
    placed = (task_node != NO_NODE) & kept_t
    pipe_m = placed & pipelined

    ready_j = np.asarray(sol.job_ready, bool)
    placed_ix = np.flatnonzero(placed)
    hosts_row = task_node[placed_ix]
    jx_arr = job_ix[placed_ix]
    pipe_arr = pipe_m[placed_ix]
    bind_arr = ~pipe_arr & ready_j[jx_arr]

    alloc_agg: Dict[int, Resource] = {}
    pipe_agg: Dict[int, Resource] = {}
    job_agg: Dict[int, Resource] = {}
    job_alloc: Dict[int, Resource] = {}
    binds: List[TaskInfo] = []
    names = sol.node_t.names
    node_objs = [ssn.nodes[nm] for nm in names]
    for k in range(len(placed_ix)):
        task = sol.tasks[placed_ix[k]]
        jx = int(jx_arr[k])
        job = sol.jobs_list[jx]
        row = hosts_row[k]
        if pipe_arr[k]:
            status = TaskStatus.PIPELINED
            pipe_agg.setdefault(row, Resource()).add(task.resreq)
        else:
            if bind_arr[k]:
                status = TaskStatus.BINDING
                binds.append(task)
            else:
                status = TaskStatus.ALLOCATED
            alloc_agg.setdefault(row, Resource()).add(task.resreq)
            job_alloc.setdefault(jx, Resource()).add(task.resreq)
        # inline update_task_status minus the per-task Resource math
        # (aggregated above): the old status is PENDING by construction of
        # _pending_tasks
        job._del_index(task)
        task.status = status
        job._add_index(task)
        task.node_name = names[row]
        ti = task.clone()
        if status is TaskStatus.BINDING:
            ti.status = TaskStatus.ALLOCATED
        node_objs[row].tasks[task.uid] = ti
        job_agg.setdefault(jx, Resource()).add(task.resreq)

    for jx, agg in job_agg.items():
        job = sol.jobs_list[jx]
        if jx in job_alloc:
            job.allocated.add(job_alloc[jx])
        ssn._fire_allocate(_AggTask(job.uid, agg))
    for row, r in alloc_agg.items():
        node = node_objs[row]
        node.idle.sub(r)
        node.used.add(r)
    for row, r in pipe_agg.items():
        node_objs[row].pipelined.add(r)
    ssn.cache.bind_batch(binds)


def _replay_fused(ssn, sol: _FusedSolution) -> None:
    """Replay the device decisions through the session: batched when
    _fast_replay_ok holds, else through Statements, job by job, preserving
    gang atomicity on the host model (statement.go semantics)."""
    if _fast_replay_ok(ssn):
        _replay_fused_fast(ssn, sol)
        return
    per_job_tasks: Dict[int, List[int]] = {}
    for i, jx in enumerate(sol.job_ix):
        per_job_tasks.setdefault(int(jx), []).append(i)
    for jx, task_ids in per_job_tasks.items():
        if not sol.job_kept[jx]:
            continue
        job = sol.jobs_list[jx]
        stmt = ssn.statement()
        try:
            for i in task_ids:
                n = int(sol.task_node[i])
                if n == NO_NODE:
                    continue
                name = sol.node_t.names[n]
                if sol.pipelined[i]:
                    stmt.pipeline(sol.tasks[i], name)
                else:
                    stmt.allocate(sol.tasks[i], ssn.nodes[name])
        except Exception:
            stmt.discard()
            raise
        if ssn.job_ready(job):
            stmt.commit()
        elif not ssn.job_pipelined(job):
            stmt.discard()
