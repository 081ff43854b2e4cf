"""Allocate: the core scheduling action, in the engines that run on one
device.

Control flow mirrors pkg/scheduler/actions/allocate/allocate.go:42-277 —
namespace → queue (overused-filtered, share-ordered) → job → task priority
interleave, per-task predicate/score/select, Statement commit iff the gang
is Ready. The engines (the JAX package's actions/allocate.py):

- ``callbacks``: the reference's architecture on the host — per-(task,
  node) plugin callbacks through predicate_nodes/prioritize_nodes, the
  interleave popping one job at a time. An engine a conf selects (the
  default of ``allocate``), never a stand-in for a failed device engine.
- ``tpu-strict``: the same interleave, with the device solves batched: the
  next B pops are predicted by simulating the interleave, solved in one
  placement kernel launch (ops/place.py) with the node state carried
  across jobs, and verified pop by pop at replay; a mispredicted pop
  discards the rest of the batch and re-solves the verified prefix. The
  batch doubles after a verified full batch (up to 32 times the floor,
  ``strict-batch``, 16 by default) and halves on a mispredict; it is 1
  under stateful predicates. ``tpu-strict-perjob`` solves one job a launch.
- ``tpu-fused``: the whole action as one solve: the job order is fixed up
  front by simulating the interleave with every popped job assumed
  admitted, all pending tasks solve in one placement kernel launch, the
  order is re-simulated with the actually admitted set until it stops
  changing, and the final solve replays through the session.
- ``tpu-blocks``: tpu-fused's fixed point with the block auction
  (ops/blocks.py) as the solve.

- ``tpu-scan`` and ``tpu-pallas``: the JAX package's XLA scan and Pallas
  forms of tpu-fused's solve; both compute B1's function, so here both run
  tpu-fused (the placement kernel).

A positive ``topology-weight`` (an ``allocate`` or ``allocate-tpu``
argument) turns tpu-fused's solve into B6, the placement kernel's
zone-anchor mode, as the JAX package's scan takes ``place_scan_topo``; the
other engines do not read it, as there. The elastic-gang plugin's pending
filter narrows an elastic gang's pending set in every engine.

The action ``allocate`` defaults to callbacks and ``allocate-tpu`` to
tpu-fused. A conf that asks for an engine this package lacks
(``tpu-sharded``, ``callbacks-parallel``) is refused by name. A device
solve that fails raises: there is no fallback placer and no device
cool-down.

The pipelined shell splits tpu-fused's first solve in two:
``dispatch_speculative_solve`` orders, assembles and launches it on a side
CUDA stream with no host synchronization, and at the next cycle's commit
boundary ``finalize_speculative_dispatch`` fetches it and
``_execute_fused(first_solution=...)`` continues the fixed point from it.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .. import metrics
from ..obs import trace as obs_trace
from ..api import (FitError, PodGroupPhase, Resource, TaskInfo, TaskStatus)
from ..api.types import NODE_RESOURCE_FIT_FAILED
from ..cache.snapshot import (NodeTensors, assemble_feasibility,
                              assemble_static_score, assemble_weights,
                              discover_resource_names, task_requests)
from ..ops.blocks import (JobMeta, NodeState, padded_task_len,
                          place_blocks_unified)
from ..ops.place import (NEG, NO_NODE, fetch_packed, place, place_dispatch,
                         upload)
from ..ops.scores import ScoreWeights
from ..utils import PriorityQueue
from ..utils.scheduler_helper import (predicate_nodes, prioritize_nodes,
                                      select_best_node)
from .base import Action

ENGINES = ("callbacks", "tpu-strict", "tpu-strict-perjob", "tpu-fused",
           "tpu-scan", "tpu-pallas", "tpu-blocks")
# the engines whose first solve the pipelined shell may dispatch ahead: all
# three name the placement kernel here
SPECULATIVE_ENGINES = ("tpu-fused", "tpu-scan", "tpu-pallas")
# engines of the JAX package this one lacks, and why
MISSING_ENGINES = {
    "tpu-sharded": "the node-sharded solve over a device mesh (B5)",
    "callbacks-parallel": "the 16-way threaded callbacks engine",
}
BLOCKS_BIG_T = 12000    # above this many tasks the blocks budgets are 5/4


# the last execute's node-tensor assembly: "tensor_s", host seconds summed
# over its solves, and "tensor_incremental", whether the last solve read
# the cache's persistent tensors (True) or a fresh build (False)
LAST_STATS: Dict[str, object] = {}


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


def _action_args(configurations, names):
    """The arguments of every configuration block of the named actions."""
    return [c.arguments for c in configurations if c.name in names]


class AllocateAction(Action):
    NAME = "allocate"
    DEFAULT_ENGINE = "callbacks"

    def __init__(self, engine: Optional[str] = None):
        self.engine = engine or self.DEFAULT_ENGINE
        # the last execute's phases in host wall seconds and counts
        self.last_stats: Dict[str, object] = {}

    def configured_engine(self, configurations):
        """The engine and strict batch the conf's blocks name for this
        action; refuses an engine or argument this package lacks."""
        engine = self.engine
        batch = 16
        for args in _action_args(configurations, (self.NAME, "allocate")):
            engine = args.get("engine", engine)
            batch = int(args.get("strict-batch", batch))
        if engine in MISSING_ENGINES:
            raise ValueError(f"allocate engine {engine!r} is not in "
                             f"volcano_tpu_torch: it needs "
                             f"{MISSING_ENGINES[engine]}")
        if engine not in ENGINES:
            raise ValueError(f"unknown allocate engine {engine!r}")
        return engine, batch

    def check_conf(self, configurations) -> None:
        self.configured_engine(configurations)

    def execute(self, ssn) -> None:
        engine, batch = self.configured_engine(ssn.configurations)
        LAST_STATS.pop("tensor_s", None)      # accumulates within one cycle
        LAST_STATS.pop("tensor_incremental", None)
        if engine == "callbacks":
            t0 = time.perf_counter()
            _execute_interleaved(ssn, _CallbackJobPlacer(ssn))
            self.last_stats = {"interleave": time.perf_counter() - t0}
        elif engine == "tpu-strict":
            self.last_stats = _execute_strict_batched(ssn, batch=batch)
        elif engine == "tpu-strict-perjob":
            placer = _DeviceJobPlacer(ssn)
            _execute_interleaved(ssn, placer)
            self.last_stats = placer.stats
        else:
            self.last_stats = _execute_fused(
                ssn, blocks=engine == "tpu-blocks")


class AllocateTPUAction(AllocateAction):
    NAME = "allocate-tpu"
    DEFAULT_ENGINE = "tpu-fused"


def _topology_weight(ssn) -> float:
    """The allocate action's ``topology-weight`` argument (0: the term is
    off), the last ``allocate`` or ``allocate-tpu`` block's; unparsable
    reads as 0, a negative weight as 0."""
    w = 0.0
    for args in _action_args(ssn.configurations,
                             ("allocate", "allocate-tpu")):
        try:
            w = float(args.get("topology-weight", w))
        except (TypeError, ValueError):
            w = 0.0
    return max(w, 0.0)


def _solve_route(ssn, blocks: bool) -> str:
    """The ``kernel`` attribute of a fused solve's span: the wrapper the
    solve goes through and its route on the session's device, the kernel
    (``_cuda``) or its plain version (``_plain``)."""
    if blocks:
        name = "blocks"
    elif _topology_weight(ssn) > 0:
        name = "place_topo"
    else:
        name = "place"
    return name + ("_cuda" if ssn.device.type == "cuda" else "_plain")


def _node_tensors(ssn, rnames):
    """Node-state tensors for a device solve: the cache's persistent,
    scatter-updated rows when the session can prove its snapshot untouched
    (Session.snapshot_node_tensors), else a fresh NodeTensors in snapshot
    order on the session's device. Timed into LAST_STATS, which also
    records the path, and traced as the ``tensor_assembly`` span."""
    with obs_trace.span("tensor_assembly") as sp:
        node_t = ssn.snapshot_node_tensors(rnames)
        incremental = node_t is not None
        if node_t is None:
            node_t = NodeTensors(list(ssn.nodes.values()), rnames,
                                 ssn.device)
    LAST_STATS["tensor_s"] = LAST_STATS.get("tensor_s", 0.0) + sp.dur_s
    LAST_STATS["tensor_incremental"] = incremental
    return node_t


# ---------------------------------------------------------------------------
# the interleave (allocate.go:123-274)
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
    # the elastic decision class: with the elastic-gang plugin in the conf,
    # an elastic gang shows its core members until admission and nothing
    # after (grow-shrink owns growth toward desired)
    flt = getattr(ssn, "elastic_pending_filter", None)
    if flt is not None:
        tasks = flt(job, tasks)
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


def _build_interleave(ssn, only_jobs: Optional[set] = None):
    """The namespace -> queue -> job priority queues the popping loop
    mutates (allocate.go:123-142), over the uids of ``only_jobs`` when
    given."""
    namespaces = PriorityQueue(ssn.namespace_order_fn)
    jobs_map: Dict[str, Dict[str, PriorityQueue]] = {}
    for job in _eligible_jobs(ssn):
        if only_jobs is not None and job.uid not in only_jobs:
            continue
        ns = job.namespace
        if ns not in jobs_map:
            namespaces.push(ns)
            jobs_map[ns] = {}
        if job.queue not in jobs_map[ns]:
            jobs_map[ns][job.queue] = PriorityQueue(ssn.job_order_fn)
        jobs_map[ns][job.queue].push(job)
    return namespaces, jobs_map


def _pop_next(ssn, namespaces, jobs_map):
    """One pop of the interleave (allocate.go:143-180), with its queue
    deletions; returns (job, jobs_pq, ns), or (None, None, None) when
    drained. The live loop, the order simulations and the strict engine's
    verification all pop through here. The namespace is not pushed back:
    the reference re-inserts it after the popped job's statement closes, so
    a share-based namespace order sees the post-placement shares. Callers
    push ``ns`` back after the job."""
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
            continue              # every queue of the namespace is done
        jobs = queue_jobs[queue.uid]
        if jobs.empty():
            del queue_jobs[queue.uid]
            namespaces.push(ns)
            continue
        return jobs.pop(), jobs, ns
    return None, None, None


def _assume_allocated(ssn, job) -> Optional[_AggTask]:
    """One aggregated allocate event as if every pending task of ``job``
    placed: allocate-event handlers are additive in task.resreq, so one
    event per job is equivalent and O(jobs) instead of O(tasks)."""
    total = Resource()
    count = 0
    for task in job.task_status_index.get(TaskStatus.PENDING, {}).values():
        if task.resreq.is_empty():
            continue
        total.add(task.resreq)
        count += 1
    if not count:
        return None
    agg = _AggTask(job.uid, total)
    ssn._fire_allocate(agg)
    return agg


def _fixed_job_order(ssn, assumed_admitted: Optional[set] = None,
                     only_jobs: Optional[set] = None) -> List:
    """Precompute the interleave for the fused solve: the popping loop with
    every popped job in ``assumed_admitted`` (all jobs when None) assumed to
    allocate all of its pending tasks, its allocate events fired so that
    share updates and overused gating order queues as the live loop would;
    all events are undone before returning. The fused executor iterates this
    to a fixed point on the actually admitted set, so gang failures feed
    back into the ordering. ``only_jobs`` restricts the interleave to those
    uids: the pipelined commit's suffix solve orders exactly the jobs a
    committed speculation could not know."""
    namespaces, jobs_map = _build_interleave(ssn, only_jobs)
    ordered: List = []
    simulated: List[_AggTask] = []
    try:
        while True:
            job, _, ns = _pop_next(ssn, namespaces, jobs_map)
            if job is None:
                break
            ordered.append(job)
            if assumed_admitted is None or job.uid in assumed_admitted:
                agg = _assume_allocated(ssn, job)
                if agg is not None:
                    simulated.append(agg)
            namespaces.push(ns)
    finally:
        # the replay runs in this same session and must not see phantom
        # queue shares
        for agg in reversed(simulated):
            ssn._fire_deallocate(agg)
    return ordered


def _execute_interleaved(ssn, placer) -> None:
    """The live popping loop (allocate.go:143-274): each popped job's tasks
    go to ``placer`` inside a Statement, committed if the gang is ready,
    kept if it is pipelined, else discarded."""
    with obs_trace.span("interleave",
                        placer=type(placer).__name__.lstrip("_")):
        _run_interleaved(ssn, placer)


def _run_interleaved(ssn, placer) -> None:
    namespaces, jobs_map = _build_interleave(ssn)
    pending: Dict[str, List[TaskInfo]] = {}
    while True:
        job, jobs, ns = _pop_next(ssn, namespaces, jobs_map)
        if job is None:
            break
        if job.uid not in pending:
            pending[job.uid] = _pending_tasks(ssn, job)
        stmt = ssn.statement()
        try:
            placer.place(job, pending[job.uid], stmt, jobs)
        except Exception:
            stmt.discard()
            raise
        if ssn.job_ready(job):
            stmt.commit()
        elif not ssn.job_pipelined(job):
            stmt.discard()
        namespaces.push(ns)            # post-placement, like allocate.go


def _fit_error(task, node) -> ValueError:
    err = ValueError(f"task {task.key()} on node {node.name}: resource fit "
                     f"failed")
    err.fit_error = FitError(task, node, [NODE_RESOURCE_FIT_FAILED])
    return err


class _CallbackJobPlacer:
    """Per-(task, node) callback placement — the reference's hot loop
    (allocate.go:186-262)."""

    def __init__(self, ssn):
        self.ssn = ssn

    def place(self, job, tasks, stmt, jobs_pq) -> None:
        ssn = self.ssn
        nodes = list(ssn.nodes.values())

        def pred(task, node):
            if not task.init_resreq.less_equal(node.future_idle()):
                raise _fit_error(task, node)
            ssn.predicate_fn(task, node)

        while tasks:
            task = tasks.pop(0)
            feasible, fit_errors = predicate_nodes(task, nodes, pred)
            if not feasible:
                job.nodes_fit_errors[task.uid] = fit_errors
                break
            candidates = [n for n in feasible
                          if task.init_resreq.less_equal(n.idle)
                          or task.init_resreq.less_equal(n.future_idle())]
            if not candidates:
                continue
            scores = prioritize_nodes(task, candidates,
                                      ssn.batch_node_order_fn,
                                      ssn.node_order_fn)
            node = ssn.best_node_fn(task, scores) or select_best_node(scores)
            if task.init_resreq.less_equal(node.idle):
                stmt.allocate(task, node)
            elif task.init_resreq.less_equal(node.future_idle()):
                stmt.pipeline(task, node.name)
            if ssn.job_ready(job) and tasks:
                jobs_pq.push(job)
                return


# ---------------------------------------------------------------------------
# the strict engines: the interleave with device solves
# ---------------------------------------------------------------------------

class _StrictSolver:
    """What the strict engines solve against: the node tensors built once
    at the action's start, the weights, and the node state carried from
    solve to solve on the session's device (``state``: idle, future idle,
    used, pod counts)."""

    def __init__(self, ssn):
        tasks_all = [t for j in ssn.jobs.values() for t in j.tasks.values()]
        nodes = list(ssn.nodes.values())
        self.ssn = ssn
        self.rnames = discover_resource_names(nodes, tasks_all)
        self.node_t = _node_tensors(ssn, self.rnames)
        self.weights = assemble_weights(ssn, self.rnames)
        nt = self.node_t
        self.state = (nt.idle, nt.future_idle, nt.used, nt.ntasks)
        self.stats: Dict[str, object] = {"solves": 0, "batches": [],
                                         "solve": 0.0}

    def solve(self, jobs_with_tasks, state):
        """One placement kernel launch over the jobs' pending tasks, from
        node state ``state`` (per-job gang snapshots in the kernel).
        Returns the PlacementResult and each job's task slice."""
        ssn = self.ssn
        t0 = time.perf_counter()
        tasks: List[TaskInfo] = []
        job_ix: List[int] = []
        slices: List[tuple] = []
        for jx, (_, jtasks) in enumerate(jobs_with_tasks):
            slices.append((len(tasks), len(tasks) + len(jtasks)))
            tasks.extend(jtasks)
            job_ix.extend([jx] * len(jtasks))
        nt = self.node_t
        req = task_requests(tasks, self.rnames)
        masked = _masked_static(assemble_feasibility(ssn, tasks, nt),
                                assemble_static_score(ssn, tasks, nt),
                                len(tasks), len(nt.names), ssn.device)
        min_av, base_r, base_p = _gang_meta([j for j, _ in jobs_with_tasks])
        res = place(*state, nt.allocatable, nt.max_tasks,
                    torch.tensor(req, device=ssn.device),
                    np.asarray(job_ix, np.int32), masked, min_av, base_r,
                    base_p, self.weights)
        self.stats["solves"] += 1
        self.stats["batches"].append(len(jobs_with_tasks))
        self.stats["solve"] += time.perf_counter() - t0
        return res, slices

    def replay(self, tasks, task_node, pipelined, stmt) -> None:
        """A solved job's placements through its Statement."""
        ssn = self.ssn
        recheck = bool(ssn.stateful_predicates)
        for i, task in enumerate(tasks):
            n = int(task_node[i])
            if n == NO_NODE:
                continue
            name = self.node_t.names[n]
            node = ssn.nodes[name]
            if recheck and not _stateful_recheck(ssn, task, node):
                continue
            if pipelined[i]:
                stmt.pipeline(task, name)
            else:
                stmt.allocate(task, node)


def _new_state(res):
    return (res.idle, res.future_idle, res.used, res.ntasks)


class _DeviceJobPlacer(_StrictSolver):
    """tpu-strict-perjob: one solve a popped job, the live interleave
    deciding every job; the solve's node state is kept only when the job is
    kept."""

    def place(self, job, tasks, stmt, jobs_pq) -> None:
        if not tasks or not self.node_t.names:
            tasks.clear()
            return
        with obs_trace.span("solve", batch=1):
            res, _ = self.solve([(job, tasks)], self.state)
        if bool(res.job_kept[0]):
            self.state = _new_state(res)
        # every task is consumed: the reference pops each task from its
        # queue once per cycle whether or not it placed
        # (allocate.go:187-223)
        self.replay(tasks, res.task_node, res.task_pipelined, stmt)
        tasks.clear()


def _predict_pops(ssn, namespaces, jobs_map, n: int, first=None) -> List:
    """The next ``n`` pops of the interleave, simulated on clones of the
    live queues with each popped job's assume-all-allocated event fired
    (undone before returning). Optimistic, never authoritative: the caller
    verifies each against the live pop. ``first`` seeds a job the live loop
    already popped (a previous batch's mispredict)."""
    sim_ns = namespaces.clone()
    sim_map = {ns: {qid: pq.clone() for qid, pq in qmap.items()}
               for ns, qmap in jobs_map.items()}
    predicted: List = [] if first is None else [first]
    simulated: List[_AggTask] = []
    try:
        for job in predicted:
            agg = _assume_allocated(ssn, job)
            if agg is not None:
                simulated.append(agg)
            # the live loop popped this job's namespace and pushes it back
            # when the job's statement closes
            sim_ns.push(job.namespace)
        while len(predicted) < n:
            job, _, ns = _pop_next(ssn, sim_ns, sim_map)
            if job is None:
                break
            predicted.append(job)
            agg = _assume_allocated(ssn, job)
            if agg is not None:
                simulated.append(agg)
            sim_ns.push(ns)
    finally:
        for agg in reversed(simulated):
            ssn._fire_deallocate(agg)
    return predicted


def _execute_strict_batched(ssn, batch: int = 16) -> Dict[str, object]:
    """tpu-strict: pop by pop the callbacks loop — the live _pop_next
    decides every job and every placement replays through a Statement with
    the same votes — with the device solves batched. The next B pops are
    predicted, solved in one launch with the node state carried across
    them, and verified against the live pops at replay; a mispredict
    discards the rest, re-solves the verified prefix from the batch's start
    state (the same decisions, so the same state) and restarts prediction
    from the job the live loop popped. B doubles after a verified full
    batch, up to 32 times ``batch``, and halves on a mispredict; it is 1
    under stateful predicates, whose feasibility changes as jobs replay.
    Returns the solves' count, their batch sizes and host seconds."""
    if not ssn.nodes:
        return {"solves": 0, "batches": [], "solve": 0.0}
    solver = _StrictSolver(ssn)
    if ssn.stateful_predicates:
        batch = 1
    namespaces, jobs_map = _build_interleave(ssn)
    pending: Dict[str, List[TaskInfo]] = {}
    carry = None     # (job, ns) a mispredict popped live but left unplaced
    b_cur, b_max = batch, batch * 32 if batch > 1 else 1

    def live_tasks(job):
        if job.uid not in pending:
            pending[job.uid] = _pending_tasks(ssn, job)
        return pending[job.uid]

    while True:
        carried_job, carried_ns = carry if carry is not None else (None, None)
        predicted = _predict_pops(ssn, namespaces, jobs_map, b_cur,
                                  first=carried_job)
        carry = None
        if not predicted:
            break
        solvable = [(j, live_tasks(j)) for j in predicted if live_tasks(j)]
        start = solver.state
        if solvable:
            with obs_trace.span("solve", batch=len(solvable)):
                res, slices = solver.solve(solvable, start)
        solved_ix = {id(j): k for k, (j, _) in enumerate(solvable)}

        verified: List[tuple] = []
        ok = True
        for idx, job in enumerate(predicted):
            if idx == 0 and carried_job is job:
                actual, ns = job, carried_ns
            else:
                actual, _, ns = _pop_next(ssn, namespaces, jobs_map)
            if actual is not job:
                carry = None if actual is None else (actual, ns)
                ok = False
                break
            tasks = live_tasks(job)
            stmt = ssn.statement()
            k = solved_ix.get(id(job))
            if k is not None:
                lo, hi = slices[k]
                try:
                    solver.replay(tasks, res.task_node[lo:hi],
                                  res.task_pipelined[lo:hi], stmt)
                except Exception:
                    stmt.discard()
                    raise
                verified.append((job, list(tasks)))
                tasks.clear()
            if ssn.job_ready(job):
                stmt.commit()
            elif not ssn.job_pipelined(job):
                stmt.discard()
            namespaces.push(ns)
        if ok and solvable:
            solver.state = _new_state(res)
        elif verified:
            solver.state = _new_state(solver.solve(verified, start)[0])
        if ok and len(predicted) == b_cur:
            b_cur = min(b_cur * 2, b_max)
        elif not ok:
            b_cur = max(batch, b_cur // 2)
        if carry is None and not ok:
            break                           # the live loop drained
    return solver.stats


# ---------------------------------------------------------------------------
# the fused solve
# ---------------------------------------------------------------------------

def _execute_fused(ssn, blocks: bool = False,
                   max_order_iters: int = 4,
                   first_solution: Optional["_FusedSolution"] = None,
                   first_ordered: Optional[List] = None,
                   first_assumed: Optional[set] = None,
                   only_jobs: Optional[set] = None) -> Dict[str, object]:
    """tpu-fused, or with ``blocks`` tpu-blocks: iterate (order simulation
    → one device solve) until the admitted-job set stabilizes, then replay
    the final solve. Convergence is usually immediate; gang rollbacks
    trigger one extra iteration because a failed job must stop influencing
    queue shares and overused gating.

    With stateful predicates (host ports) a device proposal can fail the
    live re-check at replay because an earlier replay placement changed the
    state the mask was computed from. Those tasks stay pending, and up to
    two more rounds re-solve them against the fresh session state — the
    batched analogue of the reference's per-task re-evaluation.

    ``first_solution``/``first_ordered`` seed the fixed point with a first
    iteration already solved: the pipelined commit's speculative solve,
    from the same snapshot values, order and kernel the serial cycle would
    have used. When its admitted set does not match its premise
    (``first_assumed``: None for all admitted, the empty set for a solve
    warm-started at the ∅ fixed point) the loop goes on as the serial cycle
    would. ``only_jobs`` restricts the execution to those uids (the
    commit's suffix solve). LAST_STATS["final_kept_empty"] records whether
    the fixed point converged at the empty admitted set, the witness of the
    next speculation's warm start.

    Returns the phases' host wall seconds: "order" (the order simulation),
    "assemble" (the solve's tensors, built and copied to the device),
    "solve" (the kernels, the one device-to-host copy and the decode),
    "replay", and "solves", the number of solves; with ``blocks`` also
    "blocks", the block auction's counts (ops/blocks.py)."""
    stats: Dict[str, object] = {"order": 0.0, "assemble": 0.0, "solve": 0.0,
                                "replay": 0.0, "solves": 0}
    blocks_stats = stats["blocks"] = {} if blocks else None
    max_rounds = 3 if ssn.stateful_predicates else 1
    seeded = first_solution
    kept_uids: Optional[set] = None
    solution = None
    for _ in range(max_rounds):
        assumed: Optional[set] = None
        solution = None
        for _ in range(max_order_iters):
            if seeded is not None:
                # iteration 1 ran in the speculate window
                ordered_jobs, solution = first_ordered, seeded
                assumed = first_assumed
                seeded = None
            else:
                with obs_trace.span("order") as sp:
                    ordered_jobs = _fixed_job_order(ssn, assumed, only_jobs)
                stats["order"] += sp.dur_s
                if not ordered_jobs:
                    solution = None
                    break
                # the span covers the assembly too, where the JAX
                # package's solve span opens
                with obs_trace.span("solve",
                                    kernel=_solve_route(ssn, blocks)):
                    t1 = time.perf_counter()
                    inputs = placement_inputs(ssn, ordered_jobs)
                    t2 = time.perf_counter()
                    stats["assemble"] += t2 - t1
                    if inputs is not None:
                        with metrics.solver_trace("allocate-solve"):
                            solution = _fused_solution(inputs, blocks,
                                                       blocks_stats)
                        stats["solve"] += time.perf_counter() - t2
                        stats["solves"] += 1
                if inputs is None:
                    solution = None
                    break
            kept_uids = {solution.jobs_list[jx].uid
                         for jx in range(len(solution.jobs_list))
                         if solution.job_kept[jx]}
            # assumed=None simulated "all jobs admitted" — if the solve
            # indeed kept every job the premise held; no re-solve needed.
            if kept_uids == assumed or (
                    assumed is None
                    and kept_uids == {j.uid for j in ordered_jobs}):
                break
            assumed = kept_uids
        if solution is None:
            break
        with obs_trace.span("replay") as sp:
            rejected = _replay_fused(ssn, solution)
        stats["replay"] += sp.dur_s
        if not rejected:
            break
    LAST_STATS["final_kept_empty"] = bool(solution is not None
                                          and kept_uids is not None
                                          and not kept_uids)
    if blocks_stats is None:
        del stats["blocks"]
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
    topo_weight: float              # B6's weight; 0 solves with B1


def placement_inputs(ssn, ordered_jobs) -> Optional[PlacementInputs]:
    """Assemble the solve's tensors for ``ordered_jobs``; None when there
    is nothing to place."""
    tasks, job_ix, jobs_list = _collect_pending_ordered(ssn, ordered_jobs)
    if not tasks or not ssn.nodes:
        return None
    rnames = discover_resource_names(list(ssn.nodes.values()), tasks)
    node_t = _node_tensors(ssn, rnames)
    req = task_requests(tasks, rnames)
    feas = assemble_feasibility(ssn, tasks, node_t)
    static = assemble_static_score(ssn, tasks, node_t)
    weights = assemble_weights(ssn, rnames)
    # Non-finite values would flow through the kernel into silently wrong
    # placements (an inf score times a zero weight is NaN) — refuse them.
    if not np.isfinite(req).all() or (
            static is not None and not np.isfinite(static).all()):
        raise SolverFault("non-finite task requests or static scores")
    topo_w = _topology_weight(ssn)
    if not (np.isfinite(weights.binpack_res).all()
            and all(np.isfinite(w) for w in (
                weights.binpack_weight, weights.least_req_weight,
                weights.most_req_weight, weights.balanced_weight, topo_w))):
        raise SolverFault("non-finite score weights")
    min_av, base_r, base_p = _gang_meta(jobs_list)
    return PlacementInputs(
        tasks=tasks, jobs_list=jobs_list, node_t=node_t,
        req=upload(req, ssn.device),
        job_ix=np.asarray(job_ix, np.int32),
        masked_static=_masked_static(feas, static, len(tasks),
                                     len(node_t.names), ssn.device),
        min_available=min_av, base_ready=base_r, base_pipelined=base_p,
        weights=weights, topo_weight=topo_w)


def _masked_static(feas, static, T: int, N: int, device):
    """The plugins' [T,N] mask and static scores (None where every plugin
    abstains) folded into one f32[T,N] on ``device``: the static scores
    where the mask allows the pair, NEG elsewhere; None when both are None
    (the solves then test no mask and add no static score, which gives the
    same bits as an all-true mask and a zero matrix)."""
    if feas is None and static is None:
        return None
    f = np.ones((T, N), bool) if feas is None else feas
    s = np.zeros((T, N), np.float32) if static is None else static
    return upload(np.where(f, s, NEG).astype(np.float32), device)


def solve(inputs: PlacementInputs, blocks: bool = False,
          stats: Optional[Dict[str, int]] = None):
    """One solve of ``inputs``: the placement kernel (ops/place.place), B6
    at a positive topology weight (allocate.py:1402-1406), or with
    ``blocks`` the block auction (ops/blocks.place_blocks_unified, which has
    no anchor term) at the reference's size-scaled budgets, 5 sweeps and 4
    passes above BLOCKS_BIG_T tasks, else 3 and 3 (allocate.py:1387-1393).
    Returns (task_node, task_pipelined, job_ready, job_kept) as NumPy
    arrays."""
    nt = inputs.node_t
    if not blocks:
        res = place(nt.idle, nt.future_idle, nt.used, nt.ntasks,
                    nt.allocatable, nt.max_tasks, inputs.req, inputs.job_ix,
                    inputs.masked_static, inputs.min_available,
                    inputs.base_ready, inputs.base_pipelined, inputs.weights,
                    nt.zone_code, inputs.topo_weight)
        return res.task_node, res.task_pipelined, res.job_ready, res.job_kept
    T = len(inputs.tasks)
    J = len(inputs.min_available)
    big = T > BLOCKS_BIG_T
    dev = inputs.req.device
    packed, _ = place_blocks_unified(
        None, NodeState(nt.idle, nt.future_idle, nt.used, nt.ntasks),
        inputs.req, torch.ones(T, dtype=torch.bool, device=dev),
        torch.tensor(inputs.job_ix, device=dev),
        JobMeta(inputs.min_available, inputs.base_ready,
                inputs.base_pipelined),
        inputs.weights, nt.allocatable, nt.max_tasks,
        sweeps=5 if big else 3, passes=4 if big else 3,
        masked_static=inputs.masked_static, stats=stats)
    packed = packed.cpu().numpy()
    Tp = padded_task_len(T)
    return (packed[:T], packed[Tp:Tp + T].astype(bool),
            packed[2 * Tp:2 * Tp + J].astype(bool),
            packed[2 * Tp + J:].astype(bool))


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


def _fused_solution(inputs: PlacementInputs, blocks: bool = False,
                    stats: Optional[Dict[str, int]] = None
                    ) -> _FusedSolution:
    return _FusedSolution(inputs.tasks, inputs.job_ix, inputs.jobs_list,
                          inputs.node_t, *solve(inputs, blocks, stats))


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

def _stateful_recheck(ssn, task, node) -> bool:
    """Re-validate a device proposal through the predicate chain when a
    plugin registered itself in ssn.stateful_predicates (host ports): the
    static feasibility mask shipped to the device is necessary but not
    sufficient for those, and the reference evaluates them per placement."""
    try:
        ssn.predicate_fn(task, node)
        return True
    except ValueError:              # a predicate's fit error
        return False


def _fast_replay_ok(ssn) -> bool:
    """The batched replay skips the per-task Statement machinery; it is
    sound only when (a) no stateful predicates need re-checking, (b) every
    event handler declared itself additive per job and (c) the gang plugin
    alone decides job readiness/pipelining, so the kernel's gang verdicts
    (gang.go's formula) are authoritative."""
    if ssn.stateful_predicates:
        return False
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
    # a hole row of the persistent tensors (name "") is never placed on
    node_objs = [ssn.nodes.get(nm) if nm else None for nm in names]
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
        node._touched = True          # direct aggregate mutation below
        node.idle.sub(r)
        node.used.add(r)
    for row, r in pipe_agg.items():
        node = node_objs[row]
        node._touched = True
        node.pipelined.add(r)
    # the statement-free path never goes through session.dispatch, so it
    # feeds the decision audit here (a no-op unless the audit is on)
    for task in binds:
        ssn._audit_event("bind", task, task.node_name)
    # bind_batch records every bound task/node in the cache's dirty set, so
    # the NEXT cycle's snapshot+tensor delta is exactly this cycle's binds
    with obs_trace.span("bind_commit", binds=len(binds)):
        ssn.cache.bind_batch(binds)


def _replay_fused(ssn, sol: _FusedSolution) -> int:
    """Replay the device decisions through the session: batched when
    _fast_replay_ok holds, else through Statements, job by job, preserving
    gang atomicity on the host model (statement.go semantics). Returns the
    number of proposals the live stateful re-check rejected (the caller
    re-solves those tasks against fresh state)."""
    if _fast_replay_ok(ssn):
        _replay_fused_fast(ssn, sol)
        return 0
    per_job_tasks: Dict[int, List[int]] = {}
    for i, jx in enumerate(sol.job_ix):
        per_job_tasks.setdefault(int(jx), []).append(i)
    recheck = bool(ssn.stateful_predicates)
    rejected = 0
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
                node = ssn.nodes[name]
                if recheck and not _stateful_recheck(ssn, sol.tasks[i],
                                                     node):
                    rejected += 1
                    continue
                if sol.pipelined[i]:
                    stmt.pipeline(sol.tasks[i], name)
                else:
                    stmt.allocate(sol.tasks[i], node)
        except Exception:
            stmt.discard()
            raise
        if ssn.job_ready(job):
            stmt.commit()
        elif not ssn.job_pipelined(job):
            stmt.discard()
    return rejected


# ---------------------------------------------------------------------------
# the speculative dispatch/await split (the pipelined cycle)
# ---------------------------------------------------------------------------

_SIDE_STREAMS: Dict[torch.device, object] = {}


def speculation_stream(device: torch.device):
    """The side CUDA stream the speculative solves of ``device`` run on,
    made at first use; None on the CPU."""
    if device.type != "cuda":
        return None
    stream = _SIDE_STREAMS.get(device)
    if stream is None:
        stream = _SIDE_STREAMS[device] = torch.cuda.Stream(device=device)
    return stream


class PendingFusedSolution:
    """A dispatched, not yet fetched, first solve of tpu-fused's fixed
    point, with what the commit boundary needs to fetch and replay it.
    Holding it is the overlap: the card solves on the side stream while
    the host commits the previous cycle."""

    __slots__ = ("ordered_jobs", "tasks", "job_ix", "jobs_list", "node_t",
                 "wire", "event", "eligible_uids", "assumed_hint",
                 "dispatch_s", "done_at_fetch", "wait_s")

    def __init__(self, ordered_jobs, tasks, job_ix, jobs_list, node_t,
                 wire, event, eligible_uids, assumed_hint=None,
                 dispatch_s=0.0):
        self.ordered_jobs = ordered_jobs
        self.tasks = tasks
        self.job_ix = job_ix
        self.jobs_list = jobs_list
        self.node_t = node_t
        self.wire = wire            # i32 [2T + 2J] on the solve's device
        self.event = event          # recorded after the decode; None on CPU
        # every job eligible at speculation time, covered or not: the
        # commit suffix-solves the jobs eligible then that are not here
        self.eligible_uids = eligible_uids
        # None: the all-admitted premise (the serial iteration 1); set():
        # warm-started at the ∅ fixed point, which the commit must verify
        self.assumed_hint = assumed_hint
        # host seconds of the dispatch; at the fetch, whether the card had
        # finished (counted only, never branched on) and the seconds waited
        self.dispatch_s = dispatch_s
        self.done_at_fetch: Optional[bool] = None
        self.wait_s: Optional[float] = None


def dispatch_speculative_solve(ssn, engine: str = "tpu-fused",
                               assumed_hint: Optional[set] = None
                               ) -> Optional[PendingFusedSolution]:
    """Order, assemble and launch the first solve of tpu-fused's fixed
    point for ``ssn`` (a speculative session) without synchronizing the
    host: on the card the solve and B7's decode run on the side stream
    (``speculation_stream``) and this returns as soon as they are queued;
    ``finalize_speculative_dispatch`` fetches the wire at the commit
    boundary. The assembly is the serial solve's own
    (``placement_inputs``: ``_collect_pending_ordered``, ``_gang_meta``,
    ``_masked_static``), so a committed speculation equals the serial
    cycle's solve. ``assumed_hint`` set() starts the order at the ∅ fixed
    point (the previous cycle converged there); None is the serial start.
    Returns None when speculation cannot run this cycle: stateful
    predicates, no nodes, an engine that is not the placement kernel,
    nothing pending, or non-finite inputs (the serial solve's SolverFault
    owns those)."""
    if ssn.stateful_predicates or not ssn.nodes:
        return None
    if engine not in SPECULATIVE_ENGINES:
        return None
    t0 = time.perf_counter()
    with obs_trace.span("order", speculative=True):
        ordered_jobs = _fixed_job_order(ssn, assumed_hint)
    if not ordered_jobs:
        return None
    try:
        inputs = placement_inputs(ssn, ordered_jobs)
    except SolverFault:
        return None
    if inputs is None:
        return None
    nt = inputs.node_t
    # no span of its own: the launch is timed by the shell's "speculate"
    # span, as the JAX package's dispatch is
    wire, event = place_dispatch(
        nt.idle, nt.future_idle, nt.used, nt.ntasks, nt.allocatable,
        nt.max_tasks, inputs.req, inputs.job_ix, inputs.masked_static,
        inputs.min_available, inputs.base_ready, inputs.base_pipelined,
        inputs.weights, speculation_stream(inputs.req.device),
        nt.zone_code, inputs.topo_weight)
    return PendingFusedSolution(
        ordered_jobs, inputs.tasks, inputs.job_ix, inputs.jobs_list, nt,
        wire, event, {j.uid for j in _eligible_jobs(ssn)},
        assumed_hint=assumed_hint, dispatch_s=time.perf_counter() - t0)


def finalize_speculative_dispatch(pending: PendingFusedSolution
                                  ) -> _FusedSolution:
    """The dispatched solve's one fetch: always waits on its event, so
    what it returns never depends on how fast the card was. Raises
    SolverFault on a node index out of range (the shell then re-solves
    the cycle serially)."""
    T, J = len(pending.tasks), len(pending.jobs_list)
    with obs_trace.span("solve", speculative=True):
        pending.done_at_fetch = (pending.event is None
                                 or pending.event.query())
        t0 = time.perf_counter()
        task_node, pipelined, job_ready, job_kept = fetch_packed(
            pending.wire, pending.event, T, J)
        pending.wait_s = time.perf_counter() - t0
    return _FusedSolution(pending.tasks, pending.job_ix, pending.jobs_list,
                          pending.node_t, task_node, pipelined, job_ready,
                          job_kept)


def remap_speculative_solution(sol: _FusedSolution, ordered_jobs, ssn):
    """Re-anchor a speculative solution onto the commit session's objects
    by uid; sound because the conflict check proved the covered jobs' and
    the placed-on nodes' decision inputs unchanged since the speculative
    snapshot (on a promotion the session is the speculative one and this
    is the identity). Returns ``(solution, ordered)``, or ``(None, None)``
    when a covered job, task or node vanished or a task is no longer
    pending (the shell counts a conflict)."""
    jobs_list = []
    for job in sol.jobs_list:
        live = ssn.jobs.get(job.uid)
        if live is None:
            return None, None
        jobs_list.append(live)
    ordered = []
    for job in ordered_jobs:
        live = ssn.jobs.get(job.uid)
        if live is None:
            return None, None
        ordered.append(live)
    tasks = []
    for t in sol.tasks:
        job = ssn.jobs.get(t.job)
        live = job.tasks.get(t.uid) if job is not None else None
        if live is None or live.status != TaskStatus.PENDING:
            return None, None
        tasks.append(live)
    tn = np.asarray(sol.task_node)
    for n in np.unique(tn[tn != NO_NODE]):
        if sol.node_t.names[int(n)] not in ssn.nodes:
            return None, None
    mapped = _FusedSolution(tasks, sol.job_ix, jobs_list, sol.node_t,
                            sol.task_node, sol.pipelined, sol.job_ready,
                            sol.job_kept)
    return mapped, ordered
