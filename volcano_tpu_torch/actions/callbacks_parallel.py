"""`callbacks-parallel`: the callbacks engine with its two hot loops fanned
out over a process pool, the mirror of the reference's 16-way
``workqueue.ParallelizeUntil`` in PredicateNodes / PrioritizeNodes
(pkg/scheduler/util/scheduler_helper.go:121,157); the JAX package's
actions/callbacks_parallel.py.

It keeps the CPU-vs-device comparison honest at 10k pods / 2k nodes: the
single-threaded callbacks loop overstates the reference's cycle time by
about the worker count, so a benchmark compares the device engines with
this engine's wall clock while its decisions equal the serial callbacks
engine's.

Design (Go's goroutines share memory; Python processes do not):

- the pool forks after the session opens: each worker inherits the session
  snapshot (plugins, their closures, node state) copy-on-write and runs
  the same ``predicate_fn`` / ``node_order_fn`` chains the parent would;
- a placement journal keeps the workers' copies current: every statement
  op (allocate, pipeline, and their reverses when a gang is discarded) is
  appended by the parent and shipped to each worker with its next request;
  the worker replays them before it scans, so every evaluation sees the
  state the serial engine would;
- decisions equal the serial engine's: the default conf scans every node
  (no early-exit nondeterminism), chunk results merge in node order, and
  the batch scores and the best-node choice run in the parent.

Forking after CUDA: in the port the parent may already hold CUDA state
(a session on the card, the cache's device tensors). CUDA cannot be
re-initialised in a forked child, and a child that touches a CUDA tensor
hangs or crashes rather than raising. So the workers evaluate host
objects only, and each worker replaces ``torch.cuda._lazy_init`` with a
guard that counts the attempt and raises: a plugin callback that reached
for the card fails that node's evaluation by name instead of hanging, and
``_ScanPool.cuda_attempts`` reports it (the tests hold it at zero).
"""

from __future__ import annotations

import multiprocessing as mp
import os
from typing import Dict, List

from ..api import TaskStatus
from ..api.unschedule_info import FitErrors
from ..utils.scheduler_helper import (calculate_num_feasible_nodes,
                                      select_best_node)

DEFAULT_WORKERS = 16        # scheduler_helper.go:121 workqueue width


def effective_cpus() -> int:
    """CPUs available to this process (affinity aware): os.cpu_count()
    reports the host's cores and over-forks in containers."""
    try:
        return max(1, len(os.sched_getaffinity(0)))
    except (AttributeError, OSError):
        return max(1, os.cpu_count() or 1)


def _guard_cuda() -> List[int]:
    """In a forked worker: make any CUDA initialisation raise, counting the
    attempts (returned list's one entry)."""
    import torch

    attempts = [0]

    def refuse(*_args, **_kwargs):
        attempts[0] += 1
        raise RuntimeError("callbacks-parallel worker: a forked worker must "
                           "not touch CUDA (the parent may hold its state)")

    torch.cuda._lazy_init = refuse
    return attempts


def _worker_main(conn, ssn, node_names: List[str]) -> None:
    """Forked worker: owns a copy-on-write copy of the session; replays
    journal ops and evaluates predicate/score chunks on request."""
    attempts = _guard_cuda()
    nodes = ssn.nodes

    def apply_ops(ops) -> None:
        for op, job_uid, task_uid, hostname in ops:
            job = ssn.jobs[job_uid]
            task = job.tasks[task_uid]
            if op in ("alloc", "pipe"):
                status = (TaskStatus.ALLOCATED if op == "alloc"
                          else TaskStatus.PIPELINED)
                job.update_task_status(task, status)
                task.node_name = hostname
                nodes[hostname].add_task(task)
            else:                              # un-alloc / un-pipe
                job.update_task_status(task, TaskStatus.PENDING)
                node = nodes.get(task.node_name)
                if node is not None:
                    node.remove_task(task)
                task.node_name = ""

    while True:
        msg = conn.recv()
        cmd = msg[0]
        if cmd == "stop":
            return
        if cmd == "probe":
            import torch
            conn.send((os.getpid(), attempts[0],
                       bool(torch.cuda.is_initialized())))
            continue
        ops, job_uid, task_uid, lo, hi = msg[1], msg[2], msg[3], msg[4], msg[5]
        apply_ops(ops)
        task = ssn.jobs[job_uid].tasks[task_uid]
        if cmd == "pred":
            feasible: List[str] = []
            errors: List = []
            for name in node_names[lo:hi]:
                node = nodes[name]
                try:
                    if not task.init_resreq.less_equal(node.future_idle()):
                        from .allocate import _fit_error
                        raise _fit_error(task, node)
                    ssn.predicate_fn(task, node)
                except Exception as err:       # noqa: BLE001 — as serial
                    errors.append((name, getattr(err, "fit_error",
                                                 str(err))))
                    continue
                feasible.append(name)
            conn.send((feasible, errors))
        elif cmd == "score":
            cand = msg[6]
            conn.send([ssn.node_order_fn(task, nodes[name])
                       for name in cand])


class _ScanPool:
    def __init__(self, ssn, workers: int):
        self.node_names = list(ssn.nodes)
        self.workers = workers
        self.pipes = []
        self.procs = []
        self.journal: List[tuple] = []
        self.cursor = [0] * workers
        ctx = mp.get_context("fork")
        for _ in range(workers):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_worker_main,
                            args=(child, ssn, self.node_names), daemon=True)
            p.start()
            child.close()
            self.pipes.append(parent)
            self.procs.append(p)

    def _send(self, w: int, cmd: str, job_uid, task_uid, lo, hi,
              extra=None):
        ops = self.journal[self.cursor[w]:]
        self.cursor[w] = len(self.journal)
        msg = [cmd, ops, job_uid, task_uid, lo, hi]
        if extra is not None:
            msg.append(extra)
        self.pipes[w].send(tuple(msg))

    def _chunks(self, n: int):
        per = -(-n // self.workers)
        return [(w, w * per, min(n, (w + 1) * per))
                for w in range(self.workers) if w * per < n]

    def predicate(self, task):
        chunks = self._chunks(len(self.node_names))
        for w, lo, hi in chunks:
            self._send(w, "pred", task.job, task.uid, lo, hi)
        feasible: List[str] = []
        errors = FitErrors()
        for w, _lo, _hi in chunks:
            names, errs = self.pipes[w].recv()
            feasible.extend(names)
            for name, fe in errs:
                errors.set_node_error(name, fe)
        return feasible, errors

    def score(self, task, candidates: List[str]) -> Dict[str, float]:
        chunks = self._chunks(len(candidates))
        for w, lo, hi in chunks:
            self._send(w, "score", task.job, task.uid, lo, hi,
                       extra=candidates[lo:hi])
        out: Dict[str, float] = {}
        for w, lo, hi in chunks:
            for name, s in zip(candidates[lo:hi], self.pipes[w].recv()):
                out[name] = s
        return out

    def record(self, op: str, task) -> None:
        self.journal.append((op, task.job, task.uid, task.node_name))

    def record_reverts(self, ops) -> None:
        from ..framework.statement import ALLOCATE
        for op in reversed(ops):
            kind = "un-alloc" if op.name == ALLOCATE else "un-pipe"
            self.journal.append((kind, op.task.job, op.task.uid, ""))

    def cuda_attempts(self) -> List[tuple]:
        """Each worker's (pid, CUDA initialisations it attempted, whether
        its torch reports CUDA initialised)."""
        for pipe in self.pipes:
            pipe.send(("probe",))
        return [pipe.recv() for pipe in self.pipes]

    def stop(self) -> None:
        for pipe in self.pipes:
            try:
                pipe.send(("stop",))
            except (BrokenPipeError, OSError):
                pass
        for p in self.procs:
            p.join(timeout=2)
            if p.is_alive():
                p.terminate()


class ParallelCallbackJobPlacer:
    """Drop-in for allocate._CallbackJobPlacer with pooled node scans. Needs
    the default full-node scan (percentage 100): an adaptive early-exit
    scan depends on order and stays on the serial engine."""

    def __init__(self, ssn, workers: int = 0):
        self.ssn = ssn
        self.workers = workers or min(DEFAULT_WORKERS, effective_cpus())
        self.pool = _ScanPool(ssn, self.workers)

    def place(self, job, tasks, stmt, jobs_pq) -> None:
        ssn = self.ssn
        pool = self.pool
        node_map = ssn.nodes
        while tasks:
            task = tasks.pop(0)
            to_find = calculate_num_feasible_nodes(len(pool.node_names))
            feasible_names, fit_errors = pool.predicate(task)
            feasible = [node_map[n] for n in feasible_names[:to_find]]
            if not feasible:
                job.nodes_fit_errors[task.uid] = fit_errors
                break
            candidates = [n for n in feasible
                          if task.init_resreq.less_equal(n.idle)
                          or task.init_resreq.less_equal(n.future_idle())]
            if not candidates:
                continue
            name_scores = pool.score(task, [n.name for n in candidates])
            for name, s in (ssn.batch_node_order_fn(
                    task, candidates) or {}).items():
                if name in name_scores:
                    name_scores[name] += s
            grouped: Dict[float, List] = {}
            for n in candidates:
                grouped.setdefault(name_scores[n.name], []).append(n)
            node = ssn.best_node_fn(task, grouped) or select_best_node(grouped)
            if task.init_resreq.less_equal(node.idle):
                stmt.allocate(task, node)
                pool.record("alloc", task)
            elif task.init_resreq.less_equal(node.future_idle()):
                stmt.pipeline(task, node.name)
                pool.record("pipe", task)
            if ssn.job_ready(job) and tasks:
                jobs_pq.push(job)
                return

    def statement_closed(self, job, committed: bool, ops) -> None:
        """The action closed the job's statement; a discard is replayed
        into the worker journals."""
        if not committed:
            self.pool.record_reverts(ops)

    def close(self) -> None:
        self.pool.stop()
