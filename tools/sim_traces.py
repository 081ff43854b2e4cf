"""Sim traces beyond the package's named scenarios, and a recorder of the
allocate solves' node-tensor path, shared by ``tools/sim_reference.py``
(the JAX package's reference runs), the port's CPU tests and
``chip_smoke.py`` (the port on the card). The traces are built with the
port's trace generator, which ``tests/test_torch_sim.py`` holds equal to
the JAX package's line for line, and both sims replay them from a JSONL
file (``--trace``).

- ``churn``: the ``node-flap`` scenario (800 gangs on 32 nodes, seed 0)
  plus two node deaths (node-00012 and node-00013 at t = 20) and two fresh
  nodes of node-flap's shape (node-x0 and node-x1 at t = 22), so the
  persistent node tensors open holes and refill them.
- ``hole-10k``: BASELINE config 3 (``baseline_config("10k")``: 10,000 pods
  in 200 gangs on 2,000 nodes of 32 CPU / 128 GiB / 110 pods), all at
  t = 0. Cycle 1 places every pod and leaves no node empty, so four spare
  nodes of the same shape join at t = 1, with one small gang (cycle 2
  places it on spare-0 and the tensors absorb cycle 1's binds in a full
  rebuild). At t = 2 the empty spare-1 dies, a fresh spare-x joins and
  three one-pod gangs that each need a whole node arrive: cycle 3 takes
  the scatter path, spare-x takes spare-1's row, and the three gangs land
  on spare-x, spare-2 and spare-3 in row order with the persistent
  tensors on, in snapshot order (spare-2, spare-3, spare-x) with them off.
- ``backlog-16k``: the ``pipelined-steady`` scenario scaled up to
  steady-10k's cluster, a full-width world with a standing backlog: 2,000
  gangs of 4, 8 or 16 pods (about 16,000 pods, 1 or 2 CPU and 1 GiB each,
  30-45 s each) land at about t = 0 on 300 nodes of 32 CPU / 128 GiB / 110
  pods, so about 26,000 CPU of demand face 9,600 of capacity and the
  cluster drains the gangs in waves over about 100 cycles. Each cycle
  leaves a backlog for the pipelined shell to speculate over.
- ``elastic-10k``: BASELINE config 3 (as ``hole-10k``) with topology and
  elastic gangs: node i joins zone ``z{i // 16:03d}`` (125 zones of 16
  nodes, 512 CPU a zone against a mean gang of about 110 CPU) and every
  gang is elastic with ``desired`` its task count and ``min_available``
  two below it (at least 1). Under ``elastic_deployed_conf(10)``
  allocate's zone-anchor solve (B6) places the core members and
  grow-shrink the other two of each gang.

``elastic_deployed_conf(w)`` is ``deploy/scheduler.conf`` as written with
three changes: the elastic-gang plugin in tier 1 with ``topology-weight:
w``, grow-shrink right after allocate-tpu, and ``topology-weight: w`` under
allocate-tpu, whose engine stays tpu-fused: at ``w > 0`` its solve is the
zone-anchor mode. ``CONFS`` names it at weights 10 and 0.

Run as a script, it writes one trace: ``python tools/sim_traces.py NAME
OUT.jsonl``, or one conf: ``python tools/sim_traces.py --conf NAME
OUT.conf``.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from typing import Dict, List

GI = 1 << 30
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# node-flap's node shape (synthetic_trace's defaults)
NODE_SHAPE = {"cpu_milli": 32000, "mem": 128 * GI, "pods": 110, "gpus": 0}


def _job(name: str, queue: str, priority: int, tasks: int, cpu: int,
         duration: float) -> dict:
    return {"name": name, "queue": queue, "priority": priority,
            "tasks": tasks, "min_available": tasks, "cpu_milli": cpu,
            "mem": GI, "gpus": 0, "duration": duration}


def churn_trace(seed: int = 0):
    from volcano_tpu_torch.sim.trace import TraceEvent, validate_trace
    from volcano_tpu_torch.sim.workload import make_scenario
    extra = [TraceEvent(20.0, "node_fail", {"name": "node-00012"}),
             TraceEvent(20.0, "node_fail", {"name": "node-00013"}),
             TraceEvent(22.0, "node_add", {"name": "node-x0", **NODE_SHAPE}),
             TraceEvent(22.0, "node_add", {"name": "node-x1", **NODE_SHAPE})]
    return validate_trace(_merge(make_scenario("node-flap", seed=seed),
                                 extra))


def hole_trace(seed: int = 0):
    from volcano_tpu_torch.sim.trace import TraceEvent, validate_trace
    from volcano_tpu_torch.sim.workload import baseline_trace
    extra = [TraceEvent(1.0, "node_add", {"name": f"spare-{i}",
                                          **NODE_SHAPE})
             for i in range(4)]
    extra.append(TraceEvent(1.0, "job_arrival",
                            _job("small-0", "q1", 0, 1, 1000, 30.0)))
    extra.append(TraceEvent(2.0, "node_fail", {"name": "spare-1"}))
    extra.append(TraceEvent(2.0, "node_add", {"name": "spare-x",
                                              **NODE_SHAPE}))
    for i in range(3):
        extra.append(TraceEvent(2.0, "job_arrival",
                                _job(f"whole-{i}", "q1", 3 - i, 1,
                                     NODE_SHAPE["cpu_milli"], 30.0)))
    return validate_trace(_merge(baseline_trace("10k", seed=seed), extra))


def backlog_trace(seed: int = 0):
    from volcano_tpu_torch.sim.trace import validate_trace
    from volcano_tpu_torch.sim.workload import synthetic_trace
    return validate_trace(synthetic_trace(
        2000, 300, seed=seed, arrival_rate=1000.0, duration_mean=30.0,
        duration_cap=45.0, tail_alpha=4.0,
        gang_sizes=((4, 0.4), (8, 0.4), (16, 0.2)), queues=(("q1", 1),),
        cpu_choices=(1000, 2000), mem_choices=(GI,),
        priority_choices=(0,)))


def elastic_10k_trace(seed: int = 0):
    from volcano_tpu_torch.sim.trace import TraceEvent, validate_trace
    from volcano_tpu_torch.sim.workload import baseline_trace
    out = []
    nodes = 0
    for ev in baseline_trace("10k", seed=seed):
        d = dict(ev.data)
        if ev.kind == "node_add":
            d["zone"] = f"z{nodes // 16:03d}"
            nodes += 1
        elif ev.kind == "job_arrival":
            d["desired"] = d["tasks"]
            d["min_available"] = max(1, d["tasks"] - 2)
        out.append(TraceEvent(ev.t, ev.kind, d))
    return validate_trace(out)


def elastic_deployed_conf(w: float) -> str:
    """deploy/scheduler.conf with elastic gangs and the topology term at
    weight ``w`` (module docstring)."""
    with open(os.path.join(REPO, "deploy", "scheduler.conf")) as f:
        text = f.read()
    w = float(w)
    edits = (
        ('actions: "enqueue, allocate-tpu, preempt, reclaim, backfill"',
         'actions: "enqueue, allocate-tpu, grow-shrink, preempt, reclaim, '
         'backfill"'),
        ("  - name: gang\n",
         f"  - name: gang\n  - name: elastic-gang\n    arguments:\n"
         f"      topology-weight: {w}\n"),
        ("    engine: tpu-fused\n",
         f"    engine: tpu-fused\n    topology-weight: {w}\n"))
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"deploy/scheduler.conf: {old!r} is not there "
                             f"once")
        text = text.replace(old, new)
    return text


def _merge(trace, extra):
    """``extra`` after every event of ``trace`` at the same time, in its
    own order."""
    out = list(trace)
    for ev in extra:
        at = len(out)
        while at and out[at - 1].t > ev.t:
            at -= 1
        out.insert(at, ev)
    return out


TRACES = {"churn": churn_trace, "hole-10k": hole_trace,
          "backlog-16k": backlog_trace, "elastic-10k": elastic_10k_trace}
CONFS = {"elastic-deployed-10": lambda: elastic_deployed_conf(10),
         "elastic-deployed-0": lambda: elastic_deployed_conf(0)}


def write_trace_file(name: str, path: str) -> str:
    from volcano_tpu_torch.sim.trace import write_trace
    write_trace(path, TRACES[name]())
    return path


def write_conf_file(name: str, path: str) -> str:
    with open(path, "w") as f:
        f.write(CONFS[name]())
    return path


class TensorPathRecorder:
    """Records, solve by solve, which node-tensor path a package's allocate
    took (``actions/allocate.py::_node_tensors``: the persistent rows or a
    fresh build; for the persistent rows whether the refresh rebuilt them
    all and how many rows it scattered; a pipelined run's speculative
    solves too), and every drift the shadow verifier repaired. Works on either package: pass its allocate module
    and its SchedulerCache class. ``close`` restores both."""

    def __init__(self, alloc_module, cache_cls):
        self.paths: List[list] = []
        self.drift: List[dict] = []
        self._alloc = alloc_module
        self._cache_cls = cache_cls
        self._node_tensors = alloc_module._node_tensors
        self._verify = cache_cls.verify_state_integrity
        real_nt, real_verify, rec = self._node_tensors, self._verify, self

        def node_tensors(ssn, rnames):
            node_t = real_nt(ssn, rnames)
            if alloc_module.LAST_STATS["tensor_incremental"]:
                # a speculative solve reads a pinned epoch of the
                # persistent tensors; its owner holds the refresh's stats
                refresh = getattr(node_t, "_owner", node_t).last_refresh
                rec.paths.append(["persistent", bool(refresh["full"]),
                                  int(refresh["rows"])])
            else:
                rec.paths.append(["fresh", False, len(node_t.names)])
            return node_t

        def verify(cache, *args, **kwargs):
            stats = real_verify(cache, *args, **kwargs)
            if stats["drift_total"]:
                rec.drift.append(stats["drift"])
            return stats

        alloc_module._node_tensors = node_tensors
        cache_cls.verify_state_integrity = verify

    def close(self) -> None:
        self._alloc._node_tensors = self._node_tensors
        self._cache_cls.verify_state_integrity = self._verify

    def summary(self) -> Dict[str, object]:
        """Counts of the solves by path and the SHA-256 of the whole
        solve-by-solve record (comparable across packages)."""
        persistent = [p for p in self.paths if p[0] == "persistent"]
        scatters = [p for p in persistent if not p[1] and p[2]]
        text = json.dumps(self.paths, separators=(",", ":")).encode()
        return {"sha256": hashlib.sha256(text).hexdigest(),
                "solves": len(self.paths),
                "persistent": len(persistent),
                "fresh": len(self.paths) - len(persistent),
                "full": sum(1 for p in persistent if p[1]),
                "scatter": len(scatters),
                "scatter_rows": sum(p[2] for p in scatters),
                "drift": self.drift}


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if sys.argv[1] == "--conf":
        write_conf_file(sys.argv[2], sys.argv[3])
    else:
        write_trace_file(sys.argv[1], sys.argv[2])
