#!/usr/bin/env python3
"""Record (not hold) how far the block auction's plain version is from the
JAX package's on fractional requests over many tasks, on the CPU.

    JAX_PLATFORMS=cpu python tools/blocks_frees_gap.py [--seeds 5] [T ...]

ops/blocks.py::blocks_plain adds the sweep's frees (unified.py:421-422,
``einsum("tn,tr->nr", hot, req)``) in blocks of 256 tasks, the order
XLA:CPU gives that product at 1,024 tasks. For the task counts given
(default: 1,024, 1,280, 1,536, 4,096 and 20,000, the 20k world's), and for
each seed, the world is T fractional requests in 8 gangs on 4 nodes, every
other gang one task short of its minAvailable, so every sweep frees half
the tasks.

Two witnesses per (T, seed), both from the JAX package in a child process
without FMA contraction (as the tests run it):
- ``solve``: place_blocks_unified(None, ...) against blocks_plain: whether
  the packed rows are equal, how many tasks' nodes differ and the first,
  and the largest difference of the final node state in ulps;
- ``einsum``: the bare frees product at that T, on a drop set and requests
  of the same seed, against the port's ordered block sum
  (``_block_node_sums``): the largest difference in ulps.

Where the solve differs, a third witness traces its first differing task:
the reference solves the tasks before that task's chunk (one gang of
minAvailable 1, so the first pass is the same), then that chunk alone from
the state they leave. It prints the node the reference's compiled program
picks there, the node the port picks, and the task's dynamic score on
every node evaluated op by op, by the JAX function jitted alone and by the
port.

Prints one JSON line per (T, seed) and per trace, and exits 0: the gap is a
record of XLA:CPU's compilation, not a check.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import torch_parity as tp  # noqa: E402

NODES, GANGS = 4, 8


def frees_world(seed: int, T: int) -> dict:
    """T fractional requests in GANGS gangs on NODES nodes; every other
    gang asks for one task more than it has, so the sweep frees it."""
    rng = np.random.RandomState(seed)
    req = rng.uniform(0.1, 2.3, size=(T, 2)).astype(np.float32)
    alloc = np.full((NODES, 2), 1e5, np.float32)
    size = T // GANGS
    mina = [size + 1 if j % 2 else size for j in range(GANGS)]
    job_ix = np.repeat(np.arange(GANGS), size)
    job_ix = np.concatenate([job_ix, np.full(T - len(job_ix), GANGS - 1)])
    return tp._blocks_world(alloc, req, job_ix, mina,
                            max_tasks=np.full(NODES, T))


def einsum_inputs(seed: int, T: int):
    """The frees product's operands: a one-hot [T, NODES] of a random half
    of the tasks on random nodes, and T fractional requests."""
    rng = np.random.RandomState(10_000 + seed)
    req = rng.uniform(0.1, 2.3, size=(T, 2)).astype(np.float32)
    node = rng.randint(0, NODES, size=T)
    drop = rng.rand(T) < 0.5
    return req, np.where(drop, node, -1)


def trace_worlds(seed: int, T: int, task: int):
    """The first pass of frees_world(seed, T) up to ``task``'s chunk (one
    gang of minAvailable 1), and the builder of that chunk alone from a
    node state."""
    req = frees_world(seed, T)["req"]
    lo = task // 256 * 256
    alloc = np.full((NODES, 2), 1e5, np.float32)
    maxt = np.full(NODES, T)
    before = tp._blocks_world(alloc, req[:lo], np.zeros(lo, np.int32), [1],
                              max_tasks=maxt)

    def chunk(state):
        w = tp._blocks_world(alloc, req[lo:lo + 256], np.zeros(256, np.int32),
                             [1], used=state[3], ntasks=state[4],
                             max_tasks=maxt)
        w["idle"], w["future_idle"] = state[1], state[2]
        return w
    return before, chunk


def _trace_child(out_path: str, traces) -> None:
    import jax

    from volcano_tpu.ops.scores import combined_dynamic_score, default_weights
    results = {}
    for seed, T, task in traces:
        before, chunk = trace_worlds(seed, T, task)
        w = chunk(tp.jax_blocks(before) if len(before["req"]) else
                  (None, before["idle"], before["future_idle"],
                   before["used"], before["ntasks"]))
        score = jax.jit(lambda r, u, a: combined_dynamic_score(
            r, u, a, default_weights(2)))(w["req"], w["used"],
                                          w["allocatable"])
        results[(seed, T, task)] = (w, tp.jax_blocks(w)[0][task % 256],
                                    np.asarray(score)[task % 256])
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


def _child(out_path: str, sizes, seeds) -> None:
    import jax
    import jax.numpy as jnp

    @jax.jit
    def frees(hot, req):
        return jnp.einsum("tn,tr->nr", hot, req)

    results = {}
    for T in sizes:
        for seed in seeds:
            req, node = einsum_inputs(seed, T)
            hot = (np.eye(NODES, dtype=np.float32)[np.maximum(node, 0)]
                   * (node >= 0)[:, None])
            results[(T, seed)] = (tp.jax_blocks(frees_world(seed, T)),
                                  np.asarray(frees(hot, req)))
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


def ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in units in the last place between two arrays of
    finite f32 values (-0.0 and +0.0 one apart)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF) - 1, i)
    ia, ib = ordered(a), ordered(b)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--trace", help=argparse.SUPPRESS)
    ap.add_argument("sizes", nargs="*", type=int,
                    default=[1024, 1280, 1536, 4096, 20000])
    args = ap.parse_args()
    seeds = list(range(args.seeds))
    if args.child:
        if args.trace:
            _trace_child(args.child, json.loads(args.trace))
        else:
            _child(args.child, args.sizes, seeds)
        return 0
    import torch

    from volcano_tpu_torch.ops import blocks as B
    with tempfile.TemporaryDirectory() as tmp:
        ref = tp.jax_reference_script(
            [os.path.abspath(__file__), "--seeds", str(args.seeds),
             *map(str, args.sizes), "--child"], os.path.join(tmp, "gap.pkl"))
    traces = []
    for (T, seed), (want, want_frees) in sorted(ref.items()):
        bargs, kw = tp.blocks_args(frees_world(seed, T), "cpu")
        got = B.blocks_plain(*bargs, **kw)
        req, node = einsum_inputs(seed, T)
        frees = B._block_node_sums(torch.tensor(node), torch.tensor(req),
                                   NODES, None).numpy()
        differ = np.flatnonzero(got[0].numpy()[:T] != want[0][:T])
        print(json.dumps({
            "T": T, "seed": seed,
            "solve_packed_equal": bool(np.array_equal(got[0].numpy(),
                                                      want[0])),
            "solve_tasks_differing": int(differ.size),
            "solve_first_task": int(differ[0]) if differ.size else None,
            "solve_state_ulps": max(ulps(g.numpy(), w)
                                    for g, w in zip(got[1:4], want[1:4])),
            "einsum_ulps": ulps(frees, want_frees)}), flush=True)
        if differ.size:
            traces.append((seed, T, int(differ[0])))
    if traces:
        trace(traces)
    return 0


def trace(traces) -> None:
    """The third witness (module docstring) for each (seed, T, task)."""
    import torch

    from volcano_tpu_torch.ops import blocks as B
    from volcano_tpu_torch.ops.scores import (combined_dynamic_score,
                                              default_weights)
    with tempfile.TemporaryDirectory() as tmp:
        ref = tp.jax_reference_script(
            [os.path.abspath(__file__), "--trace", json.dumps(traces),
             "--child"], os.path.join(tmp, "trace.pkl"))
    for (seed, T, task), (w, ref_node, jax_score) in sorted(ref.items()):
        bargs, kw = tp.blocks_args(w, "cpu")
        port_node = int(B.blocks_plain(*bargs, **kw)[0][task % 256])
        port_score = combined_dynamic_score(
            torch.tensor(w["req"][task % 256:task % 256 + 1]),
            torch.tensor(w["used"]), torch.tensor(w["allocatable"]),
            default_weights(2))[0].numpy()
        op_score = np.array([op_by_op_score(w["req"][task % 256], w["used"][n],
                                            w["allocatable"][n])
                             for n in range(NODES)], np.float32)
        print(json.dumps({
            "trace": {"seed": seed, "T": T, "task": task},
            "compiled_picks": int(ref_node), "port_picks": port_node,
            "score_op_by_op": op_score.tolist(),
            "score_jax_alone": np.asarray(jax_score).tolist(),
            "score_port": port_score.tolist()}), flush=True)


def op_by_op_score(req, used, alloc) -> float:
    """volcano_tpu/ops/scores.py's combined_dynamic_score at the default
    weights (binpack 1 on cpu and memory, least 1, most 0, balanced 1) for
    one task and one node with two resource columns, one f32 operation at
    a time in NumPy."""
    f = np.float32
    uf = (used + req).astype(f)
    binpack = f(f(f(f(f(uf[0] * f(1)) / alloc[0])
                    + f(f(uf[1] * f(1)) / alloc[1])) / f(2)) * f(100))
    least = [min(max(f(f(f(alloc[r] - used[r]) - req[r]) / alloc[r]), f(0)),
                 f(1)) for r in range(2)]
    least = f(f(f(least[0] + least[1]) / f(2)) * f(100))
    frac = [min(max(f(uf[r] / alloc[r]), f(0)), f(1)) for r in range(2)]
    mean = f(f(frac[0] + frac[1]) / f(2))
    var = f(f(f(f(frac[0] - mean) * f(frac[0] - mean))
              + f(f(frac[1] - mean) * f(frac[1] - mean))) / f(2))
    balanced = f(f(f(1) - f(np.sqrt(var))) * f(100))
    most = f(0)
    return float(f(f(f(binpack + least) + most) + balanced))


if __name__ == "__main__":
    sys.exit(main())
