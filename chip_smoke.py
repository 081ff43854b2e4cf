#!/usr/bin/env python3
"""Drive volcano_tpu_torch on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA
                                 # card, nvcc and nvidia-smi

1. Prints the card's name and power limit, and builds the CUDA kernels
   (volcano_tpu_torch/ops/csrc, one nvcc per source, all at once).
2. Holds each kernel against its plain PyTorch version on the card, on
   seeded worlds and on the 10k-pod / 2k-node cycle's own tensors, at the
   default launch plan and at every cluster size the card launches: outputs
   and final node state must be equal (tolerance 0: both round every f32
   operation alike). Prints the kernel's time (CUDA events, warm, median),
   the plain version's, the largest state difference, the (task, node)
   scorings the inputs require and the bound they give; on slice-10k,
   slice-10k-taints, r3-n8192 (a new request every task) and two gang
   worlds of 8,192 and 16,384 nodes (one request a gang) also the time at
   each cluster size. One world (R=8, 40,000 nodes) is larger than a
   16-CTA cluster's shared memory, so the kernel keeps its planes in device
   memory. The static-row pre-pass (rowdiff) is held against its plain
   version on the worlds with a static matrix.
3. Runs the scheduling cycle ``Scheduler(cache, SLICE_CONF).run_once()`` on
   the BASELINE 10k world (10,000 pending pods in 200 gangs, 2,000 nodes of
   32 CPU / 128 GiB / 110 pods, 3 queues) on the card, with each kernel's
   launch count set to 0 just before and read just after: the placement
   kernel must have launched, all 10,000 pods must bind, and the bind map
   must equal the same world's on the CPU. Then again with a
   PreferNoSchedule taint on 10% of the nodes, which puts nodeorder's
   [10,000 x 2,000] static score matrix on the card: there the rowdiff
   pre-pass must have launched too (and without taints, not at all).
   torch.profiler then traces one more cycle of each.
4. Prints one JSON line with each kernel's launches, times, bound and
   error, then the card's name and power limit, then the result line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero without the result
line; so it does without a CUDA device, and outside the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SLICE_CONF = """
actions: "enqueue, allocate-tpu, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: nodeorder
  - name: binpack
configurations:
- name: allocate-tpu
  arguments:
    engine: tpu-fused
"""

# one H100 SXM (NVIDIA's data sheet): HBM bytes/s and FP32 (non-tensor)
# operations/s; the bound of a kernel is the larger of its bytes and its
# operations over these
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# the placement kernel against its plain version
# ---------------------------------------------------------------------------

def random_world(seed, T, N, J, R, tight, static=True):
    """Seeded node state, requests, gangs and (optionally) a masked static
    score matrix; tight worlds oversubscribe, so gangs roll back and tasks
    pipeline onto releasing capacity."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    cap = rng.choice([2000.0, 4000.0, 8000.0], size=(N, R)).astype(f32)
    used = (cap * rng.uniform(0, 0.8 if tight else 0.5, (N, R))).astype(f32)
    releasing = (cap * rng.uniform(0, 0.1, (N, R))).astype(f32)
    req = rng.choice([250.0, 500.0, 1000.0, 2000.0], (T, R)).astype(f32)
    job_ix = np.sort(rng.randint(0, J, T)).astype(np.int32)
    ms = None
    if static:
        feas = rng.rand(T, N) > (0.5 if tight else 0.2)
        ms = np.where(feas, rng.randint(0, 50, (T, N)), -1e30).astype(f32)
    return dict(idle=cap - used, future_idle=cap - used + releasing,
                used=used, ntasks=rng.randint(0, 3, N).astype(np.int32),
                allocatable=cap,
                max_tasks=rng.randint(2, 60, N).astype(np.int32),
                req=req, job_ix=job_ix, masked_static=ms,
                min_available=rng.randint(1, 6, J).astype(np.int32))


def identical_world(T, N, J):
    """Identical empty nodes and identical tasks: every pick is a tie."""
    cap = np.tile(np.array([[32000.0, 128 * 2.0 ** 30]], np.float32), (N, 1))
    z = np.zeros((N, 2), np.float32)
    return dict(idle=cap.copy(), future_idle=cap.copy(), used=z,
                ntasks=np.zeros(N, np.int32), allocatable=cap,
                max_tasks=np.full(N, 110, np.int32),
                req=np.tile(np.array([[1000.0, 2.0 ** 30]], np.float32),
                            (T, 1)),
                job_ix=np.repeat(np.arange(J), T // J).astype(np.int32),
                masked_static=None,
                min_available=np.full(J, T // J, np.int32))


def runs_world(seed, N, gang_sizes, R=2, static=True):
    """Gangs that share one request and (optionally) one static row each,
    the requests differing across gangs."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    J = len(gang_sizes)
    cap = rng.choice([32000.0, 64000.0], size=(N, R)).astype(f32)
    used = (cap * rng.uniform(0, 0.3, (N, R))).astype(f32)
    job_ix = np.repeat(np.arange(J), gang_sizes).astype(np.int32)
    gang_req = rng.choice([250.0, 500.0, 1000.0, 2000.0], (J, R)).astype(f32)
    gang_ms = np.where(rng.rand(J, N) > 0.2, rng.randint(0, 50, (J, N)),
                       -1e30).astype(f32)
    return dict(idle=cap - used, future_idle=cap - used, used=used,
                ntasks=np.zeros(N, np.int32), allocatable=cap,
                max_tasks=np.full(N, 110, np.int32), req=gang_req[job_ix],
                job_ix=job_ix,
                masked_static=gang_ms[job_ix] if static else None,
                min_available=np.asarray(gang_sizes, np.int32))


def static_one_node_world(seed, T, N, J):
    """One request; each task's static row differs from the one before on a
    single node."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    cap = np.full((N, 2), 64000.0, f32)
    used = (cap * rng.uniform(0, 0.4, (N, 2))).astype(f32)
    row = rng.randint(0, 50, N).astype(f32)
    ms = np.repeat(row[None], T, axis=0)
    at = rng.randint(0, N, T)
    val = np.where(rng.rand(T) < 0.3, -1e30, rng.randint(0, 50, T))
    for t in range(T):          # each change persists into the later rows
        ms[t:, at[t]] = val[t]
    return dict(idle=cap - used, future_idle=cap - used, used=used,
                ntasks=np.zeros(N, np.int32), allocatable=cap,
                max_tasks=np.full(N, 110, np.int32),
                req=np.full((T, 2), 1000.0, f32),
                job_ix=np.repeat(np.arange(J), T // J).astype(np.int32),
                masked_static=ms.astype(f32),
                min_available=np.full(J, T // J // 2, np.int32))


def rollback_then_same_world(N):
    """Gangs too large for what is left roll back, and the next gang asks
    the same request, so every node a rolled-back gang touched is stale."""
    f32 = np.float32
    cap = np.full((N, 2), 4000.0, f32)
    used = np.zeros((N, 2), f32)
    used[::3] = 1000.0
    sizes = [2 * N, N, 3 * N, N // 2, N // 4, 2 * N]
    job_ix = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    T = len(job_ix)
    ms = (((np.arange(T)[:, None] // 40) * 5 + np.arange(N)[None, :] * 2)
          % 7).astype(f32)
    return dict(idle=cap - used, future_idle=cap - used, used=used,
                ntasks=np.zeros(N, np.int32), allocatable=cap,
                max_tasks=np.full(N, 30, np.int32),
                req=np.full((T, 2), 1000.0, f32), job_ix=job_ix,
                masked_static=ms, min_available=np.asarray(sizes, np.int32))


def wide_ties_world(slice_, T):
    """Identical nodes at N = 3 * slice_ + 5, three tasks to a node: picks
    walk up the node axis through ties, across CTA slices."""
    w = identical_world(T, 3 * slice_ + 5, T // 20)
    w["max_tasks"] = np.full(3 * slice_ + 5, 3, np.int32)
    return w


def kernel_args(world, device):
    """place_cuda/place_plain arguments on ``device`` for a world."""
    import torch

    from volcano_tpu_torch.ops.place import task_flags
    from volcano_tpu_torch.ops.scores import default_weights
    J = len(world["min_available"])
    zeros = np.zeros(J, np.int32)
    flags, ready_need, keep_need = task_flags(
        world["job_ix"], world["min_available"], zeros, zeros)

    def t(a):
        return None if a is None else torch.tensor(a, device=device)

    return (t(world["idle"]), t(world["future_idle"]), t(world["used"]),
            t(world["ntasks"]), t(world["allocatable"]),
            t(world["max_tasks"]), t(world["req"]), t(flags), t(ready_need),
            t(keep_need), t(world["masked_static"]),
            default_weights(world["req"].shape[1]))


def slice_args(cache):
    """The placement kernel's arguments exactly as the 10k cycle's first
    solve builds them, on the card."""
    import torch

    from volcano_tpu_torch.actions import allocate
    from volcano_tpu_torch.framework import (get_action, open_session,
                                             parse_scheduler_conf)
    from volcano_tpu_torch.ops.place import task_flags
    conf = parse_scheduler_conf(SLICE_CONF)
    ssn = open_session(cache, conf.tiers, conf.configurations)
    get_action("enqueue").execute(ssn)
    inp = allocate.placement_inputs(ssn, allocate._fixed_job_order(ssn))
    nt = inp.node_t
    dev = ssn.device
    flags, ready_need, keep_need = (torch.tensor(a, device=dev) for a in
                                    task_flags(inp.job_ix, inp.min_available,
                                               inp.base_ready,
                                               inp.base_pipelined))
    return (nt.idle, nt.future_idle, nt.used, nt.ntasks, nt.allocatable,
            nt.max_tasks, inp.req, flags, ready_need, keep_need,
            inp.masked_static, inp.weights)


def time_cuda_ms(fn, reps=5) -> float:
    """Median of ``reps`` warm runs, CUDA events around each."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_host_ms(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def larger(t_bytes, t_ops):
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def place_bound(args, counts):
    """Least time the card could take for one solve, from what these inputs
    need: each input byte read once and each output byte written once over
    HBM bandwidth, against the operations over the FP32 rate. ``counts``
    holds the nodes the cache rule re-scores for each evaluated task
    (ops/place.py::task_rescores). Per re-scored (task, node) pair the fit
    tests and binpack terms cost about ten operations a resource column,
    least/most/balanced allocation, the square root and the weighted sum
    about 41 more (place.cu); per task the argmax over the cached keys
    re-reduces the 32-node group of each re-scored node and reduces the
    N/32 group maxima, two operations a 64-bit compare. Returns (bound_ms,
    "bytes" or "operations", all_pairs_ms): the last is PR 1's operation
    count, every node scored for every evaluated task, kept so that the two
    kernels' bounds compare."""
    idle, _, _, _, _, _, req, _, _, _, ms, _ = args
    N, R = idle.shape
    T = req.shape[0]
    state_bytes = 3 * N * R * 4 + N * 4
    in_bytes = (T * R * 4 + 3 * T * 4 + N * R * 4 + N * 4 + state_bytes
                + R * 4 + (T * N * 4 if ms is not None else 0))
    out_bytes = T * 4 + state_bytes
    groups = -(-int(N) // 32)
    per_pair = 10 * R + 41
    compares = int((32 * np.minimum(counts, groups) + groups).sum())
    ops = int(counts.sum()) * per_pair + 2 * compares
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    all_pairs = len(counts) * N * per_pair / FP32_OPS_PER_S * 1e3
    return (*larger(t_bytes, ops / FP32_OPS_PER_S * 1e3),
            max(t_bytes, all_pairs))


def same_result(label, got, want) -> float:
    """Raise unless the packed words and the final state are equal; returns
    the largest state difference (0)."""
    import torch
    if not torch.equal(got[0], want[0]):
        first = (got[0] != want[0]).nonzero().flatten()[:1].tolist()
        raise RuntimeError(f"{label}: kernel and plain decisions differ, "
                           f"first at task {first}")
    err = 0.0
    for name, g, w in zip(("idle", "future_idle", "used", "ntasks"),
                          got[1:], want[1:]):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{label}: {name} shape/dtype differ")
        err = max(err, float((g.double() - w.double()).abs().max())
                  if g.numel() else 0.0)
    check(err == 0.0, f"{label}: final node state differs by {err}")
    return err


def compare_place(label, args, sweep=False):
    """place_cuda against place_plain on the same CUDA tensors, at the
    default plan and at every cluster size the card launches; returns a
    record of the comparison and the times (with ``sweep``, also the time
    at each cluster size)."""
    import torch

    from volcano_tpu_torch.ops.place import (CLUSTER_SIZES, launch_plan,
                                             max_cluster, place_cuda,
                                             place_plain, task_rescores)
    got = place_cuda(*args)
    torch.cuda.synchronize()
    plain = {}
    plain_ms = time_host_ms(lambda: plain.setdefault("out",
                                                     place_plain(*args)))
    want = plain["out"]
    err = same_result(label, got, want)
    sizes = [c for c in CLUSTER_SIZES if c <= max_cluster()]
    for c in sizes:
        err = max(err, same_result(f"{label} cluster {c}",
                                   place_cuda(*args, cluster=c), want))
    torch.cuda.synchronize()
    words = got[0].cpu().numpy()
    flags = args[7].cpu().numpy()
    last = (flags & 4) != 0
    N, R = args[0].shape
    ms = args[10]
    plan = launch_plan(N, R, ms is not None, max_cluster())
    counts = task_rescores(words, flags, args[6].cpu().numpy(),
                           None if ms is None else ms.cpu().numpy(), int(N))
    rec = {
        "world": label, "T": int(args[6].shape[0]), "N": int(N), "R": int(R),
        "static": ms is not None,
        "placed": int(((words & 1) != 0).sum()),
        "pipelined": int(((words & 2) != 0).sum()),
        "jobs": int(last.sum()),
        "rolled_back": int(((words[last] & 8) == 0).sum()),
        "max_abs_err": err,
        "cluster": plan.cluster, "threads": plan.threads,
        "in_smem": plan.in_smem,
        "scored_pairs": int(counts.sum()),
        "ms": time_cuda_ms(lambda: place_cuda(*args)),
        "plain_ms": plain_ms,
    }
    (rec["bound_ms"], rec["bound_by"],
     rec["bound_all_pairs_ms"]) = place_bound(args, counts)
    if sweep:
        rec["ms_by_cluster"] = {
            c: time_cuda_ms(lambda c=c: place_cuda(*args, cluster=c))
            for c in sizes}
    print("kernel place", json.dumps(rec), flush=True)
    return rec


def compare_rowdiff(label, ms):
    """rowdiff_cuda against rowdiff_plain on the same static matrix; returns
    a record of the comparison, the times and the bound (the matrix read
    once, the marks written once)."""
    import torch

    from volcano_tpu_torch.ops.place import rowdiff_cuda, rowdiff_plain
    got = rowdiff_cuda(ms)
    plain = {}
    plain_ms = time_host_ms(lambda: plain.setdefault("out",
                                                     rowdiff_plain(ms)))
    check(torch.equal(got, plain["out"]),
          f"{label}: rowdiff kernel and plain marks differ")
    T, N = ms.shape
    rec = {"world": label, "T": int(T), "N": int(N),
           "rows_new": int(got.sum()), "max_abs_err": 0.0,
           "ms": time_cuda_ms(lambda: rowdiff_cuda(ms)),
           "plain_ms": plain_ms}
    rec["bound_ms"], rec["bound_by"] = larger(
        (T * N * 4 + T * 4) / HBM_BYTES_PER_S * 1e3,
        T * N / FP32_OPS_PER_S * 1e3)
    print("kernel rowdiff", json.dumps(rec), flush=True)
    return rec


# ---------------------------------------------------------------------------
# the cycle
# ---------------------------------------------------------------------------

def taint_tenth(cache):
    taint = {"key": "dedicated", "value": "batch",
             "effect": "PreferNoSchedule"}
    for i, node in enumerate(cache.nodes.values()):
        if i % 10 == 3:
            node.taints = [taint]


def run_cycle(device, taints, count=False):
    """One cycle of the slice conf on a fresh 10k world; returns (binds,
    phase times in ms, launches of each kernel during the cycle)."""
    from volcano_tpu_torch import Scheduler
    from volcano_tpu_torch.cache.synthetic import baseline_config
    from volcano_tpu_torch.ops.place import place_cuda, rowdiff_cuda
    cache, binder, _ = baseline_config("10k")
    if taints:
        taint_tenth(cache)
    sched = Scheduler(cache, SLICE_CONF, device=device)
    place_cuda.launches = rowdiff_cuda.launches = 0
    sched.run_once()
    launches = {"place": place_cuda.launches,
                "rowdiff": rowdiff_cuda.launches}
    times = {k: v * 1e3 for k, v in sched.last_cycle_s.items()}
    allocate = next(a for a in sched.actions if a.name() == "allocate-tpu")
    times["allocate_phases"] = {
        k: v * 1e3 if k != "solves" else v
        for k, v in allocate.last_stats.items()}
    return dict(binder.binds), times, launches


def profile_cycle(taints: bool, cycle_ms: float) -> dict:
    """One more 10k cycle on the card under torch.profiler: the device time
    by kernel name, and the device's idle share of an unprofiled cycle of
    ``cycle_ms``. Only device events (kernels, copies) are summed: a CPU op
    also carries the device time of what it launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from volcano_tpu_torch import Scheduler
    from volcano_tpu_torch.cache.synthetic import baseline_config
    cache = baseline_config("10k")[0]
    if taints:
        taint_tenth(cache)
    sched = Scheduler(cache, SLICE_CONF)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sched.run_once()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "device_busy_ms": busy_ms,
        "device_idle_share": (1.0 - busy_ms / cycle_ms) if busy_ms else None,
        "by_kernel_ms": {e.key[:60]: e.self_device_time_total / 1e3
                         for e in top},
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from volcano_tpu_torch.ops import build
    except ImportError:
        print("chip_smoke: run from the root of the repository (no "
              "volcano_tpu_torch package here)", file=sys.stderr)
        return 2

    # 1. the card and the build
    card = card_line()
    print("card:", card, flush=True)
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {len(logs)} kernel(s) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  nvcc {name}: {line.strip()}")

    # 2. each kernel against its plain version
    from volcano_tpu_torch.cache.synthetic import baseline_config
    from volcano_tpu_torch.framework import resolve_device
    dev = resolve_device(None)          # the card
    records = []
    for seed in range(3):
        records.append(compare_place(
            f"random-{seed}", kernel_args(random_world(
                seed, T=400, N=300, J=40, R=3, tight=False), dev)))
        records.append(compare_place(
            f"tight-{seed}", kernel_args(random_world(
                100 + seed, T=600, N=64, J=60, R=2, tight=True), dev)))
    records.append(compare_place(
        "identical-nodes", kernel_args(identical_world(4000, 2048, 40), dev)))
    records.append(compare_place(
        "r3-n8192", kernel_args(random_world(
            7, T=4000, N=8192, J=100, R=3, tight=False, static=False), dev),
        sweep=True))
    for seed, N in ((11, 8192), (12, 16384)):
        # one request a gang, as in the 10k world, past one CTA's nodes
        records.append(compare_place(
            f"gangs-n{N}", kernel_args(runs_world(
                seed, N, np.random.RandomState(seed).randint(20, 51, 100),
                static=False), dev), sweep=True))
    gangs = np.random.RandomState(8).randint(20, 51, 80)
    runs_args = kernel_args(runs_world(8, 2000, gangs), dev)
    records.append(compare_place("runs", runs_args))
    one_node_args = kernel_args(static_one_node_world(
        9, T=1000, N=2000, J=20), dev)
    records.append(compare_place("static-one-node", one_node_args))
    records.append(compare_place(
        "rollback-then-same", kernel_args(rollback_then_same_world(64), dev)))
    records.append(compare_place(
        "wide-ties", kernel_args(wide_ties_world(512, 3000), dev)))
    records.append(compare_place(
        "device-memory-r8-n40000", kernel_args(random_world(
            10, T=500, N=40000, J=50, R=8, tight=False, static=False), dev)))
    check(not records[-1]["in_smem"],
          "the R=8, 40,000-node world did not take the device-memory path")
    slice_rec = compare_place("slice-10k", slice_args(
        baseline_config("10k")[0]), sweep=True)
    records.append(slice_rec)
    tainted = baseline_config("10k")[0]
    taint_tenth(tainted)
    tainted_args = slice_args(tainted)
    records.append(compare_place("slice-10k-taints", tainted_args,
                                 sweep=True))
    compare_rowdiff("runs", runs_args[10])
    compare_rowdiff("static-one-node", one_node_args[10])
    rowdiff_rec = compare_rowdiff("slice-10k-taints", tainted_args[10])

    # 3. the cycle on the card (twice without taints: the second run shows
    # the time without first-use costs), and on the CPU
    results = {}
    for label, taints in (("10k", False), ("10k-taints", True)):
        cpu_binds, cpu_times, _ = run_cycle("cpu", taints)
        for run in ("first", "second") if not taints else ("first",):
            binds, times, launches = run_cycle(None, taints)
            check(launches["place"] > 0,
                  f"{label}: the cycle launched no placement kernel")
            # the pre-pass runs exactly when a plugin gives a static matrix
            check((launches["rowdiff"] > 0) == taints,
                  f"{label}: rowdiff launched {launches['rowdiff']} times")
            check(len(binds) == 10000,
                  f"{label}: {len(binds)} of 10000 pods bound")
            check(binds == cpu_binds,
                  f"{label}: bind map differs from the CPU cycle's")
            results[f"{label}-{run}"] = {"launches": launches, "ms": times}
            print(f"cycle {label} {run}:", json.dumps(
                {"binds": len(binds), "launches": launches,
                 "allocate_ms": times["allocate-tpu"],
                 "cycle_ms": times["cycle"], "phases_ms": times}),
                flush=True)
        print(f"cycle {label} cpu:", json.dumps(
            {"binds": len(cpu_binds), "allocate_ms": cpu_times["allocate-tpu"],
             "cycle_ms": cpu_times["cycle"]}), flush=True)
    for label, taints, run in (("10k", False, "10k-second"),
                               ("10k-taints", True, "10k-taints-first")):
        print(f"profile {label}:", json.dumps(profile_cycle(
            taints, results[run]["ms"]["cycle"])), flush=True)

    # 4. the kernels line (launches: the placement kernel's in the 10k
    # cycle, the pre-pass's in the 10k cycle with taints, the one that gives
    # it a static matrix), the card, the result
    main_run = results["10k-first"]
    kernels = [{
        "name": "place",
        "route": "cuda",
        "source": "volcano_tpu_torch/ops/csrc/place.cu",
        "replaces": "volcano_tpu/ops/pallas_place.py:58",
        "launches": main_run["launches"]["place"],
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "ms": slice_rec["ms"],
        "plain_ms": slice_rec["plain_ms"],
        "bound_ms": slice_rec["bound_ms"],
        "bound_by": slice_rec["bound_by"],
        "library_ms": None,
        "cluster": slice_rec["cluster"],
        "scored_pairs": slice_rec["scored_pairs"],
    }, {
        "name": "rowdiff",
        "route": "cuda",
        "source": "volcano_tpu_torch/ops/csrc/place.cu",
        "replaces": "volcano_tpu/ops/pallas_place.py:58",
        "launches": results["10k-taints-first"]["launches"]["rowdiff"],
        "max_abs_err": rowdiff_rec["max_abs_err"],
        "ms": rowdiff_rec["ms"],
        "plain_ms": rowdiff_rec["plain_ms"],
        "bound_ms": rowdiff_rec["bound_ms"],
        "bound_by": rowdiff_rec["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
