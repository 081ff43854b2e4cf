#!/usr/bin/env python3
"""Drive volcano_tpu_torch on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA
                                 # card, nvcc and nvidia-smi

1. Prints the card's name and power limit, starts the CPU path's
   reference runs (the cycles, preempt, deployed and engine runs the card's
   are compared with) and the plain versions that run on the CPU (step 2's
   placement worlds, step 9's fractional-20k) in four spawned worker
   processes, which never touch the card, and builds the CUDA kernels
   (volcano_tpu_torch/ops/csrc, one nvcc per source, all at once); ptxas
   must report no stack frame and no spills for any instance of the block
   auction's round kernel (its lane sums stay in registers).
2. Holds the placement kernel against its plain PyTorch version, on
   seeded worlds and on the 10k-pod / 2k-node cycle's own tensors, at the
   default launch plan and at every cluster size the card launches: outputs
   and final node state must be equal (tolerance 0: both round every f32
   operation alike). The plain version ran on the CPU in step 1, on inputs
   whose SHA-256 must equal the card's. Prints the kernel's time (CUDA
   events, warm, median), the plain version's (host clock, in its worker),
   the largest state difference, the (task, node)
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
4. Holds the preempt victim walk (csrc/evict.cu) against its plain version
   on the card, to the bit (task nodes, slot owners, quota verdicts,
   evaluated tasks), on seeded worlds (gang rollback, the intra-job phase,
   drf tiers, two dynamic tiers, 64 slots, nothing fits, and five worlds
   built to break a wrong verdict cache), on three worlds too large for the
   plain walk on the CPU (2,500 nodes; W = 64 at 400 nodes, whose victim
   tables must leave shared memory; 8,192 nodes, whose node and group state
   must) and on the walk inputs of ``baseline_config("preempt")``'s phase 1
   and of its intra-job variant's phase 2. The nodes the kernel
   re-dispatched must equal those its cache rule needs, counted from the
   plain walk, and the bound counts those. Prints each walk's launch plan,
   dispatches and µs per evaluated task.
5. Runs ``PreemptAction(engine="tpu")`` alone with deploy/scheduler.conf's
   tiers on ``baseline_config("preempt")`` (5,000 running and 5,000
   pending pods on 1,000 nodes) on the card, counts set to 0 just before:
   the walk must launch, and the evictions and pipelined tasks must equal
   the port's CPU run.
6. Runs ``Scheduler(cache, deploy/scheduler.conf as written).run_once()``
   on the 10k world, on bench.py's pipeline world (10k pods / 2k nodes,
   half the gangs running) and on a tight running+pending mix (400 nodes,
   10,000 pods) on the card and on the CPU, counts set to 0 just before
   each card run: binds, evictions, pipelined tasks and PodGroup phases
   must be equal, the placement kernel must launch, and in the tight mix
   the walk too, whose own inputs are then held against the plain walk.
   Prints each action's ms and the counts.
7. Runs proportion's deserved water-filling at 64 queues in its torch form
   on the card (ops/fairness.py::proportion_deserved, B8), against its
   NumPy twin within 1e-5 relative, with its time and bound.
8. Runs deploy/scheduler.conf with its allocate engine line changed to
   tpu-blocks at baseline_config("20k") (20,000 pods / 5,000 nodes, budgets
   5/4), with and without taint_tenth (a [20,000 x 5,000] static matrix),
   on the card and on the CPU (binds, pipelined tasks, PodGroup phases and
   evictions equal; every B4 kernel launched, the placement kernel not),
   and at baseline_config("100k") (100,000 pods / 20,000 nodes) on the
   card alone, held to the invariants: no node over its capacity or pod
   count, every gang bound whole or not at all. Prints allocate and solve
   ms, and keeps each card cycle's first solve.
9. Holds the block auction's three kernels (csrc/blocks.cu, B4) against
   blocks_plain on the card, to the bit (packed row and final node state),
   on tests/torch_parity.py's blocks worlds, on its card worlds (20,000
   nodes with few request classes; a fractional world of 20,000 tasks and
   5,000 nodes, whose blocks_plain ran on the CPU in step 1 on inputs of
   the same SHA-256; 2^23 + 64 nodes) and on the solves step 8 kept; both
   of the round kernel's sum modes must have run. Each ``kernel blocks``
   line has the solve's
   time, each kernel's time and launches in one solve, the counts (the
   candidate lists computed, the chunks each sum mode took), µs a round and
   a candidate launch, each kernel's bound and one timed run of
   blocks_plain. torch.topk over the 20k solve's first chunk of masked
   scores is the candidate kernel's library yardstick (selection only).
10. Runs the same conf with engine tpu-strict at 10k on the card and on
   the CPU (equal decisions; one placement launch a solve), printing the
   batch sizes and whether its admissions equal tpu-fused's (step 6).
11. Runs the reference's default conf (enqueue, allocate, backfill) on
   baseline_config("1k", seed=3) with engine callbacks (host), tpu-strict
   and tpu-fused (card): callbacks binds as tpu-strict does and admits the
   gangs tpu-fused admits, with as many binds.
12. Runs the sim (``python -m volcano_tpu_torch.sim``, direct mode) on the
   card under deploy/scheduler.conf: baseline-10k (10,000 pods / 2,000
   nodes, 31 cycles), preempt-burst, skew, and smoke with 20% bind/evict
   chaos and kills at cycles 5 and 12, each kernel's count set to 0 just
   before each run. Each run's decision plane (the bytes ``--deterministic``
   prints) and its side-effect sequence (every bind's node and every
   eviction, in order) must hash to the JAX package's digests in
   tests/sim_reference_digests.json (tools/sim_reference.py), with no
   action failure and no double bind; the placement kernel must launch in
   every run and the walk in preempt-burst. Prints each run's cycles,
   binds, evictions, launches, pipeline_e2e_ms and per-action ms, and the
   card's name and power limit.
13. Runs the incremental snapshot and the persistent node tensors on the
   card, under deploy/scheduler.conf, each kernel's count set to 0 just
   before each run: baseline-10k (the slice's full width) with the switch
   on and again with VOLCANO_TPU_INCREMENTAL_SNAPSHOT=0, steady-10k
   (10,500 gangs on 300 nodes), and the traces of tools/sim_traces.py:
   ``churn`` (node-flap with two node deaths and two fresh nodes) and
   ``hole-10k`` (the 10k world with spare nodes, one dying empty and a
   fresh one taking its row). Each run's decision plane, side-effect
   sequence and solve-by-solve node-tensor path (persistent rows or a
   fresh build, full rebuild or scatter and its rows, each drift the
   shadow verifier repaired) must equal the JAX package's record in
   tests/sim_reference_digests.json, which the port's CPU run equals too;
   no action failure, no double bind, the placement kernel launched, no
   persistent read with the switch off, and at least one scatter in
   steady-10k and the hole world. Prints each run's schedule and session
   open (snapshot) ms p50/p99, the refreshes' scatter rows and ms, the
   drift counts, and baseline-10k's on and off side by side.
14. Holds B7, the speculative solve's device decode
   (``decode_packed_cuda``, csrc/place.cu), against its plain version to
   the bit: on the words of B1 solves of step 2's worlds and of the 10k
   cycle's solve (timed: CUDA events, warm, median; its bound is the
   bytes once over HBM bandwidth), and on seeded wires with jobs of no
   boundary row, jobs of several and rows of zero flags. Then
   ``dispatch_speculative_solve`` on the baseline-10k world's speculative
   session under ``torch.cuda.set_sync_debug_mode("error")`` must raise
   nothing, and its fetched solution must equal the serial solve's.
15. Runs the sim under ``--pipelined`` on the card (runner.
   PIPELINED_SIM_CONF), each kernel's count set to 0 before each run:
   pipelined-steady (seed 3, with --verify-pipelined-equivalence),
   pipelined-conflict with --fast-admit, pipelined-conflict with kills at
   cycles 3, 8 and 14 (kill seed 5: two land between a speculative
   dispatch and its commit) and tools/sim_traces.py's ``backlog-16k``
   (2,000 gangs, ~16,000 pods on 300 nodes, a standing backlog). Each
   run's decision plane (with its speculation verdicts), side-effect
   sequence and node-tensor path record must equal the JAX package's in
   tests/sim_reference_digests.json, with no action failure and no double
   bind; B7 must launch once for each dispatched speculation and B1 at
   least as often. backlog-16k runs again with the serial shell in the
   same call (the same terminal accounting); prints both sides'
   schedule_ms and pipeline_e2e_ms p50/p99, and for each fetched
   speculation whether its event had completed at the fetch (a count),
   the dispatch's host ms and the fetch's wait ms.
16. Holds B6, the placement kernel's zone-anchor mode
   (``place_topo_cuda``), against ``place_topo_plain`` to the bit at every
   cluster size, on tests/torch_parity.py's zone-anchor worlds at their
   weights and a 6,005-node wide-ties world in 13 interleaved zones (a
   cluster of CTAs at the default plan); then
   runs the sim with elastic gangs on the card (tools/sim_reference.py's
   elastic runs: ``elastic-churn`` under the JAX sim's elastic conf and
   under deploy/scheduler.conf with elastic gangs, at topology weights 10
   and 0, at 10 also with the incremental snapshot off, and
   tools/sim_traces.py's full-width ``elastic-10k``, 10,000 elastic pods on
   2,000 nodes in 125 zones, under the latter at weight 10), each kernel's
   count set to 0 before each run. Each run's decision plane, side-effect
   sequence and node-tensor path record must equal the JAX package's in
   tests/sim_reference_digests.json, with no action failure, no double
   bind and no below-min eviction; B6 must launch once for each allocate
   solve of a weight-10 deployed run and never elsewhere, and each of its
   solves is held against the plain version on its own inputs.
   elastic-10k's first solve is timed beside B1 on the same inputs.
17. Runs the flight recorder on the card (``--deterministic --lifecycle
   --trace-out``): baseline-10k and preempt-burst under
   deploy/scheduler.conf and elastic-churn under the deployed elastic conf
   at weight 10, each kernel's count set to 0 before each run, the
   decision-audit ring holding every cycle. Each run's report (with its
   latency and slo sections), sequence and node-tensor paths, and the
   digests of its trace (each ``solve`` span's ``kernel`` attribute, the
   solve's route, replaced by one placeholder), audit records and job
   timelines must equal the JAX package's in
   tests/sim_reference_digests.json; the trace must pass
   ``validate_chrome_trace``; without the latency and slo sections the
   plane and sequence must be those of the run without the flags, and
   every kernel must launch as often as in that run (steps 12 and 16).
   Then baseline-10k runs without the flags with the audit and timelines
   recording (the default) and with both off, alternated twice: prints
   each run's pipeline_e2e_ms p50 and p99, the phase's seconds and the
   card's name and power limit.
18. Device containment on the card, on ``baseline_config("1k")`` under
   deploy/scheduler.conf, the cool-down on an injected clock, with 40 late
   pods in 10 gangs arriving after each cycle: cycle 1's allocate hook
   asks the caching allocator for more than the card holds, a real
   ``torch.cuda.OutOfMemoryError`` that must classify as "oom", open the
   cool-down and finish the cycle on the sequential placer (B1 not
   launched); cycle 2 is degraded (the hook not called, B1 not launched);
   cycle 3, past the window, probes: the hook is called, B1 launches and
   ``record_ok`` closes the window. Each cycle's binds must equal the CPU
   path's under the same script (an injected "oom" there), and
   ``LAST_FALLBACK``, ``last_stats["fallback"]``, the counters and
   ``health_detail()["device"]`` must show each step. Then a
   ``solve_deadline_s`` of 1e-9 s must open the window after a cycle that
   launched B1, and a launch the placement kernel's C entry fails
   (cudaError_t 719, injected at the entry) must fail the allocate action
   with every fallback counter unchanged. Last, a child process runs one
   cycle whose solve launches B1 and then gathers past its tensor on the
   card: the card raises a real device-side assert at the sync, which
   must fail the allocate action, count one ``device_faults{device_lost}``
   and open the cool-down, with no solver fallback and no bind.
19. The object store and the feedback watch path on the card
   (tools/sim_reference.py's STORE_RUNS): smoke under deploy/scheduler.conf
   with ``--store-wired``, ``--store-chaos``, ``--ack-chaos`` and
   ``--store-wired --ack-chaos``, preempt-burst with ``--store-chaos``,
   pipelined-conflict with ``--pipelined --ack-chaos`` and the full-width
   baseline-10k with ``--store-wired`` (10,000 pods on 2,000 nodes, every
   pod, podgroup and queue a store object, the cache fed by informers),
   each kernel's count set to 0 before each run. Each run's report (with
   its store and feedback sections) and side-effect sequence must equal
   the JAX package's in tests/sim_reference_digests.json, with no action
   failure and no double bind; B1 must launch in every run, B3 in
   preempt-burst and B7 in pipelined-conflict. Prints each run's B1, B3
   and B7 launches and baseline-10k's pipeline_e2e_ms store-wired beside
   step 12's direct run.
20. The HA control plane on the card (tools/sim_reference.py's HA_RUNS:
   three replicas over one cluster, seeded leader kills and lease
   losses), each run held to the JAX package's report, sequence and
   solve-by-solve node-tensor path, B1 once a solve, B3 as the CPU path
   counts, failover within three cycles, and a crash restart freeing the
   killed replica's device tensors.
21. The overload plane on the card (OVERLOAD_RUNS: overload-burst under
   the ``--overload-chaos`` preset with four seeded kills, again under
   deploy/scheduler.conf, and with ``--lifecycle``), then
22. the federated control plane (FEDERATED_RUNS: four partitions with
   partition kills, the non-contended fed-smoke, the reserve-driving
   fed-starve on the sim's conf and under deploy/scheduler.conf, the
   rebalancer's fed-hotspot, the merged trace of two partitions, the
   federated overload soak, the store-backed federation under store chaos
   and the full-width baseline-10k over four partitions with a kill inside
   a partition's bind funnel). Each run's report, sequence and
   node-tensor path (each partition's too) must equal the JAX package's,
   where its refresh of a node changed and then removed fired with that
   refresh mended (the port's refresh); the merged trace's recorder
   digests must too, and its flow arcs validate. B1 launches once a solve
   (each partition's counted around its run_once), B3 as the CPU path
   counts; no double bind, no action failure, every admitted gang
   completed, the cycle spend within twice the budget, the priority-aware
   shed fired on overload-burst, the rebalancer's moves converged on
   fed-hotspot, a crash restart frees the killed shell's device tensors
   and no card memory outlives a run. Prints each run's wall seconds,
   pipeline_e2e_ms, reserves, transfers and queue moves and B1 by
   partition, and baseline-10k's pipeline_e2e_ms over four partitions
   beside step 12's direct run.
23. Elastic partition membership (ELASTIC_RUNS: diurnal-flash-crowd from
   one partition under the overload preset, CI's elastic soak with store
   chaos and kills at split and merge boundaries, the contract run, the
   same world under deploy/scheduler.conf and the kill run), held as step
   22 holds its runs, each partition's B1 launches counted (the newborns'
   too); at least one split and one merge, the membership back at one
   partition, and each merged partition's node rows freed by the end of
   the cycle that retired it.
24. The in-process system (tools/system_reference.py's worlds through
   ``VolcanoSystem`` on the card: system-10k, the BASELINE 10k world's
   200 gangs submitted as Jobs through the batched front door under
   deploy/scheduler.conf; system-preempt; system-lifecycle): Jobs,
   PodGroups, Pods, store events, the bind and evict sequence and the
   node-tensor path equal to the JAX package's digests, B1 once a solve
   (every gang of system-10k bound), B3 once a walk (system-preempt's
   evictions). Prints each world's wall seconds and system-10k's cycle ms
   p50/p99.
25. The snapshot RPC sidecar on the card (tools/rpc_reference.py's
   worlds, each sent over TCP by ``SnapshotClient`` to ``rpc.serve``'s
   sidecar: rpc-10k, the BASELINE 10k world under deploy/scheduler.conf;
   rpc-10k-blocks, the same snapshot under tpu-blocks; rpc-preempt, the
   tight running+pending mix under deploy/scheduler.conf): each reply's
   decisions digest equal to the JAX package's in
   tests/rpc_reference_digests.json, rpc-10k binding all 10,000 pods with
   one B1 launch, B4 and B3 launching as their solves counted, no card
   memory outliving the requests; then system-preempt and
   system-lifecycle over ``VolcanoSystem(native_store=True)``, equal to the
   JAX package's native-store records; the metrics server scraped after
   rpc-10k (/metrics, /healthz) and after the native system-preempt
   (/healthz?detail, /debug/why, /debug/timeline); last, the
   vc-snapshot-rpc binary (``python -m volcano_tpu_torch.cmd``) as a
   process of its own answers rpc-10k twice, serves /healthz and exits 0
   on SIGTERM. Prints each world's wall s and encode, request and decode
   ms, and the binary's seconds to listen and its request ms.
26. The plugin worlds (tools/plugin_reference.py) through the port's
   ``Scheduler`` on the card, two cycles each: affinity-10k (the BASELINE
   10k world with hostname and zone labels, gangs spread one pod a node,
   kept to one zone or drawn to their zone by pod affinity), gpushare-10k
   (its 2,000 nodes, 500 of them with 4 shared cards, 80 gangs requesting
   card memory under predicate.GPUSharingEnable), affinity-preempt (the
   tight mix with every tenth running pod critical and conformance in the
   first tier), numa-1k (numa-aware on 200 two-NUMA-node nodes) and
   proportional-1k (predicate.ProportionalEnable on gpu-small); then
   slice 18's: tdm-10k (the 10k generator's nodes, 400 of them in two
   revocable zones, one active on the logical clock and one not;
   preemptable gangs running on plain and inactive-zone nodes; tdm in the
   first tier: B1 under tdm's mask, B3 under its tier mask, the drain in
   the first cycle only), topology-10k (the 10k world's gangs as chief, ps
   and workers with task-topology annotations: B1 in task-topology's task
   order, replayed through Statements), sla-overcommit-10k (300 Pending
   PodGroups asking 1.5x the cluster's idle CPU, overcommit in the second
   tier and sla in the first, three cycles: what overcommit holds back
   enqueues as its sla wait runs out) and reservation-1k (elect and reserve
   around allocate, four cycles: the target and a node locked a cycle);
   each kernel's count set to 0 just before: each digest (binds and
   evictions in order, PodGroup phases, node-tensor path, critical pods
   evicted, the walks' evictions of a victim the first tier refused after
   offering it, and for slice 18's worlds a record a cycle) equal to the
   record tests/plugin_reference_digests.json holds it to (affinity-preempt
   and tdm-10k: the JAX package with its tier dispatch mended as
   upstream's, none such evicted; sla-overcommit-10k: with its durations
   read as Go's), B1 launched once a recorded solve and B3 once a recorded
   walk, the proportional guard refusing placements, no action failure,
   no fallback, and no card memory outliving the phase. Prints each
   world's binds, evictions, launches, rounds, re-check rejections and
   allocate ms split, with the card's name and power limit.
27. Prints one JSON line with each kernel's launches, times, bound and
   error (and its launches in each sim run, system world, rpc world and
   plugin world),
   then the card's name and power limit, then the result line ``{"ok":
   true, "device": {...}}``.

Every phase but step 18 ends with no solver fallback, no device fault and
no degraded cycle counted since the last containment check, and the
device cool-down closed: a fallback nobody asked for is a failed run.

Every ``Scheduler.run_once`` must return no isolated action failure: the
shell isolates a failing action (a kernel that does not launch, say), and
the script counts that as a failed check.

Any failed check raises, and the script exits non-zero without the result
line; so it does without a CUDA device, and outside the repository.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))

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


def admitted(binds) -> frozenset:
    """The gangs a bind map admits (bench.py's admission comparison)."""
    return frozenset(k.rsplit("-", 1)[0] for k in binds)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def clocks_line() -> str:
    """The card's SM clock and its maximum, memory clock, power draw and
    temperature now, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,clocks.mem,"
         "power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
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


def slice_args(cache, device=None):
    """The placement kernel's arguments exactly as the 10k cycle's first
    solve builds them, on ``device`` (the card by default)."""
    import torch

    from volcano_tpu_torch.actions import allocate
    from volcano_tpu_torch.framework import (get_action, open_session,
                                             parse_scheduler_conf)
    from volcano_tpu_torch.ops.place import task_flags
    conf = parse_scheduler_conf(SLICE_CONF)
    ssn = open_session(cache, conf.tiers, conf.configurations,
                       device=device)
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


def place_bound(args, counts, zone=False):
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
    kernels' bounds compare. With ``zone`` (B6) the zone-code column is
    read too."""
    idle, _, _, _, _, _, req, _, _, _, ms, _ = args
    N, R = idle.shape
    T = req.shape[0]
    state_bytes = 3 * N * R * 4 + N * 4
    in_bytes = (T * R * 4 + 3 * T * 4 + N * R * 4 + N * 4 + state_bytes
                + R * 4 + (T * N * 4 if ms is not None else 0)
                + (N * 4 if zone else 0))
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


def args_digest(args) -> str:
    """SHA-256 of a kernel's arguments: tensors by dtype, shape and bytes
    (on whichever device they lie), tuples element by element, anything
    else by repr."""
    import hashlib

    import torch
    h = hashlib.sha256()

    def feed(a):
        if isinstance(a, torch.Tensor):
            t = a.detach().cpu().contiguous()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.numpy().tobytes())
        elif isinstance(a, np.ndarray):
            h.update(f"{a.dtype}{a.shape}".encode())
            h.update(np.ascontiguousarray(a).tobytes())
        elif isinstance(a, (tuple, list)):
            h.update(b"(")
            for x in a:
                feed(x)
            h.update(b")")
        else:
            h.update(repr(a).encode())
    feed(args)
    return h.hexdigest()


def place_worlds():
    """Step 2's placement worlds in its order: label -> (a function of the
    device that makes place_cuda/place_plain's arguments there, whether to
    time every cluster size)."""
    from volcano_tpu_torch.cache.synthetic import baseline_config

    def tainted_10k():
        cache = baseline_config("10k")[0]
        taint_tenth(cache)
        return cache

    gangs = np.random.RandomState(8).randint(20, 51, 80)
    worlds = {}
    for seed in range(3):
        worlds[f"random-{seed}"] = (lambda dev, s=seed: kernel_args(
            random_world(s, T=400, N=300, J=40, R=3, tight=False), dev),
            False)
        worlds[f"tight-{seed}"] = (lambda dev, s=seed: kernel_args(
            random_world(100 + s, T=600, N=64, J=60, R=2, tight=True), dev),
            False)
    worlds["identical-nodes"] = (lambda dev: kernel_args(
        identical_world(4000, 2048, 40), dev), False)
    worlds["r3-n8192"] = (lambda dev: kernel_args(random_world(
        7, T=4000, N=8192, J=100, R=3, tight=False, static=False), dev), True)
    for seed, N in ((11, 8192), (12, 16384)):
        # one request a gang, as in the 10k world, past one CTA's nodes
        worlds[f"gangs-n{N}"] = (lambda dev, s=seed, n=N: kernel_args(
            runs_world(s, n, np.random.RandomState(s).randint(20, 51, 100),
                       static=False), dev), True)
    worlds["runs"] = (lambda dev: kernel_args(runs_world(8, 2000, gangs),
                                              dev), False)
    worlds["static-one-node"] = (lambda dev: kernel_args(
        static_one_node_world(9, T=1000, N=2000, J=20), dev), False)
    worlds["rollback-then-same"] = (lambda dev: kernel_args(
        rollback_then_same_world(64), dev), False)
    worlds["wide-ties"] = (lambda dev: kernel_args(
        wide_ties_world(512, 3000), dev), False)
    worlds["device-memory-r8-n40000"] = (lambda dev: kernel_args(random_world(
        10, T=500, N=40000, J=50, R=8, tight=False, static=False), dev), False)
    worlds["slice-10k"] = (lambda dev: slice_args(
        baseline_config("10k")[0], dev), True)
    worlds["slice-10k-taints"] = (lambda dev: slice_args(tainted_10k(), dev),
                                  True)
    return worlds


def place_plain_cpu(label):
    """place_plain on the CPU on one of step 2's worlds: (the digest of its
    arguments, its outputs as NumPy arrays, its ms on the host clock)."""
    from volcano_tpu_torch.ops.place import place_plain
    args = place_worlds()[label][0]("cpu")
    t0 = time.perf_counter()
    out = place_plain(*args)
    ms = (time.perf_counter() - t0) * 1e3
    return args_digest(args), tuple(t.numpy() for t in out), ms


def compare_place(label, args, plain, sweep=False):
    """place_cuda on the card against place_plain's result on the CPU on the
    same inputs (``plain``: place_plain_cpu's), at the default plan and at
    every cluster size the card launches; returns a record of the
    comparison and the times (with ``sweep``, also the time at each cluster
    size)."""
    import torch

    from volcano_tpu_torch.ops.place import (CLUSTER_SIZES, launch_plan,
                                             max_cluster, place_cuda,
                                             task_rescores)
    digest, want, plain_ms = plain
    check(args_digest(args) == digest,
          f"{label}: the card's inputs differ from the CPU plain run's")
    want = tuple(torch.from_numpy(a).to(args[0].device) for a in want)
    got = place_cuda(*args)
    torch.cuda.synchronize()
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
        "plain_ms": plain_ms, "plain_device": "cpu",
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
# the preempt victim walk against its plain version
# ---------------------------------------------------------------------------

def walk_worlds(card=False):
    """The seeded walk worlds of tests/torch_parity.py (NumPy only) and
    those whose tier kinds only the port takes; with ``card``, those too
    large for the plain walk on the CPU."""
    sys.path.insert(0, os.path.join(_ROOT, "tests"))
    from torch_parity import CARD_WALK_WORLDS, PORT_WALK_WORLDS, WALK_WORLDS
    return CARD_WALK_WORLDS if card else {**WALK_WORLDS, **PORT_WALK_WORLDS}


def walk_bound(inputs, kinds, dispatches):
    """Least time the card could take for one walk, from what these inputs
    need: every input byte read once and every output byte written once
    over HBM bandwidth, against the operations over the FP32 rate.
    ``dispatches`` holds the node dispatches the verdict cache needs on
    these inputs (ops/evict.py::walk_dispatches, counted from the plain
    walk). A dispatch of node n costs, per valid victim slot on it, one
    operation for each static mask and two more for the tier cascade, R
    adds for the evictable sum, and under a drf tier 3R + 3 for the victim
    job's remaining share and the keep compare; per pair of its slots, R
    adds of drf's same-job prefix; R fit compares and two operations of its
    key. Per evaluated task the argmax over the cached keys re-reduces the
    32-node group of each dispatched node and reduces the N/32 group
    maxima, two operations a 64-bit compare. Returns (bound_ms, "bytes" or
    "operations", all_pairs_ms): the last counts a walk without the cache,
    every node dispatched for every evaluated task."""
    nw = inputs.nw
    N, W, R = nw.vreq.shape
    M = inputs.tier_masks.shape[0]
    drf = any(kind.startswith("drf") for kind in kinds)
    k = nw.valid.sum(dim=1).double().cpu().numpy()
    per_node = (k * (M + 2 + R + (3 * R + 3 if drf else 0))
                + (k * (k - 1) / 2 * R if drf else 0) + R + 2)
    groups = -(-int(N) // 32)
    compares = (32 * np.minimum(dispatches.per_task, groups) + groups).sum()
    ops = float((dispatches.per_node * per_node).sum()) + 2.0 * compares
    all_pairs = len(dispatches.per_task) * float(per_node.sum())
    tensors = [t for t in inputs if hasattr(t, "nbytes")] + list(nw)
    in_bytes = sum(int(t.nbytes) for t in tensors)
    P = inputs.preq.shape[0]
    out_bytes = 4 * (P + N * W + inputs.needed.shape[0])
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    return (*larger(t_bytes, ops / FP32_OPS_PER_S * 1e3),
            max(t_bytes, all_pairs / FP32_OPS_PER_S * 1e3))


def compare_walk(label, world, device):
    """walk_cuda against walk_plain on the same CUDA tensors: task nodes,
    slot owners, quota verdicts and evaluated tasks must be equal, and the
    node dispatches the kernel counted must equal those its cache rule
    needs, counted from the plain walk. The record carries the plan the
    kernel launched with (threads, which blocks sit in shared memory), its
    dispatches, its bulk operations and its µs per evaluated task."""
    import torch

    from volcano_tpu_torch.ops.evict import (to_device, walk_cuda,
                                             walk_dispatches, walk_plain)
    inputs, kinds, sizes, gang = world
    d = to_device(inputs, device)
    got = walk_cuda(d, kinds, sizes, gang)
    torch.cuda.synchronize()
    plain = {}
    plain_ms = time_host_ms(lambda: plain.setdefault(
        "out", walk_plain(d, kinds, sizes, gang)))
    want = plain["out"]
    for name in ("task_node", "owner", "job_done"):
        g, w = getattr(got, name), getattr(want, name)
        if not torch.equal(g, w):
            first = (g != w).nonzero()[:1].tolist()
            raise RuntimeError(f"walk {label}: kernel and plain {name} "
                               f"differ, first at {first}")
    check(got.steps == want.steps,
          f"walk {label}: {got.steps} evaluated tasks, plain {want.steps}")
    needed = walk_dispatches(d, kinds, sizes, gang)
    check(int(needed.per_node.sum()) == got.redispatched,
          f"walk {label}: the kernel dispatched {got.redispatched} nodes, "
          f"its cache rule needs {int(needed.per_node.sum())}")
    N, W, R = d.nw.vreq.shape
    plan = got.plan
    rec = {"world": label, "P": int(d.preq.shape[0]), "N": int(N),
           "W": int(W), "R": int(R), "tiers": list(kinds), "gang": gang,
           "steps": got.steps,
           "placed": int((got.task_node >= 0).sum()),
           "evicted": int((got.owner >= 0).sum()), "max_abs_err": 0.0,
           "in_smem": plan.in_smem, "smem_blocks": plan.where(),
           "threads": plan.threads, "redispatched": got.redispatched,
           "bulks": got.bulks,
           "ms": time_cuda_ms(lambda: walk_cuda(d, kinds, sizes, gang)),
           "plain_ms": plain_ms}
    rec["us_per_task"] = rec["ms"] * 1e3 / max(got.steps, 1)
    (rec["bound_ms"], rec["bound_by"],
     rec["bound_all_pairs_ms"]) = walk_bound(d, kinds, needed)
    print("kernel evict_walk", json.dumps(rec), flush=True)
    return rec


def record_walks(fn):
    """Run ``fn`` and return every walk it asked for, as (inputs, kinds,
    sizes, gang) on the inputs' device."""
    from volcano_tpu_torch.actions import evict_tpu
    seen = []
    real = evict_tpu.walk

    def recording(inputs, kinds, sizes, gang_commit):
        seen.append((inputs, kinds, sizes, gang_commit))
        return real(inputs, kinds, sizes, gang_commit)

    evict_tpu.walk = recording
    try:
        fn()
    finally:
        evict_tpu.walk = real
    return seen


# ---------------------------------------------------------------------------
# proportion's water-filling (B8) in its torch form
# ---------------------------------------------------------------------------

def compare_proportion(Q, seed, device):
    """ops/fairness.py::proportion_deserved on the card against its NumPy
    twin on the same seeded inputs (tests/torch_parity.py's): deserved
    shares and queue shares within 1e-5 relative, the tolerance the CPU
    tests hold the torch form to against the JAX loop (the two order the
    64-term queue sums differently). Time: host
    clock around the call, which reads its loop condition back once a
    round (median of 5, warm). Bound: the inputs read once and the outputs
    written once over HBM, against about 16 operations per (queue,
    resource) element per round over the FP32 rate; the rounds are this
    run's, counted by the queue-axis sums (two a round)."""
    import torch

    from volcano_tpu_torch.ops import fairness
    sys.path.insert(0, os.path.join(_ROOT, "tests"))
    from torch_parity import proportion_inputs
    args = proportion_inputs(Q, seed)
    want = fairness.proportion_deserved_numpy(*args)
    calls = [0]
    real = fairness._sum0

    def counting(x):
        calls[0] += 1
        return real(x)

    fairness._sum0 = counting
    try:
        got = fairness.proportion_deserved(*args, device=device)
    finally:
        fairness._sum0 = real
    rounds = calls[0] // 2
    err = 0.0
    for g, w in ((got.deserved, want.deserved), (got.share, want.share)):
        g = g.double().cpu().numpy()
        w = np.asarray(w, np.float64)
        both = np.isfinite(w)
        check(np.array_equal(both, np.isfinite(g)),
              "proportion: infinite entries differ")
        rel = np.abs(g[both] - w[both]) / np.maximum(np.abs(w[both]), 1e-30)
        err = max(err, float(rel.max()) if rel.size else 0.0)
    check(err <= 1e-5, f"proportion: deserved {err} relative off the twin")
    times = []
    for _ in range(6):
        times.append(time_host_ms(lambda: fairness.proportion_deserved(
            *args, device=device)))
    R = len(args[0])
    in_bytes = 4 * (R + Q + 3 * Q * R)
    out_bytes = 4 * (Q * R + Q)
    rec = {"Q": Q, "R": R, "rounds": rounds, "max_rel_err": err,
           "ms": statistics.median(times[1:]),
           "numpy_ms": time_host_ms(
               lambda: fairness.proportion_deserved_numpy(*args))}
    rec["bound_ms"], rec["bound_by"] = larger(
        (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3,
        max(rounds, 1) * Q * R * 16 / FP32_OPS_PER_S * 1e3)
    print("proportion", json.dumps(rec), flush=True)
    return rec


# ---------------------------------------------------------------------------
# the block auction (B4) against its plain version
# ---------------------------------------------------------------------------

BLOCK_KERNELS = ("blocks_prep", "blocks_topk", "blocks_round", "blocks_free")


def blocks_worlds():
    """tests/torch_parity.py's blocks worlds, its card-only blocks worlds
    and the function that makes their arguments (NumPy and the port
    only)."""
    sys.path.insert(0, os.path.join(_ROOT, "tests"))
    from torch_parity import BLOCK_WORLDS, CARD_BLOCK_WORLDS, blocks_args
    return BLOCK_WORLDS, CARD_BLOCK_WORLDS, blocks_args


def blocks_bound(args, kw, stats):
    """Least time the card could take for each B4 kernel's work in one
    solve, from this run's counts (``stats``: chunks and rows with work,
    candidate lists computed (classes), rounds, sweeps, dropped tasks):
    each input
    byte read once and each output byte written once over HBM, against the
    operations the function needs over the FP32 rate. blocks_prep: each
    request and static word hashed once (3 operations) and a grouping of
    each chunk's rows (log2 C), against the requests, the static matrix and
    the class and flag outputs. blocks_topk: rows of one class (the same
    request and static row) have the same candidates, so the function
    scores each (class with work, node) pair once: the fit tests and
    binpack terms, about 11 operations a resource column, and 43 for
    least/most/balanced allocation, the square root and the sums.
    blocks_round: every sum over tasks on one node is an in-order segmented
    prefix (or total) over the chunk's tasks grouped by node, so per task
    with work (a chunk's rows spread evenly over its rounds) a round needs
    a grouping of log2(C) compares, the claims (R + 1), three waves of
    prefix, fit and count tests (3R + 2 each) and the free room (R); a
    chunk then needs a grouping, nine split steps (3R + 1 each), the deltas
    (2R + 1) and the chosen nodes' update (3R + 1). blocks_free: 2R adds
    per dropped task and the state update (3R + 1) of every node per sweep;
    its bytes are the node groups, the dropped tasks' rows and the node
    state. Returns {kernel: (bound_ms, "bytes" or "operations")}, and under
    "blocks_topk_all_rows" the candidate bound counted per row with
    work."""
    N, R = args[0].shape
    has_ms = args[10] is not None
    C = kw["chunk"]
    K = min(32, int(N))
    chunks, rows, classes = stats["chunks"], stats["rows"], stats["classes"]
    log_c = max(1, (int(C) - 1).bit_length())
    per_row = rows / max(1, chunks)
    state_bytes = chunks * (3 * N * R * 4 + 2 * N * 4)
    Tp = int(args[6].shape[0])
    ops = {
        "blocks_prep": Tp * ((R + (N if has_ms else 0)) * 3 + log_c),
        "blocks_topk": classes * N * (11 * R + 43),
        "blocks_topk_all_rows": rows * N * (11 * R + 43),
        "blocks_round": (stats["rounds"] * per_row * (log_c + 11 * R + 7)
                         + rows * (log_c + 9 * (3 * R + 1) + 5 * R + 2)),
        "blocks_free": (stats["dropped"] * 2 * R
                        + stats["sweeps"] * N * (3 * R + 1)),
    }
    moved = {
        "blocks_prep": (Tp * (R * 4 + (N * 4 if has_ms else 0) + 8)
                        + (Tp // C) * (4 + 1)),
        "blocks_topk": (state_bytes + rows * 4
                        + classes * (R * 4 + (N * 4 if has_ms else 0)
                                     + K * 8)),
        "blocks_topk_all_rows": (state_bytes + rows * (
            R * 4 + (N * 4 if has_ms else 0) + K * 8)),
        "blocks_round": chunks * (C * K * 8 + C * R * 4
                                  + 2 * C * (3 * R + 1) * 4 + 8 * C),
        "blocks_free": (stats["sweeps"] * (2 * N * 4
                                           + 2 * N * (3 * R + 1) * 4)
                        + stats["dropped"] * (R + 2) * 4),
    }
    return {k: larger(moved[k] / HBM_BYTES_PER_S * 1e3,
                      ops[k] / FP32_OPS_PER_S * 1e3) for k in ops}


def topk_library_ms(args, kw):
    """The yardstick of the candidate kernel's selection: one torch.topk
    over the first chunk's [C, N] masked scores (ops/blocks.py::
    masked_scores at the solve's initial state), CUDA events, warm, median
    of 5. It covers the selection only, not the scoring, and one row at a
    time where the kernel computes one list a class."""
    import torch

    from volcano_tpu_torch.ops.blocks import masked_scores
    C, N = kw["chunk"], args[0].shape[0]
    ms = None if args[10] is None else args[10][:C]
    masked = masked_scores(args[1], args[2], args[3], args[4], args[5],
                           args[6][:C], ms, args[11])
    return time_cuda_ms(lambda: torch.topk(masked, min(32, N), dim=1))


# the card worlds whose blocks_plain runs on the CPU: its in-order sums are
# Python loops of small tensor operations, several times faster there than
# as launches on the card
BLOCKS_PLAIN_ON_CPU = ("fractional-20k",)


def blocks_plain_cpu(name):
    """blocks_plain on the CPU on one of tests/torch_parity.py's card blocks
    worlds: (the digest of its arguments, its outputs as NumPy arrays, its
    ms on the host clock)."""
    from volcano_tpu_torch.ops.blocks import blocks_plain
    _, card_worlds, world_args = blocks_worlds()
    args, kw = world_args(card_worlds[name](), "cpu")
    t0 = time.perf_counter()
    out = blocks_plain(*args, **kw)
    ms = (time.perf_counter() - t0) * 1e3
    return args_digest((args, kw)), tuple(t.numpy() for t in out), ms


def compare_blocks(label, args, kw, plain=None):
    """blocks_cuda against blocks_plain on the same inputs, the plain
    version on the card or, given ``plain`` (blocks_plain_cpu's result), on
    the CPU: the packed row and the final node state must be equal
    (tolerance 0). The
    record has the solve's time (CUDA events around the whole call, warm,
    median of 5), each kernel's device time in one solve (events around
    each launch alone, median of 5), the classes' and exactness flags'
    ("blocks_prep", once a solve) and the frees' grouping's (tensor ops
    before each blocks_free launch, "blocks_free_prep"), each kernel's
    launches in one solve, the counts (with the chunks each sum mode took),
    µs a round of the round kernel and a launch of the candidate kernel,
    the bound of each kernel from the counts, and one timed run of
    blocks_plain (host clock, synchronised), with its parts by kernel for
    the engine's solves (labels "solve-...")."""
    import torch

    from volcano_tpu_torch.ops.blocks import (blocks_cuda, blocks_plain,
                                              chunk_exact, free_cuda,
                                              prep_cuda, round_cuda,
                                              task_classes, topk_cuda)
    counters = (prep_cuda, topk_cuda, round_cuda, free_cuda)
    # the per-solve classes and exactness flags: kernel against tensor ops
    req, ms, C = args[6], args[10], kw["chunk"]
    classes, exact = prep_cuda(req, ms, C)
    want = (*task_classes(req, ms, C), chunk_exact(req, C).to(torch.uint8))
    for name, g, w in zip(("cls", "class_rep", "n_class", "exact"),
                          (*classes, exact), want):
        if not torch.equal(g, w):
            raise RuntimeError(f"blocks {label}: blocks_prep's {name} differs "
                               f"from the tensor ops'")
    prep_plain_ms = time_cuda_ms(lambda: (task_classes(req, ms, C),
                                          chunk_exact(req, C)))
    before = [k.launches for k in counters]
    stats = {}
    got = blocks_cuda(*args, stats=stats, **kw)
    torch.cuda.synchronize()
    launches = dict(zip(BLOCK_KERNELS, (k.launches - b for k, b in
                                        zip(counters, before))))
    # the plain version's parts only for the engine's solves (the kernels
    # line reads them): timing them synchronises after every part
    box, plain_parts = {}, ({} if label.startswith("solve-") else None)
    if plain is None:
        plain_ms = time_host_ms(lambda: box.setdefault("out", blocks_plain(
            *args, timing=plain_parts, **kw)))
    else:
        digest, want, plain_ms = plain
        check(args_digest((args, kw)) == digest,
              f"blocks {label}: the card's inputs differ from the CPU plain "
              f"run's")
        box["out"] = tuple(torch.from_numpy(a).to(got[0].device)
                           for a in want)
    for name, g, w in zip(("packed", "idle", "future_idle", "used",
                           "ntasks"), got, box["out"]):
        if not torch.equal(g, w):
            first = (g != w).nonzero()[:1].tolist()
            raise RuntimeError(f"blocks {label}: kernels and plain {name} "
                               f"differ, first at {first}")
    runs = []
    for _ in range(5):
        timing = {}
        blocks_cuda(*args, timing=timing, **kw)
        runs.append(timing)
    T = int(args[7].sum())
    kernel_ms = {k: statistics.median(r.get(k, 0.0) * 1e3 for r in runs)
                 for k in BLOCK_KERNELS + ("blocks_free_prep",)}
    bound = blocks_bound(args, kw, stats)
    rec = {"world": label, "T": T, "Tp": int(args[6].shape[0]),
           "N": int(args[0].shape[0]), "R": int(args[0].shape[1]),
           "static": args[10] is not None, **kw,
           "placed": int((got[0][:args[6].shape[0]] >= 0).sum()),
           "max_abs_err": 0.0, "launches": launches, "counts": stats,
           "modes": {"exact": stats["chunks_exact"],
                     "in_order": stats["chunks"] - stats["chunks_exact"]},
           "ms": time_cuda_ms(lambda: blocks_cuda(*args, **kw)),
           "kernel_ms": kernel_ms,
           "us_per_round": (kernel_ms["blocks_round"] * 1e3
                            / max(1, stats["rounds"])),
           "us_per_chunk": (kernel_ms["blocks_topk"] * 1e3
                            / max(1, launches["blocks_topk"])),
           "plain_ms": plain_ms,
           "plain_device": "cuda" if plain is None else "cpu",
           "plain_kernel_ms": {k: v * 1e3
                               for k, v in (plain_parts or {}).items()},
           "prep_plain_ms": prep_plain_ms,
           "bound": bound}
    print("kernel blocks", json.dumps(rec), flush=True)
    return rec


def record_blocks_solves(fn):
    """Run ``fn`` and return, for every block-auction solve the allocate
    action asked for, blocks_plain/blocks_cuda's arguments as the solve
    passed them (the task axis padded), on the card."""
    import torch

    from volcano_tpu_torch.actions import allocate
    from volcano_tpu_torch.ops.blocks import JobMeta, pad_tasks
    seen = []
    real = allocate.place_blocks_unified

    def recording(mesh, nodes, req, valid, job_ix, jobs, weights, alloc,
                  max_tasks, **kw):
        padded = pad_tasks(req, valid, job_ix, kw.get("masked_static"))
        meta = JobMeta(*(torch.as_tensor(a, dtype=torch.int32,
                                         device=req.device) for a in jobs))
        seen.append(((*nodes, alloc, max_tasks, *padded[:3], meta,
                      padded[3], weights),
                     {"chunk": 256, "sweeps": kw["sweeps"],
                      "passes": kw["passes"]}))
        return real(mesh, nodes, req, valid, job_ix, jobs, weights, alloc,
                    max_tasks, **kw)

    allocate.place_blocks_unified = recording
    try:
        out = fn()
    finally:
        allocate.place_blocks_unified = real
    return out, seen


def engine_conf(engine: str, default: bool = False) -> str:
    """deploy/scheduler.conf with only its allocate-tpu engine line set to
    ``engine``; with ``default``, the reference's default conf with its
    allocate action's engine set."""
    if default:
        from volcano_tpu_torch.framework import DEFAULT_SCHEDULER_CONF
        return (DEFAULT_SCHEDULER_CONF + "configurations:\n"
                "- name: allocate\n  arguments:\n"
                f"    engine: {engine}\n")
    return deployed_conf().replace("engine: tpu-fused", f"engine: {engine}")


def check_capacity_and_gangs(cache, label):
    """The invariants of a cycle with no CPU run to compare with: no node
    holds more than its allocatable or its pod count, and every gang is
    bound whole (at least its minAvailable) or not at all. Returns the bind
    count."""
    tasks = {f"{t.namespace}/{t.name}": (j, t) for j in cache.jobs.values()
             for t in j.tasks.values()}
    used, pods, per_job = {}, {}, {}
    for key, node_name in cache.binder.binds.items():
        job, task = tasks[key]
        r = task.resreq
        u = used.setdefault(node_name, [0.0, 0.0])
        u[0] += r.cpu
        u[1] += r.memory
        pods[node_name] = pods.get(node_name, 0) + 1
        per_job[job.uid] = per_job.get(job.uid, 0) + 1
    for name, (cpu, mem) in used.items():
        node = cache.nodes[name]
        alloc = node.allocatable
        check(cpu <= alloc.cpu and mem <= alloc.memory,
              f"{label}: node {name} holds {cpu}/{mem} of "
              f"{alloc.cpu}/{alloc.memory}")
        check(pods[name] <= alloc.max_task_num,
              f"{label}: node {name} holds {pods[name]} pods")
    for uid, n in per_job.items():
        check(n >= cache.jobs[uid].min_available,
              f"{label}: gang {uid} bound {n} of "
              f"{cache.jobs[uid].min_available}")
    return len(cache.binder.binds)


# ---------------------------------------------------------------------------
# preempt alone, and the deployed cycle
# ---------------------------------------------------------------------------

def deployed_conf() -> str:
    with open(os.path.join(_ROOT, "deploy", "scheduler.conf")) as f:
        return f.read()


def preempt_world(intra=False):
    from volcano_tpu_torch.cache.synthetic import baseline_config
    cache = baseline_config("preempt")[0]
    if intra:
        sys.path.insert(0, os.path.join(_ROOT, "tests"))
        from torch_parity import intra_variant
        intra_variant(cache)
    return cache


def run_preempt(device, intra=False):
    """PreemptAction(engine="tpu") alone, under deploy/scheduler.conf's
    tiers, on a fresh preempt world; returns (evictions, pipelined tasks,
    walk launches, action ms, phase stats, the walks it ran)."""
    from volcano_tpu_torch.actions import PreemptAction
    from volcano_tpu_torch.framework import (close_session, open_session,
                                             parse_scheduler_conf)
    from volcano_tpu_torch.ops.evict import walk_cuda
    cache = preempt_world(intra)
    conf = parse_scheduler_conf(deployed_conf())
    ssn = open_session(cache, conf.tiers, conf.configurations, device=device)
    out = {}
    action = PreemptAction(engine="tpu")

    def drive():
        walk_cuda.launches = 0
        t0 = time.perf_counter()
        action.execute(ssn)
        out["ms"] = (time.perf_counter() - t0) * 1e3
        out["launches"] = walk_cuda.launches

    walks = record_walks(drive)
    pipelined = sorted(t.uid for j in ssn.jobs.values()
                       for t in j.tasks.values() if int(t.status) == 3)
    close_session(ssn)
    return (sorted(cache.evictor.evicts), pipelined, out["launches"],
            out["ms"], action.last_stats, walks)


def deployed_world(name):
    """A fresh world: a BASELINE config by name ("1k-seed3": the 1k world
    from seed 3; a "-taints" suffix: taint_tenth on top), bench.py's
    pipeline world, or the tight running+pending mix."""
    from volcano_tpu_torch.cache import synthetic
    if name in ("10k", "20k", "20k-taints", "100k", "1k-seed3"):
        base, _, extra = name.partition("-")
        cache = synthetic.baseline_config(
            base, seed=3 if extra == "seed3" else 0)[0]
        if extra == "taints":
            taint_tenth(cache)
        return cache
    if name == "pipeline":
        return synthetic.pipeline_world()[0]
    return synthetic.preempt_mix_cache(n_nodes=400, n_tasks=10000,
                                       n_jobs=200)[0]


def kernel_counters():
    """Every kernel wrapper whose launches the script counts, by name."""
    from volcano_tpu_torch.ops.blocks import (free_cuda, prep_cuda,
                                              round_cuda, topk_cuda)
    from volcano_tpu_torch.ops.evict import walk_cuda
    from volcano_tpu_torch.ops.place import (decode_packed_cuda, place_cuda,
                                             place_topo_cuda, rowdiff_cuda)
    return {"place": place_cuda, "place_topo": place_topo_cuda,
            "rowdiff": rowdiff_cuda,
            "decode_packed": decode_packed_cuda,
            "evict_walk": walk_cuda, "blocks_prep": prep_cuda,
            "blocks_topk": topk_cuda, "blocks_round": round_cuda,
            "blocks_free": free_cuda}


def run_deployed(name, device, conf_text=None, keep_cache=False):
    """One ``Scheduler.run_once`` of deploy/scheduler.conf as written (or
    ``conf_text``) on a fresh world, each kernel's count set to 0 just
    before; returns the decisions, the phase times in ms, the launches, the
    preempt phases (None without preempt) and the allocate action's stats
    (and the cache with ``keep_cache``)."""
    from volcano_tpu_torch import Scheduler, scheduler
    cache = deployed_world(name)
    sched = Scheduler(cache, conf_text or deployed_conf(), device=device)
    closed = []
    real_close = scheduler.close_session

    def close(ssn):
        closed.append(ssn)
        real_close(ssn)

    scheduler.close_session = close
    counters = kernel_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    try:
        errors = sched.run_once()
    finally:
        scheduler.close_session = real_close
    check(errors == [], f"deployed {name}: isolated action failures "
                        f"{[(n, repr(e)) for n, e in errors]}")
    launches = {k: w.launches for k, w in counters.items()}
    ssn = closed[0]
    got = {
        "binds": dict(cache.binder.binds),
        "evicts": sorted(cache.evictor.evicts),
        "pipelined": sorted(t.uid for j in ssn.jobs.values()
                            for t in j.tasks.values() if int(t.status) == 3),
        "phases": {uid: j.podgroup.phase.value
                   for uid, j in cache.jobs.items()},
    }
    times = {k: v * 1e3 for k, v in sched.last_cycle_s.items()}
    by_name = {a.name(): a for a in sched.actions}
    preempt = by_name.get("preempt")
    alloc = by_name.get("allocate-tpu") or by_name.get("allocate")
    out = (got, times, launches,
           None if preempt is None else preempt.last_stats, alloc.last_stats)
    return out + (cache,) if keep_cache else out



# ---------------------------------------------------------------------------
# the sim
# ---------------------------------------------------------------------------

# the sim runs on the card, each held to the JAX package's decision-plane
# digest in tests/sim_reference_digests.json (tools/sim_reference.py)
SIM_RUNS = (
    ("baseline-10k", ("--conf", "deploy/scheduler.conf")),
    ("preempt-burst", ("--conf", "deploy/scheduler.conf")),
    ("skew", ("--conf", "deploy/scheduler.conf")),
    ("smoke", ("--conf", "deploy/scheduler.conf", "--chaos-rate", "0.2",
               "--kill-cycles", "5,12")),
)


def sim_digests() -> dict:
    with open(os.path.join(_ROOT, "tests",
                           "sim_reference_digests.json")) as f:
        return {run["key"]: run for run in json.load(f)["runs"]}


def run_sim(scenario, args, source_argv=None):
    """``python -m volcano_tpu_torch.sim --scenario S ARGS`` on the card
    (its entry point, in this process; ``source_argv`` replaces
    ``--scenario S``, e.g. with ``--trace FILE``), each kernel's count set
    to 0 just before; returns the report, the decision plane's bytes as
    ``--deterministic`` prints them, the run's sequence digest (every
    bind's node and every eviction, in order), the launches and the wall
    seconds."""
    import contextlib
    import io

    from volcano_tpu_torch import metrics
    from volcano_tpu_torch.sim.__main__ import main as sim_main
    from volcano_tpu_torch.sim.report import (deterministic_json,
                                              percentiles, sequence_digest)
    counters = kernel_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    out = io.StringIO()
    mark = metrics.durations_mark()
    t0 = time.perf_counter()
    runners = []
    src = source_argv or ["--scenario", scenario]
    with contextlib.redirect_stdout(out):
        rc = sim_main([*src, *args], runners=runners)
    wall_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in counters.items()}
    check(rc == 0, f"sim {scenario}: exit {rc}")
    report = json.loads(out.getvalue())
    if "wallclock" in report:
        # open_session to close_session, each cycle (the rest of run_once
        # is the resync pass and the epilogue); a --deterministic run
        # prints no wall-clock plane
        report["wallclock"]["schedule_ms"] = percentiles(
            metrics.durations_since(mark).get(("e2e",), []))
    text = (deterministic_json(report) + "\n").encode()
    return report, text, sequence_digest(runners[0]), launches, wall_s


def profile_sim(scenario, args) -> dict:
    """The same sim run again under torch.profiler: the device's busy time
    by kernel name and its idle share of the run's cycles (the summed
    pipeline_e2e_ms). Only device events are summed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        report, text, sequence, _, _ = run_sim(scenario, args)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    cycles_ms = (report["wallclock"]["pipeline_e2e_ms"]["mean"]
                 * report["cycles"])
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "device_busy_ms": busy_ms, "cycles_ms": cycles_ms,
        "device_idle_share": (1.0 - busy_ms / cycles_ms)
        if busy_ms else None,
        "by_kernel_ms": {e.key[:60]: e.self_device_time_total / 1e3
                         for e in top},
        "decision_plane_sha256": __import__("hashlib").sha256(
            text).hexdigest(),
        "sequence_sha256": sequence["sha256"],
    }


# ---------------------------------------------------------------------------
# incremental state
# ---------------------------------------------------------------------------

OFF_ENV = (("VOLCANO_TPU_INCREMENTAL_SNAPSHOT", "0"),)
# (source, sim arguments, environment), each held to its entry in
# tests/sim_reference_digests.json (tools/sim_reference.py's keys): the
# slice's full width with the incremental snapshot and the persistent
# node tensors on (the default) and off, steady-10k, and the traces of
# tools/sim_traces.py (node churn, and the full-width hole world)
INCREMENTAL_RUNS = (
    ("baseline-10k", ("--conf", "deploy/scheduler.conf"), ()),
    ("baseline-10k", ("--conf", "deploy/scheduler.conf"), OFF_ENV),
    ("steady-10k", ("--conf", "deploy/scheduler.conf"), ()),
    ("trace:churn", ("--conf", "deploy/scheduler.conf"), ()),
    ("trace:hole-10k", ("--conf", "deploy/scheduler.conf"), ()),
)


def sim_tools():
    """tools/sim_reference.py (run keys, trace arguments) and
    tools/sim_traces.py (the traces, the tensor-path recorder); neither
    imports JAX."""
    sys.path.insert(0, os.path.join(_ROOT, "tools"))
    import sim_reference
    import sim_traces
    return sim_reference, sim_traces


def run_incremental(source, args, env, trace_dir):
    """One sim run of INCREMENTAL_RUNS on the card with ``env`` set: the
    run_sim results, the summary of the solves' node-tensor paths, each
    session open's ms (with its snapshot's clone ms), and each tensor
    refresh's host ms, full flag and rows. Nothing here synchronizes the
    card, so switch-on and switch-off runs are timed alike: a scatter's
    device work is queued and lands in the solve that reads it."""
    from volcano_tpu_torch import scheduler as shell
    from volcano_tpu_torch.actions import allocate
    from volcano_tpu_torch.cache import SchedulerCache
    tool, traces = sim_tools()
    opens, snaps, refreshes = [], [], []
    real_open = shell.open_session
    real_refresh = SchedulerCache.tensor_refresh

    def timed_open(cache, *a, **kw):
        t0 = time.perf_counter()
        ssn = real_open(cache, *a, **kw)
        opens.append((time.perf_counter() - t0) * 1e3)
        snaps.append(cache.last_snapshot_stats["clone_s"] * 1e3)
        return ssn

    def timed_refresh(cache, *a, **kw):
        t0 = time.perf_counter()
        tc = real_refresh(cache, *a, **kw)
        if tc is not None:
            refreshes.append(((time.perf_counter() - t0) * 1e3,
                              tc.last_refresh["full"],
                              tc.last_refresh["rows"]))
        return tc

    saved = {k: os.environ.get(k) for k, _ in env}
    os.environ.update(dict(env))
    shell.open_session = timed_open
    SchedulerCache.tensor_refresh = timed_refresh
    paths = traces.TensorPathRecorder(allocate, SchedulerCache)
    try:
        out = run_sim(None, args, tool.sim_argv(source, trace_dir))
    finally:
        paths.close()
        shell.open_session = real_open
        SchedulerCache.tensor_refresh = real_refresh
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out, paths.summary(), opens, snaps, refreshes


def incremental_phase(digests, sim_runs, runs=INCREMENTAL_RUNS,
                      extra_args=()):
    """Step 13: each run of ``runs`` on the card, held to the JAX package's
    record: its decision plane, side-effect sequence and solve-by-solve
    node-tensor path (with the drift repairs); baseline-10k with the switch
    on and off in this call. Adds each run's launches to ``sim_runs``."""
    import hashlib
    import tempfile

    from volcano_tpu_torch import metrics
    from volcano_tpu_torch.sim.report import percentiles
    tool, _ = sim_tools()
    inc_runs = {}
    with tempfile.TemporaryDirectory() as trace_dir:
        for source, args, env in runs:
            key = tool.run_key(source, args, env)
            drift0 = {k[1]: v for k, v in metrics.local_counters().items()
                      if k[0] == "state_drift"}
            (report, text, sequence, launches, wall_s), paths, opens, \
                snaps, refreshes = run_incremental(
                    source, (*args, *extra_args), env, trace_dir)
            drift = {k[1]: v - drift0.get(k[1], 0)
                     for k, v in metrics.local_counters().items()
                     if k[0] == "state_drift"}
            want = digests[key]
            check(hashlib.sha256(text).hexdigest() == want["sha256"]
                  and len(text) == want["bytes"],
                  f"incremental {key}: decision plane differs from the JAX "
                  f"package's ({len(text)} bytes, want {want['bytes']})")
            check((sequence["sha256"], sequence["binds"],
                   sequence["evicts"])
                  == (want["sequence_sha256"], want["sequence_binds"],
                      want["sequence_evicts"]),
                  f"incremental {key}: a bind's node or an eviction "
                  f"differs from the JAX package's")
            check(paths == want["tensor_paths"],
                  f"incremental {key}: node-tensor paths {paths} differ "
                  f"from the JAX package's {want['tensor_paths']} (the "
                  f"port's CPU run equals them: "
                  f"tests/test_torch_sim_incremental.py)")
            check(report["action_failures"] == 0
                  and report["double_binds"] == 0,
                  f"incremental {key}: {report['action_failures']} action "
                  f"failures, {report['double_binds']} double binds")
            check(launches["place"] > 0,
                  f"incremental {key}: the placement kernel never "
                  f"launched")
            if env:
                check(paths["persistent"] == 0,
                      f"incremental {key}: a solve read persistent rows "
                      f"with the switch off")
            elif source in ("steady-10k", "trace:hole-10k"):
                check(paths["scatter"] > 0,
                      f"incremental {key}: no scatter refresh")
            scatters = [r for r in refreshes if not r[1] and r[2]]
            wall = report["wallclock"]
            rec = {
                "cycles": report["cycles"], "binds": report["binds"],
                "evicts": report["evicts"], "launches": launches,
                "schedule_ms": wall["schedule_ms"],
                "pipeline_e2e_ms": wall["pipeline_e2e_ms"],
                "open_ms": percentiles(opens),
                "snapshot_clone_ms": percentiles(snaps),
                "tensor_paths": {k: v for k, v in paths.items()
                                 if k != "sha256"},
                "refreshes": len(refreshes),
                "scatter_rows": percentiles([r[2] for r in scatters]),
                "scatter_refresh_host_ms": percentiles(
                    [r[0] for r in scatters]),
                "full_refresh_host_ms": percentiles(
                    [r[0] for r in refreshes if r[1]]),
                "drift_repairs": len(paths["drift"]),
                "state_drift": drift, "wall_s": wall_s,
                "decision_plane_sha256": hashlib.sha256(text).hexdigest(),
                "sequence_sha256": sequence["sha256"]}
            inc_runs[key] = rec
            sim_runs[key] = launches
            print(f"incremental {key}:", json.dumps(rec), flush=True)
    on = inc_runs[tool.run_key(*runs[0])]
    off = inc_runs[tool.run_key(*runs[1])]
    print("incremental baseline-10k on vs off:", json.dumps({
        k: {"on": on[k], "off": off[k]}
        for k in ("schedule_ms", "open_ms", "snapshot_clone_ms",
                  "pipeline_e2e_ms", "tensor_paths")}), flush=True)
    print("incremental card:", card_line(), flush=True)


# ---------------------------------------------------------------------------
# the pipelined cycle and B7
# ---------------------------------------------------------------------------

# (source, sim arguments, arguments past the digest's), each held to its
# entry in tests/sim_reference_digests.json (tools/sim_reference.py's
# pipelined RUNS): the no-conflict world (with its serial oracle), churn
# with fast admit, churn with kills (two of them between a speculative
# dispatch and its commit) and the full-width standing backlog
PIPELINED_RUNS = (
    ("pipelined-steady", ("--seed", "3", "--pipelined"),
     ("--verify-pipelined-equivalence",)),
    ("pipelined-conflict", ("--pipelined", "--fast-admit"), ()),
    ("pipelined-conflict", ("--pipelined", "--kill-cycles", "3,8,14",
                            "--kill-seed", "5"), ()),
    ("trace:backlog-16k", ("--pipelined",), ()),
)


def job_index(flags):
    """Each task's job index from the solve's FIRST flags."""
    return (np.cumsum((np.asarray(flags) & 2) != 0) - 1).astype(np.int32)


def compare_decode(label, packed, job_ix, J, timed=False):
    """decode_packed_cuda against decode_packed_plain on the same CUDA
    tensors, to the bit; with ``timed`` also both times and the bound
    (each word and job index read once, the wire written once, over HBM
    bandwidth)."""
    import torch

    from volcano_tpu_torch.ops.place import (decode_packed_cuda,
                                             decode_packed_plain)
    got = decode_packed_cuda(packed, job_ix, J)
    torch.cuda.synchronize()
    want = decode_packed_plain(packed, job_ix, J)
    check(got.dtype == want.dtype and torch.equal(got, want),
          f"decode {label}: kernel and plain wires differ")
    T = int(packed.shape[0])
    rec = {"world": label, "T": T, "J": int(J), "max_abs_err": 0.0,
           "boundary_rows": int(((packed & 12) != 0).sum())}
    if timed:
        rec["ms"] = time_cuda_ms(lambda: decode_packed_cuda(packed, job_ix,
                                                            J), reps=21)
        rec["plain_ms"] = time_host_ms(
            lambda: decode_packed_plain(packed, job_ix, J))
        rec["bound_ms"] = (2 * T + 2 * T + 2 * J) * 4 / HBM_BYTES_PER_S * 1e3
        rec["bound_by"] = "bytes"
    print("kernel decode_packed", json.dumps(rec), flush=True)
    return rec


def decode_worlds(dev):
    """B7 on the wires of B1 solves of step 2's worlds and of the 10k
    cycle's solve (B1 on the card, its words then decoded), and on seeded
    wires with jobs of no boundary row, jobs of several and rows of zero
    flags. Returns the records; the 10k cycle's is timed."""
    import torch

    from volcano_tpu_torch.cache.synthetic import baseline_config
    from volcano_tpu_torch.ops.place import place_cuda
    out = []
    solves = [("b1-random-0", kernel_args(random_world(
                   0, T=400, N=300, J=40, R=3, tight=False), dev)),
              ("b1-tight-0", kernel_args(random_world(
                   100, T=600, N=64, J=60, R=2, tight=True), dev)),
              ("b1-rollback-then-same",
               kernel_args(rollback_then_same_world(64), dev)),
              ("b1-slice-10k", slice_args(baseline_config("10k")[0]))]
    for label, args in solves:
        packed = place_cuda(*args)[0]
        flags = args[7].cpu().numpy()
        jix = job_index(flags)
        J = int(jix[-1]) + 1 if len(jix) else 0
        out.append(compare_decode(
            label, packed, torch.tensor(jix, device=dev), J,
            timed=label == "b1-slice-10k"))
    rng = np.random.default_rng(7)
    for T, J in ((1, 1), (1000, 40), (20000, 3000), (5000, 5000), (0, 5)):
        jix = np.sort(rng.integers(0, J, T)).astype(np.int32)
        fl = rng.integers(0, 16, T)
        fl[rng.random(T) < 0.25] = 0
        packed = ((rng.integers(0, 2000, T) + 1) << 4 | fl).astype(np.int32)
        out.append(compare_decode(
            f"seeded-T{T}-J{J}", torch.tensor(packed, device=dev),
            torch.tensor(jix, device=dev), J))
    return out


def nosync_dispatch(dev):
    """dispatch_speculative_solve on the baseline-10k world's speculative
    session under torch.cuda.set_sync_debug_mode("error"), then its fetch
    against the serial solve on the same session; returns the dispatch's
    host ms and the fetch's wait ms."""
    import torch

    from volcano_tpu_torch import Scheduler
    from volcano_tpu_torch.actions import allocate
    from volcano_tpu_torch.cache.synthetic import baseline_config
    from volcano_tpu_torch.framework import abandon_session, open_session
    from volcano_tpu_torch.ops.place import max_cluster
    from volcano_tpu_torch.sim.runner import PIPELINED_SIM_CONF
    cache = baseline_config("10k")[0]
    sched = Scheduler(cache, PIPELINED_SIM_CONF, device=dev, pipelined=True)
    sched.prewarm()
    max_cluster()
    ssn = open_session(cache, sched.conf.tiers, sched.conf.configurations,
                       device=dev, speculative=True)
    try:
        sched.actions[0].execute(ssn)        # enqueue, as the cycle before
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = allocate.dispatch_speculative_solve(ssn, "tpu-fused")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(pending is not None and pending.event is not None,
              "the 10k speculative session dispatched nothing")
        got = allocate.finalize_speculative_dispatch(pending)
        want = allocate._fused_solution(
            allocate.placement_inputs(ssn, pending.ordered_jobs))
        for f in ("task_node", "pipelined", "job_ready", "job_kept"):
            check(np.array_equal(np.asarray(getattr(got, f)),
                                 np.asarray(getattr(want, f))),
                  f"the dispatched solve's {f} differs from the serial "
                  f"solve's")
        check(int((np.asarray(got.task_node) >= 0).sum())
              == len(pending.tasks),
              "the dispatched 10k solve did not place every pod")
        rec = {"dispatch_host_ms": pending.dispatch_s * 1e3,
               "fetch_wait_ms": pending.wait_s * 1e3,
               "done_at_fetch": bool(pending.done_at_fetch),
               "tasks": len(pending.tasks)}
    finally:
        abandon_session(ssn)
    print("pipelined nosync dispatch 10k:", json.dumps(rec), flush=True)
    return rec


def run_pipelined(source, args, extra, trace_dir):
    """One run of PIPELINED_RUNS on the card: the run_sim results, the
    tensor-path summary of its first (reported) run, and each dispatched
    speculation's dispatch host ms, with, where it was fetched, whether
    its event had completed at the fetch and the fetch's wait ms."""
    from volcano_tpu_torch.actions import allocate
    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.sim.runner import SimRunner
    tool, traces = sim_tools()
    dispatched, fetched = [], []
    real_dispatch = allocate.dispatch_speculative_solve
    real_finalize = allocate.finalize_speculative_dispatch
    real_run = SimRunner.run
    first = {}

    def dispatch(*a, **kw):
        pending = real_dispatch(*a, **kw)
        if pending is not None:
            dispatched.append(pending)
        return pending

    def finalize(pending):
        sol = real_finalize(pending)
        fetched.append(pending)
        return sol

    def run(runner):
        report = real_run(runner)
        first.setdefault("paths", len(paths.paths))
        first.setdefault("drift", len(paths.drift))
        return report

    allocate.dispatch_speculative_solve = dispatch
    allocate.finalize_speculative_dispatch = finalize
    SimRunner.run = run
    paths = traces.TensorPathRecorder(allocate, SchedulerCache)
    try:
        out = run_sim(None, (*args, *extra), tool.sim_argv(source, trace_dir))
    finally:
        paths.close()
        allocate.dispatch_speculative_solve = real_dispatch
        allocate.finalize_speculative_dispatch = real_finalize
        SimRunner.run = real_run
    paths.paths = paths.paths[:first["paths"]]
    paths.drift = paths.drift[:first["drift"]]
    return out, paths.summary(), dispatched, fetched


def pipelined_phase(digests, sim_runs, runs=PIPELINED_RUNS, extra_args=()):
    """Step 15: B7 against its plain version, the no-sync dispatch, and
    the sim's pipelined runs on the card, each held to the JAX package's
    record, with backlog-16k's serial run in the same call. Adds each
    run's launches to ``sim_runs``; returns B7's timed record, the no-sync
    record and the pipelined runs' records."""
    import hashlib
    import tempfile

    from volcano_tpu_torch.framework import resolve_device
    from volcano_tpu_torch.sim.report import percentiles, terminal_accounting
    dev = resolve_device(None)
    decode_records = decode_worlds(dev)
    nosync = nosync_dispatch(dev)
    tool, _ = sim_tools()
    out = {}
    with tempfile.TemporaryDirectory() as trace_dir:
        for source, args, extra in runs:
            key = tool.run_key(source, args)
            (report, text, sequence, launches, wall_s), paths, dispatched, \
                fetched = run_pipelined(source, (*args, *extra_args),
                                        extra, trace_dir)
            want = digests[key]
            check(hashlib.sha256(text).hexdigest() == want["sha256"]
                  and len(text) == want["bytes"],
                  f"pipelined {key}: decision plane differs from the JAX "
                  f"package's ({len(text)} bytes, want {want['bytes']})")
            check((sequence["sha256"], sequence["binds"],
                   sequence["evicts"])
                  == (want["sequence_sha256"], want["sequence_binds"],
                      want["sequence_evicts"]),
                  f"pipelined {key}: a bind's node or an eviction differs "
                  f"from the JAX package's")
            check(paths == want["tensor_paths"],
                  f"pipelined {key}: node-tensor paths {paths} differ from "
                  f"the JAX package's {want['tensor_paths']}")
            check(report["action_failures"] == 0
                  and report["double_binds"] == 0,
                  f"pipelined {key}: {report['action_failures']} action "
                  f"failures, {report['double_binds']} double binds")
            check(report["jobs"]["completed"] == report["jobs"]["arrived"],
                  f"pipelined {key}: not every arrived job completed")
            n = len(dispatched)
            check(n > 0, f"pipelined {key}: no speculation was dispatched")
            check(launches["decode_packed"] == n,
                  f"pipelined {key}: B7 launched {launches['decode_packed']}"
                  f" times for {n} dispatched speculations")
            check(launches["place"] >= n,
                  f"pipelined {key}: B1 launched {launches['place']} times "
                  f"for {n} dispatched speculations")
            wall = report["wallclock"]
            rec = {
                "args": list(args) + list(extra), "cycles": report["cycles"],
                "binds": report["binds"], "restarts": report["restarts"],
                "speculation": report["speculation"],
                "fast_admit": report.get("fast_admit"),
                "dispatched": n, "fetched": len(fetched),
                "done_at_fetch": sum(1 for p in fetched if p.done_at_fetch),
                "dispatch_host_ms": percentiles(
                    [p.dispatch_s * 1e3 for p in dispatched]),
                "fetch_wait_ms": percentiles(
                    [p.wait_s * 1e3 for p in fetched]),
                "launches": launches,
                "schedule_ms": wall["schedule_ms"],
                "pipeline_e2e_ms": wall["pipeline_e2e_ms"],
                "tensor_paths": {k: v for k, v in paths.items()
                                 if k != "sha256"},
                "ttfb_p99_cycles": report.get("ttfb_p99_cycles"),
                "wall_s": wall_s,
                "decision_plane_sha256": hashlib.sha256(text).hexdigest(),
                "sequence_sha256": sequence["sha256"]}
            out[key] = (rec, report)
            sim_runs[key] = launches
            print(f"pipelined {key}:", json.dumps(rec), flush=True)
        # backlog-16k's serial shell on the same trace and conf, same call
        from volcano_tpu_torch.sim.runner import PIPELINED_SIM_CONF
        conf = os.path.join(trace_dir, "pipelined.conf")
        with open(conf, "w") as f:
            f.write(PIPELINED_SIM_CONF)
        src = tool.sim_argv("trace:backlog-16k", trace_dir)
        report, text, sequence, launches, wall_s = run_sim(
            None, ("--conf", conf, *extra_args), src)
        piped_rec, piped = out[tool.run_key("trace:backlog-16k",
                                            ("--pipelined",))]
        check(terminal_accounting(report) == terminal_accounting(piped)
              and report["binds"] == piped["binds"],
              "backlog-16k: the serial run's terminal accounting differs "
              "from the pipelined run's")
        check(launches["decode_packed"] == 0,
              "backlog-16k serial: B7 launched")
        sim_runs["trace:backlog-16k serial"] = launches
        wall = report["wallclock"]
        side = {
            "pipelined": {k: piped_rec[k] for k in (
                "schedule_ms", "pipeline_e2e_ms", "speculation",
                "done_at_fetch", "fetched", "dispatch_host_ms",
                "fetch_wait_ms", "cycles", "wall_s")},
            "serial": {"schedule_ms": wall["schedule_ms"],
                       "pipeline_e2e_ms": wall["pipeline_e2e_ms"],
                       "cycles": report["cycles"], "wall_s": wall_s,
                       "launches": launches}}
        print("pipelined backlog-16k pipelined vs serial:",
              json.dumps(side), flush=True)
    print("pipelined card:", card_line(), flush=True)
    timed = [r for r in decode_records if "ms" in r][0]
    return timed, decode_records, nosync, out


# ---------------------------------------------------------------------------
# elastic gangs and B6
# ---------------------------------------------------------------------------

# tools/sim_reference.py's elastic RUNS, each held to its entry in
# tests/sim_reference_digests.json: elastic-churn under the JAX sim's
# elastic conf and under deploy/scheduler.conf with elastic gangs (B6 at
# weight 10), each at weights 10 and 0, the latter at 10 with the switch
# off, and the full-width elastic-10k under it, the path's main run
ELASTIC_MAIN = "--trace elastic-10k --elastic-gangs --conf " \
    "conf:elastic-deployed-10"


def elastic_runs():
    tool, _ = sim_tools()
    return [r for r in tool.RUNS if "--elastic-gangs" in r[1]]


def compare_topo(label, args, zone, weight, timed=False):
    """place_topo_cuda against place_topo_plain on the same CUDA tensors,
    at the default plan and at every cluster size the card launches; with
    ``timed`` also both times, B1's time on the same inputs without the
    term (same call), the scorings the cache rule requires and the bound
    (place_bound's, with the zone column read once)."""
    import torch

    from volcano_tpu_torch.ops.place import (CLUSTER_SIZES, launch_plan,
                                             max_cluster, place_cuda,
                                             place_topo_cuda,
                                             place_topo_plain, task_rescores)
    got = place_topo_cuda(*args, zone, weight)
    torch.cuda.synchronize()
    plain = {}
    plain_ms = time_host_ms(lambda: plain.setdefault(
        "out", place_topo_plain(*args, zone, weight)))
    want = plain["out"]
    err = same_result(label, got, want)
    for c in [c for c in CLUSTER_SIZES if c <= max_cluster()]:
        err = max(err, same_result(
            f"{label} cluster {c}",
            place_topo_cuda(*args, zone, weight, cluster=c), want))
    torch.cuda.synchronize()
    words = got[0].cpu().numpy()
    flags = args[7].cpu().numpy()
    last = (flags & 4) != 0
    N, R = args[0].shape
    ms = args[10]
    plan = launch_plan(N, R, ms is not None, max_cluster(), topo=True)
    rec = {"world": label, "T": int(args[6].shape[0]), "N": int(N),
           "R": int(R), "weight": float(weight), "static": ms is not None,
           "zones": int(torch.unique(zone).numel()),
           "placed": int(((words & 1) != 0).sum()),
           "jobs": int(last.sum()),
           "rolled_back": int(((words[last] & 8) == 0).sum()),
           "max_abs_err": err, "cluster": plan.cluster,
           "in_smem": plan.in_smem}
    if timed:
        counts = task_rescores(words, flags, args[6].cpu().numpy(),
                               None if ms is None else ms.cpu().numpy(),
                               int(N), zone.cpu().numpy())
        b1_counts = task_rescores(
            place_cuda(*args)[0].cpu().numpy(), flags,
            args[6].cpu().numpy(), None if ms is None else ms.cpu().numpy(),
            int(N))
        rec.update(
            scored_pairs=int(counts.sum()),
            b1_scored_pairs=int(b1_counts.sum()),
            ms=time_cuda_ms(lambda: place_topo_cuda(*args, zone, weight)),
            b1_ms=time_cuda_ms(lambda: place_cuda(*args)),
            plain_ms=plain_ms)
        rec["bound_ms"], rec["bound_by"], _ = place_bound(args, counts,
                                                          zone=True)
    print("kernel place_topo", json.dumps(rec), flush=True)
    return rec


def topo_worlds(dev):
    """B6 against its plain version on tests/torch_parity.py's zone-anchor
    worlds (NumPy only) at their weights, and on a wide-ties world of 6,005
    nodes in 13 interleaved zones, whose default plan is a cluster."""
    sys.path.insert(0, os.path.join(_ROOT, "tests"))
    from torch_parity import TOPO_CASES, TOPO_WORLDS, topo_args
    out = []
    for name, weight in TOPO_CASES:
        args = topo_args(TOPO_WORLDS[name](), dev)
        out.append(compare_topo(f"{name}@{weight}", args[:12], args[12],
                                weight))
    w = wide_ties_world(2000, 4000)
    args = kernel_args(w, dev)
    import torch
    zone = torch.tensor(1 + np.arange(len(w["max_tasks"])) % 13,
                        dtype=torch.int32, device=dev)
    out.append(compare_topo("wide-ties-n6005@10", args, zone, 10.0))
    check(out[-1]["cluster"] > 1, "the 6,005-node world ran on one CTA")
    return out


def run_elastic(source, args, env, trace_dir):
    """One elastic run on the card with ``env`` set: the run_sim results,
    the tensor-path summary, and the arguments of each B6 launch the run's
    allocate solves made (cloned)."""
    from volcano_tpu_torch.actions import allocate
    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.ops import place as place_mod
    tool, traces = sim_tools()
    solves = []
    real = place_mod._place_launch

    def recorded(wrapper, *a):
        # a: place_cuda's twelve arguments, the cluster, the zone codes
        # and the weight
        if wrapper is place_mod.place_topo_cuda:
            solves.append(tuple(x.clone() if hasattr(x, "clone") else x
                                for x in a[:12] + a[13:]))
        return real(wrapper, *a)

    saved = {k: os.environ.get(k) for k, _ in env}
    os.environ.update(dict(env))
    place_mod._place_launch = recorded
    paths = traces.TensorPathRecorder(allocate, SchedulerCache)
    try:
        out = run_sim(None, tool.conf_args(args, trace_dir),
                      tool.sim_argv(source, trace_dir))
    finally:
        paths.close()
        place_mod._place_launch = real
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out, paths.summary(), solves


def elastic_phase(digests, sim_runs, runs=None, extra_args=()):
    """Step 16: B6 against its plain version on the zone-anchor worlds,
    then each elastic run on the card, held to the JAX package's record
    (plane, sequence, node-tensor paths), with every B6 solve a run made
    held against the plain version on its own inputs; the main run's first
    solve (elastic-10k: about 9,600 core members on 2,000 nodes in 125
    zones) timed beside B1 on the same inputs. Adds each run's launches to
    ``sim_runs``; returns the timed record, every B6 record and the runs'
    records."""
    import hashlib
    import tempfile

    from volcano_tpu_torch.framework import resolve_device
    from volcano_tpu_torch.sim.report import percentiles
    dev = resolve_device(None)
    records = topo_worlds(dev)
    tool, _ = sim_tools()
    out, timed = {}, None
    with tempfile.TemporaryDirectory() as trace_dir:
        for source, args, env in runs or elastic_runs():
            key = tool.run_key(source, args, env)
            (report, text, sequence, launches, wall_s), paths, solves = \
                run_elastic(source, (*args, *extra_args), env, trace_dir)
            want = digests[key]
            check(hashlib.sha256(text).hexdigest() == want["sha256"]
                  and len(text) == want["bytes"],
                  f"elastic {key}: decision plane differs from the JAX "
                  f"package's ({len(text)} bytes, want {want['bytes']})")
            check((sequence["sha256"], sequence["binds"],
                   sequence["evicts"])
                  == (want["sequence_sha256"], want["sequence_binds"],
                      want["sequence_evicts"]),
                  f"elastic {key}: a bind's node or an eviction differs "
                  f"from the JAX package's")
            check(paths == want["tensor_paths"],
                  f"elastic {key}: node-tensor paths {paths} differ from "
                  f"the JAX package's {want['tensor_paths']}")
            eg = report["elastic_gangs"]
            check(report["action_failures"] == 0
                  and report["double_binds"] == 0
                  and eg["below_min_evictions"] == 0,
                  f"elastic {key}: {report['action_failures']} action "
                  f"failures, {report['double_binds']} double binds, "
                  f"{eg['below_min_evictions']} below-min evictions")
            b6 = "conf:elastic-deployed-10" in args
            check(launches["place_topo"] == len(solves)
                  == (paths["solves"] if b6 else 0),
                  f"elastic {key}: B6 launched {launches['place_topo']} "
                  f"times for {paths['solves']} solves")
            check(b6 or "conf:elastic-deployed-0" not in args
                  or launches["place"] == paths["solves"] > 0,
                  f"elastic {key}: B1 launched {launches['place']} times")
            for k, a in enumerate(solves):
                rec = compare_topo(f"{source}-solve-{k}", a[:12], a[12],
                                   a[13], timed=key == ELASTIC_MAIN
                                   and k == 0)
                records.append(rec)
                if "ms" in rec:
                    timed = rec
            wall = report["wallclock"]
            rec = {
                "env": dict(env), "cycles": report["cycles"],
                "binds": report["binds"], "evicts": report["evicts"],
                "jobs": report["jobs"], "elastic_gangs": eg,
                "launches": launches, "b6_solves": len(solves),
                "schedule_ms": wall["schedule_ms"],
                "pipeline_e2e_ms": wall["pipeline_e2e_ms"],
                "actions_ms": wall["actions_ms"],
                "tensor_paths": {k: v for k, v in paths.items()
                                 if k != "sha256"},
                "wall_s": wall_s,
                "decision_plane_sha256": hashlib.sha256(text).hexdigest(),
                "sequence_sha256": sequence["sha256"]}
            out[key] = rec
            sim_runs[key] = launches
            print(f"elastic {key}:", json.dumps(rec), flush=True)
    check(timed is not None, "elastic: the main run made no B6 solve")
    print("elastic card:", card_line(), flush=True)
    return timed, records, out


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------

# tools/sim_reference.py's flight-recorder runs held here: the slice's full
# width (B1), preempt-burst (B3) and elastic-churn under the deployed
# elastic conf at weight 10 (B6); smoke and pipelined-conflict are the CPU
# tests'
OBS_SOURCES = ("baseline-10k", "preempt-burst", "elastic-churn")
# the recorder's cost: baseline-10k with audit and timelines on (the
# default) and off, alternated this many times each
OBS_OVERHEAD_REPS = 2


def obs_runs():
    tool, _ = sim_tools()
    return [r for r in tool.OBS_RUNS if r[0] in OBS_SOURCES]


def run_obs(source, args, env, trace_dir, extra_args=()):
    """One flight-recorder run (``--deterministic ... --trace-out FILE``)
    on the card through the sim's entry point, with the audit ring the
    run's environment names, each kernel's count set to 0 just before:
    the printed plane, the sequence digest, the launches, the node-tensor
    paths, the trace object, the recorder's state and the wall seconds."""
    import contextlib
    import io

    from volcano_tpu_torch import obs
    from volcano_tpu_torch.actions import allocate
    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.obs import audit
    from volcano_tpu_torch.obs import trace as obs_trace
    from volcano_tpu_torch.sim.__main__ import main as sim_main
    from volcano_tpu_torch.sim.report import sequence_digest
    tool, traces = sim_tools()
    path = os.path.join(trace_dir, "obs-trace.json")
    argv = [*tool.sim_argv(source, trace_dir), "--deterministic",
            *tool.conf_args(args, trace_dir), path, *extra_args]
    counters = kernel_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    obs.AUDIT.configure(int(dict(env)["VOLCANO_TPU_AUDIT_CYCLES"]))
    paths = traces.TensorPathRecorder(allocate, SchedulerCache)
    out = io.StringIO()
    runners = []
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = sim_main(argv, runners=runners)
        state = tool.recorder_state(obs)
    finally:
        wall_s = time.perf_counter() - t0
        paths.close()
        obs.AUDIT.configure(audit._default_cycles())
        obs.TRACE.configure(max_cycles=obs_trace.DEFAULT_MAX_CYCLES,
                            logical=False)
    launches = {k: w.launches for k, w in counters.items()}
    check(rc == 0, f"obs {source}: exit {rc}")
    with open(path) as f:
        trace = json.load(f)
    return (out.getvalue().encode(), sequence_digest(runners[0]), launches,
            paths.summary(), trace, state, wall_s)


def recorder_overhead(extra_args=()):
    """baseline-10k under deploy/scheduler.conf, without the recorder's
    flags, with the decision audit and the timelines recording (the
    default) and with both off (what VOLCANO_TPU_AUDIT_CYCLES=0 and
    VOLCANO_TPU_TIMELINE=0 give at start-up), alternated: each run's
    pipeline_e2e_ms p50 and p99."""
    from volcano_tpu_torch import obs
    from volcano_tpu_torch.obs import audit, lifecycle
    out = {"on": [], "off": []}
    for _ in range(OBS_OVERHEAD_REPS):
        for mode in ("on", "off"):
            if mode == "off":
                obs.AUDIT.configure(0)
                obs.TIMELINE.enabled = False
            try:
                report, _, _, _, wall_s = run_sim(
                    "baseline-10k",
                    ("--conf", "deploy/scheduler.conf", *extra_args))
            finally:
                obs.AUDIT.configure(audit._default_cycles())
                obs.TIMELINE.enabled = lifecycle._env_enabled()
            e2e = report["wallclock"]["pipeline_e2e_ms"]
            out[mode].append({"p50": e2e["p50"], "p99": e2e["p99"],
                              "wall_s": wall_s})
    return out


def obs_phase(digests, sim_runs, runs=None, extra_args=()):
    """Step 17: each flight-recorder run on the card, held to the JAX
    package's records (the report with its latency and slo sections, the
    sequence, the node-tensor paths, and the trace, audit and timeline
    digests), its trace checked by ``validate_chrome_trace``, and without
    the latency and slo sections the plane and sequence of the run without
    the flags, whose launches (counted in an earlier phase) each kernel
    must repeat; then the recorder's on/off cost at baseline-10k. Adds each
    run's launches to ``sim_runs``; returns the runs' records and the
    overhead."""
    import hashlib
    import tempfile

    from volcano_tpu_torch.obs import validate_chrome_trace
    tool, _ = sim_tools()
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as trace_dir:
        for source, args, env in runs or obs_runs():
            key = tool.run_key(source, args, env)
            plain = tool.run_key(source, tuple(
                a for a in args if a not in tool.OBS))
            text, sequence, launches, paths, trace, state, wall_s = \
                run_obs(source, args, env, trace_dir, extra_args)
            want = digests[key]
            check(hashlib.sha256(text).hexdigest() == want["sha256"]
                  and len(text) == want["bytes"],
                  f"obs {key}: report differs from the JAX package's "
                  f"({len(text)} bytes, want {want['bytes']})")
            check((sequence["sha256"], sequence["binds"],
                   sequence["evicts"])
                  == (want["sequence_sha256"], want["sequence_binds"],
                      want["sequence_evicts"]),
                  f"obs {key}: a bind's node or an eviction differs from "
                  f"the JAX package's")
            check(paths == want["tensor_paths"],
                  f"obs {key}: node-tensor paths differ from the JAX "
                  f"package's")
            got = tool.obs_digests(trace, *state)
            check(got == want["obs"],
                  f"obs {key}: recorder digests {got} differ from the JAX "
                  f"package's {want['obs']}")
            spans = validate_chrome_trace(trace)
            report = json.loads(text)
            report.pop("latency")
            report.pop("slo")
            stripped = (json.dumps(report, sort_keys=True,
                                   separators=(",", ":")) + "\n").encode()
            check(hashlib.sha256(stripped).hexdigest()
                  == digests[plain]["sha256"]
                  and sequence["sha256"]
                  == digests[plain]["sequence_sha256"],
                  f"obs {key}: the flags changed the decision plane")
            base = sim_runs.get(plain, sim_runs.get(source))
            check(base is not None and launches == base,
                  f"obs {key}: launches {launches} differ from the run "
                  f"without the flags {base}")
            check(report["action_failures"] == 0
                  and report["double_binds"] == 0,
                  f"obs {key}: {report['action_failures']} action "
                  f"failures, {report['double_binds']} double binds")
            rec = {"cycles": report["cycles"], "binds": report["binds"],
                   "evicts": report["evicts"], "launches": launches,
                   "spans": spans, **got, "wall_s": wall_s}
            out[key] = rec
            sim_runs["obs " + source] = launches
            print(f"obs {key}:", json.dumps(rec), flush=True)
        overhead = recorder_overhead(extra_args)
    print("obs overhead baseline-10k pipeline_e2e_ms:",
          json.dumps(overhead), flush=True)
    print(f"obs phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    print("obs card:", card_line(), flush=True)
    return out, overhead


# ---------------------------------------------------------------------------
# device containment
# ---------------------------------------------------------------------------

# the containment counters as step 18 left them: every other phase must end
# with the same counts (no fallback nobody asked for)
_CONTAINMENT_MARK: dict = {}


def containment_counts() -> dict:
    """The nonzero solver-fallback, device-fault and degraded-cycle
    counters (volcano_tpu_torch.metrics), flat."""
    from volcano_tpu_torch import metrics
    return {k: v for k, v in metrics.containment_counts().items() if v}


def check_contained(label: str) -> None:
    """The end of a phase that injects no fault: the containment counters
    are where the containment phase left them (0 before it), the device
    cool-down is closed and no fault hook is installed."""
    from volcano_tpu_torch.actions import allocate
    from volcano_tpu_torch.device_health import DEVICE_HEALTH
    got = containment_counts()
    check(got == _CONTAINMENT_MARK and DEVICE_HEALTH.available()
          and allocate.DEVICE_FAULT_HOOK is None,
          f"{label}: containment counters {got} (want "
          f"{_CONTAINMENT_MARK}), device available "
          f"{DEVICE_HEALTH.available()}: a fallback nobody asked for")


def card_oom() -> None:
    """A real out-of-memory error from the card: ask the caching
    allocator for more bytes than the card holds."""
    import torch
    total = torch.cuda.get_device_properties(0).total_memory
    torch.empty(total + (1 << 30), dtype=torch.uint8, device="cuda")


def injected_oom() -> None:
    from volcano_tpu_torch.device_health import DeviceFaultError
    raise DeviceFaultError("oom")


def containment_drive(device, oom) -> list:
    """Three cycles of deploy/scheduler.conf on baseline_config("1k") on
    ``device`` (None: the card), the allocate hook calling ``oom`` at its
    first solve attempt, 40 late pods in 10 gangs added after each cycle,
    the cool-down on a virtual clock moved past its window before cycle
    3. Returns each cycle's new binds, B1 launches, hook calls,
    LAST_FALLBACK, ``last_stats["fallback"]``, availability, the
    ``device`` section of health_detail() and the counter deltas."""
    from volcano_tpu_torch import Scheduler, metrics
    from volcano_tpu_torch.actions import allocate
    from volcano_tpu_torch.cache.synthetic import baseline_config, make_jobs
    from volcano_tpu_torch.device_health import DEVICE_HEALTH
    clock = [0.0]
    DEVICE_HEALTH.reset(time_fn=lambda: clock[0])
    cache, binder, _ = baseline_config("1k")
    queues = sorted(cache.queues)
    sched = Scheduler(cache, deployed_conf(), device=device)
    calls = []

    def hook(engine):
        calls.append(engine)
        if len(calls) == 1:
            oom()

    counters = kernel_counters()
    mark = dict(metrics.containment_counts())
    allocate.DEVICE_FAULT_HOOK = hook
    cycles = []
    try:
        for cyc in range(3):
            if cyc == 2:
                clock[0] += DEVICE_HEALTH.cooldown_remaining() + 1.0
            for wrapper in counters.values():
                wrapper.launches = 0
            before, n_calls = dict(binder.binds), len(calls)
            errors = sched.run_once()
            check(errors == [], f"containment cycle {cyc + 1}: isolated "
                                f"action failures "
                                f"{[(n, repr(e)) for n, e in errors]}")
            now = metrics.containment_counts()
            alloc = [a for a in sched.actions if a.name() == "allocate-tpu"]
            cycles.append({
                "binds": {k: v for k, v in binder.binds.items()
                          if k not in before},
                "place": counters["place"].launches,
                "hook_calls": len(calls) - n_calls,
                "fallback": dict(allocate.LAST_FALLBACK),
                "last_stats_fallback": alloc[0].last_stats.get("fallback"),
                "available": DEVICE_HEALTH.available(),
                "health_device": metrics.health_detail()["device"],
                "counts": {k: now[k] - mark.get(k, 0) for k in now
                           if now[k] != mark.get(k, 0)},
            })
            mark = dict(now)
            for job in make_jobs(40, 10, queues, seed=100 + cyc,
                                 name_prefix=f"late{cyc}-"):
                cache.add_job(job)
    finally:
        allocate.DEVICE_FAULT_HOOK = None
        DEVICE_HEALTH.reset(time_fn=time.monotonic)
    return cycles


class _FailingPlaceLib:
    """The placement library with its launch entry failing as the card
    would report a failed launch (cudaErrorLaunchFailure, 719), without
    launching; every other entry is the real one."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def vt_place(self, *args):
        return 719


# the child's allocate-only pipeline: nothing after allocate touches the
# card whose context the child's fault leaves dead
_SYNC_CHILD_CONF = SLICE_CONF.replace(
    'actions: "enqueue, allocate-tpu, backfill"',
    'actions: "enqueue, allocate-tpu"')
_SYNC_CHILD_FLAG = "--cuda-error-at-sync"


def cuda_error_child() -> int:
    """One cycle of baseline_config("1k") whose solve launches B1, then
    gathers at an index past its tensor on the card and synchronizes: a
    real device-side assert, raised by the card at the sync as a faulty
    kernel's would be. Prints one JSON line of the cycle's isolated
    failures, B1 launches, binds, LAST_FALLBACK, the cool-down and the
    counters, then leaves without tearing down the dead context."""
    import torch

    from volcano_tpu_torch import Scheduler, metrics
    from volcano_tpu_torch.actions import allocate
    from volcano_tpu_torch.cache.synthetic import baseline_config
    from volcano_tpu_torch.device_health import DEVICE_HEALTH
    counters = kernel_counters()
    real_place = allocate.place

    def place_then_sync(*args, **kwargs):
        res = real_place(*args, **kwargs)
        row = torch.zeros(4, device=res.idle.device)
        index = torch.full((1,), 1 << 20, dtype=torch.long,
                           device=res.idle.device)
        row[index]
        torch.cuda.synchronize()
        return res

    allocate.place = place_then_sync
    cache, binder, _ = baseline_config("1k")
    sched = Scheduler(cache, _SYNC_CHILD_CONF, device=None)
    for wrapper in counters.values():
        wrapper.launches = 0
    try:
        errors = [(n, type(e).__name__, str(e).splitlines()[0][:120])
                  for n, e in sched.run_once()]
        raised = None
    except BaseException as exc:       # reported, judged by the parent
        errors, raised = [], f"{type(exc).__name__}: {exc}"[:300]
    print("cuda-error-child:", json.dumps({
        "errors": errors, "raised": raised,
        "place": counters["place"].launches, "binds": len(binder.binds),
        "fallback": dict(allocate.LAST_FALLBACK),
        "available": DEVICE_HEALTH.available(),
        "last_kind": DEVICE_HEALTH.detail()["last_kind"],
        "counts": containment_counts()}), flush=True)
    sys.stdout.flush()
    os._exit(0)


def cuda_error_at_sync() -> dict:
    """Runs ``cuda_error_child`` in a process of its own (the fault kills
    its CUDA context) and returns its record."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          _SYNC_CHILD_FLAG], cwd=_ROOT, capture_output=True,
                         text=True, timeout=300)
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("cuda-error-child: ")]
    check(out.returncode == 0 and len(lines) == 1,
          f"containment cuda error at sync: the child exited "
          f"{out.returncode}: {out.stdout[-800:]} {out.stderr[-1500:]}")
    return json.loads(lines[0].split(": ", 1)[1])


def containment_phase():
    """Step 18; returns the card's cycles and the deadline, launch
    failure and CUDA-error-at-sync records."""
    import torch

    from volcano_tpu_torch import Scheduler, metrics
    from volcano_tpu_torch.actions import allocate
    from volcano_tpu_torch.cache.synthetic import baseline_config
    from volcano_tpu_torch.device_health import DEVICE_HEALTH
    from volcano_tpu_torch.ops import place as place_mod
    from volcano_tpu_torch.ops.build import KernelError
    global _CONTAINMENT_MARK
    t_phase = time.perf_counter()
    card = containment_drive(None, card_oom)
    torch.cuda.empty_cache()
    cpu = containment_drive("cpu", injected_oom)
    for i, (c, h) in enumerate(zip(card, cpu)):
        check(c["binds"] == h["binds"],
              f"containment cycle {i + 1}: the card's binds differ from "
              f"the CPU path's under the same script")
        check(c["counts"] == h["counts"] and c["available"] == h["available"]
              and c["hook_calls"] == h["hook_calls"],
              f"containment cycle {i + 1}: card {c['counts']} "
              f"available={c['available']} against the CPU path's "
              f"{h['counts']} available={h['available']}")
    c1, c2, c3 = card
    check("OutOfMemoryError" in c1["fallback"].get("error", "")
          and c1["fallback"].get("engine") == "tpu-fused"
          and c1["last_stats_fallback"] == c1["fallback"]
          and c1["counts"] == {"solver_fallback/allocate-tpu": 1,
                               "device_faults/oom": 1}
          and not c1["available"] and c1["place"] == 0
          and c1["hook_calls"] == 1 and c1["binds"]
          and c1["health_device"]["last_kind"] == "oom",
          f"containment cycle 1: the card's OOM was not contained as "
          f"an oom fallback: {json.dumps(c1, default=str)[:600]}")
    check(c2["fallback"] == {"engine": "tpu-fused",
                             "error": "device cool-down"}
          and c2["counts"] == {"device_degraded_cycles": 1}
          and c2["hook_calls"] == 0 and c2["place"] == 0
          and not c2["available"] and c2["binds"],
          f"containment cycle 2: not a degraded cycle: "
          f"{json.dumps(c2, default=str)[:600]}")
    check(c3["fallback"] == {} and c3["counts"] == {}
          and c3["hook_calls"] == 1 and c3["place"] > 0
          and c3["available"] and c3["binds"]
          and c3["health_device"]["consecutive_faults"] == 0,
          f"containment cycle 3: the probe did not launch B1 and close "
          f"the window: {json.dumps(c3, default=str)[:600]}")
    counters = kernel_counters()
    # a hard solve deadline no solve meets opens the window
    DEVICE_HEALTH.reset(time_fn=time.monotonic)
    mark = dict(metrics.containment_counts())
    cache, _, _ = baseline_config("1k")
    sched = Scheduler(cache, deployed_conf(), device=None,
                      solve_deadline_s=1e-9)
    for wrapper in counters.values():
        wrapper.launches = 0
    errors = sched.run_once()
    now = metrics.containment_counts()
    deadline = {"errors": [n for n, _ in errors],
                "place": counters["place"].launches,
                "available": DEVICE_HEALTH.available(),
                "last_kind": DEVICE_HEALTH.detail()["last_kind"],
                "counts": {k: now[k] - mark.get(k, 0) for k in now
                           if now[k] != mark.get(k, 0)}}
    check(deadline["errors"] == [] and deadline["place"] > 0
          and not deadline["available"]
          and deadline["counts"] == {"device_faults/slow_solve": 1},
          f"containment deadline: {deadline}")
    DEVICE_HEALTH.reset(time_fn=time.monotonic)
    # a launch the C entry fails stays a failed action, no fallback
    mark = dict(metrics.containment_counts())
    real_lib = place_mod._lib
    place_mod._lib = lambda: _FailingPlaceLib(real_lib())
    try:
        cache, binder, _ = baseline_config("1k")
        sched = Scheduler(cache, deployed_conf(), device=None)
        for wrapper in counters.values():
            wrapper.launches = 0
        errors = sched.run_once()
    finally:
        place_mod._lib = real_lib
    now = metrics.containment_counts()
    launch = {"errors": [(n, type(e).__name__, str(e)[:120])
                         for n, e in errors],
              "place": counters["place"].launches,
              "binds": len(binder.binds),
              "available": DEVICE_HEALTH.available(),
              "fallback": dict(allocate.LAST_FALLBACK),
              "counts": {k: now[k] - mark.get(k, 0) for k in now
                         if now[k] != mark.get(k, 0)}}
    check([n for n, *_ in launch["errors"]] == ["allocate-tpu"]
          and isinstance(errors[0][1], KernelError)
          and "719" in str(errors[0][1])
          and launch["counts"] == {} and launch["available"]
          and launch["fallback"] == {} and launch["place"] == 0
          and launch["binds"] == 0,
          f"containment launch failure: {launch}")
    # a CUDA error the card raises at a sync after B1 launched fails the
    # action: counted and cooling down, but no fallback
    sync = cuda_error_at_sync()
    check(sync["raised"] is None
          and [n for n, *_ in sync["errors"]] == ["allocate-tpu"]
          and "device-side assert" in sync["errors"][0][2]
          and sync["counts"] == {"device_faults/device_lost": 1}
          and sync["fallback"] == {} and not sync["available"]
          and sync["last_kind"] == "device_lost"
          and sync["place"] > 0 and sync["binds"] == 0,
          f"containment cuda error at sync: {sync}")
    _CONTAINMENT_MARK = containment_counts()
    for i, c in enumerate(card):
        print(f"containment cycle {i + 1}:", json.dumps({
            "binds": len(c["binds"]), "place_launches": c["place"],
            "hook_calls": c["hook_calls"], "fallback": c["fallback"],
            "available": c["available"], "counts": c["counts"],
            "device": c["health_device"]}, default=str), flush=True)
    print("containment deadline:", json.dumps(deadline), flush=True)
    print("containment launch failure:", json.dumps(launch), flush=True)
    print("containment cuda error at sync:", json.dumps(sync), flush=True)
    print(f"containment phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    print("containment card:", card_line(), flush=True)
    return card, deadline, launch


# ---------------------------------------------------------------------------
# the object store and the feedback watch path
# ---------------------------------------------------------------------------

# baseline-10k's direct-mode pipeline_e2e_ms and wall seconds from step
# 12, beside which steps 19 and 22 print the store-wired and federated
# runs' own
_DIRECT_E2E: dict = {}


def store_phase(digests, sim_runs, runs=None, extra_args=()):
    """Step 19: each store-wired or ack-chaos run on the card, held to the
    JAX package's report and sequence; adds each run's launches to
    ``sim_runs`` and returns the runs' records."""
    import hashlib
    tool, _ = sim_tools()
    t_phase = time.perf_counter()
    out = {}
    for source, args, env in runs or tool.STORE_RUNS:
        key = tool.run_key(source, args, env)
        report, text, sequence, launches, wall_s = run_sim(
            source, tuple(args) + tuple(extra_args))
        want = digests[key]
        check(hashlib.sha256(text).hexdigest() == want["sha256"]
              and len(text) == want["bytes"],
              f"store {key}: report differs from the JAX package's "
              f"({len(text)} bytes, want {want['bytes']})")
        check((sequence["sha256"], sequence["binds"], sequence["evicts"])
              == (want["sequence_sha256"], want["sequence_binds"],
                  want["sequence_evicts"]),
              f"store {key}: a bind's node or an eviction differs from the "
              f"JAX package's ({sequence['binds']} binds, "
              f"{sequence['evicts']} evicts)")
        check(report["action_failures"] == 0
              and report["double_binds"] == 0,
              f"store {key}: {report['action_failures']} action failures, "
              f"{report['double_binds']} double binds")
        check(launches["place"] > 0,
              f"store {key}: the placement kernel never launched")
        if source == "preempt-burst":
            check(launches["evict_walk"] > 0,
                  f"store {key}: the preempt walk never launched")
        if "--pipelined" in args:
            check(launches["decode_packed"] > 0,
                  f"store {key}: the speculative decode never launched")
        wall = report["wallclock"]
        rec = {"cycles": report["cycles"], "binds": report["binds"],
               "evicts": report["evicts"], "jobs": report["jobs"],
               "B1": launches["place"], "B3": launches["evict_walk"],
               "B7": launches["decode_packed"],
               "store": report.get("store"),
               "feedback": report.get("feedback"),
               "pipeline_e2e_ms": wall["pipeline_e2e_ms"],
               "schedule_ms": wall["schedule_ms"], "wall_s": wall_s}
        out[key] = rec
        sim_runs["store " + key] = launches
        print(f"store {key}:", json.dumps(rec), flush=True)
    base = "--scenario baseline-10k --conf deploy/scheduler.conf"
    wired = out.get(base + " --store-wired")
    if wired is not None and _DIRECT_E2E:
        print("store baseline-10k pipeline_e2e_ms:", json.dumps({
            "store_wired": wired["pipeline_e2e_ms"],
            "direct": _DIRECT_E2E["pipeline_e2e_ms"]}), flush=True)
    print(f"store phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    print("store card:", card_line(), flush=True)
    return out


# ---------------------------------------------------------------------------
# the HA control plane
# ---------------------------------------------------------------------------

# the preempt walk's dispatches (B3 launches on the card) the CPU path
# counts in each HA run that preempts; tests/test_torch_sim_ha.py holds the
# same counts on the CPU
HA_CPU_WALKS = {
    "--scenario preempt-burst --conf deploy/scheduler.conf --ha 3 "
    "--kill-cycles 10,30,47 --kill-seed 2 --lease-loss-cycles 20": 33,
}


def run_ha(source, args, extra_args=()):
    """One HA run (three replicas over one cluster) on the card through the
    sim's entry point: run_sim's results, the summary of the solves'
    node-tensor paths, each handoff (the new leader's startup_reconcile in
    ms with its report, then the host ms of its first tensor refresh, a
    full build on the card, synchronized), and each crash restart: whether
    the killed replica held persistent node tensors, whether they were
    freed by the end of that cycle (after the crashed cycle's frames are
    gone), and the card's allocated bytes before the restart and then."""
    import gc
    import weakref

    import torch

    from volcano_tpu_torch import scheduler as shell
    from volcano_tpu_torch.actions import allocate
    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.sim.runner import SimRunner
    _, traces = sim_tools()
    handoffs, restarts = [], []
    real_reconcile = shell.Scheduler.startup_reconcile
    real_refresh = SchedulerCache.tensor_refresh
    real_restart = SimRunner._crash_restart_replica
    real_account = SimRunner._account_leadership

    def timed_reconcile(sched, *a, **kw):
        t0 = time.perf_counter()
        rpt = real_reconcile(sched, *a, **kw)
        handoffs.append({
            "replica": getattr(sched.elector, "identity", None),
            "epoch": sched.current_fencing_epoch(),
            "reconcile_ms": (time.perf_counter() - t0) * 1e3,
            "report": rpt.as_dict() if rpt is not None else None,
            "build_ms": None})
        return rpt

    def timed_refresh(cache, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tc = real_refresh(cache, *a, **kw)
        torch.cuda.synchronize()
        if tc is not None and tc.last_refresh["full"] and handoffs \
                and handoffs[-1]["build_ms"] is None:
            handoffs[-1]["build_ms"] = (time.perf_counter() - t0) * 1e3
            handoffs[-1]["rows"] = tc.last_refresh["rows"]
        return tc

    def counted_restart(runner, rep, mode):
        tc = rep.cache.tensor_cache
        restarts.append({"replica": rep.key(), "mode": mode,
                         "had_tensors": tc is not None,
                         "ref": weakref.ref(tc) if tc is not None else None,
                         "allocated_before": torch.cuda.memory_allocated(),
                         "allocated_after": None, "freed": None})
        del tc
        real_restart(runner, rep, mode)

    def accounted(runner):
        # the end of the cycle's replica loop: a killed replica's frames
        # are gone, so its tensors must be too
        for r in restarts:
            if r["allocated_after"] is None:
                gc.collect()
                r["freed"] = r["ref"] is None or r["ref"]() is None
                r["allocated_after"] = torch.cuda.memory_allocated()
                r["ref"] = None
        return real_account(runner)

    shell.Scheduler.startup_reconcile = timed_reconcile
    SchedulerCache.tensor_refresh = timed_refresh
    SimRunner._crash_restart_replica = counted_restart
    SimRunner._account_leadership = accounted
    paths = traces.TensorPathRecorder(allocate, SchedulerCache)
    try:
        out = run_sim(source, tuple(args) + tuple(extra_args))
    finally:
        paths.close()
        shell.Scheduler.startup_reconcile = real_reconcile
        SchedulerCache.tensor_refresh = real_refresh
        SimRunner._crash_restart_replica = real_restart
        SimRunner._account_leadership = real_account
    return out, paths.summary(), handoffs, restarts


def ha_phase(digests, sim_runs, runs=None, extra_args=()):
    """Step 20: each HA run of tools/sim_reference.py's HA_RUNS on the card,
    held to the JAX package's report, sequence and solve-by-solve
    node-tensor path; B1 launches once a solve (the JAX package's count)
    and B3 as the CPU path counts; no double bind, no action failure,
    failover within three cycles, and a crash restart drops the killed
    replica's device tensors. Adds each run's launches to ``sim_runs`` and
    returns the runs' records."""
    import gc
    import hashlib

    import torch
    tool, _ = sim_tools()
    t_phase = time.perf_counter()
    out = {}
    for source, args, env in runs or tool.HA_RUNS:
        key = tool.run_key(source, args, env)
        gc.collect()
        mem0 = torch.cuda.memory_allocated()
        (report, text, sequence, launches, wall_s), paths, handoffs, \
            restarts = run_ha(source, args, extra_args)
        gc.collect()
        mem1 = torch.cuda.memory_allocated()
        want = digests[key]
        check(hashlib.sha256(text).hexdigest() == want["sha256"]
              and len(text) == want["bytes"],
              f"ha {key}: report differs from the JAX package's "
              f"({len(text)} bytes, want {want['bytes']})")
        check((sequence["sha256"], sequence["binds"], sequence["evicts"])
              == (want["sequence_sha256"], want["sequence_binds"],
                  want["sequence_evicts"]),
              f"ha {key}: a bind's node or an eviction differs from the "
              f"JAX package's ({sequence['binds']} binds, "
              f"{sequence['evicts']} evicts)")
        check(paths == want["tensor_paths"],
              f"ha {key}: node-tensor path {paths} differs from the JAX "
              f"package's {want['tensor_paths']}")
        ha = report["ha"]
        check(report["action_failures"] == 0
              and report["double_binds"] == 0
              and report["jobs"]["completed"] == report["jobs"]["arrived"]
              and ha["failover_cycles_max"] <= 3,
              f"ha {key}: {report['action_failures']} action failures, "
              f"{report['double_binds']} double binds, jobs "
              f"{report['jobs']}, failover {ha}")
        check(launches["place"] == want["tensor_paths"]["solves"],
              f"ha {key}: B1 launched {launches['place']} times, the "
              f"solves {want['tensor_paths']['solves']}")
        check(launches["evict_walk"] == HA_CPU_WALKS.get(key, 0),
              f"ha {key}: B3 launched {launches['evict_walk']} times, the "
              f"CPU path {HA_CPU_WALKS.get(key, 0)}")
        if "--lease-fault-rate" in args:
            check(report["failovers"] > 0,
                  f"ha {key}: the lease faults caused no failover")
        if source == "baseline-10k":
            check(report["journal_replayed"].get("replayed", 0) > 0,
                  f"ha {key}: the kill settled no crash window "
                  f"({report['journal_replayed']})")
        for r in restarts:
            check(r["freed"] and r["allocated_after"]
                  <= r["allocated_before"],
                  f"ha {key}: a crash restart kept the killed replica's "
                  f"device tensors ({r})")
        check(mem1 <= mem0, f"ha {key}: {mem1 - mem0} bytes of card "
                            f"memory outlived the run")
        wall = report["wallclock"]
        rec = {"cycles": report["cycles"], "binds": report["binds"],
               "evicts": report["evicts"], "jobs": report["jobs"],
               "wall_s": wall_s,
               "pipeline_e2e_ms": wall["pipeline_e2e_ms"],
               "schedule_ms": wall["schedule_ms"],
               "failovers": report["failovers"],
               "failover_cycles": ha["failover_cycles"],
               "restarts": report["restarts"],
               "journal_replayed": report["journal_replayed"],
               "fenced_rejections": report["fenced_rejections"],
               "B1": launches["place"], "B3": launches["evict_walk"],
               "solves": paths["solves"], "full_builds": paths["full"],
               "allocated_before": mem0, "allocated_after": mem1,
               "restart_allocated": [(r["had_tensors"],
                                      r["allocated_before"],
                                      r["allocated_after"])
                                     for r in restarts]}
        if source == "baseline-10k":
            takeovers = [h for h in handoffs if h["report"]
                         and h["report"]["replayed"]]
            rec["handoffs"] = [{
                k: h[k] for k in ("replica", "epoch", "reconcile_ms",
                                  "build_ms", "report")} for h in takeovers]
            rec["handoff_ms"] = [h["reconcile_ms"] + (h["build_ms"] or 0.0)
                                 for h in takeovers]
        out[key] = rec
        sim_runs["ha " + key] = launches
        print(f"ha {key}:", json.dumps(rec), flush=True)
    print(f"ha phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    print("ha card:", card_line(), flush=True)
    return out


# ---------------------------------------------------------------------------
# overload and the federated control plane
# ---------------------------------------------------------------------------

# the preempt walk's dispatches (B3 launches on the card) the CPU path
# counts in the overload and federated runs under deploy/scheduler.conf
# that preempt (both runs of a verifier's pair counted); the store-backed
# smoke and baseline-10k over four partitions walk none, which
# tests/test_torch_sim_federated.py holds on the CPU for the smoke
PARTITIONED_CPU_WALKS = {
    "--scenario overload-burst --seed 3 --conf deploy/scheduler.conf "
    "--overload-chaos --kill-cycles 2,5,9,13 --kill-seed 1": 173,
    "--scenario fed-starve --seed 3 --conf deploy/scheduler.conf "
    "--federated 4 --verify-federated-equivalence": 762,
    "--scenario diurnal-flash-crowd --seed 3 --conf deploy/scheduler.conf "
    "--federated 1 --elastic --overload-chaos": 455,
}


def run_partitioned(source, args, env, trace_dir, extra_args=()):
    """One overload, federated or elastic run on the card through the
    sim's entry point, with the environment's timeline ring and audit ring
    applied to the live objects (what the variables set at start-up):
    run_sim's results, the summary of the solves' node-tensor paths, B1's
    launches by partition (counted around each partition's run_once, a
    newborn's too), each crash restart's card memory on either side of the
    restart and the bytes of the killed shell's node rows, each elastic
    merge's retired node rows and whether they were freed by the end of
    that cycle, the virtual cycles' summed times, and for a run ending in
    ``--trace-out`` the trace and the recorder's state."""
    import gc
    import weakref

    import torch

    from volcano_tpu_torch import obs
    from volcano_tpu_torch import scheduler as shell
    from volcano_tpu_torch.actions import allocate
    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.obs import audit
    from volcano_tpu_torch.obs import trace as obs_trace
    from volcano_tpu_torch.ops.place import place_cuda
    from volcano_tpu_torch.sim.runner import SimRunner
    tool, traces = sim_tools()
    env = dict(env)
    argv = list(args)
    path = None
    if argv[-1:] == ["--trace-out"]:
        # the recorder's logical clock, so the trace is the JAX package's
        path = os.path.join(trace_dir, "partitioned-trace.json")
        argv = ["--deterministic", *argv, path]
    by_part: dict = {}
    restarts = []
    retires: list = []
    real_run_once = shell.Scheduler.run_once
    real_restarts = {name: getattr(SimRunner, name) for name in
                     ("_crash_restart", "_crash_restart_partition")}

    # a sample a virtual cycle of the federated plane: the sum of its
    # partitions' run_once times (a killed one's too), the unit of a direct
    # run's pipeline_e2e_ms, which the report samples a partition leader
    cycle_ms: list = []
    real_fed_cycle = SimRunner._federated_cycle
    real_retire = SimRunner._retire_partition
    # an elastic merge reaps a partition from inside its own run_once (its
    # cycle-end step), whose frames still hold that cycle's session: the
    # reaped shell's device tensors must be gone once the cycle returns
    retiring: list = []

    def timed_fed_cycle(runner, now):
        cycle_ms.append(0.0)
        out = real_fed_cycle(runner, now)
        if retiring:
            gc.collect()
            for rec, refs in retiring:
                rec["allocated_after"] = torch.cuda.memory_allocated()
                rec["freed"] = all(w() is None for w in refs)
                retires.append(rec)
            retiring.clear()
        return out

    def counted_retire(runner, pid):
        rep = next((r for r in runner.replicas if r.ix == pid), None)
        tc = rep.cache.tensor_cache if rep is not None else None
        device = list((tc._device or {}).values()) if tc is not None \
            else []
        rec = {"pid": pid, "had_tensors": tc is not None,
               "device_bytes": sum({t.untyped_storage().data_ptr():
                                    t.untyped_storage().nbytes()
                                    for t in device}.values()),
               "allocated_before": torch.cuda.memory_allocated()}
        refs = [weakref.ref(t) for t in device] + (
            [weakref.ref(tc)] if tc is not None else [])
        del tc, device, rep
        out = real_retire(runner, pid)
        retiring.append((rec, refs))
        return out

    def counted_run_once(sched):
        before = place_cuda.launches
        t0 = time.perf_counter()
        try:
            return real_run_once(sched)
        finally:
            if sched.federation is not None:
                cycle_ms[-1] += (time.perf_counter() - t0) * 1e3
            pid = sched.federation.pid if sched.federation is not None \
                else "single"
            by_part[pid] = by_part.get(pid, 0) \
                + place_cuda.launches - before

    def restart_hook(name):
        real = real_restarts[name]

        def counted(runner, *a):
            # the killed cycle's finished frames hold its session's tensors
            # until the runner's except block ends: cleared here, the card
            # memory on either side of the restart is the restart's own,
            # with no other partition's cycle in between
            exc = sys.exc_info()[1]
            if exc is not None:
                traceback.clear_frames(exc.__traceback__)
            del exc
            rep = a[0] if name == "_crash_restart_partition" else None
            cache = rep.cache if rep is not None else runner.cache
            tc = cache.tensor_cache
            device = list((tc._device or {}).values()) if tc is not None \
                else []
            storages = {t.untyped_storage().data_ptr():
                        t.untyped_storage().nbytes() for t in device}
            rec = {"mode": a[-1] if a else None,
                   "had_tensors": tc is not None,
                   "device_bytes": sum(storages.values())}
            refs = [weakref.ref(t) for t in device] + (
                [weakref.ref(tc)] if tc is not None else [])
            del tc, device, cache, rep
            gc.collect()
            rec["allocated_before"] = torch.cuda.memory_allocated()
            out = real(runner, *a)
            gc.collect()
            rec["allocated_after"] = torch.cuda.memory_allocated()
            rec["freed"] = all(w() is None for w in refs)
            restarts.append(rec)
            return out
        return counted

    events = obs.TIMELINE.max_events
    obs.TIMELINE.max_events = int(env.get("VOLCANO_TPU_TIMELINE_EVENTS",
                                          events))
    obs.AUDIT.configure(int(env.get("VOLCANO_TPU_AUDIT_CYCLES",
                                    audit._default_cycles())))
    shell.Scheduler.run_once = counted_run_once
    SimRunner._federated_cycle = timed_fed_cycle
    SimRunner._retire_partition = counted_retire
    for name in real_restarts:
        setattr(SimRunner, name, restart_hook(name))
    paths = traces.TensorPathRecorder(allocate, SchedulerCache)
    try:
        out = run_sim(source, tuple(argv) + tuple(extra_args))
        state = tool.recorder_state(obs) if path else None
    finally:
        paths.close()
        shell.Scheduler.run_once = real_run_once
        SimRunner._federated_cycle = real_fed_cycle
        SimRunner._retire_partition = real_retire
        for name, real in real_restarts.items():
            setattr(SimRunner, name, real)
        obs.TIMELINE.max_events = events
        obs.AUDIT.configure(audit._default_cycles())
        obs.TRACE.configure(max_cycles=obs_trace.DEFAULT_MAX_CYCLES,
                            logical=False)
    trace = None
    if path is not None:
        with open(path) as f:
            trace = json.load(f)
    return (out, paths.summary(), by_part, restarts, retires, cycle_ms, trace,
            state)


def partitioned_phase(kind, runs, digests, sim_runs, extra_args=()):
    """Steps 21 and 22: each run of ``runs`` (tools/sim_reference.py's
    OVERLOAD_RUNS or FEDERATED_RUNS) on the card, held to the JAX package's
    report, sequence and solve-by-solve node-tensor path (each partition's
    too; where one of the JAX package's faults that the port fixes fired,
    the package with it mended: ``held_to``), and for the merged trace its
    recorder digests and
    flow arcs; B1 launches once a solve, B3 as the CPU path counts; no
    double bind, no action failure, every admitted gang completed, the
    cycle spend within twice the budget, the priority-aware shed fired on
    overload-burst, the rebalancer's moves converged on fed-hotspot, a
    crash restart drops the killed shell's device tensors, and no card
    memory outlives a run. Adds each run's launches to ``sim_runs`` and
    returns the runs' records."""
    import gc
    import hashlib
    import tempfile

    import torch

    from volcano_tpu_torch.obs import validate
    from volcano_tpu_torch.sim.report import percentiles
    tool, _ = sim_tools()
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as trace_dir:
        for run in runs:
            source, args, env = run
            key = tool.run_key(*run)
            gc.collect()
            mem0 = torch.cuda.memory_allocated()
            (report, text, sequence, launches, wall_s), paths, by_part, \
                restarts, retires, cycle_ms, trace, state = run_partitioned(
                    source, args, env, trace_dir, extra_args)
            gc.collect()
            mem1 = torch.cuda.memory_allocated()
            want, mends = tool.held_to(run, digests)
            held_to = "+".join(k for k, _ in mends if (k, "1") in tool.MEND
                               + tool.MEND_RECONCILE) or "as is"
            check(hashlib.sha256(text).hexdigest() == want["sha256"]
                  and len(text) == want["bytes"],
                  f"{kind} {key}: report differs from the JAX package's "
                  f"({held_to}; {len(text)} bytes, want {want['bytes']})")
            check((sequence["sha256"], sequence["binds"], sequence["evicts"])
                  == (want["sequence_sha256"], want["sequence_binds"],
                      want["sequence_evicts"]),
                  f"{kind} {key}: a bind's node or an eviction differs "
                  f"from the JAX package's ({sequence['binds']} binds, "
                  f"{sequence['evicts']} evicts)")
            check(paths == want["tensor_paths"],
                  f"{kind} {key}: node-tensor path {paths} differs from "
                  f"the JAX package's {want['tensor_paths']}")
            if "obs" in want:
                got = tool.obs_digests(trace, *state)
                check(got == want["obs"],
                      f"{kind} {key}: recorder digests {got} differ from "
                      f"the JAX package's {want['obs']}")
                tpath = os.path.join(trace_dir, "partitioned-trace.json")
                check(validate.main(["--flows", tpath]) == 0,
                      f"{kind} {key}: the merged trace's flows do not "
                      f"validate")
            check(report["action_failures"] == 0
                  and report["double_binds"] == 0
                  and report["jobs"]["completed"]
                  == report["jobs"]["arrived"]
                  and not report["jobs"]["unfinished"],
                  f"{kind} {key}: {report['action_failures']} action "
                  f"failures, {report['double_binds']} double binds, jobs "
                  f"{report['jobs']}")
            check(launches["place"] == want["tensor_paths"]["solves"]
                  == sum(by_part.values()),
                  f"{kind} {key}: B1 launched {launches['place']} times "
                  f"({by_part} by partition), the solves "
                  f"{want['tensor_paths']['solves']}")
            walks = PARTITIONED_CPU_WALKS.get(key, 0)
            check(launches["evict_walk"] == walks,
                  f"{kind} {key}: B3 launched {launches['evict_walk']} "
                  f"times, the CPU path {walks}")
            overload = report.get("overload")
            el = (report.get("federation") or {}).get("elastic")
            if overload is not None and el is None:
                # the overload contract's spend bound; the elastic
                # contract (the JAX package's verifier) sets none, and
                # the JAX record of CI's elastic soak spends 2.1 s of a
                # 0.5 s budget in one cycle
                budget = overload["cycle_budget"]
                check(budget["max_cycle_spend_s"]
                      <= 2 * budget["budget_s"],
                      f"{kind} {key}: cycle spend {budget}")
                if source == "overload-burst":
                    check(overload["shed"].get("priority_shed", 0) > 0
                          and overload["retries_pending"] == 0,
                          f"{kind} {key}: the priority-aware shed "
                          f"{overload['shed']}")
            fed = report.get("federation")
            if fed is not None:
                check(fed["failover_cycles_max"] <= 3,
                      f"{kind} {key}: failover {fed['failover_cycles']}")
                reb = fed.get("rebalance")
                if source == "fed-hotspot" and reb is not None:
                    check(reb["move_count"] > 0 and reb["last_move_t"]
                          <= report["virtual_time_s"] - 10,
                          f"{kind} {key}: the rebalancer {reb}")
                if "--kill-cycles" in args and source == "baseline-10k":
                    check(report["journal_replayed"].get("replayed", 0) > 0,
                          f"{kind} {key}: the kill settled no crash window "
                          f"({report['journal_replayed']})")
            for r in restarts:
                # every device tensor of the killed shell's node rows is
                # gone, and the card's memory fell by at least their bytes
                check(r["freed"] and r["allocated_after"] + r["device_bytes"]
                      <= r["allocated_before"],
                      f"{kind} {key}: a crash restart kept the killed "
                      f"shell's device tensors ({r})")
            for r in retires:
                # a merged partition's node rows are gone by the end of the
                # cycle that retired it (later partitions' cycles ran in
                # between, so the card's total is printed, not held)
                check(r["freed"], f"{kind} {key}: retiring partition "
                                  f"{r['pid']} kept its device tensors "
                                  f"({r})")
            if el is not None:
                # the verifier's second run merges as often again
                runs_made = 2 if "--verify-elastic-equivalence" in args \
                    else 1
                check(el["splits"] >= 1 and el["merges"] >= 1
                      and el["partitions_final"] == el["partitions_initial"]
                      and len(retires) == runs_made * el["merges"],
                      f"{kind} {key}: the elastic contract {el}, "
                      f"{len(retires)} retires")
            check(mem1 <= mem0, f"{kind} {key}: {mem1 - mem0} bytes of "
                                f"card memory outlived the run")
            # a --deterministic run (the merged trace's) prints no
            # wall-clock plane
            wall = report.get("wallclock", {})
            rec = {"held_to": held_to, "cycles": report["cycles"],
                   "binds": report["binds"], "evicts": report["evicts"],
                   "jobs": report["jobs"], "wall_s": wall_s,
                   "pipeline_e2e_ms": wall.get("pipeline_e2e_ms"),
                   "cycle_sum_ms": percentiles(cycle_ms) if cycle_ms
                   else None,
                   "schedule_ms": wall.get("schedule_ms"),
                   "restarts": report["restarts"],
                   "failovers": report["failovers"],
                   "journal_replayed": report["journal_replayed"],
                   "B1": launches["place"],
                   "B1_by_partition": {str(k): v
                                       for k, v in by_part.items()},
                   "B3": launches["evict_walk"],
                   "solves": paths["solves"], "full_builds": paths["full"],
                   "scatter_rows": paths["scatter_rows"],
                   "drift": paths["drift"],
                   "allocated_before": mem0, "allocated_after": mem1,
                   "restart_memory": [
                       {"rows_bytes": r["device_bytes"],
                        "fell_by": r["allocated_before"]
                        - r["allocated_after"]}
                       for r in restarts if r["had_tensors"]]}
            if el is not None:
                rec["elastic"] = {k: el[k] for k in (
                    "splits", "merges", "abstentions", "partitions_peak",
                    "max_queue_depth", "events")}
                rec["retire_memory"] = [
                    {"pid": r["pid"], "rows_bytes": r["device_bytes"],
                     "freed": r["freed"],
                     "fell_by": r["allocated_before"]
                     - r["allocated_after"]} for r in retires]
            if overload is not None:
                rec["overload"] = {k: overload[k] for k in (
                    "cycle_budget", "shed", "readmit_attempts",
                    "burst_jobs")}
            if fed is not None:
                rec["federation"] = {k: fed[k] for k in (
                    "reserves", "node_transfers", "queue_moves", "map")}
                if "rebalance" in fed:
                    rec["federation"]["rebalance_moves"] = \
                        fed["rebalance"]["move_count"]
            out[key] = rec
            sim_runs[f"{kind} " + key] = launches
            print(f"{kind} {key}:", json.dumps(rec), flush=True)
    base = out.get("--scenario baseline-10k --conf deploy/scheduler.conf "
                   "--federated 4 --kill-cycles 0,3 --kill-seed 3")
    if base is not None and _DIRECT_E2E:
        # a partition leader's run_once, the four partitions' sum a virtual
        # cycle and the wall seconds, beside the direct run's cycle and wall
        print(f"{kind} baseline-10k pipeline_e2e_ms:", json.dumps({
            "federated_4_per_partition": base["pipeline_e2e_ms"],
            "federated_4_per_cycle": base["cycle_sum_ms"],
            "federated_wall_s": base["wall_s"],
            "direct": _DIRECT_E2E["pipeline_e2e_ms"],
            "direct_wall_s": _DIRECT_E2E["wall_s"]}), flush=True)
    print(f"{kind} phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    print(f"{kind} card:", card_line(), flush=True)
    return out


# ---------------------------------------------------------------------------
# the in-process system
# ---------------------------------------------------------------------------

def system_phase(sim_runs, device=None):
    """Step 24: each world of tools/system_reference.py through the port's
    VolcanoSystem on the card (store, webhooks, controllers, vcctl's
    commands and the scheduler in this process), each kernel's count set to
    0 just before: the Jobs, PodGroups, Pods, store events, bind and evict
    sequence and node-tensor path must equal the JAX package's in
    tests/system_reference_digests.json, with no action failure; B1 must
    launch once a solve and B3 once a walk of the CPU path, system-10k bind
    every gang with B1 and system-preempt evict through B3; no card memory
    outlives the phase. (The job controller installs its state machine's
    hooks in ``controllers/job_state.py``'s module, as the JAX package's
    does, so a system's cache and node tensors live until the next
    system's controller replaces them; each world's held bytes are
    printed.) Prints each world's wall seconds and launches, and
    system-10k's cycle ms p50/p99. Adds the launches to ``sim_runs``.
    ``device`` overrides the card (a rehearsal on the CPU)."""
    import gc

    import torch

    from volcano_tpu_torch.sim.report import percentiles
    sys.path.insert(0, os.path.join(_ROOT, "tools"))
    import system_reference
    digests = system_reference.load_digests()
    counters = kernel_counters()
    t_phase = time.perf_counter()
    out = {}
    gc.collect()
    mem_start = torch.cuda.memory_allocated()
    for world in system_reference.WORLDS:
        want = digests[world]
        gc.collect()
        mem0 = torch.cuda.memory_allocated()
        for wrapper in counters.values():
            wrapper.launches = 0
        run = system_reference.run_world("volcano_tpu_torch", world, device)
        launches = {k: w.launches for k, w in counters.items()}
        got = run.pop("digest")
        check(run["system"].device.type == (device or "cuda"),
              f"system {world}: the system solved on {run['system'].device}")
        del run["system"]
        gc.collect()
        mem1 = torch.cuda.memory_allocated()
        check(run["action_failures"] == [],
              f"system {world}: action failures {run['action_failures']}")
        expect = {k: v for k, v in want.items()
                  if k not in ("port_cpu", "action_failures")}
        diff = sorted(k for k in set(expect) | set(got)
                      if expect.get(k) != got.get(k))
        check(not diff, f"system {world}: {diff} differ from the JAX "
                        f"package's ({ {k: got.get(k) for k in diff} })")
        check(launches["place"] == want["port_cpu"]["solves"] == got["solves"]
              and launches["evict_walk"] == want["walks"] == got["walks"],
              f"system {world}: B1 launched {launches['place']} times, B3 "
              f"{launches['evict_walk']}; the CPU path "
              f"{want['port_cpu']}, the record walked {want['walks']}")
        rec = {"wall_s": run["wall_s"], "cycles": len(run["cycle_ms"]),
               "cycle_ms": percentiles(run["cycle_ms"]),
               "binds": got["binds"], "evicts": got["evicts"],
               "pods": got["pods"], "pod_phases": got["pod_phases"],
               "job_phases": got["job_phases"],
               "B1": launches["place"], "B3": launches["evict_walk"],
               "held_until_next_system_bytes": mem1 - mem0}
        out[world] = rec
        sim_runs[f"system {world}"] = launches
        print(f"system {world}:", json.dumps(rec), flush=True)
    gc.collect()
    mem_end = torch.cuda.memory_allocated()
    # the last world (system-lifecycle, the default conf) holds no node
    # tensors, and replacing the hooks let every earlier system go
    check(mem_end <= mem_start, f"system: {mem_end - mem_start} bytes of "
                                f"card memory outlived the phase")
    full = out["system-10k"]
    check(full["B1"] > 0 and full["binds"] == full["pods"] == 10000,
          f"system system-10k: {full}")
    check(out["system-preempt"]["B3"] > 0
          and out["system-preempt"]["evicts"] > 0,
          f"system system-preempt: {out['system-preempt']}")
    print("system system-10k cycle_ms p50/p99:", json.dumps(
        {"p50": full["cycle_ms"]["p50"], "p99": full["cycle_ms"]["p99"],
         "cycles": full["cycles"], "wall_s": full["wall_s"]}), flush=True)
    print(f"system phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    print("system card:", card_line(), flush=True)
    return out


# ---------------------------------------------------------------------------
# the snapshot RPC sidecar, the native store and the metrics endpoint
# ---------------------------------------------------------------------------

def _summary_count(body: str, family: str) -> float:
    """The summed ``_count`` samples of one summary family."""
    total = 0.0
    for line in body.splitlines():
        if line.startswith(family + "_count"):
            total += float(line.rsplit(" ", 1)[1])
    return total


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def rpc_binary(msg: dict, want: dict, device=None) -> dict:
    """``python -m volcano_tpu_torch.cmd vc-snapshot-rpc`` as a process of
    its own (kernels built already, so it loads them before it listens):
    seconds until it listens, ``msg`` answered over TCP with the decisions
    ``want`` records (twice: the first request and a warm one), /healthz on
    its --listen-address, and exit 0 on SIGTERM. The process is stopped
    whatever happens."""
    import signal
    import urllib.request

    sys.path.insert(0, os.path.join(_ROOT, "tools"))
    import rpc_reference
    from volcano_tpu_torch.rpc import SnapshotClient
    http = _free_port()
    argv = [sys.executable, "-m", "volcano_tpu_torch.cmd",
            "vc-snapshot-rpc", "--port", "0", "--scheduler-conf",
            os.path.join(_ROOT, "deploy", "scheduler.conf"),
            "--listen-address", str(http)]
    if device is not None:
        argv += ["--device", str(device)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=_ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        line = proc.stdout.readline()
        out["listen_s"] = time.perf_counter() - t0
        check("listening on" in line,
              f"vc-snapshot-rpc did not listen: {line!r}")
        port = int(line.rsplit(":", 1)[1])
        out["request_ms"] = []
        for _ in range(2):
            client = SnapshotClient("127.0.0.1", port, timeout=600)
            t1 = time.perf_counter()
            reply = client.schedule(msg)
            out["request_ms"].append((time.perf_counter() - t1) * 1e3)
            client.close()
            rec = rpc_reference.decisions_record(reply)
            check(rec["decisions_sha256"] == want["decisions_sha256"],
                  "vc-snapshot-rpc: the reply differs from the reference's")
        with urllib.request.urlopen(f"http://127.0.0.1:{http}/healthz",
                                    timeout=30) as r:
            out["healthz"] = r.read().decode()
        check(out["healthz"] == "ok", f"vc-snapshot-rpc /healthz: {out}")
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out["rc"] = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out["rc"] = proc.wait()
        proc.stdout.close()
        proc.stderr.close()
    check(out["rc"] == 0, f"vc-snapshot-rpc exited {out['rc']}")
    return out


def rpc_phase(sim_runs, device=None):
    """Step 25: the vc-snapshot-rpc sidecar on the card. Each world of
    tools/rpc_reference.py (rpc-10k, rpc-10k-blocks, rpc-preempt) is
    encoded once and sent over TCP by ``SnapshotClient`` to ``serve``'s
    sidecar (one a conf, solving on the card), each kernel's count set to 0
    just before the request: the reply's decisions digest must equal
    tests/rpc_reference_digests.json (the JAX package's, which the port's
    CPU path equals), rpc-10k must bind all 10,000 pods with exactly one
    B1 launch, rpc-10k-blocks launch every B4 kernel as its solve counted
    (one prep a solve, a free a sweep, as many candidate as round
    launches), rpc-preempt launch B3 as often as the CPU path walked and B1
    once a solve. The card's memory must be back at its value from before
    the requests. Then system-preempt and system-lifecycle over
    the port's C++ object store (tools/system_reference.py ``--native``)
    equal to tests/system_reference_digests.json, as over its Python
    store. The
    metrics server started at the phase's start is scraped after rpc-10k
    (/metrics in the exposition grammar with a nonzero plugin latency
    count, /healthz "ok") and after the native system-preempt
    (/healthz?detail, /debug/why and /debug/timeline of its high-priority
    job, each 200 with JSON, and a nonzero e2e count). Last, the
    vc-snapshot-rpc binary as a process of its own answers rpc-10k
    (``rpc_binary``). Prints each world's wall s, encode / request /
    decode ms and launches. Adds the launches to ``sim_runs``. ``device``
    overrides the card (a rehearsal)."""
    import gc

    import torch

    sys.path.insert(0, os.path.join(_ROOT, "tools"))
    import rpc_reference
    import system_reference
    from volcano_tpu_torch import metrics
    from volcano_tpu_torch.framework import get_action
    from volcano_tpu_torch.native import NativeObjectStore
    from volcano_tpu_torch.obs import validate
    from volcano_tpu_torch.rpc import SnapshotClient, serve
    doc = rpc_reference.load_digests()
    system_digests = system_reference.load_digests()
    counters = kernel_counters()
    t_phase = time.perf_counter()
    http = metrics.start_metrics_server(0, "127.0.0.1")
    servers = {}
    out = {}
    try:
        gc.collect()
        mem_start = torch.cuda.memory_allocated()
        for world in rpc_reference.WORLDS:
            want = doc["worlds"][world]
            t0 = time.perf_counter()
            snap = rpc_reference.world_snapshot(world)
            t1 = time.perf_counter()
            msg = rpc_reference.encode(snap)
            encode_ms = (time.perf_counter() - t1) * 1e3
            del snap
            check(rpc_reference.message_sha256(msg)
                  == want["snapshot_sha256"],
                  f"rpc {world}: the snapshot differs from the reference's")
            conf = rpc_reference.conf_text(world)
            if conf not in servers:
                servers[conf] = serve(conf_text=conf, device=device)[0]
            client = SnapshotClient("127.0.0.1",
                                    servers[conf].server_address[1],
                                    timeout=600)
            for wrapper in counters.values():
                wrapper.launches = 0
            t1 = time.perf_counter()
            reply = client.schedule(msg)
            request_ms = (time.perf_counter() - t1) * 1e3
            launches = {k: w.launches for k, w in counters.items()}
            client.close()
            t1 = time.perf_counter()
            rec = rpc_reference.decisions_record(reply)
            decode_ms = (time.perf_counter() - t1) * 1e3
            del reply, msg
            stats = get_action("allocate-tpu").last_stats
            blocks = stats.get("blocks") or {}
            diff = sorted(k for k in rec if rec[k] != want[k])
            check(not diff, f"rpc {world}: {diff} differ from the JAX "
                            f"package's ({ {k: rec[k] for k in diff} })")
            cpu = want["port_cpu"]
            check(launches["evict_walk"] == cpu["walks"],
                  f"rpc {world}: B3 launched {launches['evict_walk']} "
                  f"times, the CPU path walked {cpu['walks']}")
            if world == "rpc-10k-blocks":
                check(launches["place"] == 0
                      and launches["blocks_prep"] == cpu["allocate"]
                      and launches["blocks_free"] == cpu["blocks_sweeps"]
                      == blocks.get("sweeps")
                      and blocks.get("passes") == cpu["blocks_passes"]
                      and launches["blocks_topk"]
                      == launches["blocks_round"] > 0,
                      f"rpc {world}: B4 launches {launches}, solve "
                      f"{blocks}, CPU path {cpu}")
            else:
                check(launches["place"] == cpu["allocate"],
                      f"rpc {world}: B1 launched {launches['place']} "
                      f"times for {cpu['allocate']} solves")
            if world == "rpc-10k":
                check(launches["place"] == 1 and rec["binds"] == 10000,
                      f"rpc-10k: B1 {launches['place']}, binds "
                      f"{rec['binds']}")
            if world == "rpc-preempt":
                check(launches["evict_walk"] >= 1,
                      "rpc-preempt: the walk never launched")
            line = {"wall_s": time.perf_counter() - t0,
                    "encode_ms": encode_ms, "request_ms": request_ms,
                    "decode_ms": decode_ms, "binds": rec["binds"],
                    "evicts": rec["evicts"],
                    "decisions_sha256": rec["decisions_sha256"],
                    "digest": "equal", "launches": launches}
            out[world] = line
            sim_runs[f"rpc {world}"] = launches
            print(f"rpc {world}:", json.dumps(line), flush=True)
            if world == "rpc-10k":
                status, body = validate.fetch(http, "/metrics", timeout=30)
                text = body.decode()
                samples = validate.parse_sample_count(text)
                plugin = _summary_count(
                    text, "volcano_plugin_scheduling_latency_microseconds")
                health = validate.fetch(http, "/healthz", timeout=30)
                check(status == 200 and samples > 0 and plugin > 0
                      and health == (200, b"ok"),
                      f"rpc scrape: /metrics {status}, {samples} samples, "
                      f"plugin count {plugin}; /healthz {health}")
                print("rpc scrape after rpc-10k:", json.dumps(
                    {"samples": samples, "plugin_count": plugin,
                     "bytes": len(body), "healthz": health[1].decode()}),
                    flush=True)
        for server in servers.values():
            server.shutdown()
            server.server_close()
        servers.clear()
        gc.collect()
        mem_after = torch.cuda.memory_allocated()
        check(mem_after == mem_start,
              f"rpc: {mem_after - mem_start} bytes of card memory "
              f"outlived the requests")
        for world in system_reference.NATIVE_WORLDS:
            want = system_digests[world]
            for wrapper in counters.values():
                wrapper.launches = 0
            run = system_reference.run_world("volcano_tpu_torch", world,
                                             device, native=True)
            launches = {k: w.launches for k, w in counters.items()}
            got = run.pop("digest")
            check(isinstance(run["system"].store, NativeObjectStore),
                  f"native {world}: the system's store is not native")
            del run["system"]
            check(run["action_failures"] == [],
                  f"native {world}: action failures "
                  f"{run['action_failures']}")
            diff = sorted(k for k in want
                          if k not in ("action_failures", "port_cpu")
                          and want[k] != got.get(k))
            check(not diff, f"native {world}: {diff} differ from the JAX "
                            f"package's ({ {k: got.get(k) for k in diff} })")
            walks = system_digests[world]["walks"]
            check(launches["place"] == got["solves"]
                  and launches["evict_walk"] == walks == got["walks"],
                  f"native {world}: B1 {launches['place']} for "
                  f"{got['solves']} solves, B3 {launches['evict_walk']} "
                  f"for {walks} walks")
            line = {"wall_s": run["wall_s"], "binds": got["binds"],
                    "evicts": got["evicts"], "B1": launches["place"],
                    "B3": launches["evict_walk"], "digest": "equal"}
            out[f"native {world}"] = line
            sim_runs[f"native {world}"] = launches
            print(f"rpc native {world}:", json.dumps(line), flush=True)
            if world == "system-preempt":
                scraped = {}
                for path in ("/healthz?detail", "/debug/why?job=default/high",
                             "/debug/timeline?job=default/high"):
                    status, body = validate.fetch(http, path, timeout=30)
                    check(status == 200 and json.loads(body),
                          f"rpc scrape {path}: {status} {body[:200]!r}")
                    scraped[path] = len(body)
                status, body = validate.fetch(http, "/metrics", timeout=30)
                e2e = _summary_count(
                    body.decode(),
                    "volcano_e2e_scheduling_latency_milliseconds")
                check(status == 200 and e2e > 0,
                      f"rpc scrape: e2e count {e2e} after system-preempt")
                scraped["e2e_count"] = e2e
                print("rpc scrape after native system-preempt:",
                      json.dumps(scraped), flush=True)
        gc.collect()
        mem_end = torch.cuda.memory_allocated()
        # the last native world (the default conf) holds no node tensors,
        # and its controller let the earlier system go
        check(mem_end <= mem_start,
              f"rpc: {mem_end - mem_start} bytes of card memory outlived "
              f"the phase")
        world = "rpc-10k"
        out["binary"] = rpc_binary(rpc_reference.snapshot_message(world),
                                   doc["worlds"][world], device)
        print("rpc binary vc-snapshot-rpc:", json.dumps(out["binary"]),
              flush=True)
    finally:
        for server in servers.values():
            server.shutdown()
            server.server_close()
        http.shutdown()
        http.server_close()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"rpc phase: {out['phase_s']:.1f} s", flush=True)
    print("rpc card:", card_line(), flush=True)
    return out


# ---------------------------------------------------------------------------
# the plugin worlds: pod affinity, GPU sharing, conformance, NUMA, the
# proportional guard
# ---------------------------------------------------------------------------

def plugins_phase(sim_runs, device=None):
    """Step 26: each world of tools/plugin_reference.py through the port's
    Scheduler on the card, two cycles (three for sla-overcommit-10k, four
    for reservation-1k), each kernel's count set to 0 just before: the
    digest must equal the record tests/plugin_reference_digests.json holds
    it to (the JAX package's, mended where the world meets a fault of it
    the port fixes, ROADMAP §3; the port's CPU path equals it), B1 must
    launch once a recorded solve and B3 once a recorded walk (the JAX
    package's walks and the CPU path's), no walk may evict a victim that a
    plugin of the first tier refused after the tier's first plugin offered
    it (affinity-preempt: no critical pod of a lower-priority job than its
    preemptor's; the critical pods still evicted are the held record's,
    fewer than the unmended one's, all on nodes where priority offered
    nothing and drf's tier ruled, as upstream's dispatch allows), the
    proportional guard must refuse placements in proportional-1k, no action
    may fail and no fallback be counted, and the card's memory must be back
    at its start at the phase's end. Prints each world's line and the
    phase's seconds. Adds the launches to ``sim_runs``. ``device``
    overrides the card (a rehearsal)."""
    import gc

    import torch

    sys.path.insert(0, os.path.join(_ROOT, "tools"))
    import plugin_reference
    digests = plugin_reference.load_digests()
    counters = kernel_counters()
    card = card_line()
    t_phase = time.perf_counter()
    gc.collect()
    mem_start = torch.cuda.memory_allocated()
    out = {}
    for world in plugin_reference.WORLDS:
        want = plugin_reference.held_to(digests[world])
        port_cpu = digests[world]["port_cpu"]
        for wrapper in counters.values():
            wrapper.launches = 0
        run = plugin_reference.run_world("volcano_tpu_torch", world, device)
        launches = {k: w.launches for k, w in counters.items()}
        got = run["digest"]
        diff = sorted(k for k in got
                      if want.get(k) != got[k])
        check(not diff, f"plugins {world}: {diff} differ from the JAX "
                        f"package's ({ {k: got[k] for k in diff} } against "
                        f"{ {k: want.get(k) for k in diff} })")
        check(launches["place"] == want["solves"] == port_cpu["solves"],
              f"plugins {world}: B1 launched {launches['place']} times, "
              f"the record solved {want['solves']}")
        check(launches["evict_walk"] == want["walks"] == port_cpu["walks"],
              f"plugins {world}: B3 launched {launches['evict_walk']} "
              f"times, the record walked {want['walks']}")
        check(got["action_failures"] == [],
              f"plugins {world}: action failures {got['action_failures']}")
        check_contained(f"plugins {world}")
        alloc = run["allocate"]
        rec = {"binds": got["binds"], "evicts": got["evicts"],
               "critical_evicted": got["critical_evicted"],
               "vetoed_evicted": got.get("vetoed_evicted"),
               "guard_refusals": run["guard_refusals"],
               "B1": launches["place"], "B3": launches["evict_walk"],
               "rounds": sum(a["rounds"] for a in alloc),
               "rejected": sum(a["rejected"] for a in alloc),
               "allocate_ms": {k: sum(a[k] for a in alloc) * 1e3
                               for k in ("order", "assemble", "solve",
                                         "replay")},
               "podgroup_phases": got["podgroup_phases"],
               "wall_s": run["wall_s"], "card": card}
        if "per_cycle" in got:
            cycles = got["per_cycle"]
            rec.update(fast_replays=got["fast_replays"],
                       drained=[c["evicts_by_zone"] for c in cycles],
                       pending=[c["podgroup_phases"].get("Pending", 0)
                                for c in cycles],
                       target=[c["target"] for c in cycles],
                       locked=[len(c["locked"]) for c in cycles])
        out[world] = rec
        sim_runs[f"plugins {world}"] = launches
        print(f"plugins {world}:", json.dumps(rec), flush=True)
    gc.collect()
    mem_end = torch.cuda.memory_allocated()
    check(mem_end <= mem_start, f"plugins: {mem_end - mem_start} bytes of "
                                f"card memory outlived the phase")
    as_is = digests["affinity-preempt"]
    check(out["affinity-10k"]["rejected"] > 0
          and out["affinity-preempt"]["B3"] > 0
          and out["affinity-preempt"]["vetoed_evicted"] == 0
          < as_is["vetoed_evicted"]
          and out["affinity-preempt"]["critical_evicted"]
          < as_is["critical_evicted"]
          and out["proportional-1k"]["guard_refusals"] > 0
          and out["gpushare-10k"]["binds"] > 0,
          f"plugins: {out}")
    # slice 18: tdm's walk and its drain in the first cycle only; the
    # Statement replay of task-topology's order; sla letting through what
    # overcommit held back; a target and a node locked a cycle
    tdm, topo = out["tdm-10k"], out["topology-10k"]
    sla, res = out["sla-overcommit-10k"], out["reservation-1k"]
    check(tdm["B3"] > 0 and tdm["vetoed_evicted"] == 0
          and tdm["drained"][0].get("rz-closed", 0) > 0
          and not any(tdm["drained"][1:])
          and topo["B1"] > 0 and topo["fast_replays"] == 0
          and sla["pending"][0] > sla["pending"][1] > sla["pending"][2]
          and sla["B1"] > 0
          and res["target"] == ["vip"] * 4 and res["locked"] == [1, 2, 3, 4],
          f"plugins: slice 18's worlds {tdm, topo, sla, res}")
    print(f"plugins phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


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
    errors = sched.run_once()
    check(errors == [], f"cycle {device or 'cuda'}: isolated action "
                        f"failures {[(n, repr(e)) for n, e in errors]}")
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
        errors = sched.run_once()
        torch.cuda.synchronize()
    check(errors == [], f"profiled cycle: isolated action failures "
                        f"{[(n, repr(e)) for n, e in errors]}")
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


# the CPU path's runs the card's are compared with, and the plain versions
# step 2 and step 9 hold kernels against on the CPU: they need no card, so
# they run in spawned worker processes (each a fresh process that never
# touches CUDA) while the kernels build, and main waits for every one of
# them before its first timed phase, so no time the script prints but the
# build's is taken while they run
CPU_REF_WORKERS = 4
CPU_REF_THREADS = 2
_CPU_POOL: list = []


def _cpu_worker_init() -> None:
    import torch
    torch.set_num_threads(CPU_REF_THREADS)


def _timed_cpu_run(fn, args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def start_cpu_references() -> dict:
    """Submit every CPU-path reference run and every plain version that
    runs on the CPU to a pool of spawned workers, the longest first: key ->
    its pending result."""
    import multiprocessing
    blocks = engine_conf("tpu-blocks")
    strict = engine_conf("tpu-strict")
    jobs = [
        ("deployed 20k-taints tpu-blocks", ("deployed", "20k-taints", blocks),
         run_deployed, ("20k-taints", "cpu", blocks)),
        *((f"blocks_plain {name}", ("blocks_plain", name), blocks_plain_cpu,
           (name,)) for name in BLOCKS_PLAIN_ON_CPU),
        ("preempt", ("preempt", False), run_preempt, ("cpu", False)),
        ("preempt intra", ("preempt", True), run_preempt, ("cpu", True)),
        ("cycle 10k-taints", ("cycle", True), run_cycle, ("cpu", True)),
        ("deployed 20k tpu-blocks", ("deployed", "20k", blocks),
         run_deployed, ("20k", "cpu", blocks)),
        ("deployed 10k tpu-strict", ("deployed", "10k", strict),
         run_deployed, ("10k", "cpu", strict)),
        ("cycle 10k", ("cycle", False), run_cycle, ("cpu", False)),
    ] + [(f"deployed {name}", ("deployed", name, None), run_deployed,
          (name, "cpu")) for name in ("10k", "pipeline", "tight-mix")]
    jobs += [(f"place_plain {label}", ("place_plain", label), place_plain_cpu,
              (label,)) for label in sorted(
                  place_worlds(), key=lambda k: not k.startswith("slice"))]
    pool = multiprocessing.get_context("spawn").Pool(
        CPU_REF_WORKERS, initializer=_cpu_worker_init)
    _CPU_POOL.append(pool)
    return {key: (label, pool.apply_async(_timed_cpu_run, (fn, args)))
            for label, key, fn, args in jobs}


def finish_cpu_references(pending: dict) -> dict:
    """Wait for every CPU-path reference run and stop the workers: key ->
    the run's result. Prints each run's seconds in its worker."""
    t0 = time.perf_counter()
    refs, seconds = {}, {}
    for key, (label, result) in pending.items():
        refs[key], seconds[label] = result.get()
    pool = _CPU_POOL.pop()
    pool.close()
    pool.join()
    print(f"cpu references: {len(refs)} runs, {CPU_REF_WORKERS} workers "
          f"of {CPU_REF_THREADS} threads, waited "
          f"{time.perf_counter() - t0:.1f} s after the build; seconds each:",
          json.dumps(seconds), flush=True)
    return refs


def stop_cpu_references() -> None:
    """A failed run stops the workers at once (their results are moot)."""
    while _CPU_POOL:
        _CPU_POOL.pop().terminate()


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

    # 1. the card and the build; the CPU path's reference runs start in
    # their workers at once, and end before the first timed phase
    started = time.perf_counter()
    pending = start_cpu_references()

    current = []

    def phase(name):
        # every phase but containment ends with no fallback nobody asked for
        if current:
            check_contained(current[-1])
        current.append(name)
        print(f"phase {name} at {time.perf_counter() - started:.1f} s, "
              f"clocks {clocks_line()}", flush=True)

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
    # the round kernel keeps its lane sums in registers: no stack frame and
    # no spills in any instance
    round_ptxas = {fn: r for fn, r in build.ptxas_report("blocks").items()
                   if "blocks_round_kernel" in fn}
    print("ptxas blocks_round_kernel:", json.dumps(round_ptxas), flush=True)
    check(len(round_ptxas) == 7 and all(
        r.get("stack") == 0 and r.get("spill_stores") == 0
        and r.get("spill_loads") == 0 for r in round_ptxas.values()),
          "blocks_round_kernel has a stack frame or spills")

    cpu_refs = finish_cpu_references(pending)

    phase("kernels")
    # 2. each kernel against its plain version (the placement kernel's
    # computed on the CPU while the kernels built); the rowdiff pre-pass on
    # three worlds' static matrices
    from volcano_tpu_torch.framework import resolve_device
    dev = resolve_device(None)          # the card
    records, static = [], {}
    for label, (make, sweep) in place_worlds().items():
        args = make(dev)
        records.append(compare_place(label, args,
                                     cpu_refs[("place_plain", label)], sweep))
        if label in ("runs", "static-one-node", "slice-10k-taints"):
            static[label] = args[10]
        del args
        if label == "device-memory-r8-n40000":
            check(not records[-1]["in_smem"], "the R=8, 40,000-node world "
                  "did not take the device-memory path")
        if label == "slice-10k":
            slice_rec = records[-1]
    compare_rowdiff("runs", static["runs"])
    compare_rowdiff("static-one-node", static["static-one-node"])
    rowdiff_rec = compare_rowdiff("slice-10k-taints",
                                  static.pop("slice-10k-taints"))

    # the preempt walk: seeded worlds, then the preempt world's own walks,
    # recorded on the port's CPU runs (which step 5 compares against)
    walk_records = [compare_walk(name, make(), dev)
                    for name, make in walk_worlds().items()]
    for name, make in walk_worlds(card=True).items():
        walk_records.append(compare_walk(name, make(), dev))
        where = walk_records[-1]["smem_blocks"]
        if name == "w64-n400":
            check(not where["tables"],
                  "w64-n400 kept its victim tables in shared memory")
        if name == "n8192":
            check(not where["nodes"] and not where["groups"],
                  f"n8192 kept node or group state in shared memory: {where}")
    cpu_preempt = cpu_refs[("preempt", False)]
    check(len(cpu_preempt[5]) == 1 and cpu_preempt[5][0][3],
          "the preempt world ran no phase-1 walk")
    walk_main = compare_walk("preempt-p1", cpu_preempt[5][0], dev)
    walk_records.append(walk_main)
    intra_walks = cpu_refs[("preempt", True)][5]
    phase2 = [w for w in intra_walks if not w[3]]
    check(len(phase2) == 1, "the intra-job preempt world ran no phase-2 walk")
    walk_records.append(compare_walk("preempt-intra-p2", phase2[0], dev))

    phase("cycle")
    # 3. the cycle on the card (twice without taints: the second run shows
    # the time without first-use costs), and on the CPU
    results = {}
    for label, taints in (("10k", False), ("10k-taints", True)):
        cpu_binds, cpu_times, _ = cpu_refs[("cycle", taints)]
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

    phase("preempt")
    # 5. preempt alone on the preempt world, on the card
    evicts, pipelined, launches, ms, stats, _ = run_preempt(None)
    check(launches >= 1, "preempt on the card launched no walk")
    check(evicts == cpu_preempt[0],
          "preempt: evictions differ from the CPU run's")
    check(pipelined == cpu_preempt[1],
          "preempt: pipelined tasks differ from the CPU run's")
    print("preempt:", json.dumps(
        {"evictions": len(evicts), "pipelined": len(pipelined),
         "walk_launches": launches, "ms": ms, "cpu_ms": cpu_preempt[3],
         "phases": stats}), flush=True)

    phase("deployed")
    # 6. the deployed cycle, on the card and on the CPU
    deployed = {}
    tight_walks = []
    for name in ("10k", "pipeline", "tight-mix"):
        want, cpu_times = cpu_refs[("deployed", name, None)][:2]
        ran = {}
        walks = record_walks(lambda: ran.setdefault(
            "out", run_deployed(name, None)))
        got, times, launches, stats, _ = ran["out"]
        if name == "tight-mix":
            tight_walks = walks
        for key in ("binds", "evicts", "pipelined", "phases"):
            check(got[key] == want[key],
                  f"deployed {name}: {key} differ from the CPU cycle's")
        check(launches["place"] > 0,
              f"deployed {name}: the cycle launched no placement kernel")
        if name == "tight-mix":
            check(launches["evict_walk"] > 0,
                  "deployed tight-mix: preempt launched no walk")
        deployed[name] = launches
        if name == "10k":
            fused_10k_binds = got["binds"]
        print(f"deployed {name}:", json.dumps(
            {"binds": len(got["binds"]), "evictions": len(got["evicts"]),
             "pipelined": len(got["pipelined"]), "launches": launches,
             "ms": times, "cpu_ms": cpu_times, "preempt_phases": stats}),
            flush=True)

    # the tight mix's own walk against the plain walk
    check(len(tight_walks) >= 1, "deployed tight-mix: no walk recorded")
    for k, w in enumerate(tight_walks):
        walk_records.append(compare_walk(f"tight-mix-walk-{k}", w, dev))

    phase("proportion")
    # 7. proportion's water-filling at 64 queues (B8)
    compare_proportion(64, 1, dev)

    phase("tpu-blocks")
    # 8. tpu-blocks under the deployed conf (its engine line changed): at
    # 20k, with and without taints, on the card against the CPU; at 100k on
    # the card alone, held to capacity and gang invariants. The card cycles'
    # first solves are kept for step 9.
    blocks_cycles, solves = {}, {}
    for name in ("20k", "20k-taints", "100k"):
        conf = engine_conf("tpu-blocks")
        cpu = None if name == "100k" else cpu_refs[("deployed", name,
                                                    conf)]
        ran, seen = record_blocks_solves(
            lambda: run_deployed(name, None, conf, keep_cache=True))
        got, times, launches, _, stats, cache = ran
        solves[name] = seen[0]
        for k in BLOCK_KERNELS:
            check(launches[k] > 0,
                  f"tpu-blocks {name}: {k} never launched")
        check(launches["place"] == 0,
              f"tpu-blocks {name}: the placement kernel launched")
        if cpu is not None:
            for key in ("binds", "pipelined", "phases", "evicts"):
                check(got[key] == cpu[0][key],
                      f"tpu-blocks {name}: {key} differ from the CPU cycle's")
        binds = check_capacity_and_gangs(cache, f"tpu-blocks {name}")
        del cache
        blocks_cycles[name] = launches
        rec = {"binds": binds, "pipelined": len(got["pipelined"]),
               "launches": launches, "allocate_ms": times["allocate-tpu"],
               "allocate_phases_ms": {
                   k: v * 1e3 for k, v in stats.items()
                   if k in ("order", "assemble", "solve", "replay")},
               "solves": stats["solves"], "cycle_ms": times["cycle"],
               "blocks": stats["blocks"]}
        if cpu is not None:
            rec.update(cpu_allocate_ms=cpu[1]["allocate-tpu"],
                       cpu_solve_ms=cpu[4]["solve"] * 1e3,
                       cpu_cycle_ms=cpu[1]["cycle"])
        print(f"cycle tpu-blocks {name}:", json.dumps(rec), flush=True)

    phase("blocks-kernels")
    # 9. the block auction's kernels against blocks_plain on the CPU test
    # worlds and on the tpu-blocks cycles' own first solves (20k with and
    # without taints, 100k)
    worlds, card_worlds, world_args = blocks_worlds()
    blocks_records = []
    for name, make in {**worlds, **card_worlds}.items():
        args, kw = world_args(make(), dev)
        blocks_records.append(compare_blocks(
            name, args, kw, cpu_refs.get(("blocks_plain", name))))
    big_blocks = {}
    for name in ("20k", "20k-taints", "100k"):
        args, kw = solves.pop(name)
        big_blocks[name] = compare_blocks(f"solve-{name}", args, kw)
        blocks_records.append(big_blocks[name])
        if name == "20k":
            topk_library = topk_library_ms(args, kw)
        del args
    for mode in ("exact", "in_order"):
        check(any(r["modes"][mode] for r in blocks_records),
              f"blocks: no world's chunks took the {mode} sum mode")

    phase("tpu-strict")
    # 10. tpu-strict at 10k under the deployed conf, card against CPU, and
    # its admissions beside tpu-fused's (step 6)
    strict_conf = engine_conf("tpu-strict")
    want, cpu_times, _, _, cpu_stats = cpu_refs[("deployed", "10k",
                                                  strict_conf)]
    got, times, launches, _, stats = run_deployed("10k", None, strict_conf)
    for key in ("binds", "pipelined", "phases", "evicts"):
        check(got[key] == want[key],
              f"tpu-strict 10k: {key} differ from the CPU cycle's")
    check(launches["place"] == stats["solves"] > 0,
          f"tpu-strict 10k: {launches['place']} placement launches for "
          f"{stats['solves']} solves")
    print("cycle tpu-strict 10k:", json.dumps({
        "binds": len(got["binds"]), "place_launches": launches["place"],
        "batches": stats["batches"],
        "admissions_equal_tpu_fused": (admitted(got["binds"])
                                       == admitted(fused_10k_binds)),
        "allocate_ms": times["allocate-tpu"],
        "solve_ms": stats["solve"] * 1e3,
        "cpu_allocate_ms": cpu_times["allocate-tpu"]}), flush=True)

    phase("default-conf")
    # 11. the reference's default conf at 1k (seed 3): callbacks on the
    # host, tpu-strict and tpu-fused on the card
    runs = {e: run_deployed("1k-seed3", None, engine_conf(e, default=True))
            for e in ("callbacks", "tpu-strict", "tpu-fused")}
    binds = {e: r[0]["binds"] for e, r in runs.items()}
    check(binds["callbacks"] == binds["tpu-strict"],
          "default conf 1k: callbacks and tpu-strict bind differently")
    check(admitted(binds["callbacks"]) == admitted(binds["tpu-fused"])
          and len(binds["callbacks"]) == len(binds["tpu-fused"]),
          "default conf 1k: callbacks and tpu-fused admit differently")
    check(not any(runs["callbacks"][2].values()),
          "default conf 1k: callbacks launched a kernel")
    check(runs["tpu-strict"][2]["place"] > 0
          and runs["tpu-fused"][2]["place"] > 0,
          "default conf 1k: a device engine launched no placement kernel")
    print("engines default-conf 1k:", json.dumps({
        e: {"binds": len(binds[e]), "launches": r[2],
            "allocate_ms": r[1]["allocate"]} for e, r in runs.items()}),
        flush=True)

    phase("sim")
    # 12. the sim in direct mode on the card under deploy/scheduler.conf:
    # every run's decision plane is the JAX package's, byte for byte
    import hashlib
    digests = sim_digests()
    sim_runs = {}
    for scenario, args in SIM_RUNS:
        key = " ".join(("--scenario", scenario) + args)
        report, text, sequence, launches, wall_s = run_sim(scenario, args)
        want = digests[key]
        check(hashlib.sha256(text).hexdigest() == want["sha256"]
              and len(text) == want["bytes"],
              f"sim {key}: decision plane differs from the JAX package's "
              f"({len(text)} bytes, want {want['bytes']})")
        check((sequence["sha256"], sequence["binds"], sequence["evicts"])
              == (want["sequence_sha256"], want["sequence_binds"],
                  want["sequence_evicts"]),
              f"sim {key}: a bind's node or an eviction differs from the "
              f"JAX package's ({sequence['binds']} binds, "
              f"{sequence['evicts']} evicts)")
        check(report["action_failures"] == 0,
              f"sim {key}: {report['action_failures']} action failures")
        check(report["double_binds"] == 0,
              f"sim {key}: {report['double_binds']} double binds")
        check(launches["place"] > 0,
              f"sim {key}: the placement kernel never launched")
        if scenario == "preempt-burst":
            check(launches["evict_walk"] > 0,
                  f"sim {key}: the preempt walk never launched")
        sim_runs[scenario] = launches
        wall = report["wallclock"]
        if scenario == "baseline-10k":
            _DIRECT_E2E.update(pipeline_e2e_ms=wall["pipeline_e2e_ms"],
                               wall_s=wall_s)
        print(f"sim {scenario}:", json.dumps({
            "args": list(args), "cycles": report["cycles"],
            "binds": report["binds"], "evicts": report["evicts"],
            "restarts": report["restarts"],
            "jobs": report["jobs"], "launches": launches,
            "pipeline_e2e_ms": wall["pipeline_e2e_ms"],
            "schedule_ms": wall["schedule_ms"],
            "actions_ms": wall["actions_ms"], "wall_s": wall_s,
            "decision_plane_sha256": hashlib.sha256(text).hexdigest(),
            "sequence_sha256": sequence["sha256"]}),
            flush=True)
    prof = profile_sim(*SIM_RUNS[0])
    want = digests[" ".join(("--scenario",) + SIM_RUNS[0][:1]
                            + SIM_RUNS[0][1])]
    check(prof["decision_plane_sha256"] == want["sha256"]
          and prof["sequence_sha256"] == want["sequence_sha256"],
          "sim baseline-10k under the profiler: decisions differ")
    print("profile sim baseline-10k:", json.dumps(prof), flush=True)
    print("sim card:", card_line(), flush=True)

    phase("incremental")
    # 13. the incremental snapshot and the persistent node tensors
    incremental_phase(digests, sim_runs)

    phase("pipelined")
    # 14-15. the pipelined cycle: B7, the no-sync dispatch, the sim
    decode_rec, decode_records, _, pipelined_runs = pipelined_phase(
        digests, sim_runs)
    backlog_key = "--trace backlog-16k --pipelined"

    phase("elastic")
    # 16. elastic gangs and B6
    topo_rec, topo_records, elastic_out = elastic_phase(digests, sim_runs)

    phase("obs")
    # 17. the flight recorder
    obs_phase(digests, sim_runs)

    phase("containment")
    # 18. device containment: a real OOM, the cool-down, the probe, the
    # deadline and a failed launch
    containment_phase()

    phase("store")
    # 19. the object store and the feedback watch path
    store_phase(digests, sim_runs)

    phase("ha")
    # 20. the HA control plane: fenced leader election, warm standbys, the
    # shell's role gate, leader kills and a lost lease
    ha_phase(digests, sim_runs)

    tool, _ = sim_tools()
    phase("overload")
    # 21. the overload plane: cycle budgets, bounded admission with the
    # priority-aware shed, seeded bursts
    partitioned_phase("overload", tool.OVERLOAD_RUNS, digests, sim_runs)

    phase("federated")
    # 22. the federated control plane: partitioned schedulers, reserves,
    # node transfers, queue moves and the rebalancer
    partitioned_phase("federated", tool.FEDERATED_RUNS, digests, sim_runs)

    phase("elastic-membership")
    # 23. elastic partition membership: splits under a flash crowd, merges
    # once it passes, each newborn's solves over its own node tensors
    partitioned_phase("elastic-membership", tool.ELASTIC_RUNS, digests,
                      sim_runs)

    phase("system")
    # 24. the in-process system: webhooks, controllers, vcctl's commands
    # and VolcanoSystem at 10k pods / 2k nodes, preempt and the lifecycle
    # policies
    system_phase(sim_runs)

    phase("rpc")
    # 25. the vc-snapshot-rpc sidecar over TCP at 10k pods / 2k nodes, the
    # native object store, the metrics and health endpoints
    rpc_phase(sim_runs)

    phase("plugins")
    # 26. pod affinity, GPU sharing, conformance, NUMA placement and the
    # proportional guard, each a world held to the JAX package's digest
    plugins_phase(sim_runs)

    phase("summary")
    # 27. the kernels line (launches: the placement kernel's in the 10k
    # cycle, the pre-pass's in the 10k cycle with taints, the one that gives
    # it a static matrix, the walk's in the deployed cycle of the tight mix,
    # the one where preempt has work, the block auction's in the tpu-blocks
    # cycle at 20k; times and bounds of B4 on that cycle's first solve), the
    # card, the result
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
        "name": "place_topo",
        "route": "cuda",
        "source": "volcano_tpu_torch/ops/csrc/place.cu",
        "replaces": "volcano_tpu/ops/place.py:249",
        "launches": elastic_out[ELASTIC_MAIN]["launches"]["place_topo"],
        "max_abs_err": max(r["max_abs_err"] for r in topo_records),
        "ms": topo_rec["ms"],
        "plain_ms": topo_rec["plain_ms"],
        "bound_ms": topo_rec["bound_ms"],
        "bound_by": topo_rec["bound_by"],
        "library_ms": None,
        "b1_ms_same_inputs": topo_rec["b1_ms"],
        "T": topo_rec["T"], "N": topo_rec["N"],
        "scored_pairs": topo_rec["scored_pairs"],
        "b1_scored_pairs": topo_rec["b1_scored_pairs"],
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
    }, {
        "name": "evict_walk",
        "route": "cuda",
        "source": "volcano_tpu_torch/ops/csrc/evict.cu",
        "replaces": "volcano_tpu/ops/evict.py:249",
        "launches": deployed["tight-mix"]["evict_walk"],
        "max_abs_err": max(r["max_abs_err"] for r in walk_records),
        "ms": walk_main["ms"],
        "plain_ms": walk_main["plain_ms"],
        "bound_ms": walk_main["bound_ms"],
        "bound_by": walk_main["bound_by"],
        "bound_all_pairs_ms": walk_main["bound_all_pairs_ms"],
        "library_ms": None,
        "steps": walk_main["steps"],
        "us_per_task": walk_main["us_per_task"],
        "redispatched": walk_main["redispatched"],
        "bulks": walk_main["bulks"],
        "in_smem": walk_main["in_smem"],
        "threads": walk_main["threads"],
    }, {
        "name": "decode_packed",
        "route": "cuda",
        "source": "volcano_tpu_torch/ops/csrc/place.cu",
        "replaces": "volcano_tpu/ops/pallas_place.py:471",
        "launches": pipelined_runs[backlog_key][0]["launches"][
            "decode_packed"],
        "max_abs_err": max(r["max_abs_err"] for r in decode_records),
        "ms": decode_rec["ms"],
        "plain_ms": decode_rec["plain_ms"],
        "bound_ms": decode_rec["bound_ms"],
        "bound_by": decode_rec["bound_by"],
        "library_ms": None,
        "T": decode_rec["T"], "J": decode_rec["J"],
    }]
    solve20 = big_blocks["20k"]
    extra = {
        "blocks_prep": {
            "classes_in_chunks": solve20["counts"]["classes"],
            "chunks_exact": solve20["counts"]["chunks_exact"],
            "plain_ms": solve20["prep_plain_ms"],
            "note": ("new with the redesign: each row's class and each "
                     "chunk's exactness flag, once a solve"),
        },
        "blocks_topk": {
            "classes": solve20["counts"]["classes"],
            "rows": solve20["counts"]["rows"],
            "us_per_chunk": solve20["us_per_chunk"],
            "bound_all_rows_ms": solve20["bound"]["blocks_topk_all_rows"][0],
            "library_call": ("torch.topk over the first chunk's [C, N] "
                             "masked scores: the selection only, one "
                             "launch's worth"),
        },
        "blocks_round": {
            "rounds": solve20["counts"]["rounds"],
            "us_per_round": solve20["us_per_round"],
            "chunks_by_mode": solve20["modes"],
            "ptxas": round_ptxas,
        },
        "blocks_free": {"prep_ms": solve20["kernel_ms"]["blocks_free_prep"]},
    }
    for k in BLOCK_KERNELS:
        kernels.append({
            "name": k,
            "route": "cuda",
            "source": "volcano_tpu_torch/ops/csrc/blocks.cu",
            "replaces": ("volcano_tpu/ops/unified.py:313" if k == "blocks_free"
                         else "volcano_tpu/ops/unified.py:152"),
            "launches": blocks_cycles["20k"][k],
            "max_abs_err": max(r["max_abs_err"] for r in blocks_records),
            "ms": solve20["kernel_ms"][k],
            "plain_ms": solve20["plain_kernel_ms"].get(k, 0.0),
            "bound_ms": solve20["bound"][k][0],
            "bound_by": solve20["bound"][k][1],
            "library_ms": topk_library if k == "blocks_topk" else None,
            "launches_per_solve": solve20["launches"][k],
            **extra[k],
            "solve_ms": solve20["ms"],
            "plain_solve_ms": solve20["plain_ms"],
        })
    for rec in kernels:
        rec["sim_launches"] = {name: launches[rec["name"]]
                               for name, launches in sim_runs.items()}
    check_contained("summary")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == [_SYNC_CHILD_FLAG]:
        sys.exit(cuda_error_child())
    try:
        rc = main()
    except BaseException:
        stop_cpu_references()
        raise
    sys.exit(rc)
