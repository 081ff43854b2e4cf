"""Compute the JAX package's sim decision planes, the reference the
PyTorch port's ``volcano_tpu_torch.sim`` is held to byte for byte.

For each run it executes ``python -m volcano_tpu.sim --deterministic`` in
a child process with ``XLA_FLAGS=--xla_backend_optimization_level=0``
(compiled at its default level XLA:CPU contracts multiplies into fused
multiply-adds and flips near-ties; the port rounds every operation on its
own) and records the SHA-256 and byte count of what it printed. The
printed plane counts binds and evictions but never names a node, so the
child also records the SHA-256 of the run's side-effect sequence: every
bind as [task uid, node] and every eviction's task uid, in the order they
reached the cluster (``volcano_tpu_torch/sim/report.py::decision_sequence``
serializes the port's run the same way). It records too, solve by
solve, the node-tensor path the JAX allocate took (its persistent,
scatter-updated rows or a fresh build; a full rebuild or a scatter and its
rows) and each drift the shadow verifier repaired
(``tools/sim_traces.py::TensorPathRecorder``). The digests go to
``tests/sim_reference_digests.json``, which ``chip_smoke.py`` holds the
card's runs to, since the card has no JAX.

A run is a named scenario or a trace of ``tools/sim_traces.py`` (``churn``,
``hole-10k``, ``backlog-16k``, ``elastic-10k``), written to a JSONL file
and replayed with ``--trace``, and may set environment switches:
``VOLCANO_TPU_INCREMENTAL_SNAPSHOT=0`` runs the JAX package with its
incremental snapshot and persistent tensors off. A ``--conf`` of the form
``conf:NAME`` names a conf of ``tools/sim_traces.py::CONFS``
(``elastic-deployed-10``, ``elastic-deployed-0``), written to a file.

The JAX package's persistent node tensors
(``volcano_tpu/cache/snapshot.py::PersistentNodeTensors``) have no
``device_zone_code``, which ``_solve_fused`` calls at a positive
``topology-weight`` (``actions/allocate.py:1406``): with its incremental
snapshot on (the default) every such solve raises AttributeError and the
cycle falls back to the sequential placer, so the zone-anchor solve never
runs. The child mends that: it gives the class the method, returning the
zone-code row its device rows already hold (as ``NodeTensors`` and
``TensorEpochView`` do). Nothing else reads it, so only runs with a
positive topology weight change. With the switch off the JAX package builds
fresh ``NodeTensors`` and needs no mend; the elastic runs include one so.

The JAX preempt walk (``volcano_tpu/ops/evict.py::build_preempt_walk``)
has two modes: its per-task formulation (``allow_cheap=False``) and a
closed-form same-node fill (the default) that its docstring holds
bit-identical to it. It is not: the fill keeps a victim's drf share from
the start of the fill, but evicting a same-job victim of LATER candidate
rank lowers that share, and the per-task walk then drops the victim
(``preempt-burst``, cycle 47: the default fill places a 4-task gang whose
last task the per-task walk and the callbacks engine do not place). The
port's walk is the per-task one, so the reference here runs the JAX walk
in that mode ("exact"); the default mode's digests are recorded beside
them.

Regenerate the file (CPU, about fifteen minutes), or only the named runs
(merged into the file)::

    JAX_PLATFORMS=cpu python tools/sim_reference.py --write
    JAX_PLATFORMS=cpu python tools/sim_reference.py --write \
        --keys "--trace churn --conf deploy/scheduler.conf"

Print one run's bytes::

    JAX_PLATFORMS=cpu python tools/sim_reference.py --run smoke \\
        --conf deploy/scheduler.conf --chaos-rate 0.2 --kill-cycles 5,12

A run whose arguments end in ``--trace-out`` (no value: the child writes
the trace to a temporary file) is a flight-recorder run: beside the
plane and the sequence, the child records ``obs_digests`` of what the
recorder saw — the Chrome trace with each ``solve`` span's ``kernel``
attribute replaced by one placeholder (it names the solve's route, which
differs between the packages by design), every decision-audit record
(``AUDIT.records()``; such runs set ``VOLCANO_TPU_AUDIT_CYCLES`` large, so
the ring keeps every cycle) and every job's timeline events, in job
order.

Long runs under ``deploy/scheduler.conf`` compile one XLA executable per
new shape and keep them all; past the kernel's limit on memory maps
(65,530 by default) LLVM can no longer map new code and the process
aborts. The child therefore clears JAX's compilation caches between
cycles once its map count passes a threshold. Recompiling the same
program at the same optimization level gives the same code, so this
changes when compiles happen, not what the run decides.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
DIGESTS = os.path.join(REPO, "tests", "sim_reference_digests.json")
DEPLOYED = "deploy/scheduler.conf"
NO_FMA_XLA_FLAGS = "--xla_backend_optimization_level=0"
MAPS_LIMIT = 40000
# JAX children at once under --write: each holds one to two GiB
JOBS = 6
# the child's last line on stderr: this marker, then the sequence digest
SEQUENCE_MARKER = "sim-reference-sequence "

# the switch that turns the incremental snapshot and the persistent node
# tensors off, in both packages
OFF = (("VOLCANO_TPU_INCREMENTAL_SNAPSHOT", "0"),)
# a decision-audit ring that keeps every cycle of a flight-recorder run
# (the default keeps 32; preempt-burst runs 83)
AUDIT_ALL = (("VOLCANO_TPU_AUDIT_CYCLES", "100000"),)
# the flight recorder's arguments: the latency and slo report sections and
# the trace (the child supplies the file)
OBS = ("--lifecycle", "--trace-out")
# the placeholder a trace's solve-span kernel attribute is compared under
KERNEL_PLACEHOLDER = "*"

# (source, sim arguments, environment): every run chip_smoke.py drives on
# the card, and the CPU tests' runs. A source is a scenario name or
# "trace:NAME" of tools/sim_traces.py.
RUNS = (
    ("smoke", (), ()),
    ("smoke", ("--conf", DEPLOYED), ()),
    ("smoke", ("--chaos-rate", "0.2", "--kill-cycles", "5,12"), ()),
    ("smoke", ("--conf", DEPLOYED, "--chaos-rate", "0.2",
               "--kill-cycles", "5,12"), ()),
    ("skew", ("--conf", DEPLOYED), ()),
    ("preempt-burst", ("--conf", DEPLOYED), ()),
    ("baseline-10k", ("--conf", DEPLOYED), ()),
    ("steady-10k", ("--conf", DEPLOYED), ()),
    ("trace:churn", ("--conf", DEPLOYED), ()),
    ("trace:hole-10k", ("--conf", DEPLOYED), ()),
    ("smoke", ("--conf", DEPLOYED), OFF),
    ("preempt-burst", ("--conf", DEPLOYED), OFF),
    ("baseline-10k", ("--conf", DEPLOYED), OFF),
    ("trace:churn", ("--conf", DEPLOYED), OFF),
    ("trace:hole-10k", ("--conf", DEPLOYED), OFF),
    # the pipelined shell under its own conf (runner.PIPELINED_SIM_CONF):
    # the no-conflict world, churn with fast admit, churn with kills (kill
    # seed 5 draws post_cycle, speculate, speculate: two of them land
    # between a speculative dispatch and its commit), and the full-width
    # standing backlog
    ("pipelined-steady", ("--seed", "3", "--pipelined"), ()),
    ("pipelined-conflict", ("--pipelined", "--fast-admit"), ()),
    ("pipelined-conflict", ("--pipelined", "--kill-cycles", "3,8,14",
                            "--kill-seed", "5"), ()),
    ("trace:backlog-16k", ("--pipelined",), ()),
    # elastic gangs: the JAX sim's own conf (runner.elastic_sim_conf, the
    # callbacks engine and the plugin's zone bonus) at weights 10 and 0;
    # deploy/scheduler.conf with elastic gangs (tools/sim_traces.py::
    # elastic_deployed_conf: tpu-fused, at weight 10 the zone-anchor solve)
    # at 10 and 0, at 10 also with the switch off; and the full-width
    # elastic-10k world under it
    ("elastic-churn", ("--elastic-gangs",), ()),
    ("elastic-churn", ("--elastic-gangs", "--topology-weight", "0"), ()),
    ("elastic-churn", ("--elastic-gangs", "--conf",
                       "conf:elastic-deployed-10"), ()),
    ("elastic-churn", ("--elastic-gangs", "--topology-weight", "0",
                       "--conf", "conf:elastic-deployed-0"), ()),
    ("elastic-churn", ("--elastic-gangs", "--conf",
                       "conf:elastic-deployed-10"), OFF),
    ("trace:elastic-10k", ("--elastic-gangs", "--conf",
                           "conf:elastic-deployed-10"), ()),
)

# the flight-recorder runs, apart from RUNS (whose readers drive each run
# as is): each ends in --trace-out, which the caller gives a file
OBS_RUNS = (
    # the flight recorder (latency and slo sections, the trace, the audit
    # and the timelines) on the default conf, deploy/scheduler.conf (B1 at
    # full width, and B3), the elastic deployed conf (B6) and the pipelined
    # shell with fast admit
    ("smoke", OBS, AUDIT_ALL),
    ("preempt-burst", ("--conf", DEPLOYED) + OBS, AUDIT_ALL),
    ("baseline-10k", ("--conf", DEPLOYED) + OBS, AUDIT_ALL),
    ("elastic-churn", ("--elastic-gangs", "--conf",
                       "conf:elastic-deployed-10") + OBS, AUDIT_ALL),
    ("pipelined-conflict", ("--pipelined", "--fast-admit") + OBS,
     AUDIT_ALL),
)


# the object store and the feedback watch path: every pod, podgroup and
# queue a store object behind the retrying transport (--store-wired), with
# seeded verb faults and torn watch streams (--store-chaos), and seeded ack
# faults on the ack wire or, store-wired, on the watch path (--ack-chaos);
# deploy/scheduler.conf throughout but for the pipelined run, which takes
# the runner's pipelined conf
STORE_RUNS = (
    ("smoke", ("--conf", DEPLOYED, "--store-wired"), ()),
    ("smoke", ("--conf", DEPLOYED, "--store-chaos"), ()),
    ("smoke", ("--conf", DEPLOYED, "--ack-chaos"), ()),
    ("smoke", ("--conf", DEPLOYED, "--store-wired", "--ack-chaos"), ()),
    ("preempt-burst", ("--conf", DEPLOYED, "--store-chaos"), ()),
    ("pipelined-conflict", ("--pipelined", "--ack-chaos"), ()),
    ("baseline-10k", ("--conf", DEPLOYED, "--store-wired"), ()),
)


# the HA control plane (--ha 3: three replicas over one cluster, fenced
# leader election, warm standbys tailing the journal): the CI soak's three
# smoke runs on the sim's default conf (seeded leader kills with a
# mid-cycle lease loss, the non-contended run, the faulted lease path),
# each with its --verify-ha-equivalence check; then deploy/scheduler.conf:
# smoke with the same kills, preempt-burst (B3 across four failovers) and
# the full-width baseline-10k, whose kill seed 3 is the first from 2 up
# under which cycle 0's kill lands inside its 10,000-bind funnel (the
# handoff reconcile settles a real crash window: journal_replayed is not
# empty)
HA_KILLS = ("--kill-cycles", "2,5,9,13", "--kill-seed", "2",
            "--lease-loss-cycles", "7")
HA_RUNS = (
    ("smoke", ("--seed", "3", "--ha", "3") + HA_KILLS
     + ("--verify-ha-equivalence",), ()),
    ("smoke", ("--seed", "3", "--ha", "3", "--verify-ha-equivalence"), ()),
    ("smoke", ("--seed", "3", "--ha", "3", "--lease-fault-rate", "0.6",
               "--verify-ha-equivalence"), ()),
    ("smoke", ("--seed", "3", "--conf", DEPLOYED, "--ha", "3") + HA_KILLS,
     ()),
    ("preempt-burst", ("--conf", DEPLOYED, "--ha", "3", "--kill-cycles",
                       "10,30,47", "--kill-seed", "2",
                       "--lease-loss-cycles", "20"), ()),
    ("baseline-10k", ("--conf", DEPLOYED, "--ha", "3", "--kill-cycles",
                      "0,3", "--kill-seed", "3", "--lease-loss-cycles",
                      "5"), ()),
)


# the overload plane (ROADMAP item 9d): CI's overload soak on the sim's
# default conf (the full --overload-chaos preset with four seeded kills and
# --verify-overload-equivalence), the same world under
# deploy/scheduler.conf (B1, and B3 as the run needs it), and CI's SLO run
# (--lifecycle with a per-job event ring of 4096)
OVERLOAD_KILLS = ("--kill-cycles", "2,5,9,13", "--kill-seed", "1")
OVERLOAD_RUNS = (
    ("overload-burst", ("--seed", "3", "--overload-chaos") + OVERLOAD_KILLS
     + ("--verify-overload-equivalence",), ()),
    ("overload-burst", ("--seed", "3", "--conf", DEPLOYED,
                        "--overload-chaos") + OVERLOAD_KILLS, ()),
    ("overload-burst", ("--seed", "3", "--overload-chaos", "--lifecycle"),
     (("VOLCANO_TPU_TIMELINE_EVENTS", "4096"),)),
)

# the child's switch that mends the JAX package's refresh of a node changed
# and then removed (volcano_tpu/cache/snapshot.py::PersistentNodeTensors.
# refresh builds its touch list before the removal loop and raises
# KeyError; Session.snapshot_node_tensors swallows it). The port's refresh
# leaves such a name out, as the mend does.
MEND = (("VOLCANO_TPU_REFERENCE_MEND_REFRESH", "1"),)

# the federated control plane (ROADMAP item 9e without elastic
# membership): CI's federated soak (smoke with four seeded partition kills,
# the non-contended fed-smoke and the reserve-driving fed-starve, each with
# --verify-federated-equivalence), fed-starve again under
# deploy/scheduler.conf (each partition's B1 and B3 over its own node
# tensors, nodes moving between them through the reserve protocol), the
# rebalancer's fed-hotspot under the overload preset, CI's merged
# federated trace, the federated overload soak, the store-backed
# federation under store chaos, and the full-width baseline-10k over four
# partitions (2,000 nodes sharded four ways, 500 a partition; its queues
# default, q1, q2 and q3 round-robin, one a partition, so partition 0's
# queue holds no job and partition 0 places nothing). Kill seed 3 is the
# first from 2 up whose cycle-0 draw (bind_after, at the fifth bind) lands
# inside a partition's bind funnel. Each deploy/scheduler.conf run is
# digested again with the refresh mended (MEND).
FED_KILLS = ("--kill-cycles", "2,5,9,13", "--kill-seed", "2")
FEDERATED_RUNS = (
    ("smoke", ("--seed", "3", "--federated", "4") + FED_KILLS
     + ("--verify-federated-equivalence",), ()),
    ("fed-smoke", ("--seed", "3", "--federated", "4",
                   "--verify-federated-equivalence"), ()),
    ("fed-starve", ("--seed", "3", "--federated", "4",
                    "--verify-federated-equivalence"), ()),
    ("fed-starve", ("--seed", "3", "--conf", DEPLOYED, "--federated", "4",
                    "--verify-federated-equivalence"), ()),
    ("fed-hotspot", ("--seed", "3", "--federated", "4", "--overload-chaos",
                     "--verify-overload-equivalence"), ()),
    ("fed-hotspot", ("--seed", "3", "--federated", "2", "--trace-out"),
     AUDIT_ALL),
    ("overload-burst", ("--seed", "3", "--federated", "4",
                        "--overload-chaos") + FED_KILLS
     + ("--verify-overload-equivalence",), ()),
    ("smoke", ("--seed", "3", "--conf", DEPLOYED, "--store-chaos",
               "--federated", "4") + FED_KILLS, ()),
    ("baseline-10k", ("--conf", DEPLOYED, "--federated", "4",
                      "--kill-cycles", "0,3", "--kill-seed", "3"), ()),
    # the smallest world whose cycle-0 kill (bind_after, at the third bind)
    # leaves an open intent while the later partitions take their first
    # leadership (RECONCILE_RUNS)
    ("baseline-tiny", ("--federated", "4", "--kill-cycles", "0",
                       "--kill-seed", "4"), ()),
)
# elastic partition membership (ROADMAP item 9e′): diurnal-flash-crowd
# from one partition under the overload preset, where chronic cycle-budget
# exhaustion splits the partition and chronic idleness merges the newborns
# back. (a) CI's elastic soak (ci/check.sh): store chaos and four seeded
# kills at split and merge boundaries, with --verify-elastic-equivalence;
# (b) the same world without kills or store chaos (TestElasticSim's
# contract run); (c) (b) under deploy/scheduler.conf, where every
# partition's solve, the newborns' included, is B1 over that partition's
# own node tensors; (d) (b) with (a)'s kills, TestElasticSim's kill run.
ELASTIC_KILLS = ("--kill-cycles", "22,39,134,146")
ELASTIC = ("--seed", "3", "--federated", "1", "--elastic",
           "--overload-chaos")
ELASTIC_RUNS = (
    ("diurnal-flash-crowd", ELASTIC + ("--store-chaos",) + ELASTIC_KILLS
     + ("--verify-elastic-equivalence",), ()),
    ("diurnal-flash-crowd", ELASTIC, ()),
    ("diurnal-flash-crowd", ("--seed", "3", "--conf", DEPLOYED,
                             "--federated", "1", "--elastic",
                             "--overload-chaos"), ()),
    ("diurnal-flash-crowd", ELASTIC + ELASTIC_KILLS, ()),
)
# the deploy/scheduler.conf runs of the lists, mended
MENDED_RUNS = tuple((src, args, env + MEND)
                    for src, args, env in OVERLOAD_RUNS + FEDERATED_RUNS
                    + ELASTIC_RUNS
                    if DEPLOYED in args)

# the child's switch that mends the JAX package's reconcile of a journal
# shared by partitions (volcano_tpu/cache/journal.py::reconcile settles
# EVERY unacked intent against this cache: a partition's first handoff
# acks another partition's crash window as stale, so the killed partition's
# own handoff never rolls its optimistic binds back). Mended, an intent
# that another partition's cache journaled stays open, as the port's
# reconcile leaves it. The runs whose kill lands while another partition
# takes its first leadership are digested with it (baseline-10k also with
# MEND).
MEND_RECONCILE = (("VOLCANO_TPU_REFERENCE_MEND_RECONCILE", "1"),)
RECONCILE_RUNS = (
    ("baseline-tiny", ("--federated", "4", "--kill-cycles", "0",
                       "--kill-seed", "4"), MEND_RECONCILE),
    ("baseline-10k", ("--conf", DEPLOYED, "--federated", "4",
                      "--kill-cycles", "0,3", "--kill-seed", "3"),
     MEND_RECONCILE),
    ("baseline-10k", ("--conf", DEPLOYED, "--federated", "4",
                      "--kill-cycles", "0,3", "--kill-seed", "3"),
     MEND + MEND_RECONCILE),
)


def held_to(run, digests) -> tuple:
    """The JAX record the port's run is held to: the package as is, or with
    each of its faults that fired in the run (the record counts
    ``refresh_faults`` and ``reconcile_faults``) mended, as the port's
    refresh and reconcile are. Returns (record, the switches)."""
    source, args, env = run
    plain = digests[run_key(*run)]
    mends = tuple(env)
    if plain.get("refresh_faults"):
        mends += MEND
    if plain.get("reconcile_faults"):
        mends += MEND_RECONCILE
    return digests[run_key(source, args, mends)], mends


def run_key(source: str, args, env=()) -> str:
    src = (("--trace", source[len("trace:"):])
           if source.startswith("trace:") else ("--scenario", source))
    return " ".join([f"{k}={v}" for k, v in env] + list(src)
                    + list(args))


def sim_argv(source: str, trace_dir: str) -> list:
    """The sim's source arguments: ``--scenario S``, or ``--trace FILE``
    with the trace of tools/sim_traces.py written into ``trace_dir``."""
    if not source.startswith("trace:"):
        return ["--scenario", source]
    from sim_traces import write_trace_file
    name = source[len("trace:"):]
    path = os.path.join(trace_dir, f"{name}.jsonl")
    if not os.path.exists(path):
        write_trace_file(name, path)
    return ["--trace", path]


def conf_args(args, conf_dir: str) -> list:
    """``args`` with each ``--conf conf:NAME`` replaced by the path of that
    conf of tools/sim_traces.py::CONFS, written into ``conf_dir``."""
    from sim_traces import write_conf_file
    out = list(args)
    for i, a in enumerate(out):
        if a.startswith("conf:") and i and out[i - 1] == "--conf":
            name = a[len("conf:"):]
            path = os.path.join(conf_dir, f"{name}.conf")
            if not os.path.exists(path):
                write_conf_file(name, path)
            out[i] = path
    return out


def trace_args(args, trace_dir: str) -> list:
    """``args`` with a trailing ``--trace-out`` given a file in
    ``trace_dir``."""
    out = list(args)
    if out[-1:] == ["--trace-out"]:
        fd, path = tempfile.mkstemp(suffix=".json", dir=trace_dir)
        os.close(fd)
        out.append(path)
    return out


def normalized_trace(obj: dict) -> dict:
    """A Chrome trace object with every ``solve`` span's ``kernel``
    attribute replaced by KERNEL_PLACEHOLDER: the attribute names the
    solve's route (the JAX package's kernel selector, the port's CUDA
    kernel or plain version), the one field the packages' traces may
    differ in."""
    events = []
    for ev in obj["traceEvents"]:
        args = ev.get("args")
        if ev.get("name") == "solve" and args and "kernel" in args:
            ev = dict(ev, args=dict(args, kernel=KERNEL_PLACEHOLDER))
        events.append(ev)
    return dict(obj, traceEvents=events)


def _sha(value) -> str:
    return hashlib.sha256(json.dumps(
        value, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


def obs_digests(trace_obj: dict, audit_records, timelines) -> dict:
    """The flight recorder's digests for one run: the normalized trace,
    the decision-audit records (``AUDIT.records()``) and the timelines
    (``[[job, TIMELINE.events(job)], ...]`` in ``TIMELINE.jobs()``
    order), each as canonical JSON's SHA-256 with its count."""
    trace = normalized_trace(trace_obj)
    return {"trace_sha256": _sha(trace),
            "trace_events": len(trace["traceEvents"]),
            "audit_sha256": _sha(list(audit_records)),
            "audit_records": len(audit_records),
            "timeline_sha256": _sha([list(t) for t in timelines]),
            "timeline_events": sum(len(ev) for _, ev in timelines)}


def recorder_state(obs_module) -> tuple:
    """(audit records, timelines) of a package's ``obs`` module after a
    run."""
    tl = obs_module.TIMELINE
    return (obs_module.AUDIT.records(),
            [(job, tl.events(job)) for job in tl.jobs()])


def _child_env(env=()) -> dict:
    env = dict(os.environ, **dict(env))
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    if NO_FMA_XLA_FLAGS not in flags:
        env["XLA_FLAGS"] = (flags + " " + NO_FMA_XLA_FLAGS).strip()
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH", "")) if p)
    return env


_TRACE_DIR = None


def _trace_dir() -> str:
    global _TRACE_DIR
    if _TRACE_DIR is None:
        _TRACE_DIR = tempfile.mkdtemp(prefix="sim-traces-")
    return _TRACE_DIR


def start(source: str, args=(), walk: str = "exact",
          env=()) -> subprocess.Popen:
    """Start the JAX sim for one run in a child process; its stdout is the
    decision plane's canonical JSON. ``walk`` picks the JAX preempt walk's
    mode: "exact" (its per-task formulation) or "default"; ``env`` adds
    environment switches."""
    cmd = [sys.executable, os.path.abspath(__file__), "--child", walk,
           *sim_argv(source, _trace_dir()), "--deterministic",
           *trace_args(conf_args(args, _trace_dir()), _trace_dir())]
    return subprocess.Popen(cmd, cwd=REPO, env=_child_env(env),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def finish_record(proc: subprocess.Popen, timeout: float = 3600):
    """Wait for a child of ``start``: returns the decision plane's bytes
    and the child's record ({sha256, binds, evicts, tensor_paths})."""
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"JAX sim failed (exit {proc.returncode}):\n"
                           f"{err.decode(errors='replace')[-4000:]}")
    lines = [line for line in err.decode().splitlines()
             if line.startswith(SEQUENCE_MARKER)]
    if len(lines) != 1:
        raise RuntimeError("JAX sim child printed no sequence digest")
    return out, json.loads(lines[0][len(SEQUENCE_MARKER):])


def finish(proc: subprocess.Popen, timeout: float = 3600):
    """Wait for a child of ``start``: returns the decision plane's bytes
    and the run's sequence digest ({sha256, binds, evicts})."""
    out, record = finish_record(proc, timeout)
    record.pop("tensor_paths")
    record.pop("obs", None)
    return out, record


def sequence_digest(runner) -> dict:
    """The SHA-256 of a SimRunner's bind and eviction sequence, serialized
    as ``volcano_tpu_torch.sim.report.decision_sequence`` does."""
    text = json.dumps({"binds": [list(b) for b in runner.binder.sequence],
                       "evicts": list(runner.evictor.sequence)},
                      separators=(",", ":")).encode()
    return {"sha256": hashlib.sha256(text).hexdigest(),
            "binds": len(runner.binder.sequence),
            "evicts": len(runner.evictor.sequence)}


def digest(text: bytes) -> dict:
    return {"sha256": hashlib.sha256(text).hexdigest(), "bytes": len(text)}


def _child(walk: str, argv) -> int:
    """Run ``volcano_tpu.sim``'s CLI in this process, clearing JAX's
    caches between cycles whenever the process holds more than
    MAPS_LIMIT memory maps; with ``walk`` "exact", the preempt walk runs
    its per-task formulation. Prints the reported run's sequence digest
    to stderr after SEQUENCE_MARKER."""
    import jax
    from sim_traces import TensorPathRecorder
    from volcano_tpu import scheduler as jax_scheduler
    from volcano_tpu.actions import allocate as jax_allocate
    from volcano_tpu.cache import SchedulerCache
    from volcano_tpu.cache.snapshot import PersistentNodeTensors
    from volcano_tpu.ops import evict as jax_evict
    from volcano_tpu.sim.__main__ import main
    from volcano_tpu.sim.runner import SimRunner

    if walk == "exact":
        build = jax_evict.build_preempt_walk

        def build_exact(kinds, sizes, gang_commit, allow_cheap=True,
                        axis=None):
            return build(kinds, sizes, gang_commit, False, axis)

        jax_evict.build_preempt_walk = build_exact

    if os.environ.get(MEND[0][0]) == "1":
        # MEND's switch: a name changed and then removed before the refresh
        # is left out of the touch list (tests/torch_parity.py::
        # _mend_jax_refresh)
        sys.path.insert(0, os.path.join(REPO, "tests"))
        from torch_parity import _mend_jax_refresh
        _mend_jax_refresh(PersistentNodeTensors)
    from volcano_tpu.cache import journal as jax_journal
    reconcile_faults = []
    jax_reconcile = jax_journal.reconcile
    mend_reconcile = os.environ.get(MEND_RECONCILE[0][0]) == "1"
    # seq -> the cache whose funnel journaled the intent: the partition
    # the port's intent records carry (its ``part``), with or without the
    # lifecycle timeline
    owners = {}
    journal_intent = SchedulerCache._journal_intent

    def owned_intent(self, *args, **kwargs):
        seq = journal_intent(self, *args, **kwargs)
        if seq is not None:
            owners[seq] = self
        return seq

    SchedulerCache._journal_intent = owned_intent

    def partitioned_reconcile(cache, journal, *args, **kwargs):
        # MEND_RECONCILE's switch: the intents another partition's cache
        # journaled stay open (the port's reconcile); unmended, count them
        # as they are settled stale
        foreign = [i for i in journal.unacked()
                   if owners.get(i.seq, cache) is not cache]
        if not mend_reconcile:
            reconcile_faults.extend(foreign)
            return jax_reconcile(cache, journal, *args, **kwargs)
        skip = {i.seq for i in foreign}
        unacked = journal.unacked
        journal.unacked = lambda: [i for i in unacked()
                                   if i.seq not in skip]
        try:
            return jax_reconcile(cache, journal, *args, **kwargs)
        finally:
            del journal.unacked

    jax_journal.reconcile = partitioned_reconcile
    refresh_faults = []
    jax_refresh = PersistentNodeTensors.refresh

    def counted_refresh(self, nodes, changed):
        # the unmended refresh's KeyError, counted before the session
        # swallows it
        try:
            return jax_refresh(self, nodes, changed)
        except KeyError as exc:
            refresh_faults.append(str(exc))
            raise

    PersistentNodeTensors.refresh = counted_refresh

    if not hasattr(PersistentNodeTensors, "device_zone_code"):
        # the module docstring's mend
        PersistentNodeTensors.device_zone_code = \
            lambda self: self._device["zone_code"]

    def map_count() -> int:
        try:
            with open("/proc/self/maps") as f:
                return sum(1 for _ in f)
        except OSError:
            return 0

    run_once = jax_scheduler.Scheduler.run_once

    def bounded_run_once(self):
        if map_count() > MAPS_LIMIT:
            jax.clear_caches()
        return run_once(self)

    jax_scheduler.Scheduler.run_once = bounded_run_once

    runners = []
    sim_run = SimRunner.run

    def recorded_run(self):
        runners.append(self)
        return sim_run(self)

    SimRunner.run = recorded_run
    paths = TensorPathRecorder(jax_allocate, SchedulerCache)
    rc = main(argv)
    if rc == 0:
        sys.stdout.flush()
        record = dict(sequence_digest(runners[0]),
                      tensor_paths=paths.summary())
        if refresh_faults:
            record["refresh_faults"] = len(refresh_faults)
        if reconcile_faults:
            record["reconcile_faults"] = len(reconcile_faults)
        if "--trace-out" in argv:
            from volcano_tpu import obs
            with open(argv[argv.index("--trace-out") + 1]) as f:
                trace = json.load(f)
            record["obs"] = obs_digests(trace, *recorder_state(obs))
        print(SEQUENCE_MARKER + json.dumps(record), file=sys.stderr)
    return rc


def _entry(source, run_args, env, exact, default) -> dict:
    out, record = exact
    other_out, other_record = default
    other = digest(other_out)
    return {"key": run_key(source, run_args, env),
            "source": source, "args": list(run_args),
            "env": dict(env), **digest(out),
            "sequence_sha256": record["sha256"],
            "sequence_binds": record["binds"],
            "sequence_evicts": record["evicts"],
            "tensor_paths": record["tensor_paths"],
            "default_walk_sha256": other["sha256"],
            "default_walk_bytes": other["bytes"],
            "default_walk_sequence_sha256": other_record["sha256"],
            **({"obs": record["obs"]} if "obs" in record else {}),
            **{k: record[k] for k in ("refresh_faults", "reconcile_faults")
               if k in record}}


def _run_all(runs) -> dict:
    """Each run in both walk modes, at most JOBS children at once:
    (run, walk) -> (plane bytes, record)."""
    pending = [(run, walk) for run in runs for walk in ("exact", "default")]
    running, results = [], {}
    while pending or running:
        while pending and len(running) < JOBS:
            (source, run_args, env), walk = item = pending.pop(0)
            running.append((item, start(source, run_args, walk, env)))
        item, proc = running.pop(0)
        results[item] = finish_record(proc)
    return results


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--child"]:
        return _child(argv[1], argv[2:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help=f"compute the runs of RUNS, OBS_RUNS, "
                         f"STORE_RUNS, HA_RUNS, OVERLOAD_RUNS, "
                         f"FEDERATED_RUNS, ELASTIC_RUNS, MENDED_RUNS and "
                         f"RECONCILE_RUNS "
                         f"and write {DIGESTS}")
    ap.add_argument("--keys", nargs="+", metavar="KEY",
                    help="with --write: compute only these runs and merge "
                         "them into the file")
    ap.add_argument("--run", metavar="SOURCE",
                    help="print one run's decision plane (a scenario, or "
                         "trace:NAME)")
    ap.add_argument("--walk", choices=("exact", "default"),
                    default="exact",
                    help="the JAX preempt walk's mode for --run")
    args, rest = ap.parse_known_args(argv)
    if args.run:
        out, record = finish_record(start(args.run, rest, args.walk))
        sys.stdout.buffer.write(out)
        print(f"record: {json.dumps(record)}", file=sys.stderr)
        return 0
    if not args.write:
        ap.error("one of --write / --run is required")
    every = (RUNS + OBS_RUNS + STORE_RUNS + HA_RUNS + OVERLOAD_RUNS
             + FEDERATED_RUNS + ELASTIC_RUNS + MENDED_RUNS + RECONCILE_RUNS)
    runs = [r for r in every
            if args.keys is None or run_key(*r) in args.keys]
    if args.keys is not None and len(runs) != len(args.keys):
        ap.error(f"unknown keys; known: {[run_key(*r) for r in every]}")
    results = _run_all(runs)
    fresh = {}
    for run in runs:
        entry = _entry(*run, results[(run, "exact")],
                       results[(run, "default")])
        fresh[entry["key"]] = entry
        print(f"{entry['key']}: {entry['bytes']} bytes"
              f"{'' if entry['default_walk_sha256'] == entry['sha256'] else ' (default walk differs)'}",
              file=sys.stderr)
    old = {}
    if args.keys is not None:
        with open(DIGESTS) as f:
            old = {run["key"]: run for run in json.load(f)["runs"]}
    entries = [fresh.get(run_key(*r)) or old[run_key(*r)] for r in every]
    doc = {"schema": "volcano-tpu-sim-report/v1",
           "command": "JAX_PLATFORMS=cpu python tools/sim_reference.py "
                      "--write",
           "xla_flags": NO_FMA_XLA_FLAGS, "walk": "exact",
           "runs": entries}
    with open(DIGESTS, "w") as f:
        f.write(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
