"""The snapshot RPC's reference decisions: each world's snapshot message
through the JAX package's ``SchedulerService`` and the port's, digested
the same way. ``chip_smoke.py``'s ``rpc`` phase sends the same messages
over TCP to the port's sidecar on the card and holds the replies to
``tests/rpc_reference_digests.json``.

Worlds (the message is the port's ``encode_snapshot`` of a
``cache/synthetic`` world's first snapshot, seed 0; both packages decode
the same bytes):

- ``rpc-10k``: ``baseline_config("10k")`` (10,000 pending pods in 200
  gangs, 2,000 nodes) under deploy/scheduler.conf: one B1 solve binds
  every pod;
- ``rpc-10k-blocks``: the same snapshot under ``BLOCKS_CONF``
  (tests/test_rpc.py's conf: ``allocate-tpu`` with ``tpu-blocks``): B4;
- ``rpc-preempt``: the tight running+pending mix, ``preempt_mix_cache(
  n_nodes=400, n_tasks=10000, n_jobs=200)`` (half of the gangs running),
  under deploy/scheduler.conf: allocate leaves gangs starving and
  preempt's walk (B3) evicts for them. (``baseline_config("preempt")``
  under this conf gets every gang to its minimum in allocate, so preempt
  has no starving job and walks nothing.)

A decisions record is the SHA-256 of the reply's canonical JSON (binds and
evictions in reply order, each PodGroup's phase and conditions without
their transition time and session id) with its counts. The JAX side runs
in a child at ``--xla_backend_optimization_level=0``, its preempt walk in
the per-task formulation (ROADMAP §3: its closed-form fill is not its
per-task walk), as tools/system_reference.py runs it. Beside each JAX
record the file keeps the port's CPU path's solve counts (``port_cpu``:
B1 and B4 solves, B3 walks, the block auction's passes and sweeps).

    JAX_PLATFORMS=cpu python tools/rpc_reference.py --write
    python tools/rpc_reference.py --run rpc-10k --device cpu   # the port
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
DIGESTS = os.path.join(REPO, "tests", "rpc_reference_digests.json")
DEPLOYED = os.path.join(REPO, "deploy", "scheduler.conf")
NO_FMA_XLA_FLAGS = "--xla_backend_optimization_level=0"
RECORD_MARKER = "rpc-reference-record "

BLOCKS_CONF = ('actions: "enqueue, allocate-tpu, backfill"\n'
               'tiers:\n'
               '- plugins:\n'
               '  - name: priority\n'
               '  - name: gang\n'
               '- plugins:\n'
               '  - name: drf\n'
               '  - name: predicates\n'
               '  - name: proportion\n'
               '  - name: nodeorder\n'
               'configurations:\n'
               '- name: allocate-tpu\n'
               '  arguments:\n'
               '    engine: tpu-blocks\n')

# world -> (synthetic world, conf: "deployed" or "blocks")
WORLDS = {"rpc-10k": ("10k", "deployed"),
          "rpc-10k-blocks": ("10k", "blocks"),
          "rpc-preempt": ("tight-mix", "deployed")}


def _sha(value) -> str:
    return hashlib.sha256(json.dumps(
        value, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


def conf_text(world: str) -> str:
    if WORLDS[world][1] == "blocks":
        return BLOCKS_CONF
    with open(DEPLOYED) as f:
        return f.read()


def world_snapshot(world: str):
    """The world's first snapshot, built by the port (no JAX)."""
    from volcano_tpu_torch.cache import synthetic
    name = WORLDS[world][0]
    if name == "tight-mix":
        cache = synthetic.preempt_mix_cache(n_nodes=400, n_tasks=10000,
                                            n_jobs=200)[0]
    else:
        cache = synthetic.baseline_config(name, seed=0)[0]
    return cache.snapshot()


def encode(snap) -> dict:
    """A snapshot's message, as JSON carries it."""
    from volcano_tpu_torch.rpc import encode_snapshot
    return json.loads(json.dumps(encode_snapshot(
        list(snap.nodes.values()), list(snap.jobs.values()),
        list(snap.queues.values()))))


def snapshot_message(world: str) -> dict:
    return encode(world_snapshot(world))


def message_sha256(msg: dict) -> str:
    return _sha(msg)


def _conditions(conds) -> list:
    return [{k: v for k, v in c.items()
             if k not in ("lastTransitionTime", "transitionID")}
            for c in conds]


def decisions_record(out: dict) -> dict:
    """A decisions reply as its canonical digest and counts."""
    binds = [[b["uid"], b["namespace"], b["name"], b["node"]]
             for b in out["binds"]]
    evicts = [[e["uid"], e["namespace"], e["name"], e["reason"]]
              for e in out["evicts"]]
    groups = [[p["uid"], p["phase"], _conditions(p["conditions"])]
              for p in out["podgroups"]]
    phases: dict = {}
    for _, phase, _ in groups:
        phases[phase] = phases.get(phase, 0) + 1
    return {"decisions_sha256": _sha([binds, evicts, groups]),
            "binds_sha256": _sha(binds), "binds": len(binds),
            "evicts_sha256": _sha(evicts), "evicts": len(evicts),
            "podgroups_sha256": _sha(groups), "podgroups": len(groups),
            "podgroup_phases": dict(sorted(phases.items()))}


class SolveCounter:
    """Counts the port's solves while installed: each allocate solve of
    the fused and blocks engines (``_fused_solution``) and each preempt
    walk (``evict_tpu.walk``)."""

    def __init__(self):
        from volcano_tpu_torch.actions import allocate, evict_tpu
        self.allocate, self.evict_tpu = allocate, evict_tpu
        self.solves = self.walks = 0
        self._solution = allocate._fused_solution
        self._walk = evict_tpu.walk

        def solution(*a, **kw):
            self.solves += 1
            return self._solution(*a, **kw)

        def walk(*a, **kw):
            self.walks += 1
            return self._walk(*a, **kw)

        allocate._fused_solution = solution
        evict_tpu.walk = walk

    def close(self) -> None:
        self.allocate._fused_solution = self._solution
        self.evict_tpu.walk = self._walk


def run_port(world: str, device=None, msg=None) -> dict:
    """One world through the port's SchedulerService in process: the
    decisions record, the solve counts and the wall seconds."""
    from volcano_tpu_torch.framework import get_action
    from volcano_tpu_torch.rpc import SchedulerService
    msg = snapshot_message(world) if msg is None else msg
    service = SchedulerService(conf_text(world), device=device)
    counter = SolveCounter()
    t0 = time.perf_counter()
    try:
        out = service.schedule(msg)
    finally:
        counter.close()
    stats = get_action("allocate-tpu").last_stats
    blocks = stats.get("blocks") or {}
    return {"record": decisions_record(out),
            "solves": {"allocate": counter.solves, "walks": counter.walks,
                       "blocks_passes": blocks.get("passes", 0),
                       "blocks_sweeps": blocks.get("sweeps", 0)},
            "wall_s": time.perf_counter() - t0}


def _per_task_walk() -> None:
    """The JAX walk in its per-task formulation (tools/sim_reference.py)."""
    # the JAX preempt imports the builder from this module at each walk
    evict = importlib.import_module("volcano_tpu.ops.evict")
    build = evict.build_preempt_walk

    def per_task(kinds, sizes, gang_commit, allow_cheap=True, axis=None):
        return build(kinds, sizes, gang_commit, False, axis)

    evict.build_preempt_walk = per_task


def _child(world: str, msg_path: str) -> int:
    from volcano_tpu.rpc import SchedulerService
    _per_task_walk()
    with open(msg_path) as f:
        msg = json.load(f)
    out = SchedulerService(conf_text(world)).schedule(msg)
    print(RECORD_MARKER + json.dumps(decisions_record(out), sort_keys=True),
          flush=True)
    return 0


def _child_env() -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    if NO_FMA_XLA_FLAGS not in flags:
        env["XLA_FLAGS"] = (flags + " " + NO_FMA_XLA_FLAGS).strip()
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH", "")) if p)
    return env


def jax_record(world: str, msg: dict, timeout: float = 3600) -> dict:
    """One world through the JAX package's service in a child process."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "snapshot.json")
        with open(path, "w") as f:
            json.dump(msg, f)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", world,
             path], cwd=REPO, env=_child_env(), capture_output=True,
            text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"JAX world {world} failed (exit "
                           f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith(RECORD_MARKER)]
    return json.loads(lines[-1][len(RECORD_MARKER):])


def load_digests() -> dict:
    with open(DIGESTS) as f:
        return json.load(f)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--child"]:
        return _child(argv[1], argv[2])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help=f"compute every world through the JAX package "
                         f"and write {DIGESTS}")
    ap.add_argument("--run", choices=sorted(WORLDS),
                    help="print one world's record through the port")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.run:
        print(json.dumps(run_port(args.run, args.device), sort_keys=True))
        return 0
    if not args.write:
        ap.error("one of --write / --run is required")
    worlds = {}
    for world in WORLDS:
        msg = snapshot_message(world)
        record = jax_record(world, msg)
        port = run_port(world, "cpu", msg)
        if port["record"] != record:
            print(f"{world}: the port's CPU path differs from the JAX "
                  f"package's: {port['record']} against {record}",
                  file=sys.stderr)
        record.update(snapshot_sha256=message_sha256(msg),
                      port_cpu=port["solves"])
        worlds[world] = record
        print(f"{world}: {record}", file=sys.stderr)
    doc = {"schema": "volcano-tpu-rpc-reference/v1",
           "command": "JAX_PLATFORMS=cpu python tools/rpc_reference.py "
                      "--write",
           "xla_flags": NO_FMA_XLA_FLAGS,
           "worlds": worlds}
    with open(DIGESTS, "w") as f:
        f.write(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
