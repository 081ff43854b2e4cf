"""The sharded worlds' reference decisions: the ``tpu-sharded`` engine at
full width, the mesh-chaos and sharded sims, and ``callbacks-parallel``,
each run through either package and digested the same way.
``chip_smoke.py``'s ``sharded`` phase runs the port's worlds on the card at
8 slots and holds them to ``tests/sharded_reference_digests.json``, to the
port's one-slot run on the card and to its CPU path.

Every world takes the package's name (``volcano_tpu`` or
``volcano_tpu_torch``) and imports it, so the port's runs import no JAX. The
JAX package runs in a child process on 8 virtual CPU devices
(``--xla_force_host_platform_device_count=8``) without FMA contraction,
its tier dispatch mended as tests/torch_parity.py mends it; the port runs
over ``slots`` slots of ops/unified.py. A world is one cycle of
``deploy/scheduler.conf`` with the engine lines it names, on a logical
clock (a cycle is one second):

- ``sharded-10k`` (full width, B4 over a mesh and the sharded walk's
  path): ``baseline_config("10k")``, seed 0; allocate-tpu, preempt and
  reclaim on ``tpu-sharded``.
- ``sharded-tight`` (the sharded walk): ``preempt_mix_cache(n_nodes=400,
  n_tasks=10000, n_jobs=200)``, seed 0; preempt on ``tpu-sharded``.
- ``sharded-20k`` (B4 over a mesh): ``baseline_config("20k")``, seed 0;
  allocate-tpu on ``tpu-sharded``.
- ``callbacks-parallel-1k``: the default conf's allocate on
  ``callbacks-parallel``, ``baseline_config("1k", seed=3)``; and
  ``callbacks-1k``, the same on the serial ``callbacks`` engine (no JAX
  record: callbacks-parallel's is its).

The sims (``SIMS``) are ``python -m PACKAGE.sim ARGS --deterministic`` (the
port's with ``--device``): the record is the sha256 of the decision plane
it prints.

    python tools/sharded_reference.py --write    # JAX records -> the file
    python tools/sharded_reference.py --run sharded-10k --device cuda
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tools")]
DIGESTS = os.path.join(REPO, "tests", "sharded_reference_digests.json")
DEPLOYED = os.path.join(REPO, "deploy", "scheduler.conf")
XLA_FLAGS = ("--xla_backend_optimization_level=0 "
             "--xla_force_host_platform_device_count=8")
RECORD_MARKER = "sharded-reference-record "
SLOTS = 8

# world -> (world maker, engines by action, the conf: "deployed" or "default")
WORLDS = {
    "sharded-10k": (("baseline", "10k", 0),
                    {"allocate-tpu": "tpu-sharded", "preempt": "tpu-sharded",
                     "reclaim": "tpu-sharded"}, "deployed"),
    "sharded-tight": (("tight",), {"preempt": "tpu-sharded"}, "deployed"),
    "sharded-20k": (("baseline", "20k", 0), {"allocate-tpu": "tpu-sharded"},
                    "deployed"),
    "callbacks-parallel-1k": (("baseline", "1k", 3),
                              {"allocate": "callbacks-parallel"}, "default"),
    "callbacks-1k": (("baseline", "1k", 3), {"allocate": "callbacks"},
                     "default"),
}
# the world the JAX package is not run on: callbacks-1k, the serial engine
# callbacks-parallel is held to (callbacks-parallel-1k's record is its)
NO_JAX = ("callbacks-1k",)
SIMS = {
    "sim-mesh-chaos": ["--scenario", "mesh-chaos", "--mesh-chaos",
                       "--verify-mesh-equivalence", "--kill-cycles", "6,17",
                       "--deterministic"],
    "sim-smoke-sharded": ["--scenario", "smoke", "--seed", "3", "--sharded",
                          "--verify-sharded-equivalence", "--deterministic"],
}


def _sha(value) -> str:
    return hashlib.sha256(json.dumps(value, sort_keys=True,
                                     separators=(",", ":")).encode()
                          ).hexdigest()


def world_conf(world: str) -> str:
    """The world's conf text: deploy/scheduler.conf with its engine lines
    set (an action without a block gets one), or the default conf with an
    allocate block."""
    _, engines, base = WORLDS[world]
    if base == "default":
        from volcano_tpu_torch.framework import DEFAULT_SCHEDULER_CONF
        return DEFAULT_SCHEDULER_CONF + "configurations:\n" + "".join(
            f"- name: {a}\n  arguments:\n    engine: {e}\n"
            for a, e in engines.items())
    with open(DEPLOYED) as f:
        conf = f.read()
    for action, engine in engines.items():
        head = f"- name: {action}\n  arguments:\n    engine: "
        at = conf.index(head) + len(head)
        end = conf.index("\n", at)
        conf = conf[:at] + engine + conf[end:]
    return conf


def build_world(pkg, world: str):
    """(cache, binder, evictor) of the world in package ``pkg``."""
    spec = WORLDS[world][0]
    if spec[0] == "baseline":
        return pkg.cache.synthetic.baseline_config(spec[1], seed=spec[2])
    return pkg.cache.synthetic.preempt_mix_cache(n_nodes=400, n_tasks=10000,
                                                 n_jobs=200)


def package(name: str):
    import importlib
    pkg = importlib.import_module(name)
    for sub in ("cache.synthetic", "scheduler", "plugins", "actions"):
        importlib.import_module(f"{name}.{sub}")
    return pkg


def run_world(package_name: str, world: str, device=None,
              slots: int = SLOTS) -> dict:
    """One cycle of the world through ``package_name``'s Scheduler shell
    (the port over ``slots`` slots on ``device``). Returns {"digest",
    "wall_s", "stats"}: the stats are the port's allocate and preempt
    ``last_stats``."""
    from system_reference import LogicalClock
    pkg = package(package_name)
    cache, binder, evictor = build_world(pkg, world)
    port = package_name != "volcano_tpu"
    kwargs = {}
    if port:
        from volcano_tpu_torch.ops import unified
        unified.set_devices(slots, device)
        kwargs = {"device": device}
    try:
        sched = pkg.scheduler.Scheduler(cache, world_conf(world), **kwargs)
        clock = LogicalClock()
        sched.clock = clock
        cache.time_fn = cache.resync_queue.time_fn = clock.time
        cache.inflight.time_fn = clock.time
        t0 = time.perf_counter()
        failures = [name for name, _ in sched.run_once()]
        wall = time.perf_counter() - t0
        stats = {}
        if port:
            for action in sched.actions:
                if action.name() in ("allocate", "allocate-tpu", "preempt"):
                    stats[action.name()] = dict(action.last_stats)
    finally:
        if port:
            unified.set_devices(None)
    binds = sorted(binder.binds.items())
    evicts = sorted(evictor.evicts)
    phases = sorted([uid, j.podgroup.phase.value]
                    for uid, j in cache.jobs.items())
    counts: dict = {}
    for _, phase in phases:
        counts[phase] = counts.get(phase, 0) + 1
    return {"digest": {"binds": len(binds), "binds_sha256": _sha(binds),
                       "evicts": len(evicts), "evicts_sha256": _sha(evicts),
                       "podgroups_sha256": _sha(phases),
                       "podgroup_phases": dict(sorted(counts.items())),
                       "action_failures": failures},
            "wall_s": wall, "stats": stats}


def sim_plane(stdout: str) -> dict:
    """The record of a sim run: its decision plane's sha256 (canonical
    JSON) and its job accounting."""
    report = json.loads(stdout)
    return {"plane_sha256": _sha(report), "jobs": report.get("jobs"),
            "mesh": report.get("mesh")}


def run_port_sim(name: str, device) -> dict:
    """The port's sim run of ``SIMS[name]`` in this process on ``device``
    over ``SLOTS`` slots: its record, exit code and stderr."""
    from volcano_tpu_torch.ops import unified
    from volcano_tpu_torch.sim.__main__ import main as sim_main
    out, err = io.StringIO(), io.StringIO()
    unified.set_devices(SLOTS, device)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = sim_main(SIMS[name] + ["--device", str(device)])
    finally:
        unified.set_devices(None)
    return {"record": sim_plane(out.getvalue()) if rc == 0 else None,
            "rc": rc, "stderr": err.getvalue()}


def _child_env() -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " " + XLA_FLAGS).strip()
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, os.path.join(REPO, "tests"),
                    env.get("PYTHONPATH", "")) if p)
    return env


def _child(world: str) -> int:
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_parity import mend_jax
    mend_jax()
    out = run_world("volcano_tpu", world)
    print(RECORD_MARKER + json.dumps(out["digest"], sort_keys=True),
          flush=True)
    return 0


def jax_record(world: str, timeout: float = 7200) -> dict:
    """One world, or one sim, through the JAX package in a child process."""
    if world in SIMS:
        argv = [sys.executable, "-m", "volcano_tpu.sim", *SIMS[world]]
    else:
        argv = [sys.executable, os.path.abspath(__file__), "--child", world]
    proc = subprocess.run(argv, cwd=REPO, env=_child_env(),
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"JAX {world} failed (exit {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    if world in SIMS:
        return sim_plane(proc.stdout)
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith(RECORD_MARKER)]
    return json.loads(lines[-1][len(RECORD_MARKER):])


def load_digests() -> dict:
    with open(DIGESTS) as f:
        return json.load(f)["worlds"]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--child"]:
        return _child(argv[1])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help=f"compute the JAX records and write {DIGESTS}")
    ap.add_argument("--worlds", nargs="+",
                    choices=sorted(set(WORLDS) | set(SIMS)),
                    help="with --write: only these, merged into the file")
    ap.add_argument("--run", help="print the port's record of one world")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--slots", type=int, default=SLOTS)
    args = ap.parse_args(argv)
    if args.run:
        if args.run in SIMS:
            out = run_port_sim(args.run, args.device)
            print(json.dumps(out["record"], sort_keys=True))
            return out["rc"]
        out = run_world("volcano_tpu_torch", args.run, args.device,
                        args.slots)
        print(json.dumps(dict(out["digest"], wall_s=out["wall_s"]),
                         sort_keys=True))
        return 0
    if not args.write:
        ap.error("one of --write / --run is required")
    records = load_digests() if os.path.exists(DIGESTS) else {}
    for name in args.worlds or [*WORLDS, *SIMS]:
        if name in NO_JAX:
            continue
        t0 = time.perf_counter()
        record = jax_record(name)
        record["jax_wall_s"] = round(time.perf_counter() - t0, 1)
        records[name] = record
        print(f"{name}: {record}", file=sys.stderr, flush=True)
    doc = {"schema": "volcano-tpu-sharded-reference/v1",
           "command": "python tools/sharded_reference.py --write",
           "xla_flags": XLA_FLAGS, "slots": SLOTS,
           "no_jax_record": list(NO_JAX),
           "sims": {k: " ".join(v) for k, v in SIMS.items()},
           "worlds": dict(sorted(records.items()))}
    with open(DIGESTS, "w") as f:
        f.write(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
