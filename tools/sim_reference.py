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
serializes the port's run the same way). The digests go to
``tests/sim_reference_digests.json``, which ``chip_smoke.py`` holds the
card's runs to, since the card has no JAX.

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

Regenerate the file (CPU, about ten minutes)::

    JAX_PLATFORMS=cpu python tools/sim_reference.py --write

Print one run's bytes::

    JAX_PLATFORMS=cpu python tools/sim_reference.py --run smoke \\
        --conf deploy/scheduler.conf --chaos-rate 0.2 --kill-cycles 5,12

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIGESTS = os.path.join(REPO, "tests", "sim_reference_digests.json")
DEPLOYED = "deploy/scheduler.conf"
NO_FMA_XLA_FLAGS = "--xla_backend_optimization_level=0"
MAPS_LIMIT = 40000
# the child's last line on stderr: this marker, then the sequence digest
SEQUENCE_MARKER = "sim-reference-sequence "

# (scenario, sim arguments): every run chip_smoke.py drives on the card,
# and the CPU tests' runs
RUNS = (
    ("smoke", ()),
    ("smoke", ("--conf", DEPLOYED)),
    ("smoke", ("--chaos-rate", "0.2", "--kill-cycles", "5,12")),
    ("smoke", ("--conf", DEPLOYED, "--chaos-rate", "0.2",
               "--kill-cycles", "5,12")),
    ("skew", ("--conf", DEPLOYED)),
    ("preempt-burst", ("--conf", DEPLOYED)),
    ("baseline-10k", ("--conf", DEPLOYED)),
)


def run_key(scenario: str, args) -> str:
    return " ".join(("--scenario", scenario) + tuple(args))


def _child_env() -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    if NO_FMA_XLA_FLAGS not in flags:
        env["XLA_FLAGS"] = (flags + " " + NO_FMA_XLA_FLAGS).strip()
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH", "")) if p)
    return env


def start(scenario: str, args=(), walk: str = "exact") -> subprocess.Popen:
    """Start the JAX sim for one run in a child process; its stdout is the
    decision plane's canonical JSON. ``walk`` picks the JAX preempt walk's
    mode: "exact" (its per-task formulation) or "default"."""
    cmd = [sys.executable, os.path.abspath(__file__), "--child", walk,
           "--scenario", scenario, "--deterministic", *args]
    return subprocess.Popen(cmd, cwd=REPO, env=_child_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def finish(proc: subprocess.Popen, timeout: float = 3600):
    """Wait for a child of ``start``: returns the decision plane's bytes
    and the run's sequence digest ({sha256, binds, evicts})."""
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"JAX sim failed (exit {proc.returncode}):\n"
                           f"{err.decode(errors='replace')[-4000:]}")
    lines = [line for line in err.decode().splitlines()
             if line.startswith(SEQUENCE_MARKER)]
    if len(lines) != 1:
        raise RuntimeError("JAX sim child printed no sequence digest")
    return out, json.loads(lines[0][len(SEQUENCE_MARKER):])


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
    from volcano_tpu import scheduler as jax_scheduler
    from volcano_tpu.ops import evict as jax_evict
    from volcano_tpu.sim.__main__ import main
    from volcano_tpu.sim.runner import SimRunner

    if walk == "exact":
        build = jax_evict.build_preempt_walk

        def build_exact(kinds, sizes, gang_commit, allow_cheap=True,
                        axis=None):
            return build(kinds, sizes, gang_commit, False, axis)

        jax_evict.build_preempt_walk = build_exact

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
    rc = main(argv)
    if rc == 0:
        sys.stdout.flush()
        print(SEQUENCE_MARKER + json.dumps(sequence_digest(runners[0])),
              file=sys.stderr)
    return rc


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--child"]:
        return _child(argv[1], argv[2:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help=f"compute every run of RUNS and write {DIGESTS}")
    ap.add_argument("--run", metavar="SCENARIO",
                    help="print one run's decision plane")
    ap.add_argument("--walk", choices=("exact", "default"),
                    default="exact",
                    help="the JAX preempt walk's mode for --run")
    args, rest = ap.parse_known_args(argv)
    if args.run:
        out, sequence = finish(start(args.run, rest, args.walk))
        sys.stdout.buffer.write(out)
        print(f"sequence: {json.dumps(sequence)}", file=sys.stderr)
        return 0
    if not args.write:
        ap.error("one of --write / --run is required")
    procs = [(scenario, run_args, start(scenario, run_args, "exact"),
              start(scenario, run_args, "default"))
             for scenario, run_args in RUNS]
    entries = []
    for scenario, run_args, exact, default in procs:
        out, sequence = finish(exact)
        other_out, other_sequence = finish(default)
        other = digest(other_out)
        entries.append({"key": run_key(scenario, run_args),
                        "scenario": scenario, "args": list(run_args),
                        **digest(out),
                        "sequence_sha256": sequence["sha256"],
                        "sequence_binds": sequence["binds"],
                        "sequence_evicts": sequence["evicts"],
                        "default_walk_sha256": other["sha256"],
                        "default_walk_bytes": other["bytes"],
                        "default_walk_sequence_sha256":
                            other_sequence["sha256"]})
        print(f"{run_key(scenario, run_args)}: {entries[-1]['bytes']} bytes"
              f"{'' if other['sha256'] == entries[-1]['sha256'] else ' (default walk differs)'}",
              file=sys.stderr)
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
