"""Drive scripted worlds through one package's ``VolcanoSystem`` (the object
store, admission webhooks, controllers, vcctl's commands and the scheduler
in one process) and digest what comes out: the reference the PyTorch
port's system is held to.

Each world takes the package's name (``volcano_tpu`` or
``volcano_tpu_torch``) and imports it, so ``chip_smoke.py`` runs the port's
worlds without importing JAX. For each world the digest records, with
wall-clock fields normalised away:

- every Job's phase and status counts;
- every PodGroup's phase and conditions (without their transition time and
  session id);
- every Pod's node and phase;
- the store's events in order (without their time);
- the cache's bind and evict sequence, as the executors saw it;
- the solves: each allocate solve's node-tensor path
  (``tools/sim_traces.py::TensorPathRecorder``) and the number of preempt
  walks, which on the port's CPU path are B1's and B3's plain versions.

Objects are minted the same way in both packages: each world restarts the
package's uid counter and stamps every stored object's creation time from
a logical clock, so job and task order never reads the wall clock.

Worlds:

- ``system-10k``, the full-width path: ``cache/synthetic.baseline_config
  ("10k")``, seed 0. Its 2,000 nodes go into the system's cache, queues q1,
  q2 and q3 at weights 3, 2 and 1 are created through ``QueueCommands``,
  and its 200 gangs (10,000 pods) are submitted as 200 Jobs through
  ``submit_job_batch`` (one TaskSpec of the gang's size and request, its
  ``min_available``, queue and priority, the priority through a
  PriorityClass). Under ``deploy/scheduler.conf``, ``schedule_once`` runs
  until no pod is Pending or 8 cycles have run; then every pod of every
  third job finishes, one more cycle runs, and the garbage collector runs.
- ``system-preempt``: under ``deploy/scheduler.conf``, low-priority jobs
  fill a small cluster, then a high-priority job arrives and is placed
  through preempt (B3), its victims' Evict events recorded. The JAX
  package's walk runs in its per-task formulation, as
  ``tools/sim_reference.py`` runs it (ROADMAP §3: its closed-form fill is
  not its per-task walk).
- ``system-lifecycle``: the default conf and the job error-handling matrix
  of ``tests/test_system_e2e.py`` (pod failed, evicted or completed
  against RestartJob, TerminateJob, AbortJob and CompleteJob, job-level
  and task-level, and exit codes) as one run.

``native=True`` (``--native``) runs system-preempt or system-lifecycle
over the package's C++ object store (``native.NativeObjectStore`` under
the same logical clock, given to ``VolcanoSystem`` as its store). The
port's runs over it equal the digests above; the JAX package's
system-lifecycle over its own C++ store does not (ROADMAP §3), so no
native record is written. A package whose store did not build is
refused: the JAX package's factory would hand back its Python store.
system-10k's batched front door needs ``create_batch``, which the native
store lacks, so it runs over the Python store only.

Write the digests (the JAX package, one child a world at
``--xla_backend_optimization_level=0``, as ``tools/sim_reference.py``
runs it)::

    JAX_PLATFORMS=cpu python tools/system_reference.py --write

Print one world's record for a package::

    python tools/system_reference.py --run system-preempt \\
        --package volcano_tpu_torch --device cpu
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import itertools
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
DIGESTS = os.path.join(REPO, "tests", "system_reference_digests.json")
DEPLOYED = os.path.join(REPO, "deploy", "scheduler.conf")
NO_FMA_XLA_FLAGS = "--xla_backend_optimization_level=0"
WORLDS = ("system-10k", "system-preempt", "system-lifecycle")
NATIVE_WORLDS = ("system-preempt", "system-lifecycle")
# the child's last line on stdout: this marker, then the record
RECORD_MARKER = "system-reference-record "
GI = 1 << 30
MAX_CYCLES_10K = 8


def _sha(value) -> str:
    return hashlib.sha256(json.dumps(
        value, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


class Package:
    """The modules of one package that a world drives, imported by name."""

    def __init__(self, name: str):
        self.name = name
        imp = importlib.import_module
        self.api = imp(f"{name}.api")
        self.objects = imp(f"{name}.apis.objects")
        self.store = imp(f"{name}.store")
        self.system = imp(f"{name}.system")
        self.admission = imp(f"{name}.webhooks.admission")
        self.controllers = imp(f"{name}.controllers")
        self.synthetic = imp(f"{name}.cache.synthetic")
        self.allocate = imp(f"{name}.actions.allocate")
        self.cache = imp(f"{name}.cache")
        self.evict_tpu = imp(f"{name}.actions.evict_tpu")


def native_store_class(pkg: Package):
    """The package's C++ object store class, refusing a package whose
    store did not build."""
    native = importlib.import_module(f"{pkg.name}.native")
    if not native.available():
        raise RuntimeError(f"{pkg.name}.native did not build: "
                           f"{getattr(native, 'build_error', lambda: '')()}")
    return native.NativeObjectStore


def logical_store(pkg: Package, native: bool = False):
    """An object store whose every created object gets its creation time
    from a counter: the order of jobs and tasks (creation time, then uid)
    is the order of creation in both packages, never a clock tie.
    ``native``: the package's C++ store under the same clock."""
    clock = itertools.count(1)
    base = native_store_class(pkg) if native else pkg.store.ObjectStore

    class LogicalClockStore(base):
        def create(self, obj):
            obj.metadata.creation_timestamp = float(next(clock))
            return super().create(obj)

        def create_batch(self, objs, admit=True):
            objs = list(objs)
            for obj in objs:
                obj.metadata.creation_timestamp = float(next(clock))
            return super().create_batch(objs, admit=admit)

    return LogicalClockStore()


class Recorder:
    """The cache's executor calls in order, and the solves: each allocate
    solve's node-tensor path and each preempt walk."""

    def __init__(self, pkg: Package, system):
        from sim_traces import TensorPathRecorder
        self.sequence = []
        cache = system.cache
        bind, evict = cache.binder.bind, cache.evictor.evict

        def rec_bind(task, hostname):
            self.sequence.append(["bind", f"{task.namespace}/{task.name}",
                                  hostname])
            return bind(task, hostname)

        def rec_evict(task, reason):
            self.sequence.append(["evict", f"{task.namespace}/{task.name}",
                                  reason])
            return evict(task, reason)

        cache.binder.bind = rec_bind
        cache.evictor.evict = rec_evict
        self.paths = TensorPathRecorder(pkg.allocate, pkg.cache.SchedulerCache)
        self.walks = 0
        if pkg.name == "volcano_tpu":
            # the JAX package: its walk in the per-task formulation, as
            # tools/sim_reference.py runs it (the port's walk), counted
            # where the built walk runs
            self._module = importlib.import_module("volcano_tpu.ops.evict")
            self._name = "build_preempt_walk"
            build = self._real = self._module.build_preempt_walk

            def patched(kinds, sizes, gang_commit, allow_cheap=True,
                        axis=None):
                fn = build(kinds, sizes, gang_commit, False, axis)

                def counted(*a):
                    self.walks += 1
                    return fn(*a)
                return counted
        else:
            # the port: its walk wrapper (B3 on the card, its plain
            # version on the CPU)
            self._module = pkg.evict_tpu
            self._name = "walk"
            walk = self._real = pkg.evict_tpu.walk

            def patched(*a, **kw):
                self.walks += 1
                return walk(*a, **kw)
        setattr(self._module, self._name, patched)

    def close(self) -> None:
        self.paths.close()
        setattr(self._module, self._name, self._real)


def _conditions(conds) -> list:
    return [{k: v for k, v in c.items()
             if k not in ("lastTransitionTime", "transitionID")}
            for c in conds]


def state_records(system) -> dict:
    """The system's end state and its event history as plain lists: every
    Job's phase and status counts, every PodGroup's phase and conditions,
    every Pod's node and phase (each by namespace/name) and the store's
    events in order."""
    store = system.store
    jobs = []
    for job in sorted(store.list("Job"), key=lambda o: o.metadata.key()):
        s = job.status
        jobs.append([job.metadata.key(), s.state.value, s.pending, s.running,
                     s.succeeded, s.failed, s.terminating, s.unknown,
                     s.version, s.retry_count, s.min_available])
    groups = []
    for pg in sorted(store.list("PodGroup"), key=lambda o: o.metadata.key()):
        groups.append([pg.metadata.key(), pg.status.phase.value,
                       _conditions(pg.status.conditions), pg.status.running,
                       pg.status.succeeded, pg.status.failed])
    pods = [[p.metadata.key(), p.status.node_name, p.status.phase]
            for p in sorted(store.list("Pod"),
                            key=lambda o: o.metadata.key())]
    events = [[e["kind"], e["namespace"], e["name"], e["type"], e["reason"],
               e["message"]] for e in store.events]
    return {"jobs": jobs, "podgroups": groups, "pods": pods,
            "events": events}


def system_digest(system, recorder: Recorder) -> dict:
    """The world's end state and its histories, as canonical JSON digests
    with their counts."""
    rec = state_records(system)
    paths = recorder.paths.summary()
    return {
        "jobs_sha256": _sha(rec["jobs"]), "jobs": len(rec["jobs"]),
        "job_phases": _phase_counts(j[1] for j in rec["jobs"]),
        "podgroups_sha256": _sha(rec["podgroups"]),
        "podgroups": len(rec["podgroups"]),
        "pods_sha256": _sha(rec["pods"]), "pods": len(rec["pods"]),
        "pod_phases": _phase_counts(p[2] for p in rec["pods"]),
        "events_sha256": _sha(rec["events"]), "events": len(rec["events"]),
        "sequence_sha256": _sha(recorder.sequence),
        "binds": sum(1 for s in recorder.sequence if s[0] == "bind"),
        "evicts": sum(1 for s in recorder.sequence if s[0] == "evict"),
        "solves": paths["solves"], "tensor_paths_sha256": paths["sha256"],
        "walks": recorder.walks,
    }


def _phase_counts(phases) -> dict:
    out: dict = {}
    for p in phases:
        out[p] = out.get(p, 0) + 1
    return dict(sorted(out.items()))


class LogicalClock:
    """The scheduler's and the cache's clock in a world: a cycle is one
    second, whatever it took (retry backoffs, in-flight ack deadlines and
    session timestamps read it)."""

    def __init__(self, start: float = 1e6):
        self._now = float(start)

    def time(self) -> float:
        return self._now

    def now(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            self._now += seconds


def new_system(pkg: Package, conf_text=None, device=None, nodes=(),
               native: bool = False):
    """A VolcanoSystem over a logical-clock store (the C++ one with
    ``native``), on a logical clock that each ``schedule_once`` advances by
    a second, the package's uid counter restarted, ``nodes`` added to its
    cache."""
    pkg.objects._uid = itertools.count()
    kwargs = {} if device is None else {"device": device}
    system = pkg.system.VolcanoSystem(conf_text=conf_text,
                                      schedule_period=0.01,
                                      store=logical_store(pkg, native),
                                      **kwargs)
    clock = LogicalClock()
    system.scheduler.clock = clock
    cache = system.cache
    cache.time_fn = cache.resync_queue.time_fn = clock.time
    cache.inflight.time_fn = clock.time
    drained_cycle = system.schedule_once

    def schedule_once():
        errors = drained_cycle()
        clock.sleep(1.0)
        return errors

    system.schedule_once = schedule_once
    for node in nodes:
        cache.add_node(node)
    return system


def _nodes(pkg: Package, n: int, cpu: int, mem: int, prefix="node"):
    out = []
    for i in range(n):
        alloc = pkg.api.Resource(cpu, mem)
        alloc.max_task_num = 110
        out.append(pkg.api.NodeInfo(name=f"{prefix}-{i}", allocatable=alloc))
    return out


def _job(pkg: Package, name, replicas, cpu, mem, queue="default",
         min_available=0, priority_class="", policies=(), task_policies=()):
    o = pkg.objects
    return o.Job(
        metadata=o.ObjectMeta(name=name),
        spec=o.JobSpec(
            queue=queue, min_available=min_available,
            priority_class_name=priority_class,
            policies=list(policies),
            tasks=[o.TaskSpec(name="worker", replicas=replicas,
                              template=o.PodTemplate(
                                  resources=pkg.api.Resource(cpu, mem)),
                              policies=list(task_policies))]))


def _pending_pods(system) -> int:
    return sum(1 for p in system.store.list("Pod")
               if p.status.phase == "Pending")


def _timed_cycle(system, cycle_ms: list) -> list:
    t0 = time.perf_counter()
    errors = system.schedule_once()
    cycle_ms.append((time.perf_counter() - t0) * 1e3)
    return errors


def world_10k(pkg: Package, device=None) -> tuple:
    """system-10k (module docstring). Returns (system, cycle ms, action
    failures)."""
    o = pkg.objects
    cache, _, _ = pkg.synthetic.baseline_config("10k", seed=0)
    with open(DEPLOYED) as f:
        conf = f.read()
    nodes = sorted(cache.nodes.values(), key=lambda n: n.name)
    fresh = []
    for n in nodes:
        alloc = pkg.api.Resource(n.allocatable.cpu, n.allocatable.memory)
        alloc.max_task_num = n.allocatable.max_task_num
        fresh.append(pkg.api.NodeInfo(name=n.name, allocatable=alloc))
    system = new_system(pkg, conf, device, fresh)
    for name, weight in (("q1", 3), ("q2", 2), ("q3", 1)):
        system.queues.create(name, weight=weight)
    for prio in range(11):
        system.store.create(o.PriorityClass(
            metadata=o.ObjectMeta(name=f"prio-{prio}", namespace=""),
            value=prio))
    jobs = []
    for job in sorted(cache.jobs.values(), key=lambda j: j.name):
        task = next(iter(job.tasks.values()))
        jobs.append(_job(pkg, job.name, len(job.tasks),
                         task.resreq.cpu, task.resreq.memory,
                         queue=job.queue, min_available=job.min_available,
                         priority_class=f"prio-{job.priority}"))
    pkg.admission.submit_job_batch(system.store, jobs)
    return system, jobs


def run_10k(pkg: Package, system, cycle_ms: list) -> list:
    failures = []
    for _ in range(MAX_CYCLES_10K):
        failures += _timed_cycle(system, cycle_ms)
        if system.store.list("Pod") and not _pending_pods(system):
            break
    names = sorted(j.metadata.name for j in system.store.list("Job"))
    for name in names[::3]:
        for pod in sorted(system.store.list("Pod"),
                          key=lambda p: p.metadata.name):
            if pod.metadata.annotations.get(
                    "scheduling.k8s.io/group-name") == name \
                    and pod.status.phase == "Running":
                system.store.finish_pod(pod.metadata.namespace,
                                        pod.metadata.name)
    failures += _timed_cycle(system, cycle_ms)
    _gc(pkg, system)
    return failures


def _gc(pkg: Package, system) -> list:
    gc = next(c for c in system.controllers
              if isinstance(c, pkg.controllers.GarbageCollector))
    return gc.process()


def world_preempt(pkg: Package, device=None, native=False) -> tuple:
    """system-preempt (module docstring): 4 nodes of 8 cores, two
    low-priority 8-pod jobs of 2 cores fill them, then a high-priority
    4-pod job of 4 cores arrives."""
    o = pkg.objects
    with open(DEPLOYED) as f:
        conf = f.read()
    system = new_system(pkg, conf, device,
                        _nodes(pkg, 4, 8000, 32 * GI), native)
    system.queues.create("q1", weight=1)
    for name, value in (("low", 1), ("high", 1000)):
        system.store.create(o.PriorityClass(
            metadata=o.ObjectMeta(name=name, namespace=""), value=value))
    return system, [
        ("submit", _job(pkg, "low-a", 8, 2000, 2 * GI, queue="q1",
                        priority_class="low")),
        ("submit", _job(pkg, "low-b", 8, 2000, 2 * GI, queue="q1",
                        priority_class="low")),
        ("cycles", 3),
        ("submit", _job(pkg, "high", 4, 4000, 4 * GI, queue="q1",
                        priority_class="high")),
        ("cycles", 6),
    ]


def run_script(system, script, cycle_ms: list) -> list:
    failures = []
    for step, arg in script:
        if step == "submit":
            system.store.create(arg)
        elif step == "cycles":
            for _ in range(arg):
                failures += _timed_cycle(system, cycle_ms)
    return failures


# the job error-handling matrix: (name, job policies, task policies, what
# happens to the job's pods once it runs)
def _lifecycle_cases(pkg: Package):
    o, api = pkg.objects, pkg.api
    E, A = api.BusEvent, api.BusAction

    def pol(event=None, action=None, exit_code=None):
        return o.LifecyclePolicy(event=event, action=action,
                                 exit_code=exit_code)

    return (
        ("fail-restart", [pol(E.POD_FAILED, A.RESTART_JOB)], [], "fail"),
        ("fail-terminate", [pol(E.POD_FAILED, A.TERMINATE_JOB)], [], "fail"),
        ("fail-abort", [pol(E.POD_FAILED, A.ABORT_JOB)], [], "fail"),
        ("evict-restart", [pol(E.POD_EVICTED, A.RESTART_JOB)], [], "evict"),
        ("evict-terminate", [pol(E.POD_EVICTED, A.TERMINATE_JOB)], [],
         "evict"),
        ("evict-abort", [pol(E.POD_EVICTED, A.ABORT_JOB)], [], "evict"),
        ("any-restart", [pol(E.ANY, A.RESTART_JOB)], [], "evict"),
        ("done-complete", [pol(E.TASK_COMPLETED, A.COMPLETE_JOB)], [],
         "succeed"),
        ("exit-restart", [pol(exit_code=3, action=A.RESTART_JOB)], [],
         "exit"),
        ("either-terminate", [pol(E.POD_EVICTED, A.TERMINATE_JOB),
                              pol(E.POD_FAILED, A.TERMINATE_JOB)], [],
         "fail"),
        ("task-fail-restart", [], [pol(E.POD_FAILED, A.RESTART_JOB)],
         "fail"),
        ("task-evict-terminate", [], [pol(E.POD_EVICTED, A.TERMINATE_JOB)],
         "evict"),
        ("task-done-complete", [], [pol(E.TASK_COMPLETED,
                                        A.COMPLETE_JOB)], "succeed"),
        ("task-over-job", [pol(E.POD_FAILED, A.ABORT_JOB)],
         [pol(E.POD_FAILED, A.RESTART_JOB)], "fail"),
    )


def world_lifecycle(pkg: Package, device=None, native=False) -> tuple:
    """system-lifecycle (module docstring): 14 two-pod jobs on 4 nodes."""
    system = new_system(pkg, None, device, _nodes(pkg, 4, 8000, 16 * GI),
                        native)
    cases = _lifecycle_cases(pkg)
    for name, policies, task_policies, _ in cases:
        system.store.create(_job(pkg, name, 2, 1000, GI, policies=policies,
                                 task_policies=task_policies))
    return system, cases


def run_lifecycle(system, cases, cycle_ms: list) -> list:
    failures = []
    for _ in range(2):
        failures += _timed_cycle(system, cycle_ms)
    for name, _, _, what in cases:
        pods = sorted((p for p in system.store.list("Pod")
                       if p.metadata.annotations.get(
                           "scheduling.k8s.io/group-name") == name),
                      key=lambda p: p.metadata.name)
        if what == "fail":
            system.store.finish_pod("default", pods[0].metadata.name,
                                    succeeded=False)
        elif what == "evict":
            system.store.evict_pod("default", pods[0].metadata.name,
                                   "preempt")
        elif what == "succeed":
            for pod in pods:
                system.store.finish_pod("default", pod.metadata.name,
                                        succeeded=True)
        elif what == "exit":
            system.store.finish_pod("default", pods[0].metadata.name,
                                    succeeded=False, exit_code=1)
            system.store.finish_pod("default", pods[1].metadata.name,
                                    succeeded=False, exit_code=3)
    for _ in range(3):
        failures += _timed_cycle(system, cycle_ms)
    return failures


def run_world(package: str, world: str, device=None,
              native: bool = False) -> dict:
    """Build and drive one world through ``package``'s VolcanoSystem
    (over its C++ store with ``native``). Returns {"digest", "cycle_ms",
    "action_failures", "wall_s", "system"}."""
    pkg = Package(package)
    t0 = time.perf_counter()
    cycle_ms: list = []
    if world == "system-10k":
        if native:
            raise ValueError("system-10k submits through create_batch, "
                             "which the native store lacks")
        system, _ = world_10k(pkg, device)
        recorder = Recorder(pkg, system)
        try:
            failures = run_10k(pkg, system, cycle_ms)
        finally:
            recorder.close()
    elif world == "system-preempt":
        system, script = world_preempt(pkg, device, native)
        recorder = Recorder(pkg, system)
        try:
            failures = run_script(system, script, cycle_ms)
        finally:
            recorder.close()
    elif world == "system-lifecycle":
        system, cases = world_lifecycle(pkg, device, native)
        recorder = Recorder(pkg, system)
        try:
            failures = run_lifecycle(system, cases, cycle_ms)
        finally:
            recorder.close()
    else:
        raise ValueError(f"unknown world {world!r}; known: {WORLDS}")
    return {"digest": system_digest(system, recorder),
            "cycle_ms": cycle_ms,
            "action_failures": [name for name, _ in failures],
            "wall_s": time.perf_counter() - t0, "system": system}


def _child_env() -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    if NO_FMA_XLA_FLAGS not in flags:
        env["XLA_FLAGS"] = (flags + " " + NO_FMA_XLA_FLAGS).strip()
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH", "")) if p)
    return env


def _child(world: str) -> int:
    out = run_world("volcano_tpu", world)
    record = dict(out["digest"], action_failures=out["action_failures"])
    print(RECORD_MARKER + json.dumps(record, sort_keys=True), flush=True)
    return 0


def jax_record(world: str, timeout: float = 3600) -> dict:
    """One world through the JAX package in a child process."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", world],
        cwd=REPO, env=_child_env(), capture_output=True, text=True,
        timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"JAX world {world} failed (exit "
                           f"{proc.returncode}):\n{proc.stderr[-4000:]}")
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
                    help=f"compute WORLDS through the JAX package and "
                         f"write {DIGESTS}")
    ap.add_argument("--worlds", nargs="+", choices=WORLDS,
                    help="with --write: only these worlds, merged into "
                         "the file")
    ap.add_argument("--run", choices=WORLDS,
                    help="print one world's record")
    ap.add_argument("--package", default="volcano_tpu_torch")
    ap.add_argument("--device", default=None)
    ap.add_argument("--native", action="store_true",
                    help="with --run: over the package's C++ object store")
    args = ap.parse_args(argv)
    if args.run:
        out = run_world(args.package, args.run, args.device, args.native)
        print(json.dumps(dict(out["digest"],
                              action_failures=out["action_failures"],
                              wall_s=out["wall_s"]), sort_keys=True))
        return 0
    if not args.write:
        ap.error("one of --write / --run is required")
    worlds = args.worlds or WORLDS
    records = {}
    if args.worlds:
        records = load_digests()
    for world in worlds:
        record = jax_record(world)
        # the port's CPU path: B1's plain version once a solve (chip_smoke.py
        # holds the card's launches to it, and B3's to the record's walks)
        port = run_world("volcano_tpu_torch", world, "cpu")["digest"]
        if port != {k: v for k, v in record.items()
                    if k != "action_failures"}:
            print(f"{world}: the port's CPU path differs from the JAX "
                  f"package's: {port} against {record}", file=sys.stderr)
        record["port_cpu"] = {"solves": port["solves"]}
        records[world] = record
        print(f"{world}: {records[world]}", file=sys.stderr)
    doc = {"schema": "volcano-tpu-system-reference/v1",
           "command": "JAX_PLATFORMS=cpu python tools/system_reference.py "
                      "--write",
           "xla_flags": NO_FMA_XLA_FLAGS,
           "worlds": {w: records[w] for w in WORLDS if w in records}}
    with open(DIGESTS, "w") as f:
        f.write(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
