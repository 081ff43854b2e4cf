"""The plugin worlds' reference decisions: pod affinity, GPU sharing,
conformance's critical pods, NUMA placement, the proportional guard, and
tdm, task-topology, sla with overcommit, and the reservation with its
elect and reserve actions, each a world built from one seed in either
package and scheduled through
its ``Scheduler`` shell, digested the same way. ``chip_smoke.py``'s
``plugins`` phase runs the port's worlds on the card and holds them to
``tests/plugin_reference_digests.json``; the tests hold the port's CPU path
to the same records.

Every world takes the package's name (``volcano_tpu`` or
``volcano_tpu_torch``) and imports it, so the port's runs import no JAX.
Each runs ``CYCLES`` cycles of ``deploy/scheduler.conf`` with the one change
its conf names, a cycle a second of a logical clock (the in-flight
watchdog's ack deadline never reads the host's speed):

- ``affinity-10k`` (full width, B1): ``baseline_config("10k")``, seed 0
  (2,000 nodes, 200 gangs, 10,000 pods). Node i is labelled
  ``kubernetes.io/hostname`` = its name and ``topology.kubernetes.io/zone``
  = ``zone-{i % 20}``; every pod ``app: <job name>``. Gang j by j % 4:
  required anti-affinity to its own app on hostname, required affinity to
  its own app on zone, preferred affinity (weight 100) to its own app on
  zone, none. The conf as written.
- ``gpushare-10k`` (full width, B1): the 10k generator's nodes and gangs;
  nodes i % 4 == 0 carry 4 cards of 24,576 MiB (``volcano.sh/gpu-number``
  4, ``volcano.sh/gpu-memory`` 98,304, milli-scaled as
  ``Resource.from_dict`` scales them), and the pods of 80 gangs, drawn by
  seed, request 6,144, 8,192 or 12,288 MiB of card memory, one size a
  gang. ``predicate.GPUSharingEnable: true``.
- ``affinity-preempt`` (B1 and B3): ``preempt_mix_cache(n_nodes=400,
  n_tasks=10000, n_jobs=200)``, seed 0. Every tenth running pod is
  critical (namespace ``kube-system`` and annotation ``priorityClassName:
  system-node-critical`` in turn), every pod is labelled with its app, and
  every fourth pending gang carries the hostname anti-affinity.
  ``conformance`` joins the first tier.
- ``numa-1k`` (B1): 200 nodes of 2 NUMA nodes x 16 CPUs under the static
  CPU manager, topology policies by node i % 4 (single-numa-node twice,
  restricted, best-effort), and 1,000 pods in 40 gangs of whole-CPU
  requests (2-8 a gang, by seed) with the same policies by gang j % 4.
  ``numa-aware`` joins the second tier.
- ``proportional-1k`` (B1): ``baseline_config("gpu-small")``'s nodes and
  gangs (200 nodes x 8 ``nvidia.com/gpu``, 800 one-GPU pods) with the GPUs
  milli-scaled as ``Resource.from_dict`` scales a scalar (the generator
  keeps whole units, which the guard would read as thousandths of a GPU),
  plus 400 CPU-only pods in 20 gangs, with ``predicate.ProportionalEnable``
  for ``nvidia.com/gpu`` at 4 CPUs and 16 GiB a GPU.

- ``tdm-10k`` (full width, B1 and B3): ``world_tdm``, tdm after gang in
  the first tier with zones ``rz-open`` (13:00-14:00, active on the
  logical clock) and ``rz-closed`` (00:00-12:00).
- ``topology-10k`` (full width, B1): ``world_topology``, task-topology in
  the second tier.
- ``sla-overcommit-10k`` (full width, B1, three cycles):
  ``world_sla_overcommit``, sla in the first tier and overcommit (1.2) in
  the second.
- ``reservation-1k`` (B1, four cycles): ``world_reservation``, the
  actions ``enqueue, elect, allocate-tpu, backfill, reserve`` and the
  reservation plugin in the first tier.

``affinity-1k``, ``gpushare-1k``, ``tdm-1k``, ``topology-1k`` and
``sla-overcommit-1k`` are the full-width worlds at a tenth (200 nodes, 1,000
pods), and ``VARIANTS`` the tenths under another setting of their plugin:
all run live against the JAX package by the tests rather than digested.
``NAME@callbacks`` runs a world with every device engine swapped for the
host's.

A world's digest: the binds and evictions in order (``sequence_sha256``),
each PodGroup's phase, each allocate solve's node-tensor path
(``tools/sim_traces.py::TensorPathRecorder``), the solves and the preempt
walks, how many critical pods were evicted and, where a walk ran, how many
of its evictions took a victim that a plugin of the first tier refused
after the tier's first plugin offered it (``vetoed_evicted``: conformance's
guarantee, none under upstream's dispatch), and for slice 18's worlds a
record a cycle (``_cycle_record``) and the fused allocate's batched
replays. The JAX side runs one child a
world at ``--xla_backend_optimization_level=0`` with its walk in the
per-task formulation (as ``tools/system_reference.py`` runs it); beside
each record the file keeps the port's CPU path's solves and walks
(``port_cpu``), which the card's B1 and B3 launches must equal.

The JAX package's tier dispatch lets a later tier rule after a veto that
followed a plugin's victims, where upstream's does not (ROADMAP §3), and
affinity-preempt and tdm-10k meet it: conformance (tdm) vetoes victims
priority offered, and drf's tier then evicts them. Its duration parser
reads "1500ms" as 1,500 minutes, which sla-overcommit-10k meets. Those
records are taken as the JAX package is, and again with the package
mended (``tests/torch_parity.py::mend_jax``) under ``mended``; ``held_to``
names the one the port is held to.

    JAX_PLATFORMS=cpu python tools/plugin_reference.py --write
    python tools/plugin_reference.py --run numa-1k --device cpu   # the port
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
DIGESTS = os.path.join(REPO, "tests", "plugin_reference_digests.json")
DEPLOYED = os.path.join(REPO, "deploy", "scheduler.conf")
NO_FMA_XLA_FLAGS = "--xla_backend_optimization_level=0"
RECORD_MARKER = "plugin-reference-record "
GI = 1 << 30
CYCLES = 2

HOSTNAME = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"
REQUIRED = "requiredDuringSchedulingIgnoredDuringExecution"
PREFERRED = "preferredDuringSchedulingIgnoredDuringExecution"
GPU = "nvidia.com/gpu"
GPU_MEMORY = "volcano.sh/gpu-memory"
GPU_NUMBER = "volcano.sh/gpu-number"
CARD_MIB = 24576
CARD_SIZES_MIB = (6144, 8192, 12288)
NUMA_POLICIES = ("single-numa-node", "single-numa-node", "restricted",
                 "best-effort")
REVOCABLE_ZONE = "volcano.sh/revocable-zone"
# tools/system_reference.py's LogicalClock starts at 1e6 s, 1970-01-12
# 13:46:40 UTC, and moves a second a cycle: rz-open's window holds it,
# rz-closed's does not
CLOCK_START = 1e6
OPEN_WINDOW = "13:00-14:00"
CLOSED_WINDOW = "00:00-12:00"
TDM_CPU_RANGE = (4000, 12000)
SLA_CPU_RANGE = (6000, 13200)
SLA_WAITING_TIME = "sla-waiting-time"
TOPOLOGY_AFFINITY = "volcano.sh/task-topology-affinity"
TOPOLOGY_ANTI_AFFINITY = "volcano.sh/task-topology-anti-affinity"
TOPOLOGY_ORDER = "volcano.sh/task-topology-task-order"


def _sha(value) -> str:
    import hashlib
    return hashlib.sha256(json.dumps(
        value, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


# ---------------------------------------------------------------------------
# confs
# ---------------------------------------------------------------------------

def deployed_conf() -> str:
    with open(DEPLOYED) as f:
        return f.read()


def _plugin_args(name: str, args: dict) -> str:
    """``deploy/scheduler.conf`` with ``args`` under plugin ``name``."""
    lines = "".join(f"      {k}: {v}\n" for k, v in args.items())
    conf = deployed_conf()
    entry = f"  - name: {name}\n"
    assert conf.count(entry) == 1, name
    return conf.replace(entry, entry + "    arguments:\n" + lines)


def _add_plugin(conf: str, after: str, name: str, args: dict) -> str:
    """``conf`` with plugin ``name`` (and ``args``) after plugin ``after``,
    in its tier."""
    entry = f"  - name: {after}\n"
    assert conf.count(entry) == 1, after
    lines = "".join(f"      {k}: {v}\n" for k, v in args.items())
    plugin = f"  - name: {name}\n" + ("    arguments:\n" + lines
                                       if lines else "")
    return conf.replace(entry, entry + plugin)


def gpushare_conf() -> str:
    return _plugin_args("predicates", {"predicate.GPUSharingEnable": "true"})


def proportional_conf() -> str:
    return _plugin_args("predicates", {
        "predicate.ProportionalEnable": "true",
        "predicate.proportional.resources": "nvidia.com/gpu",
        "predicate.proportional.resources.nvidia.com/gpu.cpu": 4,
        "predicate.proportional.resources.nvidia.com/gpu.memory": 16})


def conformance_conf() -> str:
    conf = deployed_conf()
    entry = "  - name: gang\n"
    assert conf.count(entry) == 1
    return conf.replace(entry, entry + "  - name: conformance\n")


def numa_conf() -> str:
    conf = deployed_conf()
    entry = "  - name: binpack\n"
    assert conf.count(entry) == 1
    return conf.replace(entry, entry + "  - name: numa-aware\n")


# ---------------------------------------------------------------------------
# worlds
# ---------------------------------------------------------------------------

def _set_affinity(pkg, task, affinity: dict) -> None:
    """A task's pod affinity, with the flag each package decides from it
    when a task is built (affinity never changes after that)."""
    task.affinity = affinity
    flag = any((affinity.get(kind) or {}).get(term)
               for kind in ("podAffinity", "podAntiAffinity")
               for term in (REQUIRED, PREFERRED))
    if pkg.name == "volcano_tpu":
        task._has_pod_affinity = flag
    else:
        task.has_pod_affinity = flag


def _rebuild_job(pkg, job, decorate):
    """A pending job built anew with each task's constructor arguments
    changed by ``decorate(job_index_task) -> dict``: what the generator
    gave, plus resources, labels, affinity or a topology policy."""
    api = pkg.api
    new = api.JobInfo(uid=job.uid, name=job.name, namespace=job.namespace,
                      queue=job.queue, min_available=job.min_available,
                      podgroup=job.podgroup, priority=job.priority,
                      creation_timestamp=job.creation_timestamp)
    for t in job.tasks.values():
        kw = dict(uid=t.uid, name=t.name, namespace=t.namespace, job=t.job,
                  resreq=t.resreq, status=t.status, priority=t.priority,
                  creation_timestamp=t.creation_timestamp)
        kw.update(decorate(t))
        new.add_task_info(api.TaskInfo(**kw))
    return new


def _app_affinity(kind: str, app: str, key: str, weight=None) -> dict:
    term = {"labelSelector": {"matchLabels": {"app": app}},
            "topologyKey": key}
    if weight is None:
        return {kind: {REQUIRED: [term]}}
    return {kind: {PREFERRED: [{"weight": weight, "podAffinityTerm": term}]}}


def _wire(pkg, queues, nodes, jobs):
    cache = pkg.cache.SchedulerCache(binder=pkg.cache.FakeBinder(),
                                     evictor=pkg.cache.FakeEvictor())
    for q in queues:
        cache.add_queue(q)
    for n in nodes:
        cache.add_node(n)
    for j in jobs:
        cache.add_job(j)
    return cache


def _three_queues(pkg):
    return [pkg.api.QueueInfo(name=f"q{k + 1}", weight=w)
            for k, w in enumerate((3, 2, 1))]


def world_affinity(pkg, n_nodes=2000, n_tasks=10000, n_jobs=200, seed=0):
    syn = pkg.synthetic
    nodes = syn.make_cluster(n_nodes, seed=seed)
    for i, node in enumerate(nodes):
        node.labels.update({HOSTNAME: node.name, ZONE: f"zone-{i % 20}"})
    jobs = syn.make_jobs(n_tasks, n_jobs, ["q1", "q2", "q3"], seed=seed)
    kinds = (lambda app: _app_affinity("podAntiAffinity", app, HOSTNAME),
             lambda app: _app_affinity("podAffinity", app, ZONE),
             lambda app: _app_affinity("podAffinity", app, ZONE, 100),
             lambda app: {})
    out = []
    for j, job in enumerate(jobs):
        aff = kinds[j % 4](job.name)
        out.append(_rebuild_job(pkg, job, lambda t, a=aff, app=job.name: {
            "labels": {"app": app}, "affinity": a}))
    return _wire(pkg, _three_queues(pkg), nodes, out), set()


def world_gpushare(pkg, n_nodes=2000, n_tasks=10000, n_jobs=200,
                   n_card_jobs=80, seed=0):
    api, syn = pkg.api, pkg.synthetic
    nodes = []
    for i in range(n_nodes):
        scalars = ({GPU_NUMBER: 4 * 1000.0, GPU_MEMORY: 4 * CARD_MIB * 1000.0}
                   if i % 4 == 0 else None)
        alloc = api.Resource(32000, 128 * GI, scalars)
        alloc.max_task_num = 110
        nodes.append(api.NodeInfo(name=f"node-{i:05d}", allocatable=alloc))
    jobs = syn.make_jobs(n_tasks, n_jobs, ["q1", "q2", "q3"], seed=seed)
    rng = random.Random(seed)
    card_jobs = sorted(rng.sample(range(n_jobs), n_card_jobs))
    sizes = {j: rng.choice(CARD_SIZES_MIB) for j in card_jobs}
    out = []
    for j, job in enumerate(jobs):
        if j not in sizes:
            out.append(job)
            continue
        mib = sizes[j]
        out.append(_rebuild_job(pkg, job, lambda t, m=mib: {
            "resreq": api.Resource(t.resreq.cpu, t.resreq.memory,
                                   {GPU_MEMORY: m * 1000.0})}))
    return _wire(pkg, _three_queues(pkg), nodes, out), set()


def world_affinity_preempt(pkg, seed=0):
    api, syn = pkg.api, pkg.synthetic
    nodes = syn.make_cluster(400, seed=seed)
    jobs = syn.make_jobs(10000, 200, ["q1", "q2"], running_fraction=0.5,
                         nodes=nodes, seed=seed)
    on_node = {t.uid: t for n in nodes for t in n.tasks.values()}
    critical = set()
    k = 0
    out = []
    pending = 0
    for job in jobs:
        running = any(t.uid in on_node for t in job.tasks.values())
        if not running:
            anti = pending % 4 == 0
            pending += 1
            aff = (_app_affinity("podAntiAffinity", job.name, HOSTNAME)
                   if anti else {})
            out.append(_rebuild_job(pkg, job, lambda t, a=aff, app=job.name: {
                "labels": {"app": app}, "affinity": a}))
            continue
        for t in job.tasks.values():
            copies = [t] + ([on_node[t.uid]] if t.uid in on_node
                            and on_node[t.uid] is not t else [])
            crit = t.uid in on_node and k % 10 == 0
            system_ns = crit and (k // 10) % 2 == 0
            if t.uid in on_node:
                k += 1
            for c in copies:
                c.labels = {"app": job.name}
                if system_ns:
                    c.namespace = "kube-system"
                elif crit:
                    c.annotations = {"priorityClassName":
                                     "system-node-critical"}
            if crit:
                critical.add(f"{copies[0].namespace}/{t.name}")
        out.append(job)
    queues = [api.QueueInfo(name="q1", weight=1),
              api.QueueInfo(name="q2", weight=1)]
    return _wire(pkg, queues, nodes, out), critical


def world_numa(pkg, n_nodes=200, n_tasks=1000, n_jobs=40, seed=0):
    import importlib
    api, syn = pkg.api, pkg.synthetic
    numa = importlib.import_module(f"{pkg.name}.api.numa_info")
    nodes = syn.make_cluster(n_nodes, seed=seed)
    for i, node in enumerate(nodes):
        node.numa_info = numa.NumatopoInfo.uniform(
            node.name, 2, 16, topology_policy=NUMA_POLICIES[i % 4])
    jobs = syn.make_jobs(n_tasks, n_jobs, ["default"], seed=seed)
    rng = random.Random(seed)
    out = []
    for j, job in enumerate(jobs):
        cpus = rng.randint(2, 8)
        policy = NUMA_POLICIES[j % 4]
        out.append(_rebuild_job(pkg, job, lambda t, c=cpus, p=policy: {
            "resreq": api.Resource(c * 1000, t.resreq.memory),
            "topology_policy": p}))
    return _wire(pkg, [api.QueueInfo(name="default", weight=1)], nodes,
                 out), set()


def world_proportional(pkg, seed=0):
    api, syn = pkg.api, pkg.synthetic
    nodes = []
    for node in syn.make_cluster(200, gpus=8, seed=seed):
        a = node.allocatable
        alloc = api.Resource(a.cpu, a.memory, {GPU: 8 * 1000.0})
        alloc.max_task_num = a.max_task_num
        nodes.append(api.NodeInfo(name=node.name, allocatable=alloc))
    jobs = [_rebuild_job(pkg, job, lambda t: {"resreq": api.Resource(
                t.resreq.cpu, t.resreq.memory, {GPU: 1000.0})})
            for job in syn.make_jobs(800, 16, ["default"], gpus_per_task=1,
                                     seed=seed)]
    jobs += syn.make_jobs(400, 20, ["default"], seed=seed + 1,
                          name_prefix="cpu-")
    return _wire(pkg, [api.QueueInfo(name="default", weight=1)], nodes,
                 jobs), set()


def _set_revocable(node, zone: str) -> None:
    """A node of a revocable zone: the label, and the zone each package
    reads from it when a node is built."""
    node.labels[REVOCABLE_ZONE] = zone
    node.revocable_zone = zone


def _place_round_robin(tasks, nodes, start: int) -> int:
    """Each task RUNNING on the next of ``nodes`` it fits, round robin from
    ``start`` (the generator's placement); returns where it stopped."""
    at = start
    for task in tasks:
        for _ in range(len(nodes)):
            node = nodes[at % len(nodes)]
            at += 1
            if task.resreq.less_equal(node.idle):
                node.add_task(task)
                break
    return at


def world_tdm(pkg, n_nodes=2000, n_tasks=10000, n_jobs=200, seed=0):
    """Every fifth node revocable, in ``rz-open`` and ``rz-closed`` by
    turns. Jobs by j % 8: 0 preemptable and running (on plain and on
    rz-closed nodes by turns), 4 preemptable and pending, 1 and 5 running
    on plain nodes, the rest pending. A preemptable job's tasks name the
    zone rz-open; its disruption budget by j % 24: none, minAvailable 50%,
    maxUnavailable 5."""
    api, syn = pkg.api, pkg.synthetic
    nodes = syn.make_cluster(n_nodes, seed=seed)
    for i, node in enumerate(nodes):
        if i % 5 == 0:
            _set_revocable(node, "rz-open" if i % 10 == 0 else "rz-closed")
    plain = [n for n in nodes if not n.revocable_zone]
    drained = [n for i, n in enumerate(nodes)
               if not n.revocable_zone or i % 10 == 5]
    jobs = syn.make_jobs(n_tasks, n_jobs, ["q1", "q2", "q3"],
                         cpu_range=TDM_CPU_RANGE, seed=seed)
    out = []
    at_plain = at_drained = 0
    for j, job in enumerate(jobs):
        kind = j % 8
        preemptable = kind in (0, 4)
        running = kind in (0, 1, 5)
        status = api.TaskStatus.RUNNING if running else api.TaskStatus.PENDING
        new = _rebuild_job(pkg, job, lambda t, p=preemptable, s=status: {
            "preemptable": p, "revocable_zone": "rz-open" if p else "",
            "status": s})
        new.preemptable = preemptable
        new.revocable_zone = "rz-open" if preemptable else ""
        if preemptable:
            new.budget = (None, api.DisruptionBudget(min_available="50%"),
                          api.DisruptionBudget(max_unavailable="5"))[
                              (j // 8) % 3]
        if running:
            job.podgroup.phase = api.PodGroupPhase.RUNNING
            tasks = list(new.tasks.values())
            if kind == 0:
                at_drained = _place_round_robin(tasks, drained, at_drained)
            else:
                at_plain = _place_round_robin(tasks, plain, at_plain)
        out.append(new)
    return _wire(pkg, _three_queues(pkg), nodes, out), set()


def tdm_conf(windows=(OPEN_WINDOW, CLOSED_WINDOW), period=None) -> str:
    """``tdm`` after gang in the first tier, its two zones' windows (in
    UTC on the session clock) and its drain period."""
    args = {"tdm.revocable-zone.rz-open": f'"{windows[0]}"',
            "tdm.revocable-zone.rz-closed": f'"{windows[1]}"'}
    if period is not None:
        args["tdm.evict.period"] = period
    return _add_plugin(deployed_conf(), "gang", "tdm", args)


TOPOLOGY_KINDS = (
    {TOPOLOGY_AFFINITY: "ps,worker", TOPOLOGY_ANTI_AFFINITY: "ps",
     TOPOLOGY_ORDER: "chief,ps,worker"},
    {TOPOLOGY_AFFINITY: "chief,ps", TOPOLOGY_ORDER: "worker,chief"},
    {TOPOLOGY_ANTI_AFFINITY: "worker;chief,ps"},
    {},
)


def _task_role(t: int) -> str:
    return "chief" if t == 0 else "ps" if t % 10 == 1 else "worker"


def world_topology(pkg, n_nodes=2000, n_tasks=10000, n_jobs=200, seed=0):
    """The 10k generator's nodes and gangs, each gang a chief, a ps in ten
    and workers, with gang j's task-topology annotations by j % 4
    (``TOPOLOGY_KINDS``: affinity with self anti-affinity and a task order;
    affinity and an order; anti-affinity; none)."""
    syn = pkg.synthetic
    nodes = syn.make_cluster(n_nodes, seed=seed)
    jobs = syn.make_jobs(n_tasks, n_jobs, ["q1", "q2", "q3"], seed=seed)
    out = []
    for j, job in enumerate(jobs):
        job.podgroup.annotations.update(TOPOLOGY_KINDS[j % 4])
        index = {uid: t for t, uid in enumerate(job.tasks)}
        out.append(_rebuild_job(pkg, job, lambda task, ix=index: {
            "task_role": _task_role(ix[task.uid])}))
    return _wire(pkg, _three_queues(pkg), nodes, out), set()


def topology_conf() -> str:
    return _add_plugin(deployed_conf(), "binpack", "task-topology", {})


def world_sla_overcommit(pkg, n_nodes=2000, n_tasks=10000, n_jobs=300,
                         seed=0):
    """Pending PodGroups whose minResources (the gang's requests) sum to
    about 1.5x the cluster's idle CPU, created a second before the first
    cycle (the logical clock's start). The gangs of queue q3 (j % 3 == 2,
    the queue enqueue reaches last, after overcommit's room is spent) have
    an sla-waiting-time: 1.5 s where j % 6 == 2 (waited out by cycle 2),
    2.5 s where j % 6 == 5 (by cycle 3); the other gangs j % 9 == 1 wait an
    hour, the rest name no waiting time."""
    api, syn = pkg.api, pkg.synthetic
    nodes = syn.make_cluster(n_nodes, seed=seed)
    jobs = syn.make_jobs(n_tasks, n_jobs, ["q1", "q2", "q3"],
                         cpu_range=SLA_CPU_RANGE, seed=seed)
    for j, job in enumerate(jobs):
        pg = job.podgroup
        pg.phase = api.PodGroupPhase.PENDING
        total = api.Resource()
        for t in job.tasks.values():
            total.add(t.resreq)
        pg.min_resources = total
        job.creation_timestamp = CLOCK_START - 1.0 + j * 1e-3
        wait = ("1500ms" if j % 6 == 2 else "2500ms" if j % 6 == 5
                else "1h" if j % 9 == 1 else None)
        if wait is not None:
            pg.annotations[SLA_WAITING_TIME] = wait
    return _wire(pkg, _three_queues(pkg), nodes, jobs), set()


def sla_overcommit_conf(factor="1.2", sla=True) -> str:
    """``overcommit`` in the second tier and ``sla`` in the first: a REJECT
    in a tier vetoes whatever another plugin of that tier permits
    (session_plugins.go JobEnqueueable), so sla overrides overcommit only
    from an earlier tier, where upstream's sla documentation puts it."""
    conf = _add_plugin(deployed_conf(), "binpack", "overcommit",
                       {"overcommit-factor": factor})
    return _add_plugin(conf, "gang", "sla", {}) if sla else conf


def world_reservation(pkg, seed=0):
    """``preempt_mix_cache``'s generator at 200 nodes and 800 pods in 32
    gangs, half running, plus two pending gangs of queue ``vip``, whose
    capability (4,000 CPU) is below either gang's minimum, so proportion
    keeps both Pending: ``vip`` (priority 100, 100 pods of 30 CPU: more
    than the cluster has free) and ``vip-low`` (priority 50, 100 pods of 1
    CPU), which entered scheduling first."""
    api, syn = pkg.api, pkg.synthetic
    nodes = syn.make_cluster(200, seed=seed)
    jobs = syn.make_jobs(800, 32, ["q1", "q2"], running_fraction=0.5,
                         nodes=nodes, seed=seed)
    for name, prio, cpu, start in (("vip", 100, 30000, 2.0),
                                   ("vip-low", 50, 1000, 1.0)):
        pg = api.PodGroup(name=name, queue="vip", min_member=100,
                          phase=api.PodGroupPhase.PENDING,
                          min_resources=api.Resource(100 * cpu, 100 * GI))
        job = api.JobInfo(uid=name, name=name, queue="vip",
                          min_available=100, podgroup=pg, priority=prio,
                          creation_timestamp=float(len(jobs)))
        job.schedule_start_timestamp = start
        for t in range(100):
            job.add_task_info(api.TaskInfo(
                uid=f"{name}-{t}", name=f"{name}-{t}", job=name,
                resreq=api.Resource(cpu, GI), priority=prio,
                creation_timestamp=float(t)))
        jobs.append(job)
    queues = [api.QueueInfo(name="q1", weight=1),
              api.QueueInfo(name="q2", weight=1),
              api.QueueInfo(name="vip", weight=1,
                            capability=api.Resource(4000, 1000 * GI))]
    return _wire(pkg, queues, nodes, jobs), set()


def reservation_conf() -> str:
    conf = deployed_conf().replace(
        'actions: "enqueue, allocate-tpu, preempt, reclaim, backfill"',
        'actions: "enqueue, elect, allocate-tpu, backfill, reserve"')
    assert "elect" in conf
    return _add_plugin(conf, "gang", "reservation", {})


def with_engine(conf: str, engine: str) -> str:
    """``conf`` with every device engine swapped for the host's when
    ``engine`` is ``callbacks`` (allocate-tpu's tpu-fused, preempt's and
    reclaim's tpu)."""
    if engine == "tpu-fused":
        return conf
    assert engine == "callbacks", engine
    out = conf.replace("engine: tpu-fused\n", "engine: callbacks\n")
    return out.replace("engine: tpu\n", "engine: callbacks\n")


# world -> (builder, conf)
WORLDS = {
    "affinity-10k": (world_affinity, deployed_conf),
    "gpushare-10k": (world_gpushare, gpushare_conf),
    "affinity-preempt": (world_affinity_preempt, conformance_conf),
    "numa-1k": (world_numa, numa_conf),
    "proportional-1k": (world_proportional, proportional_conf),
    "tdm-10k": (world_tdm, tdm_conf),
    "topology-10k": (world_topology, topology_conf),
    "sla-overcommit-10k": (world_sla_overcommit, sla_overcommit_conf),
    "reservation-1k": (world_reservation, reservation_conf),
}
# the full-width worlds at a tenth, held live to the JAX package by tests
TENTH = {
    "affinity-1k": (lambda pkg: world_affinity(pkg, 200, 1000, 20),
                    deployed_conf),
    "gpushare-1k": (lambda pkg: world_gpushare(pkg, 200, 1000, 20, 8),
                    gpushare_conf),
    "tdm-1k": (lambda pkg: world_tdm(pkg, 200, 1000, 20), tdm_conf),
    "topology-1k": (lambda pkg: world_topology(pkg, 200, 1000, 20),
                    topology_conf),
    "sla-overcommit-1k": (lambda pkg: world_sla_overcommit(pkg, 200, 1000,
                                                           30),
                          sla_overcommit_conf),
}
# the tenths under another setting of their plugin, held live by tests
VARIANTS = {
    # both zones closed: no pod lands on a revocable node
    "tdm-1k-closed": (TENTH["tdm-1k"][0],
                      lambda: tdm_conf((CLOSED_WINDOW, CLOSED_WINDOW))),
    # a drain period of one second: the drain runs every cycle
    "tdm-1k-period": (TENTH["tdm-1k"][0], lambda: tdm_conf(period="1s")),
    # a factor below 1.0 is clamped to 1.2, and without sla nothing
    # overrides overcommit
    "overcommit-1k-clamped": (TENTH["sla-overcommit-1k"][0],
                              lambda: sla_overcommit_conf("0.5", sla=False)),
    "overcommit-1k": (TENTH["sla-overcommit-1k"][0],
                      lambda: sla_overcommit_conf("1.2", sla=False)),
}
ALL_WORLDS = {**WORLDS, **TENTH, **VARIANTS}
# cycles a world runs where its plugin needs more than CYCLES
WORLD_CYCLES = {"sla-overcommit": 3, "overcommit": 3, "reservation": 4}
# worlds whose digest carries a record a cycle ("per_cycle")
PER_CYCLE = ("tdm", "topology", "sla-overcommit", "overcommit",
             "reservation")
# worlds that meet a fault of the JAX package the port fixes (its tier
# dispatch: affinity-preempt, tdm-10k; its duration units: sla-overcommit-10k):
# recorded as it is and mended, and held to the mended record
MENDED = ("affinity-preempt", "tdm-10k", "sla-overcommit-10k")


# ---------------------------------------------------------------------------
# runs
# ---------------------------------------------------------------------------

def package(name: str):
    from system_reference import Package
    pkg = Package(name)
    import importlib
    pkg.synthetic = importlib.import_module(f"{name}.cache.synthetic")
    pkg.scheduler = importlib.import_module(f"{name}.scheduler")
    importlib.import_module(f"{name}.actions")
    importlib.import_module(f"{name}.plugins")
    return pkg


def vetoed_evicted(owner, vslot, pjob, masks, part) -> int:
    """A walk's evictions of a victim that a plugin of the first tier
    refused after the tier's first participating plugin offered it: none
    under upstream's dispatch, whose first tier then decides the node.
    owner i32[N, W] (the evicting task or -1), vslot i32[N, W], pjob i32[P],
    and the first tier's static masks bool[Mt, PJ, V+1] and participation
    bool[Mt, PJ]."""
    import numpy as np
    owner, vslot, pjob = (np.asarray(x) for x in (owner, vslot, pjob))
    masks, part = np.asarray(masks, bool), np.asarray(part, bool)
    n, w = np.nonzero(owner >= 0)
    if not n.size or not masks.shape[0]:
        return 0
    pj, v = pjob[owner[n, w]], vslot[n, w]
    hit, p = masks[:, pj, v], part[:, pj]               # [Mt, E]
    offered = p.any(0) & hit[p.argmax(0), np.arange(n.size)]
    refused = (p & ~hit).any(0)
    return int((offered & refused).sum())


class Recorder:
    """The cache's executor calls in order (binds and evictions), each
    allocate solve's node-tensor path, each preempt walk with the
    evictions it made against its first tier's veto (``vetoed_evicted``),
    and the proportional guard's refusals. The JAX package's walk runs in
    its per-task formulation (ROADMAP §3: its closed-form fill is not its
    per-task walk), patched where its preempt imports the builder at each
    phase; the port's is counted at its walk wrapper (B3 on the card, its
    plain version on the CPU)."""

    def __init__(self, pkg, cache):
        import importlib
        from sim_traces import TensorPathRecorder
        self.sequence = []
        self.evicted_from = []
        bind, evict = cache.binder.bind, cache.evictor.evict

        def rec_bind(task, hostname):
            self.sequence.append(["bind", f"{task.namespace}/{task.name}",
                                  hostname])
            return bind(task, hostname)

        def rec_evict(task, reason):
            self.sequence.append(["evict", f"{task.namespace}/{task.name}",
                                  reason])
            self.evicted_from.append(task.node_name)
            return evict(task, reason)

        cache.binder.bind = rec_bind
        cache.evictor.evict = rec_evict
        self.paths = TensorPathRecorder(pkg.allocate, pkg.cache.SchedulerCache)
        self.walks = 0
        self.vetoed = 0
        if pkg.name == "volcano_tpu":
            self._module = importlib.import_module("volcano_tpu.ops.evict")
            self._name = "build_preempt_walk"
            build = self._real = self._module.build_preempt_walk

            def patched(kinds, sizes, gang_commit, allow_cheap=True,
                        axis=None):
                fn = build(kinds, sizes, gang_commit, False, axis)

                def counted(*a):
                    self.walks += 1
                    out = fn(*a)
                    if kinds and kinds[0] == "static":
                        self.vetoed += vetoed_evicted(
                            out[1], a[1].vslot, a[5], *a[3][0])
                    return out
                return counted
        else:
            self._module = pkg.evict_tpu
            self._name = "walk"
            walk = self._real = pkg.evict_tpu.walk

            def patched(inputs, kinds, sizes, *a, **kw):
                self.walks += 1
                out = walk(inputs, kinds, sizes, *a, **kw)
                if kinds and kinds[0] == "static":
                    self.vetoed += vetoed_evicted(
                        out.owner.cpu(), inputs.nw.vslot.cpu(),
                        inputs.pjob.cpu(),
                        inputs.tier_masks[:sizes[0]].cpu(),
                        inputs.tier_part[:sizes[0]].cpu())
                return out
        setattr(self._module, self._name, patched)
        # the proportional guard's refusals, counted where both packages'
        # mask and live re-check call it
        self.refused = 0
        self._preds = importlib.import_module(f"{pkg.name}.plugins.predicates")
        guard = self._guard = self._preds.proportional_ok

        def counted_guard(*a, **kw):
            ok = guard(*a, **kw)
            self.refused += not ok
            return ok
        self._preds.proportional_ok = counted_guard
        # the fused allocate's batched replays (the others replay through
        # Statements)
        self.fast_replays = 0
        self._alloc = pkg.allocate
        fast = self._fast = pkg.allocate._replay_fused_fast

        def counted_fast(*a, **kw):
            self.fast_replays += 1
            return fast(*a, **kw)
        self._alloc._replay_fused_fast = counted_fast

    def close(self) -> None:
        self.paths.close()
        setattr(self._module, self._name, self._real)
        self._preds.proportional_ok = self._guard
        self._alloc._replay_fused_fast = self._fast


def _split_engine(world: str):
    """``NAME@ENGINE`` -> (NAME, ENGINE); a bare name runs the conf as
    written (tpu-fused)."""
    name, _, engine = world.partition("@")
    return name, engine or "tpu-fused"


def world_conf(world: str) -> str:
    name, engine = _split_engine(world)
    return with_engine(ALL_WORLDS[name][1](), engine)


def world_cycles(world: str) -> int:
    name = _split_engine(world)[0]
    return next((n for prefix, n in WORLD_CYCLES.items()
                 if name.startswith(prefix)), CYCLES)


def build_world(package_name: str, world: str):
    """(pkg, cache, critical pod keys) of one world in one package."""
    pkg = package(package_name)
    build, _ = ALL_WORLDS[_split_engine(world)[0]]
    cache, critical = build(pkg)
    return pkg, cache, critical


def _cycle_record(cache, recorder, reservation, seen) -> dict:
    """What one cycle decided: its binds and evictions (those from a
    revocable node by zone), the PodGroups by phase, and the reservation's
    target and locked nodes. ``seen``: the recorder's sequence and
    eviction lengths when the cycle began."""
    new = recorder.sequence[seen[0]:]
    zones = {n.name: n.revocable_zone for n in cache.nodes.values()}
    drained: dict = {}
    for node in recorder.evicted_from[seen[1]:]:
        if zones.get(node):
            drained[zones[node]] = drained.get(zones[node], 0) + 1
    phases: dict = {}
    for job in cache.jobs.values():
        phase = job.podgroup.phase.value
        phases[phase] = phases.get(phase, 0) + 1
    target = reservation.target_job
    return {"binds": sum(1 for x in new if x[0] == "bind"),
            "evicts": sum(1 for x in new if x[0] == "evict"),
            "evicts_by_zone": dict(sorted(drained.items())),
            "podgroup_phases": dict(sorted(phases.items())),
            "target": None if target is None else target.uid,
            "locked": sorted(reservation.locked_nodes)}


def run_world(package_name: str, world: str, device=None,
              cycles=None, keep=None) -> dict:
    """Build and schedule one world through ``package_name``'s Scheduler
    shell (``NAME@callbacks``: with the host engines). Returns {"digest",
    "wall_s", "allocate", "guard_refusals"}: for the port each cycle's
    allocate stats (order, assemble, solve and replay seconds, solves,
    rounds, re-check rejections), and the proportional guard's refusals
    (mask and re-check). The cache is appended to the list ``keep`` when
    one is given."""
    import importlib
    from system_reference import LogicalClock
    pkg, cache, critical = build_world(package_name, world)
    if keep is not None:
        keep.append(cache)
    conf = world_conf(world)
    cycles = world_cycles(world) if cycles is None else cycles
    per_cycle = _split_engine(world)[0].startswith(PER_CYCLE)
    # the reservation is a module global that outlives a scheduler
    reservation = importlib.import_module(
        f"{package_name}.utils.reservation").Reservation
    reservation.reset()
    port = package_name != "volcano_tpu"
    kwargs = {"device": device} if port else {}
    sched = pkg.scheduler.Scheduler(cache, conf, **kwargs)
    # a cycle is one second of a logical clock, however long it took: the
    # in-flight watchdog's ack deadline (60 s) must not read the host's
    # speed
    clock = LogicalClock()
    sched.clock = clock
    cache.time_fn = cache.resync_queue.time_fn = clock.time
    cache.inflight.time_fn = clock.time
    recorder = Recorder(pkg, cache)
    allocate = []
    failures = []
    records = []
    t0 = time.perf_counter()
    try:
        for _ in range(cycles):
            seen = len(recorder.sequence), len(recorder.evicted_from)
            failures += [name for name, _ in sched.run_once()]
            if per_cycle:
                records.append(_cycle_record(cache, recorder, reservation,
                                             seen))
            clock.sleep(1.0)
            if port:
                from volcano_tpu_torch.framework import get_action
                st = get_action("allocate-tpu").last_stats
                allocate.append({k: st.get(k) for k in (
                    "order", "assemble", "solve", "replay", "solves",
                    "rounds", "rejected")})
    finally:
        recorder.close()
        reservation.reset()
    wall = time.perf_counter() - t0
    out = digest(cache, recorder, critical, failures)
    if per_cycle:
        out["per_cycle"] = records
        out["fast_replays"] = recorder.fast_replays
    return {"digest": out, "wall_s": wall, "allocate": allocate,
            "guard_refusals": recorder.refused}


def digest(cache, recorder, critical, failures) -> dict:
    seq = recorder.sequence
    phases = sorted([uid, j.podgroup.phase.value]
                    for uid, j in cache.jobs.items())
    counts: dict = {}
    for _, phase in phases:
        counts[phase] = counts.get(phase, 0) + 1
    paths = recorder.paths.summary()
    evicted = [s[1] for s in seq if s[0] == "evict"]
    walked = {"vetoed_evicted": recorder.vetoed} if recorder.walks else {}
    return {**walked,
        "sequence_sha256": _sha(seq),
        "binds": sum(1 for s in seq if s[0] == "bind"),
        "evicts": len(evicted),
        "critical_evicted": sum(1 for key in evicted if key in critical),
        "podgroups_sha256": _sha(phases),
        "podgroup_phases": dict(sorted(counts.items())),
        "solves": paths["solves"],
        "tensor_paths_sha256": paths["sha256"],
        "walks": recorder.walks,
        "action_failures": failures,
    }


def _child_env() -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    if NO_FMA_XLA_FLAGS not in flags:
        env["XLA_FLAGS"] = (flags + " " + NO_FMA_XLA_FLAGS).strip()
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH", "")) if p)
    return env


def _child(world: str, mend: bool) -> int:
    if mend:
        sys.path.insert(0, os.path.join(REPO, "tests"))
        from torch_parity import mend_jax
        mend_jax()
    out = run_world("volcano_tpu", world)
    print(RECORD_MARKER + json.dumps(out["digest"], sort_keys=True),
          flush=True)
    return 0


def jax_record(world: str, mend: bool = False,
               timeout: float = 7200) -> dict:
    """One world through the JAX package in a child process, its tier
    dispatch mended if ``mend``."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", world]
        + (["--mend"] if mend else []),
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


def held_to(record: dict) -> dict:
    """The record of a world that the port is held to: the JAX package
    mended where ``held_to`` says so, else as it is."""
    return record["mended"] if record.get("held_to") == "mended" else record


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--child"]:
        return _child(argv[1], "--mend" in argv[2:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help=f"compute WORLDS through the JAX package and "
                         f"write {DIGESTS}")
    ap.add_argument("--worlds", nargs="+", choices=sorted(WORLDS),
                    help="with --write: only these worlds, merged into "
                         "the file")
    ap.add_argument("--jax-only", action="store_true",
                    help="with --write: leave each world's port_cpu as "
                         "the file has it")
    ap.add_argument("--run", help="print one world's record (a name of "
                    "ALL_WORLDS, NAME@callbacks for the host engines)")
    ap.add_argument("--package", default="volcano_tpu_torch")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.run:
        out = run_world(args.package, args.run, args.device)
        print(json.dumps(dict(out["digest"], wall_s=out["wall_s"],
                              allocate=out["allocate"],
                              guard_refusals=out["guard_refusals"]),
                         sort_keys=True))
        return 0
    if not args.write:
        ap.error("one of --write / --run is required")
    records = load_digests() if os.path.exists(DIGESTS) else {}
    for world in args.worlds or WORLDS:
        t0 = time.perf_counter()
        record = jax_record(world)
        record["jax_wall_s"] = time.perf_counter() - t0
        if world in MENDED:
            t0 = time.perf_counter()
            record["mended"] = jax_record(world, mend=True)
            record["mended"]["jax_wall_s"] = time.perf_counter() - t0
            record["held_to"] = "mended"
        if args.jax_only and "port_cpu" in records.get(world, {}):
            record["port_cpu"] = records[world]["port_cpu"]
        else:
            # the port's CPU path: B1's plain version once a solve, B3's
            # once a walk (chip_smoke.py holds the card's launches to these)
            port = run_world("volcano_tpu_torch", world, "cpu")["digest"]
            if any(held_to(record).get(k) != v
                   for k, v in port.items()):
                print(f"{world}: the port's CPU path differs from the JAX "
                      f"package's: {port} against {held_to(record)}",
                      file=sys.stderr)
            record["port_cpu"] = {"solves": port["solves"],
                                  "walks": port["walks"]}
        records[world] = record
        print(f"{world}: {record}", file=sys.stderr, flush=True)
    doc = {"schema": "volcano-tpu-plugin-reference/v1",
           "command": "JAX_PLATFORMS=cpu python tools/plugin_reference.py "
                      "--write",
           "xla_flags": NO_FMA_XLA_FLAGS,
           "cycles": CYCLES,
           "worlds": {w: records[w] for w in WORLDS if w in records}}
    with open(DIGESTS, "w") as f:
        f.write(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
