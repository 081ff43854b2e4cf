"""The task-topology plugin in the port against the JAX package, on the
CPU: tests/test_task_topology.py's cases, then its scheduling worlds under
both engines.

The annotations, buckets and the event handler are pure Python: each case
runs through both packages' modules in process and must agree, then
asserts what the JAX package's test asserts. The scheduling worlds
(tests/torch_parity.py::topology_case: ``mates``, ``spread`` and
``bound``, a ps already running) run one allocate under the callbacks and
the tpu-fused engine; the JAX package runs in a child at XLA level 0. The
binds, each allocate's task order and every pending task's node scores
must be equal. The fused solve does not read node_order_fns in either
package (ROADMAP §3), so the node score decides only under callbacks:
``spread``'s ps land on two nodes there and on one under tpu-fused.
"""

import types

import pytest

from volcano_tpu.api import JobInfo as JaxJob
from volcano_tpu.api import PodGroup as JaxPodGroup
from volcano_tpu.api import PodGroupPhase as JaxPhase
from volcano_tpu.api import Resource as JaxResource
from volcano_tpu.api import TaskInfo as JaxTask
from volcano_tpu.plugins import task_topology as jax_topology
from volcano_tpu_torch.api import (JobInfo, PodGroup, PodGroupPhase,
                                   Resource, TaskInfo)
from volcano_tpu_torch.plugins import task_topology
from volcano_tpu_torch.plugins.task_topology import (
    AFFINITY_ANNOTATION, ANTI_AFFINITY_ANNOTATION, TASK_ORDER_ANNOTATION,
    JobManager, TaskTopology, read_topology_from_pg_annotations)

from torch_parity import port_gc_windows  # noqa: F401 (autouse)
from torch_parity import TOPOLOGY_KEYS, jax_reference, topology_run

PORT = types.SimpleNamespace(job=JobInfo, pg=PodGroup, phase=PodGroupPhase,
                             res=Resource, task=TaskInfo, mod=task_topology)
JAX = types.SimpleNamespace(job=JaxJob, pg=JaxPodGroup, phase=JaxPhase,
                            res=JaxResource, task=JaxTask, mod=jax_topology)
ENGINES = ("callbacks", "tpu-fused")


def build_job(pk, name, annotations, task_specs, min_avail=1,
              queue="default"):
    """tests/test_task_topology.py::build_job in package ``pk``:
    task_specs (task_role, count, cpu)."""
    pg = pk.pg(name=name, queue=queue, min_member=min_avail,
               phase=pk.phase.INQUEUE, annotations=annotations)
    job = pk.job(uid=name, name=name, queue=queue, min_available=min_avail,
                 podgroup=pg)
    i = 0
    for role, count, cpu in task_specs:
        for _ in range(count):
            job.add_task_info(pk.task(
                uid=f"{name}-{i}", name=f"{name}-{role}-{i}", job=name,
                task_role=role, resreq=pk.res(cpu, 100),
                creation_timestamp=float(i)))
            i += 1
    return job


def _topology(pk, *a):
    topo = pk.mod.read_topology_from_pg_annotations(build_job(pk, *a))
    return None if topo is None else (topo.affinity, topo.anti_affinity,
                                      topo.task_order)


def _buckets(pk, specs, **topo):
    job = build_job(pk, "j1", {}, specs)
    mgr = pk.mod.JobManager("j1")
    mgr.apply_task_topology(pk.mod.TaskTopology(**topo))
    mgr.construct_bucket(job.tasks)
    return job, mgr, ([sorted(b.tasks) for b in mgr.buckets],
                      mgr.bucket_max_size, dict(mgr.pod_in_bucket))


# -- tests/test_task_topology.py: the annotations --------------------------------

class TestAnnotations:
    def test_parse(self):
        args = ("j1", {AFFINITY_ANNOTATION: "ps,worker",
                       ANTI_AFFINITY_ANNOTATION: "ps",
                       TASK_ORDER_ANNOTATION: "worker,ps"},
                [("ps", 2, 100), ("worker", 2, 100)])
        assert _topology(PORT, *args) == _topology(JAX, *args) == (
            [["ps", "worker"]], [["ps"]], ["worker", "ps"])
        job = build_job(PORT, *args)
        assert read_topology_from_pg_annotations(job).task_order == \
            ["worker", "ps"]

    def test_unknown_task_rejected(self):
        args = ("j1", {AFFINITY_ANNOTATION: "ps,ghost"}, [("ps", 2, 100)])
        assert _topology(PORT, *args) is None
        assert _topology(JAX, *args) is None

    def test_no_annotations(self):
        args = ("j1", {}, [("ps", 1, 100)])
        assert _topology(PORT, *args) is None
        assert _topology(JAX, *args) is None


# -- tests/test_task_topology.py: the buckets ------------------------------------

class TestBuckets:
    def test_affinity_tasks_share_bucket(self):
        specs = [("ps", 1, 100), ("worker", 2, 100)]
        _, mgr, got = _buckets(PORT, specs, affinity=[["ps", "worker"]])
        assert got == _buckets(JAX, specs, affinity=[["ps", "worker"]])[2]
        assert len(mgr.buckets) == 1
        assert mgr.bucket_max_size == 3

    def test_self_anti_affinity_splits(self):
        specs = [("ps", 3, 100)]
        _, mgr, got = _buckets(PORT, specs, anti_affinity=[["ps"]])
        assert got == _buckets(JAX, specs, anti_affinity=[["ps"]])[2]
        assert len(mgr.buckets) == 3

    def test_inter_anti_affinity_splits(self):
        specs = [("ps", 1, 100), ("worker", 1, 100)]
        _, mgr, got = _buckets(PORT, specs, anti_affinity=[["ps", "worker"]])
        assert got == _buckets(JAX, specs,
                               anti_affinity=[["ps", "worker"]])[2]
        assert len(mgr.buckets) == 2

    def test_untopologized_task_out_of_bucket(self):
        specs = [("ps", 1, 100), ("other", 1, 100)]
        job, mgr, got = _buckets(PORT, specs, affinity=[["ps"]])
        assert got == _buckets(JAX, specs, affinity=[["ps"]])[2]
        out = [t for t in job.tasks.values() if t.task_role == "other"][0]
        assert mgr.get_bucket(out) is None


@pytest.mark.parametrize("specs, topo", [
    ([("ps", 2, 300), ("worker", 4, 100), ("chief", 1, 50)],
     {"affinity": [["ps", "worker"], ["chief"]],
      "anti_affinity": [["worker"]], "task_order": ["chief", "ps"]}),
    ([("ps", 3, 100), ("worker", 3, 200)],
     {"affinity": [["ps", "worker"]], "anti_affinity": [["ps"]]}),
    ([("a", 2, 100), ("b", 2, 100), ("c", 2, 100)],
     {"affinity": [["a", "b", "c"]], "anti_affinity": [["a", "c"]],
      "task_order": ["c", "b", "a"]}),
])
def test_buckets_and_task_order_equal_jax(specs, topo):
    """Bucket building (the reversed TaskOrder sort, the net affinity of a
    task to each bucket, the request score tie) and the task order's
    comparator agree pair by pair."""
    port_job, port_mgr, got = _buckets(PORT, specs, **topo)
    jax_job, jax_mgr, want = _buckets(JAX, specs, **topo)
    assert got == want
    port_plugin = task_topology.TaskTopologyPlugin()
    port_plugin.managers = {"j1": port_mgr}
    jax_plugin = jax_topology.TaskTopologyPlugin()
    jax_plugin.managers = {"j1": jax_mgr}
    for a in port_job.tasks:
        for b in port_job.tasks:
            assert port_plugin.task_order_fn(
                port_job.tasks[a], port_job.tasks[b]) == \
                jax_plugin.task_order_fn(jax_job.tasks[a], jax_job.tasks[b])


def test_allocate_event_skips_the_order_simulation():
    """The fused allocate's order simulation fires one aggregated event a
    job, which carries no task: the handler leaves the buckets alone; a
    task's event moves it into its bucket's bound count."""
    from volcano_tpu_torch.actions.allocate import _AggTask
    from volcano_tpu_torch.framework.session import Event
    job, mgr, _ = _buckets(PORT, [("ps", 1, 100), ("worker", 2, 100)],
                           affinity=[["ps", "worker"]])
    plugin = task_topology.TaskTopologyPlugin()
    handlers = []
    ssn = types.SimpleNamespace(
        jobs={"j1": job}, add_task_order_fn=lambda *a: None,
        add_node_order_fn=lambda *a: None,
        add_event_handler=handlers.append)
    job.podgroup.annotations[AFFINITY_ANNOTATION] = "ps,worker"
    plugin.on_session_open(ssn)
    handler = handlers[0]
    assert not handler.aggregatable
    bucket = plugin.managers["j1"].buckets[0]
    handler.allocate_func(Event(_AggTask("j1", Resource(300, 300))))
    assert (bucket.bound_task, len(bucket.tasks)) == (0, 3)
    task = job.tasks["j1-1"]
    task.node_name = "n0"
    handler.allocate_func(Event(task))
    assert (bucket.bound_task, len(bucket.tasks), bucket.node) == \
        (1, 2, {"n0": 1})


# -- tests/test_task_topology.py: the scheduling worlds ---------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_reference("topology", TOPOLOGY_KEYS,
                         tmp_path_factory.mktemp("jax") / "topology.pkl")


def _run(case, engine, reference):
    got = topology_run(True, f"{case}:{engine}")
    assert got == reference[f"{case}:{engine}"]
    return got


class TestScheduling:
    @pytest.mark.parametrize("engine", ENGINES)
    def test_affinity_mates_land_together(self, engine, reference):
        binds = _run("mates", engine, reference)["binds"]
        assert len(binds) == 3
        assert len(set(binds.values())) == 1

    @pytest.mark.parametrize("engine", ENGINES)
    def test_anti_affinity_tasks_spread(self, engine, reference):
        """The node score spreads the ps under callbacks; the fused solve
        does not read it (in the JAX package as in the port) and packs."""
        binds = _run("spread", engine, reference)["binds"]
        assert len(binds) == 2
        assert len(set(binds.values())) == (2 if engine == "callbacks"
                                            else 1)


@pytest.mark.parametrize("engine", ENGINES)
def test_bound_mate_pulls_the_bucket(engine, reference):
    """A running ps pulls its bucket's workers onto its node: the node
    score counts the bound mate, less the workers' anti-affinity."""
    got = _run("bound", engine, reference)
    scores = got["scores"]
    assert all(s["n1"] > s["n0"] for s in scores.values())
    assert set(got["binds"].values()) == {"n1"}
