"""The in-process Volcano system of volcano_tpu_torch (``system.py``: the
object store, admission webhooks, controllers, vcctl's commands and the
scheduler in one process, and ``cmd.py``'s binaries), held to the JAX
package's.

- The port's versions of tests/test_system_e2e.py's classes: each test body
  is the reference's, run once through each package (``pk``: the package's
  names). Every system a body builds is recorded, and the two packages'
  end states (every Job's phase and counts, every PodGroup's phase and
  conditions, every Pod's node and phase, the store's events in order) must
  be equal. The systems run on a logical clock (a cycle is one second) over
  a store that stamps creation times from a counter
  (tools/system_reference.py), so nothing read from the wall clock can
  reorder them. TestDeployArtifacts and TestHelmChart check the JAX
  package's deploy/ tree and are not ported; ``test_metrics_healthz_
  endpoint`` is tests/test_torch_metrics_server.py's.
- The small worlds of tools/system_reference.py (system-preempt under
  deploy/scheduler.conf, system-lifecycle) against the JAX package's
  digests in tests/system_reference_digests.json; system-10k is the card's
  (``chip_smoke.py``'s ``system`` phase).
- tests/test_overload.py's TestFrontDoorIntegration, through both packages.
- The entry points' device rule, the native store and the binaries'
  dispatcher.
"""

import copy
import functools
import importlib
import itertools
import os
import sys

import pytest
import torch

import volcano_tpu.api as jax_api
import volcano_tpu.apis.objects as jax_objects
import volcano_tpu.cache.store_wiring as jax_wiring
import volcano_tpu.cli.vcctl as jax_vcctl
import volcano_tpu.controllers as jax_controllers
import volcano_tpu.controllers.job_state as jax_job_state
import volcano_tpu.framework as jax_framework
import volcano_tpu.store as jax_store
import volcano_tpu.webhooks.admission as jax_admission
import volcano_tpu.webhooks.backpressure as jax_backpressure
import volcano_tpu_torch.api as pt_api
import volcano_tpu_torch.apis.objects as pt_objects
import volcano_tpu_torch.cache.store_wiring as pt_wiring
import volcano_tpu_torch.cli.vcctl as pt_vcctl
import volcano_tpu_torch.controllers as pt_controllers
import volcano_tpu_torch.controllers.job_state as pt_job_state
import volcano_tpu_torch.framework as pt_framework
import volcano_tpu_torch.store as pt_store
import volcano_tpu_torch.webhooks.admission as pt_admission
import volcano_tpu_torch.webhooks.backpressure as pt_backpressure
from volcano_tpu_torch import cmd as pt_cmd
from volcano_tpu_torch.system import VolcanoSystem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import system_reference as ref  # noqa: E402


class Names:
    """One package's names as the reference tests use them, and the
    systems its ``make_system`` built."""

    def __init__(self, package, api, objects, store, wiring, controllers,
                 job_state, framework, vcctl, device):
        self.pkg = ref.Package(package)
        self.metrics = importlib.import_module(f"{package}.metrics")
        self.obs = importlib.import_module(f"{package}.obs")
        self.objects = objects
        self.device = device
        for name in ("BusEvent", "BusAction", "JobPhase", "PodGroupPhase",
                     "QueueState", "Resource", "NodeInfo"):
            setattr(self, name, getattr(api, name))
        for name in ("Job", "JobSpec", "LifecyclePolicy", "ObjectMeta",
                     "Pod", "PodTemplate", "TaskSpec", "QueueCR",
                     "QueueSpecCR", "PVC", "PriorityClass"):
            setattr(self, name, getattr(objects, name))
        self.AdmissionError = store.AdmissionError
        self.GROUP_NAME_ANNOTATION = wiring.GROUP_NAME_ANNOTATION
        self.GarbageCollector = controllers.GarbageCollector
        self.job_state = job_state
        self.open_session = functools.partial(framework.open_session,
                                              device=device) \
            if device is not None else framework.open_session
        self.close_session = framework.close_session
        self.main = vcctl.main
        self.created = []

    def make_system(self):
        """tests/test_system_e2e.py's make_system: three 8-core nodes."""
        nodes = []
        for i in range(3):
            alloc = self.Resource(8000, 16 << 30)
            alloc.max_task_num = 110
            nodes.append(self.NodeInfo(name=f"node-{i}", allocatable=alloc))
        system = ref.new_system(self.pkg, device=self.device, nodes=nodes)
        self.created.append(system)
        return system

    def submit_mpi_job(self, system, name="mpi-job", replicas=3,
                       min_available=None, plugins=None):
        job = self.Job(
            metadata=self.ObjectMeta(name=name),
            spec=self.JobSpec(
                min_available=min_available if min_available is not None
                else 0,
                tasks=[self.TaskSpec(name="worker", replicas=replicas,
                                     template=self.PodTemplate(
                                         resources=self.Resource(
                                             1000, 1 << 30)))],
                plugins=plugins or {}))
        return system.store.create(job)


JAX = Names("volcano_tpu", jax_api, jax_objects, jax_store, jax_wiring,
            jax_controllers, jax_job_state, jax_framework, jax_vcctl, None)
PORT = Names("volcano_tpu_torch", pt_api, pt_objects, pt_store, pt_wiring,
             pt_controllers, pt_job_state, pt_framework, pt_vcctl, "cpu")


def held(method):
    """Run a reference test body through each package; every system it
    built must end in the same state in both."""
    def test(self):
        states = {}
        for side, pk in (("jax", JAX), ("port", PORT)):
            pk.created = []
            pk.objects._uid = itertools.count()
            method(self, pk)
            states[side] = [ref.state_records(s) for s in pk.created]
        assert states["port"] == states["jax"]

    test.__name__ = method.__name__
    test.__qualname__ = method.__qualname__
    test.__doc__ = method.__doc__
    return test


# ---------------------------------------------------------------------------
# tests/test_system_e2e.py's classes, through both packages
# ---------------------------------------------------------------------------

class TestJobLifecycle:
    @held
    def test_submit_schedule_run(self, pk):
        """Job create → webhook defaults → controller podgroup →
        scheduler enqueue admits the gang → controller creates pods (the
        syncTask gate: no pods while the PodGroup is Pending,
        job_controller_actions.go:263-280) → scheduler binds → Running."""
        sys = pk.make_system()
        pk.submit_mpi_job(sys)
        # webhook defaulted minAvailable to Σreplicas
        job = sys.store.get("Job", "default", "mpi-job")
        assert job.spec.min_available == 3
        # controller created the podgroup but NOT the pods yet
        assert sys.store.list("Pod") == []
        pg = sys.store.get("PodGroup", "default", "mpi-job")
        assert pg is not None and pg.spec.min_member == 3
        assert pg.spec.min_resources.cpu == 3000

        sys.schedule_once()          # enqueue admits -> pods created
        pods = sys.store.list("Pod")
        assert len(pods) == 3
        sys.schedule_once()          # allocate binds the gang

        pods = sys.store.list("Pod")
        assert all(p.status.phase == "Running" for p in pods)
        assert len({p.status.node_name for p in pods}) >= 1
        job = sys.store.get("Job", "default", "mpi-job")
        assert job.status.running == 3
        assert job.status.state == pk.JobPhase.RUNNING
        pg = sys.store.get("PodGroup", "default", "mpi-job")
        assert pg.status.phase == pk.PodGroupPhase.RUNNING

    @held
    def test_gang_blocks_partial(self, pk):
        """A gang larger than the cluster binds nothing."""
        sys = pk.make_system()
        pk.submit_mpi_job(sys, name="huge", replicas=100)
        sys.schedule_once()
        pods = sys.store.list("Pod")
        assert all(p.status.phase == "Pending" for p in pods)
        pg = sys.store.get("PodGroup", "default", "huge")
        assert any(c["type"] == "Unschedulable"
                   for c in pg.status.conditions)

    @held
    def test_complete_and_gc(self, pk):
        sys = pk.make_system()
        job = pk.submit_mpi_job(sys)
        job.spec.ttl_seconds_after_finished = 0.0
        sys.schedule_once()
        sys.schedule_once()
        for pod in list(sys.store.list("Pod")):
            sys.store.finish_pod(pod.metadata.namespace, pod.metadata.name)
        job = sys.store.get("Job", "default", "mpi-job")
        assert job.status.state == pk.JobPhase.COMPLETED
        gc = next(c for c in sys.controllers
                  if isinstance(c, pk.GarbageCollector))
        deleted = gc.process()
        assert deleted == ["default/mpi-job"]
        assert sys.store.get("Job", "default", "mpi-job") is None

    @held
    def test_suspend_resume(self, pk):
        """vcctl suspend posts an AbortJob command; pods are torn down;
        resume restarts (SURVEY.md §3.4)."""
        sys = pk.make_system()
        pk.submit_mpi_job(sys)
        sys.schedule_once()
        sys.jobs.suspend("mpi-job")
        job = sys.store.get("Job", "default", "mpi-job")
        assert job.status.state in (pk.JobPhase.ABORTING, pk.JobPhase.ABORTED)
        assert sys.store.list("Pod") == []
        sys.jobs.resume("mpi-job")
        job = sys.store.get("Job", "default", "mpi-job")
        assert job.status.state in (pk.JobPhase.RESTARTING,
                                    pk.JobPhase.PENDING,
                                    pk.JobPhase.RUNNING)
        # pods recreated once the scheduler re-admits the gang (syncTask
        # gate: no pods while the PodGroup is Pending)
        sys.schedule_once()
        assert len(sys.store.list("Pod")) == 3

    @held
    def test_pod_failure_policy_restart(self, pk):
        """LifecyclePolicy PodFailed -> RestartJob tears down and retries
        (job_error_handling e2e analogue)."""
        sys = pk.make_system()
        job = pk.Job(
            metadata=pk.ObjectMeta(name="fragile"),
            spec=pk.JobSpec(
                tasks=[pk.TaskSpec(name="w", replicas=2,
                                template=pk.PodTemplate(
                                    resources=pk.Resource(1000, 1 << 30)))],
                policies=[pk.LifecyclePolicy(event=pk.BusEvent.POD_FAILED,
                                          action=pk.BusAction.RESTART_JOB)]))
        sys.store.create(job)
        sys.schedule_once()
        sys.schedule_once()
        pod = sys.store.list("Pod")[0]
        sys.store.finish_pod(pod.metadata.namespace, pod.metadata.name,
                             succeeded=False)
        job = sys.store.get("Job", "default", "fragile")
        assert job.status.retry_count == 1
        assert job.status.state in (pk.JobPhase.RESTARTING,
                                    pk.JobPhase.PENDING)

    @held
    def test_abort_retains_finished_pods(self, pk):
        """PodRetainPhaseSoft (state/factory.go:39-44): abort keeps
        Succeeded/Failed pods, drains the running ones."""
        sys = pk.make_system()
        pk.submit_mpi_job(sys, name="soft", min_available=1)
        sys.schedule_once()
        sys.schedule_once()
        pods = sys.store.list("Pod")
        assert len(pods) == 3
        sys.store.finish_pod(pods[0].metadata.namespace,
                             pods[0].metadata.name)   # one Succeeded
        sys.jobs.suspend("soft")                      # AbortJob
        remaining = sys.store.list("Pod")
        assert [p.status.phase for p in remaining] == ["Succeeded"]

    @held
    def test_exit_code_policy(self, pk):
        """exitCode lifecycle policies (job.go:162-164,
        job_controller_util.go:170-200): a policy keyed on a termination
        code fires its action; other codes fall through."""
        sys = pk.make_system()
        job = pk.Job(
            metadata=pk.ObjectMeta(name="codes"),
            spec=pk.JobSpec(
                tasks=[pk.TaskSpec(name="w", replicas=2,
                                template=pk.PodTemplate(
                                    resources=pk.Resource(1000, 1 << 30)))],
                policies=[pk.LifecyclePolicy(action=pk.BusAction.RESTART_JOB,
                                          exit_code=137)]))
        sys.store.create(job)
        sys.schedule_once()
        sys.schedule_once()
        pods = sys.store.list("Pod")
        # exit 1: policy does not match -> plain sync, no restart
        sys.store.finish_pod(pods[0].metadata.namespace,
                             pods[0].metadata.name, succeeded=False,
                             exit_code=1)
        job = sys.store.get("Job", "default", "codes")
        assert job.status.retry_count == 0
        # exit 137 (OOM-kill style): policy fires RestartJob
        sys.store.finish_pod(pods[1].metadata.namespace,
                             pods[1].metadata.name, succeeded=False,
                             exit_code=137)
        job = sys.store.get("Job", "default", "codes")
        assert job.status.retry_count == 1
        assert job.status.state in (pk.JobPhase.RESTARTING,
                                    pk.JobPhase.PENDING)

    @held
    def test_job_plugins_env_svc(self, pk):
        sys = pk.make_system()
        pk.submit_mpi_job(sys, name="mpi", plugins={"env": [], "svc": [],
                                                 "ssh": []})
        sys.schedule_once()          # enqueue -> pods created
        pods = sys.store.list("Pod")
        env = {e["name"]: e["value"] for e in pods[0].template.env}
        assert env["VC_TASK_INDEX"] in ("0", "1", "2")
        assert "mpi-worker-0.mpi" in env["VC_WORKER_HOSTS"]
        assert env["VC_WORKER_NUM"] == "3"
        assert any(v.get("secret") == "mpi-ssh"
                   for v in pods[0].template.volumes)
        job = sys.store.get("Job", "default", "mpi")
        assert job.metadata.annotations.get(
            "volcano.sh/ssh-secret") == "mpi-ssh"


class TestAdmission:
    @held
    def test_min_available_exceeds_replicas_denied(self, pk):
        sys = pk.make_system()
        with pytest.raises(pk.AdmissionError):
            pk.submit_mpi_job(sys, name="bad", replicas=2, min_available=5)

    @held
    def test_unknown_queue_denied(self, pk):
        sys = pk.make_system()
        job = pk.Job(metadata=pk.ObjectMeta(name="q"),
                  spec=pk.JobSpec(queue="nope",
                               tasks=[pk.TaskSpec(name="t", replicas=1)]))
        with pytest.raises(pk.AdmissionError):
            sys.store.create(job)

    @held
    def test_closed_queue_denied(self, pk):
        sys = pk.make_system()
        sys.queues.create("night", weight=1)
        sys.queues.operate("night", "close")
        q = sys.store.get("Queue", "default", "night")
        assert q.status.state == pk.QueueState.CLOSED
        job = pk.Job(metadata=pk.ObjectMeta(name="j"),
                  spec=pk.JobSpec(queue="night",
                               tasks=[pk.TaskSpec(name="t", replicas=1)]))
        with pytest.raises(pk.AdmissionError):
            sys.store.create(job)

    @held
    def test_queue_weight_validated(self, pk):
        sys = pk.make_system()
        with pytest.raises(pk.AdmissionError):
            sys.queues.create("bad", weight=-1)

    @held
    def test_queue_hierarchy_validated(self, pk):
        """validate_queue.go:113-168: weights/path length match, positive
        numeric weights, no sub-path conflicts."""
        sys = pk.make_system()

        def queue(name, hierarchy, weights):
            return pk.QueueCR(
                metadata=pk.ObjectMeta(
                    name=name, namespace="default",
                    annotations={"volcano.sh/hierarchy": hierarchy,
                                 "volcano.sh/hierarchy-weights": weights}),
                spec=pk.QueueSpecCR(weight=1))

        with pytest.raises(pk.AdmissionError):     # length mismatch
            sys.store.create(queue("q1", "root/sci", "100"))
        with pytest.raises(pk.AdmissionError):     # non-numeric weight
            sys.store.create(queue("q2", "root/sci", "100/abc"))
        with pytest.raises(pk.AdmissionError):     # non-positive weight
            sys.store.create(queue("q3", "root/sci", "100/0"))
        sys.store.create(queue("q4", "root/sci/dev", "100/50/50"))
        with pytest.raises(pk.AdmissionError):     # sub-path conflict
            sys.store.create(queue("q5", "root/sci", "100/50"))

    @held
    def test_duplicate_task_name_denied(self, pk):
        sys = pk.make_system()
        job = pk.Job(metadata=pk.ObjectMeta(name="dup"),
                  spec=pk.JobSpec(tasks=[pk.TaskSpec(name="a", replicas=1),
                                      pk.TaskSpec(name="a", replicas=1)]))
        with pytest.raises(pk.AdmissionError):
            sys.store.create(job)


class TestPodsWebhook:
    """/pods admission (admit_pod.go:1-203) + the store bind gate."""

    @held
    def test_vc_job_pod_denied_while_podgroup_pending(self, pk):
        """A pod carrying a group annotation pointing at a Pending PodGroup
        is rejected at creation."""
        sys = pk.make_system()
        pk.submit_mpi_job(sys)        # PodGroup exists, phase Pending
        rogue = pk.Pod(metadata=pk.ObjectMeta(
            name="rogue",
            annotations={pk.GROUP_NAME_ANNOTATION: "mpi-job"}))
        with pytest.raises(pk.AdmissionError):
            sys.store.create(rogue)
        sys.schedule_once()        # enqueue admits the group
        sys.store.create(rogue)    # now allowed

    @held
    def test_unknown_group_annotation_denied(self, pk):
        sys = pk.make_system()
        rogue = pk.Pod(metadata=pk.ObjectMeta(
            name="orphan", annotations={pk.GROUP_NAME_ANNOTATION: "nope"}))
        with pytest.raises(pk.AdmissionError):
            sys.store.create(rogue)

    @held
    def test_foreign_scheduler_pod_allowed(self, pk):
        sys = pk.make_system()
        pod = pk.Pod(metadata=pk.ObjectMeta(name="other"),
                  scheduler_name="default-scheduler")
        sys.store.create(pod)      # not ours; no gate

    @held
    def test_jdb_annotations_validated(self, pk):
        sys = pk.make_system()
        bad = pk.Pod(metadata=pk.ObjectMeta(
            name="bad", annotations={"volcano.sh/jdb-min-available": "0"}))
        with pytest.raises(pk.AdmissionError):
            sys.store.create(bad)
        bad2 = pk.Pod(metadata=pk.ObjectMeta(
            name="bad2",
            annotations={"volcano.sh/jdb-max-unavailable": "150%"}))
        with pytest.raises(pk.AdmissionError):
            sys.store.create(bad2)
        both = pk.Pod(metadata=pk.ObjectMeta(
            name="both",
            annotations={"volcano.sh/jdb-min-available": "1",
                         "volcano.sh/jdb-max-unavailable": "50%"}))
        with pytest.raises(pk.AdmissionError):
            sys.store.create(both)
        ok = pk.Pod(metadata=pk.ObjectMeta(
            name="ok", annotations={"volcano.sh/jdb-min-available": "50%"}))
        sys.store.create(ok)

    @held
    def test_bind_gated_on_pending_podgroup(self, pk):
        """ObjectStore.bind_pod refuses to run a pod whose gang is still
        Pending (the in-process enforcement of the webhook)."""
        sys = pk.make_system()
        pod = pk.Pod(metadata=pk.ObjectMeta(name="solo"),
                  template=pk.PodTemplate(resources=pk.Resource(500, 1 << 30)))
        sys.store.create(pod)      # pg controller creates a Pending group
        with pytest.raises(pk.AdmissionError):
            sys.store.bind_pod("default", "solo", "node-0")


class TestBarePod:
    @held
    def test_bare_pod_gets_podgroup_and_schedules(self, pk):
        """SURVEY.md §3.5: plain pod → pg controller creates a 1-gang →
        scheduler binds it."""
        sys = pk.make_system()
        pod = pk.Pod(metadata=pk.ObjectMeta(name="solo"),
                  template=pk.PodTemplate(resources=pk.Resource(500, 1 << 30)))
        sys.store.create(pod)
        pgs = sys.store.list("PodGroup")
        assert len(pgs) == 1 and pgs[0].spec.min_member == 1
        sys.schedule_once()
        pod = sys.store.get("Pod", "default", "solo")
        assert pod.status.phase == "Running"


class TestMinSuccess:
    @held
    def test_job_completes_at_min_success(self, pk):
        """jobp/min_success.go analogue: the job completes once minSuccess
        pods succeeded, even while others still run (running.go:61-65)."""
        sys = pk.make_system()
        job = pk.Job(
            metadata=pk.ObjectMeta(name="ms"),
            spec=pk.JobSpec(
                min_available=1,
                tasks=[pk.TaskSpec(name="w", replicas=4,
                                template=pk.PodTemplate(
                                    resources=pk.Resource(1000, 1 << 30)))]))
        job.spec.min_success = 2
        sys.store.create(job)
        sys.schedule_once()
        sys.schedule_once()
        pods = sys.store.list("Pod")
        assert len(pods) == 4
        for pod in pods[:2]:
            sys.store.finish_pod(pod.metadata.namespace, pod.metadata.name)
        sys._drain_controllers()
        job = sys.store.get("Job", "default", "ms")
        assert job.status.state == pk.JobPhase.COMPLETED

    @held
    def test_min_success_drains_stragglers(self, pk):
        """finished.go:30: a job completed early by minSuccess drains its
        still-running pods (Soft retain keeps the succeeded ones)."""
        sys = pk.make_system()
        job = pk.Job(
            metadata=pk.ObjectMeta(name="msd"),
            spec=pk.JobSpec(
                min_available=1,
                tasks=[pk.TaskSpec(name="w", replicas=3,
                                template=pk.PodTemplate(
                                    resources=pk.Resource(1000, 1 << 30)))]))
        job.spec.min_success = 1
        sys.store.create(job)
        sys.schedule_once()
        sys.schedule_once()
        pods = sys.store.list("Pod")
        assert len(pods) == 3
        sys.store.finish_pod(pods[0].metadata.namespace,
                             pods[0].metadata.name)
        sys._drain_controllers()
        job = sys.store.get("Job", "default", "msd")
        assert job.status.state == pk.JobPhase.COMPLETED
        remaining = sys.store.list("Pod")
        assert [p.status.phase for p in remaining] == ["Succeeded"]

    @held
    def test_min_success_floor_fails_job(self, pk):
        """All pods finished with fewer than minSuccess successes ->
        Failed (running.go:84-90)."""
        sys = pk.make_system()
        job = pk.Job(
            metadata=pk.ObjectMeta(name="msf"),
            spec=pk.JobSpec(
                min_available=1,
                tasks=[pk.TaskSpec(name="w", replicas=2,
                                template=pk.PodTemplate(
                                    resources=pk.Resource(1000, 1 << 30)))]))
        job.spec.min_success = 2
        sys.store.create(job)
        sys.schedule_once()
        sys.schedule_once()
        pods = sys.store.list("Pod")
        sys.store.finish_pod(pods[0].metadata.namespace,
                             pods[0].metadata.name, succeeded=True)
        sys.store.finish_pod(pods[1].metadata.namespace,
                             pods[1].metadata.name, succeeded=False)
        sys._drain_controllers()
        job = sys.store.get("Job", "default", "msf")
        assert job.status.state == pk.JobPhase.FAILED


class TestEventsAndScale:
    @held
    def test_scheduled_and_evict_events_recorded(self, pk):
        """EventRecorder analogue (cache.go:597-641): binds emit Scheduled,
        evictions emit Evict, unschedulable gangs emit FailedScheduling."""
        sys = pk.make_system()
        pk.submit_mpi_job(sys)
        sys.schedule_once()
        sys.schedule_once()
        evs = sys.store.events_for("Pod", "default", "mpi-job-worker-0")
        assert any(e["reason"] == "Scheduled" for e in evs)
        # unschedulable gang -> FailedScheduling on the podgroup
        pk.submit_mpi_job(sys, name="huge", replicas=500)
        sys.schedule_once()
        pg_events = sys.store.events_for("PodGroup", "default", "huge")
        assert any(e["reason"] == "FailedScheduling" for e in pg_events)

    @held
    def test_job_scale_up_down(self, pk):
        """jobp/job_scale_up_down.go analogue: editing replicas grows and
        shrinks the pod set through the spec-change sync."""
        sys = pk.make_system()
        pk.submit_mpi_job(sys, name="elastic", replicas=2, min_available=1)
        sys.schedule_once()
        assert len(sys.store.list("Pod")) == 2
        job = sys.store.get("Job", "default", "elastic")
        import copy
        newjob = copy.deepcopy(job)
        newjob.spec.tasks[0].replicas = 4
        sys.store.update(newjob)
        assert len(sys.store.list("Pod")) == 4
        newjob2 = copy.deepcopy(sys.store.get("Job", "default", "elastic"))
        newjob2.spec.tasks[0].replicas = 1
        sys.store.update(newjob2)
        assert len(sys.store.list("Pod")) == 1

    @held
    def test_bind_pod_group_forwards_cluster(self, pk):
        """Multi-cluster forwarding (cache.go:275-312): the silo-cluster
        annotation lands on every pod and the PodGroup."""
        sys = pk.make_system()
        pk.submit_mpi_job(sys, name="silo")
        sys.schedule_once()          # pods exist
        ssn_job = None
        ssn = pk.open_session(sys.cache, sys.scheduler.conf.tiers, [])
        ssn_job = ssn.jobs.get("default/silo")
        assert ssn_job is not None
        ssn.bind_pod_group(ssn_job, "silo-cluster-1")
        pk.close_session(ssn)
        pg = sys.store.get("PodGroup", "default", "silo")
        assert pg.metadata.annotations.get("volcano.sh/forward-cluster") \
            == "silo-cluster-1"
        for t in ssn_job.tasks.values():
            assert t.annotations.get("volcano.sh/forward-cluster") \
                == "silo-cluster-1"


class TestJobVolumes:
    """PVC lifecycle (createJobIOIfNotExist, job_controller_actions.go:442
    + the volume binder, cache.go:241-273)."""

    @held
    def test_pvc_autocreated_and_bound(self, pk):
        """A volume with a claim spec gets an owned PVC; it goes Bound when
        the pods bind."""
        sys = pk.make_system()
        job = pk.Job(
            metadata=pk.ObjectMeta(name="vj"),
            spec=pk.JobSpec(
                tasks=[pk.TaskSpec(name="w", replicas=2,
                                template=pk.PodTemplate(
                                    resources=pk.Resource(1000, 1 << 30)))],
                volumes=[{"mountPath": "/data",
                          "volumeClaim": {"storage": "10Gi"}}]))
        sys.store.create(job)
        pvcs = sys.store.list("PersistentVolumeClaim")
        assert len(pvcs) == 1
        assert pvcs[0].status.phase == "Pending"
        assert pvcs[0].metadata.owner_references[0]["name"] == "vj"
        job = sys.store.get("Job", "default", "vj")
        assert job.spec.volumes[0]["volumeClaimName"] == pvcs[0].metadata.name
        assert job.status.controlled_resources == {
            f"volume-pvc-{pvcs[0].metadata.name}": pvcs[0].metadata.name}

        sys.schedule_once()
        sys.schedule_once()
        pods = sys.store.list("Pod")
        assert pods and all(p.status.phase == "Running" for p in pods)
        # every pod mounts the claim; the claim is Bound
        assert all(any(v.get("claimName") == pvcs[0].metadata.name
                       for v in p.template.volumes) for p in pods)
        pvc = sys.store.list("PersistentVolumeClaim")[0]
        assert pvc.status.phase == "Bound"
        assert pvc.status.node

    @held
    def test_missing_referenced_pvc_blocks_job(self, pk):
        """A volume naming a PVC that doesn't exist keeps the job podless
        until the PVC appears (reference: job Pending with message)."""
        sys = pk.make_system()
        job = pk.Job(
            metadata=pk.ObjectMeta(name="needs-pvc"),
            spec=pk.JobSpec(
                tasks=[pk.TaskSpec(name="w", replicas=1,
                                template=pk.PodTemplate(
                                    resources=pk.Resource(1000, 1 << 30)))],
                volumes=[{"mountPath": "/data",
                          "volumeClaimName": "shared-data"}]))
        sys.store.create(job)
        sys.schedule_once()
        assert sys.store.list("Pod") == []
        job = sys.store.get("Job", "default", "needs-pvc")
        assert "shared-data" in job.status.state_message

        sys.store.create(pk.PVC(metadata=pk.ObjectMeta(name="shared-data")))
        sys.schedule_once()
        assert len(sys.store.list("Pod")) == 1

    @held
    def test_pvc_cascade_deleted_with_job(self, pk):
        """Owner-reference GC: deleting the job removes its PVCs."""
        sys = pk.make_system()
        job = pk.Job(
            metadata=pk.ObjectMeta(name="vjgc"),
            spec=pk.JobSpec(
                tasks=[pk.TaskSpec(name="w", replicas=1,
                                template=pk.PodTemplate(
                                    resources=pk.Resource(1000, 1 << 30)))],
                volumes=[{"mountPath": "/d",
                          "volumeClaim": {"storage": "1Gi"}}]))
        sys.store.create(job)
        assert len(sys.store.list("PersistentVolumeClaim")) == 1
        sys.store.delete("Job", "default", "vjgc")
        assert sys.store.list("PersistentVolumeClaim") == []
        assert sys.store.get("PodGroup", "default", "vjgc") is None


class TestQueueCLI:
    @held
    def test_queue_status_aggregation(self, pk):
        sys = pk.make_system()
        pk.submit_mpi_job(sys)
        sys.schedule_once()
        q = sys.store.get("Queue", "default", "default")
        assert q.status.running >= 0   # aggregated by queue controller
        lines = []
        pk.main(["queue", "list"], store=sys.store, out=lines.append)
        assert any("default" in line for line in lines)
        pk.main(["job", "list"], store=sys.store, out=lines.append)
        assert any("mpi-job" in line for line in lines)


class TestAdviceRegressions:
    """Regression tests for reference-semantics deviations found in review."""

    @held
    def test_task_without_status_entry_does_not_fail_job(self, pk):
        """running.go's `if taskStatus, ok := ...; ok` guard: the per-task
        minAvailable success check only applies to tasks that HAVE a
        TaskStatusCount entry; a task absent from the map (e.g. its pods
        drained during a scale-down) must not flip the verdict to Failed."""

        job = pk.Job(
            metadata=pk.ObjectMeta(name="shrink"),
            spec=pk.JobSpec(
                min_available=2,
                tasks=[
                    pk.TaskSpec(name="w", replicas=2, min_available=1,
                             template=pk.PodTemplate(
                                 resources=pk.Resource(1000, 1 << 30))),
                    pk.TaskSpec(name="opt", replicas=0, min_available=0,
                             template=pk.PodTemplate(
                                 resources=pk.Resource(1000, 1 << 30))),
                ]))
        job.status.state = pk.JobPhase.RUNNING
        job.status.succeeded = 2
        job.status.failed = 0
        # only "w" reported status; "opt" has no entry at all — and give it
        # a real minimum to prove absence (not min_available=0) is the guard
        job.spec.tasks[1].min_available = 1
        job.spec.min_available = 2
        job.status.task_status_count = {"w": {"Succeeded": 2}}

        phases = []
        orig = pk.job_state.sync_job

        def capture(j, next_phase):
            phases.append(next_phase(j.status))
        pk.job_state.sync_job = capture
        try:
            pk.job_state.RunningState(job).execute(pk.BusAction.SYNC_JOB)
        finally:
            pk.job_state.sync_job = orig
        assert phases == [pk.JobPhase.COMPLETED], phases

    @held
    def test_policy_event_and_exit_code_clauses_are_independent(self, pk):
        """applyPolicies (job_controller_util.go:168-200) + admission
        (validate/util.go:60-66): a policy carries EITHER an event clause
        OR an exitCode clause, never both — and each clause triggers
        independently of the other field."""
        sys = pk.make_system()
        # both-specified is rejected at admission, like the reference
        with pytest.raises(pk.AdmissionError,
                           match="event and exitCode simultaneously"):
            sys.store.create(pk.Job(
                metadata=pk.ObjectMeta(name="both"),
                spec=pk.JobSpec(tasks=[pk.TaskSpec(
                    name="w", replicas=1,
                    template=pk.PodTemplate(resources=pk.Resource(1000, 1)))],
                    policies=[pk.LifecyclePolicy(event=pk.BusEvent.POD_FAILED,
                                              action=pk.BusAction.RESTART_JOB,
                                              exit_code=137)])))
        # an empty policy is rejected too
        with pytest.raises(pk.AdmissionError,
                           match="either event and exitCode"):
            sys.store.create(pk.Job(
                metadata=pk.ObjectMeta(name="neither"),
                spec=pk.JobSpec(tasks=[pk.TaskSpec(
                    name="w", replicas=1,
                    template=pk.PodTemplate(resources=pk.Resource(1000, 1)))],
                    policies=[pk.LifecyclePolicy(
                        action=pk.BusAction.RESTART_JOB)])))
        # an event clause fires regardless of the pod's exit code
        job = pk.Job(
            metadata=pk.ObjectMeta(name="ev"),
            spec=pk.JobSpec(
                tasks=[pk.TaskSpec(name="w", replicas=2,
                                template=pk.PodTemplate(
                                    resources=pk.Resource(1000, 1 << 30)))],
                policies=[pk.LifecyclePolicy(event=pk.BusEvent.POD_FAILED,
                                          action=pk.BusAction.RESTART_JOB)]))
        sys.store.create(job)
        sys.schedule_once()
        sys.schedule_once()
        pods = sys.store.list("Pod")
        sys.store.finish_pod(pods[0].metadata.namespace,
                             pods[0].metadata.name, succeeded=False,
                             exit_code=42)
        job = sys.store.get("Job", "default", "ev")
        assert job.status.retry_count == 1
        assert job.status.state in (pk.JobPhase.RESTARTING,
                                    pk.JobPhase.PENDING)


class TestPriorityClassPropagation:
    @held
    def test_job_priority_class_update_reaches_podgroup(self, pk):
        """createOrUpdatePodGroup syncs priorityClassName on job updates
        (job_controller_actions.go:530-636) — without it a PriorityClass
        set after job creation never reaches the scheduler's job priority
        and preemption silently never fires."""
        sys = pk.make_system()
        sys.store.create(pk.PriorityClass(metadata=pk.ObjectMeta(name="crit"),
                                       value=77))
        pk.submit_mpi_job(sys, name="pj", replicas=1)
        sys.schedule_once()
        pg = sys.store.get("PodGroup", "default", "pj")
        assert pg is not None and pg.spec.priority_class_name == ""
        job = sys.store.get("Job", "default", "pj")
        job.spec.priority_class_name = "crit"
        sys.store.update(job)
        sys.schedule_once()
        pg = sys.store.get("PodGroup", "default", "pj")
        assert pg.spec.priority_class_name == "crit"
        assert sys.cache.jobs["default/pj"].priority == 77


class TestJobErrorHandlingMatrix:
    """The reference's failure-path scenario table
    (test/e2e/jobseq/job_error_handling.go): pod fail/evict/complete x
    RestartJob/AbortJob/TerminateJob/CompleteJob at both job and task
    level, plus the unschedulable->JobUnknown path."""

    def _run_job(self, pk, policies=None, task_policies=None, replicas=2,
                 name="ej"):
        sys = pk.make_system()
        job = pk.Job(
            metadata=pk.ObjectMeta(name=name),
            spec=pk.JobSpec(
                tasks=[pk.TaskSpec(name="worker", replicas=replicas,
                                template=pk.PodTemplate(
                                    resources=pk.Resource(1000, 1 << 30)),
                                policies=task_policies or [])],
                policies=policies or []))
        sys.store.create(job)
        sys.schedule_once()
        sys.schedule_once()
        pods = sys.store.list("Pod")
        assert pods and all(p.status.phase == "Running" for p in pods), \
            [p.status.phase for p in pods]
        return sys

    def _job(self, sys, name="ej"):
        return sys.store.get("Job", "default", name)

    # --- job-level: PodFailed x three actions ---------------------------

    @held
    def test_podfailed_restart_job(self, pk):
        sys = self._run_job(pk, [pk.LifecyclePolicy(
            event=pk.BusEvent.POD_FAILED, action=pk.BusAction.RESTART_JOB)])
        pod = sys.store.list("Pod")[0]
        sys.store.finish_pod("default", pod.metadata.name, succeeded=False)
        job = self._job(sys)
        assert job.status.retry_count == 1
        for _ in range(3):
            sys.schedule_once()
        job = self._job(sys)
        assert job.status.state == pk.JobPhase.RUNNING
        assert all(p.status.phase == "Running"
                   for p in sys.store.list("Pod"))

    @held
    def test_podfailed_terminate_job(self, pk):
        sys = self._run_job(pk, [pk.LifecyclePolicy(
            event=pk.BusEvent.POD_FAILED, action=pk.BusAction.TERMINATE_JOB)])
        pod = sys.store.list("Pod")[0]
        sys.store.finish_pod("default", pod.metadata.name, succeeded=False)
        sys.schedule_once()
        job = self._job(sys)
        assert job.status.state in (pk.JobPhase.TERMINATING,
                                    pk.JobPhase.TERMINATED)
        assert not any(p.status.phase == "Running"
                       for p in sys.store.list("Pod"))

    @held
    def test_podfailed_abort_job(self, pk):
        sys = self._run_job(pk, [pk.LifecyclePolicy(
            event=pk.BusEvent.POD_FAILED, action=pk.BusAction.ABORT_JOB)])
        pod = sys.store.list("Pod")[0]
        sys.store.finish_pod("default", pod.metadata.name, succeeded=False)
        sys.schedule_once()
        job = self._job(sys)
        assert job.status.state in (pk.JobPhase.ABORTING, pk.JobPhase.ABORTED)

    # --- job-level: PodEvicted x three actions --------------------------

    @held
    def test_podevicted_restart_job(self, pk):
        sys = self._run_job(pk, [pk.LifecyclePolicy(
            event=pk.BusEvent.POD_EVICTED, action=pk.BusAction.RESTART_JOB)])
        pod = sys.store.list("Pod")[0]
        sys.store.evict_pod("default", pod.metadata.name, "preempt")
        job = self._job(sys)
        assert job.status.retry_count == 1
        for _ in range(3):
            sys.schedule_once()
        assert self._job(sys).status.state == pk.JobPhase.RUNNING

    @held
    def test_podevicted_terminate_job(self, pk):
        sys = self._run_job(pk, [pk.LifecyclePolicy(
            event=pk.BusEvent.POD_EVICTED, action=pk.BusAction.TERMINATE_JOB)])
        pod = sys.store.list("Pod")[0]
        sys.store.evict_pod("default", pod.metadata.name, "preempt")
        sys.schedule_once()
        assert self._job(sys).status.state in (pk.JobPhase.TERMINATING,
                                               pk.JobPhase.TERMINATED)

    @held
    def test_podevicted_abort_job(self, pk):
        sys = self._run_job(pk, [pk.LifecyclePolicy(
            event=pk.BusEvent.POD_EVICTED, action=pk.BusAction.ABORT_JOB)])
        pod = sys.store.list("Pod")[0]
        sys.store.evict_pod("default", pod.metadata.name, "preempt")
        sys.schedule_once()
        assert self._job(sys).status.state in (pk.JobPhase.ABORTING,
                                               pk.JobPhase.ABORTED)

    # --- job-level: Any / TaskCompleted / exit codes --------------------

    @held
    def test_any_event_restart_job(self, pk):
        sys = self._run_job(pk, [pk.LifecyclePolicy(
            event=pk.BusEvent.ANY, action=pk.BusAction.RESTART_JOB)])
        pod = sys.store.list("Pod")[0]
        sys.store.evict_pod("default", pod.metadata.name, "node drained")
        assert self._job(sys).status.retry_count == 1

    @held
    def test_taskcompleted_complete_job(self, pk):
        sys = self._run_job(pk, [pk.LifecyclePolicy(
            event=pk.BusEvent.TASK_COMPLETED,
            action=pk.BusAction.COMPLETE_JOB)])
        for pod in list(sys.store.list("Pod")):
            sys.store.finish_pod("default", pod.metadata.name,
                                 succeeded=True)
        sys.schedule_once()
        assert self._job(sys).status.state in (pk.JobPhase.COMPLETING,
                                               pk.JobPhase.COMPLETED)

    @held
    def test_exit_code_restart_job(self, pk):
        sys = self._run_job(pk, [pk.LifecyclePolicy(exit_code=3,
                                             action=pk.BusAction.RESTART_JOB)])
        pods = sys.store.list("Pod")
        # exit code 1 does not match the policy -> no restart
        sys.store.finish_pod("default", pods[0].metadata.name,
                             succeeded=False, exit_code=1)
        assert self._job(sys).status.retry_count == 0
        # exit code 3 does
        sys.store.finish_pod("default", pods[1].metadata.name,
                             succeeded=False, exit_code=3)
        assert self._job(sys).status.retry_count == 1

    @held
    def test_event_list_either_fires(self, pk):
        """The reference's Events-list policy: either PodEvicted or
        PodFailed triggers TerminateJob (modeled as two policies)."""
        policies = [pk.LifecyclePolicy(event=pk.BusEvent.POD_EVICTED,
                                    action=pk.BusAction.TERMINATE_JOB),
                    pk.LifecyclePolicy(event=pk.BusEvent.POD_FAILED,
                                    action=pk.BusAction.TERMINATE_JOB)]
        sys = self._run_job(pk, policies)
        pod = sys.store.list("Pod")[0]
        sys.store.finish_pod("default", pod.metadata.name, succeeded=False)
        assert self._job(sys).status.state in (pk.JobPhase.TERMINATING,
                                               pk.JobPhase.TERMINATED)
        sys = self._run_job(pk, policies)
        pod = sys.store.list("Pod")[0]
        sys.store.evict_pod("default", pod.metadata.name, "preempt")
        assert self._job(sys).status.state in (pk.JobPhase.TERMINATING,
                                               pk.JobPhase.TERMINATED)

    # --- task-level policies --------------------------------------------

    @held
    def test_task_level_podfailed_restart(self, pk):
        sys = self._run_job(pk, task_policies=[pk.LifecyclePolicy(
            event=pk.BusEvent.POD_FAILED, action=pk.BusAction.RESTART_JOB)])
        pod = sys.store.list("Pod")[0]
        sys.store.finish_pod("default", pod.metadata.name, succeeded=False)
        assert self._job(sys).status.retry_count == 1

    @held
    def test_task_level_podevicted_terminate(self, pk):
        sys = self._run_job(pk, task_policies=[pk.LifecyclePolicy(
            event=pk.BusEvent.POD_EVICTED, action=pk.BusAction.TERMINATE_JOB)])
        pod = sys.store.list("Pod")[0]
        sys.store.evict_pod("default", pod.metadata.name, "preempt")
        assert self._job(sys).status.state in (pk.JobPhase.TERMINATING,
                                               pk.JobPhase.TERMINATED)

    @held
    def test_task_level_taskcompleted_complete(self, pk):
        sys = self._run_job(pk, task_policies=[pk.LifecyclePolicy(
            event=pk.BusEvent.TASK_COMPLETED,
            action=pk.BusAction.COMPLETE_JOB)])
        for pod in list(sys.store.list("Pod")):
            sys.store.finish_pod("default", pod.metadata.name,
                                 succeeded=True)
        sys.schedule_once()
        assert self._job(sys).status.state in (pk.JobPhase.COMPLETING,
                                               pk.JobPhase.COMPLETED)

    @held
    def test_task_policy_overrides_job_policy(self, pk):
        """job: PodFailed->AbortJob; task: PodFailed->RestartJob — the
        task-level policy wins (job_controller_util.go:170-200)."""
        sys = self._run_job(pk, 
            policies=[pk.LifecyclePolicy(event=pk.BusEvent.POD_FAILED,
                                      action=pk.BusAction.ABORT_JOB)],
            task_policies=[pk.LifecyclePolicy(event=pk.BusEvent.POD_FAILED,
                                           action=pk.BusAction.RESTART_JOB)])
        pod = sys.store.list("Pod")[0]
        sys.store.finish_pod("default", pod.metadata.name, succeeded=False)
        job = self._job(sys)
        assert job.status.retry_count == 1
        assert job.status.state not in (pk.JobPhase.ABORTING,
                                        pk.JobPhase.ABORTED)

    # --- unschedulable -> JobUnknown ------------------------------------

    @held
    def test_unschedulable_running_job_fires_job_unknown(self, pk):
        """A running gang whose evicted members cannot reschedule turns the
        PodGroup Unknown (session.go:176-214), which raises JobUnknown
        against the job's policies (job_controller_handler.go:405-433)."""
        sys = pk.make_system()
        job = pk.Job(
            metadata=pk.ObjectMeta(name="unsched"),
            spec=pk.JobSpec(
                min_available=2,
                tasks=[pk.TaskSpec(name="w", replicas=2,
                                template=pk.PodTemplate(
                                    resources=pk.Resource(6000, 8 << 30)))],
                policies=[pk.LifecyclePolicy(event=pk.BusEvent.JOB_UNKNOWN,
                                          action=pk.BusAction.RESTART_JOB)]))
        sys.store.create(job)
        for _ in range(3):
            sys.schedule_once()
        running = [p for p in sys.store.list("Pod")
                   if p.metadata.name.startswith("unsched")
                   and p.status.phase == "Running"]
        assert len(running) == 2, [p.status.phase
                                   for p in sys.store.list("Pod")]
        # cordon every node (the reference taints them), then evict one
        # member: the replacement cannot schedule while the other keeps
        # running -> gang split -> Unknown -> RestartJob
        for node in sys.cache.nodes.values():
            node.unschedulable = True
        sys.store.evict_pod("default", running[0].metadata.name, "drain")
        before = sys.store.get("Job", "default", "unsched").status.retry_count
        for _ in range(4):
            sys.schedule_once()
        job = sys.store.get("Job", "default", "unsched")
        assert job.status.retry_count > before, job.status.state


class TestElasticScale:
    """Elastic scale-up/down e2e (job_scale_up_down.go,
    job_controller_actions.go:179-195): sync_job's desired-vs-existing pod
    diff IS the elastic mechanism — growing replicas creates exactly the
    missing pods, shrinking deletes exactly the excess, and the PodGroup's
    minMember/minResources follow the spec through createOrUpdatePodGroup."""

    @held
    def test_scale_up_then_down(self, pk):
        sys = pk.make_system()
        pk.submit_mpi_job(sys, name="elastic", replicas=2)
        sys.schedule_once()
        sys.schedule_once()
        pods = sys.store.list("Pod")
        assert len(pods) == 2
        assert all(p.status.phase == "Running" for p in pods)

        # ---- scale UP 2 -> 5: only the three new pods are created (the
        # two running ones are untouched), the PodGroup quota follows
        before = {p.metadata.name for p in sys.store.list("Pod")}
        # real clients send a NEW object; mutating the store's live
        # reference would alias old==new and suppress the update event
        job = copy.deepcopy(sys.store.get("Job", "default", "elastic"))
        job.spec.tasks[0].replicas = 5
        job.spec.min_available = 5       # webhook default Σreplicas
        sys.store.update(job)
        sys.schedule_once()
        sys.schedule_once()
        pods = sys.store.list("Pod")
        assert len(pods) == 5
        assert before <= {p.metadata.name for p in pods}  # no churn of old
        assert all(p.status.phase == "Running" for p in pods)
        pg = sys.store.get("PodGroup", "default", "elastic")
        assert pg.spec.min_member == 5
        assert pg.spec.min_resources.cpu == 5000
        job = sys.store.get("Job", "default", "elastic")
        assert job.status.running == 5
        assert job.status.state == pk.JobPhase.RUNNING

        # ---- scale DOWN 5 -> 2: exactly the excess indices are deleted,
        # MinAvailable tracks the shrink (gang stays satisfied — the job
        # must NOT dip through Restarting/Unknown), quota shrinks
        job = copy.deepcopy(sys.store.get("Job", "default", "elastic"))
        job.spec.tasks[0].replicas = 2
        job.spec.min_available = 2
        sys.store.update(job)
        sys.schedule_once()
        sys.schedule_once()
        pods = sys.store.list("Pod")
        assert len(pods) == 2
        kept = {p.metadata.name for p in pods}
        assert kept == {"elastic-worker-0", "elastic-worker-1"}
        assert all(p.status.phase == "Running" for p in pods)
        pg = sys.store.get("PodGroup", "default", "elastic")
        assert pg.spec.min_member == 2
        assert pg.spec.min_resources.cpu == 2000
        job = sys.store.get("Job", "default", "elastic")
        assert job.status.running == 2
        assert job.status.state == pk.JobPhase.RUNNING

    @held
    def test_template_change_syncs_min_resources(self, pk):
        """A spec change that moves minResources but NOT minMember (a
        template resource bump at constant minAvailable) must still reach
        the PodGroup: createOrUpdatePodGroup compares minResources too
        (job_controller_actions.go:584-589) — the scheduler's enqueue
        quota math reads minResources, not the replica count. minResources
        itself covers only the first minAvailable tasks
        (calcPGMinResources, job_controller_actions.go:638-660), so a
        replica-only change at constant minAvailable correctly leaves it."""
        sys = pk.make_system()
        pk.submit_mpi_job(sys, name="fixedmin", replicas=2, min_available=2)
        sys.schedule_once()
        sys.schedule_once()
        # replica-only growth: minMember AND minResources stay
        job = copy.deepcopy(sys.store.get("Job", "default", "fixedmin"))
        job.spec.tasks[0].replicas = 4       # minAvailable stays 2
        sys.store.update(job)
        sys.schedule_once()
        sys.schedule_once()
        pg = sys.store.get("PodGroup", "default", "fixedmin")
        assert pg.spec.min_member == 2
        assert pg.spec.min_resources.cpu == 2000
        assert len(sys.store.list("Pod")) == 4
        # template bump: minResources follows while minMember stays
        job = copy.deepcopy(sys.store.get("Job", "default", "fixedmin"))
        job.spec.tasks[0].template.resources = pk.Resource(1500, 1 << 30)
        sys.store.update(job)
        sys.schedule_once()
        pg = sys.store.get("PodGroup", "default", "fixedmin")
        assert pg.spec.min_member == 2
        assert pg.spec.min_resources.cpu == 3000




# ---------------------------------------------------------------------------
# the system worlds against the JAX package's digests
# ---------------------------------------------------------------------------

# the CPU holds the small worlds; system-10k is the card's
SMALL_WORLDS = ("system-preempt", "system-lifecycle")


@pytest.fixture(scope="module")
def world_digests():
    return ref.load_digests()


def test_every_world_has_a_digest(world_digests):
    assert sorted(world_digests) == sorted(ref.WORLDS)
    full = world_digests["system-10k"]
    # the full-width world binds every gang in one B1 solve
    assert full["binds"] == full["pods"] == 10000
    assert full["pod_phases"] == {"Running": 6650, "Succeeded": 3350}
    assert full["port_cpu"] == {"solves": 1} and full["walks"] == 0
    assert world_digests["system-preempt"]["evicts"] > 0


@pytest.mark.parametrize("world", SMALL_WORLDS)
def test_system_world_matches_jax(world_digests, world):
    """Jobs, PodGroups, Pods, the store's events, the cache's bind and
    evict sequence, the node-tensor path and the preempt walks: the JAX
    package's; B1's plain version runs as often as the digests' CPU path
    says."""
    want = world_digests[world]
    out = ref.run_world("volcano_tpu_torch", world, "cpu")
    got = out["digest"]
    assert out["action_failures"] == [] == want["action_failures"]
    assert got == {k: v for k, v in want.items()
                   if k not in ("port_cpu", "action_failures")}
    assert {"solves": got["solves"]} == want["port_cpu"]


def test_preempt_world_evicts_through_the_walk():
    """system-preempt: the high-priority job runs on the full cluster by
    evicting low-priority pods through preempt's walk, and each eviction
    is a store event."""
    out = ref.run_world("volcano_tpu_torch", "system-preempt", "cpu")
    system = out["system"]
    high = [p for p in system.store.list("Pod")
            if p.metadata.name.startswith("high-")]
    assert len(high) == 4 and all(p.status.phase == "Running" for p in high)
    evicts = [e for e in system.store.events if e["reason"] == "Evict"]
    assert len(evicts) == out["digest"]["evicts"] > 0
    assert out["digest"]["walks"] > 0


# ---------------------------------------------------------------------------
# the front door: tests/test_overload.py's TestFrontDoorIntegration
# ---------------------------------------------------------------------------

class FrontDoor:
    def __init__(self, pk, objects, store, admission, backpressure):
        self.objects, self.store_mod = objects, store
        self.admission, self.bp = admission, backpressure
        self.pk = pk

    def store(self):
        o = self.objects
        store = self.store_mod.ObjectStore()
        self.admission.register_webhooks(store)
        store.create(o.QueueCR(metadata=o.ObjectMeta(name="default",
                                                     namespace="default"),
                               spec=o.QueueSpecCR(weight=1)))
        store.create(o.PriorityClass(
            metadata=o.ObjectMeta(name="gold", namespace="default"),
            value=10))
        return store

    def job(self, name, replicas=2, priority_class=""):
        o = self.objects
        return o.Job(metadata=o.ObjectMeta(name=name, namespace="default"),
                     spec=o.JobSpec(queue="default",
                                    priority_class_name=priority_class,
                                    tasks=[o.TaskSpec(
                                        name="main", replicas=replicas,
                                        template=o.PodTemplate())]))


FRONT_DOORS = (FrontDoor(JAX, jax_objects, jax_store, jax_admission,
                         jax_backpressure),
               FrontDoor(PORT, pt_objects, pt_store, pt_admission,
                         pt_backpressure))


def _shed_atomically(f):
    store = f.store()
    budget = f.bp.AdmissionBudget(max_queue_depth=10, shed_watermark=1.0)
    created = f.admission.submit_job_batch(
        store, [f.job(f"a{i}") for i in range(5)], budget=budget)
    out = [len(created), budget.pending_depth()]
    try:
        f.admission.submit_job_batch(store, [f.job("b0")], budget=budget)
    except f.bp.BackpressureError as e:
        out += [e.reason, e.retry_after_s > 0]
    return out + [len(store.list("Job"))]


def _priority_through_the_floor(f):
    store = f.store()
    budget = f.bp.AdmissionBudget(max_queue_depth=20, shed_watermark=0.5)
    f.admission.submit_job_batch(store, [f.job(f"base{i}") for i in range(7)],
                                 budget=budget)  # depth 14: past watermark
    out = []
    try:
        f.admission.submit_job_batch(store, [f.job("low")], budget=budget)
    except f.bp.BackpressureError as e:
        out.append(e.reason)
    created = f.admission.submit_job_batch(
        store, [f.job("vip", priority_class="gold")], budget=budget)
    return out + [len(created)]


def _no_priority_read_below_watermark(f):
    store = f.store()
    budget = f.bp.AdmissionBudget(max_queue_depth=100, shed_watermark=0.9)
    reads = {"n": 0}
    orig = store.list

    def counting(kind, namespace=None):
        if kind == "PriorityClass":
            reads["n"] += 1
        return orig(kind, namespace)

    store.list = counting
    f.admission.submit_job_batch(store, [f.job("cold")], budget=budget)
    return reads["n"]


def _no_budget_keeps_historical_behavior(f):
    store = f.store()
    return len(f.admission.submit_job_batch(
        store, [f.job(f"h{i}") for i in range(64)]))


@pytest.mark.parametrize("scenario,want", [
    (_shed_atomically, [5, 10, "queue_depth", True, 5]),
    (_priority_through_the_floor, ["priority_shed", 1]),
    (_no_priority_read_below_watermark, 0),
    (_no_budget_keeps_historical_behavior, 64),
], ids=["sheds-atomically-with-retry-hint", "priority-class-resolves",
        "no-priority-read-below-watermark", "no-budget-historical"])
def test_front_door_integration(scenario, want):
    """submit_job_batch charging the AdmissionBudget: a shed batch writes
    nothing and carries a retry hint; past the shed watermark only a
    high-priority batch lands; the PriorityClass read is lazy."""
    jax_out, port_out = (scenario(f) for f in FRONT_DOORS)
    assert port_out == jax_out == want


# ---------------------------------------------------------------------------
# vcctl's verbs, through both packages
# ---------------------------------------------------------------------------

VERBS = (
    ["queue", "list"], ["job", "list"], ["job", "view", "--name", "mpi-job"],
    ["queue", "get", "--name", "default"],
    ["cache", "dead-letter"], ["cache", "redrive-dead-letter"],
    ["leader", "status"], ["federation", "status"],
    ["federation", "rebalance-status"], ["federation", "elastic-status"],
    ["slo", "status"],
    ["job", "scale", "--name", "mpi-job", "--desired", "4"],
)


@pytest.mark.parametrize("argv", VERBS, ids=lambda a: " ".join(a[:2]))
def test_vcctl_verb_matches_jax(argv):
    def run(pk):
        # the process-local state the verbs read starts empty: other tests
        # in this process published into one package's and not the other's
        pk.metrics.reset_local()
        pk.obs.TIMELINE.clear()
        pk.created = []
        pk.objects._uid = itertools.count()
        system = pk.make_system()
        pk.submit_mpi_job(system)
        system.schedule_once()
        system.schedule_once()
        out = []
        rc = pk.main(argv, store=system.store, out=out.append,
                     cache=system.cache)
        return rc, out

    assert run(PORT) == run(JAX)


def test_vcctl_process_local_verbs():
    """version, device status (the fleet window, the mesh rung, a row a
    slot of the lattice) and trace why read this process's state
    (the audit ring's depth differs between the two packages' histories,
    so these are checked on the port alone)."""
    out = []
    assert pt_vcctl.main(["version"], out=out.append) == 0
    assert out == ["vcctl version 0.1.0"]
    out = []
    assert pt_vcctl.main(["device", "status"], out=out.append) == 0
    assert out[0].startswith("fleet\tavailable=")
    assert out[1].startswith("mesh\trung=")
    assert len(out) >= 3
    out = []
    assert pt_vcctl.main(["trace", "why", "--job", "default/nope"],
                         out=out.append) == 1
    assert out[0].startswith("no decision recorded for job 'default/nope'")


def test_job_commands_drive_the_lifecycle():
    """vcctl job run, suspend and resume through the port's system."""
    system = PORT.make_system()
    assert pt_vcctl.main(["job", "run", "--name", "cli", "--replicas", "2",
                          "--requests", "cpu=1,memory=1Gi"],
                         store=system.store, out=print) == 0
    system.schedule_once()
    system.schedule_once()
    assert [p.status.phase for p in system.store.list("Pod")] \
        == ["Running", "Running"]
    assert pt_vcctl.main(["job", "suspend", "--name", "cli"],
                         store=system.store, out=print) == 0
    assert system.store.list("Pod") == []
    assert pt_vcctl.main(["job", "resume", "--name", "cli"],
                         store=system.store, out=print) == 0
    system.schedule_once()
    assert len(system.store.list("Pod")) == 2


# ---------------------------------------------------------------------------
# the entry points: the device rule, the native store, the dispatcher
# ---------------------------------------------------------------------------

def test_system_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VolcanoSystem()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_cmd.scheduler_main([])


def test_system_passes_its_device_to_the_scheduler():
    system = VolcanoSystem(device="cpu")
    assert system.scheduler.device == torch.device("cpu")
    assert system.device == torch.device("cpu")


def test_native_store_backs_the_system():
    """native_store=True puts the API server's state in the C++ store; a
    store given wins."""
    from volcano_tpu_torch.native import NativeObjectStore
    assert isinstance(VolcanoSystem(device="cpu", native_store=True).store,
                      NativeObjectStore)
    given = pt_store.ObjectStore()
    assert VolcanoSystem(device="cpu", native_store=True,
                         store=given).store is given


@pytest.mark.parametrize("argv", [
    ["vc-unknown"], [],
], ids=["unknown-binary", "no-binary"])
def test_cmd_names_its_binaries(capsys, argv):
    """python -m volcano_tpu_torch.cmd takes a binary's name first."""
    assert pt_cmd.main(argv) == 2
    err = capsys.readouterr().err
    assert all(name in err for name in pt_cmd.BINARIES)


def test_quick_start_runs_on_the_cpu():
    """The README's quick start, through the port."""
    from volcano_tpu_torch.api import NodeInfo, Resource
    system = VolcanoSystem(device="cpu")
    alloc = Resource(8000, 32 << 30)
    alloc.max_task_num = 110
    system.cache.add_node(NodeInfo(name="n0", allocatable=alloc))
    system.jobs.run("job-1", replicas=2)
    assert system.schedule_once() == []
    assert system.schedule_once() == []
    assert sorted(p.status.phase for p in system.store.list("Pod")) \
        == ["Running", "Running"]
