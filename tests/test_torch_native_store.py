"""The C++ object store of volcano_tpu_torch (``native/store.cpp``, the
port's own copy, and ``native.NativeObjectStore``), held to the JAX
package's.

- tests/test_native_store.py's tests on the port's store: CRUD, watch,
  admission, kubelet emulation, concurrent writers, a whole system.
- The same script of writes gives the same watch stream on the port's
  native store, its Python store and the JAX package's Python store.
- The build: g++ at first use into ``ops/_build/`` under a name of each
  process's own, so processes building at once all succeed; a failed build
  raises, never falls back to the Python store.
- The second watch protocol (a consistent list, resume, GoneError,
  bookmarks), which store-fed caches need for their informers; nested
  writes delivered as the Python store delivers them; one DELETED event
  for an eviction; the owner cascade.
- The system worlds over the native store (tools/system_reference.py
  ``--native``) equal the JAX package's records over its Python store
  (tests/system_reference_digests.json), which the port's Python store
  equals too.
"""

import subprocess
import sys
import threading
from pathlib import Path

import pytest

import volcano_tpu.apis.objects as jax_objects
import volcano_tpu.store as jax_store
from volcano_tpu_torch import native
from volcano_tpu_torch.apis.objects import (Job, JobSpec, ObjectMeta, Pod,
                                            TaskSpec)
from volcano_tpu_torch.native import (NativeBuildError, NativeObjectStore,
                                      make_object_store)
from volcano_tpu_torch.store import (ADDED, DELETED, UPDATED, AdmissionError,
                                     ObjectStore)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import system_reference as ref  # noqa: E402


def make_pod(name, ns="default"):
    return Pod(metadata=ObjectMeta(name=name, namespace=ns))


def make_job(name, ns="default", objects=None):
    o = objects
    if o is None:
        return Job(metadata=ObjectMeta(name=name, namespace=ns),
                   spec=JobSpec(tasks=[TaskSpec(name="t", replicas=1)]))
    return o.Job(metadata=o.ObjectMeta(name=name, namespace=ns),
                 spec=o.JobSpec(tasks=[o.TaskSpec(name="t", replicas=1)]))


class TestCRUD:
    def test_create_get_list_delete(self):
        s = NativeObjectStore()
        s.create(make_pod("a"))
        s.create(make_pod("b", ns="other"))
        assert s.get("Pod", "default", "a").metadata.name == "a"
        assert len(s.list("Pod")) == 2
        assert [p.metadata.name for p in s.list("Pod", "other")] == ["b"]
        s.delete("Pod", "default", "a")
        assert s.get("Pod", "default", "a") is None
        assert len(s.list("Pod")) == 1

    def test_create_duplicate_raises(self):
        s = NativeObjectStore()
        s.create(make_pod("a"))
        with pytest.raises(ValueError):
            s.create(make_pod("a"))

    def test_resource_versions_monotonic(self):
        s = NativeObjectStore()
        p = s.create(make_pod("a"))
        rv1 = p.metadata.resource_version
        p.status.phase = "Running"
        s.update_status(p)
        rv2 = p.metadata.resource_version
        assert rv2 > rv1 > 0
        assert s.get("Pod", "default", "a").metadata.resource_version == rv2

    def test_objects_round_trip_as_copies(self):
        """Readers get copies, as from a real API server."""
        s = NativeObjectStore()
        s.create(make_pod("a"))
        got = s.get("Pod", "default", "a")
        got.status.phase = "Hacked"
        assert s.get("Pod", "default", "a").status.phase != "Hacked"

    def test_compare_and_swap_update(self):
        """update(expect_rv=...): the stored version must match, else
        ConflictError with the observed one (the Python store's
        contract)."""
        from volcano_tpu_torch.store import ConflictError
        s = NativeObjectStore()
        p = s.create(make_pod("a"))
        rv = p.metadata.resource_version
        p.status.phase = "Running"
        s.update(p, expect_rv=rv)
        with pytest.raises(ConflictError) as err:
            s.update(p, expect_rv=rv)
        assert err.value.observed == p.metadata.resource_version


class TestWatch:
    def test_watch_replays_existing_then_streams(self):
        s = NativeObjectStore()
        s.create(make_pod("pre"))
        events = []
        s.watch("Pod", lambda ev, obj, old:
                events.append((ev, obj.metadata.name)))
        assert events == [(ADDED, "pre")]
        s.create(make_pod("post"))
        p = s.get("Pod", "default", "post")
        p.status.phase = "Running"
        s.update_status(p)
        s.delete("Pod", "default", "pre")
        assert events == [(ADDED, "pre"), (ADDED, "post"),
                          (UPDATED, "post"), (DELETED, "pre")]

    def test_update_carries_old_object(self):
        s = NativeObjectStore()
        s.create(make_pod("a"))
        seen = []
        s.watch("Pod", lambda ev, obj, old: seen.append((ev, old)))
        p = s.get("Pod", "default", "a")
        p.status.phase = "Running"
        s.update_status(p)
        ev, old = seen[-1]
        assert ev == UPDATED and old is not None
        assert old.status.phase != "Running"

    @pytest.mark.parametrize("other", ["port-python", "jax-python"])
    def test_parity_with_python_store(self, other):
        """The same writes give the same watch stream (event, name, a
        Pod's phase, a live Job's resourceVersion) on the port's native
        store as on the port's and the JAX package's Python ObjectStore.
        (A deleted object's resourceVersion is the one its last writer
        saw, in the native stores of both packages.)"""
        def drive(store, objects):
            events = []
            store.watch("Job", lambda ev, obj, old: events.append(
                (ev, obj.metadata.name,
                 obj.metadata.resource_version if ev != DELETED else None)))
            store.watch("Pod", lambda ev, obj, old: events.append(
                (ev, obj.metadata.name, obj.status.phase)))
            j = store.create(make_job("j1", objects=objects))
            j.status.state = "Running"
            store.update_status(j)
            store.create(make_job("j2", objects=objects))
            store.create(objects.Pod(metadata=objects.ObjectMeta(
                name="p", namespace="default")))
            store.bind_pod("default", "p", "n0")
            store.finish_pod("default", "p")
            store.delete("Job", "default", "j1")
            return events

        import volcano_tpu_torch.apis.objects as pt_objects
        got = drive(NativeObjectStore(), pt_objects)
        want = (drive(ObjectStore(), pt_objects) if other == "port-python"
                else drive(jax_store.ObjectStore(), jax_objects))
        assert got == want


class TestAdmission:
    def test_mutating_and_validating_hooks(self):
        s = NativeObjectStore()

        def mutate(op, kind, obj, old):
            if op == "CREATE" and kind == "Pod":
                obj.metadata.labels["admitted"] = "true"
            return obj

        def validate(op, kind, obj, old):
            if kind == "Pod" and obj.metadata.name == "bad":
                raise AdmissionError("rejected")
            return None

        s.register_admission_hook(mutate)
        s.register_admission_hook(validate)
        p = s.create(make_pod("good"))
        assert p.metadata.labels["admitted"] == "true"
        with pytest.raises(AdmissionError):
            s.create(make_pod("bad"))
        assert s.get("Pod", "default", "bad") is None


class TestKubeletEmulation:
    def test_bind_and_finish(self):
        s = NativeObjectStore()
        s.create(make_pod("p"))
        s.bind_pod("default", "p", "node-1")
        pod = s.get("Pod", "default", "p")
        assert pod.status.phase == "Running"
        assert pod.status.node_name == "node-1"
        s.finish_pod("default", "p")
        assert s.get("Pod", "default", "p").status.phase == "Succeeded"

    def test_evict_deletes_with_condition(self):
        s = NativeObjectStore()
        s.create(make_pod("p"))
        deleted = []
        s.watch("Pod", lambda ev, obj, old:
                deleted.append(obj) if ev == DELETED else None)
        s.evict_pod("default", "p", "Preempted")
        assert s.get("Pod", "default", "p") is None
        assert deleted[0].status.conditions[-1]["reason"] == "Preempted"


class TestConcurrency:
    def test_parallel_writers_unique_rvs(self):
        s = NativeObjectStore()
        errs = []

        def writer(i):
            try:
                for k in range(50):
                    s.create(make_pod(f"p-{i}-{k}"))
            except Exception as e:                      # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=writer, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        pods = s.list("Pod")
        assert len(pods) == 400
        assert len({p.metadata.resource_version for p in pods}) == 400


class TestFullSystemOverNativeStore:
    def test_job_runs_end_to_end(self):
        """The control plane (webhooks, controllers, the scheduler on the
        CPU, vcctl) with its API server's state in the C++ store."""
        import time
        from volcano_tpu_torch.api import NodeInfo, Resource
        from volcano_tpu_torch.cli.vcctl import main
        from volcano_tpu_torch.system import VolcanoSystem

        sys_ = VolcanoSystem(schedule_period=0.05, native_store=True,
                             device="cpu")
        assert isinstance(sys_.store, NativeObjectStore)
        alloc = Resource(8000, 16 << 30)
        alloc.max_task_num = 110
        sys_.cache.add_node(NodeInfo(name="n0", allocatable=alloc))
        main(["job", "run", "--name", "train", "--replicas", "2"],
             store=sys_.store)
        th = sys_.start()
        try:
            deadline = time.time() + 15
            while time.time() < deadline:
                pods = sys_.store.list("Pod")
                if pods and all(p.status.phase == "Running" for p in pods):
                    break
                time.sleep(0.05)
        finally:
            sys_.stop()
            th.join()
        pods = sys_.store.list("Pod")
        assert len(pods) == 2
        assert all(p.status.phase == "Running" for p in pods)


# -- the build ----------------------------------------------------------------

def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that does not start, or a source that does not compile,
    raises NativeBuildError with the compiler's message."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    with pytest.raises(NativeBuildError, match="did not start"):
        native.build_library(cxx=str(tmp_path / "no-such-g++"))
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    with pytest.raises(NativeBuildError, match="failed"):
        native.build_library(src=broken)
    assert not list(tmp_path.glob("*.tmp"))


def test_no_fallback_to_the_python_store(monkeypatch):
    """make_object_store(prefer_native=True) and VolcanoSystem(
    native_store=True) raise when the library does not build: the JAX
    package's factory quietly returns its Python store there."""
    from volcano_tpu_torch.system import VolcanoSystem

    def fail():
        raise NativeBuildError("native store: g++ failed (exit 1)")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build_library", lambda *a, **k: fail())
    assert native.available() is False
    with pytest.raises(NativeBuildError, match="g..? failed"):
        make_object_store(prefer_native=True)
    with pytest.raises(NativeBuildError):
        VolcanoSystem(native_store=True, device="cpu")
    assert isinstance(make_object_store(), ObjectStore)


def test_builds_at_once_in_several_processes(tmp_path):
    """Four processes build the library at once into one empty directory:
    each writes a temporary file of its own and moves it into place, so
    every one loads a whole library (the JAX package's shared temporary
    name makes such racers read a truncated file)."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from volcano_tpu_torch import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "store = native.NativeObjectStore()\n"
        "from volcano_tpu_torch.apis.objects import ObjectMeta, Pod\n"
        "store.create(Pod(metadata=ObjectMeta(name='p')))\n"
        "assert len(store.list('Pod')) == 1\n"
        "print('ok')\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [o[1] for o in outs]
    assert all(o[0].strip() == "ok" for o in outs)
    assert [p.name for p in tmp_path.iterdir()] == [
        native.library_path().name]


# -- the watch protocol of the informers -------------------------------------------

def _nested_script(store, objects):
    """Two watchers of Pods; the first answers p's binding by creating q,
    inside the delivery. Returns what each watcher saw, in order."""
    seen = {"first": [], "second": []}

    def first(ev, obj, old, rv):
        seen["first"].append((ev, obj.metadata.name, obj.status.phase, rv))
        if obj.metadata.name == "p" and obj.status.phase == "Running" \
                and store.get("Pod", "default", "q") is None:
            store.create(objects.Pod(metadata=objects.ObjectMeta(
                name="q", namespace="default")))

    store.watch("Pod", first, with_rv=True)
    store.watch("Pod", lambda ev, obj, old, rv: seen["second"].append(
        (ev, obj.metadata.name, obj.status.phase, rv)), with_rv=True)
    store.create(objects.Pod(metadata=objects.ObjectMeta(
        name="p", namespace="default")))
    store.bind_pod("default", "p", "n0")
    store.finish_pod("default", "p")
    return seen


def test_nested_write_delivered_as_by_the_python_store():
    """A write that a handler makes inside a delivery reaches every
    watcher at once, before the rest of the outer delivery, and exactly
    once (as the Python store delivers it). The outer event that a later
    watcher then gets carries its own, older resourceVersion, which the
    cache's informer drops as stale."""
    import volcano_tpu_torch.apis.objects as pt_objects
    got = _nested_script(NativeObjectStore(), pt_objects)
    want = _nested_script(ObjectStore(), pt_objects)
    assert [e[:2] + e[3:] for e in got["second"]] == \
        [e[:2] + e[3:] for e in want["second"]]
    assert [e[:2] for e in got["first"]] == [e[:2] for e in want["first"]]
    rvs = [e[3] for e in got["second"]]
    assert len(rvs) == len(set(rvs)) == 4
    assert rvs != sorted(rvs)       # q's ADDED came before p's binding


def test_list_with_rv_resume_and_bookmarks():
    """The second watch protocol: a consistent list and its version, a
    resume from a version that replays the events after it, BOOKMARKs to
    rv-aware watchers, unwatch."""
    s = NativeObjectStore()
    s.create(make_pod("a"))
    objs, rv = s.list_with_rv("Pod")
    assert [o.metadata.name for o in objs] == ["a"] and rv == s.current_rv()
    s.create(make_pod("b"))
    s.delete("Pod", "default", "a")
    s.create(make_job("j"))
    seen = []
    w = s.watch("Pod", lambda ev, obj, old, v: seen.append(
        (ev, obj.metadata.name if obj is not None else None, v)),
        since_rv=rv, with_rv=True)
    assert seen == [(ADDED, "b", rv + 1), (DELETED, "a", rv + 2)]
    assert s.emit_bookmarks() == s.current_rv()
    assert seen[-1] == ("bookmark", None, s.current_rv())
    s.unwatch("Pod", w)
    s.create(make_pod("c"))
    assert seen[-1][0] == "bookmark"


def test_resume_past_the_log_is_gone():
    """A resume from below what the native log still holds raises
    GoneError, the informer's cue to relist."""
    from volcano_tpu_torch.store import GoneError
    s = NativeObjectStore(log_capacity=4)
    for i in range(8):
        s.create(make_pod(f"p{i}"))
    with pytest.raises(GoneError):
        s.watch("Pod", lambda *a: None, since_rv=1, with_rv=True)
    s.watch("Pod", lambda *a: None, since_rv=s.current_rv() - 2,
            with_rv=True)


def test_store_fed_cache_takes_the_informers():
    """A cache fed by the native store subscribes through the resumable
    informers, as over the Python store, and a torn stream resumes."""
    from volcano_tpu_torch.system import VolcanoSystem
    system = VolcanoSystem(native_store=True, device="cpu")
    manager = system.cache.watch_manager
    assert manager is not None
    pod_watch = next(w for w in manager.watches if w.kind == "Pod")
    pod_watch.tear()
    system.store.create(make_pod("late"))
    assert manager.step() == 1
    assert "default/late" in pod_watch.known


def test_eviction_is_one_deleted_event():
    """evict_pod gives watchers one DELETED event whose pod carries the
    Evicted condition, as the Python store does, not an update first."""
    for store in (NativeObjectStore(), ObjectStore()):
        store.create(make_pod("p"))
        events = []
        store.watch("Pod", lambda ev, obj, old: events.append(
            (ev, [c["type"] for c in obj.status.conditions])))
        store.evict_pod("default", "p", "preempt")
        assert events[1:] == [(DELETED, ["Evicted"])]


def test_delete_cascades_to_dependents():
    """Deleting an owner deletes its dependents, as the Python store's
    owner-reference collection does."""
    s = NativeObjectStore()
    s.create(make_job("j"))
    pod = make_pod("j-pod")
    pod.metadata.owner_references = [{"kind": "Job", "name": "j"}]
    s.create(pod)
    s.delete("Job", "default", "j")
    assert s.list("Pod") == []


# -- the system worlds over the native store ---------------------------------------

@pytest.mark.parametrize("world", ["system-preempt", "system-lifecycle"])
def test_native_system_world_matches_the_digests(world):
    """The world over the port's native store equals the JAX package's
    record over its Python store (tests/system_reference_digests.json:
    Jobs, PodGroups, Pods, store events, the bind and evict sequence, the
    node-tensor path)."""
    out = ref.run_world("volcano_tpu_torch", world, "cpu", native=True)
    assert isinstance(out["system"].store, NativeObjectStore)
    want = ref.load_digests()[world]
    assert out["action_failures"] == [] == want["action_failures"]
    assert out["digest"] == {k: v for k, v in want.items()
                             if k not in ("port_cpu", "action_failures")}


def test_restart_is_counted_over_either_store():
    """A job restarted by its policy keeps retry_count 1 over the native
    store as over the Python one: the count is written in the restart's
    own status write, not set on the controller's copy after it."""
    counts = []
    for native_store in (True, False):
        out = ref.run_world("volcano_tpu_torch", "system-lifecycle", "cpu",
                            native=native_store)
        job = out["system"].store.get("Job", "default", "fail-restart")
        counts.append(job.status.retry_count)
    assert counts == [1, 1]
