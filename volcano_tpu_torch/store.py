"""ObjectStore: the in-process API-server/etcd substitute.

SURVEY.md §5.8: the reference's distributed communication backend IS the
Kubernetes API server — informer watch streams in, REST writes out. The
rebuild collapses that into one process: a thread-safe object store with
watch callbacks (the informer analogue), an admission-hook chain invoked on
create/update (the webhook-manager analogue), and bind/evict entry points
that emulate the kubelet side (pod starts running once bound; evicted pods
are deleted with a condition).

State lives only here — "the store is the checkpoint" (SURVEY.md §5.4):
every component rebuilds its caches from a relist, exactly like informers
resyncing after a restart.

Watch semantics (docs/robustness.md, store failure model): every write
stamps a cluster-monotonic resourceVersion and appends the event to a
bounded per-kind backlog — the etcd watch-cache analogue. A watcher may
register ``since_rv`` to RESUME a torn stream from where it left off;
when the backlog has already trimmed past that version the store raises
:class:`GoneError` (the HTTP 410 the informer contract answers with a
relist). ``list_with_rv`` returns a consistent (objects, rv) snapshot
under one lock window — the relist anchor. Registration is ATOMIC with
its replay: the handler observes every object exactly once (the replay
IS a synthetic ADD of current state, and live events at or below the
registration horizon are deduplicated per watcher), so a cache wired up
while a ``_notify`` is in flight can neither miss pre-registration state
nor double-apply it.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from .apis.objects import Command, Job, Pod, PodGroupCR, QueueCR

ADDED = "added"
UPDATED = "updated"
DELETED = "deleted"
# Bookmark events (the k8s WatchBookmark analogue) carry only a
# resourceVersion: an idle resumable watcher keeps its resume point fresh
# so a later resume stays within the backlog window. Delivered only to
# rv-aware watchers (legacy 3-arg handlers never see them).
BOOKMARK = "bookmark"

# Per-kind watch-event backlog depth: resumes reaching further back than
# this answer GoneError (relist). Generous relative to cycle volume — a
# stream torn for one cycle replays; one torn for a whole soak relists.
DEFAULT_WATCH_BACKLOG = 4096


class ConflictError(Exception):
    """Optimistic-concurrency failure: stored resourceVersion moved past
    the one the writer read (HTTP 409 analogue). Carries the observed and
    expected versions so a retry loop can re-read precisely."""

    def __init__(self, kind: str, key: str, observed: int, expected: int):
        super().__init__(
            f"{kind} {key}: conflict — observed resourceVersion "
            f"{observed} != expected {expected}")
        self.kind = kind
        self.key = key
        self.observed = observed
        self.expected = expected


class GoneError(Exception):
    """HTTP 410 Gone analogue: the requested resourceVersion has aged out
    of the watch backlog — the watcher must relist (list_with_rv) and
    re-watch from the fresh snapshot's version."""

    def __init__(self, kind: str, since_rv: int, oldest: int):
        super().__init__(
            f"{kind}: watch from resourceVersion {since_rv} is gone "
            f"(backlog starts after {oldest}); relist required")
        self.kind = kind
        self.since_rv = since_rv
        self.oldest = oldest


class AdmissionError(Exception):
    """Raised by admission hooks to reject a create/update."""


class _Watcher:
    """One registered watch stream: the handler, whether it takes the
    event resourceVersion, and the registration horizon — live events at
    or below the horizon were already covered by the registration (or
    resume) replay and are skipped, which is what makes registration
    during an in-flight ``_notify`` exactly-once."""

    __slots__ = ("handler", "with_rv", "horizon", "alive")

    def __init__(self, handler: Callable, with_rv: bool, horizon: int):
        self.handler = handler
        self.with_rv = with_rv
        self.horizon = horizon
        self.alive = True

    def deliver(self, event: str, obj, old, rv: int) -> None:
        if not self.alive or (rv and rv <= self.horizon):
            return
        if self.with_rv:
            self.handler(event, obj, old, rv)
        elif event != BOOKMARK:
            self.handler(event, obj, old)


JOB_NAME_ANNOTATION = "volcano.sh/job-name"


class _PodsByJob(dict):
    """The store's pods by key, with each job's pods (its namespace and the
    job-name annotation, as the pod was last written) in the same
    insertion order, so that one job's pods are listed without a scan of
    every pod. A pod that an update moves to another job takes its place
    in that job's group by the store's order."""

    def __init__(self):
        super().__init__()
        self.groups: Dict[tuple, Dict[str, object]] = {}
        self._group_of: Dict[str, tuple] = {}

    def __setitem__(self, key, pod) -> None:
        dict.__setitem__(self, key, pod)
        group = (pod.metadata.namespace,
                 pod.metadata.annotations.get(JOB_NAME_ANNOTATION))
        old = self._group_of.get(key)
        self._group_of[key] = group
        if old is not None and old != group:
            self._drop(old, key)
            self.groups[group] = {k: p for k, p in self.items()
                                  if self._group_of[k] == group}
        else:
            self.groups.setdefault(group, {})[key] = pod

    def pop(self, key, default=None):
        if key not in self:
            return default
        self._drop(self._group_of.pop(key), key)
        return dict.pop(self, key)

    def _drop(self, group: tuple, key: str) -> None:
        members = self.groups[group]
        del members[key]
        if not members:
            del self.groups[group]


class ObjectStore:
    KINDS = ("Pod", "Job", "PodGroup", "Queue", "Command", "PriorityClass",
             "PersistentVolumeClaim", "Lease", "ResourceQuota",
             "PartitionState")

    def __init__(self, watch_backlog: int = DEFAULT_WATCH_BACKLOG):
        self._lock = threading.RLock()
        self._objects: Dict[str, Dict[str, object]] = {k: {} for k in self.KINDS}
        self._objects["Pod"] = _PodsByJob()
        self._watchers: Dict[str, List[_Watcher]] = {k: [] for k in self.KINDS}
        self._admission_hooks: List[Callable] = []
        self._rv = 0
        self.watch_backlog = max(int(watch_backlog), 1)
        # per-kind event backlog: (rv, event, obj, old) in rv order, plus
        # the rv of the newest TRIMMED event (resume below it = Gone)
        self._backlog: Dict[str, "collections.deque"] = {
            k: collections.deque() for k in self.KINDS}
        self._trimmed_rv: Dict[str, int] = {k: 0 for k in self.KINDS}
        # k8s EventRecorder analogue (cache.go:597-641): bounded event log
        self.events: "collections.deque" = collections.deque(maxlen=2000)

    # -- events (EventRecorder analogue) ------------------------------------

    def record_event(self, kind: str, namespace: str, name: str,
                     etype: str, reason: str, message: str) -> None:
        self.events.append({
            "kind": kind, "namespace": namespace, "name": name,
            "type": etype, "reason": reason, "message": message,
            "time": time.time()})

    def events_for(self, kind: str, namespace: str, name: str) -> List[dict]:
        return [e for e in self.events
                if e["kind"] == kind and e["namespace"] == namespace
                and e["name"] == name]

    # -- admission (webhook-manager analogue) -------------------------------

    def register_admission_hook(self, hook: Callable) -> None:
        """hook(operation, kind, obj, old_obj) -> possibly-mutated obj;
        raises AdmissionError to deny."""
        self._admission_hooks.append(hook)

    def _admit(self, operation: str, kind: str, obj, old=None):
        for hook in self._admission_hooks:
            result = hook(operation, kind, obj, old)
            if result is not None:
                obj = result
        return obj

    # -- watch (informer analogue) ------------------------------------------

    def current_rv(self) -> int:
        with self._lock:
            return self._rv

    def watch(self, kind: str, handler: Callable,
              since_rv: Optional[int] = None,
              with_rv: bool = False) -> _Watcher:
        """Register a watch stream; returns the watcher token (pass to
        ``unwatch`` to cancel — the transport layer's stream handle).

        - ``since_rv=None`` (a fresh informer): existing objects replay
          as ADDED, atomically with registration — the handler observes
          every object exactly once even when a concurrent write's
          ``_notify`` is mid-flight (the registration horizon dedups the
          overlap).
        - ``since_rv=N`` (a resume after a torn stream): backlog events
          with rv > N replay in order; raises :class:`GoneError` when
          the backlog trimmed past N — the caller relists.
        - ``with_rv=True`` handlers are called ``(event, obj, old, rv)``
          and additionally receive BOOKMARK events.
        """
        with self._lock:
            if since_rv is not None and since_rv < self._trimmed_rv[kind]:
                raise GoneError(kind, since_rv, self._trimmed_rv[kind])
            w = _Watcher(handler, with_rv, horizon=self._rv)
            if since_rv is None:
                replay: List[Tuple[int, str, object, object]] = [
                    (0, ADDED, obj, None)
                    for obj in self._objects[kind].values()]
            else:
                replay = [e for e in self._backlog[kind] if e[0] > since_rv]
            self._watchers[kind].append(w)
            # replay UNDER the lock: no write can interleave between the
            # snapshot and the registration, so the stream the handler
            # sees is gapless and duplicate-free by construction
            for rv, event, obj, old in replay:
                if w.with_rv:
                    handler(event, obj, old,
                            rv or getattr(obj.metadata, "resource_version",
                                          0))
                else:
                    handler(event, obj, old)
        return w

    def unwatch(self, kind: str, watcher: _Watcher) -> None:
        with self._lock:
            watcher.alive = False
            if watcher in self._watchers[kind]:
                self._watchers[kind].remove(watcher)

    def emit_bookmarks(self) -> int:
        """Deliver a BOOKMARK carrying the current resourceVersion to
        every rv-aware watcher of every kind (the periodic
        WatchBookmark). Returns the bookmark rv."""
        with self._lock:
            rv = self._rv
            targets = [(k, list(ws)) for k, ws in self._watchers.items()]
        for _kind, watchers in targets:
            for w in watchers:
                if w.with_rv and w.alive:
                    w.handler(BOOKMARK, None, None, rv)
        return rv

    def _record_event(self, kind: str, event: str, obj, old,
                      rv: int) -> None:
        """Caller holds self._lock: append to the resume backlog in rv
        order and trim past the cap."""
        log = self._backlog[kind]
        log.append((rv, event, obj, old))
        while len(log) > self.watch_backlog:
            trimmed = log.popleft()
            self._trimmed_rv[kind] = max(self._trimmed_rv[kind], trimmed[0])

    def _notify(self, kind: str, event: str, obj, old=None,
                rv: int = 0) -> None:
        rv = rv or getattr(obj.metadata, "resource_version", 0)
        for watcher in list(self._watchers[kind]):
            watcher.deliver(event, obj, old, rv)

    # -- CRUD ---------------------------------------------------------------

    def create(self, obj) -> object:
        kind = obj.KIND
        obj = self._admit("CREATE", kind, obj)
        with self._lock:
            key = obj.metadata.key()
            if key in self._objects[kind]:
                raise ValueError(f"{kind} {key} already exists")
            self._rv += 1
            obj.metadata.resource_version = self._rv
            self._objects[kind][key] = obj
            self._record_event(kind, ADDED, obj, None, self._rv)
        self._notify(kind, ADDED, obj)
        return obj

    def create_batch(self, objs: Iterable, admit: bool = True) -> List:
        """Create a batch of objects through ONE store write: a single
        lock window covers the existence checks and inserts (an
        apiserver transaction analogue), and watchers are notified once
        per object only after the whole batch committed. All-or-nothing:
        any duplicate key aborts the batch before anything is inserted.
        resourceVersions are minted in batch order under the same lock,
        so the event stream stays rv-monotonic across the batch.

        ``admit=False`` skips the admission-hook chain — for callers
        that already validated the batch through the amortized batch
        validator (webhooks/admission.submit_job_batch), where a
        per-object hook walk would re-pay exactly the per-job store
        reads the batch path exists to avoid."""
        objs = list(objs)
        if admit:
            objs = [self._admit("CREATE", obj.KIND, obj) for obj in objs]
        with self._lock:
            seen = set()
            for obj in objs:
                key = (obj.KIND, obj.metadata.key())
                if key in seen or obj.metadata.key() \
                        in self._objects[obj.KIND]:
                    raise ValueError(
                        f"{obj.KIND} {obj.metadata.key()} already exists")
                seen.add(key)
            for obj in objs:
                self._rv += 1
                obj.metadata.resource_version = self._rv
                self._objects[obj.KIND][obj.metadata.key()] = obj
                self._record_event(obj.KIND, ADDED, obj, None, self._rv)
        for obj in objs:
            self._notify(obj.KIND, ADDED, obj)
        return objs

    def update(self, obj, expect_rv=None) -> object:
        """Update; with ``expect_rv`` set, an optimistic-concurrency write
        that fails with :class:`ConflictError` unless the stored object's
        resourceVersion still matches (the k8s resourcelock/Update CAS
        semantics clients rely on for leader election).

        Contract (identical to the native ``vs_put_cas``): ``None`` or a
        negative value = unconditional; ``0`` = create-only (conflict if
        the object exists); ``> 0`` = the object must exist with exactly
        this resourceVersion."""
        kind = obj.KIND
        with self._lock:
            key = obj.metadata.key()
            old = self._objects[kind].get(key)
        obj = self._admit("UPDATE", kind, obj, old)
        with self._lock:
            cur = self._objects[kind].get(key)
            if expect_rv is not None and expect_rv >= 0:
                cur_rv = (cur.metadata.resource_version
                          if cur is not None else 0)
                if cur_rv != expect_rv:
                    raise ConflictError(kind, key, cur_rv, expect_rv)
            old = cur
            self._rv += 1
            obj.metadata.resource_version = self._rv
            self._objects[kind][key] = obj
            event = UPDATED if old is not None else ADDED
            self._record_event(kind, event, obj, old, self._rv)
        # creating via the CAS create-only path is an ADD to watchers,
        # matching the native vs_put_cas EV_ADDED on absent keys
        self._notify(kind, event, obj, old)
        return obj

    def update_status(self, obj) -> object:
        """Status subresource: skips admission."""
        kind = obj.KIND
        with self._lock:
            key = obj.metadata.key()
            old = self._objects[kind].get(key)
            self._rv += 1
            obj.metadata.resource_version = self._rv
            self._objects[kind][key] = obj
            self._record_event(kind, UPDATED, obj, old, self._rv)
        self._notify(kind, UPDATED, obj, old)
        return obj

    def delete(self, kind: str, namespace: str, name: str) -> None:
        with self._lock:
            obj = self._objects[kind].pop(f"{namespace}/{name}", None)
            if obj is not None:
                # deletion consumes a resourceVersion too (the etcd
                # delete revision), so resumable watchers can order a
                # DELETED event against the writes around it
                self._rv += 1
                rv = self._rv
                self._record_event(kind, DELETED, obj, None, rv)
        if obj is not None:
            self._notify(kind, DELETED, obj, rv=rv)
            self._cascade_delete(kind, namespace, name)

    def _cascade_delete(self, kind: str, namespace: str, name: str) -> None:
        """Owner-reference garbage collection (the k8s GC analogue): when
        an owner goes away, its dependents follow — e.g. a deleted Job
        takes its PVCs and PodGroup."""
        for dep_kind in self.KINDS:
            with self._lock:
                victims = [
                    o.metadata.name for o in self._objects[dep_kind].values()
                    if o.metadata.namespace == namespace
                    and any(ref.get("kind") == kind
                            and ref.get("name") == name
                            for ref in o.metadata.owner_references)]
            for vname in victims:
                self.delete(dep_kind, namespace, vname)

    def get(self, kind: str, namespace: str, name: str):
        with self._lock:
            return self._objects[kind].get(f"{namespace}/{name}")

    def list(self, kind: str, namespace: Optional[str] = None,
             job: Optional[str] = None) -> List:
        """The kind's objects in the store's order, those of ``namespace``
        if given; with ``job`` (kind Pod, a namespace given), only the pods
        whose job-name annotation is ``job``."""
        with self._lock:
            if job is not None:
                assert kind == "Pod" and namespace is not None
                return list(self._objects["Pod"].groups.get(
                    (namespace, job), {}).values())
            objs = list(self._objects[kind].values())
        if namespace is None:
            return objs
        return [o for o in objs if o.metadata.namespace == namespace]

    def list_with_rv(self, kind: str,
                     namespace: Optional[str] = None) -> Tuple[List, int]:
        """Consistent LIST: the objects AND the resourceVersion they are
        consistent at, from one lock window — the relist anchor a watcher
        resumes from after a 410 (the informer ListAndWatch contract)."""
        with self._lock:
            objs = list(self._objects[kind].values())
            rv = self._rv
        if namespace is not None:
            objs = [o for o in objs if o.metadata.namespace == namespace]
        return objs, rv

    # -- kubelet emulation ---------------------------------------------------

    def bind_pod(self, namespace: str, name: str, node_name: str) -> None:
        """pods/<p>/binding analogue: place + start running. Binds are
        gated on the pod's PodGroup being schedulable — the in-process
        enforcement of the /pods admission webhook (admit_pod.go:139-155):
        a bare pod must not run while its gang is still Pending."""
        from .api import PodGroupPhase
        with self._lock:
            pod: Pod = self._objects["Pod"].get(f"{namespace}/{name}")
            if pod is None:
                raise KeyError(f"pod {namespace}/{name} not found")
            group = pod.metadata.annotations.get(
                "scheduling.k8s.io/group-name", "")
            if group:
                pg = self._objects["PodGroup"].get(f"{namespace}/{group}")
                if pg is not None and \
                        pg.status.phase == PodGroupPhase.PENDING:
                    raise AdmissionError(
                        f"cannot bind pod {namespace}/{name}: podgroup "
                        f"{group} phase is Pending")
            old = _shallow_status_copy(pod)
            pod.status.node_name = node_name
            pod.status.phase = "Running"
            self._rv += 1
            pod.metadata.resource_version = self._rv
            self._record_event("Pod", UPDATED, pod, old, self._rv)
        self.record_event("Pod", namespace, name, "Normal", "Scheduled",
                          f"Successfully assigned {namespace}/{name} "
                          f"to {node_name}")
        self._notify("Pod", UPDATED, pod, old)

    def evict_pod(self, namespace: str, name: str, reason: str) -> None:
        """Eviction analogue: condition + delete (cache.go:146-176)."""
        with self._lock:
            pod: Pod = self._objects["Pod"].get(f"{namespace}/{name}")
            if pod is None:
                return
            pod.status.conditions.append({"type": "Evicted", "reason": reason})
        self.record_event("Pod", namespace, name, "Warning", "Evict",
                          f"Pod is evicted, because of {reason}")
        self.delete("Pod", namespace, name)

    def finish_pod(self, namespace: str, name: str, succeeded: bool = True,
                   exit_code: Optional[int] = None) -> None:
        """Test/e2e helper: complete a running pod (kubelet analogue)."""
        with self._lock:
            pod: Pod = self._objects["Pod"].get(f"{namespace}/{name}")
            if pod is None:
                return
            old = _shallow_status_copy(pod)
            pod.status.phase = "Succeeded" if succeeded else "Failed"
            pod.status.exit_code = (exit_code if exit_code is not None
                                    else (0 if succeeded else 1))
            self._rv += 1
            pod.metadata.resource_version = self._rv
            self._record_event("Pod", UPDATED, pod, old, self._rv)
        self._notify("Pod", UPDATED, pod, old)


def _shallow_status_copy(pod: Pod) -> Pod:
    import copy
    clone = copy.copy(pod)
    clone.status = copy.deepcopy(pod.status)
    return clone
