"""The native (C++) object store, bound with ctypes: the JAX package's
``native/``.

``store.cpp`` is a resource-versioned object store with a watch-event log
(the API server's etcd state and watch streams); :class:`NativeObjectStore`
wraps it with the API of ``volcano_tpu_torch.store.ObjectStore``
(admission hooks, watch replay, kubelet emulation).

g++ builds the library at first use into ``ops/_build/`` (kept out of the
repository), named by the source's SHA-256, under a temporary name of the
building process's own that ``os.replace`` then moves into place: processes
building at once (test workers) never read one another's half-written file.
There is no fallback: a build or load that fails raises
:class:`NativeBuildError` with the compiler's message, from the store's
constructor and from ``make_object_store(prefer_native=True)`` alike.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import pickle
import struct
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from ..store import (ADDED, BOOKMARK, DELETED, UPDATED, AdmissionError,
                     ConflictError, GoneError, _Watcher)

SRC = Path(__file__).parent / "store.cpp"
BUILD_DIR = Path(__file__).parent.parent / "ops" / "_build"
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


class NativeBuildError(RuntimeError):
    """The C++ store did not build or load."""


_lib = None
_lib_lock = threading.Lock()


def library_path(src: Path = SRC) -> Path:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()
    return BUILD_DIR / f"store-{digest[:12]}.so"


def build_library(src: Path = SRC, cxx: str = CXX) -> Path:
    """The built library's path, compiling it first when no build of this
    source exists. Raises NativeBuildError naming the compiler's error."""
    lib = library_path(src)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(src), "-o", str(tmp)],
                              capture_output=True, text=True)
    except OSError as exc:
        raise NativeBuildError(f"native store: {cxx} did not start: "
                               f"{exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"native store: {cxx} failed "
                               f"(exit {proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def _bind(path: Path) -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as exc:
        raise NativeBuildError(f"native store: {path} did not load: "
                               f"{exc}") from exc
    c_void_p, c_char_p = ctypes.c_void_p, ctypes.c_char_p
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    for name, restype, argtypes in (
            ("vs_new", c_void_p, [i64]),
            ("vs_free", None, [c_void_p]),
            ("vs_rv", i64, [c_void_p]),
            ("vs_trimmed_rv", i64, [c_void_p]),
            ("vs_put", i64, [c_void_p, c_char_p, c_char_p, c_char_p, i64,
                             i32]),
            ("vs_put_cas", i64, [c_void_p, c_char_p, c_char_p, c_char_p,
                                 i64, i64]),
            ("vs_get", i64, [c_void_p, c_char_p, c_char_p, c_char_p, i64]),
            ("vs_get_rv", i64, [c_void_p, c_char_p, c_char_p]),
            ("vs_delete", i64, [c_void_p, c_char_p, c_char_p, c_char_p,
                                i64]),
            ("vs_count", i64, [c_void_p, c_char_p]),
            ("vs_list_keys", i64, [c_void_p, c_char_p, c_char_p, i64]),
            ("vs_events_since", i64, [c_void_p, i64, c_char_p, i64])):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def load() -> ctypes.CDLL:
    """The bound library, built at the first call of the process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _bind(build_library())
        return _lib


def available() -> bool:
    """True when the C++ store builds and loads here."""
    try:
        load()
    except NativeBuildError:
        return False
    return True


# ---------------------------------------------------------------------------
# NativeObjectStore: the ObjectStore API over the C++ core
# ---------------------------------------------------------------------------

_EV_NAMES = {0: ADDED, 1: UPDATED, 2: DELETED}


def _serialized(method):
    """Run a writing method under the store's dispatch lock: a write and
    the delivery of its events are one step to every other thread, so a
    list and its resourceVersion (``list_with_rv``, a watch's replay) never
    straddle a write."""
    @functools.wraps(method)
    def locked(self, *args, **kwargs):
        with self._dispatch_lock:
            return method(self, *args, **kwargs)
    return locked


class NativeObjectStore:
    """``volcano_tpu_torch.store.ObjectStore``'s API with its state in the
    C++ store: every object round-trips through pickle into the native
    key-value core, and watchers are notified by draining the native event
    log, so ordering, resourceVersions and replay are the C++ side's.
    Readers get copies, as from a real API server, where the Python store
    hands out its own objects.

    It speaks both watch protocols of the Python store, so a store-fed
    cache over it subscribes through the resumable informers
    (``cache/watches.py``), which drop a stale event; the JAX package's
    speaks only the first, and its system decides otherwise over it than
    over its Python store (ROADMAP §3). A write made inside a handler is
    delivered to every watcher at once and exactly once, as the Python
    store delivers it.

    Raises NativeBuildError when the library does not build or load."""

    KINDS = ("Pod", "Job", "PodGroup", "Queue", "Command", "PriorityClass",
             "PersistentVolumeClaim", "Lease", "ResourceQuota",
             "PartitionState")

    # sized reads retry when a concurrent writer outgrows the buffer
    # between the sizing call and the copy; bounded, so a writer looping
    # on one key cannot spin a reader forever
    _SIZED_READ_RETRIES = 64

    def __init__(self, log_capacity: int = 65536):
        self._lib = load()
        self._h = self._lib.vs_new(log_capacity)
        self._watchers: Dict[str, List[_Watcher]] = {k: [] for k in
                                                     self.KINDS}
        self._admission_hooks: List[Callable] = []
        # serializes event delivery; _dispatched is the last rv whose
        # watchers were notified
        self._dispatch_lock = threading.RLock()
        self._dispatched = 0
        # the EventRecorder analogue stays in Python: events are telemetry,
        # not replayed state
        self.events: "collections.deque" = collections.deque(maxlen=2000)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h is not None:
            self._lib.vs_free(h)

    def record_event(self, kind: str, namespace: str, name: str,
                     etype: str, reason: str, message: str) -> None:
        with self._dispatch_lock:
            self.events.append({
                "kind": kind, "namespace": namespace, "name": name,
                "type": etype, "reason": reason, "message": message,
                "time": time.time()})

    def events_for(self, kind: str, namespace: str, name: str) -> List[dict]:
        return [e for e in self.events
                if e["kind"] == kind and e["namespace"] == namespace
                and e["name"] == name]

    # -- admission (the webhook manager) ------------------------------------

    def register_admission_hook(self, hook: Callable) -> None:
        with self._dispatch_lock:
            self._admission_hooks.append(hook)

    def _admit(self, operation: str, kind: str, obj, old=None):
        for hook in self._admission_hooks:
            result = hook(operation, kind, obj, old)
            if result is not None:
                obj = result
        return obj

    # -- the native calls ---------------------------------------------------

    def _read(self, kind: str, key: str):
        # vs_get returns the current length on every call: a copy whose
        # length fits the buffer is complete (a shorter replacement copies
        # whole); only a value that grew between the calls is read again
        k, kk = kind.encode(), key.encode()
        n = self._lib.vs_get(self._h, k, kk, None, 0)
        for _ in range(self._SIZED_READ_RETRIES):
            if n < 0:
                return None
            buf = ctypes.create_string_buffer(int(n) if n > 0 else 1)
            n2 = self._lib.vs_get(self._h, k, kk, buf, n)
            if n2 < 0:
                return None
            if 0 < n2 <= n:
                obj = pickle.loads(buf.raw[:n2])
                # the native side owns resourceVersions
                obj.metadata.resource_version = self._lib.vs_get_rv(
                    self._h, k, kk)
                return obj
            n = n2
        raise RuntimeError(
            f"vs_get({kind}/{key}): value replaced with a longer one on "
            f"{self._SIZED_READ_RETRIES} consecutive sized reads")

    def _write(self, kind: str, obj, create_only: bool) -> int:
        key = obj.metadata.key()
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        rv = self._lib.vs_put(self._h, kind.encode(), key.encode(), data,
                              len(data), 1 if create_only else 0)
        if rv < 0:
            raise ValueError(f"{kind} {key} already exists")
        obj.metadata.resource_version = rv
        return rv

    def _event_batch(self, since: int) -> list:
        """The native log's events after ``since`` that one buffer holds,
        as (rv, kind, event, obj, old): ``obj`` the object a watcher gets
        (a DELETED event's is the deleted object), ``old`` the previous
        object of an update."""
        n = self._lib.vs_events_since(self._h, since, None, 0)
        if n <= 4:
            return []
        buf = ctypes.create_string_buffer(int(n))
        m = self._lib.vs_events_since(self._h, since, buf, n)
        raw = buf.raw[:m]
        (count,) = struct.unpack_from("<I", raw, 0)
        out, off = [], 4
        for _ in range(count):
            (rv,) = struct.unpack_from("<q", raw, off)
            off += 8
            (etype,) = struct.unpack_from("<i", raw, off)
            off += 4
            blobs = []
            for _b in range(4):
                (ln,) = struct.unpack_from("<I", raw, off)
                off += 4
                blobs.append(raw[off:off + ln])
                off += ln
            obj = pickle.loads(blobs[2]) if blobs[2] else None
            old = pickle.loads(blobs[3]) if blobs[3] else None
            if obj is not None:
                obj.metadata.resource_version = rv
            event = _EV_NAMES[etype]
            if event == DELETED:
                obj, old = old, None
            out.append((rv, blobs[0].decode(), event, obj, old))
        return out

    def _drain_events(self) -> None:
        """Deliver the undispatched native events to the watchers in rv
        order; loops, since a batch is bounded by its buffer."""
        with self._dispatch_lock:
            while True:
                batch = self._event_batch(self._dispatched)
                if not batch:
                    return
                for rv, kind, event, obj, old in batch:
                    if rv <= self._dispatched:
                        continue          # a nested drain delivered it
                    self._dispatched = rv
                    for w in list(self._watchers.get(kind, ())):
                        w.deliver(event, obj, old, rv)

    # -- watch (the informer) -----------------------------------------------

    def current_rv(self) -> int:
        return self._lib.vs_rv(self._h)

    def watch(self, kind: str, handler: Callable,
              since_rv: Optional[int] = None,
              with_rv: bool = False) -> _Watcher:
        """Register a watch stream, as ``ObjectStore.watch`` does; returns
        the watcher token for ``unwatch``. ``since_rv=None``: every
        existing object replays as ADDED, then live events follow.
        ``since_rv=N``: the native log's events of ``kind`` after N replay
        in order; GoneError when the log dropped events after N.
        ``with_rv=True`` handlers take ``(event, obj, old, rv)`` and also
        get BOOKMARK events."""
        with self._dispatch_lock:
            self._drain_events()
            if since_rv is not None:
                trimmed = self._lib.vs_trimmed_rv(self._h)
                if since_rv < trimmed:
                    raise GoneError(kind, since_rv, trimmed)
            horizon = self._dispatched
            w = _Watcher(handler, with_rv, horizon=horizon)
            if since_rv is None:
                replay = [(0, ADDED, obj, None)
                          for obj in self._list(kind)]
            else:
                replay = [(rv, event, obj, old) for rv, k, event, obj, old
                          in self._events_after(since_rv)
                          if k == kind and rv <= horizon]
            self._watchers[kind].append(w)
            for rv, event, obj, old in replay:
                if with_rv:
                    handler(event, obj, old,
                            rv or obj.metadata.resource_version)
                else:
                    handler(event, obj, old)
        return w

    def unwatch(self, kind: str, watcher: _Watcher) -> None:
        with self._dispatch_lock:
            watcher.alive = False
            if watcher in self._watchers[kind]:
                self._watchers[kind].remove(watcher)

    def emit_bookmarks(self) -> int:
        """A BOOKMARK with the dispatched resourceVersion to every
        rv-aware watcher. Returns that rv."""
        with self._dispatch_lock:
            self._drain_events()
            rv = self._dispatched
            for watchers in list(self._watchers.values()):
                for w in list(watchers):
                    if w.with_rv and w.alive:
                        w.handler(BOOKMARK, None, None, rv)
        return rv

    def _events_after(self, since: int) -> list:
        out = []
        while True:
            batch = self._event_batch(since)
            if not batch:
                return out
            out.extend(batch)
            since = batch[-1][0]

    # -- CRUD ---------------------------------------------------------------

    @_serialized
    def create(self, obj):
        kind = obj.KIND
        obj = self._admit("CREATE", kind, obj)
        self._write(kind, obj, create_only=True)
        self._drain_events()
        return obj

    @_serialized
    def update(self, obj, expect_rv=None):
        """Update; with ``expect_rv``, the compare-and-swap write
        (``vs_put_cas``): a negative value is unconditional, 0 create-only,
        a positive value the stored resourceVersion it must match, else
        ConflictError with the observed version."""
        kind = obj.KIND
        old = self._read(kind, obj.metadata.key())
        obj = self._admit("UPDATE", kind, obj, old)
        if expect_rv is None:
            self._write(kind, obj, create_only=False)
        else:
            key = obj.metadata.key()
            data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
            rv = self._lib.vs_put_cas(self._h, kind.encode(), key.encode(),
                                      data, len(data), int(expect_rv))
            if rv == -2:
                cur = self._read(kind, key)
                observed = (cur.metadata.resource_version
                            if cur is not None else 0)
                raise ConflictError(kind, key, observed, int(expect_rv))
            obj.metadata.resource_version = rv
        self._drain_events()
        return obj

    @_serialized
    def update_status(self, obj):
        self._write(obj.KIND, obj, create_only=False)
        self._drain_events()
        return obj

    @_serialized
    def delete(self, kind: str, namespace: str, name: str,
               last=None) -> None:
        """Delete, then the owner-reference cascade, as the Python store
        does. ``last``: the object's final state, which the DELETED event
        carries instead of the stored one."""
        data = (None if last is None
                else pickle.dumps(last, protocol=pickle.HIGHEST_PROTOCOL))
        rv = self._lib.vs_delete(self._h, kind.encode(),
                                 f"{namespace}/{name}".encode(), data,
                                 len(data) if data else 0)
        self._drain_events()
        if rv >= 0:
            self._cascade_delete(kind, namespace, name)

    def _cascade_delete(self, kind: str, namespace: str, name: str) -> None:
        """Owner-reference garbage collection: a deleted owner's dependents
        follow (the Python store's ``_cascade_delete``)."""
        for dep_kind in self.KINDS:
            for obj in self.list(dep_kind, namespace):
                if any(ref.get("kind") == kind and ref.get("name") == name
                       for ref in obj.metadata.owner_references):
                    self.delete(dep_kind, namespace, obj.metadata.name)

    def get(self, kind: str, namespace: str, name: str):
        return self._read(kind, f"{namespace}/{name}")

    def _keys(self, kind: str) -> List[str]:
        # the sizing race of _read: a copy that fits the buffer is whole,
        # only a key set that grew between the calls is read again
        n = self._lib.vs_list_keys(self._h, kind.encode(), None, 0)
        for _ in range(self._SIZED_READ_RETRIES):
            if n <= 0:
                return []
            buf = ctypes.create_string_buffer(int(n))
            n2 = self._lib.vs_list_keys(self._h, kind.encode(), buf, n)
            if n2 <= n:
                return buf.raw[:max(int(n2), 0)].decode().splitlines()
            n = n2
        raise RuntimeError(
            f"vs_list_keys({kind}): the key set kept growing past the "
            f"sized buffer on {self._SIZED_READ_RETRIES} consecutive reads")

    def _list(self, kind: str) -> List:
        objs = [self._read(kind, k) for k in self._keys(kind)]
        return [o for o in objs if o is not None]

    def list(self, kind: str, namespace: Optional[str] = None) -> List:
        objs = self._list(kind)
        if namespace is None:
            return objs
        return [o for o in objs if o.metadata.namespace == namespace]

    def list_with_rv(self, kind: str, namespace: Optional[str] = None):
        """The objects and the resourceVersion they are consistent at: the
        relist anchor of a resumable watch. Writers hold the dispatch lock,
        so nothing is written between the list and its version."""
        with self._dispatch_lock:
            self._drain_events()
            return self.list(kind, namespace), self._dispatched

    # -- kubelet emulation ----------------------------------------------------

    @_serialized
    def bind_pod(self, namespace: str, name: str, node_name: str) -> None:
        pod = self._read("Pod", f"{namespace}/{name}")
        if pod is None:
            raise KeyError(f"pod {namespace}/{name} not found")
        # the /pods webhook's gate, as in the Python store: no bind while
        # the pod's gang is Pending
        group = pod.metadata.annotations.get(
            "scheduling.k8s.io/group-name", "")
        if group:
            from ..api import PodGroupPhase
            pg = self._read("PodGroup", f"{namespace}/{group}")
            if pg is not None and pg.status.phase == PodGroupPhase.PENDING:
                raise AdmissionError(
                    f"cannot bind pod {namespace}/{name}: podgroup "
                    f"{group} phase is Pending")
        pod.status.node_name = node_name
        pod.status.phase = "Running"
        self._write("Pod", pod, create_only=False)
        self.record_event("Pod", namespace, name, "Normal", "Scheduled",
                          f"Successfully assigned {namespace}/{name} "
                          f"to {node_name}")
        self._drain_events()

    @_serialized
    def evict_pod(self, namespace: str, name: str, reason: str) -> None:
        pod = self._read("Pod", f"{namespace}/{name}")
        if pod is None:
            return
        # one DELETED event whose pod carries the condition, as from the
        # Python store
        pod.status.conditions.append({"type": "Evicted", "reason": reason})
        self.record_event("Pod", namespace, name, "Warning", "Evict",
                          f"Pod is evicted, because of {reason}")
        self.delete("Pod", namespace, name, last=pod)

    @_serialized
    def finish_pod(self, namespace: str, name: str, succeeded: bool = True,
                   exit_code=None) -> None:
        pod = self._read("Pod", f"{namespace}/{name}")
        if pod is None:
            return
        pod.status.phase = "Succeeded" if succeeded else "Failed"
        pod.status.exit_code = (exit_code if exit_code is not None
                                else (0 if succeeded else 1))
        self._write("Pod", pod, create_only=False)
        self._drain_events()


def make_object_store(prefer_native: bool = False):
    """The native store when asked for (raising NativeBuildError when it
    does not build: no quiet fallback), else the Python ObjectStore."""
    if prefer_native:
        return NativeObjectStore()
    from ..store import ObjectStore
    return ObjectStore()
