"""The hostile store boundary (docs/robustness.md, store failure model).

In production the scheduler talks to the Kubernetes API server; every
verb can be slow, fail transiently (500/etcd timeout), conflict (409),
or — for watches — silently die mid-stream. This module puts that
reality between the scheduler and the in-process :class:`ObjectStore`:

- :class:`FaultyStoreTransport` injects seeded faults per verb (driven
  by :class:`chaos.StoreFaultInjector`) and owns the
  tearable watch-stream handles — the chaos half;
- :class:`RetryingStoreTransport` is the production-side funnel every
  scheduler write rides: bounded retry with exponential backoff +
  seeded jitter on transient errors, under a per-cycle time budget.
  Exhaustion re-raises, and the cache funnels degrade to the existing
  rollback → resync → dead-letter machinery instead of crashing the
  cycle. vlint rule VT016 statically pins scheduler-side store verbs to
  this funnel (docs/static-analysis.md).

Composition (the production stack, faulty layer only in chaos rigs)::

    store = RetryingStoreTransport(FaultyStoreTransport(ObjectStore(),
                                                        injector))
    cache = wire_cache_to_store(store)

Both wrappers are duck-typed to the ObjectStore verb surface; anything
not intercepted (events, admission hooks) delegates to the inner store.
"""

from __future__ import annotations

import random
import time
from typing import Callable, List, Optional

from .store import BOOKMARK, ConflictError

# verbs the retry funnel wraps; reads retry too (a relist that dies on a
# transient must not wedge the informer)
WRITE_VERBS = ("create", "create_batch", "update", "update_status",
               "delete", "bind_pod", "evict_pod", "finish_pod")
READ_VERBS = ("get", "list", "list_with_rv")


class TransientStoreError(RuntimeError):
    """A store verb failed in a way a retry may fix — the HTTP 500 /
    etcd-timeout analogue (client-go's IsServerTimeout class)."""

    def __init__(self, verb: str, seed: int, attempt: int):
        super().__init__(f"store: injected transient {verb} failure "
                         f"(seed={seed}, attempt={attempt})")
        self.verb = verb


class StreamHandle:
    """One watch stream through the faulty transport. ``torn`` flips when
    the injector kills the stream — events stop flowing until the owner
    (cache/watches.ResumableWatch) resumes or relists. ``cancel`` ends
    the stream for good (normal informer shutdown)."""

    __slots__ = ("kind", "transport", "handler", "torn", "_watcher")

    def __init__(self, kind: str, transport: "FaultyStoreTransport",
                 handler: Callable):
        self.kind = kind
        self.transport = transport
        self.handler = handler
        self.torn = False
        self._watcher = None

    def cancel(self) -> None:
        if self._watcher is not None:
            self.transport.store.unwatch(self.kind, self._watcher)
            self._watcher = None

    def tear(self) -> None:
        """Kill the stream (the transport's injector calls this on a
        seeded roll; the sim also tears streams wholesale at seeded
        cycles). Idempotent."""
        if not self.torn:
            self.torn = True
            self.cancel()


class FaultyStoreTransport:
    """Seeded fault injection over an ObjectStore-shaped inner store.
    Verb faults come from the injector's per-call roll; watch streams
    are delivered through tearable :class:`StreamHandle`s whose events
    additionally roll the injector's tear rate."""

    def __init__(self, store, injector, name: str = "store"):
        self.store = store
        self.injector = injector
        self.name = name
        self.streams: List[StreamHandle] = []

    # -- verb faulting -------------------------------------------------------

    def _roll(self, verb: str, kind_hint: str = "", key: str = "") -> None:
        fault = self.injector.roll(verb)
        if fault is None:
            return
        from . import metrics
        metrics.register_store_fault(verb, fault)
        if fault == "transient":
            raise TransientStoreError(verb, self.injector.seed,
                                      self.injector.attempts)
        if fault == "conflict":
            raise ConflictError(kind_hint or verb, key or "?",
                                observed=self.store.current_rv(),
                                expected=-1)
        # "latency": the injector already slept; the verb proceeds

    def create(self, obj):
        self._roll("create", obj.KIND, obj.metadata.key())
        return self.store.create(obj)

    def create_batch(self, objs, admit: bool = True):
        objs = list(objs)
        hint = objs[0].KIND if objs else "?"
        self._roll("create_batch", hint)
        return self.store.create_batch(objs, admit=admit)

    def update(self, obj, expect_rv=None):
        self._roll("update", obj.KIND, obj.metadata.key())
        return self.store.update(obj, expect_rv=expect_rv)

    def update_status(self, obj):
        self._roll("update_status", obj.KIND, obj.metadata.key())
        return self.store.update_status(obj)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self._roll("delete", kind, f"{namespace}/{name}")
        return self.store.delete(kind, namespace, name)

    def get(self, kind: str, namespace: str, name: str):
        self._roll("get", kind, f"{namespace}/{name}")
        return self.store.get(kind, namespace, name)

    def list(self, kind: str, namespace=None, job=None):
        self._roll("list", kind)
        return self.store.list(kind, namespace, job=job)

    def list_with_rv(self, kind: str, namespace=None):
        self._roll("list", kind)
        return self.store.list_with_rv(kind, namespace)

    def bind_pod(self, namespace: str, name: str, node_name: str) -> None:
        self._roll("bind_pod", "Pod", f"{namespace}/{name}")
        return self.store.bind_pod(namespace, name, node_name)

    def evict_pod(self, namespace: str, name: str, reason: str) -> None:
        self._roll("evict_pod", "Pod", f"{namespace}/{name}")
        return self.store.evict_pod(namespace, name, reason)

    def finish_pod(self, namespace: str, name: str, succeeded: bool = True,
                   exit_code=None) -> None:
        # kubelet-side helper: not a scheduler verb; no fault roll
        return self.store.finish_pod(namespace, name, succeeded, exit_code)

    # -- tearable watch streams ----------------------------------------------

    def watch(self, kind: str, handler: Callable,
              since_rv: Optional[int] = None,
              with_rv: bool = False) -> StreamHandle:
        """Open a watch stream through the transport. The returned handle
        tears on the injector's seeded per-event roll (and on explicit
        ``tear()``); a torn stream delivers nothing more — exactly a
        died apiserver connection — until its owner re-watches."""
        hs = StreamHandle(kind, self, handler)

        def forward(event, obj, old, rv):
            if hs.torn:
                return
            if event != BOOKMARK and self.injector.roll_tear():
                from . import metrics
                metrics.register_store_fault("watch", "torn")
                hs.tear()
                return
            if with_rv:
                handler(event, obj, old, rv)
            else:
                handler(event, obj, old)

        hs._watcher = self.store.watch(kind, forward, since_rv=since_rv,
                                       with_rv=True)
        self.streams.append(hs)
        return hs

    def unwatch(self, kind: str, handle: StreamHandle) -> None:
        handle.cancel()
        if handle in self.streams:
            self.streams.remove(handle)

    def tear_streams(self, n: int, rng: Optional[random.Random] = None
                     ) -> List[str]:
        """Tear ``n`` live streams chosen by the (seeded) rng — the sim's
        whole-stream tear drill. Returns the torn kinds."""
        live = [s for s in self.streams if not s.torn]
        if not live:
            return []
        rng = rng or self.injector._rng
        torn = []
        for _ in range(min(n, len(live))):
            s = live.pop(rng.randrange(len(live)))
            s.tear()
            torn.append(s.kind)
            from . import metrics
            metrics.register_store_fault("watch", "torn")
        return torn

    # -- delegation ----------------------------------------------------------

    def __getattr__(self, name):
        return getattr(self.store, name)


DEFAULT_MAX_ATTEMPTS = 5
DEFAULT_BASE_DELAY = 0.02
DEFAULT_MAX_DELAY = 0.5
DEFAULT_JITTER = 0.25
DEFAULT_CYCLE_BUDGET_S = 2.0


class RetryingStoreTransport:
    """The scheduler-side store write funnel: bounded retry with
    exponential backoff + seeded jitter on :class:`TransientStoreError`,
    under a per-cycle time budget.

    Only transients retry — a :class:`ConflictError` is a semantic
    verdict its caller owns (CAS loops re-read; plain writers surface
    it), and admission denials are final. When the attempt budget or the
    cycle's time budget runs out the last error re-raises: the cache
    funnels then roll back and hand the side effect to the resync
    queue → dead-letter machinery, so a sick apiserver degrades the
    scheduler instead of crashing its cycle (docs/robustness.md).

    ``sleep_fn``/``time_fn``/``rng`` are injectable (vlint VT002/VT003):
    the sim pins them to the virtual clock and a seeded RNG so faulted
    runs replay byte-deterministically; production defaults are wall
    time and per-process entropy (a fleet retrying a sick apiserver
    must not retry in lockstep)."""

    def __init__(self, store, max_attempts: int = DEFAULT_MAX_ATTEMPTS,
                 base_delay: float = DEFAULT_BASE_DELAY,
                 max_delay: float = DEFAULT_MAX_DELAY,
                 jitter: float = DEFAULT_JITTER,
                 cycle_budget_s: float = DEFAULT_CYCLE_BUDGET_S,
                 sleep_fn=time.sleep, time_fn=time.monotonic,
                 rng: Optional[random.Random] = None):
        self.store = store
        self.max_attempts = max(int(max_attempts), 1)
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.jitter = jitter
        self.cycle_budget_s = cycle_budget_s
        self.sleep_fn = sleep_fn
        self.time_fn = time_fn
        self._rng = rng if rng is not None else random.Random()
        self._budget_spent = 0.0
        self.retries = 0
        self.exhausted = 0

    def new_cycle(self) -> None:
        """Reset the per-cycle retry time budget (the scheduler shell's
        epilogue calls this; the sim calls it per virtual cycle)."""
        self._budget_spent = 0.0

    def _call(self, verb: str, fn: Callable, *args, **kwargs):
        from . import metrics
        attempt = 0
        while True:
            try:
                out = fn(*args, **kwargs)
                metrics.register_store_retry(verb, "ok")
                return out
            except TransientStoreError:
                attempt += 1
                delay = min(self.base_delay * (2 ** (attempt - 1)),
                            self.max_delay)
                delay *= 1.0 + self._rng.uniform(0.0, self.jitter)
                if attempt >= self.max_attempts \
                        or self._budget_spent + delay > self.cycle_budget_s:
                    self.exhausted += 1
                    metrics.register_store_retry(verb, "exhausted")
                    raise
                self.retries += 1
                metrics.register_store_retry(verb, "retry")
                self._budget_spent += delay
                self.sleep_fn(delay)

    # -- wrapped verbs -------------------------------------------------------

    def create(self, obj):
        return self._call("create", self.store.create, obj)

    def create_batch(self, objs, admit: bool = True):
        objs = list(objs)
        return self._call("create_batch", self.store.create_batch, objs,
                          admit=admit)

    def update(self, obj, expect_rv=None):
        return self._call("update", self.store.update, obj,
                          expect_rv=expect_rv)

    def update_status(self, obj):
        return self._call("update_status", self.store.update_status, obj)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        return self._call("delete", self.store.delete, kind, namespace,
                          name)

    def get(self, kind: str, namespace: str, name: str):
        return self._call("get", self.store.get, kind, namespace, name)

    def list(self, kind: str, namespace=None, job=None):
        return self._call("list", self.store.list, kind, namespace, job=job)

    def list_with_rv(self, kind: str, namespace=None):
        return self._call("list", self.store.list_with_rv, kind, namespace)

    def bind_pod(self, namespace: str, name: str, node_name: str) -> None:
        return self._call("bind_pod", self.store.bind_pod, namespace, name,
                          node_name)

    def evict_pod(self, namespace: str, name: str, reason: str) -> None:
        return self._call("evict_pod", self.store.evict_pod, namespace,
                          name, reason)

    def finish_pod(self, namespace: str, name: str, succeeded: bool = True,
                   exit_code=None) -> None:
        return self._call("finish_pod", self.store.finish_pod, namespace,
                          name, succeeded, exit_code)

    def watch(self, kind: str, handler: Callable,
              since_rv: Optional[int] = None, with_rv: bool = False):
        # stream recovery belongs to the resumable-watch layer
        # (cache/watches.py), not to verb retry. A v1 store (the native
        # backend) only speaks the legacy signature — current_rv is the
        # watch-v2 capability probe store_wiring uses too.
        if since_rv is None and not with_rv \
                and not hasattr(self.store, "current_rv"):
            return self.store.watch(kind, handler)
        return self.store.watch(kind, handler, since_rv=since_rv,
                                with_rv=with_rv)

    def unwatch(self, kind: str, handle) -> None:
        return self.store.unwatch(kind, handle)

    def detail(self) -> dict:
        """The /healthz?detail "store" fragment this funnel owns."""
        return {"retries": self.retries, "exhausted": self.exhausted,
                "max_attempts": self.max_attempts,
                "cycle_budget_s": self.cycle_budget_s}

    def __getattr__(self, name):
        return getattr(self.store, name)
