"""Resumable watch streams: the informer contract over the store boundary.

A real informer's watch connection dies all the time; the client
re-watches from its last seen resourceVersion and — when the server
answers 410 Gone — relists and reconciles. This module gives the cache
wiring (store_wiring.py) exactly that behavior over any store-shaped
source (the raw ObjectStore, or the faulty/retrying transports of
store_transport.py):

- :class:`ResumableWatch` is ONE stream: it tracks the last delivered
  resourceVersion (bookmarks keep it fresh while idle), normalizes the
  event stream against its ``known`` object map so the downstream cache
  handler sees each object's lifecycle exactly once (a replayed ADDED
  for a known pod is delivered as UPDATED with the previous object; a
  DELETED for an unknown key is dropped), and recovers a torn stream by
  re-watching from ``last_rv`` — or, on :class:`GoneError`, by the
  list-then-watch relist that neither double-adds pods nor drops a
  delete that raced the relist (tests/test_store_transport.py proves
  both properties);
- :class:`WatchManager` owns a cache's streams: ``step()`` (called by
  the scheduler epilogue and per sim cycle) resumes whatever tore,
  ticks bookmarks, resets the retry funnel's per-cycle budget, and
  publishes stream staleness to /healthz?detail and
  volcano_store_watch_staleness.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Tuple

from ..store import ADDED, BOOKMARK, DELETED, UPDATED, GoneError

log = logging.getLogger(__name__)


def _key(obj) -> str:
    return obj.metadata.key()


class ResumableWatch:
    """One resumable watch stream over ``source`` for ``kind``; delivers
    normalized (event, obj, old) triples to ``handler`` — the cache
    wiring's per-kind informer handler."""

    def __init__(self, source, kind: str, handler: Callable):
        self.source = source
        self.kind = kind
        self.handler = handler
        self.last_rv = 0
        # key -> (obj, rv at delivery): the informer store. Normalizing
        # against it is what makes resume/relist exactly-once for the
        # downstream cache (cache.add_task is NOT idempotent — a
        # double-ADD double-counts a placed pod's accounting).
        self.known: Dict[str, Tuple[object, int]] = {}
        self.handle = None
        self.resumes = 0
        self.relists = 0
        self._start()

    # -- lifecycle -----------------------------------------------------------

    def _start(self) -> None:
        """Initial list-then-watch (the informer ListAndWatch): a
        consistent list anchors ``last_rv``; the subscription replays
        anything newer from the backlog — no gap, no overlap."""
        self._apply_list()
        self._subscribe(self.last_rv)

    def _subscribe(self, since_rv: int) -> None:
        self.handle = self.source.watch(self.kind, self._on_event,
                                        since_rv=since_rv, with_rv=True)

    def cancel(self) -> None:
        if self.handle is not None and hasattr(self.handle, "cancel"):
            self.handle.cancel()
        elif self.handle is not None:
            # raw-store watcher token
            self.source.unwatch(self.kind, self.handle)
        self.handle = None

    @property
    def torn(self) -> bool:
        return self.handle is None or getattr(self.handle, "torn", False)

    def tear(self) -> None:
        """Test/sim affordance: kill the stream as the transport would."""
        if self.handle is not None and hasattr(self.handle, "tear"):
            self.handle.tear()
        else:
            self.cancel()

    # -- event normalization -------------------------------------------------

    def _on_event(self, event: str, obj, old, rv: int) -> None:
        if event == BOOKMARK:
            self.last_rv = max(self.last_rv, rv)
            return
        self.last_rv = max(self.last_rv, rv)
        key = _key(obj)
        prev = self.known.get(key)
        if event == DELETED:
            if prev is None:
                return                    # never knew it: nothing to undo
            self.known.pop(key, None)
            self.handler(DELETED, obj, None)
            return
        if prev is not None and rv and rv <= prev[1]:
            return                        # duplicate/stale replay
        self.known[key] = (obj, rv or getattr(obj.metadata,
                                              "resource_version", 0))
        if prev is None:
            self.handler(ADDED, obj, None)
        else:
            # an ADDED replay of a known object is an UPDATE downstream;
            # prefer the event's own old snapshot when the store sent one
            self.handler(UPDATED, obj,
                         old if old is not None else prev[0])

    # -- recovery ------------------------------------------------------------

    def _apply_list(self) -> None:
        """Reconcile ``known`` (and the downstream cache) against a
        fresh consistent list: new keys ADD, changed keys UPDATE with the
        previously delivered object, keys missing from the list are the
        deletes that raced — delivered as DELETED, never silently
        dropped. Unchanged keys are skipped (no double-add)."""
        objs, rv = self.source.list_with_rv(self.kind)
        listed = {_key(o): o for o in objs}
        for key in sorted(set(self.known) - set(listed)):
            prev, _ = self.known.pop(key)
            self.handler(DELETED, prev, None)
        for key in sorted(listed):
            obj = listed[key]
            orv = getattr(obj.metadata, "resource_version", 0)
            prev = self.known.get(key)
            if prev is None:
                self.known[key] = (obj, orv)
                self.handler(ADDED, obj, None)
            elif orv > prev[1]:
                self.known[key] = (obj, orv)
                self.handler(UPDATED, obj, prev[0])
        self.last_rv = max(self.last_rv, rv)

    def resume(self) -> Optional[str]:
        """Recover a torn stream: re-watch from ``last_rv`` (the backlog
        replays what was missed), falling back to the full relist on 410
        Gone. Returns the outcome ("resume"|"relist") or None when the
        stream is live."""
        if not self.torn:
            return None
        from .. import metrics
        self.cancel()
        try:
            self._subscribe(self.last_rv)
            self.resumes += 1
            metrics.register_watch_resume("resume")
            return "resume"
        except GoneError:
            self._apply_list()
            self._subscribe(self.last_rv)
            self.relists += 1
            metrics.register_watch_resume("relist")
            return "relist"

    def detail(self) -> dict:
        return {"kind": self.kind, "last_rv": self.last_rv,
                "torn": self.torn, "known": len(self.known),
                "resumes": self.resumes, "relists": self.relists}


class WatchManager:
    """A cache's resumable watch streams plus the per-cycle upkeep the
    scheduler shell drives (Scheduler._cycle_epilogue → ``step()``)."""

    def __init__(self, source):
        self.source = source
        self.watches: List[ResumableWatch] = []

    def add(self, kind: str, handler: Callable) -> ResumableWatch:
        w = ResumableWatch(self.source, kind, handler)
        self.watches.append(w)
        return w

    def torn(self) -> List[ResumableWatch]:
        return [w for w in self.watches if w.torn]

    def staleness(self) -> int:
        """Max resourceVersion lag across streams — how far the most
        behind (torn) stream trails the store."""
        cur = self.source.current_rv() \
            if hasattr(self.source, "current_rv") else 0
        return max((cur - w.last_rv for w in self.watches), default=0)

    def step(self) -> int:
        """One upkeep tick: resume torn streams, emit bookmarks so idle
        streams' resume points stay inside the backlog window, reset the
        retry funnel's per-cycle budget, publish staleness + the store
        /healthz?detail fragment. Returns the number of streams
        recovered."""
        from .. import metrics
        recovered = 0
        for w in self.watches:
            try:
                if w.resume() is not None:
                    recovered += 1
            except Exception:
                # a failed resume (e.g. the relist itself hit a transient
                # past the retry budget) leaves the stream torn; the next
                # step retries — degradation, not a crashed cycle
                log.exception("watch resume for %s failed; stream stays "
                              "torn until the next cycle", w.kind)
        if hasattr(self.source, "emit_bookmarks"):
            self.source.emit_bookmarks()
        if hasattr(self.source, "new_cycle"):
            self.source.new_cycle()
        metrics.set_store_watch_staleness(self.staleness())
        detail = {"wired": True, "staleness": self.staleness(),
                  "streams": [w.detail() for w in self.watches]}
        if hasattr(self.source, "detail"):
            detail["retry_funnel"] = self.source.detail()
        metrics.set_store_detail(detail)
        return recovered
