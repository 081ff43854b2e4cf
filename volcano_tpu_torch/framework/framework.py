"""OpenSession/CloseSession (mirrors
pkg/scheduler/framework/framework.go:30-60), with automatic garbage
collection suspended for the lifetime of each session."""

from __future__ import annotations

import gc
import threading
from typing import List, Optional, Union

import torch

from .. import metrics
from ..obs import trace as obs_trace
from .conf import Configuration, Tier
from .job_updater import update_all
from .registry import get_plugin_builder
from .session import Session


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device a session solves on: the CUDA card by default. A caller
    that wants the CPU says so (``device="cpu"``, as the tests do); with no
    card and no such request this raises instead of quietly running on the
    CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to schedule on the CPU")
    return torch.device("cuda")


# Whether automatic GC is on in this process OUTSIDE session windows.
# Learned (not snapshotted per session) so an open_session that was never
# paired with close_session cannot latch the "disabled" state into every
# later session's restore decision.
_GC_ON_OUTSIDE: bool = gc.isenabled()

# Suspension DEPTH, not a boolean latch: overlapping sessions each open one
# _GCWindow and close it at most once, and collection re-enables only when
# the last open window closes. A session must end in close_session or, when
# its cycle failed, abandon_session: a finalizer on the session object (the
# JAX package's guard) never runs while collection is off, because plugin
# callbacks hold the session in a reference cycle.
_GC_LOCK = threading.Lock()
_GC_OPEN_WINDOWS: List["_GCWindow"] = []


class _GCWindow:
    __slots__ = ("closed",)

    def __init__(self):
        self.closed = False


def _gc_suspend() -> "_GCWindow":
    global _GC_ON_OUTSIDE
    window = _GCWindow()
    with _GC_LOCK:
        if not _GC_OPEN_WINDOWS and gc.isenabled():
            _GC_ON_OUTSIDE = True
        _GC_OPEN_WINDOWS.append(window)
        gc.disable()
    return window


def _gc_resume(window: "_GCWindow") -> None:
    """Close one suspension window; a no-op if it already closed. The last
    window to close re-enables collection and runs one young-generation
    pass over the cycle's garbage."""
    with _GC_LOCK:
        if window.closed:
            return
        window.closed = True
        _GC_OPEN_WINDOWS.remove(window)
        if _GC_OPEN_WINDOWS or not _GC_ON_OUTSIDE:
            return
        gc.enable()
    gc.collect(1)


def open_session(cache, tiers: List[Tier],
                 configurations: List[Configuration] = (),
                 time_fn=None,
                 device: Optional[Union[str, torch.device]] = None,
                 speculative: bool = False) -> Session:
    # Automatic (threshold-triggered) collection is suspended from before
    # the snapshot to close_session: a 10k-pod cycle allocates enough
    # tracked objects (task clones, Resources, statement entries) to trip
    # full-heap collections inside the cycle. close_session resumes it and
    # runs one bounded young-generation pass.
    # A speculative open (the pipelined cycle) runs the same plugin opens
    # in a window of its own, nested in no other session's, on the cache's
    # staged snapshot: nothing of the cache's bookkeeping is consumed until
    # the shell adopts or discards the speculation.
    window = _gc_suspend()
    try:
        if speculative:
            with obs_trace.span("snapshot", speculative=True):
                ci, basis = cache.speculative_snapshot()
                ssn = Session(cache, tiers, list(configurations),
                              resolve_device(device), time_fn=time_fn,
                              snapshot=ci)
                ssn.speculative = True
                ssn.spec_basis = basis
        else:
            with obs_trace.span("snapshot"):
                ssn = Session(cache, tiers, list(configurations),
                              resolve_device(device), time_fn=time_fn)
        for tier in tiers:
            for opt in tier.plugins:
                plugin = get_plugin_builder(opt.name)(opt.arguments)
                ssn.plugins[plugin.name()] = plugin
                # the span records the callback in the cycle trace and
                # times the plugin latency series: one timer
                with obs_trace.span("plugin:" + plugin.name(),
                                    event="OnSessionOpen") as sp:
                    plugin.on_session_open(ssn)
                metrics.update_plugin_duration(plugin.name(),
                                               "OnSessionOpen", sp.dur_s)
    except BaseException:
        _gc_resume(window)
        raise
    ssn._gc_window = window
    return ssn


def _retire_session_pin(ssn: Session) -> None:
    """Release the session's pinned tensor epoch, if any (a speculative
    session pins one for its in-flight solve). Idempotent."""
    view = ssn._pinned_epoch
    if view is None:
        return
    ssn._pinned_epoch = None
    view._owner.retire_epoch(view)


def abandon_session(ssn: Session) -> None:
    """End a session whose cycle failed, or a discarded speculation:
    release its pinned tensor epoch and its garbage-collection window
    without the plugins' close or any status writeback."""
    try:
        _retire_session_pin(ssn)
    finally:
        _gc_resume(ssn._gc_window)


def close_session(ssn: Session) -> None:
    try:
        for plugin in ssn.plugins.values():
            with obs_trace.span("plugin:" + plugin.name(),
                                event="OnSessionClose") as sp:
                plugin.on_session_close(ssn)
            metrics.update_plugin_duration(plugin.name(), "OnSessionClose",
                                           sp.dur_s)
        # writeback of job/podgroup status (job_updater.go:95-108)
        with obs_trace.span("job_updater"):
            update_all(ssn)
    finally:
        # a promoted speculative session's pin is retired at the commit;
        # this releases one that was not
        try:
            _retire_session_pin(ssn)
        finally:
            _gc_resume(ssn._gc_window)
