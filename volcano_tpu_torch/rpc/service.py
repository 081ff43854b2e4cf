"""SchedulerService: one snapshot in, one cycle of the real conf pipeline,
decisions out (the JAX package's ``rpc/service.py``).

The sidecar half of the split deployment: the Go shim keeps client-go and
the Statement execution; the session, the plugin tiers and the actions,
with the hand kernels they launch, run here as they run in process.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Union

import torch

from ..cache import SchedulerCache
from ..cache.executors import Binder, Evictor
from ..framework import (close_session, get_action, open_session,
                         parse_scheduler_conf, resolve_device)
from .codec import decisions_from_recorders, decode_snapshot


class RecordingBinder(Binder):
    """Binds keyed by (namespace/name, uid), so the shim maps a decision
    back to its pod without parsing names."""

    def __init__(self):
        self.bind_records: Dict[tuple, str] = {}

    def bind(self, task, hostname: str) -> None:
        self.bind_records[(task.key(), task.uid)] = hostname


class RecordingEvictor(Evictor):
    def __init__(self):
        self.evict_records = []

    def evict(self, task, reason: str) -> None:
        self.evict_records.append((task.key(), task.uid, reason))


def _pinned(device: torch.device) -> torch.device:
    """``device`` with its index: a request runs on a handler thread, whose
    current CUDA device is not the constructing thread's."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class SchedulerService:
    """Stateless a request: every call rebuilds a cache from the snapshot
    (the store, on the other side of the wire, is the checkpoint).

    ``device``: where the sessions solve, the CUDA card by default; with no
    card and no ``device`` this raises. A conf naming an action, plugin,
    engine or argument this package lacks raises ValueError here, and a
    snapshot with pod affinity on a task fails its request by name (the
    session's open refuses it), never dropped."""

    def __init__(self, conf_text: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None):
        # actions and plugins register on import
        from .. import actions as _actions  # noqa: F401
        from .. import plugins as _plugins  # noqa: F401
        from ..scheduler import check_conf
        self.device = _pinned(resolve_device(device))
        self.conf = parse_scheduler_conf(conf_text)
        check_conf(self.conf)
        # one snapshot at a time: the transport serves connections
        # concurrently, but a cycle touches process-wide state (the
        # engines' counters, the device cool-down)
        self._cycle_lock = threading.Lock()

    def schedule(self, snapshot_msg: dict) -> dict:
        with self._cycle_lock:
            return self._schedule_locked(snapshot_msg)

    def reload_conf(self, conf_text: Optional[str]) -> None:
        """Swap the conf between cycles (the sidecar's file watcher)."""
        from ..scheduler import check_conf
        conf = parse_scheduler_conf(conf_text)
        check_conf(conf)
        with self._cycle_lock:
            self.conf = conf

    def _schedule_locked(self, snapshot_msg: dict) -> dict:
        nodes, jobs, queues = decode_snapshot(snapshot_msg)
        binder = RecordingBinder()
        evictor = RecordingEvictor()
        cache = SchedulerCache(binder=binder, evictor=evictor,
                               default_queue="")
        for q in queues:
            cache.add_queue(q)
        for n in nodes:
            cache.add_node(n)
        for j in jobs:
            cache.add_job(j)
        on_card = (torch.cuda.device(self.device)
                   if self.device.type == "cuda"
                   else contextlib.nullcontext())
        with on_card:
            ssn = open_session(cache, self.conf.tiers,
                               self.conf.configurations, device=self.device)
            try:
                for name in self.conf.actions:
                    get_action(name).execute(ssn)
            finally:
                close_session(ssn)
        return decisions_from_recorders(binder, evictor,
                                        list(ssn.jobs.values()))
