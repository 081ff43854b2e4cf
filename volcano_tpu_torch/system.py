"""The whole system in one process: a Volcano-equivalent cluster, the JAX
package's ``system.py``.

Wires the three control-plane components and the CLI together: the
ObjectStore (the API server and etcd), the webhook router
(vc-webhook-manager), the controllers (vc-controller-manager), and the
Scheduler over a store-wired cache (vc-scheduler), whose sessions solve on
the CUDA card unless the caller asks for the CPU.

Quick start::

    from volcano_tpu_torch.system import VolcanoSystem
    from volcano_tpu_torch.api import NodeInfo, Resource

    system = VolcanoSystem()                 # device="cpu" off the card
    alloc = Resource(8000, 32 << 30)
    alloc.max_task_num = 110
    system.cache.add_node(NodeInfo(name="n0", allocatable=alloc))
    system.jobs.run("job-1", replicas=2)     # vcctl job run
    system.schedule_once()
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .apis.objects import ObjectMeta, QueueCR, QueueSpecCR
from .cache.store_wiring import wire_cache_to_store
from .cli.vcctl import JobCommands, QueueCommands
from .controllers import start_controllers
from .framework.framework import resolve_device
from .scheduler import Scheduler
from .store import ObjectStore
from .webhooks import register_webhooks

class VolcanoSystem:
    def __init__(self, conf_text: Optional[str] = None,
                 schedule_period: float = 1.0,
                 default_queue: str = "default",
                 store: Optional[ObjectStore] = None,
                 native_store: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        """``device``: where the scheduler's sessions solve, the CUDA card
        by default; with no card and no ``device`` this raises rather than
        run on the CPU. ``native_store=True`` backs the API server's state
        with the C++ store (``native.NativeObjectStore``), built at first
        use; a failed build raises. A ``store`` given wins over both."""
        # before any component is built: a system without a usable device
        # is refused whole
        self.device = resolve_device(device)
        if store is not None:
            self.store = store
        elif native_store:
            from .native import make_object_store
            self.store = make_object_store(prefer_native=True)
        else:
            self.store = ObjectStore()
        self.router = register_webhooks(self.store)
        self.controllers = start_controllers(self.store)
        if default_queue:
            self.store.create(QueueCR(
                metadata=ObjectMeta(name=default_queue, namespace="default"),
                spec=QueueSpecCR(weight=1)))
        # the scheduler's connection to the store rides the retrying
        # transport funnel: every scheduler-side verb gets bounded retry
        # with backoff and jitter under a per-cycle budget, degrading to
        # resync past it. Controllers, webhooks and the CLI keep the raw
        # store: they are other components with their own semantics
        from .store_transport import RetryingStoreTransport
        self.scheduler_transport = RetryingStoreTransport(self.store)
        self.cache = wire_cache_to_store(self.scheduler_transport)
        self.scheduler = Scheduler(self.cache, conf_text=conf_text,
                                   schedule_period=schedule_period,
                                   device=self.device)
        self.jobs = JobCommands(self.store)
        self.queues = QueueCommands(self.store)

    def schedule_once(self):
        """One drained scheduling cycle. Returns the cycle's isolated
        per-action failures ([] when clean): a misconfigured action does
        not raise out of run_once, so a caller checks the list (the shell's
        run() loop does the same through its crash-loop guard)."""
        self._drain_controllers()
        errors = self.scheduler.run_once()
        self._drain_controllers()
        return errors

    def _drain_controllers(self) -> None:
        """Coalesced controller work (the workqueue worker's analogue):
        jobs whose pods churned get one sync, not one a pod event."""
        for c in self.controllers:
            if hasattr(c, "process_dirty"):
                c.process_dirty()

    def start(self):
        return self.scheduler.start()

    def stop(self) -> None:
        self.scheduler.stop()
