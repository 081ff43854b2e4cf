"""Queue controller: queue lifecycle state machine + status aggregation.

Mirrors Volcano's pkg/controllers/queue/{queue_controller.go,
queue_controller_action.go:35-127, state/} — Open/Closed/Closing/Unknown
transitions on OpenQueue/CloseQueue commands; PodGroup counts aggregated
into Queue.Status.
"""

from __future__ import annotations

from ..api import BusAction, PodGroupPhase, QueueState
from ..apis.objects import Command, PodGroupCR, QueueCR
from ..store import ADDED, DELETED, UPDATED, ObjectStore
from .framework import Controller


class QueueController(Controller):
    NAME = "queue-controller"

    def __init__(self):
        self.store: ObjectStore = None

    def initialize(self, store: ObjectStore, **options) -> None:
        self.store = store
        store.watch("PodGroup", self._on_podgroup)
        store.watch("Command", self._on_command)

    # -- status aggregation (queue_controller_action.go syncQueue) ----------

    def _on_podgroup(self, event: str, pg: PodGroupCR, old) -> None:
        self.sync_queue(pg.spec.queue)

    def sync_queue(self, queue_name: str) -> None:
        queue: QueueCR = self.store.get("Queue", "default", queue_name)
        if queue is None:
            return
        counts = {p: 0 for p in PodGroupPhase}
        for pg in self.store.list("PodGroup"):
            if pg.spec.queue == queue_name:
                counts[pg.status.phase] = counts.get(pg.status.phase, 0) + 1
        queue.status.pending = counts.get(PodGroupPhase.PENDING, 0)
        queue.status.running = counts.get(PodGroupPhase.RUNNING, 0)
        queue.status.unknown = counts.get(PodGroupPhase.UNKNOWN, 0)
        queue.status.inqueue = counts.get(PodGroupPhase.INQUEUE, 0)
        self.store.update_status(queue)

    # -- open/close state machine (queue/state/*.go) -------------------------

    def _on_command(self, event: str, cmd: Command, old) -> None:
        if event != ADDED:
            return
        target = cmd.target_object or {}
        if target.get("kind") != "Queue":
            return
        queue: QueueCR = self.store.get("Queue", "default", target.get("name"))
        self.store.delete("Command", cmd.metadata.namespace, cmd.metadata.name)
        if queue is None:
            return
        if cmd.action == BusAction.OPEN_QUEUE:
            queue.status.state = QueueState.OPEN
        elif cmd.action == BusAction.CLOSE_QUEUE:
            active = any(pg.spec.queue == queue.metadata.name
                         and pg.status.phase in (PodGroupPhase.RUNNING,
                                                 PodGroupPhase.INQUEUE)
                         for pg in self.store.list("PodGroup"))
            queue.status.state = (QueueState.CLOSING if active
                                  else QueueState.CLOSED)
        self.store.update_status(queue)
        self.sync_queue(queue.metadata.name)
