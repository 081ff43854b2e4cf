"""PodGroup controller: auto-gang for bare pods.

Mirrors Volcano's pkg/controllers/podgroup/pg_controller_handler.go:
37-127 — a plain pod with the volcano scheduler and no group annotation gets
a 1-member PodGroup and the annotation stamped.
"""

from __future__ import annotations

from ..apis.objects import ObjectMeta, Pod, PodGroupCR, PodGroupSpec
from ..cache.store_wiring import GROUP_NAME_ANNOTATION
from ..store import ADDED, ObjectStore
from .framework import Controller


class PodGroupController(Controller):
    NAME = "pg-controller"

    def __init__(self, scheduler_name: str = "volcano"):
        self.store: ObjectStore = None
        self.scheduler_name = scheduler_name

    def initialize(self, store: ObjectStore, **options) -> None:
        self.store = store
        store.watch("Pod", self._on_pod)

    def _on_pod(self, event: str, pod: Pod, old) -> None:
        if event != ADDED:
            return
        if pod.scheduler_name != self.scheduler_name:
            return
        if pod.metadata.annotations.get(GROUP_NAME_ANNOTATION):
            return
        pg_name = f"podgroup-{pod.metadata.uid}"
        if self.store.get("PodGroup", pod.metadata.namespace, pg_name) is None:
            self.store.create(PodGroupCR(
                metadata=ObjectMeta(
                    name=pg_name, namespace=pod.metadata.namespace,
                    owner_references=[{"kind": "Pod",
                                       "name": pod.metadata.name}]),
                spec=PodGroupSpec(
                    min_member=1,
                    queue=pod.metadata.annotations.get(
                        "volcano.sh/queue-name", "default"),
                    min_resources=(pod.template.resources.clone()
                                   if pod.template.resources else None))))
        pod.metadata.annotations[GROUP_NAME_ANNOTATION] = pg_name
        self.store.update(pod)
