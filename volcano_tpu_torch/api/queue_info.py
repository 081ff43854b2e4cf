"""QueueInfo and NamespaceInfo (mirrors pkg/scheduler/api/queue_info.go and
namespace_info.go): weight, capability (proportion), reclaimability
(reclaim) and the hierarchy annotations (hierarchical drf)."""

from __future__ import annotations

from typing import Dict, Optional

from .resource import Resource
from .types import QueueState

DEFAULT_NAMESPACE_WEIGHT = 1

# scheduling/v1beta1 annotation keys (vendor/volcano.sh/apis labels.go:19-21)
KUBE_HIERARCHY_ANNOTATION_KEY = "volcano.sh/hierarchy"
KUBE_HIERARCHY_WEIGHT_ANNOTATION_KEY = "volcano.sh/hierarchy-weights"


class QueueInfo:
    def __init__(self, uid: str = "", name: str = "", weight: int = 1,
                 capability: Optional[Resource] = None,
                 reclaimable: bool = True,
                 state: QueueState = QueueState.OPEN,
                 annotations: Optional[Dict[str, str]] = None):
        self.uid = uid or name
        self.name = name or self.uid
        self.weight = weight
        self.capability = capability      # None => unlimited in every dimension
        self.reclaimable = reclaimable
        self.state = state
        self.annotations = dict(annotations or {})

    @property
    def hierarchy(self) -> str:
        """Slash-separated path in the queue tree (queue_info.go:40-55)."""
        return self.annotations.get(KUBE_HIERARCHY_ANNOTATION_KEY, "")

    @property
    def hierarchy_weights(self) -> str:
        return self.annotations.get(KUBE_HIERARCHY_WEIGHT_ANNOTATION_KEY, "")

    def clone(self) -> "QueueInfo":
        return QueueInfo(uid=self.uid, name=self.name, weight=self.weight,
                         capability=self.capability,
                         reclaimable=self.reclaimable, state=self.state,
                         annotations=self.annotations)

    def __repr__(self) -> str:
        return f"Queue({self.name} weight={self.weight})"


class NamespaceInfo:
    def __init__(self, name: str, weight: int = DEFAULT_NAMESPACE_WEIGHT):
        self.name = name
        self.weight = weight

    def get_weight(self) -> int:
        return self.weight if self.weight > 0 else DEFAULT_NAMESPACE_WEIGHT


class NamespaceCollection:
    """One namespace's weights by source, the ResourceQuotas'
    ``volcano.sh/namespace.weight`` (namespace_info.go:60-145): the
    snapshot's NamespaceInfo takes the largest."""

    WEIGHT_KEY = "volcano.sh/namespace.weight"

    def __init__(self, name: str):
        self.name = name
        self._weights: Dict[str, int] = {}

    def update(self, source: str, weight: int) -> None:
        self._weights[source] = weight

    def delete(self, source: str) -> None:
        self._weights.pop(source, None)

    def snapshot(self) -> NamespaceInfo:
        weight = (max(self._weights.values()) if self._weights
                  else DEFAULT_NAMESPACE_WEIGHT)
        return NamespaceInfo(self.name, weight)
