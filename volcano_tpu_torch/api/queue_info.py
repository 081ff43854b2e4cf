"""QueueInfo (mirrors pkg/scheduler/api/queue_info.go). The
allocate cycle orders queues by uid (no queue-order plugin in this package
yet); capability, reclaimability and state arrive with proportion and
reclaim."""

from __future__ import annotations


class QueueInfo:
    def __init__(self, uid: str = "", name: str = "", weight: int = 1):
        self.uid = uid or name
        self.name = name or self.uid
        self.weight = weight

    def clone(self) -> "QueueInfo":
        return QueueInfo(uid=self.uid, name=self.name, weight=self.weight)

    def __repr__(self) -> str:
        return f"Queue({self.name} weight={self.weight})"
