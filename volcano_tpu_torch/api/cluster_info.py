"""ClusterInfo: the per-cycle snapshot root.

Mirrors pkg/scheduler/api/cluster_info.go. The snapshot is the
session's isolated world: plugins and actions mutate only this copy, never the
live cache. The allocate solve materializes it into dense tensors on the
session's device (volcano_tpu_torch.cache.snapshot.NodeTensors).
"""

from __future__ import annotations

from typing import Dict

from .job_info import JobInfo
from .node_info import NodeInfo
from .queue_info import NamespaceInfo, QueueInfo


class ClusterInfo:
    def __init__(self):
        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}
        self.namespaces: Dict[str, NamespaceInfo] = {}

    def __repr__(self) -> str:
        return (f"ClusterInfo(jobs={len(self.jobs)} nodes={len(self.nodes)} "
                f"queues={len(self.queues)})")
