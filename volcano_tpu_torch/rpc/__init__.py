"""The snapshot RPC: the scheduler as a sidecar of a Go shim (the JAX
package's ``rpc/``).

A thin Go shim (``shim/main.go``) keeps client-go against a real cluster:
it serializes the cluster snapshot, ships it here and executes the
decisions that come back through its own Statement machinery. So the
in-process ObjectStore is one of two front ends.

- codec: the versioned JSON wire (nodes with live usage, jobs and
  podgroups with their tasks, queues; binds, evictions and podgroup
  writebacks back);
- service: ``SchedulerService`` runs the conf pipeline (session, plugins,
  actions and their hand kernels, on the card by default) over a cache
  rebuilt from each snapshot, with recording executors;
- admission: the webhook router over the same wire (``{"op": "admit"}``);
- server: the length-prefixed TCP server, ``serve(...)``, and
  ``SnapshotClient``: a 4-byte big-endian length, then UTF-8 JSON, both
  ways.
"""

from .codec import decisions_from_recorders, decode_snapshot, encode_snapshot
from .server import SnapshotClient, serve
from .service import SchedulerService

__all__ = ["encode_snapshot", "decode_snapshot",
           "decisions_from_recorders", "SchedulerService",
           "SnapshotClient", "serve"]
