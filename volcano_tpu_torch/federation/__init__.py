"""The federated control plane: partitioned schedulers with cross-partition
reserve and reclaim, the JAX package's ``federation`` package.

N scheduler partitions own disjoint queue subsets and node shards of ONE
cluster, each run by its own fenced leader (a per-partition Lease and
FencingAuthority: epochs namespaced by partition id), all coordinating
through the shared intent journal and store. Cross-partition work (a
starved queue reclaiming capacity another partition owns) goes through the
two-phase reserve/transfer protocol in :mod:`reserve`; everything else is
partition-local.

- :class:`PartitionMap`: who owns which queues and node shards, and the
  per-partition snapshot scope the scheduler shell consumes;
- :class:`ReserveLedger`: the journaled reserve → drain → transfer
  protocol with timeout-based release (a killed partition can never
  strand capacity), queue moves, and the journaled membership funnel
  (``partition_spawn``/``partition_retire``);
- :class:`PartitionMember`: the per-partition glue the scheduler shell's
  cycle hooks drive (review incoming reserves at the cycle boundary,
  detect starvation, publish health);
- :class:`RebalanceController`: load-driven queue rebalancing, a
  deterministic greedy bin-balancer with hysteresis and a flap guard over
  the published load, executing through the same journaled move funnel
  operators use;
- :class:`ElasticController`: load-driven membership. A chronically
  budget-exhausted partition SPLITS through the journaled
  ``partition_spawn`` funnel and a chronically idle one MERGES back
  through ``partition_retire``, queue and node ownership flowing through
  the same move and reserve funnels;
- :class:`StorePartitionBackend`, :class:`StoreBackedPartitionMap` and
  :class:`StoreBackedReserveLedger`: the map and the ledger as a
  ``PartitionState`` store object behind the CAS/watch path.

``sim --federated N`` drives the protocol: partition kills mid-trace, no
cross-partition double bind, the aggregate decision plane equal to a
single scheduler's on non-contended traces; ``sim --elastic`` adds kills
mid-split and mid-merge that reconcile to a consistent membership.
"""

from .elastic import ElasticController
from .member import PartitionMember
from .partition import PartitionMap
from .rebalance import RebalanceController
from .reserve import ReserveLedger
from .store_backed import (StoreBackedPartitionMap,
                           StoreBackedReserveLedger,
                           StorePartitionBackend)

__all__ = ["ElasticController", "PartitionMap", "PartitionMember",
           "RebalanceController", "ReserveLedger",
           "StoreBackedPartitionMap", "StoreBackedReserveLedger",
           "StorePartitionBackend"]
