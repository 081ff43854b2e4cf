"""NUMA topology model: Numatopology CR info + topology-manager hint algebra.

Mirrors pkg/scheduler/api/numa_info.go:38-180 (NumatopoInfo,
ResourceInfo, ResNumaSets and their Allocate/Release set arithmetic) and the
kubelet-style hint machinery the numaaware plugin builds on
(pkg/scheduler/plugins/numaaware/policy/policy.go:24-167, factory.go:30-43).

Representation choices (host-side):
- a cpuset is a plain Python ``frozenset``-able ``set[int]``;
- a NUMA-node affinity is a plain ``int`` bitmask (bit i = NUMA node i),
  so merging hints is ``&`` and narrowness is ``bit_count()`` — the same
  trick a dense per-node NUMA mask would use.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from itertools import product
from typing import Dict, Iterable, List, Optional, Set

CPU_MANAGER_POLICY = "CPUManagerPolicy"        # nodeinfo/v1alpha1 PolicyName
TOPOLOGY_MANAGER_POLICY = "TopologyManagerPolicy"

CPU = "cpu"


# ---------------------------------------------------------------------------
# bitmask helpers (k8s topologymanager/bitmask, reimplemented on int)

def bitmask(numa_ids: Iterable[int]) -> int:
    mask = 0
    for i in numa_ids:
        mask |= 1 << i
    return mask


def mask_bits(mask: int) -> List[int]:
    out, i = [], 0
    while mask >> i:
        if (mask >> i) & 1:
            out.append(i)
        i += 1
    return out


def mask_count(mask: int) -> int:
    return bin(mask).count("1")


def is_narrower(a: int, b: int) -> bool:
    """bitmask.IsNarrowerThan: fewer bits set; ties broken by lower value."""
    ca, cb = mask_count(a), mask_count(b)
    if ca == cb:
        return a < b
    return ca < cb


def iterate_bitmasks(numa_ids: List[int]):
    """bitmask.IterateBitMasks — every non-empty combination of NUMA ids."""
    n = len(numa_ids)
    for bits in range(1, 1 << n):
        yield bitmask(numa_ids[i] for i in range(n) if (bits >> i) & 1)


# ---------------------------------------------------------------------------
# topology hints (policy/factory.go:30-36)

@dataclass
class TopologyHint:
    """NUMA affinity proposal for one resource of one task.

    ``affinity is None`` means "any NUMA node" (the nil bitmask in the
    reference)."""
    affinity: Optional[int]
    preferred: bool


@dataclass
class CPUInfo:
    """Per-CPU detail (kubelet topology.CPUDetails entry)."""
    numa_id: int
    socket_id: int = 0
    core_id: int = 0


@dataclass
class ResourceInfo:
    """numa_info.go:39-43 — allocatable cpuset + capacity for one resource."""
    allocatable: Set[int] = field(default_factory=set)
    capacity: int = 0

    def clone(self) -> "ResourceInfo":
        return ResourceInfo(set(self.allocatable), self.capacity)


# ResNumaSets (numa_info.go:157): resource name -> cpuset
ResNumaSets = Dict[str, Set[int]]


def res_sets_allocate(target: ResNumaSets, taken: ResNumaSets) -> None:
    """ResNumaSets.Allocate — remove assigned ids (numa_info.go:160-167)."""
    for res, ids in taken.items():
        if res in target:
            target[res] -= ids


def res_sets_release(target: ResNumaSets, taken: ResNumaSets) -> None:
    """ResNumaSets.Release (numa_info.go:170-177)."""
    for res, ids in taken.items():
        if res in target:
            target[res] |= ids


def res_sets_clone(sets: ResNumaSets) -> ResNumaSets:
    return {res: set(ids) for res, ids in sets.items()}


class NumatopoInfo:
    """Per-node topology-manager state (numa_info.go:45-114)."""

    def __init__(self, name: str = "", namespace: str = "default",
                 policies: Optional[Dict[str, str]] = None,
                 numa_res_map: Optional[Dict[str, ResourceInfo]] = None,
                 cpu_detail: Optional[Dict[int, CPUInfo]] = None,
                 res_reserved: Optional[Dict[str, float]] = None):
        self.name = name
        self.namespace = namespace
        self.policies = dict(policies or {})
        self.numa_res_map = numa_res_map or {}
        self.cpu_detail = cpu_detail or {}
        self.res_reserved = dict(res_reserved or {})

    @classmethod
    def uniform(cls, name: str, numa_nodes: int, cpus_per_node: int,
                topology_policy: str = "best-effort",
                cpu_manager_policy: str = "static") -> "NumatopoInfo":
        """Convenience builder: `numa_nodes` NUMA domains with
        `cpus_per_node` CPUs each, ids laid out contiguously."""
        detail = {}
        for node in range(numa_nodes):
            for k in range(cpus_per_node):
                detail[node * cpus_per_node + k] = CPUInfo(numa_id=node,
                                                           socket_id=node)
        return cls(name=name,
                   policies={CPU_MANAGER_POLICY: cpu_manager_policy,
                             TOPOLOGY_MANAGER_POLICY: topology_policy},
                   numa_res_map={CPU: ResourceInfo(set(detail), len(detail))},
                   cpu_detail=detail)

    def numa_nodes(self) -> List[int]:
        """numa_info.go GenerateNumaNodes per-node part."""
        return sorted({c.numa_id for c in self.cpu_detail.values()})

    def cpus_in_numa_nodes(self, mask: int) -> Set[int]:
        """CPUDetails.CPUsInNUMANodes for an affinity bitmask."""
        return {cpu for cpu, info in self.cpu_detail.items()
                if (mask >> info.numa_id) & 1}

    def deep_copy(self) -> "NumatopoInfo":
        return NumatopoInfo(
            name=self.name, namespace=self.namespace,
            policies=dict(self.policies),
            numa_res_map={r: info.clone()
                          for r, info in self.numa_res_map.items()},
            cpu_detail=dict(self.cpu_detail),
            res_reserved=dict(self.res_reserved))

    def compare(self, new: "NumatopoInfo") -> bool:
        """numa_info.go Compare: True iff no resource's allocatable set is
        shrinking in ``new`` (a shrink means running pods must be re-checked
        against the tighter topology)."""
        for res, info in self.numa_res_map.items():
            new_info = new.numa_res_map.get(res)
            if new_info is None or len(new_info.allocatable) < len(info.allocatable):
                return False
        return True

    def allocate(self, res_sets: ResNumaSets) -> None:
        """numa_info.go Allocate:106-110."""
        for res, ids in res_sets.items():
            if res in self.numa_res_map:
                self.numa_res_map[res].allocatable -= ids

    def release(self, res_sets: ResNumaSets) -> None:
        """numa_info.go Release:113-117."""
        for res, ids in res_sets.items():
            if res in self.numa_res_map:
                self.numa_res_map[res].allocatable |= ids

    def idle_sets(self) -> ResNumaSets:
        """GenerateNodeResNumaSets per-node part (numa_info.go:121-137)."""
        return {res: set(info.allocatable)
                for res, info in self.numa_res_map.items()}


# ---------------------------------------------------------------------------
# hint merge (policy/policy.go:24-167)

def filter_providers_hints(
        providers_hints: List[Dict[str, List[TopologyHint]]]
) -> List[List[TopologyHint]]:
    """policy.go filterProvidersHints — flatten per-provider per-resource
    hints; absent/None means "no preference", empty means "impossible"."""
    all_hints: List[List[TopologyHint]] = []
    for hints in providers_hints:
        if not hints:
            all_hints.append([TopologyHint(None, True)])
            continue
        for resource, res_hints in hints.items():
            if res_hints is None:
                all_hints.append([TopologyHint(None, True)])
            elif len(res_hints) == 0:
                all_hints.append([TopologyHint(None, False)])
            else:
                all_hints.append(res_hints)
    return all_hints


def merge_permutation(default_affinity: int,
                      permutation: Iterable[TopologyHint]) -> TopologyHint:
    """policy.go mergePermutation — AND of affinities; preferred iff all
    are."""
    preferred = True
    merged = default_affinity
    for hint in permutation:
        merged &= default_affinity if hint.affinity is None else hint.affinity
        preferred = preferred and hint.preferred
    return TopologyHint(merged, preferred)


def merge_filtered_hints(numa_ids: List[int],
                         filtered: List[List[TopologyHint]]) -> TopologyHint:
    """policy.go mergeFilteredHints — best (preferred, narrowest) merged
    permutation; falls back to {all-numa, not-preferred}."""
    default_affinity = bitmask(numa_ids)
    best = TopologyHint(default_affinity, False)
    for permutation in product(*filtered) if filtered else []:
        merged = merge_permutation(default_affinity, permutation)
        if merged.affinity == 0:
            continue
        if merged.preferred and not best.preferred:
            best = merged
        elif merged.preferred == best.preferred and \
                is_narrower(merged.affinity, best.affinity):
            best = merged
    return best


# ---------------------------------------------------------------------------
# policies (policy_none/best_effort/restricted/single_numa_node.go)

class Policy:
    def __init__(self, numa_ids: List[int]):
        self.numa_ids = numa_ids

    def predicate(self, providers_hints) -> tuple:
        raise NotImplementedError


class PolicyNone(Policy):
    def predicate(self, providers_hints):
        return TopologyHint(None, True), True


class PolicyBestEffort(Policy):
    def predicate(self, providers_hints):
        best = merge_filtered_hints(self.numa_ids,
                                    filter_providers_hints(providers_hints))
        return best, True


class PolicyRestricted(Policy):
    def predicate(self, providers_hints):
        best = merge_filtered_hints(self.numa_ids,
                                    filter_providers_hints(providers_hints))
        return best, best.preferred


class PolicySingleNumaNode(Policy):
    def predicate(self, providers_hints):
        filtered = filter_providers_hints(providers_hints)
        single = [[h for h in hints
                   if (h.affinity is None and h.preferred)
                   or (h.affinity is not None and mask_count(h.affinity) == 1
                       and h.preferred)]
                  for hints in filtered]
        best = merge_filtered_hints(self.numa_ids, single)
        return best, best.preferred


_POLICIES = {
    "none": PolicyNone,
    "best-effort": PolicyBestEffort,
    "restricted": PolicyRestricted,
    "single-numa-node": PolicySingleNumaNode,
}


def get_policy(topo: NumatopoInfo) -> Policy:
    """factory.go GetPolicy — policy from the node's topology-manager
    policy name."""
    cls = _POLICIES.get(topo.policies.get(TOPOLOGY_MANAGER_POLICY, "none"),
                        PolicyNone)
    return cls(topo.numa_nodes())


# ---------------------------------------------------------------------------
# snapshot helpers (numa_info.go:120-155)

def generate_node_res_numa_sets(nodes: Dict[str, object]) -> Dict[str, ResNumaSets]:
    out = {}
    for node in nodes.values():
        if getattr(node, "numa_info", None) is not None:
            out[node.name] = node.numa_info.idle_sets()
    return out


def generate_numa_nodes(nodes: Dict[str, object]) -> Dict[str, List[int]]:
    out = {}
    for node in nodes.values():
        if getattr(node, "numa_info", None) is not None:
            out[node.name] = node.numa_info.numa_nodes()
    return out
