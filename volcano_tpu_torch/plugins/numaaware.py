"""numa-aware plugin: topology-manager-style NUMA placement.

Mirrors pkg/scheduler/plugins/numaaware/numaaware.go:40-284
(predicate + batch node order + event bookkeeping + close-time writeback)
and the cpumanager hint provider
(numaaware/provider/cpumanager/cpu_mng.go:40-170).

Host-side by design: hint merging is tiny combinatorics over <=8 NUMA nodes
per node and only runs for tasks that declare a topology policy; the dense
placement kernel (B1) sees it only through the feasibility mask.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Set

from ..api.numa_info import (CPU, CPU_MANAGER_POLICY, TOPOLOGY_MANAGER_POLICY,
                             NumatopoInfo, ResNumaSets, TopologyHint,
                             bitmask, generate_node_res_numa_sets,
                             generate_numa_nodes, get_policy,
                             iterate_bitmasks, mask_count,
                             res_sets_allocate, res_sets_clone,
                             res_sets_release)
from ..framework.session import EventHandler
from .base import Plugin
from .util import normalize_score

PLUGIN_NAME = "numa-aware"
MAX_NODE_SCORE = 100


def guaranteed_cpus(task) -> int:
    """cpu_mng.go guaranteedCPUs — whole-CPU request count; 0 when the
    request is fractional (not exclusively allocatable)."""
    mcpu = task.resreq.cpu
    if mcpu <= 0 or mcpu % 1000 != 0:
        return 0
    return int(mcpu // 1000)


def take_by_topology(topo: NumatopoInfo, available: Set[int],
                     count: int) -> Optional[Set[int]]:
    """cpu_assignment.go takeByTopology, simplified to NUMA granularity:
    take whole free NUMA domains first (largest fit first), then fill from
    the domain with the most free CPUs."""
    if count > len(available):
        return None
    by_numa: Dict[int, List[int]] = {}
    for cpu in available:
        detail = topo.cpu_detail.get(cpu)
        if detail is not None:
            by_numa.setdefault(detail.numa_id, []).append(cpu)
    taken: Set[int] = set()
    need = count
    # whole domains, largest first, only if they fit entirely
    for numa_id in sorted(by_numa, key=lambda n: -len(by_numa[n])):
        cpus = by_numa[numa_id]
        if len(cpus) <= need:
            taken.update(cpus)
            need -= len(cpus)
            by_numa[numa_id] = []
    if need > 0:
        # fill the remainder from the fullest remaining domain
        for numa_id in sorted(by_numa, key=lambda n: -len(by_numa[n])):
            cpus = sorted(by_numa[numa_id])[:need]
            taken.update(cpus)
            need -= len(cpus)
            if need == 0:
                break
    return taken if need == 0 else None


class CpuManagerProvider:
    """cpumanager hint provider (cpu_mng.go:40-170)."""

    def name(self) -> str:
        return "cpuMng"

    def get_topology_hints(self, task, topo: NumatopoInfo,
                           res_numa_sets: ResNumaSets) -> Optional[Dict[str, List[TopologyHint]]]:
        request = guaranteed_cpus(task)
        if request == 0:
            return None
        available = set(res_numa_sets.get(CPU, set()))
        # honour reserved CPUs (cpu_mng.go:128-140)
        reserved_mcpu = topo.res_reserved.get(CPU, 0.0)
        if reserved_mcpu:
            n_reserved = int(math.ceil(reserved_mcpu / 1000.0))
            reserved = take_by_topology(topo, set(topo.cpu_detail), n_reserved)
            if reserved:
                available -= reserved
        return {CPU: self._generate_hints(topo, available, request)}

    @staticmethod
    def _generate_hints(topo: NumatopoInfo, available: Set[int],
                        request: int) -> List[TopologyHint]:
        """cpu_mng.go generateCPUTopologyHints: a hint per NUMA combination
        with enough available CPUs; preferred iff the combination is of the
        minimal size that could ever satisfy the request."""
        numa_ids = topo.numa_nodes()
        min_affinity = len(numa_ids)
        hints: List[TopologyHint] = []
        for mask in iterate_bitmasks(numa_ids):
            in_mask = topo.cpus_in_numa_nodes(mask)
            if len(in_mask) >= request and mask_count(mask) < min_affinity:
                min_affinity = mask_count(mask)
            if len(available & in_mask) < request:
                continue
            hints.append(TopologyHint(mask, False))
        for hint in hints:
            if mask_count(hint.affinity) == min_affinity:
                hint.preferred = True
        return hints

    def allocate(self, task, best_hint: TopologyHint, topo: NumatopoInfo,
                 res_numa_sets: ResNumaSets) -> Dict[str, Set[int]]:
        """cpu_mng.go Allocate — take CPUs inside the chosen affinity."""
        request = guaranteed_cpus(task)
        if request == 0:
            return {}
        available = set(res_numa_sets.get(CPU, set()))
        if best_hint.affinity is not None:
            in_mask = topo.cpus_in_numa_nodes(best_hint.affinity)
            preferred = available & in_mask
            if len(preferred) >= request:
                available = preferred
        taken = take_by_topology(topo, available, request)
        return {CPU: taken} if taken else {}


class NumaAwarePlugin(Plugin):
    NAME = PLUGIN_NAME

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.weight = self.arguments.get_int("weight", 1)
        self.providers = [CpuManagerProvider()]
        # map[task uid][node name] -> ResNumaSets (numaaware.go assignRes)
        self.assign_res: Dict[str, Dict[str, ResNumaSets]] = {}
        self.task_bind_node: Dict[str, str] = {}
        self.node_res_sets: Dict[str, ResNumaSets] = {}

    # -- policy gate (numaaware.go filterNodeByPolicy:185-224) --------------

    def _filter_node_by_policy(self, task, node) -> Optional[str]:
        """Returns an error string when the node must be rejected, "skip"
        semantics via the special value ``"abstain"`` when the plugin has
        nothing to do on this node, None when topology processing should
        proceed."""
        topo = node.numa_info
        policy = task.topology_policy
        if policy and policy != "none":
            if topo is None:
                return "numa info is empty"
            if topo.policies.get(CPU_MANAGER_POLICY) != "static":
                return "cpu manager policy isn't static"
            if policy != topo.policies.get(TOPOLOGY_MANAGER_POLICY):
                return (f"task topology policy[{policy}] is different with "
                        f"node[{topo.policies.get(TOPOLOGY_MANAGER_POLICY)}]")
            if node.name not in self.node_res_sets:
                return "no topo information"
            if not self.node_res_sets[node.name].get(CPU):
                return "cpu allocatable map is empty"
            return None
        # tasks without a policy: only account on static+managed nodes
        if topo is None or topo.policies.get(CPU_MANAGER_POLICY) != "static":
            return "abstain"
        if topo.policies.get(TOPOLOGY_MANAGER_POLICY, "none") in ("", "none"):
            return "abstain"
        return None

    # -- session wiring ------------------------------------------------------

    def on_session_open(self, ssn) -> None:
        numa_nodes = generate_numa_nodes(ssn.nodes)
        self.node_res_sets = generate_node_res_numa_sets(ssn.nodes)

        def _reallocate_live(task, node_sets) -> Dict[str, Set[int]]:
            """Re-derive the task's cpusets against the LIVE per-session
            sets. The predicate computed assign_res from a pre-placement
            snapshot; a batched solve (the device engines) may have placed a
            sibling on the node since, so stale assignments could overlap."""
            node = ssn.nodes.get(task.node_name)
            if node is None or node.numa_info is None:
                return {}
            topo = node.numa_info
            hints = [p.get_topology_hints(task, topo, node_sets)
                     for p in self.providers]
            best_hint, admit = get_policy(topo).predicate(hints)
            if not admit:
                return {}
            out: Dict[str, Set[int]] = {}
            remaining = res_sets_clone(node_sets)
            for provider in self.providers:
                for res, assign in provider.allocate(
                        task, best_hint, topo, remaining).items():
                    out[res] = out.get(res, set()) | assign
                    remaining[res] -= assign
            return out

        def on_allocate(event):
            task = event.task
            if not hasattr(task, "uid"):    # aggregated order-sim event
                return
            per_node = self.assign_res.get(task.uid)
            if not per_node or task.node_name not in per_node:
                return
            node_sets = self.node_res_sets.get(task.node_name)
            if node_sets is None:
                return
            assigned = per_node[task.node_name]
            stale = any(ids - node_sets.get(res, set())
                        for res, ids in assigned.items())
            if stale:
                assigned = _reallocate_live(task, node_sets)
                per_node[task.node_name] = assigned
                if not assigned:
                    return
            res_sets_allocate(node_sets, assigned)
            self.task_bind_node[task.uid] = task.node_name

        def on_deallocate(event):
            task = event.task
            if not hasattr(task, "uid"):
                return
            per_node = self.assign_res.get(task.uid)
            if not per_node or task.node_name not in per_node:
                return
            node_sets = self.node_res_sets.get(task.node_name)
            if node_sets is None:
                return
            if self.task_bind_node.pop(task.uid, None) is None:
                return      # nothing was subtracted for this task
            res_sets_release(node_sets, per_node[task.node_name])

        ssn.add_event_handler(EventHandler(allocate_func=on_allocate,
                                           deallocate_func=on_deallocate))

        def evaluate(task, node):
            """(None, None) when the plugin has nothing to do on the pair,
            (reason, None) when it rejects it, (None, cpusets) when it
            admits it. Reads the task's whole-CPU count and topology policy
            only, and the node's live sets."""
            if guaranteed_cpus(task) == 0:
                # not a Guaranteed whole-CPU pod (numaaware.go:116)
                return None, None
            verdict = self._filter_node_by_policy(task, node)
            if verdict == "abstain":
                return None, None
            if verdict is not None:
                return f"numa-aware: {verdict}", None
            topo = node.numa_info
            res_numa_sets = res_sets_clone(self.node_res_sets[node.name])
            task_policy = get_policy(topo)
            all_assign: Dict[str, Set[int]] = {}
            providers_hints = [p.get_topology_hints(task, topo, res_numa_sets)
                               for p in self.providers]
            best_hint, admit = task_policy.predicate(providers_hints)
            if not admit:
                return (f"plugin {self.NAME} predicates failed for task "
                        f"{task.name} on node {node.name}"), None
            for provider in self.providers:
                for res, assign in provider.allocate(
                        task, best_hint, topo, res_numa_sets).items():
                    all_assign[res] = all_assign.get(res, set()) | assign
                    res_numa_sets[res] -= assign
            return None, all_assign

        def predicate(task, node) -> None:
            reason, all_assign = evaluate(task, node)
            if reason is not None:
                from .predicates import PredicateError
                raise PredicateError(task, node, reason)
            if all_assign is not None:
                self.assign_res.setdefault(task.uid, {})[node.name] = \
                    all_assign

        ssn.add_predicate_fn(self.NAME, predicate)
        if self.node_res_sets:
            # cpusets shrink as siblings allocate: device proposals must be
            # re-validated through predicate_fn at replay time
            ssn.stateful_predicates.add(self.NAME)

        def feasibility(ssn_, tasks, node_t):
            """Tensor-path mirror of the predicate: bool[T,N] mask for the
            device engines (None when no task/node pair is NUMA-relevant).
            The predicate reads of a task only its whole-CPU count and
            topology policy, and no set changes during the pass, so each
            (count, policy, node) is evaluated once; every admitted pair
            records its own copy of the cpusets, as the predicate would."""
            if not self.node_res_sets:
                return None
            relevant = [i for i, t in enumerate(tasks)
                        if guaranteed_cpus(t) > 0]
            if not relevant:
                return None
            import numpy as np
            from ..cache.snapshot import node_infos_for
            node_infos = node_infos_for(ssn_, node_t)
            mask = np.ones((len(tasks), len(node_infos)), dtype=bool)
            memo: Dict[tuple, tuple] = {}
            for ti in relevant:
                task = tasks[ti]
                kind = (guaranteed_cpus(task), task.topology_policy)
                for ni, node in enumerate(node_infos):
                    got = memo.get((kind, ni))
                    if got is None:
                        got = memo[(kind, ni)] = evaluate(task, node)
                    reason, all_assign = got
                    if reason is not None:
                        mask[ti, ni] = False
                    elif all_assign is not None:
                        self.assign_res.setdefault(task.uid, {})[
                            node.name] = {res: set(ids) for res, ids
                                          in all_assign.items()}
            return mask

        ssn.add_feasibility_fn(self.NAME, feasibility)

        def batch_node_order(task, nodes) -> Dict[str, float]:
            """Fewest NUMA domains touched wins (numaaware.go:158-183)."""
            scores: Dict[str, float] = {}
            if not task.topology_policy or task.topology_policy == "none":
                return scores
            per_node = self.assign_res.get(task.uid)
            if not per_node:
                return scores
            raw: Dict[str, int] = {}
            for node in nodes:
                assigned = per_node.get(node.name, {}).get(CPU)
                if assigned is None or node.numa_info is None:
                    continue
                numa_ids = {node.numa_info.cpu_detail[c].numa_id
                            for c in assigned
                            if c in node.numa_info.cpu_detail}
                raw[node.name] = len(numa_ids)
            normalized = normalize_score(MAX_NODE_SCORE, True, raw)
            return {name: float(score * self.weight)
                    for name, score in normalized.items()}

        ssn.add_batch_node_order_fn(self.NAME, batch_node_order)

    def on_session_close(self, ssn) -> None:
        """Writeback: commit cpusets of tasks that were bound this session
        (numaaware.go OnSessionClose:255-284)."""
        if not self.task_bind_node:
            return
        numa_sets: Dict[str, Dict[str, ResNumaSets]] = {}
        for task_uid, node_name in self.task_bind_node.items():
            assigned = self.assign_res.get(task_uid, {}).get(node_name)
            if not assigned:
                continue
            numa_sets.setdefault(node_name, {})[task_uid] = assigned
        if numa_sets:
            ssn.update_scheduler_numa_info(numa_sets)


def New(arguments):
    return NumaAwarePlugin(arguments)
