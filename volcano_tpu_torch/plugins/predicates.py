"""Predicates plugin: hard feasibility filters.

Mirrors pkg/scheduler/plugins/predicates/predicates.go:80-362 (task-count
limit, node-unschedulable, node affinity/selector, taints, host ports, pod
affinity, the optional GPU-sharing predicate gpu.go:1-56, the proportional
scarce-resource guard proportional.go:1-44, the predicate cache
cache.go:1-88). Every filter contributes to one ``bool[T,N]`` feasibility
mask so the placement kernel never calls back to the host; the host
PredicateFn serves preempt, reclaim and backfill. Resource fit and the pod
count are checked in-kernel, because they depend on mutable node state.

Host ports, GPU card packing, the proportional guard and pod affinity make
the plugin stateful: each placement changes what they read, so the
allocate replay re-checks the solve's proposals through predicate_fn and
re-solves what it rejects (actions/allocate.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..api import FitError
from ..api.device_info import (devices_idle_matrix, gpu_memory_of_task,
                               predicate_gpu)
from ..api.types import (NODE_AFFINITY_FAILED, NODE_POD_NUMBER_EXCEEDED,
                         NODE_PORTS_FAILED, NODE_UNSCHEDULABLE,
                         TAINTS_UNTOLERATED)
from ..cache.snapshot import node_infos_for
from .base import Plugin
from .nodeorder import _toleration_matches, match_node_selector_terms
from .podaffinity import get_pod_affinity_index, session_has_pod_affinity

GPU_SHARING_FAILED = "node(s) didn't have a gpu card with enough memory"
PROPORTIONAL_FAILED = "proportional resource check failed"
POD_AFFINITY_FAILED = "pod affinity/anti-affinity check failed"


def node_selector_ok(task, node) -> bool:
    for k, v in task.node_selector.items():
        if node.labels.get(k) != v:
            return False
    required = (task.affinity.get("nodeAffinity", {})
                .get("requiredDuringSchedulingIgnoredDuringExecution"))
    if required:
        terms = required.get("nodeSelectorTerms", []) or []
        if not match_node_selector_terms(node.labels, terms):
            return False
    return True


def taints_tolerated(task, node) -> bool:
    """NoSchedule/NoExecute taints must be tolerated (PreferNoSchedule is
    scoring-only)."""
    for taint in node.taints:
        if taint.get("effect") in ("NoSchedule", "NoExecute"):
            if not any(_toleration_matches(tol, taint)
                       for tol in task.tolerations):
                return False
    return True


def proportional_ok(task, node, rates: Dict[str, Tuple[float, float]]) -> bool:
    """predicates/proportional.go checkNodeResourceIsProportional — refuse
    placements that would starve the CPU/memory needed to drive the node's
    idle scarce resource (e.g. GPUs). ``rates`` maps resource name ->
    (milli-cpu per unit, bytes per unit)."""
    for rname in rates:
        if task.resreq.get(rname) > 0:
            return True
    for rname, (cpu_rate, mem_rate) in rates.items():
        idle_scalar = node.idle.get(rname)
        if idle_scalar <= 0:
            continue
        units = idle_scalar / 1000.0        # scalars are stored milli-scaled
        cpu_reserved = units * cpu_rate
        mem_reserved = units * mem_rate
        remaining_cpu = node.idle.cpu - task.resreq.cpu
        remaining_mem = node.idle.memory - task.resreq.memory
        if remaining_cpu < cpu_reserved or remaining_mem < mem_reserved:
            return False
    return True


class PredicatesPlugin(Plugin):
    NAME = "predicates"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        args = self.arguments
        self.node_affinity_enable = args.get_bool("predicate.NodeAffinityEnable", True)
        self.taint_enable = args.get_bool("predicate.TaintTolerationEnable", True)
        self.pod_number_enable = args.get_bool("predicate.PodNumberEnable", True)
        # optional sub-predicates (predicates.go:88-110), off by default
        self.gpu_sharing_enable = args.get_bool("predicate.GPUSharingEnable", False)
        self.cache_enable = args.get_bool("predicate.CacheEnable", False)
        self.proportional_enable = args.get_bool("predicate.ProportionalEnable", False)
        # predicate.proportional.resources: "nvidia.com/gpu" with .cpu
        # (cores a unit) and .memory (GiB a unit) sub-keys, kept as milli-cpu
        # and bytes a unit (proportional.go rates)
        self.proportional: Dict[str, Tuple[float, float]] = {}
        for rname in str(args.get("predicate.proportional.resources", "")).split(","):
            rname = rname.strip()
            if rname:
                cpu_rate = args.get_float(f"predicate.proportional.resources.{rname}.cpu", 0.0)
                mem_rate = args.get_float(f"predicate.proportional.resources.{rname}.memory", 0.0)
                self.proportional[rname] = (cpu_rate * 1000.0,
                                            mem_rate * 1024 ** 3)
        # per-session predicate cache: (node, task equivalence sig) -> reason
        # or True (predicates/cache.go PredicateWithCache)
        self._cache: Dict[Tuple[str, Tuple], object] = {}
        self._ssn = None

    @staticmethod
    def _task_signature(task) -> Tuple:
        """Equivalence class of a task for predicate caching — only what the
        cacheable (node-static) predicates read. The GPU-share, proportional,
        host-port and pod-affinity checks read mutable state and are never
        cached."""
        return (tuple(sorted(task.node_selector.items())),
                repr(task.affinity) if task.affinity else "",
                tuple(repr(t) for t in task.tolerations))

    def predicate(self, task, node) -> None:
        if self.pod_number_enable and node.max_task_num:
            if len(node.tasks) >= node.max_task_num:
                raise PredicateError(task, node, NODE_POD_NUMBER_EXCEEDED)
        if node.unschedulable:
            raise PredicateError(task, node, NODE_UNSCHEDULABLE)
        # InterPodAffinity filter (predicates.go:330-338): required terms
        # plus existing pods' symmetric anti-affinity, over the live index
        if self._ssn is not None and session_has_pod_affinity(self._ssn):
            idx = get_pod_affinity_index(self._ssn)
            ni = idx.node_index.get(node.name)
            if ni is not None and not idx.node_ok(task, ni):
                raise PredicateError(task, node, POD_AFFINITY_FAILED)
        if self.cache_enable:
            key = (node.name, self._task_signature(task))
            cached = self._cache.get(key)
            if cached is None:
                try:
                    self._static_predicates(task, node)
                except PredicateError as err:
                    self._cache[key] = err.fit_error.reasons[0]
                    raise
                self._cache[key] = True
            elif cached is not True:
                raise PredicateError(task, node, cached)
        else:
            self._static_predicates(task, node)
        self._stateful_predicates(task, node)

    def _static_predicates(self, task, node) -> None:
        """Predicates over immutable node/task attributes — safe to cache."""
        if self.node_affinity_enable and not node_selector_ok(task, node):
            raise PredicateError(task, node, NODE_AFFINITY_FAILED)
        if self.taint_enable and not taints_tolerated(task, node):
            raise PredicateError(task, node, TAINTS_UNTOLERATED)

    def _stateful_predicates(self, task, node) -> None:
        """Predicates over mutable node usage — evaluated every call."""
        # NodePorts (predicates.go:321 nodePortFilter.Filter): hostPort
        # claims change as the cycle allocates, so never cached
        if node.has_port_conflict(task):
            raise PredicateError(task, node, NODE_PORTS_FAILED)
        if self.gpu_sharing_enable and gpu_memory_of_task(task) > 0:
            # gpu.go checkNodeGPUSharingPredicate: some single card must fit
            if not node.gpu_devices or predicate_gpu(task, node.gpu_devices) is None:
                raise PredicateError(task, node, GPU_SHARING_FAILED)
        if self.proportional_enable and self.proportional:
            if not proportional_ok(task, node, self.proportional):
                raise PredicateError(task, node, PROPORTIONAL_FAILED)

    def feasibility_mask(self, ssn, tasks, node_t):
        node_infos = node_infos_for(ssn, node_t)
        T, N = len(tasks), len(node_infos)
        any_taints = any(n.taints for n in node_infos)
        any_unsched = any(n.unschedulable for n in node_infos)
        gpu_reqs = None
        if self.gpu_sharing_enable:
            gpu_reqs = np.asarray([gpu_memory_of_task(t) for t in tasks],
                                  np.float32)
            if not gpu_reqs.any():
                gpu_reqs = None
        prop_needed = bool(self.proportional_enable and self.proportional)
        pod_aff = session_has_pod_affinity(ssn)
        any_ports = any(t.host_ports for t in tasks)
        if (not any_taints and not any_unsched and gpu_reqs is None
                and not prop_needed and not pod_aff and not any_ports
                and not any(t.node_selector or t.affinity for t in tasks)):
            return None                                  # all-true mask
        mask = np.ones((T, N), dtype=bool)
        if any_ports:
            for ni, node in enumerate(node_infos):
                if not node.used_ports:
                    continue
                for ti, task in enumerate(tasks):
                    if task.host_ports and node.has_port_conflict(task):
                        mask[ti, ni] = False
        if pod_aff:
            idx = get_pod_affinity_index(ssn)
            for ti, task in enumerate(tasks):
                row = idx.node_mask_cached(task)
                if row is not None:
                    mask[ti] &= row
        sched = np.asarray([not n.unschedulable for n in node_infos], bool)
        mask &= sched[None, :]
        # the static predicates read only what _task_signature keys on, and
        # the tasks of a gang share it: each group's row is computed once
        groups: Dict[Tuple, list] = {}
        for ti, task in enumerate(tasks):
            if not task.node_selector and not task.affinity and not any_taints:
                continue
            groups.setdefault(self._task_signature(task),
                              [task, []])[1].append(ti)
        for task, rows in groups.values():
            ok = np.fromiter(
                ((not self.node_affinity_enable
                  or node_selector_ok(task, node))
                 and (not self.taint_enable or taints_tolerated(task, node))
                 for node in node_infos), bool, N)
            mask[np.asarray(rows)] &= ok
        if gpu_reqs is not None:
            # feasible iff the node's best card fits the request (gpu.go)
            best_card = devices_idle_matrix(node_infos).max(axis=1)  # f32[N]
            gpu_mask = (gpu_reqs[:, None] <= 0) | \
                (best_card[None, :] >= gpu_reqs[:, None])
            mask &= gpu_mask
        if prop_needed:
            for ni, node in enumerate(node_infos):
                for ti, task in enumerate(tasks):
                    if mask[ti, ni] and not proportional_ok(
                            task, node, self.proportional):
                        mask[ti, ni] = False
        return mask

    def on_session_open(self, ssn) -> None:
        self._cache = {}
        self._ssn = ssn
        ssn.add_predicate_fn(self.NAME, self.predicate)
        ssn.add_feasibility_fn(self.NAME, self.feasibility_mask)
        if self.gpu_sharing_enable or (self.proportional_enable
                                       and self.proportional):
            # card packing and idle ratios change as the cycle allocates:
            # the static feasibility mask is necessary but not sufficient,
            # so batched engines re-check proposals through predicate_fn
            ssn.stateful_predicates.add(self.NAME)
        if session_has_pod_affinity(ssn):
            # in-cycle placements change the existing-pod set the affinity
            # terms match against
            ssn.stateful_predicates.add(self.NAME)
        if any(t.host_ports
               for job in ssn.jobs.values() for t in job.tasks.values()):
            # each in-cycle placement claims its hostPorts on the node, so
            # batched proposals must be re-checked through predicate_fn
            ssn.stateful_predicates.add(self.NAME)


class PredicateError(ValueError):
    def __init__(self, task, node, reason: str):
        super().__init__(f"task {task.key()} on node {node.name}: {reason}")
        self.fit_error = FitError(task, node, [reason])


def New(arguments):
    return PredicatesPlugin(arguments)
