"""Predicates plugin: hard feasibility filters.

Mirrors pkg/scheduler/plugins/predicates/predicates.go:80-362 (task-count
limit, node-unschedulable, node affinity/selector, taints, host ports, the
predicate cache cache.go:1-88). Every static filter contributes to one
``bool[T,N]`` feasibility mask (assembled in cache/snapshot.py) so the
placement kernels never call back to the host; the host PredicateFn serves
preempt, reclaim and backfill. Resource fit and the pod count are checked
in-kernel, because they depend on mutable node state.

Host ports make the plugin stateful: each placement claims its ports on the
node, so the allocate replay re-checks the solve's proposals through
predicate_fn. The GPU-sharing and proportional sub-predicates need the
device-card model (api/device_info.py), which this package does not have:
a conf enabling either is refused by argument name, as is a session where a
task carries pod affinity.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..api import FitError
from ..api.types import (NODE_AFFINITY_FAILED, NODE_POD_NUMBER_EXCEEDED,
                         NODE_PORTS_FAILED, NODE_UNSCHEDULABLE,
                         TAINTS_UNTOLERATED)
from ..cache.snapshot import node_infos_for
from .base import Plugin
from .nodeorder import _toleration_matches, match_node_selector_terms

REFUSED_ARGUMENTS = ("predicate.GPUSharingEnable",
                     "predicate.ProportionalEnable")


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


class PredicatesPlugin(Plugin):
    NAME = "predicates"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        args = self.arguments
        for key in REFUSED_ARGUMENTS:
            if args.get_bool(key, False):
                raise ValueError(
                    f"predicates: {key} needs the device-card model, which "
                    f"is not in volcano_tpu_torch yet")
        self.node_affinity_enable = args.get_bool("predicate.NodeAffinityEnable", True)
        self.taint_enable = args.get_bool("predicate.TaintTolerationEnable", True)
        self.pod_number_enable = args.get_bool("predicate.PodNumberEnable", True)
        self.cache_enable = args.get_bool("predicate.CacheEnable", False)
        # per-session predicate cache: (node, task equivalence sig) -> reason
        # or True (predicates/cache.go PredicateWithCache)
        self._cache: Dict[Tuple[str, Tuple], object] = {}

    @staticmethod
    def _task_signature(task) -> Tuple:
        """Equivalence class of a task for predicate caching — only what the
        cacheable (node-static) predicates read."""
        return (tuple(sorted(task.node_selector.items())),
                repr(task.affinity) if task.affinity else "",
                tuple(repr(t) for t in task.tolerations))

    def predicate(self, task, node) -> None:
        if self.pod_number_enable and node.max_task_num:
            if len(node.tasks) >= node.max_task_num:
                raise PredicateError(task, node, NODE_POD_NUMBER_EXCEEDED)
        if node.unschedulable:
            raise PredicateError(task, node, NODE_UNSCHEDULABLE)
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
        # NodePorts (predicates.go:321 nodePortFilter.Filter): hostPort
        # claims change as the cycle allocates, so never cached
        if node.has_port_conflict(task):
            raise PredicateError(task, node, NODE_PORTS_FAILED)

    def _static_predicates(self, task, node) -> None:
        """Predicates over immutable node/task attributes — safe to cache."""
        if self.node_affinity_enable and not node_selector_ok(task, node):
            raise PredicateError(task, node, NODE_AFFINITY_FAILED)
        if self.taint_enable and not taints_tolerated(task, node):
            raise PredicateError(task, node, TAINTS_UNTOLERATED)

    def feasibility_mask(self, ssn, tasks, node_t):
        node_infos = node_infos_for(ssn, node_t)
        T, N = len(tasks), len(node_infos)
        any_taints = any(n.taints for n in node_infos)
        any_unsched = any(n.unschedulable for n in node_infos)
        any_ports = any(t.host_ports for t in tasks)
        if (not any_taints and not any_unsched and not any_ports
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
        return mask

    def on_session_open(self, ssn) -> None:
        if (any(t.has_pod_affinity for job in ssn.jobs.values()
                for t in job.tasks.values())
                or any(t.has_pod_affinity for node in ssn.nodes.values()
                       for t in node.tasks.values())):
            raise NotImplementedError(
                "predicates: the pod-affinity filter is not in "
                "volcano_tpu_torch yet, and a task carries pod affinity")
        self._cache = {}
        ssn.add_predicate_fn(self.NAME, self.predicate)
        ssn.add_feasibility_fn(self.NAME, self.feasibility_mask)
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
