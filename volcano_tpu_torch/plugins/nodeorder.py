"""Nodeorder plugin: the k8s score-plugin wrap.

Mirrors pkg/scheduler/plugins/nodeorder/nodeorder.go:71-412 —
LeastAllocated/MostAllocated/BalancedAllocation as weights of the in-kernel
dynamic scorers, and the preference terms that are static per session
(preferred node affinity, PreferNoSchedule taint toleration) as a static
score matrix for the device solve; and the same terms as host scorers
(``_score``, ``_batch_score``) for preempt. The pod-affinity score term is not in
this package yet: a session where any task carries pod affinity is refused.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..cache.snapshot import node_infos_for
from .base import Plugin

MAX_NODE_SCORE = 100.0


def _match_expr(labels, expr) -> bool:
    key, op = expr.get("key"), expr.get("operator", "In")
    values = expr.get("values", []) or []
    has = key in labels
    val = labels.get(key)
    if op == "In":
        return has and val in values
    if op == "NotIn":
        return not has or val not in values
    if op == "Exists":
        return has
    if op == "DoesNotExist":
        return not has
    if op == "Gt":
        return has and float(val) > float(values[0])
    if op == "Lt":
        return has and float(val) < float(values[0])
    return False


def match_node_selector_terms(labels, terms) -> bool:
    """OR over terms, AND over matchExpressions within a term."""
    if not terms:
        return True
    for term in terms:
        exprs = term.get("matchExpressions", []) or []
        if all(_match_expr(labels, e) for e in exprs):
            return True
    return False


def node_affinity_preferred_score(task, node) -> float:
    """Sum of matching preferredDuringScheduling term weights."""
    preferred = (task.affinity.get("nodeAffinity", {})
                 .get("preferredDuringSchedulingIgnoredDuringExecution", []))
    score = 0.0
    for pref in preferred or []:
        term = pref.get("preference", {})
        if match_node_selector_terms(node.labels, [term]):
            score += float(pref.get("weight", 0))
    return score


def taint_toleration_score(tolerations, node) -> float:
    """Fraction of PreferNoSchedule taints tolerated, scaled to 100
    (k8s tainttoleration scoring wrapped at nodeorder.go:269-310)."""
    prefer = [t for t in node.taints if t.get("effect") == "PreferNoSchedule"]
    if not prefer:
        return MAX_NODE_SCORE
    intolerable = 0
    for taint in prefer:
        if not any(_toleration_matches(tol, taint) for tol in tolerations):
            intolerable += 1
    return (1.0 - intolerable / len(prefer)) * MAX_NODE_SCORE


def _toleration_matches(tol, taint) -> bool:
    if tol.get("effect") and tol.get("effect") != taint.get("effect"):
        return False
    op = tol.get("operator", "Equal")
    if op == "Exists":
        return not tol.get("key") or tol.get("key") == taint.get("key")
    return (tol.get("key") == taint.get("key")
            and tol.get("value", "") == taint.get("value", ""))


def _tolerations_key(tolerations) -> tuple:
    return tuple(tuple(sorted(tol.items())) for tol in tolerations)


class NodeOrderPlugin(Plugin):
    NAME = "nodeorder"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        args = self.arguments
        self.node_affinity_weight = args.get_int("nodeaffinity.weight", 1)
        self.pod_affinity_weight = args.get_int("podaffinity.weight", 1)
        self.least_req_weight = args.get_int("leastrequested.weight", 1)
        self.most_req_weight = args.get_int("mostrequested.weight", 0)
        self.balanced_weight = args.get_int("balancedresource.weight", 1)
        self.taint_toleration_weight = args.get_int("tainttoleration.weight", 1)

    # host-path per-(task, node) scorers: preempt's callbacks rung and its
    # f64 rank replica (actions/evict_tpu.py) read these
    def _score(self, task, node) -> float:
        score = 0.0
        alloc_c, alloc_m = node.allocatable.cpu, node.allocatable.memory
        used_c = node.used.cpu + task.resreq.cpu
        used_m = node.used.memory + task.resreq.memory
        if self.least_req_weight:
            frac_c = max(0.0, (alloc_c - used_c) / alloc_c) if alloc_c else 0.0
            frac_m = max(0.0, (alloc_m - used_m) / alloc_m) if alloc_m else 0.0
            score += self.least_req_weight * (frac_c + frac_m) / 2 * MAX_NODE_SCORE
        if self.most_req_weight:
            frac_c = used_c / alloc_c if alloc_c else 0.0
            frac_m = used_m / alloc_m if alloc_m else 0.0
            frac_c = 0.0 if frac_c > 1 else frac_c
            frac_m = 0.0 if frac_m > 1 else frac_m
            score += self.most_req_weight * (frac_c + frac_m) / 2 * MAX_NODE_SCORE
        if self.balanced_weight:
            frac_c = min(1.0, used_c / alloc_c) if alloc_c else 0.0
            frac_m = min(1.0, used_m / alloc_m) if alloc_m else 0.0
            mean = (frac_c + frac_m) / 2
            std = (((frac_c - mean) ** 2 + (frac_m - mean) ** 2) / 2) ** 0.5
            score += self.balanced_weight * (1.0 - std) * MAX_NODE_SCORE
        if self.node_affinity_weight:
            score += self.node_affinity_weight * node_affinity_preferred_score(task, node)
        return score

    def _batch_score(self, task, nodes):
        out = {}
        if self.taint_toleration_weight:
            for n in nodes:
                out[n.name] = self.taint_toleration_weight * \
                    taint_toleration_score(task.tolerations, n)
        return out

    def _static_matrix(self, ssn, tasks, node_t):
        """The device path's static score matrix (preference terms only),
        or None when it would add the same constant to every node of a
        task — no effect on node choice, so the solve skips the [T,N]
        matrix entirely."""
        nodes = node_infos_for(ssn, node_t)
        T, N = len(tasks), len(nodes)
        tainted = [(ni, n) for ni, n in enumerate(nodes)
                   if any(t.get("effect") == "PreferNoSchedule"
                          for t in n.taints)]
        prefs = [(ti, t) for ti, t in enumerate(tasks)
                 if (t.affinity.get("nodeAffinity", {})
                     .get("preferredDuringSchedulingIgnoredDuringExecution"))]
        if not tainted and not prefs:
            return None
        score = np.zeros((T, N), np.float32)
        if self.taint_toleration_weight:
            score += self.taint_toleration_weight * MAX_NODE_SCORE
            # the taint score depends only on (tolerations, node taints):
            # tasks of one gang share tolerations, so group them
            groups: Dict[tuple, list] = {}
            for ti, task in enumerate(tasks):
                groups.setdefault(_tolerations_key(task.tolerations),
                                  [task.tolerations, []])[1].append(ti)
            for tolerations, rows in groups.values():
                rows = np.asarray(rows)
                for ni, node in tainted:
                    score[rows, ni] = self.taint_toleration_weight * \
                        taint_toleration_score(tolerations, node)
        if self.node_affinity_weight:
            for ti, task in prefs:
                for ni, node in enumerate(nodes):
                    score[ti, ni] += self.node_affinity_weight * \
                        node_affinity_preferred_score(task, node)
        return score

    def on_session_open(self, ssn) -> None:
        if self.pod_affinity_weight and (
                any(t.has_pod_affinity for job in ssn.jobs.values()
                    for t in job.tasks.values())
                or any(t.has_pod_affinity for node in ssn.nodes.values()
                       for t in node.tasks.values())):
            raise NotImplementedError(
                "nodeorder: the pod-affinity score term is not in "
                "volcano_tpu_torch yet, and a task carries pod affinity")
        ssn.add_node_order_fn(self.NAME, self._score)
        ssn.add_batch_node_order_fn(self.NAME, self._batch_score)
        ssn.set_dynamic_score_weights(
            self.NAME,
            least_req_weight=float(self.least_req_weight),
            most_req_weight=float(self.most_req_weight),
            balanced_weight=float(self.balanced_weight))
        ssn.add_static_score_fn(self.NAME, self._static_matrix)


def New(arguments):
    return NodeOrderPlugin(arguments)
