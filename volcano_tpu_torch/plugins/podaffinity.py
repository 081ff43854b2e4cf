"""Inter-pod affinity and anti-affinity as per-domain counts.

Mirrors the k8s InterPodAffinity filter the reference's predicates plugin
runs (pkg/scheduler/plugins/predicates/predicates.go:330-338) and its batch
scorer (nodeorder.go:269-340), with the JAX package's semantics
(volcano_tpu/plugins/podaffinity.py) decision for decision:

- nodes partition into topology DOMAINS per topologyKey; every term reduces
  to "how many matching existing pods live in this domain", broadcast to a
  node vector;
- required podAffinity terms AND-combine (with the upstream bootstrap: when
  no existing pod matches any of them and the pod matches all of its own,
  it may start the group anywhere), required podAntiAffinity terms and
  their SYMMETRIC form (an existing pod's anti-affinity that matches the
  incoming task) exclude domains; the result is a row of the ``bool[T,N]``
  feasibility mask the placement kernel (B1) reads;
- preferred terms, and the existing pods' preferred terms that match the
  task, give a raw ``f32[N]`` score row; nodeorder normalizes it to
  [0, 100] into the static score matrix.

The index keeps its counts up to date as the session allocates and
deallocates (an event handler that is not aggregatable, so the allocate
replay takes the Statement path), where the JAX package rescans every
existing pod for each query. The counts are integers and k8s term weights
are integers, so every count, mask and score row is exactly the rescan's.

A pod affinity spec is the k8s API's dict form:
  {"podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution":
       [{"labelSelector": {...}, "topologyKey": "...",
         "namespaces": [...]}, ...],
    "preferredDuringSchedulingIgnoredDuringExecution":
       [{"weight": W, "podAffinityTerm": {...}}, ...]},
   "podAntiAffinity": {...same...}}
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

REQUIRED = "requiredDuringSchedulingIgnoredDuringExecution"
PREFERRED = "preferredDuringSchedulingIgnoredDuringExecution"
MAX_NODE_SCORE = 100.0
DEFAULT_TOPOLOGY_KEY = "kubernetes.io/hostname"


def match_label_selector(selector: dict, labels: Dict[str, str]) -> bool:
    """k8s metav1.LabelSelector: matchLabels AND matchExpressions
    (In/NotIn/Exists/DoesNotExist)."""
    if not selector:
        return False
    for k, v in (selector.get("matchLabels") or {}).items():
        if labels.get(k) != v:
            return False
    for expr in selector.get("matchExpressions") or []:
        key = expr.get("key")
        op = expr.get("operator")
        values = expr.get("values") or []
        if op == "In":
            if labels.get(key) not in values:
                return False
        elif op == "NotIn":
            if labels.get(key) in values:
                return False
        elif op == "Exists":
            if key not in labels:
                return False
        elif op == "DoesNotExist":
            if key in labels:
                return False
        else:
            return False
    return True


def _term_namespaces(term: dict, own_namespace: str) -> List[str]:
    """A term with no namespaces list applies to the pod's own namespace."""
    return term.get("namespaces") or [own_namespace]


def _affinity_terms(task, kind: str, required: bool):
    section = (task.affinity or {}).get(kind) or {}
    return section.get(REQUIRED if required else PREFERRED) or []


class _Term:
    """One (selector, namespaces, topologyKey) triple: the unit the counts
    are kept for."""

    __slots__ = ("selector", "namespaces", "key", "sig")

    def __init__(self, term: dict, namespaces: List[str]):
        self.selector = term.get("labelSelector") or {}
        self.namespaces = frozenset(namespaces)
        self.key = term.get("topologyKey") or DEFAULT_TOPOLOGY_KEY
        self.sig = (repr(self.selector), tuple(sorted(self.namespaces)),
                    self.key)

    def matches(self, task) -> bool:
        return (task.namespace in self.namespaces
                and match_label_selector(self.selector, task.labels))


def _held_terms(task):
    """The terms an existing pod holds against others: (kind, term,
    signed weight) for its required anti-affinity (weight None) and its
    preferred affinity (+w) and anti-affinity (-w) terms."""
    out = []
    for term in _affinity_terms(task, "podAntiAffinity", True):
        out.append(("anti", _Term(term, _term_namespaces(term,
                                                         task.namespace)),
                    None))
    for kind, sign in (("podAffinity", 1.0), ("podAntiAffinity", -1.0)):
        for pref in _affinity_terms(task, kind, False):
            term = pref.get("podAffinityTerm") or {}
            out.append(("pref", _Term(term, _term_namespaces(
                term, task.namespace)), sign * float(pref.get("weight", 1))))
    return out


class PodAffinityIndex:
    """Per-session topology and pod index.

    ``existing`` is the pods on the session's nodes (running, placed in this
    cycle, ...), by uid: (task, node index) entries. Counts of matching
    existing pods are kept per queried term and domain, and the terms that
    existing pods hold against others (their required anti-affinity and
    preferred terms) per domain, all updated on each add and remove, so a
    query costs a few vector operations over the nodes. Live-updated through
    the session's allocate and deallocate events, so the host predicate sees
    in-cycle placements (the reference's EventHandler-fed k8s nodeMap,
    predicates.go:80-110)."""

    def __init__(self, nodes: List):
        self.nodes = nodes
        self.node_index = {n.name: i for i, n in enumerate(nodes)}
        self._domains: Dict[str, Tuple[np.ndarray, int]] = {}
        self.existing: Dict[str, List[Tuple[object, int]]] = {}
        # term sig -> (term, per-domain count of matching existing pods)
        self._counts: Dict[tuple, Tuple[_Term, np.ndarray]] = {}
        # (matchLabels key, value) -> sigs whose selector requires it; sigs
        # without matchLabels are checked against every pod
        self._by_label: Dict[tuple, List[tuple]] = {}
        self._unlabelled: List[tuple] = []
        # held terms: (kind, sig, weight) -> (term, per-domain holder count)
        self._held: Dict[tuple, Tuple[_Term, np.ndarray]] = {}
        # memos of node_mask and score_row, cleared on every add and remove:
        # by task uid, and by _group_key for tasks not on a node (a gang's
        # tasks share one)
        self._mask_cache: Dict[object, Optional[np.ndarray]] = {}
        self._row_cache: Dict[object, Optional[np.ndarray]] = {}
        for ni, node in enumerate(nodes):
            for t in node.tasks.values():
                self._add(t, ni)

    # -- bookkeeping -----------------------------------------------------

    def _add(self, task, ni: int, step: int = 1) -> None:
        if step > 0:
            self.existing.setdefault(task.uid, []).append((task, ni))
        for sig in self._candidate_sigs(task):
            term, counts = self._counts[sig]
            if term.matches(task):
                dom, _ = self.domains(term.key)
                counts[dom[ni]] += step
        if task.has_pod_affinity:
            for kind, term, w in _held_terms(task):
                key = (kind, term.sig, w)
                entry = self._held.get(key)
                if entry is None:
                    entry = self._held[key] = (
                        term, np.zeros(self.domains(term.key)[1], np.int64))
                dom, _ = self.domains(term.key)
                entry[1][dom[ni]] += step

    def _candidate_sigs(self, task):
        out = list(self._unlabelled)
        for item in task.labels.items():
            out.extend(self._by_label.get(item, ()))
        return out

    def add_pod(self, task) -> None:
        # order-simulation pseudo-events carry no placement
        ni = self.node_index.get(getattr(task, "node_name", None))
        if ni is not None:
            self._add(task, ni)
            self._mask_cache.clear()
            self._row_cache.clear()

    def remove_pod(self, task) -> None:
        uid = getattr(task, "uid", None)
        if uid is None:
            return
        for t, ni in self.existing.pop(uid, ()):
            self._add(t, ni, step=-1)
        self._mask_cache.clear()
        self._row_cache.clear()

    def _group_key(self, task):
        """What node_mask and score_row read of a task: its namespace,
        labels and affinity, and its uid only while it is itself an
        existing pod (its anti-affinity counts leave it out)."""
        if task.uid in self.existing:
            return task.uid
        return (task.namespace, repr(sorted(task.labels.items())),
                repr(task.affinity))

    def node_mask_cached(self, task) -> Optional[np.ndarray]:
        key = self._group_key(task)
        if key not in self._mask_cache:
            self._mask_cache[key] = self.node_mask(task)
        return self._mask_cache[key]

    def score_row_cached(self, task) -> Optional[np.ndarray]:
        key = self._group_key(task)
        if key not in self._row_cache:
            self._row_cache[key] = self.score_row(task)
        return self._row_cache[key]

    def node_ok(self, task, ni: int) -> bool:
        """``node_mask(task)[ni]``, True where the mask is None: the live
        re-check of each proposal."""
        mask = self.node_mask_cached(task)
        return mask is None or bool(mask[ni])

    def domains(self, key: str) -> Tuple[np.ndarray, int]:
        """(dom i32[N], n_domains): the node partition for a topologyKey.
        Nodes missing the label form their own singleton domains (a node
        without the topology label can never co-locate)."""
        cached = self._domains.get(key)
        if cached is not None:
            return cached
        values: Dict[str, int] = {}
        dom = np.zeros(len(self.nodes), np.int32)
        next_ix = 0
        for i, node in enumerate(self.nodes):
            val = node.labels.get(key)
            if val is None:
                dom[i] = next_ix
                next_ix += 1
            else:
                if val not in values:
                    values[val] = next_ix
                    next_ix += 1
                dom[i] = values[val]
        self._domains[key] = (dom, next_ix)
        return self._domains[key]

    def _domain_counts(self, term: _Term) -> np.ndarray:
        """Per-domain count of matching existing pods, kept from the first
        query on."""
        entry = self._counts.get(term.sig)
        if entry is None:
            dom, nd = self.domains(term.key)
            counts = np.zeros(nd, np.int64)
            for entries in self.existing.values():
                for t, ni in entries:
                    if term.matches(t):
                        counts[dom[ni]] += 1
            entry = self._counts[term.sig] = (term, counts)
            labels = term.selector.get("matchLabels") or {}
            if labels:
                item = next(iter(labels.items()))
                self._by_label.setdefault(item, []).append(term.sig)
            else:
                self._unlabelled.append(term.sig)
        return entry[1]

    def _term_node_counts(self, term: _Term,
                          exclude_uid: Optional[str] = None) -> np.ndarray:
        """Count of matching existing pods in each node's domain."""
        dom, _ = self.domains(term.key)
        counts = self._domain_counts(term)
        if exclude_uid is not None and exclude_uid in self.existing:
            counts = counts.copy()
            for t, ni in self.existing[exclude_uid]:
                if term.matches(t):
                    counts[dom[ni]] -= 1
        return counts[dom]

    # -- required terms -> feasibility -----------------------------------

    def node_mask(self, task) -> Optional[np.ndarray]:
        """bool[N] required-term feasibility for one task; None = all-true."""
        masks = []
        aff = [(term, _Term(term, _term_namespaces(term, task.namespace)))
               for term in _affinity_terms(task, "podAffinity", True)]
        counts = [self._term_node_counts(t) for _, t in aff]
        # k8s bootstrap allowance (upstream InterPodAffinity Filter): only
        # when no existing pod matches any required affinity term and the
        # pod matches all of its own terms may it start the group anywhere
        bootstrap = (bool(aff)
                     and all(not cnt.any() for cnt in counts)
                     and all(t.matches(task) for _, t in aff))
        if not bootstrap:
            for cnt in counts:
                masks.append(cnt > 0)
        for term in _affinity_terms(task, "podAntiAffinity", True):
            cnt = self._term_node_counts(
                _Term(term, _term_namespaces(term, task.namespace)),
                exclude_uid=task.uid)
            masks.append(cnt == 0)
        sym = self._symmetric_anti_mask(task)
        if sym is not None:
            masks.append(sym)
        if not masks:
            return None
        out = masks[0]
        for m in masks[1:]:
            out = out & m
        return out

    def _symmetric_anti_mask(self, task) -> Optional[np.ndarray]:
        """An existing pod's required anti-affinity term that matches this
        task excludes the pod's whole domain."""
        out = None
        for (kind, _, _), (term, holders) in self._held.items():
            if kind != "anti" or not holders.any() or not term.matches(task):
                continue
            dom, _ = self.domains(term.key)
            if out is None:
                out = np.ones(len(self.nodes), bool)
            out &= holders[dom] == 0
        return out

    # -- preferred terms -> scoring --------------------------------------

    def score_row(self, task) -> Optional[np.ndarray]:
        """f32[N] raw preferred-term score for one task; None when neither
        the task nor any existing pod contributes a term. Includes the k8s
        scorer's symmetric half: existing pods' preferred terms that match
        the incoming task attract or repel toward their own domains."""
        row = None
        for pref in _affinity_terms(task, "podAffinity", False):
            term = pref.get("podAffinityTerm") or {}
            w = float(pref.get("weight", 1))
            cnt = self._term_node_counts(
                _Term(term, _term_namespaces(term, task.namespace)))
            row = (row if row is not None else 0) + w * cnt
        for pref in _affinity_terms(task, "podAntiAffinity", False):
            term = pref.get("podAffinityTerm") or {}
            w = float(pref.get("weight", 1))
            cnt = self._term_node_counts(
                _Term(term, _term_namespaces(term, task.namespace)))
            row = (row if row is not None else 0) - w * cnt
        for (kind, _, w), (term, holders) in self._held.items():
            if kind != "pref" or not holders.any() or not term.matches(task):
                continue
            dom, _ = self.domains(term.key)
            row = (row if row is not None else 0) + w * holders[dom]
        if row is None:
            return None
        return np.asarray(row, np.float32)


def session_has_pod_affinity(ssn) -> bool:
    """True when any session task, or any pod already placed on a node,
    carries pod affinity or anti-affinity: every index is gated on it, so
    the common case costs one cached boolean."""
    flag = getattr(ssn, "_has_pod_affinity", None)
    if flag is None:
        flag = (any(t.has_pod_affinity for job in ssn.jobs.values()
                    for t in job.tasks.values())
                or any(t.has_pod_affinity for node in ssn.nodes.values()
                       for t in node.tasks.values()))
        ssn._has_pod_affinity = flag
    return flag


def get_pod_affinity_index(ssn) -> PodAffinityIndex:
    """The session's index, subscribed to its allocate and deallocate
    events. The handler is not aggregatable, so the allocate replay takes
    the Statement path whenever pod affinity is in play."""
    idx = getattr(ssn, "_pod_affinity_index", None)
    if idx is None:
        from ..framework.session import EventHandler
        idx = PodAffinityIndex(list(ssn.nodes.values()))
        ssn._pod_affinity_index = idx
        ssn.add_event_handler(EventHandler(
            allocate_func=lambda ev: idx.add_pod(ev.task),
            deallocate_func=lambda ev: idx.remove_pod(ev.task),
            aggregatable=False))
    return idx


def normalize_scores(row: np.ndarray) -> np.ndarray:
    """k8s defaultNormalizeScore over [0, 100] with negatives shifted."""
    if row.size == 0:
        return row
    lo, hi = float(row.min()), float(row.max())
    if hi == lo:
        return np.zeros_like(row) if hi == 0 else \
            np.full_like(row, MAX_NODE_SCORE)
    return (row - lo) * MAX_NODE_SCORE / (hi - lo)
