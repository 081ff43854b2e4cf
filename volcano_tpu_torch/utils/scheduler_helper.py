"""Per-(task, node) helpers of the host paths (preempt's callbacks rung and
the reclaim rotation).

Mirrors pkg/scheduler/util/scheduler_helper.go:36-266 — PredicateNodes,
PrioritizeNodes score merge, SelectBestNode — and preempt.go's sortNodes.
The reference parallelizes these over 16 goroutines; here they are
straightforward loops. The deployed configuration searches every node
(percentageOfNodesToFind 100), so PredicateNodes keeps every feasible
node.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..api import FitErrors, NodeInfo, TaskInfo

def predicate_nodes(task: TaskInfo, nodes: List[NodeInfo],
                    fn: Callable[[TaskInfo, NodeInfo], None],
                    ) -> Tuple[List[NodeInfo], FitErrors]:
    """PredicateNodes (scheduler_helper.go:71-127): the nodes that pass
    ``fn``, in node order, and why the others failed."""
    feasible: List[NodeInfo] = []
    errors = FitErrors()
    for node in nodes:
        try:
            fn(task, node)
        except ValueError as err:       # a predicate's fit error
            errors.set_node_error(node.name, getattr(err, "fit_error", err))
            continue
        feasible.append(node)
    return feasible, errors


def prioritize_nodes(task: TaskInfo, nodes: List[NodeInfo],
                     batch_fn, map_fn) -> Dict[float, List[NodeInfo]]:
    """PrioritizeNodes (scheduler_helper.go:130-192): per-node map scores +
    batch scores summed, grouped score -> nodes in node order."""
    scores: Dict[str, float] = {n.name: 0.0 for n in nodes}
    for node in nodes:
        scores[node.name] += map_fn(task, node)
    for name, s in (batch_fn(task, nodes) or {}).items():
        if name in scores:
            scores[name] += s
    grouped: Dict[float, List[NodeInfo]] = {}
    for node in nodes:
        grouped.setdefault(scores[node.name], []).append(node)
    return grouped


def sort_nodes(node_scores: Dict[float, List[NodeInfo]]) -> List[NodeInfo]:
    """preempt.go sortNodes: highest score first, node order within a
    score."""
    out: List[NodeInfo] = []
    for score in sorted(node_scores, reverse=True):
        out.extend(node_scores[score])
    return out


def select_best_node(node_scores: Dict[float, List[NodeInfo]]
                     ) -> Optional[NodeInfo]:
    """SelectBestNode (scheduler_helper.go:210-225). The reference picks a
    random node of the best score; this picks the first, as the JAX
    package's deterministic default does."""
    if not node_scores:
        return None
    best = node_scores[max(node_scores)]
    return best[0] if best else None
