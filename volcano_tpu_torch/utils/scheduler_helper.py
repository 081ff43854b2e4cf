"""Per-(task, node) helpers of the host paths (the allocate callbacks
engine, preempt's callbacks rung and the reclaim rotation).

Mirrors pkg/scheduler/util/scheduler_helper.go:36-266 — PredicateNodes
with adaptive feasible-node sampling, PrioritizeNodes score merge,
SelectBestNode — and preempt.go's sortNodes. The reference parallelizes
these over 16 goroutines; here they are straightforward loops.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..api import FitErrors, NodeInfo, TaskInfo

# options.go:38-41 defaults
DEFAULT_MIN_NODES_TO_FIND = 100
DEFAULT_MIN_PERCENTAGE_OF_NODES_TO_FIND = 5
DEFAULT_PERCENTAGE_OF_NODES_TO_FIND = 100


def calculate_num_feasible_nodes(
        num_all_nodes: int,
        percentage: int = DEFAULT_PERCENTAGE_OF_NODES_TO_FIND,
        min_nodes: int = DEFAULT_MIN_NODES_TO_FIND,
        min_percent: int = DEFAULT_MIN_PERCENTAGE_OF_NODES_TO_FIND) -> int:
    """CalculateNumOfFeasibleNodesToFind (scheduler_helper.go:49-68)."""
    if num_all_nodes <= min_nodes or percentage >= 100:
        return num_all_nodes
    adaptive = percentage
    if adaptive == 0:
        adaptive = int(50 - num_all_nodes / 125)
        if adaptive < min_percent:
            adaptive = min_percent
    num = num_all_nodes * adaptive // 100
    return max(num, min_nodes)


def predicate_nodes(task: TaskInfo, nodes: List[NodeInfo],
                    fn: Callable[[TaskInfo, NodeInfo], None],
                    percentage: int = DEFAULT_PERCENTAGE_OF_NODES_TO_FIND,
                    ) -> Tuple[List[NodeInfo], FitErrors]:
    """PredicateNodes (scheduler_helper.go:71-127): the first feasible
    nodes, as many as calculate_num_feasible_nodes allows, in node order,
    and why the others tried failed. Any exception ``fn`` raises fails the
    node."""
    to_find = calculate_num_feasible_nodes(len(nodes), percentage)
    feasible: List[NodeInfo] = []
    errors = FitErrors()
    for node in nodes:
        if len(feasible) >= to_find:
            break
        try:
            fn(task, node)
        except Exception as err:
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
