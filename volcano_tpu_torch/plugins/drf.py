"""DRF plugin: dominant-resource fairness job ordering and preemption,
plus hierarchical DRF (weighted queue tree with saturation rescaling) and
weighted namespace fairness.

Mirrors pkg/scheduler/plugins/drf/drf.go:
- classic job-level DRF (dominant share = max_r allocated_r/total_r),
  job order + preemptable + event handlers (drf.go:202-520);
- hierarchical DRF (drf.go:522-663): queues carry slash-separated
  ``volcano.sh/hierarchy`` paths with per-level weights; shares propagate
  bottom-up with min-dominant-resource rescaling and saturation (a node is
  saturated when a resource it requests is fully allocated or no longer
  demanding), driving QueueOrderFn and the hierarchy-mode ReclaimableFn;
- weighted namespace fairness (drf.go:431-466): NamespaceOrderFn by
  share/weight, enabled by the ``enabledNamespaceOrder`` flag.

Hierarchy and namespace order are OFF unless explicitly enabled in the
conf tier (the reference requires an explicit true, drf.go:144-168).
"""

from __future__ import annotations

from typing import Dict, Optional

from ..api import Resource, allocated_status
from ..framework.session import PERMIT, EventHandler
from .base import Plugin

SHARE_DELTA = 0.000001


class _Attr:
    """share recomputed lazily on read (events are hot, ordering is not)."""

    __slots__ = ("allocated", "_share", "_dirty", "_total")

    def __init__(self, total: "Resource"):
        self.allocated = Resource()
        self._share = 0.0
        self._dirty = True
        self._total = total

    @property
    def share(self) -> float:
        if self._dirty:
            self._share = calculate_share(self.allocated, self._total)
            self._dirty = False
        return self._share


def calculate_share(allocated: Resource, total: Resource) -> float:
    share = 0.0
    for name in total.resource_names():
        t = total.get(name)
        a = allocated.get(name)
        if t > 0:
            share = max(share, a / t)
        elif a > 0:
            share = max(share, 1.0)
    return share


class _HNode:
    """hierarchicalNode (drf.go:41-77): one level of the weighted queue
    tree. Leaves are jobs (request = job total request); interior nodes
    aggregate children with min-dominant-share rescaling."""

    __slots__ = ("parent", "allocated", "share", "request", "weight",
                 "saturated", "hierarchy", "children")

    def __init__(self, hierarchy: str, weight: float = 1.0,
                 request: Optional[Resource] = None, leaf: bool = False):
        self.parent: Optional[_HNode] = None
        self.allocated = Resource()
        self.share = 0.0
        self.request = request if request is not None else Resource()
        self.weight = weight
        self.saturated = False
        self.hierarchy = hierarchy
        self.children: Optional[Dict[str, _HNode]] = None if leaf else {}

    def clone(self, parent: Optional["_HNode"] = None) -> "_HNode":
        n = _HNode(self.hierarchy, self.weight, self.request.clone(),
                   leaf=self.children is None)
        n.parent = parent
        n.allocated = self.allocated.clone()
        n.share = self.share
        n.saturated = self.saturated
        if self.children is not None:
            n.children = {k: c.clone(n) for k, c in self.children.items()}
        return n


def _resource_saturated(allocated: Resource, request: Resource,
                        demanding: Dict[str, bool]) -> bool:
    """drf.go:79-94: a job is saturated when a requested resource is fully
    allocated to it, or it requests a resource that is no longer demanding
    (cluster-wide fully allocated)."""
    for name in allocated.resource_names():
        a, r = allocated.get(name), request.get(name)
        if a != 0 and r != 0 and a >= r:
            return True
        if not demanding.get(name, False) and r != 0:
            return True
    return False


class DRFPlugin(Plugin):
    NAME = "drf"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.total = Resource()
        self.total_allocated = Resource()
        self.job_attrs: Dict[str, _Attr] = {}
        self.namespace_opts: Dict[str, _Attr] = {}
        self.root = _HNode("root", 1.0)

    # -- feature flags (explicit true required, drf.go:144-168) -------------

    def _flag_enabled(self, ssn, flag: str) -> bool:
        for tier in ssn.tiers:
            for opt in tier.plugins:
                if opt.name == self.NAME:
                    return opt.enabled.get(flag, False)
        return False

    # -- hierarchy maintenance (drf.go:527-633) ------------------------------

    def _build_hierarchy(self, root: _HNode, job, hierarchy: str,
                         weights: str) -> None:
        inode = root
        paths = hierarchy.split("/")
        wparts = weights.split("/")
        for i in range(1, len(paths)):
            child = inode.children.get(paths[i])
            if child is None:
                try:
                    w = float(wparts[i]) if i < len(wparts) else 1.0
                except ValueError:
                    w = 1.0
                child = _HNode(paths[i], max(w, 1.0))
                child.parent = inode
                inode.children[paths[i]] = child
            inode = child
        leaf = _HNode(job.uid, 1.0, job.total_request.clone(), leaf=True)
        leaf.parent = inode
        inode.children[job.uid] = leaf

    def _leaf_attr(self, root: _HNode, job_uid: str) -> Optional[_HNode]:
        stack = [root]
        while stack:
            n = stack.pop()
            if n.children is None:
                if n.hierarchy == job_uid:
                    return n
                continue
            stack.extend(n.children.values())
        return None

    def _update_hierarchical_share(self, node: _HNode,
                                   demanding: Dict[str, bool],
                                   job_alloc: Dict[str, Resource]) -> None:
        if node.children is None:
            alloc = job_alloc.get(node.hierarchy)
            if alloc is not None:
                node.allocated = alloc.clone()
            node.share = calculate_share(node.allocated, self.total)
            node.saturated = _resource_saturated(node.allocated,
                                                 node.request, demanding)
            return
        mdr = 1.0
        for child in node.children.values():
            self._update_hierarchical_share(child, demanding, job_alloc)
            if child.share != 0 and not child.saturated:
                mdr = min(mdr, calculate_share(child.allocated, self.total))
        node.allocated = Resource()
        saturated = True
        for child in node.children.values():
            if not child.saturated:
                saturated = False
            if child.share != 0:
                if child.saturated:
                    node.allocated.add(child.allocated)
                else:
                    node.allocated.add(
                        child.allocated.clone().multi(mdr / child.share))
        node.share = calculate_share(node.allocated, self.total)
        node.saturated = saturated

    def _demanding(self, total_allocated: Resource) -> Dict[str, bool]:
        return {name: total_allocated.get(name) < self.total.get(name)
                for name in self.total.resource_names()}

    def _refresh_tree(self, root: _HNode, total_allocated: Resource,
                      job_alloc: Dict[str, Resource]) -> None:
        self._update_hierarchical_share(root, self._demanding(total_allocated),
                                        job_alloc)

    def _compare_queues(self, root: _HNode, lq, rq) -> float:
        """drf.go compareQueues: walk both paths level by level; saturated
        nodes sort last, then weighted share."""
        lnode, rnode = root, root
        lpaths = lq.hierarchy.split("/")
        rpaths = rq.hierarchy.split("/")
        depth = min(len(lpaths), len(rpaths))
        for i in range(depth):
            if not lnode.saturated and rnode.saturated:
                return -1.0
            if lnode.saturated and not rnode.saturated:
                return 1.0
            lw = lnode.share / lnode.weight
            rw = rnode.share / rnode.weight
            if lw == rw:
                if i < depth - 1:
                    lnode = (lnode.children or {}).get(lpaths[i + 1])
                    rnode = (rnode.children or {}).get(rpaths[i + 1])
                    if lnode is None or rnode is None:
                        return 0.0
            else:
                return lw - rw
        return 0.0

    # -- session wiring ------------------------------------------------------

    def on_session_open(self, ssn) -> None:
        for node in ssn.nodes.values():
            self.total.add(node.allocatable)

        namespace_order = self._flag_enabled(ssn, "enabledNamespaceOrder")
        hierarchy = self._flag_enabled(ssn, "enabledHierarchy")

        for job in ssn.jobs.values():
            attr = _Attr(self.total)
            for t in job.tasks.values():
                if allocated_status(t.status):
                    attr.allocated.add(t.resreq)
            self.job_attrs[job.uid] = attr
            if namespace_order:
                ns = self.namespace_opts.setdefault(job.namespace,
                                                    _Attr(self.total))
                ns.allocated.add(attr.allocated)
                ns._dirty = True
            if hierarchy:
                queue = ssn.queues.get(job.queue)
                if queue is not None and queue.hierarchy:
                    self.total_allocated.add(attr.allocated)
                    self._build_hierarchy(self.root, job, queue.hierarchy,
                                          queue.hierarchy_weights)
        if hierarchy:
            self._refresh_tree(self.root, self.total_allocated,
                               self._job_alloc_map())

        def preemptable(preemptor, preemptees):
            """Victim iff preemptor's share (with the task) stays <= the
            preemptee job's share after losing the task (drf.go:308-330)."""
            latt = self.job_attrs[preemptor.job]
            lalloc = latt.allocated.clone().add(preemptor.resreq)
            ls = calculate_share(lalloc, self.total)
            victims = []
            allocations: Dict[str, Resource] = {}
            for preemptee in preemptees:
                if preemptee.job not in allocations:
                    allocations[preemptee.job] = \
                        self.job_attrs[preemptee.job].allocated.clone()
                ralloc = allocations[preemptee.job].sub(preemptee.resreq)
                rs = calculate_share(ralloc, self.total)
                if ls < rs or abs(ls - rs) <= SHARE_DELTA:
                    victims.append(preemptee)
            return victims, PERMIT

        ssn.add_preemptable_fn(self.NAME, preemptable)

        if hierarchy:
            def queue_order(l, r) -> int:
                ret = self._compare_queues(self.root, l, r)
                if ret < 0:
                    return -1
                if ret > 0:
                    return 1
                return 0

            ssn.add_queue_order_fn(self.NAME, queue_order)

            def hdrf_reclaimable(reclaimer, reclaimees):
                """drf.go:349-414: simulate the tree with the reclaimer's
                task added and each reclaimee's removed; victim iff the
                reclaimer's queue then orders strictly first."""
                victims = []
                total_allocated = self.total_allocated.clone()
                root = self.root.clone()
                ljob = ssn.jobs[reclaimer.job]
                lqueue = ssn.queues[ljob.queue]
                job_alloc = self._job_alloc_map()
                job_alloc[ljob.uid] = (
                    job_alloc.get(ljob.uid, Resource()).clone()
                    .add(reclaimer.resreq))
                total_allocated.add(reclaimer.resreq)
                self._refresh_tree(root, total_allocated, job_alloc)

                for preemptee in reclaimees:
                    rjob = ssn.jobs[preemptee.job]
                    rqueue = ssn.queues[rjob.queue]
                    total_allocated.sub(preemptee.resreq)
                    saved = job_alloc.get(rjob.uid, Resource()).clone()
                    job_alloc[rjob.uid] = saved.clone().sub(preemptee.resreq)
                    self._refresh_tree(root, total_allocated, job_alloc)
                    ret = self._compare_queues(root, lqueue, rqueue)
                    # resume
                    total_allocated.add(preemptee.resreq)
                    job_alloc[rjob.uid] = saved
                    self._refresh_tree(root, total_allocated, job_alloc)
                    if ret < 0:
                        victims.append(preemptee)
                return victims, PERMIT

            ssn.add_reclaimable_fn(self.NAME, hdrf_reclaimable)

        def job_order(l, r) -> int:
            ls = self.job_attrs[l.uid].share
            rs = self.job_attrs[r.uid].share
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        ssn.add_job_order_fn(self.NAME, job_order)

        if namespace_order:
            def namespace_order_fn(l, r) -> int:
                from ..api.queue_info import DEFAULT_NAMESPACE_WEIGHT
                lw = (ssn.namespaces[l].get_weight()
                      if l in ssn.namespaces else DEFAULT_NAMESPACE_WEIGHT)
                rw = (ssn.namespaces[r].get_weight()
                      if r in ssn.namespaces else DEFAULT_NAMESPACE_WEIGHT)
                lo = self.namespace_opts.setdefault(l, _Attr(self.total))
                ro = self.namespace_opts.setdefault(r, _Attr(self.total))
                lws = lo.share / lw
                rws = ro.share / rw
                if lws == rws:
                    return 0
                return -1 if lws < rws else 1

            ssn.add_namespace_order_fn(self.NAME, namespace_order_fn)

        def on_allocate(event):
            attr = self.job_attrs[event.task.job]
            attr.allocated.add(event.task.resreq)
            attr._dirty = True
            job = ssn.jobs.get(event.task.job)
            if namespace_order and job is not None:
                ns = self.namespace_opts.setdefault(job.namespace,
                                                    _Attr(self.total))
                ns.allocated.add(event.task.resreq)
                ns._dirty = True
            if hierarchy and job is not None:
                self.total_allocated.add(event.task.resreq)
                self._refresh_tree(self.root, self.total_allocated,
                                   self._job_alloc_map())

        def on_deallocate(event):
            attr = self.job_attrs[event.task.job]
            attr.allocated.sub(event.task.resreq)
            attr._dirty = True
            job = ssn.jobs.get(event.task.job)
            if namespace_order and job is not None:
                ns = self.namespace_opts.setdefault(job.namespace,
                                                    _Attr(self.total))
                ns.allocated.sub(event.task.resreq)
                ns._dirty = True
            if hierarchy and job is not None:
                self.total_allocated.sub(event.task.resreq)
                self._refresh_tree(self.root, self.total_allocated,
                                   self._job_alloc_map())

        ssn.add_event_handler(EventHandler(allocate_func=on_allocate,
                                           deallocate_func=on_deallocate,
                                           aggregatable=True))

    def _job_alloc_map(self) -> Dict[str, Resource]:
        return {uid: attr.allocated for uid, attr in self.job_attrs.items()}

    def on_session_close(self, ssn) -> None:
        self.total = Resource()
        self.total_allocated = Resource()
        self.job_attrs = {}
        self.namespace_opts = {}
        self.root = _HNode("root", 1.0)


def New(arguments):
    return DRFPlugin(arguments)
