"""task-topology plugin: affinity-bucket co-scheduling within a job.

Mirrors pkg/scheduler/plugins/task-topology/{topology.go, manager.go,
bucket.go, util.go}: tasks of a job are grouped into buckets by
declared task-name affinity/anti-affinity; TaskOrderFn emits bucket-mates
consecutively and NodeOrderFn pulls a bucket onto the node(s) where its
mates already landed.

Topology is declared on the PodGroup annotations
(``volcano.sh/task-topology-affinity``, ``-anti-affinity``, ``-task-order``
— util.go:34-42), each a ``;``-separated list of ``,``-separated task
names, matched against TaskInfo.task_role (upstream matches the pod's
volcano.sh/task-spec annotation).

The fused allocate solve does not read node_order_fns, in this package as
in the JAX package: the node score counts only under ``engine:
callbacks``. The task order does reach the solve: it is the order of the
rows B1 places.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Set

from ..api import Resource, TaskStatus
from ..framework.session import EventHandler
from .base import Plugin

PLUGIN_NAME = "task-topology"
PLUGIN_WEIGHT = "task-topology.weight"
AFFINITY_ANNOTATION = "volcano.sh/task-topology-affinity"
ANTI_AFFINITY_ANNOTATION = "volcano.sh/task-topology-anti-affinity"
TASK_ORDER_ANNOTATION = "volcano.sh/task-topology-task-order"
OUT_OF_BUCKET = -1
MAX_NODE_SCORE = 100.0

# affinity kind -> task priority (manager.go affinityPriority:41-46)
SELF_ANTI_AFFINITY = "selfAntiAffinity"
INTER_ANTI_AFFINITY = "interAntiAffinity"
SELF_AFFINITY = "selfAffinity"
INTER_AFFINITY = "interAffinity"
AFFINITY_PRIORITY = {SELF_ANTI_AFFINITY: 4, INTER_AFFINITY: 3,
                     SELF_AFFINITY: 2, INTER_ANTI_AFFINITY: 1}


def task_name_of(task) -> str:
    """util.go getTaskName — the task-template name of a replica."""
    return task.task_role or ""


class TaskTopology:
    """Parsed topology annotations (util.go:44-49)."""

    def __init__(self, affinity=None, anti_affinity=None, task_order=None):
        self.affinity: List[List[str]] = affinity or []
        self.anti_affinity: List[List[str]] = anti_affinity or []
        self.task_order: List[str] = task_order or []


def _split_annotation(value: str) -> List[List[str]]:
    return [[t.strip() for t in group.split(",") if t.strip()]
            for group in value.split(";") if group.strip()]


def _affinity_check(job, groups: List[List[str]]) -> bool:
    """topology.go affinityCheck — every named task exists, no duplicates
    inside one group."""
    known = {task_name_of(t) for t in job.tasks.values()}
    for group in groups:
        seen: Set[str] = set()
        for name in group:
            if name not in known or name in seen:
                return False
            seen.add(name)
    return True


def read_topology_from_pg_annotations(job) -> Optional[TaskTopology]:
    """topology.go readTopologyFromPgAnnotations:287-335."""
    annotations = job.podgroup.annotations if job.podgroup else {}
    aff = annotations.get(AFFINITY_ANNOTATION)
    anti = annotations.get(ANTI_AFFINITY_ANNOTATION)
    order = annotations.get(TASK_ORDER_ANNOTATION)
    if aff is None and anti is None and order is None:
        return None
    topo = TaskTopology()
    if aff is not None:
        topo.affinity = _split_annotation(aff)
        if not _affinity_check(job, topo.affinity):
            return None
    if anti is not None:
        topo.anti_affinity = _split_annotation(anti)
        if not _affinity_check(job, topo.anti_affinity):
            return None
    if order is not None:
        topo.task_order = [t.strip() for t in order.split(",") if t.strip()]
        if not _affinity_check(job, [topo.task_order]):
            return None
    return topo


class Bucket:
    """bucket.go:34-110 — one co-placement group."""

    def __init__(self, index: int = 0):
        self.index = index
        self.tasks: Dict[str, object] = {}      # pending tasks by uid
        self.task_name_set: Dict[str, int] = {}
        self.req_score = 0.0
        self.request = Resource()
        self.bound_task = 0
        self.node: Dict[str, int] = {}          # node -> bound mate count

    def _score_of(self, req: Resource) -> float:
        # 1m CPU == 1Mi memory == 1m scalar (bucket.go CalcResReq:64-73)
        return req.cpu + req.memory / (1024 * 1024) + sum(req.scalars.values())

    def add_task(self, task_name: str, task) -> None:
        self.task_name_set[task_name] = self.task_name_set.get(task_name, 0) + 1
        if task.node_name:
            self.node[task.node_name] = self.node.get(task.node_name, 0) + 1
            self.bound_task += 1
            return
        self.tasks[task.uid] = task
        self.req_score += self._score_of(task.resreq)
        self.request.add(task.resreq)

    def task_bound(self, task) -> None:
        self.node[task.node_name] = self.node.get(task.node_name, 0) + 1
        self.bound_task += 1
        if task.uid in self.tasks:
            del self.tasks[task.uid]
            self.req_score -= self._score_of(task.resreq)
            self.request.sub(task.resreq)


class JobManager:
    """manager.go:48-347 — per-job affinity matrices and buckets."""

    def __init__(self, job_id: str):
        self.job_id = job_id
        self.buckets: List[Bucket] = []
        self.pod_in_bucket: Dict[str, int] = {}
        self.pod_in_task: Dict[str, str] = {}
        self.task_affinity_priority: Dict[str, int] = {}
        self.task_exist_order: Dict[str, int] = {}
        self.inter_affinity: Dict[str, Set[str]] = {}
        self.self_affinity: Set[str] = set()
        self.inter_anti_affinity: Dict[str, Set[str]] = {}
        self.self_anti_affinity: Set[str] = set()
        self.bucket_max_size = 0
        self.node_task_set: Dict[str, Dict[str, int]] = {}

    def mark_task_has_topology(self, task_name: str, kind: str) -> None:
        priority = AFFINITY_PRIORITY[kind]
        if priority > self.task_affinity_priority.get(task_name, 0):
            self.task_affinity_priority[task_name] = priority

    def apply_task_topology(self, topo: TaskTopology) -> None:
        """manager.go ApplyTaskTopology:113-151."""
        for group in topo.affinity:
            if len(group) == 1:
                self.self_affinity.add(group[0])
                self.mark_task_has_topology(group[0], SELF_AFFINITY)
                continue
            for i, src in enumerate(group):
                for dst in group[:i]:
                    self.inter_affinity.setdefault(src, set()).add(dst)
                    self.inter_affinity.setdefault(dst, set()).add(src)
                self.mark_task_has_topology(src, INTER_AFFINITY)
        for group in topo.anti_affinity:
            if len(group) == 1:
                self.self_anti_affinity.add(group[0])
                self.mark_task_has_topology(group[0], SELF_ANTI_AFFINITY)
                continue
            for i, src in enumerate(group):
                for dst in group[:i]:
                    self.inter_anti_affinity.setdefault(src, set()).add(dst)
                    self.inter_anti_affinity.setdefault(dst, set()).add(src)
                self.mark_task_has_topology(src, INTER_ANTI_AFFINITY)
        length = len(topo.task_order)
        for index, task_name in enumerate(topo.task_order):
            self.task_exist_order[task_name] = length - index

    def new_bucket(self) -> Bucket:
        bucket = Bucket(index=len(self.buckets))
        self.buckets.append(bucket)
        return bucket

    def add_task_to_bucket(self, bucket_index: int, task_name: str, task) -> None:
        bucket = self.buckets[bucket_index]
        self.pod_in_bucket[task.uid] = bucket_index
        bucket.add_task(task_name, task)
        size = len(bucket.tasks) + bucket.bound_task
        if size > self.bucket_max_size:
            self.bucket_max_size = size

    def task_affinity_order(self, l, r) -> int:
        """manager.go taskAffinityOrder:171-201; 1 means l ranks higher."""
        l_name = self.pod_in_task.get(l.uid, "")
        r_name = self.pod_in_task.get(r.uid, "")
        if l_name == r_name:
            return 0
        l_order = self.task_exist_order.get(l_name, 0)
        r_order = self.task_exist_order.get(r_name, 0)
        if l_order != r_order:
            return 1 if l_order > r_order else -1
        l_prio = self.task_affinity_priority.get(l_name, 0)
        r_prio = self.task_affinity_priority.get(r_name, 0)
        if l_prio != r_prio:
            return 1 if l_prio > r_prio else -1
        return 0

    def check_task_set_affinity(self, task_name: str,
                                task_name_set: Dict[str, int],
                                only_anti: bool) -> int:
        """manager.go checkTaskSetAffinity:230-264 — net affinity score of
        placing `task_name` next to the given name multiset."""
        score = 0
        if not task_name:
            return score
        for name_in_set, count in task_name_set.items():
            same = name_in_set == task_name
            if not only_anti:
                affinity = (task_name in self.self_affinity) if same else \
                    (name_in_set in self.inter_affinity.get(task_name, ()))
                if affinity:
                    score += count
            anti = (task_name in self.self_anti_affinity) if same else \
                (name_in_set in self.inter_anti_affinity.get(task_name, ()))
            if anti:
                score -= count
        return score

    def construct_bucket(self, tasks: Dict[str, object]) -> None:
        """manager.go ConstructBucket:308-320."""
        without_bucket = []
        for task in tasks.values():
            task_name = task_name_of(task)
            if not task_name or task_name not in self.task_affinity_priority:
                self.pod_in_bucket[task.uid] = OUT_OF_BUCKET
                continue
            self.pod_in_task[task.uid] = task_name
            without_bucket.append(task)

        # TaskOrder sort, reversed (util.go:92-118): bound tasks first, then
        # user order, then affinity priority.
        def sort_key(task):
            has_node = 1 if task.node_name else 0
            name = self.pod_in_task.get(task.uid, "")
            return (has_node, self.task_exist_order.get(name, 0),
                    self.task_affinity_priority.get(name, 0), task.node_name)
        without_bucket.sort(key=sort_key, reverse=True)
        self._build_bucket(without_bucket)

    def _build_bucket(self, ordered_tasks) -> None:
        """manager.go buildBucket:266-305."""
        node_bucket: Dict[str, Bucket] = {}
        for task in ordered_tasks:
            task_name = task_name_of(task)
            selected: Optional[Bucket] = None
            max_affinity = -math.inf
            if task.node_name:
                max_affinity = 0
                selected = node_bucket.get(task.node_name)
            else:
                for bucket in self.buckets:
                    aff = self.check_task_set_affinity(
                        task_name, bucket.task_name_set, only_anti=False)
                    if aff > max_affinity:
                        max_affinity = aff
                        selected = bucket
                    elif aff == max_affinity and selected is not None and \
                            bucket.req_score < selected.req_score:
                        selected = bucket
            if max_affinity < 0 or selected is None:
                selected = self.new_bucket()
                if task.node_name:
                    node_bucket[task.node_name] = selected
            self.add_task_to_bucket(selected.index, task_name, task)

    def task_bound(self, task) -> None:
        """manager.go TaskBound:322-337."""
        task_name = task_name_of(task)
        if task_name:
            node_set = self.node_task_set.setdefault(task.node_name, {})
            node_set[task_name] = node_set.get(task_name, 0) + 1
        bucket = self.get_bucket(task)
        if bucket is not None:
            bucket.task_bound(task)

    def get_bucket(self, task) -> Optional[Bucket]:
        index = self.pod_in_bucket.get(task.uid, OUT_OF_BUCKET)
        if index == OUT_OF_BUCKET:
            return None
        return self.buckets[index]


def _no_pending_tasks(job) -> bool:
    return not job.task_status_index.get(TaskStatus.PENDING)


class TaskTopologyPlugin(Plugin):
    NAME = PLUGIN_NAME

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.weight = self.arguments.get_int(PLUGIN_WEIGHT, 1)
        self.managers: Dict[str, JobManager] = {}

    def _init_buckets(self, ssn) -> None:
        """topology.go initBucket:213-238."""
        for job_id, job in ssn.jobs.items():
            if _no_pending_tasks(job):
                continue
            topo = read_topology_from_pg_annotations(job)
            if topo is None:
                continue
            manager = JobManager(job_id)
            manager.apply_task_topology(topo)
            manager.construct_bucket(job.tasks)
            self.managers[job_id] = manager

    def task_order_fn(self, l, r) -> int:
        """topology.go TaskOrderFn:60-132 — -1 ranks l first."""
        l_mgr = self.managers.get(l.job)
        r_mgr = self.managers.get(r.job)
        if l_mgr is None or r_mgr is None:
            return 0
        l_bucket, r_bucket = l_mgr.get_bucket(l), r_mgr.get_bucket(r)
        if (l_bucket is not None) != (r_bucket is not None):
            return -1 if l_bucket is not None else 1
        if l.job != r.job or l_bucket is None:
            return 0
        if len(l_bucket.tasks) != len(r_bucket.tasks):
            return -1 if len(l_bucket.tasks) > len(r_bucket.tasks) else 1
        if l_bucket.index == r_bucket.index:
            return -l_mgr.task_affinity_order(l, r)
        return -1 if l_bucket.index < r_bucket.index else 1

    def _calc_bucket_score(self, task, node):
        """topology.go calcBucketScore:134-186."""
        max_resource = node.idle.clone().add(node.releasing)
        if max_resource.less_in_some_dimension(task.resreq):
            return 0, None
        manager = self.managers.get(task.job)
        if manager is None:
            return 0, None
        bucket = manager.get_bucket(task)
        if bucket is None:
            return 0, manager
        score = bucket.node.get(node.name, 0)
        node_task_set = manager.node_task_set.get(node.name)
        if node_task_set:
            aff = manager.check_task_set_affinity(
                task_name_of(task), node_task_set, only_anti=True)
            if aff < 0:
                score += aff
        score += len(bucket.tasks)
        if bucket.request.less_equal(max_resource):
            return score, manager
        remains = bucket.request.clone()
        for uid, mate in bucket.tasks.items():
            if uid == task.uid:
                continue
            remains.sub(mate.resreq)
            score -= 1
            if remains.less_equal(max_resource):
                break
        return score, manager

    def node_order_fn(self, task, node) -> float:
        score, manager = self._calc_bucket_score(task, node)
        fscore = float(score * self.weight)
        if manager is not None and manager.bucket_max_size != 0:
            fscore = fscore * MAX_NODE_SCORE / manager.bucket_max_size
        return fscore

    def on_session_open(self, ssn) -> None:
        self.managers = {}
        self._init_buckets(ssn)
        ssn.add_task_order_fn(self.NAME, self.task_order_fn)
        ssn.add_node_order_fn(self.NAME, self.node_order_fn)

        def on_allocate(event):
            # the fused allocate's order simulation fires one aggregated
            # event a job, which carries no task
            if not hasattr(event.task, "uid"):
                return
            manager = self.managers.get(event.task.job)
            if manager is not None:
                manager.task_bound(event.task)

        ssn.add_event_handler(EventHandler(allocate_func=on_allocate))

    def on_session_close(self, ssn) -> None:
        self.managers = {}


def New(arguments):
    return TaskTopologyPlugin(arguments)
