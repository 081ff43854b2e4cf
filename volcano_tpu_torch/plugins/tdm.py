"""TDM (time-division multiplexing) plugin: revocable nodes take
preemptable workloads inside their zone's active window and are drained of
them outside it.

Mirrors pkg/scheduler/plugins/tdm/tdm.go:58-372. The zone windows read the
session clock in UTC, so a replay decides alike on any host.
"""

from __future__ import annotations

import weakref
from datetime import datetime, timedelta, timezone
from typing import Dict, List, Optional

import numpy as np

from ..api import TaskStatus
from ..framework.session import PERMIT, REJECT
from .base import Plugin
from .sla import parse_duration

REVOCABLE_ZONE_ARG_PREFIX = "tdm.revocable-zone."
EVICT_PERIOD_ARG = "tdm.evict.period"
MAX_NODE_SCORE = 100.0
DEFAULT_POD_EVICT_NUM = 1


def _parse_hhmm(text: str):
    h, m = text.strip().split(":")
    return int(h), int(m)


def parse_revocable_zone(raw: str, now: datetime):
    """'10:00-21:00' -> (start, end) on ``now``'s day; the end rolls to the
    next day when it is not after the start (tdm.go:89-117)."""
    lo, hi = raw.strip().split("-")
    h1, m1 = _parse_hhmm(lo)
    h2, m2 = _parse_hhmm(hi)
    start = now.replace(hour=h1, minute=m1, second=0, microsecond=0)
    end = now.replace(hour=h2, minute=m2, second=0, microsecond=0)
    if (h1, m1) >= (h2, m2):
        end += timedelta(days=1)
    return start, end


def _parse_int_or_percent(text: str, total: int) -> int:
    text = str(text).strip()
    if text.endswith("%"):
        return round(float(text[:-1]) / 100.0 * total)
    try:
        return int(text)
    except ValueError:
        return 0


class TDMPlugin(Plugin):
    NAME = "tdm"

    # The last periodic drain's time per scheduler cache, on the session
    # clock. Plugins are built anew at every session open, so this lives on
    # the class: on the instance the drain would run every cycle. Keyed by
    # the cache, concurrent schedulers keep their own; the weak keys let a
    # dropped scheduler's entry go.
    _last_evict_at: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.revocable_zone: Dict[str, str] = {}
        for k, v in self.arguments.items():
            if REVOCABLE_ZONE_ARG_PREFIX in k:
                self.revocable_zone[
                    k.replace(REVOCABLE_ZONE_ARG_PREFIX, "", 1)] = v
        self.evict_period = parse_duration(
            self.arguments.get(EVICT_PERIOD_ARG, "")) or 60.0

    def _zone_active(self, rz: str, now: datetime) -> Optional[str]:
        """None if the zone is active at ``now``, else why not."""
        raw = self.revocable_zone.get(rz)
        if raw is None:
            return f"revocable zone {rz} not support"
        try:
            start, end = parse_revocable_zone(raw, now)
        except ValueError:
            return f"revocable zone {raw} format error"
        if now < start or now > end:
            return f"current time beyond revocable zone {rz}:{raw}"
        return None

    @staticmethod
    def _session_now(ssn) -> datetime:
        """The session clock as a UTC datetime (wall time live, the logical
        clock under replay)."""
        return datetime.fromtimestamp(ssn.now(), tz=timezone.utc)

    def _max_victims(self, job, victims: List) -> List:
        return victims[: min(self._max_evict_num(job), len(victims))]

    def _max_evict_num(self, job) -> int:
        """The evictions the job's disruption budget allows
        (tdm.go:306-333)."""
        running = len(job.task_status_index.get(TaskStatus.RUNNING, {}))
        budget = job.budget
        if budget is not None and budget.max_unavailable not in (None, ""):
            max_unavail = _parse_int_or_percent(budget.max_unavailable,
                                                len(job.tasks))
            final = (len(job.task_status_index.get(TaskStatus.SUCCEEDED, {}))
                     + len(job.task_status_index.get(TaskStatus.FAILED, {})))
            real_unavail = len(job.tasks) - final - running
            if real_unavail >= max_unavail:
                return 0
            return max_unavail - real_unavail
        if budget is not None and budget.min_available not in (None, ""):
            min_avail = _parse_int_or_percent(budget.min_available,
                                              len(job.tasks))
            if running >= min_avail:
                return running - min_avail
        return DEFAULT_POD_EVICT_NUM

    def on_session_open(self, ssn) -> None:
        def predicate(task, node):
            if not node.revocable_zone:
                return
            err = self._zone_active(node.revocable_zone,
                                    self._session_now(ssn))
            if err:
                raise ValueError(f"plugin {self.NAME} predicates {err}")
            if not task.revocable_zone:
                raise ValueError(
                    f"plugin {self.NAME} predicates task {task.key()} is not "
                    f"allow to dispatch to revocable node {node.name}")

        ssn.add_predicate_fn(self.NAME, predicate)

        def feasibility(ssn_, tasks, node_t):
            """The predicate as B1's mask: a revocable node's column is the
            tasks that name a zone while its zone is active, else none."""
            from ..cache.snapshot import node_infos_for
            node_infos = node_infos_for(ssn_, node_t)
            if not any(n.revocable_zone for n in node_infos):
                return None
            mask = np.ones((len(tasks), len(node_infos)), dtype=bool)
            revocable = np.asarray([bool(t.revocable_zone) for t in tasks],
                                   dtype=bool)
            now = self._session_now(ssn_)
            active: Dict[str, bool] = {}
            for ni, node in enumerate(node_infos):
                rz = node.revocable_zone
                if not rz:
                    continue
                if rz not in active:
                    active[rz] = self._zone_active(rz, now) is None
                mask[:, ni] = revocable if active[rz] else False
            return mask

        ssn.add_feasibility_fn(self.NAME, feasibility)

        def node_order(task, node) -> float:
            if not node.revocable_zone:
                return 0.0
            if self._zone_active(node.revocable_zone,
                                 self._session_now(ssn)):
                return 0.0
            if not task.revocable_zone:
                return 0.0
            return MAX_NODE_SCORE

        ssn.add_node_order_fn(self.NAME, node_order)

        def preemptable(preemptor, preemptees):
            """A workload that is neither preemptable nor revocable may
            evict preemptable tasks running on plain nodes, within each
            job's budget (tdm.go:193-230)."""
            if preemptor.preemptable or preemptor.revocable_zone:
                return None, REJECT
            tasks_map: Dict[str, List] = {}
            for task in preemptees:
                if not task.preemptable or task.status != TaskStatus.RUNNING:
                    continue
                node = ssn.nodes.get(task.node_name)
                if node is None or node.revocable_zone:
                    continue
                tasks_map.setdefault(task.job, []).append(task)
            victims = []
            for job_id, tasks in tasks_map.items():
                job = ssn.jobs.get(job_id)
                if job is not None:
                    victims.extend(self._max_victims(job, tasks))
            return victims, PERMIT

        ssn.add_preemptable_fn(self.NAME, preemptable)

        def victims_fn():
            """The periodic drain of preemptable tasks from revocable nodes
            whose zone is inactive (tdm.go:232-260)."""
            last = self._last_evict_at.get(ssn.cache, 0.0)
            if last + self.evict_period > ssn.now():
                return None
            now = self._session_now(ssn)
            victims = []
            for rz in self.revocable_zone:
                if self._zone_active(rz, now) is None:
                    continue
                tasks_map: Dict[str, List] = {}
                for node in ssn.nodes.values():
                    if node.revocable_zone != rz:
                        continue
                    for task in node.tasks.values():
                        if (task.preemptable
                                and task.status == TaskStatus.RUNNING):
                            tasks_map.setdefault(task.job, []).append(task)
                for job_id, tasks in tasks_map.items():
                    job = ssn.jobs.get(job_id)
                    if job is not None:
                        victims.extend(self._max_victims(job, tasks))
            self._last_evict_at[ssn.cache] = ssn.now()
            return victims

        ssn.add_victim_tasks_fn(self.NAME, victims_fn)

        def job_order(l, r) -> int:
            if l.preemptable == r.preemptable:
                return 0
            return -1 if not l.preemptable else 1

        ssn.add_job_order_fn(self.NAME, job_order)

        def job_pipelined(job) -> int:
            occupied = job.waiting_task_num() + job.ready_task_num()
            return PERMIT if occupied >= job.min_available else REJECT

        ssn.add_job_pipelined_fn(self.NAME, job_pipelined)

        def job_starving(job) -> bool:
            if job.preemptable:
                return False
            return bool(job.task_status_index.get(TaskStatus.PENDING))

        ssn.add_job_starving_fn(self.NAME, job_starving)


def New(arguments):
    return TDMPlugin(arguments)
