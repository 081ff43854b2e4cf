"""vcctl: the operator CLI.

Mirrors Volcano's {cmd/cli/vcctl.go:47-49, pkg/cli/job/*, pkg/cli/queue/*}:
``job {run,list,view,suspend,resume,scale,delete}``, ``queue {create,get,
list,operate,delete}``, ``version``. Job suspend/resume/delete post bus
Command CRs owner-referenced to the Job (pkg/cli/job/util.go:69-95),
exactly like the reference — the job controller consumes them
asynchronously.

With the running scheduler's elastic Command funnel attached
(``main(..., funnel=...)``, like the in-process cache/trace verbs),
``job suspend|resume|scale`` route through the journaled+fenced funnel
instead (docs/design/elastic-gangs.md): the verb enqueues durably and
applies at the next cycle boundary. ``job scale`` exists ONLY on that
path — rewriting the desired-members annotation anywhere but the funnel
is what the JAX package's vlint rule VT020 forbids, so there is no store
fallback for it.

The standalone verb entry points (vsub/vcancel/vsuspend/vresume/vjobs/
vqueues, Makefile:172-180) are exposed as functions of the same commands.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from .. import __version__
from ..api import BusAction, QueueState, Resource
from ..apis.objects import (Command, Job, JobSpec, ObjectMeta, PodTemplate,
                            QueueCR, QueueSpecCR, TaskSpec)
from ..store import ObjectStore


class JobCommands:
    """pkg/cli/job analogue."""

    def __init__(self, store: ObjectStore):
        self.store = store

    def run(self, name: str, namespace: str = "default", queue: str = "default",
            replicas: int = 1, min_available: Optional[int] = None,
            requests: Optional[dict] = None, image: str = "busybox",
            scheduler: str = "volcano",
            min_success: Optional[int] = None) -> Job:
        """constructLaunchJobFlagsJob (pkg/cli/job/run.go:71-165)."""
        res = Resource.from_dict(requests or {"cpu": "1", "memory": "1Gi"})
        job = Job(
            metadata=ObjectMeta(name=name, namespace=namespace),
            spec=JobSpec(
                queue=queue, scheduler_name=scheduler,
                min_available=min_available or replicas,
                min_success=min_success,
                tasks=[TaskSpec(name="default", replicas=replicas,
                                template=PodTemplate(
                                    resources=res,
                                    containers=[{"name": name,
                                                 "image": image}]))]))
        return self.store.create(job)

    def list(self, namespace: Optional[str] = None) -> List[Job]:
        return self.store.list("Job", namespace)

    def view(self, name: str, namespace: str = "default") -> Optional[Job]:
        return self.store.get("Job", namespace, name)

    def _command(self, name: str, namespace: str, action: BusAction) -> None:
        """createJobCommand (pkg/cli/job/util.go:69-95)."""
        self.store.create(Command(
            metadata=ObjectMeta(
                name=f"{name}-{action.value.lower()}-{ObjectMeta().uid}",
                namespace=namespace,
                owner_references=[{"kind": "Job", "name": name}]),
            action=action,
            target_object={"kind": "Job", "name": name}))

    def suspend(self, name: str, namespace: str = "default") -> None:
        self._command(name, namespace, BusAction.ABORT_JOB)

    def resume(self, name: str, namespace: str = "default") -> None:
        self._command(name, namespace, BusAction.RESUME_JOB)

    def delete(self, name: str, namespace: str = "default") -> None:
        self.store.delete("Job", namespace, name)


class QueueCommands:
    """pkg/cli/queue analogue."""

    def __init__(self, store: ObjectStore):
        self.store = store

    def create(self, name: str, weight: int = 1,
               capability: Optional[dict] = None,
               reclaimable: bool = True, hierarchy: str = "",
               hierarchy_weights: str = "") -> QueueCR:
        cap = Resource.from_dict(capability) if capability else None
        annotations = {}
        if hierarchy:
            annotations["volcano.sh/hierarchy"] = hierarchy
        if hierarchy_weights:
            annotations["volcano.sh/hierarchy-weights"] = hierarchy_weights
        return self.store.create(QueueCR(
            metadata=ObjectMeta(name=name, namespace="default",
                                annotations=annotations),
            spec=QueueSpecCR(weight=weight, capability=cap,
                             reclaimable=reclaimable)))

    def get(self, name: str) -> Optional[QueueCR]:
        return self.store.get("Queue", "default", name)

    def list(self) -> List[QueueCR]:
        return self.store.list("Queue")

    def operate(self, name: str, action: str) -> None:
        bus = {"open": BusAction.OPEN_QUEUE,
               "close": BusAction.CLOSE_QUEUE}[action]
        self.store.create(Command(
            metadata=ObjectMeta(name=f"{name}-{action}-{ObjectMeta().uid}",
                                namespace="default"),
            action=bus, target_object={"kind": "Queue", "name": name}))

    def delete(self, name: str) -> None:
        self.store.delete("Queue", "default", name)


def _fmt_job(job: Job) -> str:
    return (f"{job.metadata.namespace}/{job.metadata.name}\t"
            f"queue={job.spec.queue}\tstate={job.status.state.value}\t"
            f"running={job.status.running}\tsucceeded={job.status.succeeded}")


def _fmt_queue(q: QueueCR) -> str:
    return (f"{q.metadata.name}\tweight={q.spec.weight}\t"
            f"state={q.status.state.value}\tinqueue={q.status.inqueue}\t"
            f"running={q.status.running}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="vcctl")
    sub = parser.add_subparsers(dest="group")

    job = sub.add_parser("job").add_subparsers(dest="verb")
    run = job.add_parser("run")
    run.add_argument("--name", required=True)
    run.add_argument("--namespace", default="default")
    run.add_argument("--queue", default="default")
    run.add_argument("--replicas", type=int, default=1)
    run.add_argument("--min", type=int, default=None)
    run.add_argument("--min-success", type=int, default=None,
                     dest="min_success")
    run.add_argument("--requests", default="cpu=1,memory=1Gi")
    run.add_argument("--image", default="busybox")
    for verb in ("list", "view", "suspend", "resume", "delete"):
        p = job.add_parser(verb)
        if verb != "list":
            p.add_argument("--name", required=True)
        p.add_argument("--namespace", default="default")
    js = job.add_parser(
        "scale", description="Rewrite an elastic gang's desired member "
                             "count through the scheduler's journaled "
                             "Command funnel; grow-shrink converges the "
                             "gang over the next cycles "
                             "(docs/design/elastic-gangs.md)")
    js.add_argument("--name", required=True)
    js.add_argument("--namespace", default="default")
    js.add_argument("--desired", type=int, required=True,
                    help="target member count (min_available still floors "
                         "the gang; 0 parks it at min)")
    jt = job.add_parser(
        "timeline", description="The job's retained lifecycle timeline "
                                "(docs/observability.md): every causal "
                                "event — arrival, solve verdicts, bind "
                                "intents, acks, queue moves, elastic "
                                "grow/shrink, completion — stamped with "
                                "its originating cycle/partition/epoch; "
                                "process-local like the trace verbs")
    jt.add_argument("--name", required=True)

    queue = sub.add_parser("queue").add_subparsers(dest="verb")
    qc = queue.add_parser("create")
    qc.add_argument("--name", required=True)
    qc.add_argument("--weight", type=int, default=1)
    qc.add_argument("--hierarchy", default="")
    qc.add_argument("--hierarchy-weights", default="",
                    dest="hierarchy_weights")
    for verb in ("get", "delete"):
        queue.add_parser(verb).add_argument("--name", required=True)
    queue.add_parser("list")
    qo = queue.add_parser("operate")
    qo.add_argument("--name", required=True)
    qo.add_argument("--action", choices=["open", "close"], required=True)

    cache = sub.add_parser("cache").add_subparsers(dest="verb")
    cache.add_parser(
        "redrive-dead-letter",
        description="Re-queue every dead-lettered side effect with a "
                    "fresh retry budget (after the underlying fault is "
                    "fixed) — SchedulerCache.redrive_dead_letter")
    cache.add_parser("dead-letter",
                     description="List the dead-lettered side effects")
    cache.add_parser(
        "inflight",
        description="List the in-flight ledger: executor-accepted "
                    "bind/evicts still awaiting their cluster ack, with "
                    "age and deadline, plus the watchdog's resolution "
                    "totals (docs/robustness.md feedback failure model)")

    trace = sub.add_parser(
        "trace", description="Flight-recorder verbs "
                             "(docs/observability.md); in-process like the "
                             "cache verbs — they read the running "
                             "scheduler's obs.TRACE/obs.AUDIT").add_subparsers(
        dest="verb")
    td = trace.add_parser(
        "dump", description="Write the recorded cycle ring as Chrome "
                            "trace-event JSON (perfetto-loadable)")
    td.add_argument("--out", help="file to write (default: stdout)")
    tw = trace.add_parser(
        "why", description="The last audited decision for a job: "
                           "admitted/denied/pipelined/preempted + reason")
    tw.add_argument("--job", required=True)

    leader = sub.add_parser(
        "leader", description="HA control-plane verbs "
                              "(docs/robustness.md): inspect the "
                              "scheduler lease / fencing epoch in the "
                              "store").add_subparsers(dest="verb")
    ls = leader.add_parser(
        "status", description="Who holds the scheduler lease, its "
                              "fencing epoch, and how stale the renew "
                              "timestamp is")
    ls.add_argument("--name", default="vc-scheduler")
    ls.add_argument("--namespace", default="volcano-system")

    fed = sub.add_parser(
        "federation", description="Federated control-plane verbs "
                                  "(docs/federation.md): inspect the "
                                  "per-partition scheduler leases in "
                                  "the store").add_subparsers(dest="verb")
    fs = fed.add_parser(
        "status", description="Per-partition leadership: who holds each "
                              "partition's lease, its fencing epoch, and "
                              "renew staleness")
    fs.add_argument("--name", default="vc-scheduler",
                    help="base lease name (partitions are <name>-p<i>)")
    fs.add_argument("--namespace", default="volcano-system")
    fs.add_argument("--partitions", type=int, default=0,
                    help="probe exactly N partitions; 0 discovers "
                         "contiguously from p0 until the first missing "
                         "lease")
    fed.add_parser(
        "rebalance-status",
        description="The load-driven rebalancer's per-partition state "
                    "(docs/federation.md): executed moves, abstentions, "
                    "flap-blocked queues and thresholds — read from the "
                    "process-local metrics detail, like the flight-"
                    "recorder verbs")
    fed.add_parser(
        "elastic-status",
        description="Elastic membership per-partition state "
                    "(docs/federation.md): live partition count, "
                    "split/merge totals, hot/idle streaks, flap-guard "
                    "windows and the last split/merge records — read "
                    "from the process-local metrics detail")

    dev = sub.add_parser(
        "device", description="Device verbs (docs/robustness.md): the "
                              "device cool-down, read from the process-"
                              "local metrics detail").add_subparsers(
                                  dest="verb")
    dev.add_parser(
        "status", description="The fleet cool-down window: availability, "
                              "consecutive and total faults, the last "
                              "fault's kind and the time left")

    st = sub.add_parser(
        "store", description="Store-boundary verbs (docs/robustness.md "
                             "store failure model): object counts, "
                             "fault/retry funnel totals, watch stream "
                             "staleness").add_subparsers(dest="verb")
    st.add_parser(
        "status", description="Current resourceVersion, per-kind object "
                              "counts, volcano_store_faults/retries "
                              "totals and per-stream watch state")

    slo = sub.add_parser(
        "slo", description="SLO verbs (docs/observability.md): the "
                           "declarative objectives evaluated over the "
                           "lifecycle timeline store — process-local "
                           "like the trace verbs").add_subparsers(
        dest="verb")
    slo.add_parser(
        "status", description="Evaluate every configured objective at "
                              "the store's current virtual time: "
                              "compliance, sample count and per-window "
                              "burn rates")

    sub.add_parser("version")
    return parser


def parse_requests(text: str) -> dict:
    out = {}
    for part in text.split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def main(argv: Optional[List[str]] = None, store: Optional[ObjectStore] = None,
         out=print, cache=None, funnel=None) -> int:
    args = build_parser().parse_args(argv)
    if args.group == "version":
        out(f"vcctl version {__version__}")
        return 0
    if args.group == "trace":
        # flight-recorder verbs (docs/observability.md): read the
        # process-local recorder — in-process callers share the running
        # scheduler's obs globals, same deployment model as the cache verbs
        from ..obs import AUDIT, TRACE
        if args.verb == "dump":
            if args.out:
                TRACE.dump(args.out)
                out(f"wrote {TRACE.cycles_recorded()} recorded cycle(s) "
                    f"to {args.out}")
            else:
                out(TRACE.dump())
            return 0
        if args.verb == "why":
            # timeline-backed (obs/lifecycle.py): the audit verdict
            # extended with the causal history the ring ages out of
            from ..obs.lifecycle import why as timeline_why
            rec = timeline_why(args.job)
            if rec is None:
                out(f"no decision recorded for job {args.job!r} in the "
                    f"last {AUDIT.cycles_retained()} retained cycle(s)")
                return 1
            import json
            out(json.dumps(rec, sort_keys=True))
            return 0
        build_parser().print_help()
        return 1
    if args.group == "job" and args.verb == "timeline":
        # process-local, like the trace verbs: read the running
        # scheduler's lifecycle timeline store (docs/observability.md)
        import json
        from ..obs import TIMELINE
        tl = TIMELINE.timeline(args.name)
        if tl is None:
            out(f"no timeline retained for job {args.name!r} "
                f"({TIMELINE.job_count()} job(s) retained)")
            return 1
        out(f"job {tl['job']}: {len(tl['events'])} event(s)")
        for ev in tl["events"]:
            extras = {k: v for k, v in ev.items()
                      if k not in ("ev", "cycle", "part", "epoch",
                                   "eid", "t")}
            tail = " " + json.dumps(extras, sort_keys=True) if extras \
                else ""
            out(f"t={ev['t']}\tcycle={ev['cycle']}\t"
                f"p{ev['part']}/e{ev['epoch']}\t{ev['ev']}{tail}")
        return 0
    if args.group == "slo":
        if args.verb == "status":
            from ..obs import SLO_ENGINE, TIMELINE
            status = SLO_ENGINE.publish(now=TIMELINE.now())
            if not status:
                out("no SLO objectives configured")
                return 1
            for obj in status:
                burns = " ".join(
                    f"burn[{w}]={r}" for w, r in sorted(
                        obj["burn_rate"].items(),
                        key=lambda kv: float(kv[0])))
                out(f"{obj['slo']}\tmetric={obj['metric']}\t"
                    f"ok={obj['ok']}\tcompliance={obj['compliance']}\t"
                    f"samples={obj['samples']}\t"
                    f"threshold_s={obj['threshold_s']}\t{burns}")
            return 0
        build_parser().print_help()
        return 1
    if args.group == "cache":
        # operator verbs against the scheduler cache (dead-letter ops,
        # docs/robustness.md) — in-process callers pass the live
        # SchedulerCache (VolcanoSystem.cache)
        if cache is None:
            out("no scheduler cache attached (in-process CLI requires "
                "the running scheduler's cache)")
            return 1
        if args.verb == "redrive-dead-letter":
            moved = cache.redrive_dead_letter()
            out(f"redrove {moved} dead-lettered side effects")
        elif args.verb == "dead-letter":
            for key, (op, task) in sorted(cache.dead_letter.items()):
                out(f"{key}\top={op}\ttask={task.uid}\t"
                    f"node={task.node_name or '-'}")
            out(f"{len(cache.dead_letter)} dead-lettered")
        elif args.verb == "inflight":
            ledger = getattr(cache, "inflight", None)
            if ledger is None:
                out("no in-flight ledger attached")
                return 1
            now = ledger.time_fn()
            for e in sorted(ledger.entries(),
                            key=lambda e: (e.registered_at, e.uid)):
                out(f"{e.op}/{e.uid}\tnode={e.node or '-'}\t"
                    f"age={now - e.registered_at:.1f}s\t"
                    f"deadline_in={e.deadline - now:.1f}s")
            detail = ledger.detail(now)
            res = " ".join(f"{k}={v}" for k, v in
                           detail["resolved"].items())
            out(f"{detail['open']} in flight; "
                f"oldest {detail['oldest_age_s']:.1f}s; "
                f"resolved: {res or '-'}")
        return 0
    if args.group == "federation" and args.verb == "rebalance-status":
        # process-local (metrics detail), like the trace verbs — the
        # rebalancer lives in the scheduler process, not the store
        import json
        from .. import metrics
        detail = metrics.health_detail().get("overload", {}) \
            .get("rebalance", {})
        if not detail:
            out("no rebalancer state recorded — the load-driven "
                "rebalancer is not enabled (or this process runs no "
                "partition leader)")
            return 1
        for pid in sorted(detail, key=int):
            d = detail[pid]
            out(f"p{pid}\tmoves={d.get('moves', 0)}\t"
                f"abstentions={d.get('abstentions', 0)}\t"
                f"refused={d.get('refused', 0)}\t"
                f"blocked={sorted(d.get('blocked_queues', {}))}")
            if d.get("last_move"):
                out(f"p{pid}\tlast_move={json.dumps(d['last_move'], sort_keys=True)}")
        return 0
    if args.group == "federation" and args.verb == "elastic-status":
        # process-local, like rebalance-status: the elastic controller
        # lives in each partition leader's scheduler process
        import json
        from .. import metrics
        health = metrics.health_detail()
        detail = health.get("federation", {}).get("elastic", {})
        if not detail:
            out("no elastic state recorded — elastic membership is not "
                "enabled (or this process runs no partition leader)")
            return 1
        out(f"partitions={health.get('partition_count', 0)}\t"
            f"splits={health.get('partition_splits_total', {})}\t"
            f"merges={health.get('partition_merges_total', {})}")
        for pid in sorted(detail, key=int):
            d = detail[pid]
            out(f"p{pid}\tretiring={d.get('retiring', False)}\t"
                f"splits={d.get('splits', 0)}\t"
                f"merges={d.get('merges', 0)}\t"
                f"abstentions={d.get('abstentions', 0)}\t"
                f"refused={d.get('refused', 0)}\t"
                f"hot={d.get('hot_streak', 0)}\t"
                f"idle={d.get('idle_streak', 0)}\t"
                f"block_until={d.get('block_until', 0)}")
            for k in ("last_split", "last_merge"):
                if d.get(k):
                    out(f"p{pid}\t{k}={json.dumps(d[k], sort_keys=True)}")
        return 0
    if args.group == "device" and args.verb == "status":
        # process-local, like rebalance-status: the fleet cool-down lives
        # in the scheduler process. This package runs one device, so there
        # is no per-device lattice or mesh rung to show (ROADMAP item 10b)
        from .. import metrics
        detail = metrics.health_detail().get("device", {})
        out(f"fleet\tavailable={detail.get('available', True)}\t"
            f"consecutive_faults={detail.get('consecutive_faults', 0)}\t"
            f"total_faults={detail.get('total_faults', 0)}\t"
            f"last_kind={detail.get('last_kind')}\t"
            f"cooldown_remaining_s={detail.get('cooldown_remaining_s', 0.0)}")
        out("no per-device state: the multi-device mesh is not in "
            "volcano_tpu_torch yet (ROADMAP item 10b)")
        return 0
    if args.group == "job" and args.verb in ("suspend", "resume", "scale"):
        if funnel is not None:
            # the scheduler's elastic lifecycle path: submit journals the
            # verb (epoch-stamped), consume applies it at the next cycle
            # boundary — never a direct annotation write from here (VT020)
            uid = funnel.resolve_job(args.name, args.namespace)
            if uid is None:
                out(f"job {args.namespace}/{args.name} not known to the "
                    f"scheduler cache")
                return 1
            ok = funnel.submit(args.verb, uid,
                               getattr(args, "desired", None))
            if not ok:
                out(f"{args.verb} {args.namespace}/{args.name} rejected: "
                    f"stale fencing epoch")
                return 1
            out(f"{args.verb} {args.namespace}/{args.name} queued "
                f"(applies at the next cycle boundary)")
            return 0
        if args.verb == "scale":
            # no store fallback by design: a desired-members rewrite
            # outside the journaled funnel is exactly what VT020 forbids
            out("job scale requires the running scheduler's command "
                "funnel (in-process CLI: main(..., funnel=...))")
            return 1
    if store is None:
        out("no cluster store attached (in-process CLI requires a store)")
        return 1
    if args.group == "store":
        if args.verb == "status":
            from .. import metrics
            if hasattr(store, "current_rv"):
                out(f"resourceVersion={store.current_rv()}")
            for kind in getattr(store, "KINDS", ()):
                n = len(store.list(kind))
                if n:
                    out(f"{kind}\t{n}")
            counts = metrics.store_counts()
            for family in ("faults", "retries", "watch_resumes"):
                for key, v in sorted(counts[family].items()):
                    out(f"{family}/{key}\t{int(v)}")
            detail = metrics.health_detail().get("store", {})
            for stream in detail.get("streams", []):
                out(f"watch/{stream['kind']}\tlast_rv={stream['last_rv']}"
                    f"\ttorn={stream['torn']}"
                    f"\tresumes={stream['resumes']}"
                    f"\trelists={stream['relists']}")
            if "staleness" in detail:
                out(f"watch_staleness={detail['staleness']}")
            return 0
        build_parser().print_help()
        return 1
    if args.group == "federation":
        if args.verb == "status":
            import time as _time
            from ..leaderelection import partition_lease_name
            probe = args.partitions if args.partitions > 0 else 64
            found = 0
            for pid in range(probe):
                lease = store.get("Lease", args.namespace,
                                  partition_lease_name(args.name, pid))
                if lease is None:
                    if args.partitions > 0:
                        out(f"p{pid}\tholder=-\tno lease (partition idle "
                            f"or not federated)")
                        continue
                    break
                found += 1
                age = _time.time() - lease.renew_time if lease.renew_time \
                    else float("inf")
                live = age <= lease.lease_duration
                out(f"p{pid}\tholder={lease.holder or '-'}\t"
                    f"epoch={int(getattr(lease, 'epoch', 0))}\t"
                    f"renew_age_s={age:.1f}\t"
                    f"{'LIVE' if live else 'EXPIRED'}")
            if not found and args.partitions <= 0:
                out(f"no partition leases under {args.namespace}/"
                    f"{args.name}-p* — federation not enabled")
                return 1
            return 0
        build_parser().print_help()
        return 1
    if args.group == "leader":
        if args.verb == "status":
            import time as _time
            lease = store.get("Lease", args.namespace, args.name)
            if lease is None:
                out(f"no lease {args.namespace}/{args.name} — no leader "
                    f"elected (or HA not enabled)")
                return 1
            age = _time.time() - lease.renew_time if lease.renew_time \
                else float("inf")
            live = age <= lease.lease_duration
            out(f"holder={lease.holder or '-'}\t"
                f"epoch={int(getattr(lease, 'epoch', 0))}\t"
                f"renew_age_s={age:.1f}\t"
                f"lease_duration_s={lease.lease_duration}\t"
                f"{'LIVE' if live else 'EXPIRED'}")
            return 0
        build_parser().print_help()
        return 1
    if args.group == "job":
        jc = JobCommands(store)
        if args.verb == "run":
            jc.run(args.name, args.namespace, args.queue, args.replicas,
                   args.min, parse_requests(args.requests), args.image,
                   min_success=args.min_success)
        elif args.verb == "list":
            for j in jc.list(args.namespace):
                out(_fmt_job(j))
        elif args.verb == "view":
            j = jc.view(args.name, args.namespace)
            out(_fmt_job(j) if j else f"job {args.name} not found")
        elif args.verb == "suspend":
            jc.suspend(args.name, args.namespace)
        elif args.verb == "resume":
            jc.resume(args.name, args.namespace)
        elif args.verb == "delete":
            jc.delete(args.name, args.namespace)
        return 0
    if args.group == "queue":
        qc = QueueCommands(store)
        if args.verb == "create":
            qc.create(args.name, args.weight,
                      hierarchy=args.hierarchy,
                      hierarchy_weights=args.hierarchy_weights)
        elif args.verb == "get":
            q = qc.get(args.name)
            out(_fmt_queue(q) if q else f"queue {args.name} not found")
        elif args.verb == "list":
            for q in qc.list():
                out(_fmt_queue(q))
        elif args.verb == "operate":
            qc.operate(args.name, args.action)
        elif args.verb == "delete":
            qc.delete(args.name)
        return 0
    build_parser().print_help()
    return 1
