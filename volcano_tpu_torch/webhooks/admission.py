"""The admission webhooks, the JAX package's ``webhooks/admission.py``
(Volcano's ``pkg/webhooks/admission``).

- jobs/mutate    admission/jobs/mutate/
                 mutate_job.go:100-170 — defaults: queue, scheduler name,
                 maxRetry, minAvailable=Σreplicas, task names.
- jobs/validate  admission/jobs/validate/admit_job.go:46-330 — task name and
                 replica consistency, minAvailable bounds, policy legality,
                 queue existence/state.
- queues         admission/queues/{validate,mutate} — weight bounds, state
                 legality; defaults weight=1, reclaimable.
- pods           admission/pods/admit_pod.go:1-203 — gate bare-pod binding
                 on its PodGroup being schedulable.
- podgroups      admission/podgroups/mutate_podgroup.go — default queue.
"""

from __future__ import annotations

import re
from typing import Optional

from ..api import BusAction, BusEvent, QueueState
from ..api.queue_info import (KUBE_HIERARCHY_ANNOTATION_KEY,
                              KUBE_HIERARCHY_WEIGHT_ANNOTATION_KEY)
from ..apis.objects import Job, PodGroupCR, QueueCR
from ..store import AdmissionError, ObjectStore
from .router import AdmissionService, Router, deny

DNS1123 = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")

# policy legality table (admit_job.go checkPolicyDuplicate/validatePolicies)
_VALID_JOB_ACTIONS = set(BusAction)
_VALID_EVENTS = set(BusEvent)


def mutate_job(operation: str, job: Job, old) -> Job:
    """Defaulting patch (mutate_job.go:100-170)."""
    if not job.spec.queue:
        job.spec.queue = "default"
    if not job.spec.scheduler_name:
        job.spec.scheduler_name = "volcano"
    if job.spec.max_retry == 0:
        job.spec.max_retry = 3
    for i, task in enumerate(job.spec.tasks):
        if not task.name:
            task.name = f"default{i}"
    if job.spec.min_available == 0:
        job.spec.min_available = sum(t.replicas for t in job.spec.tasks)
    return job


def _validate_job_with_queues(job: Job, queue_of) -> None:
    """The job validation body (admit_job.go:46-330), with the queue
    lookup injected: the single-job webhook passes a store getter, the
    batched front door passes a dict prefetched ONCE per batch — the
    store-read amortization that keeps high-QPS intake from scaling
    admission cost with batch size (docs/federation.md)."""
    if not job.spec.tasks:
        deny("No task specified in job spec")
    total_replicas = 0
    names = set()
    for task in job.spec.tasks:
        if task.replicas < 0:
            deny(f"'replicas' < 0 in task: {task.name}")
        if task.min_available is not None:
            if task.min_available > task.replicas:
                deny(f"'minAvailable' is greater than 'replicas' in task: "
                     f"{task.name}")
        total_replicas += task.replicas
        if task.name in names:
            deny(f"duplicated task name {task.name}")
        if not DNS1123.match(task.name):
            deny(f"task name {task.name} is not a valid DNS-1123 label")
        names.add(task.name)
        _validate_policies(task.policies)
    if job.spec.min_available > total_replicas:
        deny("job 'minAvailable' should not be greater than total replicas "
             "in tasks")
    if job.spec.min_available < 0:
        deny("job 'minAvailable' must be >= 0")
    _validate_policies(job.spec.policies)
    queue: QueueCR = queue_of(job.spec.queue)
    if queue is None:
        deny(f"unable to find job queue: {job.spec.queue}")
    elif queue.status.state != QueueState.OPEN:
        deny(f"can only submit job to queue with state `Open`, "
             f"queue `{queue.metadata.name}` status is "
             f"`{queue.status.state.value}`")


def make_validate_job(store: ObjectStore):
    def validate_job(operation: str, job: Job, old) -> None:
        _validate_job_with_queues(
            job, lambda name: store.get("Queue", "default", name))

    return validate_job


def submit_job_batch(store: ObjectStore, jobs, budget=None,
                     priority_fn=None) -> list:
    """Batched job submission — the high-QPS front door
    (docs/federation.md): the whole batch is defaulted and validated
    against ONE prefetched queue read, then lands through ONE store
    write (``ObjectStore.create_batch``: one lock window, one watcher
    flush), instead of a store read + write + admission walk per job.

    Validation is all-or-nothing: any invalid job rejects the whole
    batch BEFORE anything is written, so a partially-admitted batch can
    never exist (same atomicity a transactional apiserver POST would
    give). Returns the created Job objects; raises AdmissionError with
    the first offending job named.

    ``budget`` (an :class:`webhooks.backpressure.AdmissionBudget`)
    gates the VALIDATED batch against the bounded pending-work budget
    (docs/robustness.md overload failure model): over-depth/over-bytes
    batches — and, past the shed watermark, low-priority ones — are
    refused with a typed ``BackpressureError`` carrying a
    ``retry_after_s`` hint derived from observed drain throughput,
    before anything is written. The batch's priority is the MINIMUM
    across its jobs (``priority_fn(job) -> int``; default resolves the
    job's PriorityClass through one prefetched store read), so a batch
    is only as shed-resistant as its least-deserving member."""
    from .. import metrics
    from .backpressure import estimate_job_bytes
    jobs = list(jobs)
    if not jobs:
        return []
    queues = {q.metadata.name: q for q in store.list("Queue")}
    prepared = []
    per_queue: dict = {}
    nbytes = 0.0
    for job in jobs:
        job = mutate_job("CREATE", job, None)
        try:
            _validate_job_with_queues(job, queues.get)
        except AdmissionError as exc:
            raise AdmissionError(
                f"batch rejected at job "
                f"{job.metadata.namespace}/{job.metadata.name}: {exc}"
            ) from None
        prepared.append(job)
        if budget is not None:
            tasks = sum(t.replicas for t in job.spec.tasks)
            per_queue[job.spec.queue] = \
                per_queue.get(job.spec.queue, 0) + tasks
            nbytes += estimate_job_bytes(tasks)
    if budget is not None:
        # the batch's priority only matters once a target queue is in
        # the shed band — below the watermark the floor is 0 by
        # construction. Passing a THUNK lets the gate resolve it under
        # its own lock exactly when a non-zero floor is hit: the common
        # unloaded case skips the PriorityClass store read entirely,
        # and a queue crossing the watermark concurrently cannot race a
        # stale outside peek (the floor and the priority resolve under
        # one lock).
        def batch_priority() -> int:
            resolve = priority_fn
            if resolve is None:
                classes = {pc.metadata.name: pc.value
                           for pc in store.list("PriorityClass")}

                def resolve(job, _classes=classes):
                    return _classes.get(job.spec.priority_class_name, 0)
            return min(int(resolve(j)) for j in prepared)

        # the backpressure gate: raises BackpressureError (nothing
        # written, nothing charged) or charges the whole batch
        budget.admit_batch(per_queue, nbytes, batch_priority)
    try:
        created = store.create_batch(prepared, admit=False)
    except BaseException:
        # the store refused the batch AFTER the budget charged it
        # (duplicate key, store fault): nothing was written, so the
        # charge must not outlive the call — a leaked charge would
        # ratchet the pending depth up on every failed submit until
        # the queue sheds everything forever
        if budget is not None:
            for ix, queue in enumerate(sorted(per_queue)):
                budget.credit(queue, per_queue[queue],
                              nbytes if ix == 0 else 0.0)
        raise
    metrics.observe_admission_batch(len(created))
    return created


def _validate_policies(policies) -> None:
    events = set()
    exit_codes = set()
    for policy in policies:
        if policy.action not in _VALID_JOB_ACTIONS:
            deny(f"invalid policy action {policy.action}")
        # event and exitCode clauses are mutually exclusive, and a policy
        # must carry one of them (validate/util.go:60-66)
        if policy.event is not None and policy.exit_code is not None:
            deny("must not specify event and exitCode simultaneously")
        if policy.event is None and policy.exit_code is None:
            deny("either event and exitCode should be specified")
        if policy.event is not None:
            if policy.event in events:
                deny(f"duplicate policy event {policy.event}")
            events.add(policy.event)
            if policy.event not in _VALID_EVENTS:
                deny(f"invalid policy event {policy.event}")
        if policy.exit_code is not None:
            if policy.exit_code == 0:
                deny("0 is not a valid error code")
            if policy.exit_code in exit_codes:
                deny(f"duplicate exitCode {policy.exit_code}")
            exit_codes.add(policy.exit_code)


def mutate_queue(operation: str, queue: QueueCR, old) -> QueueCR:
    if queue.spec.weight == 0:
        queue.spec.weight = 1
    return queue


def make_validate_queue(store: ObjectStore):
    def validate_queue(operation: str, queue: QueueCR, old) -> None:
        if operation == "DELETE":
            # validate_queue.go:199-215: the default queue is undeletable,
            # and only Closed queues may be deleted. k8s sends the object
            # being deleted as OldObject.
            target = old if old is not None else queue
            if target.metadata.name == "default":
                deny("`default` queue can not be deleted")
            live = store.get("Queue", target.metadata.namespace,
                             target.metadata.name) or target
            if live.status.state != QueueState.CLOSED:
                deny(f"only queue with state `Closed` can be deleted, "
                     f"queue `{live.metadata.name}` state is "
                     f"`{live.status.state.value}`")
            return
        if queue.spec.weight < 1:
            deny(f"queue weight must be a positive integer, got "
                 f"{queue.spec.weight}")
        if operation == "CREATE" and queue.status.state not in (
                QueueState.OPEN, QueueState.CLOSED):
            deny(f"queue state must be in [Open, Closed], got "
                 f"{queue.status.state.value}")
        _validate_hierarchy(store, queue)
    return validate_queue


def _validate_hierarchy(store: ObjectStore, queue: QueueCR) -> None:
    """Hierarchy annotation legality (validate_queue.go:113-168): path and
    weights lengths match, weights are positive numbers, and no queue may
    sit on another queue's sub path."""
    ann = queue.metadata.annotations
    hierarchy = ann.get(KUBE_HIERARCHY_ANNOTATION_KEY, "")
    weights = ann.get(KUBE_HIERARCHY_WEIGHT_ANNOTATION_KEY, "")
    if not hierarchy and not weights:
        return
    paths = hierarchy.split("/")
    wparts = weights.split("/")
    if len(paths) != len(wparts):
        deny(f"{KUBE_HIERARCHY_ANNOTATION_KEY} must have the same length "
             f"with {KUBE_HIERARCHY_WEIGHT_ANNOTATION_KEY}")
    for w in wparts:
        # Go's strconv.ParseFloat rejects underscores and surrounding
        # whitespace that Python's float() tolerates
        if w != w.strip() or "_" in w:
            deny(f"{w} in the {weights} is invalid number")
        try:
            wf = float(w)
        except ValueError:
            deny(f"{w} in the {weights} is invalid number")
        else:
            if wf <= 0:
                deny(f"{w} in the {weights} must be larger than 0")
    for other in store.list("Queue"):
        other_h = other.metadata.annotations.get(
            KUBE_HIERARCHY_ANNOTATION_KEY, "")
        if (other_h and other.metadata.name != queue.metadata.name
                and other_h.startswith(hierarchy)):
            deny(f"{hierarchy} is not allowed to be in the sub path of "
                 f"{other_h} of queue {other.metadata.name}")


def mutate_podgroup(operation: str, pg: PodGroupCR, old) -> PodGroupCR:
    if not pg.spec.queue:
        pg.spec.queue = "default"
    return pg


def validate_podgroup(operation: str, pg: PodGroupCR, old) -> None:
    """Reject malformed elastic-gang specs at the door
    (docs/design/elastic-gangs.md): a desired below min would make the
    min/desired decision class degenerate (the scheduler clamps, but the
    clamp is a crash-consistency net, not an API), and the suspend mark
    only takes "true"/"false" so the Command funnel's rewrites stay
    round-trippable."""
    from ..elastic_gang.membership import (ELASTIC_DESIRED_ANNOTATION,
                                           SUSPEND_ANNOTATION)
    ann = pg.metadata.annotations or {}
    if ELASTIC_DESIRED_ANNOTATION in ann:
        raw = ann[ELASTIC_DESIRED_ANNOTATION]
        try:
            desired = int(str(raw).strip())
        except (TypeError, ValueError):
            deny(f"invalid value <{raw}> for {ELASTIC_DESIRED_ANNOTATION}, "
                 f"it must be an integer")
        if desired < max(pg.spec.min_member, 1):
            deny(f"invalid value <{desired}> for "
                 f"{ELASTIC_DESIRED_ANNOTATION}: desired members must be "
                 f">= minMember ({pg.spec.min_member})")
    sus = ann.get(SUSPEND_ANNOTATION)
    if sus is not None and sus not in ("true", "false"):
        deny(f"invalid value <{sus}> for {SUSPEND_ANNOTATION}, "
             f"it must be \"true\" or \"false\"")


# pods webhook (admit_pod.go:1-203) ------------------------------------------

JDB_MIN_AVAILABLE = "volcano.sh/jdb-min-available"
JDB_MAX_UNAVAILABLE = "volcano.sh/jdb-max-unavailable"


def _validate_int_percentage(key: str, value: str) -> None:
    """admit_pod.go validateIntPercentageStr: positive int, or 1%-99%."""
    s = str(value).strip()
    if s.endswith("%"):
        try:
            v = int(s[:-1])
        except ValueError:
            deny(f"invalid value {s} for {key}")
        if v <= 0 or v >= 100:
            deny(f"invalid value <{s}> for {key}, it must be a valid "
                 f"percentage which between 1% ~ 99%")
        return
    try:
        v = int(s)
    except ValueError:
        deny(f"invalid type: neither int nor percentage for {key}")
    if v <= 0:
        deny(f"invalid value <{s}> for {key}, it must be a positive integer")


def make_validate_pod(store: ObjectStore, scheduler_name: str = "volcano"):
    """Gate bare-pod creation on its PodGroup phase (admit_pod.go
    validatePod): allow when the pod isn't ours, when the group is already
    schedulable, or when a normal pod has no group yet; deny while the
    group is Pending. Also validates disruption-budget annotations."""
    from ..api import PodGroupPhase
    from ..cache.store_wiring import GROUP_NAME_ANNOTATION

    def check_pg_phase(pod, pg_name: str, is_vc_job: bool) -> None:
        pg: PodGroupCR = store.get("PodGroup", pod.metadata.namespace,
                                   pg_name)
        if pg is None:
            if is_vc_job:
                deny(f"failed to get PodGroup for pod "
                     f"<{pod.metadata.namespace}/{pod.metadata.name}>")
            return
        if pg.status.phase == PodGroupPhase.PENDING:
            deny(f"failed to create pod <{pod.metadata.namespace}/"
                 f"{pod.metadata.name}> as the podgroup phase is Pending")

    def validate_pod(operation: str, pod, old) -> None:
        if pod.scheduler_name != scheduler_name:
            return
        pg_name = pod.metadata.annotations.get(GROUP_NAME_ANNOTATION, "")
        if pg_name:
            check_pg_phase(pod, pg_name, is_vc_job=True)
        else:
            # normal pod: the name the podgroup controller would generate
            check_pg_phase(pod, f"podgroup-{pod.metadata.uid}",
                           is_vc_job=False)
        budget_keys = [k for k in (JDB_MIN_AVAILABLE, JDB_MAX_UNAVAILABLE)
                       if k in pod.metadata.annotations]
        for key in budget_keys:
            _validate_int_percentage(key, pod.metadata.annotations[key])
        if len(budget_keys) > 1:
            deny(f"not allow configure multiple annotations "
                 f"<{[JDB_MIN_AVAILABLE, JDB_MAX_UNAVAILABLE]}> at same time")

    return validate_pod


def register_webhooks(store: ObjectStore) -> Router:
    """Self-registration analogue (cmd/webhook-manager/app/server.go:41-108):
    build the router, bind every admission service, attach to the store."""
    router = Router()
    router.register(AdmissionService(
        "/jobs/mutate", ["Job"], ["CREATE"], mutate_job, mutating=True))
    router.register(AdmissionService(
        "/jobs/validate", ["Job"], ["CREATE", "UPDATE"],
        make_validate_job(store)))
    router.register(AdmissionService(
        "/queues/mutate", ["Queue"], ["CREATE"], mutate_queue, mutating=True))
    router.register(AdmissionService(
        "/queues/validate", ["Queue"], ["CREATE", "UPDATE", "DELETE"],
        make_validate_queue(store)))
    router.register(AdmissionService(
        "/podgroups/mutate", ["PodGroup"], ["CREATE"], mutate_podgroup,
        mutating=True))
    router.register(AdmissionService(
        "/podgroups/validate", ["PodGroup"], ["CREATE", "UPDATE"],
        validate_podgroup))
    router.register(AdmissionService(
        "/pods", ["Pod"], ["CREATE"], make_validate_pod(store)))
    store.register_admission_hook(router.hook)
    return router
