"""The port's flight recorder (volcano_tpu_torch/obs) against the JAX
package's (volcano_tpu/obs) on the CPU: the same call sequences go through
both, in this one process (neither imports JAX), and their outputs must be
equal — the span trace's bytes, the validator's verdicts, the decision
audit's ring, dedupe and ``why``, the timeline store's exactly-once ingest
and LRU, the latency math, the SLO engine's windows, flow events, the
journal's timeline ingest and the metrics' SLO publication. Flows across
several process lanes: the federated sim's merged trace
(tests/test_torch_sim_federated.py)."""

import json
import random

import pytest

from volcano_tpu import metrics as jx_metrics
from volcano_tpu import obs as jx_obs
from volcano_tpu.api import FitErrors as JxFitErrors
from volcano_tpu.api import TaskStatus as JxTaskStatus
from volcano_tpu.cache.journal import JournalFollower
from volcano_tpu.obs import audit as jx_audit
from volcano_tpu.obs import export as jx_export
from volcano_tpu.obs import lifecycle as jx_lifecycle
from volcano_tpu.obs import slo as jx_slo
from volcano_tpu.obs import trace as jx_trace

from volcano_tpu_torch import metrics as pt_metrics
from volcano_tpu_torch import obs as pt_obs
from volcano_tpu_torch.api import FitErrors as PtFitErrors
from volcano_tpu_torch.api import TaskStatus as PtTaskStatus
from volcano_tpu_torch.cache.journal import ingest_timeline
from volcano_tpu_torch.obs import audit as pt_audit
from volcano_tpu_torch.obs import export as pt_export
from volcano_tpu_torch.obs import lifecycle as pt_lifecycle
from volcano_tpu_torch.obs import slo as pt_slo
from volcano_tpu_torch.obs import trace as pt_trace
from volcano_tpu_torch.obs import validate as pt_validate

SEED = 20261018

# one module of each package, by part
PKGS = {
    "jax": {"trace": jx_trace, "export": jx_export, "audit": jx_audit,
            "lifecycle": jx_lifecycle, "slo": jx_slo, "obs": jx_obs,
            "metrics": jx_metrics, "TaskStatus": JxTaskStatus,
            "FitErrors": JxFitErrors},
    "port": {"trace": pt_trace, "export": pt_export, "audit": pt_audit,
             "lifecycle": pt_lifecycle, "slo": pt_slo, "obs": pt_obs,
             "metrics": pt_metrics, "TaskStatus": PtTaskStatus,
             "FitErrors": PtFitErrors},
}


def both(fn):
    """``fn`` on each package's modules; returns (jax result, port
    result)."""
    return fn(PKGS["jax"]), fn(PKGS["port"])


@pytest.fixture(autouse=True)
def _clean_globals():
    """The recorders are process-wide in both packages: each test starts
    and ends with them clear."""
    for p in PKGS.values():
        p["obs"].TIMELINE.clear()
        p["obs"].AUDIT.clear()
        p["obs"].TRACE.clear()
    yield
    for p in PKGS.values():
        p["obs"].TIMELINE.clear()
        p["obs"].AUDIT.clear()
        p["obs"].TRACE.clear()
        p["obs"].TRACE.disable()


def test_public_surface_is_the_jax_packages():
    assert sorted(pt_obs.__all__) == sorted(jx_obs.__all__)
    for name in ("TraceRecorder", "AuditLog", "TimelineStore", "SLOEngine"):
        jx_cls, pt_cls = getattr(jx_obs, name), getattr(pt_obs, name)
        public = {n for n in dir(jx_cls) if not n.startswith("_")}
        assert public <= set(dir(pt_cls)), (name, public - set(dir(pt_cls)))


# -- spans --------------------------------------------------------------------

def _script_nested(rec):
    rec.begin_cycle(0)
    with rec.span("cycle", cycle=0):
        with rec.span("schedule"):
            with rec.span("open_session"):
                pass
            with rec.span("action:allocate", action="allocate"):
                with rec.span("solve", kernel="k", batch=3):
                    pass
        with rec.span("epilogue"):
            pass
    rec.end_cycle()


def _script_cycles_and_ambient(rec):
    with rec.span("ambient"):              # outside any cycle
        pass
    for c in range(5):
        rec.begin_cycle(c)
        with rec.span("cycle", cycle=c):
            if c % 2:
                with rec.span("audit"):
                    pass
        rec.end_cycle()
    rec.begin_cycle(5)                     # in flight: never exported
    with rec.span("cycle", cycle=5):
        pass


def _script_flows(rec):
    rec.set_pid(3)
    rec.begin_cycle(0)
    with rec.span("cycle", cycle=0):
        rec.flow_step("bind_intent", "job:a", task="a-0")
        rec.flow_step("bind_intent", "job:a", task="a-1")
        rec.flow_end("complete", "job:b")     # never opened: a no-op
        rec.flow_step("running_ack", "job:a", task="a-0")
        rec.flow_end("complete", "job:a")
        rec.flow_step("bind_intent", "job:a", task="a-2")   # re-opens
    rec.end_cycle()


def _script_exception(rec):
    rec.begin_cycle(0)
    try:
        with rec.span("cycle", cycle=0):
            with rec.span("action:x"):
                raise RuntimeError("boom")
    except RuntimeError:
        pass
    rec.end_cycle()


SCRIPTS = {"nested": _script_nested, "cycles": _script_cycles_and_ambient,
           "flows": _script_flows, "exception": _script_exception}


@pytest.mark.parametrize("max_cycles", [0, 2])
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_trace_dump_bytes_equal(name, max_cycles):
    def run(p):
        rec = p["trace"].TraceRecorder()
        rec.configure(max_cycles=max_cycles, logical=True)
        rec.enable()
        SCRIPTS[name](rec)
        rec.disable()
        return rec.dump(), rec.cycles_recorded(), rec.chrome_events()
    (jd, jn, je), (pd, pn, pe) = both(run)
    assert pd == jd
    assert (pn, pe) == (jn, je)
    assert pt_export.validate_chrome_trace(json.loads(pd)) \
        == jx_export.validate_chrome_trace(json.loads(jd))


def test_disabled_recorder_times_but_records_nothing():
    def run(p):
        rec = p["trace"].TraceRecorder()
        rec.begin_cycle(0)
        with rec.span("cycle") as sp:
            pass
        rec.end_cycle()
        return sp.dur_s >= 0.0, rec.chrome_events(), rec.dump()
    assert both(run)[0] == both(run)[1]


def test_wall_clock_is_monotonic_under_a_repeating_time_fn(tmp_path):
    """A virtual clock that repeats values is clamped to strictly
    increasing timestamps, as Chrome trace viewers need; ``dump`` writes
    the same file."""
    def run(p):
        rec = p["trace"].TraceRecorder(time_fn=lambda: 1.0)
        rec.enable()
        _script_nested(rec)
        path = tmp_path / (p["trace"].__name__ + ".json")
        rec.dump(str(path))
        return path.read_text(), p["export"].span_totals_ms(
            rec.chrome_events())
    (jt, jtot), (pt, ptot) = both(run)
    assert pt == jt and ptot == jtot


# -- validation -----------------------------------------------------------------

def _ev(ph, name, ts, pid=1, tid=1, **kw):
    return dict({"ph": ph, "name": name, "ts": ts, "pid": pid, "tid": tid},
                **kw)


BAD_TRACES = {
    "not-an-object": [],
    "no-list": {"traceEvents": {}},
    "missing-field": {"traceEvents": [{"ph": "B", "name": "x", "ts": 1}]},
    "bad-ph": {"traceEvents": [_ev("X", "x", 1)]},
    "ts-not-numeric": {"traceEvents": [_ev("B", "x", "1")]},
    "empty-name": {"traceEvents": [_ev("B", "", 1)]},
    "args-not-object": {"traceEvents": [_ev("B", "x", 1, args=[1])]},
    "ts-backwards": {"traceEvents": [_ev("B", "x", 2), _ev("E", "x", 1)]},
    "stray-E": {"traceEvents": [_ev("E", "x", 1)]},
    "bad-nesting": {"traceEvents": [_ev("B", "a", 1), _ev("B", "b", 2),
                                    _ev("E", "a", 3), _ev("E", "b", 4)]},
    "unclosed": {"traceEvents": [_ev("B", "a", 1)]},
    "flow-no-id": {"traceEvents": [_ev("s", "f", 1, cat="flow")]},
    "flow-t-before-s": {"traceEvents": [_ev("t", "f", 1, cat="flow", id=1)]},
    "flow-s-twice": {"traceEvents": [_ev("s", "f", 1, cat="flow", id=1),
                                     _ev("s", "f", 2, cat="flow", id=1)]},
}


@pytest.mark.parametrize("name", sorted(BAD_TRACES))
def test_validator_rejects_alike(name):
    def run(p):
        with pytest.raises(ValueError) as exc:
            p["export"].validate_chrome_trace(BAD_TRACES[name])
        return str(exc.value)
    j, p = both(run)
    assert p == j


def test_validator_counts_and_summaries_alike():
    events = [_ev("B", "cycle", 1), _ev("s", "f", 2, cat="flow", id=1),
              _ev("B", "solve", 3), _ev("t", "f", 4, cat="flow", id=1),
              _ev("E", "solve", 10), _ev("f", "f", 11, cat="flow", id=1),
              _ev("E", "cycle", 12), _ev("B", "cycle", 13, pid=2),
              _ev("E", "cycle", 20, pid=2)]
    obj = {"traceEvents": events}

    def run(p):
        ex = p["export"]
        return (ex.validate_chrome_trace(obj), ex.flow_summary(events),
                ex.span_totals_ms(events),
                ex.span_totals_ms(events, names=["solve"]),
                ex.chrome_trace(events, enabled=False, logical=True))
    j, p = both(run)
    assert p == j


def test_validate_cli(tmp_path, capsys):
    """The trace check and --flows run as the JAX package's do, and
    --metrics-scrape serves and scrapes the port's /metrics (exit 0)."""
    from volcano_tpu.obs import validate as jx_validate
    rec = pt_trace.TraceRecorder(logical=True)
    rec.enable()
    for c in range(2):
        rec.begin_cycle(c)
        with rec.span("cycle", cycle=c):
            with rec.span("schedule"):
                with rec.span("open_session"):
                    rec.flow_step("bind_intent", "job:a")
            rec.flow_end("complete", "job:a")
        rec.end_cycle()
    good = tmp_path / "good.json"
    rec.dump(str(good))
    partial = tmp_path / "partial.json"
    partial.write_text(json.dumps({"traceEvents": [
        _ev("B", "cycle", 1), _ev("E", "cycle", 2)]}))
    for argv in ([str(good)], ["--flows", str(good)], [str(partial)], []):
        assert pt_validate.main(argv) == jx_validate.main(argv), argv
    capsys.readouterr()
    assert pt_validate.main([str(good)]) == 0
    assert pt_validate.main(["--flows", str(good)]) == 1   # one lane
    try:
        assert pt_validate.main(["--metrics-scrape"]) == 0
    finally:
        pt_metrics.reset_local()
    assert "/metrics OK" in capsys.readouterr().out


# -- the decision audit --------------------------------------------------------

def _audit_stream(seed, n_cycles=12, n_jobs=9):
    rng = random.Random(seed)
    verdicts = ["admitted", "denied", "pipelined", "preempted"]
    cycles = []
    for c in range(n_cycles):
        recs, live = {}, set()
        for j in range(n_jobs):
            if rng.random() < 0.2:
                continue                      # completed: drops from live
            job = f"ns/job-{j}"
            live.add(job)
            if rng.random() < 0.7:
                v = rng.choice(verdicts)
                recs[job] = [{"job": job, "queue": f"q{j % 3}",
                              "verdict": v,
                              "reason": f"r{rng.randint(0, 2)}",
                              "cycle": c, "t": c * 1.0}]
        cycles.append((c, c * 1.0, recs, live))
    return cycles


@pytest.mark.parametrize("max_cycles, max_jobs", [(32, 8192), (3, 8192),
                                                  (5, 4), (0, 8192)])
def test_audit_ring_dedupe_and_why(max_cycles, max_jobs):
    stream = _audit_stream(SEED)

    def run(p):
        log = p["audit"].AuditLog(max_cycles=max_cycles, max_jobs=max_jobs)
        changed = [log.record_cycle(c, t, recs, live_jobs=live)
                   for c, t, recs, live in stream]
        queries = [log.why(f"ns/job-{j}") for j in range(9)]
        queries += [log.why(f"job-{j}") for j in range(9)]   # bare names
        queries.append(log.why("nobody"))
        return (changed, log.records(), log.records(job="ns/job-1"),
                log.records(last_cycles=2), log.cycles_retained(),
                log.jobs_evicted, log.enabled, queries)
    j, p = both(run)
    assert p == j
    if max_cycles:
        assert p[4] <= max_cycles


def test_audit_configure_resizes_like_the_environment(monkeypatch):
    """``configure(N)`` leaves the log as ``VOLCANO_TPU_AUDIT_CYCLES=N``
    builds it, 0 disabling it."""
    stream = _audit_stream(SEED + 1)
    for n in (0, 3, 100000):
        monkeypatch.setenv("VOLCANO_TPU_AUDIT_CYCLES", str(n))
        built = pt_audit.AuditLog()
        resized = pt_audit.AuditLog(max_cycles=32)
        resized.configure(n)
        for log in (built, resized):
            for c, t, recs, live in stream:
                log.record_cycle(c, t, recs, live_jobs=live)
        assert (resized.enabled, resized.max_cycles, resized.records()) \
            == (built.enabled, built.max_cycles, built.records())


class _Job:
    """The duck type harvest_cycle reads of a session's job."""

    def __init__(self, p, uid, queue, pending, pipelined, ready, placed,
                 min_available, fit, node_errors):
        ts = p["TaskStatus"]
        self.uid, self.queue = uid, queue
        self.task_status_index = {}
        if pending:
            self.task_status_index[ts.PENDING] = {
                f"{uid}-p{i}": None for i in range(pending)}
        if pipelined:
            self.task_status_index[ts.PIPELINED] = {
                f"{uid}-q{i}": None for i in range(pipelined)}
        self._ready, self._placed = ready, placed
        self.min_available = min_available
        self.job_fit_errors = fit
        self.nodes_fit_errors = {}
        for node, reasons in node_errors.items():
            fe = p["FitErrors"]()
            for r in reasons:
                fe.set_node_error(node, r)
            self.nodes_fit_errors[node] = fe

    def ready(self):
        return self._ready

    def ready_task_num(self):
        return self._placed

    def fit_error(self):
        return "" if self.job_fit_errors else "fallback: 2 nodes"


class _Session:
    def __init__(self, jobs, events):
        self.jobs = {j.uid: j for j in jobs}
        self.audit_events = events


def _session(p):
    jobs = [
        _Job(p, "ns/a", "q1", 0, 0, True, 4, 4, "", {}),
        _Job(p, "ns/b", "q1", 3, 0, False, 1, 4,
             "gang unschedulable: 1/4", {"n0": ["Insufficient cpu"]}),
        _Job(p, "ns/c", "q2", 2, 2, False, 0, 4, "", {}),
        _Job(p, "ns/d", "q2", 1, 0, False, 0, 2, "", {}),
        _Job(p, "ns/e", "q3", 0, 0, True, 2, 2, "", {}),
    ]
    events = [("bind", "ns/a-0", "ns/a", "n1"),
              ("bind", "ns/a-1", "ns/a", "n1"),
              ("evict", "ns/e-0", "ns/e", "preempt"),
              ("evict", "ns/e-1", "ns/e", "reclaim"),
              ("evict", "ns/f-0", "ns/f", "")]
    return _Session(jobs, events)


def test_harvest_cycle_records_alike():
    """The harvest's verdicts and reasons (binds, evictions by reason,
    pipelined and denied gangs with their fit-error text) and its tee into
    the timelines."""
    def run(p):
        log = p["audit"].AuditLog(max_cycles=8)
        n = [p["audit"].harvest_cycle(_session(p), c, 10.0 + c, log=log)
             for c in range(3)]
        tl = p["obs"].TIMELINE
        return (n, log.records(), log.why("b"),
                [(job, tl.events(job)) for job in tl.jobs()])
    j, p = both(run)
    assert p == j
    assert {r["verdict"] for r in p[1]} == {
        "admitted", "denied", "pipelined", "preempted", "evicted"}


def test_fit_errors_text_is_the_jax_packages():
    """Denial reasons quote FitErrors' text: the operator reads it."""
    def run(p):
        fe = p["FitErrors"]()
        fe.set_node_error("n0", "Insufficient cpu")
        fe.set_node_error("n1", "Insufficient cpu")
        fe.set_node_error("n2", "node(s) had taints")
        return fe.error()
    j, p = both(run)
    assert p == j


# -- the timeline store ------------------------------------------------------

def _timeline_script(store, seed, n_jobs=12, n_events=200):
    rng = random.Random(seed)
    kinds = ["arrival", "bind_intent", "bind", "running", "admitted",
             "evicted", "complete", "solve", "grow"]
    held = []
    for i in range(n_events):
        if i % 17 == 0:
            store.set_context(cycle=i // 17, part=rng.randint(0, 1),
                              epoch=rng.randint(0, 2), t=i * 0.5)
        job = f"ns/job-{rng.randrange(n_jobs)}"
        ev = rng.choice(kinds)
        if held and rng.random() < 0.15:
            store.ingest(*rng.choice(held))             # a replay
            continue
        if rng.random() < 0.3:
            ctx = store.stamp(part=rng.randint(0, 2))
            if ctx is not None:
                held.append((job, ev, ctx))
                store.record(job, ev, ctx=ctx, node=f"n{i % 5}")
            continue
        store.record(job, ev, t=i * 0.25 if rng.random() < 0.5 else None,
                     queue=f"q{rng.randint(1, 3)}" if ev == "arrival"
                     else None, verdict="denied" if ev == "solve" else None)
    store.ingest("ns/job-0", "move", "not-a-ctx")


@pytest.mark.parametrize("max_jobs, max_events", [(8192, 256), (4, 256),
                                                  (8192, 5), (3, 2)])
def test_timeline_store_alike(max_jobs, max_events):
    def run(p):
        store = p["lifecycle"].TimelineStore(max_jobs=max_jobs,
                                             max_events=max_events)
        _timeline_script(store, SEED)
        jobs = store.jobs()
        return (jobs, [store.events(j) for j in jobs],
                [store.timeline(j) for j in jobs], store.stats(),
                store.timeline("job-3"), store.first("ns/job-1", "bind"),
                store.latest("ns/job-1", "bind", "running"), store.now(),
                store.job_count())
    j, p = both(run)
    assert p == j
    assert p[3]["duplicates_dropped"] > 0


def test_timeline_exactly_once_and_clear_resets_eids():
    def run(p):
        store = p["lifecycle"].TimelineStore()
        store.set_context(cycle=4, part=1, epoch=2, t=3.0)
        ctx = store.stamp()
        first = store.record("j", "bind_intent", ctx=ctx)
        again = store.ingest("j", "bind_intent", dict(ctx))
        store.clear()
        after = store.stamp()
        store.enabled = False
        return first, again, store.stats(), after, store.stamp(), \
            store.record("j", "x")
    j, p = both(run)
    assert p == j
    assert p[0] is True and p[1] is False and p[3]["eid"] == 1


def test_latency_math_and_why_alike():
    def run(p):
        lc = p["lifecycle"]
        tl, audit = p["obs"].TIMELINE, p["obs"].AUDIT
        _timeline_script(tl, SEED + 2)
        for k in range(6):
            job = f"ns/job-{k}"
            tl.record(job, "arrival", t=1.0 * k, queue=f"q{k % 2}")
            tl.record(job, "bind_intent", t=2.0 + k)
            tl.record(job, "bind", t=2.5 + k)
            tl.record(job, "running", t=3.0 + k)
            tl.record(job, "admitted", t=3.5 + k)
            tl.record(job, "complete", t=9.0 + 2 * k)
            tl.record(job, "solve", t=1.5 + k, verdict="denied",
                      reason="gang")
        audit.record_cycle(7, 7.0, {"ns/job-2": [{
            "job": "ns/job-2", "queue": "q0", "verdict": "denied",
            "reason": "x", "cycle": 7, "t": 7.0}]})
        return ([lc.job_latency(tl.events(j)) for j in tl.jobs()],
                lc.latency_classes(tl), lc.why("job-2"), lc.why("ns/job-4"),
                lc.why("missing"))
    j, p = both(run)
    assert p == j


# -- the SLO engine ------------------------------------------------------------

def _slo_store(p, seed):
    store = p["lifecycle"].TimelineStore()
    rng = random.Random(seed)
    for k in range(40):
        job = f"ns/job-{k}"
        t0 = rng.uniform(0, 200)
        store.record(job, "arrival", t=t0, queue=rng.choice(["a", "b", ""]))
        if rng.random() < 0.9:
            store.record(job, "bind_intent", t=t0 + rng.uniform(0, 3))
            store.record(job, "bind", t=t0 + rng.uniform(0, 20))
            store.record(job, "running", t=t0 + rng.uniform(3, 25))
            store.record(job, "admitted", t=t0 + rng.uniform(0, 30))
        if rng.random() < 0.7:
            store.record(job, "complete", t=t0 + rng.uniform(30, 300))
    return store


@pytest.mark.parametrize("now", [0.0, 150.0, 260.0, 600.0])
@pytest.mark.parametrize("period", [1.0, 0.5])
def test_slo_engine_windows_alike(period, now):
    def run(p):
        s = p["slo"]
        objectives = s.default_slos(period) + [
            s.SLO("ack", "ack_latency", threshold_s=5.0, target=0.9,
                  windows=(10.0, 50.0), queue="a"),
            s.SLO("jct-b", "jct", threshold_s=100.0, queue="b")]
        engine = s.SLOEngine(objectives)
        return (engine.evaluate(_slo_store(p, SEED), now=now),
                s.SLOEngine(period=period).evaluate(
                    p["lifecycle"].TimelineStore(), now=now))
    j, p = both(run)
    assert p == j


def test_slo_refuses_unknown_metrics_alike():
    def run(p):
        with pytest.raises(ValueError) as exc:
            p["slo"].SLO("x", "latency", 1.0)
        return str(exc.value)
    j, p = both(run)
    assert p == j


def test_slo_publish_reaches_health_detail_alike():
    def run(p):
        p["metrics"].reset_local()
        status = p["slo"].SLOEngine(period=1.0).publish(
            _slo_store(p, SEED + 5), now=120.0)
        # a second evaluation replaces the first wholesale
        p["metrics"].set_slo_status(status[:1])
        return status, p["metrics"].health_detail()["slo"]
    try:
        j, p = both(run)
    finally:
        jx_metrics.reset_local()
        pt_metrics.reset_local()
    assert p == j
    pt_metrics.set_slo_status(p[0])
    gauges = pt_metrics.local_gauges()
    for obj in p[0]:
        assert gauges[("slo_compliance", obj["slo"])] == obj["compliance"]
        for w, rate in obj["burn_rate"].items():
            assert gauges[("slo_burn_rate", obj["slo"], w)] == rate
    pt_metrics.reset_local()


def test_audit_eviction_warns_in_health_detail():
    try:
        log = pt_audit.AuditLog(max_cycles=4, max_jobs=2)
        for c, t, recs, live in _audit_stream(SEED + 3):
            log.record_cycle(c, t, recs, live_jobs=live)
        detail = pt_metrics.health_detail()["overload"]
        assert detail["audit_latest_evicted_total"] == log.jobs_evicted > 0
        assert any(w.startswith("audit_latest_evicted=")
                   for w in detail["warnings"])
    finally:
        pt_metrics.reset_local()


# -- the journal's timeline ingest -------------------------------------------

def _journal_records():
    ctx = lambda eid, part=0: {"cycle": 3, "part": part, "epoch": 1,  # noqa
                               "eid": eid}
    return [
        {"kind": "intent", "seq": 1, "op": "bind", "task": "a-0",
         "job": "a", "node": "n1", "ctx": ctx(1)},
        {"kind": "intent", "seq": 2, "op": "evict", "task": "b-0",
         "job": "b", "node": "n2", "ctx": ctx(2)},
        {"kind": "elastic_grow", "seq": 3, "job": "a", "task": "a-2",
         "node": "n3", "reason": "grow", "ctx": ctx(3)},
        {"kind": "elastic_shrink", "seq": 4, "job": "a", "task": "a-2",
         "node": "n3", "reason": "pressure", "ctx": ctx(4, part=1)},
        {"kind": "queue_move_done", "seq": 5, "queue": "q1", "frm": 0,
         "to": 1, "jobs": {"a": ctx(5), "c": ctx(6), "d": "bad"}},
        {"kind": "command_applied", "seq": 6, "job": "a", "ctx": ctx(7)},
        {"kind": "intent", "seq": 7, "op": "bind", "task": "e-0",
         "job": "e", "node": "n1"},                      # no ctx
        {"kind": "intent", "seq": 1, "op": "bind", "task": "a-0",
         "job": "a", "node": "n1", "ctx": ctx(1)},       # a replay
    ]


def test_journal_ingest_is_the_followers():
    """The port's ``ingest_timeline`` continues timelines from journal
    records as the JAX package's warm standby does, exactly once."""
    def run(p):
        tl = p["obs"].TIMELINE
        if p is PKGS["jax"]:
            follower = JournalFollower(cache=None)
            for rec in _journal_records():
                follower._ingest_timeline(rec)
        else:
            for rec in _journal_records():
                ingest_timeline(rec)
        return [(job, tl.events(job)) for job in tl.jobs()], tl.stats()
    j, p = both(run)
    assert p == j
    assert p[1]["duplicates_dropped"] == 1


def test_journal_records_carry_the_ctx(tmp_path):
    """An intent's ctx rides its durable record and survives a reopen and
    a rotation, as the JAX journal's does."""
    from volcano_tpu.cache.journal import IntentJournal as JxJournal
    from volcano_tpu_torch.cache.journal import IntentJournal as PtJournal

    class _Task:
        uid, job, node_name = "a-0", "a", "n1"

    def run(journal_cls, name):
        path = tmp_path / name
        j = journal_cls(str(path))
        j.record_intent("bind", _Task(), ctx={"cycle": 1, "part": 0,
                                              "epoch": 0, "eid": 9})
        j.record_intent("evict", _Task())
        j.flush()
        lines = path.read_text().splitlines()
        j.close()
        reopened = journal_cls(str(path))
        ctxs = [it.ctx for it in reopened.unacked()]
        reopened._rotate()
        rotated = path.read_text().splitlines()
        reopened.close()
        return lines, ctxs, rotated
    assert run(PtJournal, "port.wal") == run(JxJournal, "jax.wal")
