"""The metrics endpoint of volcano_tpu_torch (``metrics``: the series the
shell, the plugins, preempt and the cache publish, ``fallback_exposition``,
``start_metrics_server``'s /metrics, /healthz and /debug, and
``obs.validate --metrics-scrape``), held to the JAX package's.

- The same small cycle through both packages' shells: the port's /metrics
  body has the JAX package's ``fallback_exposition()`` families, label
  sets, counter and gauge values and each duration summary's ``_count``
  (the ``_sum``s are wall time and differ). The JAX package serves
  prometheus_client's exposition when that is installed, so its fallback
  is called directly; the port never imports prometheus_client.
- tests/test_system_e2e.py's test_metrics_healthz_endpoint, ported, and
  the endpoints' other answers.
- The binaries' --listen-address and --native-store.
"""

import json
import signal
import socket
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import pytest

import volcano_tpu.metrics as jax_metrics
import volcano_tpu.obs as jax_obs
import volcano_tpu_torch.metrics as pt_metrics
import volcano_tpu_torch.obs as pt_obs
from volcano_tpu_torch.obs import validate as pt_validate

import torch_parity as tp

REPO = Path(__file__).resolve().parents[1]

SERIES_CONF = """
actions: "enqueue, allocate, preempt, reclaim, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


class FixedClock:
    """A clock that never moves: every age and deadline the cycle reads is
    the same in both packages."""

    def time(self) -> float:
        return 1e6

    now = time

    def sleep(self, seconds: float) -> None:
        pass


def _cycles(port: bool) -> bytes:
    """Two cycles of SERIES_CONF (host engines: allocate, preempt and
    reclaim by callbacks) over tests/torch_parity.py's tight preempt mix,
    through one package's shell; that package's exposition after."""
    from volcano_tpu_torch.cache.transfer import cache_from_world
    jax_cache = tp._tight_mix()
    if port:
        from volcano_tpu_torch import Scheduler
        cache = cache_from_world(tp.world_from_cache(jax_cache))
        metrics, extra = pt_metrics, {"device": "cpu"}
    else:
        from volcano_tpu.scheduler import Scheduler
        cache, metrics, extra = jax_cache, jax_metrics, {}
    clock = FixedClock()
    cache.time_fn = cache.resync_queue.time_fn = clock.time
    cache.inflight.time_fn = clock.time
    sched = Scheduler(cache, conf_text=SERIES_CONF, clock=clock, **extra)
    metrics.reset_local()
    for _ in range(2):
        assert sched.run_once() == []
    return metrics.fallback_exposition()


def _without_sums(body: bytes) -> list:
    return [line for line in body.decode().splitlines()
            if not line.split(" ")[0].split("{")[0].endswith("_sum")]


def test_exposition_equals_jax_fallback():
    """Families, label sets, values and summary counts, line for line."""
    try:
        want = _cycles(port=False)
        got = _cycles(port=True)
    finally:
        jax_metrics.reset_local()
        pt_metrics.reset_local()
    assert _without_sums(got) == _without_sums(want)
    text = got.decode()
    for family in ("volcano_plugin_scheduling_latency_microseconds",
                   "volcano_queue_allocated_milli_cpu",
                   "volcano_snapshot_dirty_ratio",
                   "volcano_e2e_scheduling_latency_milliseconds",
                   "volcano_action_scheduling_latency_microseconds"):
        assert f"# TYPE {family} " in text, family
    assert pt_validate.parse_sample_count(text) > 0


# proportion's arguments: the JAX package's signature, and the values of
# them that both mirrors keep (the port's signature)
QUEUE_ARGS = ("q1", 1000.0, 2048.0, 500.0, 1024.0, 0.5, 3)
PORT_ARGS = {"update_queue_metrics": lambda a: ((a[0], a[1]),
                                                {"share": a[5]})}


@pytest.mark.parametrize("calls", [
    [("update_queue_metrics", QUEUE_ARGS)],
    [("update_unschedule_task_count", ("job-a", 2)),
     ("register_unschedule_job", ()), ("register_unschedule_job", ())],
    [("update_preemption_victims", (4,)),
     ("register_preemption_attempt", (3,))],
    [("update_plugin_duration", ("gang", "OnSessionOpen", 0.002)),
     ("update_plugin_duration", ("proportion", "OnSessionClose", 0.001))],
    [("update_snapshot_stats", (12, 0.25)),
     ("set_drift_verify_stats", (3, 0.01)),
     ("set_tensor_epochs_live", (2,))],
    [("set_store_watch_staleness", (4,)),
     ("register_store_retry", ("bind", "retry")),
     ("set_slo_status", ([{"slo": "e2e", "compliance": 0.9,
                           "burn_rate": {"5m": 1.5}}],))],
], ids=["queue", "gang", "preempt", "plugin", "snapshot", "store-slo"])
def test_series_exposed_as_jax(calls):
    """Each series the port added, called alike in both packages, renders
    to the same exposition bytes (no duration here is a clock's)."""
    out = []
    for metrics in (jax_metrics, pt_metrics):
        metrics.reset_local()
        try:
            for name, args in calls:
                kwargs = {}
                if metrics is pt_metrics and name in PORT_ARGS:
                    args, kwargs = PORT_ARGS[name](args)
                getattr(metrics, name)(*args, **kwargs)
            out.append(metrics.fallback_exposition())
        finally:
            metrics.reset_local()
    assert out[1] == out[0]


def _unschedulable_snapshot(prefix: str) -> dict:
    """One node of 4 cores and two gangs of two 4-core pods under
    ``prefix``: neither gang fits, so the gang plugin's close sets both
    jobs' unschedule_tasks gauges."""
    from volcano_tpu_torch.api import (JobInfo, NodeInfo, PodGroup,
                                       PodGroupPhase, QueueInfo, Resource,
                                       TaskInfo)
    from volcano_tpu_torch.rpc import encode_snapshot
    alloc = Resource(4000, 16 << 30)
    alloc.max_task_num = 110
    jobs = []
    for j in range(2):
        name = f"{prefix}{j}"
        pg = PodGroup(name=name, queue="default", min_member=2,
                      phase=PodGroupPhase.INQUEUE)
        job = JobInfo(uid=name, name=name, queue="default", min_available=2,
                      podgroup=pg, creation_timestamp=float(j))
        for t in range(2):
            job.add_task_info(TaskInfo(uid=f"{name}-{t}", name=f"{name}-{t}",
                                       job=name,
                                       resreq=Resource(4000, 1 << 30)))
        jobs.append(job)
    return encode_snapshot([NodeInfo(name="n0", allocatable=alloc)], jobs,
                           [QueueInfo(name="default", weight=1)])


def test_unschedule_gauges_hold_only_the_last_sessions_jobs():
    """The sidecar answers snapshot after snapshot in one process: after a
    request whose jobs are all new, the exposition's unschedule_tasks
    gauges name only that request's jobs."""
    from volcano_tpu_torch.rpc import SchedulerService
    service = SchedulerService(device="cpu")
    pt_metrics.reset_local()
    try:
        service.schedule(_unschedulable_snapshot("first"))
        service.schedule(_unschedulable_snapshot("second"))
        text = pt_metrics.fallback_exposition().decode()
    finally:
        pt_metrics.reset_local()
    gauges = [line for line in text.splitlines()
              if line.startswith("volcano_unschedule_task_count{")]
    assert sorted(line.split('"')[1] for line in gauges) == [
        "second0", "second1"], gauges


# -- the endpoints ------------------------------------------------------------------

@pytest.fixture
def server():
    srv = pt_metrics.start_metrics_server(0, "127.0.0.1")
    yield srv
    srv.shutdown()
    srv.server_close()
    pt_metrics.reset_local()


def _get(srv, path):
    url = f"http://127.0.0.1:{srv.server_address[1]}{path}"
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers.get("Content-Type"), err.read()


def test_metrics_healthz_endpoint(server):
    """tests/test_system_e2e.py's test: /healthz and /metrics answer."""
    status, _, body = _get(server, "/healthz")
    assert (status, body) == (200, b"ok")
    status, ctype, _ = _get(server, "/metrics")
    assert status == 200 and ctype.startswith("text/plain; version=0.0.4")


def test_healthz_degraded_and_detail(server):
    pt_metrics.set_health(pt_metrics.DEGRADED, 3)
    status, _, body = _get(server, "/healthz")
    assert status == 503
    assert body == b"degraded (3 consecutive failed cycles)"
    status, ctype, body = _get(server, "/healthz?detail")
    assert status == 503 and ctype == "application/json"
    detail = json.loads(body)
    assert detail == json.loads(json.dumps(pt_metrics.health_detail()))
    assert detail["consecutive_failures"] == 3
    for section in ("dead_letter_size", "state_drift_total",
                    "journal_replayed_total", "inflight",
                    "inflight_expired_total", "device", "store", "leader",
                    "federation", "overload", "slo"):
        assert section in detail, section


def test_health_detail_has_the_jax_sections():
    """health_detail()'s sections are the JAX package's, the per-device
    lattice and the mesh aside (the multi-device engines)."""
    for m in (jax_metrics, pt_metrics):
        m.reset_local()
    assert sorted(pt_metrics.health_detail()) \
        == sorted(jax_metrics.health_detail())


def test_debug_endpoints(server):
    """/debug/why and /debug/timeline: 400 without a job, 404 for a job
    with no record, 200 with the timeline-backed JSON once the job has
    one; /debug/traces serves the recorder's ring; other paths 404."""
    assert _get(server, "/debug/why")[0] == 400
    status, _, body = _get(server, "/debug/timeline?job=default/nope")
    assert status == 404 and "jobs_retained" in json.loads(body)
    status, _, body = _get(server, "/debug/why?job=default/nope")
    assert status == 404 and "cycles_retained" in json.loads(body)
    pt_obs.AUDIT.clear()
    pt_obs.TIMELINE.clear()
    try:
        pt_obs.TIMELINE.record("default/j", "arrival", queue="q1")
        pt_obs.TIMELINE.record("default/j", "solve", verdict="denied",
                               reason="gang", cycle=3)
        status, ctype, body = _get(server, "/debug/timeline?job=default/j")
        assert status == 200 and ctype == "application/json"
        assert json.loads(body) == json.loads(json.dumps(
            pt_obs.TIMELINE.timeline("default/j"), sort_keys=True))
        status, _, body = _get(server, "/debug/why?job=default/j")
        assert status == 200
        assert json.loads(body)["first_denied_cycle"] == 3
    finally:
        pt_obs.TIMELINE.clear()
    status, _, body = _get(server, "/debug/traces")
    assert status == 200 and "traceEvents" in json.loads(body)
    assert _get(server, "/nowhere")[0] == 404


def test_debug_why_matches_jax():
    """The same timeline in both packages gives the same /debug/why and
    /debug/timeline bodies."""
    bodies = []
    for metrics, obs in ((jax_metrics, jax_obs), (pt_metrics, pt_obs)):
        # the 404 body counts the audit ring's cycles: process state that
        # earlier cycles in this process left
        obs.AUDIT.clear()
        obs.TIMELINE.clear()
        obs.TIMELINE.record("default/j", "arrival", queue="q1")
        obs.TIMELINE.record("default/j", "solve", verdict="denied",
                            reason="gang", cycle=3)
        srv = metrics.start_metrics_server(0, "127.0.0.1")
        try:
            bodies.append([_get(srv, p)[::2] for p in (
                "/debug/why?job=default/j", "/debug/timeline?job=default/j",
                "/debug/why?job=default/x")])
        finally:
            srv.shutdown()
            srv.server_close()
            obs.TIMELINE.clear()
    assert bodies[1] == bodies[0]




def test_metrics_scrape_without_prometheus_client():
    """python -m volcano_tpu_torch.obs.validate --metrics-scrape exits 0,
    and the port never imports prometheus_client (the card machine has
    none)."""
    code = ("import sys\n"
            "from volcano_tpu_torch.obs import validate\n"
            "rc = validate.main(['--metrics-scrape'])\n"
            "assert 'prometheus_client' not in sys.modules\n"
            "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "/metrics OK" in proc.stdout


def test_malformed_exposition_fails_the_grammar():
    with pytest.raises(ValueError, match="malformed"):
        pt_validate.parse_sample_count('volcano_x{a="b"} not-a-number\n')
    assert pt_validate.parse_sample_count(
        '# HELP x y\n# TYPE x gauge\nx 1.0\nx{a="b"} 2.0\n') == 2


# -- the binaries -------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("binary,flags", [
    ("vc-scheduler", ["--device", "cpu", "--native-store"]),
    ("vc-controller-manager", ["--native-store"]),
], ids=["scheduler", "controller-manager"])
def test_binary_listen_address_and_native_store(binary, flags):
    """--listen-address serves /healthz and /metrics, --native-store backs
    the store with the C++ one, and SIGTERM ends the process with 0."""
    import time
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "volcano_tpu_torch.cmd", binary, *flags,
         "--listen-address", str(port)], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 60
        body = None
        while time.time() < deadline and body is None:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                    body = r.read()
            except OSError:
                assert proc.poll() is None, proc.communicate()[1]
                time.sleep(0.2)
        assert body == b"ok"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=5) as r:
            assert r.status == 200
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    assert rc == 0, proc.stderr.read()
