"""The snapshot RPC of volcano_tpu_torch (``rpc/``: the version-1 wire, the
SchedulerService, admission over the wire, the length-prefixed TCP server)
and its sidecar binary, held to the JAX package's.

- tests/test_rpc.py's tests, each on the port, at a small size (its
  10k-pod test runs the 1k world; the 10k world is the card's, in
  chip_smoke.py's ``rpc`` phase, against tests/rpc_reference_digests.json).
- The wire between the packages: the port's encoding of a world is the JAX
  package's byte for byte, and the port's decisions on the same message
  equal the JAX SchedulerService's (tests/torch_parity.py's RPC_WORLDS,
  the JAX side in a child without FMA contraction).
- The port's own rules: the service solves on the card unless asked for
  the CPU, refuses a conf and a snapshot with pod affinity by name, and a
  kernel's failure is the wire's error, never a host re-solve.
"""

import json
import pathlib
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

import volcano_tpu.api as jax_api
import volcano_tpu_torch.api as pt_api
from volcano_tpu.rpc import encode_snapshot as jax_encode
from volcano_tpu_torch.api import (NodeInfo, Resource, TaskStatus)
from volcano_tpu_torch.cache import FakeBinder, FakeEvictor, SchedulerCache
from volcano_tpu_torch.framework import (close_session, get_action,
                                         open_session, parse_scheduler_conf)
from volcano_tpu_torch.rpc import (SchedulerService, SnapshotClient,
                                   decode_snapshot, encode_snapshot, serve)

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
GI = 1 << 30


def build_world():
    return tp.rpc_small_world(pt_api)


def inprocess_binds(nodes, jobs, queues):
    conf = parse_scheduler_conf(None)
    binder = FakeBinder()
    cache = SchedulerCache(binder=binder, evictor=FakeEvictor(),
                           default_queue="")
    for q in queues:
        cache.add_queue(q)
    for n in nodes:
        cache.add_node(n)
    for j in jobs:
        cache.add_job(j)
    ssn = open_session(cache, conf.tiers, conf.configurations, device="cpu")
    for name in conf.actions:
        get_action(name).execute(ssn)
    close_session(ssn)
    return dict(binder.binds)


@pytest.fixture
def sidecar():
    """A CPU sidecar on a free port, shut down after the test."""
    server, _, port = serve(device="cpu")
    client = SnapshotClient("127.0.0.1", port)
    yield server, client
    client.close()
    server.shutdown()
    server.server_close()


# -- the codec ----------------------------------------------------------------

def test_codec_roundtrip():
    nodes, jobs, queues = build_world()
    msg = json.loads(json.dumps(encode_snapshot(nodes, jobs, queues)))
    nodes2, jobs2, queues2 = decode_snapshot(msg)
    assert [n.name for n in nodes2] == [n.name for n in nodes]
    assert nodes2[0].idle.cpu == nodes[0].idle.cpu  # filler accounted
    assert {j.uid for j in jobs2} == {j.uid for j in jobs}
    job0 = next(j for j in jobs2 if j.uid == "job0")
    assert job0.min_available == 2 and len(job0.tasks) == 2
    filler = next(j for j in jobs2 if j.uid == "filler")
    assert filler.tasks["filler-0"].status == TaskStatus.RUNNING
    assert filler.tasks["filler-0"].node_name == "n0"
    assert {q.name for q in queues2} == {"default", "best"}


def test_codec_preserves_external_usage_and_timestamps():
    """The wire's usage vectors are authoritative: what pods outside the
    jobs array hold survives, as do creation times and preemption
    attributes."""
    nodes, jobs, queues = build_world()
    ghost = Resource(3000, 6 * GI)
    nodes[1].idle.sub(ghost)
    nodes[1].used.add(ghost)
    jobs[0].tasks["job0-0"].preemptable = True
    jobs[0].tasks["job0-0"].revocable_zone = "rz1"
    msg = encode_snapshot(nodes, jobs, queues)
    nodes2, jobs2, _ = decode_snapshot(json.loads(json.dumps(msg)))
    n1 = next(n for n in nodes2 if n.name == "n1")
    assert n1.idle.cpu == nodes[1].idle.cpu
    assert n1.used.memory == nodes[1].used.memory
    job0 = next(j for j in jobs2 if j.uid == "job0")
    assert job0.creation_timestamp == jobs[0].creation_timestamp
    t = job0.tasks["job0-0"]
    assert t.creation_timestamp == 0.0
    assert t.preemptable and t.revocable_zone == "rz1"


def test_codec_host_ports_survive_the_wire():
    """hostPort claims round-trip: a placed task's ports are counted on its
    node, so the NodePorts predicate works behind the sidecar."""
    nodes, jobs, queues = build_world()
    filler = next(j for j in jobs if j.uid == "filler")
    filler.tasks["filler-0"].host_ports = [("0.0.0.0", "TCP", 8080)]
    pending = next(j for j in jobs if j.uid == "job0")
    pending.tasks["job0-0"].host_ports = [("0.0.0.0", "TCP", 8080)]
    msg = json.loads(json.dumps(encode_snapshot(nodes, jobs, queues)))
    nodes2, jobs2, _ = decode_snapshot(msg)
    n0 = next(n for n in nodes2 if n.name == "n0")
    assert n0.used_ports == {("0.0.0.0", "TCP", 8080): 1}
    job0 = next(j for j in jobs2 if j.uid == "job0")
    assert job0.tasks["job0-0"].host_ports == [("0.0.0.0", "TCP", 8080)]
    assert n0.has_port_conflict(job0.tasks["job0-0"])


@pytest.mark.parametrize("world", ["small", "1k"])
def test_codec_wire_equals_jax(world):
    """The same world encodes to the same JSON in both packages, and a
    message decoded by the port encodes back to itself."""
    if world == "small":
        got = encode_snapshot(*tp.rpc_small_world(pt_api))
        want = jax_encode(*tp.rpc_small_world(jax_api))
    else:
        from volcano_tpu.cache.synthetic import baseline_config as jax_bc
        from volcano_tpu_torch.cache.synthetic import baseline_config
        snaps = (baseline_config("1k")[0].snapshot(),
                 jax_bc("1k")[0].snapshot())
        got, want = (enc(list(s.nodes.values()), list(s.jobs.values()),
                         list(s.queues.values()))
                     for enc, s in zip((encode_snapshot, jax_encode), snaps))
    got, want = (json.loads(json.dumps(m)) for m in (got, want))
    assert got == want
    again = json.loads(json.dumps(encode_snapshot(*decode_snapshot(got))))
    assert again == got


# -- the service and the server -----------------------------------------------

def test_service_matches_inprocess():
    nodes, jobs, queues = build_world()
    expected = inprocess_binds(*build_world())
    out = SchedulerService(device="cpu").schedule(
        encode_snapshot(nodes, jobs, queues))
    got = {f"{b['namespace']}/{b['name']}": b["node"] for b in out["binds"]}
    assert got == expected
    phases = {p["uid"]: p["phase"] for p in out["podgroups"]}
    assert phases["job0"] == "Running"


def test_tcp_server_end_to_end(sidecar):
    _, client = sidecar
    nodes, jobs, queues = build_world()
    out = client.schedule(encode_snapshot(nodes, jobs, queues))
    expected = inprocess_binds(*build_world())
    got = {f"{b['namespace']}/{b['name']}": b["node"] for b in out["binds"]}
    assert got == expected
    # the connection is reusable
    out2 = client.schedule(encode_snapshot(nodes, jobs, queues))
    assert out2 == out or "binds" in out2


def test_rpc_at_1k_scale():
    """tests/test_rpc.py's benchmark-scale test at the 1k world: encode,
    ship over TCP, schedule with tpu-blocks, decode 1,000 binds, equal to
    the same service in process."""
    msg = tp.rpc_message("1k-blocks")
    conf = tp.rpc_conf("1k-blocks")
    expected = SchedulerService(conf, device="cpu").schedule(msg)
    server, _, port = serve(conf_text=conf, device="cpu")
    try:
        client = SnapshotClient("127.0.0.1", port, timeout=300)
        out = client.schedule(msg)
        client.close()
    finally:
        server.shutdown()
        server.server_close()
    got = {(b["uid"], b["node"]) for b in out["binds"]}
    assert got == {(b["uid"], b["node"]) for b in expected["binds"]}
    assert len(got) == 1000


def test_server_reports_errors(sidecar):
    _, client = sidecar
    with pytest.raises(RuntimeError, match="version"):
        client.schedule({"v": 99})
    # the server keeps serving after an error
    out = client.schedule(encode_snapshot(*build_world()))
    assert out["binds"]


def test_bad_payload_keeps_the_connection(sidecar):
    """A frame whose JSON is invalid gets an error reply on the same
    connection; a frame past MAX_MSG ends it."""
    import struct
    from volcano_tpu_torch.rpc import server as rpc_server
    server, client = sidecar
    body = b"{not json"
    client.sock.sendall(struct.pack(">I", len(body)) + body)
    reply = rpc_server._read_msg(client.sock)
    assert reply["error"].startswith("bad payload")
    assert client.schedule(encode_snapshot(*build_world()))["binds"]
    other = SnapshotClient("127.0.0.1", server.server_address[1])
    other.sock.sendall(struct.pack(">I", rpc_server.MAX_MSG + 1))
    assert rpc_server._read_msg(other.sock) is None
    other.close()


def _shim_fixture():
    """The fixture cluster of shim/shim_test.go, in the port's api."""
    a_alloc = Resource(8000, 16 * GI, {"nvidia.com/gpu": 4000.0})
    a_alloc.max_task_num = 110
    na = NodeInfo(name="n-a", allocatable=a_alloc, labels={"zone": "a"},
                  taints=[{"key": "dedicated", "value": "infra",
                           "effect": "NoSchedule"}])
    b_alloc = Resource(4000, 8 * GI)
    b_alloc.max_task_num = 110
    nb = NodeInfo(name="n-b", allocatable=b_alloc, unschedulable=True)
    q = pt_api.QueueInfo(name="default", weight=2, reclaimable=True,
                         capability=Resource(6000, 32 * GI))
    pg = pt_api.PodGroup(name="train", namespace="default", queue="default",
                         min_member=2, phase=pt_api.PodGroupPhase.INQUEUE,
                         min_resources=Resource(2000, 2 * GI))
    job = pt_api.JobInfo(uid="default/train", name="train",
                         namespace="default", queue="default",
                         min_available=2, podgroup=pg, priority=9,
                         creation_timestamp=1700000000.0)
    tol = [{"key": "dedicated", "operator": "Equal", "value": "infra",
            "effect": "NoSchedule"}]
    t0 = pt_api.TaskInfo(
        uid="uid-0", name="train-0", namespace="default",
        job="default/train", resreq=Resource(1000, 1 * GI),
        status=TaskStatus.RUNNING, priority=5, task_role="worker",
        labels={"app": "t"},
        annotations={"scheduling.k8s.io/group-name": "train",
                     "volcano.sh/preemptable": "true",
                     "volcano.sh/task-spec": "worker"},
        tolerations=tol, host_ports=[("0.0.0.0", "TCP", 8080)],
        preemptable=True, creation_timestamp=1700000001.0)
    t1 = pt_api.TaskInfo(
        uid="uid-1", name="train-1", namespace="default",
        job="default/train", resreq=Resource(1000, 1 * GI),
        status=TaskStatus.PENDING, priority=5,
        annotations={"scheduling.k8s.io/group-name": "train"},
        node_selector={"zone": "a"}, tolerations=tol,
        creation_timestamp=1700000002.0)
    t2 = pt_api.TaskInfo(
        uid="uid-2", name="train-2", namespace="default",
        job="default/train",
        resreq=Resource(2000, 2 * GI, {"nvidia.com/gpu": 1000.0}),
        status=TaskStatus.RELEASING, priority=5,
        annotations={"scheduling.k8s.io/group-name": "train",
                     "volcano.sh/revocable-zone": "rz1"},
        revocable_zone="rz1", creation_timestamp=1700000003.0)
    for t in (t0, t1, t2):
        job.add_task_info(t)
    na.add_task(t0)
    na.add_task(t2)
    return [na, nb], [job], [q]


def test_shim_golden_trace_conformance():
    """The port's encoder and the Go shim (shim/main.go, pinned by
    shim/shim_test.go) serialize the same fixture cluster to the same
    bytes: shim/testdata/golden_snapshot.json."""
    import re
    got = json.loads(json.dumps(encode_snapshot(*_shim_fixture())))
    want = json.loads((REPO / "shim" / "testdata"
                       / "golden_snapshot.json").read_text())
    assert got == want
    shim_src = (REPO / "shim" / "main.go").read_text()
    assert re.search(r"version\s*=\s*1\b", shim_src)
    assert "binary.BigEndian.PutUint32" in shim_src


def test_shim_golden_trace_schedules_through_the_wire(sidecar):
    """The sidecar schedules the golden snapshot: the Inqueue gang's
    pending task binds on the zone-a node."""
    _, client = sidecar
    out = client.schedule(tp.rpc_message("golden"))
    binds = {b["name"]: b["node"] for b in out["binds"]}
    assert binds.get("train-1") == "n-a"
    phases = {p["uid"]: p["phase"] for p in out["podgroups"]}
    assert phases["default/train"] == "Running"


# -- decisions against the JAX package ------------------------------------------

@pytest.fixture(scope="module")
def jax_rpc(tmp_path_factory):
    return tp.jax_reference("rpc", tp.RPC_WORLDS,
                            tmp_path_factory.mktemp("rpc") / "jax.pkl")


@pytest.mark.parametrize("world", tp.RPC_WORLDS)
def test_decisions_equal_jax(jax_rpc, world):
    """The port's reply on the same message, conditions without their
    session id and time, equals the JAX SchedulerService's to the byte:
    the default conf (host engines), the deployed conf (B1 and preempt's
    walk, their plain versions here) and tpu-blocks (B4's)."""
    got = tp.rpc_normalized(SchedulerService(
        tp.rpc_conf(world), device="cpu").schedule(tp.rpc_message(world)))
    want = jax_rpc[world]
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                          sort_keys=True)
    assert got["binds"]


def test_inprocess_equals_tcp():
    """One service's reply in process and over the wire are the same
    bytes (conditions normalized)."""
    msg = tp.rpc_message("small-deployed")
    conf = tp.rpc_conf("small-deployed")
    direct = tp.rpc_normalized(SchedulerService(conf, device="cpu")
                               .schedule(msg))
    server, _, port = serve(conf_text=conf, device="cpu")
    try:
        client = SnapshotClient("127.0.0.1", port)
        wired = tp.rpc_normalized(client.schedule(msg))
        client.close()
    finally:
        server.shutdown()
        server.server_close()
    assert json.dumps(wired, sort_keys=True) == json.dumps(direct,
                                                           sort_keys=True)


# -- the port's rules -----------------------------------------------------------

def test_service_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SchedulerService()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve()


def test_conf_refused_by_name(one_torch_thread):
    """tpu-sharded, refused by name before slice 19, is taken by the
    service and by a reload; an engine neither package has is still
    refused by name."""
    sharded = tp.DEPLOYED_CONF.replace("engine: tpu-fused",
                                       "engine: tpu-sharded")
    assert sharded != tp.DEPLOYED_CONF
    svc = SchedulerService(sharded, device="cpu")
    assert "tpu-sharded" in [c.arguments.get("engine")
                             for c in svc.conf.configurations]
    bad = tp.DEPLOYED_CONF.replace("engine: tpu-fused",
                                   "engine: tpu-nonexistent")
    with pytest.raises(ValueError, match="tpu-nonexistent"):
        SchedulerService(bad, device="cpu")
    svc = SchedulerService(device="cpu")
    with pytest.raises(ValueError, match="tpu-nonexistent"):
        svc.reload_conf(bad)
    svc.reload_conf(sharded)
    svc.reload_conf(tp.DEPLOYED_CONF)
    assert "preempt" in svc.conf.actions


def test_pod_affinity_refused_by_name(sidecar, jax_rpc):
    """The name is the refusal this test held before pod affinity was
    ported, kept so that the suite's record of it runs on; it now holds
    parity. A snapshot whose tasks carry pod affinity and labels, once refused,
    is served over TCP with the JAX package's sidecar reply on the same
    message (tests/torch_parity.py::_rpc_affinity: job0 spread one pod a
    zone, job1 drawn to job0's zone), and the sidecar keeps serving."""
    _, client = sidecar
    got = tp.rpc_normalized(client.schedule(tp.rpc_message("small-affinity")))
    assert json.dumps(got, sort_keys=True) == json.dumps(
        jax_rpc["small-affinity"], sort_keys=True)
    nodes = {b["name"]: b["node"] for b in got["binds"]}
    zone = {"n0": "a", "n1": "a", "n2": "b", "n3": "b"}
    assert zone[nodes["job0-0"]] != zone[nodes["job0-1"]]
    assert client.schedule(tp.rpc_message("small-default"))["binds"]


def test_kernel_error_is_the_wires_error(monkeypatch):
    """A hand kernel that fails (KernelError) fails the request with the
    error on the wire: no solver fallback, no host re-solve, no binds."""
    from volcano_tpu_torch import metrics
    from volcano_tpu_torch.actions import allocate
    from volcano_tpu_torch.ops.build import KernelError

    def broken(*a, **kw):
        raise KernelError("the place kernel refused the launch (-2)")

    monkeypatch.setattr(allocate, "_fused_solution", broken)
    before = metrics.containment_counts()
    server, _, port = serve(conf_text=tp.DEPLOYED_CONF, device="cpu")
    try:
        client = SnapshotClient("127.0.0.1", port)
        with pytest.raises(RuntimeError, match="KernelError"):
            client.schedule(tp.rpc_message("small-deployed"))
        client.close()
    finally:
        server.shutdown()
        server.server_close()
    after = metrics.containment_counts()
    assert {k: v for k, v in after.items() if k.startswith("solver")} \
        == {k: v for k, v in before.items() if k.startswith("solver")}


def test_requests_on_handler_threads_name_the_device():
    """Each connection's requests run on its own handler thread; the
    service pins its device and takes one snapshot at a time."""
    import threading
    server, _, port = serve(device="cpu")
    assert server.service.device == torch.device("cpu")
    msg = tp.rpc_message("small-default")
    outs, errs = [], []

    def one():
        try:
            c = SnapshotClient("127.0.0.1", port)
            outs.append(tp.rpc_normalized(c.schedule(msg)))
            c.close()
        except Exception as exc:            # pragma: no cover
            errs.append(exc)

    threads = [threading.Thread(target=one) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        server.shutdown()
        server.server_close()
    assert not errs and len(outs) == 4
    assert all(o == outs[0] for o in outs)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_snapshot_rpc_binary(tmp_path):
    """python -m volcano_tpu_torch.cmd vc-snapshot-rpc: listens, schedules
    the golden snapshot over TCP, serves /healthz and /metrics on
    --listen-address, hot-reloads its conf, and exits 0 on SIGTERM."""
    conf = tmp_path / "scheduler.conf"
    conf.write_text((REPO / "deploy" / "scheduler.conf").read_text())
    metrics_port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "volcano_tpu_torch.cmd", "vc-snapshot-rpc",
         "--device", "cpu", "--port", "0", "--scheduler-conf", str(conf),
         "--listen-address", str(metrics_port)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "listening on" in line, (line, proc.stderr.read())
        port = int(line.rsplit(":", 1)[1])
        client = SnapshotClient("127.0.0.1", port)
        out = client.schedule(tp.rpc_message("golden"))
        assert {b["name"]: b["node"] for b in out["binds"]} \
            == {"train-1": "n-a"}
        client.close()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{metrics_port}/healthz", timeout=5) as r:
            assert r.read() == b"ok"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{metrics_port}/metrics", timeout=5) as r:
            body = r.read().decode()
        assert "volcano_plugin_scheduling_latency_microseconds_count" in body
        time.sleep(0.05)
        conf.write_text(tp.SLICE_CONF)
        deadline = time.time() + 10
        reloaded = ""
        while time.time() < deadline and "reloaded" not in reloaded:
            reloaded = proc.stdout.readline()
        assert "reloaded" in reloaded
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    assert rc == 0


def test_committed_rpc_digests():
    """tests/rpc_reference_digests.json (tools/rpc_reference.py) has the
    three card worlds; the port's CPU path solved as the card must."""
    doc = json.loads((REPO / "tests" / "rpc_reference_digests.json")
                     .read_text())
    worlds = doc["worlds"]
    assert sorted(worlds) == ["rpc-10k", "rpc-10k-blocks", "rpc-preempt"]
    assert worlds["rpc-10k"]["binds"] == 10000
    assert worlds["rpc-10k"]["port_cpu"]["allocate"] == 1
    assert worlds["rpc-10k-blocks"]["port_cpu"]["blocks_passes"] > 0
    assert worlds["rpc-preempt"]["port_cpu"]["walks"] > 0


# -- admission over the wire ----------------------------------------------------

class TestAdmissionOverWire:
    """tests/test_rpc.py's admission tests through the port's sidecar."""

    def test_bad_job_denied_through_the_wire(self, sidecar):
        from volcano_tpu_torch.apis.objects import (Job, JobSpec, ObjectMeta,
                                                    TaskSpec)
        from volcano_tpu_torch.rpc.admission import to_wire
        _, client = sidecar
        bad = Job(metadata=ObjectMeta(name="bad"),
                  spec=JobSpec(min_available=5,
                               tasks=[TaskSpec(name="w", replicas=2)]))
        out = client.admit("Job", "CREATE", to_wire(bad))
        assert out["allowed"] is False
        assert "minAvailable" in out["message"] or "replicas" in \
            out["message"], out
        dup = Job(metadata=ObjectMeta(name="dup"),
                  spec=JobSpec(tasks=[TaskSpec(name="w", replicas=1),
                                      TaskSpec(name="w", replicas=1)]))
        assert client.admit("Job", "CREATE", to_wire(dup))["allowed"] \
            is False

    def test_mutation_defaults_returned(self, sidecar):
        from volcano_tpu_torch.apis.objects import (Job, JobSpec, ObjectMeta,
                                                    QueueCR, TaskSpec)
        from volcano_tpu_torch.rpc.admission import from_wire, to_wire
        _, client = sidecar
        job = Job(metadata=ObjectMeta(name="j"),
                  spec=JobSpec(min_available=0,
                               tasks=[TaskSpec(name="w", replicas=3)]))
        ctx = {"queues": [to_wire(QueueCR(
            metadata=ObjectMeta(name="default")))]}
        out = client.admit("Job", "CREATE", to_wire(job), context=ctx)
        assert out["allowed"] is True and out["patched"] is not None
        assert from_wire(Job, out["patched"]).spec.min_available == 3

    def test_queue_state_context_consulted(self, sidecar):
        from volcano_tpu_torch.api.types import QueueState
        from volcano_tpu_torch.apis.objects import (Job, JobSpec, ObjectMeta,
                                                    QueueCR, QueueStatus,
                                                    TaskSpec)
        from volcano_tpu_torch.rpc.admission import to_wire
        _, client = sidecar
        closed = QueueCR(metadata=ObjectMeta(name="batch"),
                         status=QueueStatus(state=QueueState.CLOSED))
        job = Job(metadata=ObjectMeta(name="j"),
                  spec=JobSpec(queue="batch",
                               tasks=[TaskSpec(name="w", replicas=1)]))
        out = client.admit("Job", "CREATE", to_wire(job),
                           context={"queues": [to_wire(closed)]})
        assert out["allowed"] is False, out
        open_q = QueueCR(metadata=ObjectMeta(name="batch"))
        out = client.admit("Job", "CREATE", to_wire(job),
                           context={"queues": [to_wire(open_q)]})
        assert out["allowed"] is True, out

    def test_invalid_queue_weight_denied(self, sidecar):
        from volcano_tpu_torch.apis.objects import (ObjectMeta, QueueCR,
                                                    QueueSpecCR)
        from volcano_tpu_torch.rpc.admission import to_wire
        _, client = sidecar
        q = QueueCR(metadata=ObjectMeta(name="q"),
                    spec=QueueSpecCR(weight=-2))
        assert client.admit("Queue", "CREATE", to_wire(q))["allowed"] \
            is False

    def test_malformed_review_denied_not_errored(self, sidecar):
        _, client = sidecar
        out = client.admit("Job", "CREATE", {"spec": {"tasks": "oops"}})
        assert out["allowed"] is False and "malformed" in out["message"]
        out = client.admit("Job", "CREATE", {"metadata": {"labels": ["a"]}})
        assert out["allowed"] is False
        out = client.schedule({"v": 2, "op": "admit", "review": {}})
        assert out["allowed"] is False and "version" in out["message"]

    def test_camelcase_review_and_unknown_fields(self, sidecar):
        from volcano_tpu_torch.apis.objects import ObjectMeta, QueueCR
        from volcano_tpu_torch.rpc.admission import to_wire
        _, client = sidecar
        ctx = {"queues": [to_wire(QueueCR(
            metadata=ObjectMeta(name="default")))]}
        job = {"metadata": {"name": "j"},
               "spec": {"minAvailable": 9,
                        "tasks": [{"name": "w", "replicas": 2}]}}
        assert client.admit("Job", "CREATE", job, context=ctx)["allowed"] \
            is False
        out = client.admit("Job", "CREATE", {"spec": {"noSuchField": 1}})
        assert out["allowed"] is False
        assert "unknown field" in out["message"]
        out = client.admit("Job", "CREATE", {"metadata": {"name": "x"}},
                           context={"queues": [ctx["queues"][0],
                                               ctx["queues"][0]]})
        assert out["allowed"] is False


def test_admission_golden_trace_through_the_wire(sidecar):
    """Every request of shim/testdata/golden_admission.json (what
    shim/webhook.go builds from its k8s fixtures) gets its recorded verdict
    through the port's sidecar."""
    _, client = sidecar
    golden = json.loads((REPO / "shim" / "testdata"
                         / "golden_admission.json").read_text())
    assert len(golden) >= 6
    for case in golden:
        out = client.schedule(case["request"])
        if isinstance(out.get("patched"), dict):
            out["patched"].pop("status", None)
            out["patched"].get("metadata", {}).pop("uid", None)
        assert out == case["response"], case["name"]
    by_name = {c["name"]: c for c in golden}
    assert by_name["job-min-available-over-replicas"]["response"][
        "allowed"] is False
    assert by_name["job-defaulting-patch"]["response"]["patched"][
        "spec"]["min_available"] == 2
