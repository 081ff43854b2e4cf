"""Pod affinity in the port against the JAX package, on the CPU.

Each case of tests/test_podaffinity.py is built with either package's
modules (tests/torch_parity.py::PODAFFINITY_CASES) and scheduled by one
allocate under the callbacks and the tpu-fused engine. The JAX package
runs in a child at XLA level 0 (tests/torch_parity.py says why). The binds
must be equal, each pending task's f64 host scores bit-equal and its
feasible nodes the same; each case then asserts what the JAX package's test
asserts.
"""

import numpy as np
import pytest

from volcano_tpu.plugins import podaffinity as jax_podaffinity
from volcano_tpu_torch.api import NodeInfo, Resource, TaskInfo
from volcano_tpu_torch.plugins import podaffinity
from volcano_tpu_torch.plugins.podaffinity import (PodAffinityIndex,
                                                   match_label_selector)

from torch_parity import port_gc_windows  # noqa: F401 (autouse)
from torch_parity import (PA_ENGINES, PODAFFINITY_KEYS, jax_reference,
                          podaffinity_run)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_reference("podaffinity", PODAFFINITY_KEYS,
                         tmp_path_factory.mktemp("jax") / "podaffinity.pkl")


def _run(case, engine, reference):
    got = podaffinity_run(True, f"{case}:{engine}")
    assert got == reference[f"{case}:{engine}"]
    return got["binds"]


@pytest.mark.parametrize("engine", PA_ENGINES)
def test_required_affinity_colocates(engine, reference):
    assert _run("required-affinity", engine, reference) == {
        "default/cli-0": "n2"}


@pytest.mark.parametrize("engine", PA_ENGINES)
def test_required_anti_affinity_spreads(engine, reference):
    assert _run("required-anti-affinity", engine, reference) == {
        "default/db1-0": "n1"}


@pytest.mark.parametrize("engine", PA_ENGINES)
def test_symmetric_anti_affinity(engine, reference):
    assert _run("symmetric-anti-affinity", engine, reference) == {
        "default/red-0": "n1"}


@pytest.mark.parametrize("engine", PA_ENGINES)
def test_zone_topology_domain(engine, reference):
    assert _run("zone-domain", engine, reference)["default/cli-0"] in (
        "n0", "n1")


@pytest.mark.parametrize("engine", PA_ENGINES)
def test_in_cycle_anti_affinity(engine, reference):
    binds = _run("in-cycle-anti-affinity", engine, reference)
    assert len(binds) == 2
    assert binds["default/da-0"] != binds["default/db-0"]


@pytest.mark.parametrize("engine", PA_ENGINES)
def test_self_affinity_bootstrap(engine, reference):
    binds = _run("self-affinity-bootstrap", engine, reference)
    assert len(binds) == 2
    assert binds["default/da-0"] == binds["default/db-0"]


@pytest.mark.parametrize("engine", PA_ENGINES)
def test_symmetric_preferred_repulsion(engine, reference):
    assert _run("symmetric-preferred-repulsion", engine, reference) == {
        "default/batch-0": "n1"}


@pytest.mark.parametrize("engine", PA_ENGINES)
def test_preferred_affinity_scores(engine, reference):
    assert _run("preferred-affinity", engine, reference) == {
        "default/cli-0": "n3"}


@pytest.mark.parametrize("engine", PA_ENGINES)
def test_partial_bootstrap_denied(engine, reference):
    assert _run("partial-bootstrap-denied", engine, reference) == {}


@pytest.mark.parametrize("selector, labels", [
    ({"matchExpressions": [
        {"key": "env", "operator": "In", "values": ["prod", "stage"]},
        {"key": "legacy", "operator": "DoesNotExist"}]}, labels)
    for labels in ({"env": "prod"}, {"env": "dev"},
                   {"env": "prod", "legacy": "1"})] + [
    ({}, {"env": "prod"}),
    ({"matchExpressions": [{"key": "env", "operator": "NotIn",
                            "values": ["dev"]},
                           {"key": "env", "operator": "Exists"}]},
     {"env": "prod"}),
    ({"matchLabels": {"a": "1"}, "matchExpressions": [
        {"key": "b", "operator": "Gt", "values": ["1"]}]}, {"a": "1"}),
])
def test_match_label_selector_expressions(selector, labels):
    assert match_label_selector(selector, labels) == \
        jax_podaffinity.match_label_selector(selector, labels)
    sel = {"matchExpressions": [
        {"key": "env", "operator": "In", "values": ["prod", "stage"]},
        {"key": "legacy", "operator": "DoesNotExist"}]}
    assert match_label_selector(sel, {"env": "prod"})
    assert not match_label_selector(sel, {"env": "dev"})
    assert not match_label_selector({}, {"env": "prod"})


def _node(name, zone=None):
    labels = {"kubernetes.io/hostname": name}
    if zone:
        labels["topology.kubernetes.io/zone"] = zone
    return NodeInfo(name=name, allocatable=Resource(8000, 1 << 34),
                    labels=labels)


def test_index_domains_and_counts():
    nodes = [_node("n0", "a"), _node("n1", "a"), _node("n2", "b")]
    idx = PodAffinityIndex(nodes)
    dom, nd = idx.domains("topology.kubernetes.io/zone")
    assert nd == 2 and dom[0] == dom[1] != dom[2]
    # nodes without the label are singleton domains
    nodes.append(NodeInfo(name="n3", allocatable=Resource(1, 1)))
    idx2 = PodAffinityIndex(nodes)
    dom2, nd2 = idx2.domains("topology.kubernetes.io/zone")
    assert nd2 == 3 and dom2[3] not in (dom2[0], dom2[2])


def _index_pair(seed):
    """The same nodes and existing pods in both packages' indexes: random
    labels, required and preferred terms over hostname and zone, some pods
    twice (placed, then pipelined again)."""
    import volcano_tpu.api as jax_api
    rng = np.random.RandomState(seed)
    zone = "topology.kubernetes.io/zone"
    host = "kubernetes.io/hostname"

    def term(kind):
        sel = {"matchLabels": {"app": f"a{rng.randint(3)}"}}
        t = {"labelSelector": sel,
             "topologyKey": host if rng.rand() < 0.5 else zone}
        if rng.rand() < 0.3:
            t["namespaces"] = ["default", "other"]
        return t

    def affinity():
        out = {}
        for kind in ("podAffinity", "podAntiAffinity"):
            if rng.rand() < 0.4:
                out.setdefault(kind, {})[
                    "requiredDuringSchedulingIgnoredDuringExecution"] = [
                    term(kind)]
            if rng.rand() < 0.4:
                out.setdefault(kind, {})[
                    "preferredDuringSchedulingIgnoredDuringExecution"] = [
                    {"weight": int(rng.randint(1, 101)),
                     "podAffinityTerm": term(kind)}]
        return out

    specs = [(f"p{k}", f"n{rng.randint(6)}", {"app": f"a{rng.randint(3)}"},
              ("default", "other")[rng.randint(2)], affinity())
             for k in range(12)]
    probes = [(f"q{k}", {"app": f"a{rng.randint(3)}"},
               ("default", "other")[rng.randint(2)], affinity())
              for k in range(8)]
    out = []
    for api, mod in ((jax_api, jax_podaffinity),
                     (__import__("volcano_tpu_torch.api").api,
                      podaffinity)):
        nodes = [api.NodeInfo(name=f"n{i}", allocatable=api.Resource(
            64000, 1 << 40), labels={host: f"n{i}", zone: f"z{i % 2}"})
                 for i in range(6)]
        by = {n.name: n for n in nodes}
        for uid, node, labels, ns, aff in specs:
            by[node].add_task(api.TaskInfo(
                uid=uid, name=uid, namespace=ns, resreq=api.Resource(1, 1),
                labels=labels, affinity=aff, status=api.TaskStatus.RUNNING))
        idx = mod.PodAffinityIndex(nodes)
        tasks = [api.TaskInfo(uid=uid, name=uid, namespace=ns,
                              labels=labels, affinity=aff)
                 for uid, labels, ns, aff in probes]
        out.append((idx, tasks, api, nodes))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_index_equals_jax_through_adds_and_removes(seed):
    """Masks, single-node checks and score rows equal the JAX package's
    rescanning index, before and after placements and removals."""
    (jidx, jtasks, japi, jnodes), (tidx, ttasks, tapi, tnodes) = \
        _index_pair(seed)

    def check():
        for jt, tt in zip(jtasks, ttasks):
            jm, tm = jidx.node_mask(jt), tidx.node_mask(tt)
            assert (jm is None) == (tm is None)
            if jm is not None:
                assert np.array_equal(jm, tm)
            for ni in range(len(tnodes)):
                assert tidx.node_ok(tt, ni) == (jm is None or bool(jm[ni]))
            jr, tr = jidx.score_row(jt), tidx.score_row(tt)
            assert (jr is None) == (tr is None)
            if jr is not None:
                assert jr.dtype == tr.dtype == np.float32
                assert np.array_equal(jr, tr)

    check()
    for k, (jt, tt) in enumerate(zip(jtasks, ttasks)):
        jt.node_name = tt.node_name = f"n{k % 6}"
        jidx.add_pod(jt)
        tidx.add_pod(tt)
    check()
    for jt, tt in zip(jtasks[::2], ttasks[::2]):
        jidx.remove_pod(jt)
        tidx.remove_pod(tt)
    check()


def test_normalize_scores_equals_jax():
    rows = [np.asarray(r, np.float32) for r in
            ([0, 0, 0], [3, 3, 3], [-100, 0, 250], [7, 1.5, 1e-3], [])]
    for row in rows:
        want = jax_podaffinity.normalize_scores(row)
        got = podaffinity.normalize_scores(row)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_session_flag_reads_tasks_on_nodes():
    """A session whose only affinity is on a pod already placed on a node
    still builds the index (the symmetric terms)."""
    from types import SimpleNamespace
    node = _node("n0")
    node.add_task(TaskInfo(uid="t", name="t", resreq=Resource(1, 1),
                           affinity={"podAntiAffinity": {
                               "requiredDuringSchedulingIgnoredDuringExecution":
                               [{"labelSelector": {"matchLabels": {"a": "b"}},
                                 "topologyKey": "kubernetes.io/hostname"}]}}))
    ssn = SimpleNamespace(jobs={}, nodes={"n0": node})
    assert podaffinity.session_has_pod_affinity(ssn)
