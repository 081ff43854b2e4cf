"""The GPU card model, NUMA placement, GPU sharing, the predicate cache and
the proportional predicate in the port, against the JAX package on the CPU.

The host-only pieces (tests/test_numa_device.py's card, hint, policy and
cpuset cases) run in both packages here and must give equal results. The
allocate cases (tests/torch_parity.py::NUMA_CASES) run under the callbacks
and the tpu-fused engine; the JAX package runs in a child at XLA level 0.
Binds, cpusets, per-task allocations and card use must be equal.
"""

import numpy as np
import pytest

import volcano_tpu.api as jax_api
import volcano_tpu.api.device_info as jax_device
import volcano_tpu.api.numa_info as jax_numa
import volcano_tpu.plugins.numaaware as jax_numaaware
import volcano_tpu.plugins.predicates as jax_predicates
import volcano_tpu_torch.api as api
from volcano_tpu_torch.api import (GPU_MEMORY_RESOURCE, NodeInfo, Resource,
                                   TaskInfo, TaskStatus)
from volcano_tpu_torch.api import device_info, numa_info
from volcano_tpu_torch.api.numa_info import (CPU, NumatopoInfo,
                                             PolicyBestEffort,
                                             PolicyRestricted,
                                             PolicySingleNumaNode,
                                             TopologyHint, bitmask,
                                             is_narrower, mask_bits,
                                             mask_count, merge_filtered_hints)
from volcano_tpu_torch.framework.arguments import Arguments
from volcano_tpu_torch.plugins import numaaware
from volcano_tpu_torch.plugins.numaaware import (CpuManagerProvider,
                                                 guaranteed_cpus,
                                                 take_by_topology)
from volcano_tpu_torch.plugins.predicates import (PredicateError,
                                                  PredicatesPlugin,
                                                  proportional_ok)

from torch_parity import port_gc_windows  # noqa: F401 (autouse)
from torch_parity import (NUMA_KEYS, PA_ENGINES, jax_reference, numa_run)


def gpu_task(uid, mem, pkg=api):
    return pkg.TaskInfo(uid=uid, name=uid, resreq=pkg.Resource(
        100, 100, scalars={GPU_MEMORY_RESOURCE: mem}))


# -- the card model ---------------------------------------------------------

def test_make_and_idle():
    devices = device_info.make_gpu_devices(16000, 4)
    assert len(devices) == 4
    assert devices[0].memory == 4000
    assert devices[0].idle_memory() == 4000
    assert device_info.make_gpu_devices(16000, 0) == {}


@pytest.mark.parametrize("mem", [500, 1000, 4000, 4500])
def test_predicate_gpu_picks_first_fitting(mem):
    got, want = (m.make_gpu_devices(8000, 2) for m in (device_info,
                                                       jax_device))
    got[0].task_map["other"] = want[0].task_map["other"] = 3500
    first = device_info.predicate_gpu(gpu_task("t", mem), got)
    assert first == jax_device.predicate_gpu(gpu_task("t", mem, jax_api),
                                             want)
    assert first == {500: 0, 1000: 1, 4000: 1, 4500: None}[mem]


def test_node_accounting_on_add_remove():
    node = NodeInfo(name="n1", allocatable=Resource(
        4000, 1 << 30, scalars={GPU_MEMORY_RESOURCE: 8000}))
    node.set_gpu_info(8000, 2)
    task = gpu_task("t1", 3000)
    task.status = TaskStatus.ALLOCATED
    node.add_task(task)
    assert node.gpu_devices[0].used_memory() == 3000
    clone = node.clone()
    assert clone.gpu_devices[0].used_memory() == 3000
    node.remove_task(task)
    assert node.gpu_devices[0].used_memory() == 0
    assert clone.gpu_devices[0].used_memory() == 3000
    # a pipelined task claims no card (node_info.go AddGPUResource)
    piped = gpu_task("t2", 3000)
    piped.status = TaskStatus.PIPELINED
    node.add_task(piped)
    assert node.gpu_devices[0].used_memory() == 0


def test_card_index_annotation():
    devices = device_info.make_gpu_devices(8000, 2)
    task = gpu_task("t", 1000)
    task.annotations[device_info.GPU_INDEX_ANNOTATION] = "1"
    assert device_info.add_gpu_resource(devices, task) == 1
    bad = gpu_task("u", 1000)
    bad.annotations[device_info.GPU_INDEX_ANNOTATION] = "x"
    assert device_info.add_gpu_resource(devices, bad) == 0
    device_info.sub_gpu_resource(devices, task)
    assert devices[1].used_memory() == 0


def test_auto_wiring_from_capacity_scalars():
    """NodeInfo populates cards from volcano.sh/gpu-memory + gpu-number
    capacity (node_info.go NewNodeInfo -> setNodeGPUInfo)."""
    spec = {"cpu": "4", "memory": "8Gi", "volcano.sh/gpu-memory": 8000,
            "volcano.sh/gpu-number": 2}
    node = NodeInfo(name="n1", allocatable=Resource.from_dict(spec))
    ref = jax_api.NodeInfo(name="n1",
                           allocatable=jax_api.Resource.from_dict(spec))
    assert len(node.gpu_devices) == len(ref.gpu_devices) == 2
    assert node.gpu_devices[0].memory == ref.gpu_devices[0].memory \
        == 4000 * 1000
    task = TaskInfo(uid="t", resreq=Resource.from_dict(
        {"volcano.sh/gpu-memory": 4000}))
    assert device_info.predicate_gpu(task, node.gpu_devices) == 0
    task_big = TaskInfo(uid="t2", resreq=Resource.from_dict(
        {"volcano.sh/gpu-memory": 4001}))
    assert device_info.predicate_gpu(task_big, node.gpu_devices) is None


def test_idle_matrix():
    def nodes(pkg):
        n1 = pkg.NodeInfo(name="n1", allocatable=pkg.Resource(1000, 1000))
        n1.set_gpu_info(8000, 2)
        n1.gpu_devices[1].task_map["x"] = 1500.0
        n2 = pkg.NodeInfo(name="n2", allocatable=pkg.Resource(1000, 1000))
        return [n1, n2]
    m = device_info.devices_idle_matrix(nodes(api))
    want = jax_device.devices_idle_matrix(nodes(jax_api))
    assert m.dtype == want.dtype == np.float32 and np.array_equal(m, want)
    assert m.shape == (2, 2) and m[0, 0] == 4000 and m[0, 1] == 2500
    assert m[1, 0] == float("-inf")


# -- NUMA hints and policies ------------------------------------------------

def test_bitmask_roundtrip():
    m = bitmask([0, 2])
    assert mask_bits(m) == [0, 2]
    assert mask_count(m) == 2
    assert list(numa_info.iterate_bitmasks([0, 1])) == \
        list(jax_numa.iterate_bitmasks([0, 1])) == [1, 2, 3]


def test_is_narrower():
    assert is_narrower(bitmask([0]), bitmask([0, 1]))
    assert is_narrower(bitmask([0]), bitmask([1]))   # tie: lower value


def test_merge_prefers_narrow_preferred():
    hints = [[TopologyHint(bitmask([0]), True),
              TopologyHint(bitmask([0, 1]), False)]]
    best = merge_filtered_hints([0, 1], hints)
    assert best.affinity == bitmask([0])
    assert best.preferred


def test_merge_cross_provider_and():
    provider_a = [TopologyHint(bitmask([0, 1]), True)]
    provider_b = [TopologyHint(bitmask([1]), True)]
    best = merge_filtered_hints([0, 1], [provider_a, provider_b])
    assert best.affinity == bitmask([1])
    assert best.preferred


def _hints(topo, request, pkg=api, provider=CpuManagerProvider):
    task = pkg.TaskInfo(uid="t", resreq=pkg.Resource(request * 1000, 0))
    return provider().get_topology_hints(task, topo, topo.idle_sets())


def test_best_effort_always_admits():
    topo = NumatopoInfo.uniform("n1", 2, 4)
    hint, admit = PolicyBestEffort(topo.numa_nodes()).predicate(
        [_hints(topo, 2)])
    assert admit
    assert mask_count(hint.affinity) == 1


def test_restricted_rejects_unpreferred():
    topo = NumatopoInfo.uniform("n1", 2, 4)
    topo.numa_res_map[CPU].allocatable = {0, 4}   # one cpu per numa node
    hint, admit = PolicyRestricted(topo.numa_nodes()).predicate(
        [_hints(topo, 2)])
    assert not admit


def test_single_numa_node_rejects_spanning():
    topo = NumatopoInfo.uniform("n1", 2, 4)
    topo.numa_res_map[CPU].allocatable = {0, 4}
    policy = PolicySingleNumaNode(topo.numa_nodes())
    hint, admit = policy.predicate([_hints(topo, 2)])
    assert not admit
    topo.numa_res_map[CPU].allocatable = {0, 1, 4}
    hint, admit = policy.predicate([_hints(topo, 2)])
    assert admit
    assert hint.affinity == bitmask([0])


@pytest.mark.parametrize("policy", ["none", "best-effort", "restricted",
                                    "single-numa-node"])
@pytest.mark.parametrize("free", [range(8), {0, 4}, {0, 1, 4}, {5, 6, 7},
                                  set()])
@pytest.mark.parametrize("request_cpus", [1, 2, 3, 5])
def test_policies_equal_jax(policy, free, request_cpus):
    """Every policy's verdict and merged hint, and the cpuset the provider
    takes, equal the JAX package's over free sets and requests."""
    out = []
    for pkg, mod, nmod in ((api, numaaware, numa_info),
                           (jax_api, jax_numaaware, jax_numa)):
        topo = nmod.NumatopoInfo.uniform("n1", 2, 4, topology_policy=policy)
        topo.numa_res_map[nmod.CPU].allocatable = set(free)
        hints = _hints(topo, request_cpus, pkg, mod.CpuManagerProvider)
        hint, admit = nmod.get_policy(topo).predicate([hints])
        task = pkg.TaskInfo(uid="t", resreq=pkg.Resource(
            request_cpus * 1000, 0))
        taken = mod.CpuManagerProvider().allocate(task, hint, topo,
                                                  topo.idle_sets())
        out.append((None if hints is None else
                    {r: [(h.affinity, h.preferred) for h in hs]
                     for r, hs in hints.items()},
                    (hint.affinity, hint.preferred), admit,
                    {r: sorted(ids) for r, ids in taken.items()}))
    assert out[0] == out[1]


# -- cpusets ----------------------------------------------------------------

def test_whole_domain_first():
    topo = NumatopoInfo.uniform("n1", 2, 4)
    taken = take_by_topology(topo, set(range(8)), 4)
    assert len(taken) == 4
    assert len({topo.cpu_detail[c].numa_id for c in taken}) == 1


def test_insufficient():
    topo = NumatopoInfo.uniform("n1", 2, 4)
    assert take_by_topology(topo, {0, 1}, 3) is None


@pytest.mark.parametrize("mcpu, want", [(2000, 2), (2500, 0), (0, 0)])
def test_guaranteed_cpus(mcpu, want):
    assert guaranteed_cpus(TaskInfo(uid="a", resreq=Resource(mcpu, 0))) \
        == jax_numaaware.guaranteed_cpus(
            jax_api.TaskInfo(uid="a", resreq=jax_api.Resource(mcpu, 0))) \
        == want


def test_topology_copies_and_compare():
    topo = NumatopoInfo.uniform("n1", 2, 4)
    copy = topo.deep_copy()
    copy.allocate({CPU: {0, 1}})
    assert len(topo.numa_res_map[CPU].allocatable) == 8
    assert not topo.compare(copy) and copy.compare(topo)
    copy.release({CPU: {0, 1}})
    assert copy.idle_sets() == topo.idle_sets()


# -- allocate with numa-aware and GPU sharing -------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_reference("numa", NUMA_KEYS,
                         tmp_path_factory.mktemp("jax") / "numa.pkl")


def _run(case, engine, reference):
    got = numa_run(True, f"{case}:{engine}")
    assert got == reference[f"{case}:{engine}"]
    return got


@pytest.mark.parametrize("engine", PA_ENGINES)
def test_fitting_task_binds_and_writes_back(engine, reference):
    got = _run("numa-fits", engine, reference)
    assert len(got["binds"]) == 1
    # the writeback shrank the allocatable cpuset by 2, the delete
    # returned it
    assert len(got["numa"]["allocatable"]) == 6
    assert len(got["after_delete"]["allocatable"]) == 8
    assert got["after_delete"]["allocations"] == {}


@pytest.mark.parametrize("engine", PA_ENGINES)
def test_spanning_task_rejected(engine, reference):
    assert _run("numa-spans", engine, reference)["binds"] == {}


@pytest.mark.parametrize("engine", PA_ENGINES)
def test_policy_mismatch_rejected(engine, reference):
    assert _run("numa-policy-mismatch", engine, reference)["binds"] == {}


@pytest.mark.parametrize("engine", PA_ENGINES)
def test_sibling_tasks_get_disjoint_cpusets(engine, reference):
    got = _run("numa-siblings", engine, reference)
    assert len(got["binds"]) == 3
    allocs = got["numa"]["allocations"]
    cpus = [c for sets in allocs.values() for c in sets[CPU]]
    assert len(allocs) == 3 and len(cpus) == len(set(cpus)) == 6
    assert len(got["numa"]["allocatable"]) == 2


@pytest.mark.parametrize("engine", PA_ENGINES)
def test_no_single_card_fits(engine, reference):
    """Aggregate idle card memory fits but no single card does: rejected
    (predicates/gpu.go)."""
    assert _run("gpu-no-single-card", engine, reference)["binds"] == {}


@pytest.mark.parametrize("engine", PA_ENGINES)
def test_card_fits(engine, reference):
    got = _run("gpu-card-fits", engine, reference)
    assert len(got["binds"]) == 1
    assert got["cards"][0] == [("t1", 4000.0)]


# -- the predicate cache and the proportional guard -------------------------

def test_stateful_checks_not_cached():
    """CacheEnable must not cache the GPU-share check: after task A
    consumes a card, same-signature task B must be rejected."""
    plugin = PredicatesPlugin(Arguments({
        "predicate.CacheEnable": "true",
        "predicate.GPUSharingEnable": "true"}))
    node = NodeInfo(name="n1", allocatable=Resource(
        8000, 1 << 30, scalars={GPU_MEMORY_RESOURCE: 4000},
        max_task_num=100))
    node.set_gpu_info(4000, 1)
    a, b = gpu_task("a", 3000), gpu_task("b", 3000)
    plugin.predicate(a, node)               # fits, cached True
    a.status = TaskStatus.ALLOCATED
    node.add_task(a)                        # card now has 1000 idle
    with pytest.raises(PredicateError):
        plugin.predicate(b, node)


def test_guard_blocks_cpu_hog():
    node = NodeInfo(name="n1", allocatable=Resource(
        10000, 10 * 1024 ** 3, scalars={"nvidia.com/gpu": 2000}))
    rates = {"nvidia.com/gpu": (2000.0, 1024.0 ** 3)}
    hog = TaskInfo(uid="t", resreq=Resource(9000, 1024 ** 3))
    assert not proportional_ok(hog, node, rates)
    small = TaskInfo(uid="t", resreq=Resource(1000, 1024 ** 3))
    assert proportional_ok(small, node, rates)
    gpu_user = TaskInfo(uid="t", resreq=Resource(
        9000, 1024 ** 3, scalars={"nvidia.com/gpu": 1000}))
    assert proportional_ok(gpu_user, node, rates)


@pytest.mark.parametrize("seed", range(3))
def test_proportional_guard_equals_jax(seed):
    """proportional_ok equals the JAX package's on every (task, node) pair
    of random nodes and tasks, over two scarce resources."""
    rng = np.random.RandomState(seed)
    rates = {"nvidia.com/gpu": (4000.0, 16.0 * 1024 ** 3),
             "example.com/fpga": (1000.0, 2.0 * 1024 ** 3)}
    nodes, jnodes, tasks, jtasks = [], [], [], []
    for i in range(12):
        spec = (int(rng.randint(8, 64)) * 1000, int(rng.randint(16, 256)) << 30,
                {"nvidia.com/gpu": float(rng.randint(0, 9) * 1000),
                 "example.com/fpga": float(rng.randint(0, 3) * 1000)})
        nodes.append(NodeInfo(name=f"n{i}", allocatable=Resource(*spec)))
        jnodes.append(jax_api.NodeInfo(name=f"n{i}",
                                       allocatable=jax_api.Resource(*spec)))
    for k in range(30):
        spec = (int(rng.randint(1, 40)) * 1000,
                int(rng.randint(1, 200)) << 30,
                {"nvidia.com/gpu": 1000.0} if rng.rand() < 0.2 else None)
        tasks.append(TaskInfo(uid=f"t{k}", resreq=Resource(*spec)))
        jtasks.append(jax_api.TaskInfo(uid=f"t{k}",
                                       resreq=jax_api.Resource(*spec)))
    want = np.asarray([[jax_predicates.proportional_ok(t, n, rates)
                        for n in jnodes] for t in jtasks])
    got = np.asarray([[proportional_ok(t, n, rates) for n in nodes]
                      for t in tasks])
    assert np.array_equal(got, want) and not want.all() and want.any()
