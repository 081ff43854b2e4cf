"""The port's preempt victim walk, its preempt and reclaim actions and the
deployed cycle against the JAX package's, on the CPU.

The JAX results come from a child process (tests/torch_parity.py says
why). Tolerance is 0 throughout: the walk's task nodes, slot owners and
quota verdicts, the actions' eviction and pipelined sets, and the cycle's
binds, evictions and PodGroup phases must be equal.
"""

import numpy as np
import pytest
import torch

from volcano_tpu_torch import Scheduler
from volcano_tpu_torch.cache import cache_from_world
from volcano_tpu_torch.ops import evict as torch_evict
from volcano_tpu_torch.ops.evict import to_device, walk, walk_plain

from torch_parity import port_gc_windows  # noqa: F401 (autouse)
from torch_parity import one_torch_thread  # noqa: F401
from torch_parity import (CONFORMANCE_KEYS, DEPLOYED_CONF, DEPLOYED_WORLDS,
                          EVICT_WORLDS, WALK_WORLDS, conformance_run,
                          evict_outcome, jax_reference, outcome,
                          run_torch_action, run_torch_cycle)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every JAX result this module reads, from one child process."""
    names = ([f"walk:{n}" for n in WALK_WORLDS]
             + [f"evict:{n}" for n in EVICT_WORLDS]
             + [f"deployed:{n}" for n in DEPLOYED_WORLDS]
             + [f"conformance:{k}" for k in CONFORMANCE_KEYS])
    return jax_reference("mixed", names,
                         tmp_path_factory.mktemp("jax") / "preempt.pkl")


@pytest.fixture(scope="module")
def walk_ref(reference):
    return {k[5:]: v for k, v in reference.items() if k.startswith("walk:")}


@pytest.fixture(scope="module")
def evict_ref(reference):
    return {k[6:]: v for k, v in reference.items() if k.startswith("evict:")}


@pytest.fixture(scope="module")
def deployed_ref(reference):
    return {k[9:]: v for k, v in reference.items()
            if k.startswith("deployed:")}


def _plain(world):
    inputs, kinds, sizes, gang = world
    return walk_plain(to_device(inputs, "cpu"), kinds, sizes, gang)


@pytest.mark.parametrize("name", list(WALK_WORLDS))
def test_walk_matches_jax(name, walk_ref):
    """walk_plain's task nodes, slot owners and per-group quota verdicts
    equal build_preempt_walk's, bit for bit."""
    out = _plain(WALK_WORLDS[name]())
    want_node, want_owner, want_done = walk_ref[name]
    np.testing.assert_array_equal(out.task_node.numpy(), want_node)
    np.testing.assert_array_equal(out.owner.numpy(), want_owner)
    np.testing.assert_array_equal(out.job_done.numpy(), want_done)


def test_walk_worlds_exercise_their_case(walk_ref):
    """Each named world reaches what it is named for."""
    def placed(name):
        return (walk_ref[name][0] >= 0).sum()

    inputs, *_ = WALK_WORLDS["gang-rollback"]()
    out = _plain(WALK_WORLDS["gang-rollback"]())
    quota = inputs.needed[inputs.pjg]
    assert placed("gang-rollback") > 0
    assert (~out.job_done.numpy()[np.unique(inputs.pjg)]).any()   # a rollback
    assert (quota > 0).all()
    assert placed("intra-job") > 0 and placed("drf") > 0
    assert int(walk_ref["two-dynamic-tiers"][0][0]) == 1
    assert placed("w64") > 0 and (walk_ref["w64"][1] >= 0).any()
    assert placed("no-fit") == 0 and (walk_ref["no-fit"][1] < 0).all()
    # the hand-built worlds' outcomes, as their docstrings derive them
    assert walk_ref["drf-threshold-cross"][0].tolist() == [0, 1, 2, 3, 5, 5]
    assert walk_ref["group-stale-elsewhere"][0].tolist() == [0, 1, 3, 3]
    assert walk_ref["intra-ls-falls"][0].tolist() == [0, 1, 1]
    node, owner, done = walk_ref["rollback-after-lazy-save"]
    assert node.tolist() == [-1, -1, -1, -1, 0]
    assert owner[:3, 0].tolist() == [4, -1, -1] and not done[0] and done[2]
    assert walk_ref["ties-across-warps"][0].tolist() == [31, 32, 63, 64, -1]
    assert walk_ref["rollback-after-lazy-save-quota-3"][2][0]
    # a veto after the first mask's victims leaves the node with none
    assert walk_ref["tier-veto-hand"][0].tolist() == [-1]
    assert placed("tier-veto") > 0


def test_rollback_world_evicts_on_three_nodes_before_it_fails(walk_ref):
    """With its quota lowered to 3, the rolled-back job of
    rollback-after-lazy-save commits: its three tasks evicted on nodes 0, 1
    and 2, the nodes the rollback restores (walk_plain and the JAX walk)."""
    name = "rollback-after-lazy-save-quota-3"
    out = _plain(WALK_WORLDS[name]())
    assert out.task_node.tolist()[:3] == [0, 1, 2]
    assert out.owner[:3, 0].tolist() == [0, 1, 2]
    node, owner, _ = walk_ref[name]
    assert node.tolist()[:3] == [0, 1, 2] and owner[:3, 0].tolist() == [0, 1, 2]


@pytest.mark.parametrize("name, per_task", [
    # task 5's share 0.5 passes node 4's kept 0.4: the pick (3) and node 4
    ("drf-threshold-cross", [7, 1, 1, 1, 2, 1]),
    # task 1 evicts group 1 on node 0: nodes 0 and 2; task 3's share 0.3
    # passes node 2's kept 0.25: the pick (1) and node 2
    ("group-stale-elsewhere", [4, 2, 2, 1]),
    # task 2's share falls: every node
    ("intra-ls-falls", [3, 3, 2]),
])
def test_walk_dispatches_hand_counts(name, per_task):
    """The verdict cache's dispatches on the hand-built worlds, as their
    docstrings derive them."""
    inputs, kinds, sizes, gang = WALK_WORLDS[name]()
    got = torch_evict.walk_dispatches(to_device(inputs, "cpu"), kinds, sizes,
                                      gang)
    assert got.per_task.tolist() == per_task
    assert got.per_node.sum() == sum(per_task)


@pytest.mark.parametrize("name", list(WALK_WORLDS))
def test_walk_dispatches_cover_every_evaluated_task(name):
    """One count per evaluated task: every node for the first, at least the
    last pick after it, never more than every node; a node the rule leaves
    out keeps its kept share (walk_dispatches raises otherwise)."""
    inputs, kinds, sizes, gang = WALK_WORLDS[name]()
    d = to_device(inputs, "cpu")
    got = torch_evict.walk_dispatches(d, kinds, sizes, gang)
    N = inputs.nw.vreq.shape[0]
    assert len(got.per_task) == walk_plain(d, kinds, sizes, gang).steps
    assert got.per_task[0] == N
    assert ((got.per_task >= 1) & (got.per_task <= N)).all()
    assert got.per_node.sum() == got.per_task.sum()
    assert got.per_node.shape == (N,)


@pytest.mark.parametrize("name", ["n2500", "w64-n400", "n8192"])
def test_card_walk_worlds_take_their_plans(name):
    """Each card-only world reaches the plan it is there for: more nodes
    than threads; victim tables in device memory; node state and group
    allocations in device memory (the score row read from device memory)."""
    from torch_parity import CARD_WALK_WORLDS
    inputs, *_ = CARD_WALK_WORLDS[name]()
    N, W, R = inputs.nw.vreq.shape
    plan = torch_evict.launch_plan(N, W, R, inputs.tier_masks.shape[0],
                                   inputs.jalloc0.shape[0])
    where = plan.where()
    if name == "n2500":
        assert N > plan.threads == 512 and where["nodes"]
    if name == "w64-n400":
        assert not where["tables"]
    if name == "n8192":
        assert not where["nodes"] and not where["groups"]


@pytest.mark.parametrize("N, W, R, M, AJ1", [
    (1000, 6, 2, 2, 201), (400, 6, 2, 2, 201), (400, 64, 2, 2, 201),
    (2500, 6, 2, 2, 2518), (4, 64, 1, 1, 20), (100000, 8, 8, 64, 5001)])
def test_walk_launch_plan(N, W, R, M, AJ1):
    """One thread a node up to 512; blocks join shared memory in priority
    order while they fit; device memory holds every block and the saves."""
    from volcano_tpu_torch.ops.evict import (FIXED_BYTES, SMEM_MAX,
                                             block_bytes, launch_plan)
    plan = launch_plan(N, W, R, M, AJ1)
    assert plan.threads == min(512, max(64, -(-N // 32) * 32))
    sizes = block_bytes(N, W, R, M, AJ1)
    assert plan.smem == FIXED_BYTES + sum(
        s for k, s in enumerate(sizes) if plan.blocks >> k & 1)
    assert plan.smem <= SMEM_MAX
    for k, s in enumerate(sizes):
        if not plan.blocks >> k & 1:      # left out only for want of room
            before = FIXED_BYTES + sum(
                t for j, t in enumerate(sizes[:k]) if plan.blocks >> j & 1)
            assert before + s > SMEM_MAX
    assert plan.scratch >= sum(sizes)
    assert plan.in_smem == (plan.blocks == 31)
    if (N, W) == (1000, 6):
        assert plan.in_smem                 # the preempt world's walk
    if (N, W) == (400, 64):
        assert not plan.where()["tables"]   # w64-n400


def test_walk_dispatch_takes_plain_for_cpu_and_refuses_other_devices():
    inputs, kinds, sizes, gang = WALK_WORLDS["drf"]()
    cpu = to_device(inputs, "cpu")
    before = torch_evict.walk_cuda.launches
    got = walk(cpu, kinds, sizes, gang)
    want = walk_plain(cpu, kinds, sizes, gang)
    assert torch.equal(got.task_node, want.task_node)
    assert torch_evict.walk_cuda.launches == before
    with pytest.raises(ValueError, match="not a CUDA device"):
        torch_evict.walk_cuda(cpu, kinds, sizes, gang)
    meta = to_device(inputs, "meta")
    with pytest.raises(ValueError, match="no walk kernel"):
        walk(meta, kinds, sizes, gang)


@pytest.mark.parametrize("name", list(EVICT_WORLDS))
def test_evict_action_matches_jax(name, evict_ref):
    """PreemptAction / ReclaimAction with engine tpu, alone under the
    deployed conf's tiers: the same evictions and pipelined tasks as the
    JAX package's tpu engine."""
    world, want = evict_ref[name]
    _, action = EVICT_WORLDS[name]
    cache = cache_from_world(world)
    got = evict_outcome(run_torch_action(cache, action), cache)
    assert got == want
    if name in ("reclaim-starved", "reclaim-parity", "preempt-small"):
        assert got["evicts"] and got["pipelined"]
    if name == "reclaim-protected":
        assert not got["evicts"]


@pytest.mark.parametrize("name", ["random-preempt-1", "preempt-small"])
def test_preempt_callbacks_engine_matches_jax(name, evict_ref):
    """The callbacks rung decides as the tpu engine does."""
    from volcano_tpu_torch.actions import PreemptAction
    from volcano_tpu_torch.framework import open_session, parse_scheduler_conf
    world, want = evict_ref[name]
    cache = cache_from_world(world)
    conf = parse_scheduler_conf(DEPLOYED_CONF)
    ssn = open_session(cache, conf.tiers, conf.configurations, device="cpu")
    PreemptAction(engine="callbacks")._execute_callbacks(ssn)
    assert evict_outcome(ssn, cache) == want


@pytest.mark.parametrize("name", list(DEPLOYED_WORLDS))
def test_deployed_cycle_matches_jax(name, deployed_ref):
    """One cycle of deploy/scheduler.conf as written: binds, evictions,
    PodGroup phases and conditions, pipelined tasks."""
    world, want = deployed_ref[name]
    cache = cache_from_world(world)
    got = outcome(run_torch_cycle(cache, DEPLOYED_CONF), cache)
    assert got == want
    assert got["binds"]


def test_scheduler_runs_the_deployed_conf(deployed_ref):
    """Scheduler.run_once parses the unmodified conf, runs its five actions
    and decides what the open/actions/close drive decides."""
    world, want = deployed_ref["pipeline-tenth"]
    cache = cache_from_world(world)
    sched = Scheduler(cache, DEPLOYED_CONF, device="cpu")
    assert [a.name() for a in sched.actions] == [
        "enqueue", "allocate-tpu", "preempt", "reclaim", "backfill"]
    sched.run_once()
    assert dict(cache.binder.binds) == want["binds"]
    assert sorted(cache.evictor.evicts) == want["evicts"]
    assert set(sched.last_cycle_s) >= {"open_session", "preempt", "reclaim",
                                       "close_session", "cycle"}


@pytest.mark.parametrize("old, new, refused", [
    ("engine: tpu\n- name: reclaim", "engine: tpu-sharded\n- name: reclaim",
     "tpu-sharded"),
])
def test_deployed_conf_refuses_what_is_not_ported(old, new, refused,
                                                 one_torch_thread):
    """The name is the refusal this test held before slice 19: preempt's
    tpu-sharded now runs the sharded walk (over four CPU slots) and evicts
    and binds what the single walk does, on a preempt mix."""
    from volcano_tpu_torch.cache.synthetic import preempt_mix_cache
    from volcano_tpu_torch.ops import unified
    conf = DEPLOYED_CONF.replace(old, new)
    assert conf != DEPLOYED_CONF
    runs = []
    unified.set_devices(4, "cpu")
    try:
        for text in (conf, DEPLOYED_CONF):
            cache, binder, evictor = preempt_mix_cache(
                n_nodes=30, n_tasks=600, n_jobs=30, seed=4)
            assert Scheduler(cache, text, device="cpu").run_once() == []
            runs.append((dict(binder.binds), list(evictor.evicts)))
    finally:
        unified.set_devices(None)
    assert runs[0] == runs[1] and runs[0][1]


@pytest.mark.parametrize("name", ["preempt-small", "preempt", "mix-3",
                                  "pipeline-tenth"])
def test_preempt_worlds_match_jax_generators(name):
    """One seed gives the same running+pending world in both packages'
    generators (chip_smoke.py drives the port's at full size)."""
    from volcano_tpu.cache import synthetic as jax_synthetic
    from volcano_tpu_torch.cache import synthetic as torch_synthetic

    from torch_parity import assert_same, world_from_cache

    def build(syn):
        if name == "mix-3":
            return syn.preempt_mix_cache(seed=3)[0]
        if name == "pipeline-tenth":
            if syn is torch_synthetic:
                return syn.pipeline_world(num_nodes=200, num_tasks=1000,
                                          num_jobs=20)[0]
            from torch_parity import _pipeline_tenth
            return _pipeline_tenth()
        return syn.baseline_config(name)[0]

    assert_same(world_from_cache(build(torch_synthetic)),
                world_from_cache(build(jax_synthetic)))


# -- conformance: tests/test_preempt_reclaim.py's cases -----------------------

@pytest.mark.parametrize("engine", ["callbacks", "tpu"])
def test_conformance_protects_critical(engine, reference):
    """A kube-system pod is no victim (conformance vetoes it in tier 1),
    under the callbacks engine and the walk's conformance fast path."""
    got = conformance_run(True, f"critical:{engine}")
    assert got == reference[f"conformance:critical:{engine}"]
    assert got["evicts"] == []


@pytest.mark.parametrize("engine", ["callbacks", "tpu"])
def test_intra_job_preemption(engine, reference):
    """Phase 2: a starving gang evicts its own running task. Gang's
    priority guard (tier 1) returns no same-job victim, so the dispatch
    falls through to the conformance tier, which permits it."""
    got = conformance_run(True, f"intra-job:{engine}")
    assert got == reference[f"conformance:intra-job:{engine}"]
    assert got["evicts"] == ["default/j-0"]
    assert got["pipelined"] == ["j-1"]


@pytest.mark.parametrize("engine", ["callbacks", "tpu"])
def test_conformance_veto_holds_across_tiers(engine, reference):
    """Priority and gang offer both kube-system pods and conformance
    refuses them: upstream's dispatch keeps ``init`` across the tiers, so
    drf's tier does not rule after that veto and nothing is evicted, under
    the callbacks engine and the walk (the JAX package mended alike)."""
    got = conformance_run(True, f"vetoed:{engine}")
    assert got == reference[f"conformance:vetoed:{engine}"]
    assert got["evicts"] == [] and got["pipelined"] == []


def test_session_dispatch_keeps_init_across_tiers():
    """session_plugins.go's Preemptable: a veto after one plugin's
    victims leaves none, whatever a later tier returns; a veto by the
    tier's first plugin lets the next tier rule; an abstention is no
    vote."""
    from volcano_tpu_torch.framework import Tier, PluginOption
    from volcano_tpu_torch.framework.session import Session
    from volcano_tpu_torch.api import TaskInfo
    a, b = TaskInfo(uid="a"), TaskInfo(uid="b")

    def dispatch(*tiers):
        ssn = Session.__new__(Session)
        ssn.tiers = [Tier(plugins=[PluginOption(n) for n, _ in t])
                     for t in tiers]
        fns = {n: (lambda out: lambda p, c: out)(out)
               for t in tiers for n, out in t}
        return [t.uid for t in ssn._tiered_victims(
            fns, None, lambda fn: fn(None, [a, b]))]

    offer, refuse, abstain = [a, b], [], None
    assert dispatch([("p", offer), ("c", refuse)], [("d", [b])]) == []
    assert dispatch([("c", refuse), ("p", offer)], [("d", [b])]) == ["b"]
    assert dispatch([("p", offer), ("c", [a])], [("d", [b])]) == ["a"]
    assert dispatch([("p", offer), ("c", [b]), ("g", [a])],
                    [("d", [a])]) == []
    assert dispatch([("x", abstain)], [("d", [b])]) == ["b"]
    assert dispatch([("x", abstain)]) == []


@pytest.mark.parametrize("name, placed", [("drf-leads", [-1]),
                                          ("drf-follows", [0])])
def test_walk_takes_drf_place_in_its_tier(name, placed):
    """drf ahead of its tier's static mask leads the tier: its victims
    decide the node, and the mask's veto leaves none; behind the mask, the
    mask's veto lets the next tier rule (torch_parity.tier_veto_world)."""
    from torch_parity import PORT_WALK_WORLDS
    out = _plain(PORT_WALK_WORLDS[name]())
    assert out.task_node.tolist() == placed
    assert int((out.owner >= 0).sum()) == (placed[0] >= 0)


def test_tier_stack_records_drf_place():
    """A tier with drf ahead of a static plugin gives the walk the kind
    ``drf@k``, k the static masks before drf; drf last gives ``drf``."""
    from volcano_tpu_torch.ops.evict import tier_layout
    assert tier_layout(("drf@0", "static"), (1, 1), 2) == ((True, 0),
                                                          (False, 1))
    assert tier_layout(("static", "drf"), (2, 0), 2) == ((False, 2),
                                                        (True, 0))
    for bad in (("drf@1",), ("static@0",), ("drf@x",)):
        with pytest.raises(ValueError):
            tier_layout(bad, (1,), 1)


def test_conformance_mask_is_the_plugins_verdict():
    """The tier stack's conformance fast path excludes exactly the pods the
    plugin's callback leaves out: kube-system and the two system priority
    classes, by annotation or by the job's class name."""
    from volcano_tpu_torch.actions.evict_tpu import _is_critical
    from volcano_tpu_torch.api import TaskInfo
    from volcano_tpu_torch.plugins.conformance import ConformancePlugin
    tasks = [TaskInfo(uid="a", namespace="kube-system"),
             TaskInfo(uid="b", annotations={
                 "priorityClassName": "system-cluster-critical"}),
             TaskInfo(uid="c", annotations={
                 "priorityClassName": "system-node-critical"}),
             TaskInfo(uid="d", annotations={"priorityClassName": "high"}),
             TaskInfo(uid="e")]
    fns = {}

    class Ssn:
        def add_preemptable_fn(self, name, fn):
            fns["preempt"] = fn

        def add_reclaimable_fn(self, name, fn):
            fns["reclaim"] = fn

    ConformancePlugin().on_session_open(Ssn())
    for fn in fns.values():
        victims, _ = fn(None, tasks)
        assert [t.uid for t in victims] == ["d", "e"]
    assert [_is_critical(t) for t in tasks] == [True, True, True, False,
                                                False]
