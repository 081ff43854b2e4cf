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
from torch_parity import (DEPLOYED_CONF, DEPLOYED_WORLDS, EVICT_WORLDS,
                          WALK_WORLDS, evict_outcome, jax_reference, outcome,
                          run_torch_action, run_torch_cycle)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every JAX result this module reads, from one child process."""
    names = ([f"walk:{n}" for n in WALK_WORLDS]
             + [f"evict:{n}" for n in EVICT_WORLDS]
             + [f"deployed:{n}" for n in DEPLOYED_WORLDS])
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
    ("- name: binpack", "- name: conformance", "conformance"),
    ("- name: predicates", "- name: predicates\n    arguments:\n"
     "      predicate.GPUSharingEnable: true", "GPUSharingEnable"),
])
def test_deployed_conf_refuses_what_is_not_ported(old, new, refused):
    """An engine, plugin or argument the port lacks is refused by name."""
    from volcano_tpu_torch.cache.synthetic import baseline_config
    conf = DEPLOYED_CONF.replace(old, new)
    assert conf != DEPLOYED_CONF
    with pytest.raises(ValueError, match=refused):
        Scheduler(baseline_config("tiny")[0], conf, device="cpu").run_once()


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
