"""The port's allocate cycle against the JAX package's, on the CPU.

Each world is built as a JAX SchedulerCache, carried into the port through
cache_from_world, and scheduled by both packages with the same conf
(enqueue, allocate-tpu with engine tpu-fused, backfill; priority, gang,
nodeorder, binpack). The JAX package's fused engine runs its XLA scan
(tests/torch_parity.py says how). Binds, PodGroup phases and conditions,
and the pipelined task sets must be equal.
"""

import pytest

import volcano_tpu_torch.actions.allocate as torch_allocate
from volcano_tpu.cache.synthetic import baseline_config
from volcano_tpu_torch import Scheduler
from volcano_tpu_torch.cache import cache_from_world
from volcano_tpu_torch.cache import synthetic as torch_synthetic

from torch_parity import port_gc_windows  # noqa: F401 (autouse)
from torch_parity import one_torch_thread  # noqa: F401
from torch_parity import (DEPLOYED_CONF, SLICE_CONF, assert_same,
                          jax_reference, outcome, run_torch_cycle,
                          world_from_cache)

KINDS = ["tiny", "1k", "three-queue", "tight", "releasing", "taints", "gpu"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_reference("slice", KINDS,
                         tmp_path_factory.mktemp("jax") / "slice.pkl")


def _port(world):
    cache = cache_from_world(world)
    return outcome(run_torch_cycle(cache), cache)


@pytest.mark.parametrize("kind", KINDS)
def test_slice_matches_jax(kind, reference):
    world, want = reference[kind]
    got = _port(world)
    assert got == want
    if kind == "tight":
        assert any(c[0][0] == "Unschedulable"
                   for c in got["conditions"].values())
        assert got["binds"]
    elif kind == "releasing":
        assert got["pipelined"]
    else:
        assert got["binds"]


@pytest.mark.parametrize("kind", ["tight", "releasing", "taints"])
def test_statement_replay_matches_jax(kind, reference, monkeypatch):
    """The Statement replay (taken when _fast_replay_ok does not hold)
    decides what the batched replay does."""
    monkeypatch.setattr(torch_allocate, "_fast_replay_ok", lambda ssn: False)
    world, want = reference[kind]
    assert _port(world) == want


@pytest.mark.parametrize("name", ["tiny", "1k", "10k"])
def test_synthetic_world_matches_jax(name):
    """One seed gives the same world in both packages' generators."""
    assert_same(world_from_cache(torch_synthetic.baseline_config(name, 7)[0]),
                world_from_cache(baseline_config(name, 7)[0]))


def test_scheduler_run_once():
    """Scheduler.run_once drives the same cycle as open/actions/close."""
    cache, binder, _ = torch_synthetic.baseline_config("1k")
    Scheduler(cache, SLICE_CONF, device="cpu").run_once()
    ref_cache = torch_synthetic.baseline_config("1k")[0]
    run_torch_cycle(ref_cache)
    assert len(binder.binds) == 1000
    assert binder.binds == ref_cache.binder.binds


@pytest.mark.parametrize("conf_text, refused", [
    (SLICE_CONF.replace("engine: tpu-fused", "engine: tpu-sharded"),
     "tpu-sharded"),
    (SLICE_CONF.replace("engine: tpu-fused", "engine: callbacks-parallel"),
     "callbacks-parallel"),
])
def test_refuses_what_is_not_ported(conf_text, refused, one_torch_thread):
    """The name is the refusal this test held before slice 19; both
    engines now run: tpu-sharded (over four CPU slots) binds what
    tpu-blocks binds, callbacks-parallel what callbacks binds."""
    from volcano_tpu_torch.ops import unified
    established = {"tpu-sharded": "tpu-blocks",
                   "callbacks-parallel": "callbacks"}[refused]
    binds = []
    unified.set_devices(4, "cpu")
    try:
        for text in (conf_text, conf_text.replace(refused, established)):
            cache, binder, _ = torch_synthetic.baseline_config("1k", seed=3)
            assert Scheduler(cache, text, device="cpu").run_once() == []
            binds.append(dict(binder.binds))
    finally:
        unified.set_devices(None)
    assert binds[0] == binds[1] and len(binds[0]) == 1000


@pytest.mark.parametrize("engine", ["tpu-fused", "tpu-scan", "tpu-pallas"])
def test_topology_weight_runs_the_zone_anchor_solve(engine, monkeypatch):
    """A positive topology-weight, once refused, runs: each engine that
    names the placement kernel solves with B6's plain version on the CPU
    (the JAX package's scan takes place_scan_topo at every one of them),
    and the unzoned tiny world binds as it does without the term."""
    from volcano_tpu_torch.ops import place as place_mod
    calls = []
    real = place_mod.place_topo_plain
    monkeypatch.setattr(place_mod, "place_topo_plain",
                        lambda *a: calls.append(a) or real(*a))
    conf = SLICE_CONF.replace("engine: tpu-fused",
                              f"engine: {engine}\n    topology-weight: 3")
    cache, binder, _ = torch_synthetic.baseline_config("tiny")
    assert Scheduler(cache, conf, device="cpu").run_once() == []
    assert calls and calls[0][-1] == 3.0
    plain, plain_binder, _ = torch_synthetic.baseline_config("tiny")
    assert Scheduler(plain, SLICE_CONF, device="cpu").run_once() == []
    assert binder.binds == plain_binder.binds and binder.binds


def test_refuses_pod_affinity(tmp_path):
    """The name is the refusal this test held before pod affinity was
    ported, kept so that the suite's record of it runs on; it now holds
    parity. Pod affinity, once refused, runs: one deployed cycle of
    tests/torch_parity.py's affinity world (spread, zone-kept and
    zone-preferring gangs) decides what the JAX package decides, through
    the stateful re-check and more than one round."""
    world, want = jax_reference("deployed", ["affinity"],
                                tmp_path / "affinity.pkl")["affinity"]
    cache = cache_from_world(world)
    got = outcome(run_torch_cycle(cache, DEPLOYED_CONF), cache)
    assert got == want and got["binds"]
    from volcano_tpu_torch.framework import get_action
    stats = get_action("allocate-tpu").last_stats
    assert stats["rounds"] > 1 and stats["rejected"] > 0


@pytest.mark.slow
def test_slice_matches_jax_10k(tmp_path):
    world, want = jax_reference("slice", ["10k"], tmp_path / "10k.pkl")["10k"]
    got = _port(world)
    assert got == want
    assert len(got["binds"]) == 10000
