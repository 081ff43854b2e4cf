"""tools/plugin_reference.py's worlds through the port on the CPU.

numa-1k and proportional-1k are held to their JAX records in
tests/plugin_reference_digests.json (each world to the record its
``held_to`` names: affinity-preempt's is the JAX package with its tier
dispatch mended, ROADMAP §3); affinity-1k and gpushare-1k (the
full-width affinity and GPU-sharing worlds at a tenth) are held live to the
JAX package, run in a child at XLA level 0; the three full-width worlds are
held to their records under ``slow``. A digest is the binds and evictions in
order, each PodGroup's phase, each allocate solve's node-tensor path and
the count of critical pods evicted; the port's solves and walks (B1's and
B3's plain versions here) must equal the record's ``port_cpu``, which
chip_smoke.py holds the card's launches to. The worlds themselves are equal
field by field in both packages.
"""

import os
import sys

import pytest

import volcano_tpu.cache as jax_cache_mod
import volcano_tpu.api as jax_api
from volcano_tpu.cache import synthetic as jax_synthetic
import volcano_tpu_torch.api as torch_api
import volcano_tpu_torch.cache as torch_cache_mod
from volcano_tpu_torch.cache import synthetic as torch_synthetic

from torch_parity import port_gc_windows  # noqa: F401 (autouse)
from torch_parity import (assert_same, jax_reference, plugin_slice_world,
                          world_from_cache)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import plugin_reference  # noqa: E402

DIGESTED = ("numa-1k", "proportional-1k")
LIVE = ("affinity-1k", "gpushare-1k")
FULL_WIDTH = ("affinity-10k", "gpushare-10k", "affinity-preempt")


def _port(world):
    return plugin_reference.run_world("volcano_tpu_torch", world, "cpu")


def _held_to_record(world):
    record = plugin_reference.load_digests()[world]
    want = plugin_reference.held_to(record)
    out = _port(world)
    got = out["digest"]
    assert plugin_reference.comparable(got) == {
        k: v for k, v in plugin_reference.comparable(want).items()
        if k in got}
    assert {"solves": got["solves"], "walks": got["walks"]} == \
        record["port_cpu"]
    return got, out


@pytest.mark.parametrize("world", DIGESTED)
def test_world_equals_its_record(world):
    got, out = _held_to_record(world)
    assert got["binds"] > 0 and got["action_failures"] == []
    if world == "numa-1k":
        # the NUMA predicate is stateful: proposals are re-checked live
        assert out["allocate"][0]["rounds"] >= 1
    if world == "proportional-1k":
        # milli-scaled GPUs: the guard refuses placements, and proposals
        # fail their live re-check
        assert out["guard_refusals"] > 0
        assert sum(a["rejected"] for a in out["allocate"]) > 0


def test_proportional_guard_decides(monkeypatch):
    """proportional-1k's record reads the guard: with a guard that refuses
    nothing, the port binds more and its digest departs from the record."""
    from volcano_tpu_torch.plugins import predicates
    monkeypatch.setattr(predicates, "proportional_ok", lambda *a: True)
    got = _port("proportional-1k")["digest"]
    want = plugin_reference.load_digests()["proportional-1k"]
    assert got["binds"] > want["binds"]
    assert got["sequence_sha256"] != want["sequence_sha256"]


@pytest.fixture(scope="module")
def live_reference(tmp_path_factory):
    return jax_reference("plugin-world", LIVE,
                         tmp_path_factory.mktemp("jax") / "worlds.pkl")


@pytest.mark.parametrize("world", LIVE)
def test_tenth_world_equals_jax(world, live_reference):
    out = _port(world)
    got = out["digest"]
    assert plugin_reference.comparable(got) == \
        plugin_reference.comparable(live_reference[world])
    assert got["binds"] > 0
    if world == "affinity-1k":
        # spread and zone-kept gangs: the live re-check rejects proposals
        # and the rounds re-solve them
        assert any(a["rejected"] for a in out["allocate"])
        assert max(a["rounds"] for a in out["allocate"]) == 3


@pytest.mark.slow
@pytest.mark.parametrize("world", FULL_WIDTH)
def test_full_width_world_equals_its_record(world):
    got, _ = _held_to_record(world)
    assert got["binds"] > 0


def test_record_file_names_every_world():
    doc = plugin_reference.load_digests()
    assert set(doc) == set(plugin_reference.WORLDS)
    for world, rec in doc.items():
        held = plugin_reference.held_to(rec)
        assert held["solves"] == rec["port_cpu"]["solves"] > 0, world
        assert ("mended" in rec) == (world in plugin_reference.MENDED)
    assert doc["affinity-preempt"]["port_cpu"]["walks"] > 0
    assert doc["affinity-preempt"]["evicts"] > 0


def test_affinity_preempt_is_held_to_the_mended_dispatch():
    """The JAX package as it is evicts critical pods that conformance
    refused after priority offered them (drf's tier rules after the
    veto); mended as upstream's dispatch, it evicts none such, and the
    critical pods it still evicts sit on nodes where priority offered no
    victim, so the first tier vetoed before conformance was asked."""
    rec = plugin_reference.load_digests()["affinity-preempt"]
    mended = rec["mended"]
    assert rec["held_to"] == "mended"
    assert rec["vetoed_evicted"] > 0 == mended["vetoed_evicted"]
    assert mended["critical_evicted"] < rec["critical_evicted"]
    assert mended["walks"] == rec["port_cpu"]["walks"] > 0


# -- the same world in both packages ----------------------------------------

@pytest.mark.parametrize("world", ["numa-1k", "proportional-1k",
                                   "affinity-1k", "gpushare-1k",
                                   "affinity-preempt"])
def test_tool_worlds_equal_field_by_field(world):
    """One seed gives the same world, cards, NUMA topologies, labels,
    affinity, namespaces and annotations included, in both packages."""
    _, jax_world, jax_crit = plugin_reference.build_world("volcano_tpu",
                                                          world)
    _, port_world, port_crit = plugin_reference.build_world(
        "volcano_tpu_torch", world)
    a, b = world_from_cache(port_world), world_from_cache(jax_world)
    assert_same(a, b)
    assert port_crit == jax_crit
    if world == "affinity-preempt":
        # every tenth running pod
        running = sum(len(t) for t in a["nodes"]["tasks"])
        assert len(port_crit) == (running + 9) // 10
        namespaces = {ns for j in a["jobs"] for ns in j["tasks"]["namespace"]}
        assert namespaces == {"default", "kube-system"}
    if world == "numa-1k":
        assert all(spec is not None for spec in a["nodes"]["numa"])
    if world == "gpushare-1k":
        assert sum(1 for c in a["nodes"]["cards"] if c) == 50


def test_parity_builder_world_equal_field_by_field():
    """tests/torch_parity.py's world builders give one world in both
    packages, and the port's cache_from_world carries it across whole."""
    from volcano_tpu_torch.cache import cache_from_world
    port = world_from_cache(plugin_slice_world(torch_api, torch_synthetic,
                                               torch_cache_mod))
    ref = world_from_cache(plugin_slice_world(jax_api, jax_synthetic,
                                              jax_cache_mod))
    assert_same(port, ref)
    assert_same(world_from_cache(cache_from_world(ref)), ref)
    assert any(port["nodes"]["cards"]) and any(port["nodes"]["numa"])
    tasks = [t for j in port["jobs"] for t in j["tasks"]["affinity"]]
    assert any(tasks)
