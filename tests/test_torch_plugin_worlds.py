"""tools/plugin_reference.py's worlds through the port on the CPU.

numa-1k, proportional-1k and reservation-1k are held to their JAX
records in tests/plugin_reference_digests.json (each world to the record
its ``held_to`` names: affinity-preempt's and tdm-10k's are the JAX package
with its tier dispatch mended, sla-overcommit-10k's with its durations
read as Go's, ROADMAP §3); affinity-1k, gpushare-1k, tdm-1k, topology-1k
and sla-overcommit-1k (the full-width worlds at a tenth) are held live to
the JAX package, run in a child at XLA level 0; the six full-width worlds
are held to their records under ``slow``. A digest is the binds and
evictions in order, each PodGroup's phase, each allocate solve's
node-tensor path and the count of critical pods evicted, and for slice
18's worlds a record a cycle and the fused replays; the port's solves and
walks (B1's and B3's plain versions here) must equal the record's
``port_cpu``, which chip_smoke.py holds the card's launches to. The
records' schema and what each shows are checked, and the worlds
themselves are equal field by field in both packages.
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

DIGESTED = ("numa-1k", "proportional-1k", "reservation-1k")
LIVE = ("affinity-1k", "gpushare-1k", "tdm-1k", "topology-1k",
        "sla-overcommit-1k")
FULL_WIDTH = ("affinity-10k", "gpushare-10k", "affinity-preempt", "tdm-10k",
              "topology-10k", "sla-overcommit-10k")
# slice 18's worlds: their digests carry a record a cycle
SLICE_18 = ("tdm-10k", "topology-10k", "sla-overcommit-10k",
            "reservation-1k")


def _port(world):
    return plugin_reference.run_world("volcano_tpu_torch", world, "cpu")


def _held_to_record(world):
    record = plugin_reference.load_digests()[world]
    want = plugin_reference.held_to(record)
    out = _port(world)
    got = out["digest"]
    assert got == {k: v for k, v in want.items() if k in got}
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
    if world == "reservation-1k":
        # one target, one more locked node a cycle
        assert [len(c["locked"]) for c in got["per_cycle"]] == [1, 2, 3, 4]


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
    assert got == live_reference[world]
    assert got["binds"] > 0
    if world == "affinity-1k":
        # spread and zone-kept gangs: the live re-check rejects proposals
        # and the rounds re-solve them
        assert any(a["rejected"] for a in out["allocate"])
        assert max(a["rounds"] for a in out["allocate"]) == 3
    if world in ("tdm-1k", "topology-1k", "sla-overcommit-1k"):
        # tdm's and sla's job votes and task-topology's event handler are
        # not gang's: every replay goes through Statements
        assert got["fast_replays"] == 0 and got["solves"] > 0
    if world == "tdm-1k":
        # a walk with tdm's tier mask; the drain in the first cycle only
        assert got["walks"] > 0 and got["vetoed_evicted"] == 0
        assert [c["evicts_by_zone"].get("rz-closed", 0)
                for c in got["per_cycle"]][1:] == [0]
        assert got["per_cycle"][0]["evicts_by_zone"]["rz-closed"] > 0


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


@pytest.mark.parametrize("world", SLICE_18)
def test_slice_18_record_schema(world):
    """Each record: the digest's fields, one record a cycle of the world's
    cycles (binds, evictions, evictions by zone, PodGroup phases, the
    reservation's target and locked nodes) summing to the digest's, the
    fused replays, and the JAX package's walks equal to the port's CPU
    path's."""
    rec = plugin_reference.load_digests()[world]
    held = plugin_reference.held_to(rec)
    cycles = held["per_cycle"]
    assert len(cycles) == plugin_reference.world_cycles(world)
    assert {"binds", "evicts", "evicts_by_zone", "podgroup_phases",
            "target", "locked"} == set(cycles[0])
    assert sum(c["binds"] for c in cycles) == held["binds"] > 0
    assert sum(c["evicts"] for c in cycles) == held["evicts"]
    assert cycles[-1]["podgroup_phases"] == held["podgroup_phases"]
    assert held["walks"] == rec["port_cpu"]["walks"]
    assert held["action_failures"] == [] and "fast_replays" in held


def test_slice_18_records_show_their_plugins():
    """tdm-10k: B3 walks with tdm's tier mask, the drain on rz-closed in
    the first cycle only, and the JAX package as it is evicting victims
    tdm refused after priority offered them (its tier-dispatch fault),
    mended none; topology-10k: one solve, replayed through Statements;
    sla-overcommit-10k: Pending gangs enqueued in cycles 2 and 3 as sla
    permits them, none as the JAX package is (its duration fault);
    reservation-1k: the target elected in the first cycle and a node
    locked a cycle."""
    doc = plugin_reference.load_digests()
    tdm = doc["tdm-10k"]
    assert tdm["held_to"] == "mended" and tdm["port_cpu"]["walks"] > 0
    assert tdm["vetoed_evicted"] > 0 == tdm["mended"]["vetoed_evicted"]
    drained = [c["evicts_by_zone"].get("rz-closed", 0)
               for c in tdm["mended"]["per_cycle"]]
    assert drained[0] > 0 and drained[1:] == [0]
    topo = doc["topology-10k"]
    assert topo["solves"] == 1 and topo["fast_replays"] == 0
    sla = doc["sla-overcommit-10k"]
    pending = [c["podgroup_phases"].get("Pending", 0)
               for c in sla["mended"]["per_cycle"]]
    assert pending[0] > pending[1] > pending[2] == 0
    assert len({c["podgroup_phases"].get("Pending", 0)
                for c in sla["per_cycle"]}) == 1
    res = doc["reservation-1k"]["per_cycle"]
    assert [c["target"] for c in res] == ["vip"] * 4
    assert [len(c["locked"]) for c in res] == [1, 2, 3, 4]


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


def _slice_18_fields(cache) -> dict:
    """What slice 18's plugins read and world_from_cache does not carry."""
    def budget(b):
        return None if b is None else (b.min_available, b.max_unavailable)
    return {
        "nodes": [(n.name, n.revocable_zone) for n in cache.nodes.values()],
        # the cache stamps a job's schedule start from its clock when none
        # was set: only the reservation world's Pending gangs set theirs
        "jobs": [(j.uid, j.preemptable, j.revocable_zone, budget(j.budget),
                  j.waiting_time, j.creation_timestamp,
                  j.schedule_start_timestamp if j.queue == "vip" else None,
                  sorted(j.podgroup.annotations.items()),
                  [(t.uid, t.preemptable, t.revocable_zone, t.task_role,
                    t.node_name) for t in j.tasks.values()])
                 for j in cache.jobs.values()],
        "queues": [(q.name, None if q.capability is None
                    else (q.capability.cpu, q.capability.memory))
                   for q in cache.queues.values()]}


@pytest.mark.parametrize("world", ["tdm-1k", "topology-1k",
                                   "sla-overcommit-1k", "reservation-1k"])
def test_slice_18_worlds_equal_field_by_field(world):
    """One seed gives the same world in both packages, revocable zones,
    preemptable tasks, budgets, task roles, annotations and queue
    capabilities included."""
    _, jax_world, _ = plugin_reference.build_world("volcano_tpu", world)
    _, port_world, _ = plugin_reference.build_world("volcano_tpu_torch",
                                                    world)
    assert_same(world_from_cache(port_world), world_from_cache(jax_world))
    got = _slice_18_fields(port_world)
    assert got == _slice_18_fields(jax_world)
    if world == "tdm-1k":
        zones = [z for _, z in got["nodes"]]
        assert zones.count("rz-open") == zones.count("rz-closed") == 20
        running = {t[4] for j in got["jobs"] if j[1] for t in j[8]} - {""}
        assert any(z == "rz-closed" for n, z in got["nodes"]
                   if n in running)


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
