"""The port's drf, proportion and predicates plugins against the JAX
package's, on the CPU.

- drf: hierarchical drf on tests/test_hdrf.py's worlds, and drf's
  namespace order, each as one allocate-tpu cycle in both packages;
- proportion: the deserved water-filling at 3 queues (the NumPy twin the
  plugin uses below 64) and at 64 and 96 queues (torch ops, against the
  JAX package's lax.while_loop);
- predicates: the feasibility mask over a world of taints, selectors,
  required affinity, an unschedulable node and host ports.

The JAX results come from a child process (tests/torch_parity.py). Decisions
and masks must be equal, and so must the deserved shares of the NumPy twin
and of the torch form: the torch form sums the queue axis in the order
XLA:CPU gives the JAX loop's sums (windows of 32, then the window sums).
"""

import numpy as np
import pytest
import torch

import volcano_tpu_torch.plugins  # noqa: F401
from volcano_tpu_torch.api import TaskStatus
from volcano_tpu_torch.cache import cache_from_world
from volcano_tpu_torch.cache.snapshot import discover_resource_names
from volcano_tpu_torch.framework import (close_session, open_session,
                                         parse_scheduler_conf)
from volcano_tpu_torch.ops.fairness import (proportion_deserved,
                                            proportion_deserved_numpy)

from torch_parity import port_gc_windows  # noqa: F401 (autouse)
from torch_parity import (DEPLOYED_CONF, PLUGIN_CASES, PLUGIN_WORLDS,
                          jax_reference, outcome, proportion_inputs,
                          run_torch_cycle)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_reference("plugins", list(PLUGIN_CASES),
                         tmp_path_factory.mktemp("jax") / "plugins.pkl")


@pytest.mark.parametrize("name", list(PLUGIN_WORLDS))
def test_drf_cycle_matches_jax(name, reference):
    world, want = reference[name]
    cache = cache_from_world(world)
    got = outcome(run_torch_cycle(cache, PLUGIN_WORLDS[name][1]), cache)
    assert got == want
    assert got["binds"]


@pytest.mark.parametrize("name, Q, seed", [("proportion-3", 3, 0),
                                           ("proportion-64", 64, 1),
                                           ("proportion-96", 96, 2)])
def test_proportion_deserved_matches_jax(name, Q, seed, reference):
    args = proportion_inputs(Q, seed)
    want = reference[name]
    num = proportion_deserved_numpy(*args)
    np.testing.assert_array_equal(num.deserved, want["numpy"][0])
    np.testing.assert_array_equal(num.share, want["numpy"][1])
    dev = proportion_deserved(*args, device=torch.device("cpu"))
    np.testing.assert_array_equal(dev.deserved.numpy(), want["jax"][0])
    np.testing.assert_array_equal(dev.share.numpy(), want["jax"][1])


@pytest.mark.parametrize("Q", [1, 31, 32, 33, 64, 65, 96, 200, 1025])
def test_queue_sum_follows_xla_order(Q):
    """The torch form sums the queue axis as XLA:CPU's reduce-window
    rewrite does: windows of 32 in order from 0 over the axis padded with
    zeros (the smaller half before), then the window sums the same way.
    Held against that order written out in NumPy, on values whose sum
    rounds differently in other orders."""
    from volcano_tpu_torch.ops.fairness import _sum0

    def seq(x):
        acc = np.float32(0)
        for v in x:
            acc = np.float32(acc + v)
        return acc

    def xla(x):
        if len(x) <= 32:
            return seq(x)
        pad = -len(x) % 32
        x = np.concatenate([np.zeros(pad // 2, np.float32), x,
                            np.zeros(pad - pad // 2, np.float32)])
        return xla(np.array([seq(x[i:i + 32])
                             for i in range(0, len(x), 32)], np.float32))

    rng = np.random.RandomState(Q)
    x = (rng.rand(Q, 3) * rng.choice([1e-3, 1.0, 1e3, 1e5], (Q, 3))
         ).astype(np.float32)
    got = _sum0(torch.tensor(x)).numpy()
    assert [xla(x[:, r]) for r in range(3)] == got.tolist()


def test_proportion_plugin_takes_torch_ops_at_64_queues(monkeypatch):
    """At 64 queues or more the plugin's deserved comes from the torch
    form on the session's device; below, from the NumPy twin."""
    from volcano_tpu_torch.cache.synthetic import make_cluster, make_jobs
    from volcano_tpu_torch.api import QueueInfo
    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.ops import fairness
    calls = []
    real = fairness.proportion_deserved
    monkeypatch.setattr(fairness, "proportion_deserved",
                        lambda *a, **k: calls.append(k["device"]) or real(*a, **k))
    for Q, want in ((3, 0), (64, 1)):
        calls.clear()
        cache = SchedulerCache(default_queue="")
        names = [f"q{i}" for i in range(Q)]
        for n in names:
            cache.add_queue(QueueInfo(name=n, weight=1 + len(n) % 3))
        for node in make_cluster(8):
            cache.add_node(node)
        for job in make_jobs(Q * 2, Q, names, seed=1):
            cache.add_job(job)
        conf = parse_scheduler_conf(DEPLOYED_CONF)
        ssn = open_session(cache, conf.tiers, conf.configurations,
                           device="cpu")
        assert len(ssn.queue_deserved) == Q
        close_session(ssn)
        assert len(calls) == want


def test_predicates_mask_matches_jax(reference):
    world, uids, want, want_stateful = reference["predicates-mask"]
    cache = cache_from_world(world)
    conf = parse_scheduler_conf(DEPLOYED_CONF)
    ssn = open_session(cache, conf.tiers, conf.configurations, device="cpu")
    tasks = [t for j in ssn.jobs.values() for t in j.tasks.values()
             if t.status == TaskStatus.PENDING]
    assert [t.uid for t in tasks] == uids

    class Axis:
        names = list(ssn.nodes)

    mask = ssn.plugins["predicates"].feasibility_mask(ssn, tasks, Axis)
    np.testing.assert_array_equal(mask, want)
    assert not mask.all() and mask.any()
    assert sorted(ssn.stateful_predicates) == want_stateful == ["predicates"]
    # the host predicate agrees with the mask on every (task, node) pair
    # of a node with no claimed ports
    nodes = list(ssn.nodes.values())
    for ti, task in enumerate(tasks[::7]):
        for ni, node in enumerate(nodes):
            try:
                ssn.predicate_fn(task, node)
                ok = True
            except ValueError:
                ok = False
            assert ok == mask[ti * 7, ni]
    close_session(ssn)
    assert discover_resource_names(nodes, tasks).names == ["cpu", "memory"]


@pytest.mark.parametrize("affinity_on, taints_on", [(True, True),
                                                    (True, False),
                                                    (False, True)])
def test_predicates_mask_groups_equal_pairwise(reference, affinity_on,
                                               taints_on):
    """The mask computes one row for each task signature; tasks of one gang
    with different selectors or tolerations must still get their own rows,
    equal to the static predicates tested pair by pair."""
    from volcano_tpu_torch.plugins.predicates import (node_selector_ok,
                                                      taints_tolerated)
    world = reference["predicates-mask"][0]
    cache = cache_from_world(world)
    conf = parse_scheduler_conf(DEPLOYED_CONF)
    ssn = open_session(cache, conf.tiers, conf.configurations, device="cpu")
    tasks = [t for j in ssn.jobs.values() for t in j.tasks.values()
             if t.status == TaskStatus.PENDING]
    # split gangs: every third task of a gang drops its tolerations, every
    # fifth gets a selector of its own
    for i, task in enumerate(tasks):
        if i % 3 == 1:
            task.tolerations = []
        if i % 5 == 2:
            task.node_selector = {"zone": "a"}
    plugin = ssn.plugins["predicates"]
    plugin.node_affinity_enable, plugin.taint_enable = affinity_on, taints_on

    class Axis:
        names = list(ssn.nodes)

    mask = plugin.feasibility_mask(ssn, tasks, Axis)
    nodes = list(ssn.nodes.values())
    want = np.array([[not node.unschedulable
                      and (not affinity_on or node_selector_ok(task, node))
                      and (not taints_on or taints_tolerated(task, node))
                      and not (node.used_ports
                               and node.has_port_conflict(task))
                      for node in nodes] for task in tasks])
    close_session(ssn)
    np.testing.assert_array_equal(mask, want)
    assert len({plugin._task_signature(t) for t in tasks}) > 4
