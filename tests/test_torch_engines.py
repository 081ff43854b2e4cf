"""The port's allocate engines against the JAX package's, on the CPU.

Each world (tests/test_allocate_action.py's cases, baseline_config("1k",
seed=3) under the default conf, and the strict engine's multi-queue and
adaptive-batching worlds) is built as a JAX SchedulerCache, carried into
the port through cache_from_world, and scheduled by one
``AllocateAction(engine=...)`` in each package. The JAX package runs its
engines on the CPU without FMA contraction (tests/torch_parity.py);
``callbacks`` is host code in both. Binds, PodGroup phases and conditions,
and the pipelined tasks must be equal for the same engine, and the strict
engine must run as many solves as the reference.
"""

import numpy as np
import pytest
import torch

from volcano_tpu.cache.synthetic import baseline_config
from volcano_tpu_torch import Scheduler
from volcano_tpu_torch.cache import cache_from_world
from volcano_tpu_torch.cache import synthetic as torch_synthetic
from volcano_tpu_torch.ops.place import NEG, place_plain, task_flags
from volcano_tpu_torch.ops.scores import default_weights

from torch_parity import port_gc_windows  # noqa: F401 (autouse)
from torch_parity import (ENGINE_CASES, ENGINE_WORLDS, ENGINES,
                          PLACE_WORLDS, assert_same, jax_reference, outcome,
                          run_allocate, run_torch_cycle, world_from_cache)

SMALL = [f"{e}:{c}" for e in ENGINES for c in ENGINE_CASES]
BASELINE = [f"{e}:1k-seed3" for e in ENGINES + ("tpu-fused",)]
STRICT = ["tpu-strict:strict-multiqueue",
          "tpu-strict:strict-multiqueue-batch3", "callbacks:strict-multiqueue",
          "tpu-strict:strict-adaptive", "callbacks:strict-adaptive"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_reference("engines", SMALL + BASELINE + STRICT,
                         tmp_path_factory.mktemp("jax") / "engines.pkl")


_ported = {}


def _port(name, reference):
    """The port's outcome and solves on the named world (cached: several
    tests read the 1k runs)."""
    if name not in _ported:
        engine, world_name = name.split(":", 1)
        world = reference[name][0]
        _, conf_text, arguments = ENGINE_WORLDS[world_name]
        cache = cache_from_world(world)
        ssn, solves = run_allocate(cache, engine, conf_text, arguments, True)
        _ported[name] = (outcome(ssn, cache), solves)
    return _ported[name]


@pytest.mark.parametrize("name", SMALL)
def test_engine_matches_jax(name, reference):
    got, _ = _port(name, reference)
    assert got == reference[name][1]


@pytest.mark.parametrize("name", BASELINE)
def test_default_conf_1k_matches_jax(name, reference):
    """baseline_config("1k", seed=3) under the default conf: 1,000 binds,
    equal to the JAX package's for the same engine."""
    got, _ = _port(name, reference)
    assert got == reference[name][1]
    assert len(got["binds"]) == 1000


def _admitted(binds):
    return frozenset(k.rsplit("-", 1)[0] for k in binds)


def test_engines_agree_on_1k(reference):
    """callbacks, tpu-strict and tpu-fused admit the same gangs and bind as
    many pods (tests/test_allocate_action.py:190-213 holds the reference
    to this); callbacks and tpu-strict bind alike."""
    binds = {e: _port(f"{e}:1k-seed3", reference)[0]["binds"]
             for e in ("callbacks", "tpu-strict", "tpu-fused")}
    assert _admitted(binds["callbacks"]) == _admitted(binds["tpu-strict"])
    assert _admitted(binds["callbacks"]) == _admitted(binds["tpu-fused"])
    assert len({len(b) for b in binds.values()}) == 1
    assert binds["callbacks"] == binds["tpu-strict"]


@pytest.mark.parametrize("name", STRICT)
def test_strict_worlds_match_jax(name, reference):
    """The multi-queue world, where shares move mid-cycle and predictions
    miss (batches of 16 and of 3), and the adaptive-batching world."""
    got, _ = _port(name, reference)
    assert got == reference[name][1]


def test_strict_matches_callbacks(reference):
    """tpu-strict binds the same tasks as callbacks (the reference's
    test_strict_batched_multiqueue_parity and
    test_strict_adaptive_batching_fewer_solves hold it to that)."""
    for world in ("strict-multiqueue", "strict-adaptive"):
        cb = set(_port(f"callbacks:{world}", reference)[0]["binds"])
        assert set(_port(f"tpu-strict:{world}", reference)[0]["binds"]) == cb
    assert (set(_port("tpu-strict:strict-multiqueue-batch3", reference)[0]
                ["binds"])
            == set(_port("callbacks:strict-multiqueue", reference)[0]
                   ["binds"]))


def test_strict_adaptive_solve_count(reference):
    """60 jobs at a floor of 4, doubling: as many solves as the reference
    runs, at most 7 (a fixed batch would take 15)."""
    _, solves = _port("tpu-strict:strict-adaptive", reference)
    assert solves == reference["tpu-strict:strict-adaptive"][2]
    assert solves <= 7


def test_strict_padding_changes_nothing():
    """The reference pads a strict batch's tasks to a power of two with
    invalid tasks for its compiled shapes; the port solves the batch as it
    is. Padded tasks own no job and change no state: the real tasks' words
    and the final state are the same either way."""
    (idle, releasing, used, ntasks, cap, max_tasks, req, job_ix, feas,
     static, min_avail) = PLACE_WORLDS["multi-chunk"]()
    T = len(req)
    pad = 512 - T
    zeros = np.zeros(len(min_avail), np.int32)
    flags, ready_need, keep_need = task_flags(job_ix, min_avail, zeros, zeros)
    ms = np.where(feas, static, NEG).astype(np.float32)
    t = torch.tensor
    state = (t(idle), t(idle + releasing), t(used), t(ntasks), t(cap),
             t(max_tasks))

    def padded(a, value=0):
        return t(np.concatenate([a, np.full((pad,) + a.shape[1:], value,
                                            a.dtype)]))

    w = default_weights(req.shape[1])
    want = place_plain(*state, t(req), t(flags), t(ready_need),
                       t(keep_need), t(ms), w)
    got = place_plain(*state, padded(req), padded(flags), padded(ready_need),
                      padded(keep_need), padded(ms, NEG), w)
    assert torch.equal(got[0][:T], want[0])
    assert not got[0][T:].any()
    for g, x in zip(got[1:], want[1:]):
        assert torch.equal(g, x)


def test_synthetic_20k_matches_jax():
    """One seed gives the same 20k world (20,000 pods in 400 gangs, 5,000
    nodes, queues q1/q2/q3 at 3/2/1) in both packages' generators."""
    assert_same(
        world_from_cache(torch_synthetic.baseline_config("20k", 5)[0]),
        world_from_cache(baseline_config("20k", 5)[0]))


def test_scheduler_runs_the_default_conf():
    """Scheduler.run_once with no conf text runs the reference's default
    conf (enqueue, allocate with engine callbacks, backfill)."""
    cache, binder, _ = torch_synthetic.baseline_config("1k", seed=3)
    Scheduler(cache, device="cpu").run_once()
    ref_cache = torch_synthetic.baseline_config("1k", seed=3)[0]
    run_torch_cycle(ref_cache, None)
    assert len(binder.binds) == 1000
    assert binder.binds == ref_cache.binder.binds
    assert np.all([j.podgroup.phase.value == "Running"
                   for j in cache.jobs.values()])
