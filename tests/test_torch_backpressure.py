"""The admission front door's bounded pending-work budget in
volcano_tpu_torch (``webhooks/backpressure.py``) and the overload drills'
seeded burst generator (``chaos.OverloadInjector``), held to the JAX
package's: the port of tests/test_overload.py's TestAdmissionBudget (the
batched front door, TestFrontDoorIntegration, waits for the admission
webhooks). Each scenario runs once through each package's classes and the
two records must be equal; the assertions are the reference test's."""

import types

import pytest

import volcano_tpu.chaos as jax_chaos
import volcano_tpu.metrics as jax_metrics
import volcano_tpu.store as jax_store
import volcano_tpu.webhooks.backpressure as jax_bp
import volcano_tpu_torch.chaos as pt_chaos
import volcano_tpu_torch.metrics as pt_metrics
import volcano_tpu_torch.store as pt_store
import volcano_tpu_torch.webhooks.backpressure as pt_bp

JAX = types.SimpleNamespace(bp=jax_bp, chaos=jax_chaos, store=jax_store,
                            metrics=jax_metrics)
PORT = types.SimpleNamespace(bp=pt_bp, chaos=pt_chaos, store=pt_store,
                             metrics=pt_metrics)


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` through each package; the records must
    be equal. Returns the port's."""
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def _refusal(p, budget, per_queue, nbytes, priority):
    """The BackpressureError's fields, or None when the batch landed."""
    try:
        budget.admit_batch(per_queue, nbytes, priority=priority)
    except p.bp.BackpressureError as exc:
        return {"reason": exc.reason, "queue": exc.queue,
                "retry_after_s": exc.retry_after_s,
                "priority_floor": exc.priority_floor}
    return None


def test_depth_bound_is_hard():
    def scenario(p):
        b = p.bp.AdmissionBudget(max_queue_depth=10, shed_watermark=1.0)
        b.admit_batch({"q1": 10}, 100.0, priority=0)
        return _refusal(p, b, {"q1": 1}, 10.0, 10), b.pending_depth()

    err, depth = both(scenario)
    assert err["reason"] == "queue_depth" and err["queue"] == "q1"
    assert err["retry_after_s"] > 0
    assert depth == 10                      # the refusal charged nothing


def test_priority_shed_ordering():
    """Past the watermark the floor rises with fill: the lowest priorities
    shed first while high-priority batches still land up to the hard
    limit."""
    def scenario(p):
        b = p.bp.AdmissionBudget(max_queue_depth=100, shed_watermark=0.5)
        b.admit_batch({"q1": 60}, 0.0, priority=0)
        err = _refusal(p, b, {"q1": 10}, 0.0, 0)
        landed = _refusal(p, b, {"q1": 10}, 0.0, 10)
        return err, landed, b.pending_depth(), dict(b.shed)

    err, landed, depth, shed = both(scenario)
    assert err["reason"] == "priority_shed" and err["priority_floor"] > 0
    assert landed is None and depth == 70
    assert shed == {"priority_shed": 1}


def test_floor_monotone_in_fill():
    def scenario(p):
        b = p.bp.AdmissionBudget(max_queue_depth=100, shed_watermark=0.5)
        floors = []
        for depth in (40, 60, 80, 99):
            b.depth = {"q1": depth}
            with b._lock:
                floors.append(b._priority_floor_locked("q1"))
        return floors

    floors = both(scenario)
    assert floors == sorted(floors)
    assert floors[0] == 0 and floors[-1] >= 4


def test_retry_after_monotone_in_excess():
    def scenario(p):
        b = p.bp.AdmissionBudget(cycle_period_s=1.0)
        b.observe_drain(8)                  # 8 tasks/s
        return [b.retry_after_s(x) for x in (0, 1, 4, 16, 64, 10_000)]

    hints = both(scenario)
    assert hints == sorted(hints)
    assert hints[0] >= 1.0                  # never "retry now"
    assert hints[-1] <= 64.0                # capped


def test_retry_after_uses_observed_throughput():
    def scenario(p):
        slow = p.bp.AdmissionBudget(cycle_period_s=1.0)
        fast = p.bp.AdmissionBudget(cycle_period_s=1.0)
        slow.observe_drain(1)
        fast.observe_drain(100)
        return slow.retry_after_s(10), fast.retry_after_s(10)

    slow, fast = both(scenario)
    assert slow > fast


def test_bytes_budget():
    def scenario(p):
        b = p.bp.AdmissionBudget(max_queue_depth=10_000,
                                 max_total_bytes=1000, shed_watermark=1.0)
        b.admit_batch({"q1": 1}, 900.0, priority=0)
        return _refusal(p, b, {"q2": 1}, 200.0, 10)

    assert both(scenario)["reason"] == "bytes"


def test_credit_restores_headroom():
    def scenario(p):
        b = p.bp.AdmissionBudget(max_queue_depth=10, shed_watermark=1.0)
        b.admit_batch({"q1": 10}, 100.0, priority=0)
        b.credit("q1", 10, 100.0)
        b.admit_batch({"q1": 10}, 100.0, priority=0)
        return b.detail()

    assert both(scenario)["high_water"]["q1"] == 10


def test_backpressure_is_admission_error():
    assert issubclass(pt_bp.BackpressureError, pt_store.AdmissionError)
    assert pt_bp.estimate_job_bytes(7) == jax_bp.estimate_job_bytes(7)


def test_bounded_depth_under_seeded_bursts():
    """The OverloadInjector drill: seeded flash crowds against the budget.
    The per-queue depth bound holds at every step, the same seed replays
    the same shed sequence, and each package draws the same bursts."""
    def drive(p, seed):
        inj = p.chaos.OverloadInjector(burst_rate=0.5, burst_range=(5, 20),
                                       seed=seed)
        b = p.bp.AdmissionBudget(max_queue_depth=40, shed_watermark=0.6)
        shed = admitted = 0
        specs = []
        for cycle in range(200):
            for _ in range(inj.tick()):
                spec = inj.job_spec(2)
                specs.append(spec)
                queue = f"q{spec['queue_ix'] + 1}"
                try:
                    b.admit_batch({queue: spec["tasks"]},
                                  p.bp.estimate_job_bytes(spec["tasks"]),
                                  spec["priority"])
                    admitted += 1
                except p.bp.BackpressureError:
                    shed += 1
                for q, d in b.depth.items():
                    assert d <= 40, (q, d)
            # the cluster drains a little each cycle
            for q in list(b.depth):
                b.credit(q, min(2, b.depth[q]))
            b.observe_drain(2)
        return (admitted, shed, dict(b.high_water), specs, inj.bursts,
                b.detail())

    a1 = both(drive, 7)
    assert drive(PORT, 7) == a1                 # seeded: reproducible
    admitted, shed, high = a1[:3]
    assert admitted > 0 and shed > 0
    assert all(d <= 40 for d in high.values())


def test_budget_publishes_metrics_and_health_detail():
    """Refusals count by reason and the pending depth is a gauge, in both
    packages' metrics; the port's health detail carries them in its
    ``overload`` section."""
    def scenario(p):
        p.metrics.reset_local()
        try:
            b = p.bp.AdmissionBudget(max_queue_depth=4, shed_watermark=1.0)
            b.admit_batch({"q1": 3}, 10.0, priority=0)
            _refusal(p, b, {"q1": 2}, 10.0, 0)
            counters = {k: v for k, v in p.metrics.local_counters().items()
                        if k[0] == "admission_backpressure"}
            detail = p.metrics.health_detail()["overload"]
            return counters, detail["backpressure_total"], \
                detail["admission_pending_depth"]
        finally:
            p.metrics.reset_local()

    counters, by_reason, depth = both(scenario)
    assert counters == {("admission_backpressure", "queue_depth"): 1.0}
    assert by_reason == {"queue_depth": 1.0} and depth == 3


@pytest.mark.parametrize("rate", [-0.1, 1.5])
def test_overload_injector_refuses_a_bad_rate(rate):
    for p in (JAX, PORT):
        with pytest.raises(ValueError, match="burst_rate"):
            p.chaos.OverloadInjector(burst_rate=rate)
