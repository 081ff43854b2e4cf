"""Trace-driven cluster simulation & replay, direct mode.

A discrete-event, virtual-clock simulator that drives the real scheduler
— the ``Scheduler`` shell, the configured action pipeline, cache and
executors — against workload traces, with no wall-clock sleeps. Its
decision plane is byte-identical to the JAX package's sim for the same
trace, seed and conf, which is how this package's whole cycle is held to
the reference.

Entry points::

    python -m volcano_tpu_torch.sim --scenario smoke --deterministic

    from volcano_tpu_torch.sim import SimRunner, make_scenario
    report = SimRunner(make_scenario("smoke", seed=1), seed=1,
                       scenario="smoke", device="cpu").run()
"""

from .report import deterministic_json, deterministic_part, to_json
from .runner import SIM_CONF, SimRunner, VirtualClock
from .trace import TraceEvent, load_trace, validate_trace, write_trace
from .workload import (SCENARIOS, baseline_trace, make_scenario,
                       synthetic_trace, trace_from_cache)

__all__ = [
    "SIM_CONF", "SimRunner", "VirtualClock",
    "TraceEvent", "load_trace", "validate_trace", "write_trace",
    "SCENARIOS", "baseline_trace", "make_scenario", "synthetic_trace",
    "trace_from_cache",
    "deterministic_json", "deterministic_part", "to_json",
]
