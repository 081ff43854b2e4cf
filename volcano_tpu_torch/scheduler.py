"""Scheduler shell: the periodic scheduling loop (mirrors
pkg/scheduler/scheduler.go:39-170): ``run_once`` over the configured action
pipeline, YAML conf hot-reload, per-action latency metrics.

Fault isolation: one exception raised inside an action must not abort the
cycle or kill the ``run()`` thread. ``run_once`` isolates each action — a
failing action is logged, counted (``metrics.register_action_failure``)
and skipped, the session still closes and later actions still run — and
returns the isolated failures. ``run()`` wraps every cycle in a
crash-loop guard: consecutive failed cycles back off exponentially with
jitter and flip the exported health to "degraded" until a clean cycle.

What isolation must not hide is refused before any cycle runs: every
action, plugin and configuration block of the conf is checked when the
conf loads (construction and hot-reload), and a constructor argument
asking for a mode this package lacks raises ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from . import actions as _actions  # noqa: F401  (registers the actions)
from . import metrics
from . import plugins as _plugins  # noqa: F401  (registers the plugins)
from .framework import (abandon_session, close_session, get_action,
                        get_plugin_builder, open_session,
                        parse_scheduler_conf, resolve_device)
from .framework.conf import SchedulerConfiguration
from .obs import trace as obs_trace

log = logging.getLogger(__name__)

DEFAULT_SCHEDULE_PERIOD = 1.0

# crash-loop guard defaults: the first failed cycle waits backoff_base,
# each consecutive failure doubles it up to backoff_max, each wait is
# stretched by up to backoff_jitter (uniform) so replicas crash-looping on
# the same poison input do not retry in lockstep
DEFAULT_BACKOFF_BASE = 1.0
DEFAULT_BACKOFF_MAX = 60.0
DEFAULT_BACKOFF_JITTER = 0.2

# per-cycle resync retry cap when a cycle budget is configured: the resync
# pass runs before the budget exists, so it carries its own work bound
DEFAULT_RESYNC_MAX_PER_CYCLE = 256

# shadow-verifier cadence: every N cycles the cache re-derives its snapshot
# and tensor state from scratch after the cycle's timed window and repairs
# any drift. 0 disables; VOLCANO_TPU_DRIFT_VERIFY_EVERY overrides the
# constructor default.
DEFAULT_DRIFT_VERIFY_EVERY = 64

# constructor arguments of the JAX package's shell that name modes this
# package does not have yet, and where they come from
REFUSED_MODES = {
    "pipelined": "the pipelined cycle (speculative solve, ROADMAP item 8)",
    "fast_admit": "event-driven fast admit (ROADMAP item 8)",
    "solve_deadline_s": "the device-fault cool-down (ROADMAP item 10)",
}
_MODE_ENV = {"pipelined": "VOLCANO_TPU_PIPELINED",
             "fast_admit": "VOLCANO_TPU_FAST_ADMIT"}


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").lower() in ("1", "true", "on", "yes")


def _drift_verify_default() -> int:
    try:
        return int(os.environ.get("VOLCANO_TPU_DRIFT_VERIFY_EVERY",
                                  DEFAULT_DRIFT_VERIFY_EVERY))
    except ValueError:
        return DEFAULT_DRIFT_VERIFY_EVERY


class WallClock:
    """Default time source for the shell's pacing: monotonic wall time
    with a stop-interruptible sleep. The sim swaps in a VirtualClock whose
    sleep advances virtual time and returns immediately; host timings
    (the metrics' spans) still measure real latency."""

    def __init__(self, stop_event: threading.Event):
        self._stop = stop_event

    def time(self) -> float:
        return time.monotonic()

    def now(self) -> float:
        """Wall-clock seconds since the epoch — the timebase shared with
        job creation timestamps. time() stays monotonic for pacing."""
        return time.time()

    def sleep(self, seconds: float) -> None:
        self._stop.wait(seconds)


def check_conf(conf: SchedulerConfiguration) -> None:
    """Refuse a conf naming an action, plugin, engine or argument this
    package lacks — raises ValueError by name."""
    for name in conf.actions:
        get_action(name).check_conf(conf.configurations)
    for tier in conf.tiers:
        for opt in tier.plugins:
            # building the plugin parses its arguments, which refuses the
            # ones this package lacks
            get_plugin_builder(opt.name)(opt.arguments)


class Scheduler:
    def __init__(self, cache, conf_text: Optional[str] = None,
                 conf_path: Optional[str] = None,
                 schedule_period: float = DEFAULT_SCHEDULE_PERIOD,
                 backoff_base: float = DEFAULT_BACKOFF_BASE,
                 backoff_max: float = DEFAULT_BACKOFF_MAX,
                 backoff_jitter: float = DEFAULT_BACKOFF_JITTER,
                 clock=None,
                 rng: Optional[random.Random] = None,
                 pipelined: Optional[bool] = None,
                 fast_admit: Optional[bool] = None,
                 cycle_budget_s: Optional[float] = None,
                 budget_cost_fn: Optional[Callable] = None,
                 solve_deadline_s: Optional[float] = None,
                 resync_max_per_cycle: Optional[int] = None,
                 drift_verify_every: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None):
        asked = {"pipelined": pipelined, "fast_admit": fast_admit,
                 "solve_deadline_s": solve_deadline_s}
        for mode, value in asked.items():
            env = _MODE_ENV.get(mode)
            if value is None and env is not None and _env_flag(env):
                value = True
            if value:
                raise NotImplementedError(
                    f"Scheduler({mode}=...) is not in volcano_tpu_torch "
                    f"yet: it needs {REFUSED_MODES[mode]}")
        self.cache = cache
        self.device = resolve_device(device)
        self.conf_path = conf_path
        self.schedule_period = schedule_period
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.backoff_jitter = backoff_jitter
        self._conf_mtime: Optional[float] = None
        self._stop = threading.Event()
        # time source (time/now/sleep): wall clock by default, the sim's
        # VirtualClock under replay
        self.clock = clock or WallClock(self._stop)
        # crash-loop backoff jitter: per-process entropy by default, a
        # seeded random.Random under the sim
        self._rng = rng if rng is not None else random.Random()
        self.conf: SchedulerConfiguration = None
        # pre-action hook (name, session) -> None; raising makes the
        # action count as failed (chaos.ActionFaultInjector plugs in here)
        self.action_fault_hook: Optional[Callable] = None
        self.consecutive_failures = 0
        # the epilogue counts cycles and runs the shadow drift verifier
        # every drift_verify_every of them
        self._cycles_run = 0
        self.drift_verify_every = _drift_verify_default() \
            if drift_verify_every is None else drift_verify_every
        self._reconciled = False
        # overload: a per-cycle work bound. None (the default) is
        # unbounded; with a budget every action checks it before dispatch
        # and an exhausted cycle defers the rest of the pipeline to the
        # next cycle, which starts with the first deferred action
        self.cycle_budget_s = cycle_budget_s
        self.budget_cost_fn = budget_cost_fn
        self.resync_max_per_cycle = resync_max_per_cycle \
            if resync_max_per_cycle is not None \
            else (DEFAULT_RESYNC_MAX_PER_CYCLE if cycle_budget_s else None)
        self._carryover: Optional[str] = None
        self.last_budget = None
        self.budget_exhausted_total = 0
        self.deferred_actions_total = 0
        self.max_cycle_spend_s = 0.0
        # the last cycle's phases in host wall seconds: "open_session",
        # each action run by name, "close_session" and "cycle" (open to
        # close); an action that uses the device reads its result back
        # before it returns, so its time includes the device's
        self.last_cycle_s: Dict[str, float] = {}
        self._load_conf(conf_text)

    @property
    def actions(self) -> list:
        """The action objects of the conf's pipeline, in order."""
        return [get_action(name) for name in self.conf.actions]

    def _load_conf(self, conf_text: Optional[str] = None) -> None:
        mtime = None
        if conf_text is None and self.conf_path \
                and os.path.exists(self.conf_path):
            mtime = os.path.getmtime(self.conf_path)
            with open(self.conf_path) as f:
                conf_text = f.read()
        conf = parse_scheduler_conf(conf_text)
        check_conf(conf)
        self.conf = conf
        # the file counts as loaded only once its conf is accepted: a
        # refused file is read again, and refused again, every cycle
        if mtime is not None:
            self._conf_mtime = mtime

    def _maybe_reload_conf(self) -> None:
        """Hot-reload on file change (scheduler.go:112-170). A reloaded
        conf that names something this package lacks raises here, out of
        run_once, on every cycle until the file changes again; the
        previous conf stays in force."""
        if not self.conf_path or not os.path.exists(self.conf_path):
            return
        mtime = os.path.getmtime(self.conf_path)
        if mtime != self._conf_mtime:
            self._load_conf()

    def run_once(self) -> List[Tuple[str, BaseException]]:
        """One scheduling cycle (scheduler.go:90-110).

        Returns the isolated per-action failures of the cycle, [] when
        clean. A failing action is skipped — the session still closes and
        the rest of the pipeline still runs; only a failure OUTSIDE the
        action loop (conf reload, snapshot/open_session, close_session)
        propagates. Every run_once is one span tree (cycle → resync /
        schedule → open_session / action:* / close_session → epilogue) and the per-action and end-to-end metrics are fed from
        the spans."""
        rec = obs_trace.TRACE
        cycle = self._cycles_run
        began = rec.enabled
        if began:
            rec.begin_cycle(cycle)
        try:
            with rec.span("cycle", cycle=cycle):
                return self._run_once_traced(rec, cycle)
        finally:
            if began:
                rec.end_cycle()

    def _run_once_traced(self, rec, cycle: int
                         ) -> List[Tuple[str, BaseException]]:
        self._maybe_reload_conf()
        # retry failed side effects whose backoff expired (the reference's
        # errTasks worker, cache.go:777-799); isolated like an action
        errors: List[Tuple[str, BaseException]] = []
        if hasattr(self.cache, "process_resync_tasks"):
            try:
                with rec.span("resync"):
                    self.cache.process_resync_tasks(
                        self.resync_max_per_cycle)
            except Exception as exc:
                log.exception("resync processing failed")
                metrics.register_action_failure("resync")
                errors.append(("resync", exc))
        runnable = [(name, get_action(name)) for name in self.conf.actions]
        if not runnable:
            self._cycle_epilogue()
            return errors
        # cycle budget: rotate the pipeline to the carry-over cursor
        # before anything runs, so last cycle's deferred actions go first
        budget = None
        if self.cycle_budget_s:
            from .cycle_budget import CycleBudget
            budget = CycleBudget(self.cycle_budget_s, self.clock.time)
            self.last_budget = budget
            if self._carryover is not None:
                names = [n for n, _ in runnable]
                if self._carryover in names:
                    ix = names.index(self._carryover)
                    runnable = runnable[ix:] + runnable[:ix]
                self._carryover = None
        times: Dict[str, float] = {}
        sched_sp = rec.span("schedule")
        crashed = False
        with sched_sp:
            with rec.span("open_session") as sp:
                ssn = open_session(self.cache, self.conf.tiers,
                                   self.conf.configurations,
                                   time_fn=self.clock.now,
                                   device=self.device)
            times["open_session"] = sp.dur_s
            try:
                for act_ix, (name, action) in enumerate(runnable):
                    if budget is not None and act_ix > 0 \
                            and budget.exhausted():
                        # defer the REST of the pipeline to the next cycle
                        # (the first action of a cycle always runs)
                        deferred = [n for n, _ in runnable[act_ix:]]
                        self._carryover = name
                        self.budget_exhausted_total += 1
                        self.deferred_actions_total += len(deferred)
                        metrics.register_cycle_budget_exhausted(name)
                        metrics.register_deferred_actions(len(deferred))
                        log.warning(
                            "cycle budget exhausted (%.3fs spent of %.3fs); "
                            "deferring %s to the next cycle",
                            budget.spent(), budget.budget_s, deferred)
                        break
                    action_sp = rec.span("action:" + name, action=name)
                    try:
                        with action_sp:
                            try:
                                if self.action_fault_hook is not None:
                                    self.action_fault_hook(name, ssn)
                                action.execute(ssn)
                            except Exception as exc:
                                log.exception("action %s failed; skipping "
                                              "it this cycle", name)
                                metrics.register_action_failure(name)
                                errors.append((name, exc))
                    finally:
                        metrics.update_action_duration(name,
                                                       action_sp.dur_s)
                        times[name] = action_sp.dur_s
                    if budget is not None \
                            and self.budget_cost_fn is not None:
                        # deterministic work model (the sim's meter); a
                        # broken cost model must not break the cycle
                        try:
                            budget.charge(self.budget_cost_fn(name, ssn))
                        except Exception:
                            log.exception("budget cost model failed; "
                                          "action %s not charged", name)
                if budget is not None:
                    self.max_cycle_spend_s = max(self.max_cycle_spend_s,
                                                 budget.spent())
            except BaseException as exc:
                # a non-Exception escaping here is a (simulated or real)
                # process death: a killed process runs no close-time
                # writebacks, so neither may we
                crashed = not isinstance(exc, Exception)
                raise
            finally:
                if crashed:
                    abandon_session(ssn)
                else:
                    with rec.span("close_session") as sp:
                        close_session(ssn)
                    times["close_session"] = sp.dur_s
        metrics.update_e2e_duration(sched_sp.dur_s)
        times["cycle"] = sched_sp.dur_s
        self.last_cycle_s = times
        self._cycle_epilogue()
        return errors

    def _cycle_epilogue(self) -> None:
        """Off-cycle bookkeeping, run on both run_once exits: flush the
        journal's buffered ack tail, run the in-flight ack watchdog and
        tick the drift-verify cadence."""
        with obs_trace.TRACE.span("epilogue"):
            journal = getattr(self.cache, "journal", None)
            if journal is not None:
                try:
                    journal.flush()
                except Exception:
                    log.exception("journal flush failed")
            if hasattr(self.cache, "process_expired_inflight"):
                try:
                    with obs_trace.TRACE.span("inflight_watchdog"):
                        self.cache.process_expired_inflight()
                except Exception:
                    log.exception("in-flight ack watchdog failed")
            self._maybe_verify_drift()

    def _maybe_verify_drift(self) -> None:
        """Every ``drift_verify_every`` cycles, after the cycle's timed
        window closed, have the cache re-derive its snapshot and tensor
        state from scratch and repair any drift. Isolated like an action
        (``drift-verify``): a verifier fault costs no cycle."""
        self._cycles_run += 1
        if not self.drift_verify_every \
                or self._cycles_run % self.drift_verify_every:
            return
        try:
            stats = self.cache.verify_state_integrity()
            if stats["drift_total"]:
                log.error("state drift detected and repaired: %s",
                          stats["drift"])
        except Exception:
            log.exception("shadow drift verification failed")
            metrics.register_action_failure("drift-verify")

    def startup_reconcile(self, cluster_binds=None, cluster_evicts=None):
        """Settle the intent journal's crash window before the first cycle
        (cache.reconcile_journal); called by run(), and explicitly by
        restart harnesses with a cluster-truth oracle."""
        self._reconciled = True
        reconcile = getattr(self.cache, "reconcile_journal", None)
        if reconcile is None:
            return None
        report = reconcile(cluster_binds, cluster_evicts)
        if report is not None and report.replayed:
            log.warning("journal reconciliation replayed %d unacked "
                        "intents: %s", report.replayed, report.as_dict())
        # the in-flight ledger died with the old process while the settled
        # state still shows BOUND/RELEASING tasks whose ack is outstanding
        rearm = getattr(self.cache, "rearm_inflight_from_state", None)
        if rearm is not None:
            try:
                rearm()
            except Exception:
                log.exception("re-arming the in-flight ledger failed")
        return report

    def _backoff(self, cap: float) -> float:
        """Exponential backoff with jitter for the current consecutive
        failure count (>= 1), capped at ``cap``."""
        n = max(self.consecutive_failures, 1)
        delay = min(self.backoff_base * (2 ** (n - 1)), cap)
        return delay * (1.0 + self._rng.uniform(0.0, self.backoff_jitter))

    def run(self) -> None:
        """wait.Until(runOnce, period) (scheduler.go:81-88) with the
        crash-loop guard: a failed cycle increments the consecutive
        failure count, flips health to degraded and waits a jittered
        exponential backoff instead of the period; a clean cycle resets
        both. An exception escaping run_once backs off up to backoff_max;
        isolated per-action failures cap near the schedule period."""
        if not self._reconciled:
            try:
                self.startup_reconcile()
            except Exception:
                log.exception("startup journal reconciliation failed; "
                              "continuing (side effects may retry)")
        while not self._stop.is_set():
            cycle_start = time.perf_counter()
            cycle_fault = False
            try:
                errors = self.run_once()
            except Exception as exc:
                log.exception("scheduling cycle failed outside the action "
                              "pipeline")
                errors = [("cycle", exc)]
                cycle_fault = True
            if errors:
                self.consecutive_failures += 1
                metrics.set_health(metrics.DEGRADED,
                                   self.consecutive_failures)
                cap = self.backoff_max if cycle_fault else \
                    max(self.schedule_period, self.backoff_base)
                self.clock.sleep(self._backoff(cap))
                continue
            if self.consecutive_failures:
                self.consecutive_failures = 0
            metrics.set_health(metrics.HEALTHY, 0)
            remaining = self.schedule_period \
                - (time.perf_counter() - cycle_start)
            if remaining > 0:
                self.clock.sleep(remaining)

    def prewarm(self) -> int:
        """Pay the card's start-up costs before the first cycle: open the
        CUDA context, build and load every kernel of ``ops/csrc`` (one
        nvcc per source, all at once) and, once the cache has nodes, upload
        the persistent node tensors of its current snapshot. There are no
        shape-keyed compiles to warm. Returns the number of kernel
        libraries loaded; on the CPU it does nothing and returns 0."""
        if self.device.type != "cuda":
            return 0
        from .ops import build
        torch.empty(1, device=self.device)
        build.build_all(build.KERNELS)
        for name in build.KERNELS:
            build.load(name)
        if self.cache.nodes:
            self._prewarm_tensors()
        return len(build.KERNELS)

    def _prewarm_tensors(self) -> None:
        from .cache.snapshot import discover_resource_names
        snap = self.cache.snapshot()
        tasks = [t for j in snap.jobs.values() for t in j.tasks.values()]
        rnames = discover_resource_names(list(snap.nodes.values()), tasks)
        tc = self.cache.tensor_refresh(snap.nodes, rnames, self.device,
                                       snap.snap_epoch)
        if tc is not None:
            tc._ensure_device()

    def start(self) -> threading.Thread:
        thread = threading.Thread(target=self.run, daemon=True,
                                  name="vc-scheduler")
        thread.start()
        return thread

    def stop(self) -> None:
        self._stop.set()
