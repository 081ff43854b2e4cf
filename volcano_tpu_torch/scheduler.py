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
conf loads (construction and hot-reload).

``solve_deadline_s`` is a hard deadline on the allocate action: a span
longer than it is contained like a device fault — the device cool-down
opens (``device_health``) and allocate runs the sequential placer until
the window's probe.

The pipelined cycle (``pipelined=True`` or VOLCANO_TPU_PIPELINED=1)
overlaps cycle N+1's allocate solve with cycle N's host commit: after a
cycle closes, a speculative session opens on the cache's staged snapshot
and the solve is dispatched (on the card, on a side CUDA stream); at the
next cycle's start a conflict check on what mutated since decides whether
the speculative session becomes the cycle's session (hit), its solve
replays onto a fresh session (partial), or it is discarded and the cycle
solves serially (conflict). Decisions equal the serial cycle's. Fast admit
(``fast_admit=True`` or VOLCANO_TPU_FAST_ADMIT=1) binds gangs that
trivially fit one node between cycles.

HA: ``attach_elector`` puts the shell under a lease. Each cycle first
runs one election step; a follower opens no session, takes no snapshot and
retries no side effect. A fresh acquisition settles the journal's crash
window (``startup_reconcile``) before its first cycle, and a leader that
loses the lease mid-cycle stops at the next action boundary and abandons
the open session (no plugin close, no status flush). Every journaled
intent carries the elector's fencing epoch, which the fenced executors
check. ``run_with_leader_election`` is the threaded form. The pipelined
cycle stays standalone-only: with an elector the shell runs serial
cycles.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from . import actions as _actions  # noqa: F401  (registers the actions)
from . import metrics
from . import plugins as _plugins  # noqa: F401  (registers the plugins)
from .framework import (abandon_session, close_session, get_action,
                        get_plugin_builder, open_session,
                        parse_scheduler_conf, resolve_device)
from .framework.conf import SchedulerConfiguration
from .obs import audit as obs_audit
from .obs import lifecycle as obs_lifecycle
from .obs import trace as obs_trace

log = logging.getLogger(__name__)

# the actions whose slot a committed speculation fills
_ALLOCATE_ACTIONS = ("allocate", "allocate-tpu")

# the HA role state machine. STANDALONE is the no-elector mode; with an
# elector attached the shell moves follower -> leader, demotes to FENCED on
# a mid-cycle lease loss (the open session is abandoned, never half
# applied), and a fenced replica re-enters as a follower subject to the
# elector's flap cool-down.
ROLE_STANDALONE = "standalone"
ROLE_FOLLOWER = "follower"
ROLE_CANDIDATE = "candidate"
ROLE_LEADER = "leader"
ROLE_FENCED = "fenced"


class _Speculation:
    """One in-flight speculation: the speculative session (a staged
    snapshot, its own GC window, a pinned tensor epoch) and the dispatched
    solve. In memory only: nothing is journaled before the commit, so a
    crash between dispatch and commit loses this object and nothing
    else."""

    __slots__ = ("ssn", "pending")

    def __init__(self, ssn, pending):
        self.ssn = ssn
        self.pending = pending


class _SpecCommitPlan:
    """A conflict-check verdict that lets the speculation commit, carried
    into the cycle's allocate slot. ``promoted``: the speculative session
    became the cycle's session (a hit). ``avoid_nodes``: nodes that only
    shed tasks since the stage, admitted on the promise that the solve
    placed nothing there, checked once the solution is fetched."""

    __slots__ = ("pending", "outcome", "spec_ssn", "promoted", "avoid_nodes")

    def __init__(self, spec: _Speculation, outcome: str, promoted: bool,
                 avoid_nodes=frozenset()):
        self.pending = spec.pending
        self.outcome = outcome
        self.spec_ssn = spec.ssn
        self.promoted = promoted
        self.avoid_nodes = frozenset(avoid_nodes)


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
        # hard deadline on the allocate action's span: slower is treated
        # as a device fault (the cool-down opens). None disables it
        self.solve_deadline_s = solve_deadline_s
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
        # elastic-gang lifecycle verbs: a CommandFunnel when command-driven
        # suspend/resume/scale is on, drained once a cycle after the resync
        # pass and before the snapshot, so a verb's annotation rewrite is
        # whole or absent in every cycle
        self.command_funnel = None
        # federation: a PartitionMember when this shell runs one partition
        # of a federated control plane, driven at the cycle boundaries
        # (on_cycle_start before the snapshot, so incoming reserves are
        # granted against pre-cycle state; on_cycle_end in the epilogue)
        # and only while this replica leads its partition (the hooks sit
        # behind the HA gate)
        self.federation = None
        # HA: no elector is the standalone mode; attach_elector puts the
        # shell into the role state machine (and serial cycles: a
        # speculation never crosses a leadership boundary)
        self.elector = None
        self.role = ROLE_STANDALONE
        self._was_leading = False
        self.last_handoff_report = None
        # sim hook: a restart harness points this at the cluster-truth
        # oracle of the previous leader's crash window, consumed by the
        # handoff reconcile when this replica becomes leader
        self.reconcile_oracle_fn: Optional[Callable] = None
        # sim hook at the close boundary: called with the open session
        # right before close_session, so a seeded SimKill can land inside
        # the close (binds executed, writebacks not)
        self.close_fault_hook: Optional[Callable] = None
        # decision-audit records of fast-admit binds made between cycles,
        # harvested with the next cycle's session
        self._fast_admit_audit: list = []
        # the pipelined cycle: standalone only (with an elector or a
        # federation member the shell runs serial cycles: a speculation
        # cannot carry across a leadership or partition boundary)
        self.pipelined = _env_flag("VOLCANO_TPU_PIPELINED") \
            if pipelined is None else bool(pipelined)
        self._spec: Optional[_Speculation] = None
        # sim hook: called with the in-flight speculation right after its
        # dispatch, so a seeded SimKill lands between dispatch and commit
        self.spec_fault_hook: Optional[Callable] = None
        # the last commit boundary's verdict: {"outcome": hit | partial |
        # conflict, "promoted": bool}
        self.last_speculation: dict = {}
        # did the last cycle's allocate fixed point converge at the empty
        # admitted set? The warm-start witness of the next dispatch, kept
        # here because a commit's suffix run overwrites LAST_STATS
        self._warmstart_empty = False
        # event-driven fast admit: gangs that trivially fit one node bind
        # between cycles through the journaled bind funnel
        self.fast_admit_enabled = _env_flag("VOLCANO_TPU_FAST_ADMIT") \
            if fast_admit is None else bool(fast_admit)
        if self.fast_admit_enabled:
            self.cache.fast_admit_feed = True
        self._load_conf(conf_text)

    @property
    def actions(self) -> list:
        """The action objects of the conf's pipeline, in order."""
        return [get_action(name) for name in self.conf.actions]

    # -- the HA role state machine ------------------------------------------

    def attach_elector(self, elector) -> None:
        """Enter HA mode: this replica schedules only while ``elector``
        holds the lease. Every journaled side effect is stamped with the
        elector's fencing epoch (the cache funnels read it through
        ``fencing_epoch_fn``), so a deposed incarnation's writes are
        rejectable at the executor gate."""
        self.elector = elector
        self.role = ROLE_FOLLOWER
        # the shell's leadership edge: the become-leader branch of the
        # gate (handoff reconcile, failover metric) fires on the FIRST
        # gated cycle of every leadership, whether the threaded
        # elector.run() or the cycle-driven step() flipped
        # elector.leading first
        self._was_leading = False
        if hasattr(self.cache, "fencing_epoch_fn"):
            self.cache.fencing_epoch_fn = self.current_fencing_epoch
        metrics.set_leader(False, self.role, 0)

    def current_fencing_epoch(self) -> int:
        return self.elector.fencing_epoch if self.elector is not None else 0

    def _ha_gate(self, rec) -> bool:
        """The per-cycle leadership gate: one election/renew step. Returns
        True when this replica may run the cycle (it leads). On a fresh
        acquisition the handoff runs startup_reconcile BEFORE the first
        cycle: the journal's crash window (a dead predecessor's unsettled
        intent) is settled against cluster truth, which bounds failover to
        lease-acquire -> reconcile -> resume."""
        elector = self.elector
        led_before = self._was_leading
        with rec.span("elect", role=self.role):
            leading = elector.step()
        if not leading:
            self._was_leading = False
            # a fenced ex-leader re-enters as an ordinary follower: FENCED
            # describes only the rest of the cycle the lease was lost in
            self.role = ROLE_FOLLOWER
            metrics.set_leader(False, self.role, elector.fencing_epoch)
            if self.federation is not None:
                # the leader-gated cycle hooks never run here, so the
                # partition's follower state is published from the gate
                self.federation.publish_follower()
            return False
        if not led_before:
            # epoch 1 is the first leadership ever; any later acquisition
            # (a takeover, or re-claiming after a loss) is a failover
            takeover = elector.fencing_epoch > 1
            with rec.span("handoff", epoch=elector.fencing_epoch,
                          takeover=takeover):
                oracle = None
                if self.reconcile_oracle_fn is not None:
                    oracle = self.reconcile_oracle_fn()
                try:
                    if oracle is not None:
                        self.last_handoff_report = \
                            self.startup_reconcile(*oracle)
                    else:
                        self.last_handoff_report = self.startup_reconcile()
                except Exception:
                    log.exception("handoff journal reconciliation failed; "
                                  "continuing (side effects may retry)")
            if takeover:
                metrics.register_failover()
            log.warning("replica %s became leader (epoch %d)",
                        elector.identity, elector.fencing_epoch)
        self.role = ROLE_LEADER
        self._was_leading = True
        metrics.set_leader(True, self.role, elector.fencing_epoch)
        return True

    def _demoted_mid_cycle(self) -> bool:
        """True when HA mode is on and leadership was lost since the
        cycle's gate passed (the renew watchdog or a revocation flipped
        ``elector.leading``). The action loop checks it between actions;
        a demoted leader abandons the open session rather than half
        applying it."""
        if self.elector is None or self.elector.leading:
            return False
        self.role = ROLE_FENCED
        self._was_leading = False
        metrics.set_leader(False, self.role, self.elector.fencing_epoch)
        return True

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
        schedule → open_session / action:* / close_session → audit /
        epilogue) and the per-action and end-to-end metrics are fed from
        the spans."""
        rec = obs_trace.TRACE
        cycle = self._cycles_run
        # pin the ambient correlation context (obs/lifecycle.py) every
        # funnel-level stamp of this cycle inherits; a federated member
        # also claims its own lane (pid) in the merged Chrome trace
        part = self.federation.pid if self.federation is not None \
            else getattr(self.cache, "obs_part", 0)
        if hasattr(self.cache, "obs_part"):
            self.cache.obs_part = part
        obs_lifecycle.TIMELINE.set_context(
            cycle=cycle, part=part, epoch=self.current_fencing_epoch(),
            t=self.clock.time())
        if self.federation is not None:
            rec.set_pid(part + 1)
        began = rec.enabled
        if began:
            rec.begin_cycle(cycle)
        try:
            with rec.span("cycle", cycle=cycle):
                # the HA gate: a replica without the lease runs its
                # election step and nothing else (no resync retries, no
                # snapshot, no session)
                if self.elector is not None and not self._ha_gate(rec):
                    return []
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
        # the federated cycle boundary: expire timed-out reserves, settle
        # drained queue moves, review incoming reserve requests, before the
        # snapshot, so grants (evictions, node transfers) shape the state
        # this cycle schedules against. Isolated like an action; a SimKill
        # inside a drain eviction tunnels through (it is not an Exception),
        # as through the funnels it rides
        if self.federation is not None:
            try:
                with rec.span("federation"):
                    self.federation.on_cycle_start()
            except Exception as exc:
                log.exception("federation cycle-start hook failed")
                metrics.register_action_failure("federation")
                errors.append(("federation", exc))
        if self.command_funnel is not None:
            try:
                with rec.span("commands"):
                    self.command_funnel.consume()
            except Exception as exc:
                log.exception("command funnel consume failed")
                metrics.register_action_failure("commands")
                errors.append(("commands", exc))
        runnable = [(name, get_action(name)) for name in self.conf.actions]
        if not runnable:
            self._discard_speculation("conflict")
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
        # the pipelined commit boundary, before anything opens: a clean
        # delta promotes the speculative session (no open at all), a
        # tolerable one opens a fresh session the speculative solve replays
        # onto, anything else discards the speculation and the cycle
        # solves serially
        pipelined = (self.pipelined and self.elector is None
                     and self.federation is None)
        ssn = None
        commit = None
        if self._spec is not None:
            spec, self._spec = self._spec, None
            if pipelined and any(n in _ALLOCATE_ACTIONS
                                 for n, _ in runnable):
                with rec.span("conflict_check"):
                    ssn, commit = self._check_speculation(rec, spec)
            else:
                self._abandon_speculation(spec, "conflict")
        times: Dict[str, float] = {}
        sched_sp = rec.span("schedule")
        crashed = False
        demoted = False
        with sched_sp:
            if ssn is None:
                with rec.span("open_session") as sp:
                    ssn = open_session(self.cache, self.conf.tiers,
                                       self.conf.configurations,
                                       time_fn=self.clock.now,
                                       device=self.device)
                times["open_session"] = sp.dur_s
            if self._fast_admit_audit and obs_audit.AUDIT.enabled:
                # fast-admit binds since the last cycle ride this cycle's
                # audit harvest (their jobs read "admitted" with the bind
                # count they earned between cycles)
                ssn.audit_events.extend(self._fast_admit_audit)
                self._fast_admit_audit.clear()
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
                    if self._demoted_mid_cycle():
                        # the lease was lost while the cycle ran: stop
                        # scheduling now. Side effects already executed
                        # carried a then-valid epoch; anything issued from
                        # here is a deposed leader's write, and the open
                        # session must not be half applied, so the close
                        # writebacks are skipped below
                        demoted = True
                        log.warning("lease lost mid-cycle; demoting to "
                                    "fenced and abandoning the open "
                                    "session")
                        break
                    action_sp = rec.span("action:" + name, action=name)
                    poisoned = False
                    try:
                        with action_sp:
                            try:
                                if self.action_fault_hook is not None:
                                    self.action_fault_hook(name, ssn)
                                if commit is not None \
                                        and name in _ALLOCATE_ACTIONS:
                                    plan, commit = commit, None
                                    self._commit_speculation(ssn, plan,
                                                             action)
                                elif pipelined \
                                        and name in _ALLOCATE_ACTIONS:
                                    action.execute(ssn)
                                    self._warmstart_empty = \
                                        self._allocate_kept_empty()
                                else:
                                    action.execute(ssn)
                            except Exception as exc:
                                log.exception("action %s failed; skipping "
                                              "it this cycle", name)
                                metrics.register_action_failure(name)
                                errors.append((name, exc))
                                poisoned = getattr(exc, "poisons_session",
                                                   False)
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
                    if self.solve_deadline_s is not None \
                            and name in _ALLOCATE_ACTIONS \
                            and action_sp.dur_s > self.solve_deadline_s:
                        # a solve past the hard deadline is contained like
                        # a device fault: the cool-down opens and allocate
                        # runs the sequential placer until the window's
                        # probe
                        from .device_health import DEVICE_HEALTH
                        DEVICE_HEALTH.record_fault("slow_solve")
                        log.error(
                            "device solve took %.3fs (hard deadline "
                            "%.3fs); opening the device cool-down: "
                            "allocate degrades to the sequential placer",
                            action_sp.dur_s, self.solve_deadline_s)
                    if poisoned:
                        # the action mutated session state outside any
                        # undo log (allocate.ReplayFault): later actions
                        # would schedule against phantom aggregates
                        log.error("action %s poisoned the session; "
                                  "aborting the remaining actions this "
                                  "cycle", name)
                        break
                if commit is not None:
                    # the allocate slot never ran (a budget deferral or a
                    # poisoned earlier action): the speculation cannot
                    # carry over
                    plan, commit = commit, None
                    self._finish_speculation(plan, "conflict")
                if budget is not None:
                    self.max_cycle_spend_s = max(self.max_cycle_spend_s,
                                                 budget.spent())
                if not demoted and self._demoted_mid_cycle():
                    demoted = True       # lost during the last action
            except BaseException as exc:
                # a non-Exception escaping here is a (simulated or real)
                # process death: a killed process runs no close-time
                # writebacks, so neither may we
                crashed = not isinstance(exc, Exception)
                raise
            finally:
                if crashed or demoted:
                    # a demoted leader's session rolls back: the GC window
                    # resumes, but neither the plugins' close nor the
                    # podgroup status flush runs (a fenced ex-leader may
                    # not publish decision state it no longer owns)
                    abandon_session(ssn)
                else:
                    with rec.span("close_session") as sp:
                        if self.close_fault_hook is not None:
                            try:
                                self.close_fault_hook(ssn)
                            except BaseException:
                                # a process death inside the close: no
                                # writeback runs
                                abandon_session(ssn)
                                raise
                        close_session(ssn)
                    times["close_session"] = sp.dur_s
        metrics.update_e2e_duration(sched_sp.dur_s)
        times["cycle"] = sched_sp.dur_s
        self.last_cycle_s = times
        # decision audit: harvested after close_session, so the gang
        # plugin's job_fit_errors writeback is the denial reason, outside
        # the timed window; a recorder fault is logged, never the cycle's
        if not demoted and obs_audit.AUDIT.enabled:
            try:
                with rec.span("audit"):
                    obs_audit.harvest_cycle(ssn, cycle, self.clock.time())
            except Exception:
                log.exception("decision-audit harvest failed")
        # stage 2 of the pipeline, outside the timed window: dispatch the
        # next cycle's speculative solve, which the card runs while the
        # host goes on with the epilogue and the pacing sleep
        if pipelined and not demoted:
            self._dispatch_speculation(rec, runnable)
        self._cycle_epilogue()
        return errors

    def _cycle_epilogue(self) -> None:
        """Off-cycle bookkeeping, run on both run_once exits: flush the
        journal's buffered ack tail, keep a store-wired cache's watch
        streams up, run the in-flight ack watchdog and tick the
        drift-verify cadence."""
        with obs_trace.TRACE.span("epilogue"):
            journal = getattr(self.cache, "journal", None)
            if journal is not None:
                try:
                    journal.flush()
                except Exception:
                    log.exception("journal flush failed")
            # store-wired caches: resume torn watch streams, tick
            # bookmarks, reset the retry funnel's per-cycle budget
            # (cache/watches.WatchManager); isolated, the next epilogue
            # retries
            manager = getattr(self.cache, "watch_manager", None)
            if manager is not None:
                try:
                    with obs_trace.TRACE.span("watch_upkeep"):
                        manager.step()
                except Exception:
                    log.exception("watch-stream upkeep failed")
            if hasattr(self.cache, "process_expired_inflight"):
                try:
                    with obs_trace.TRACE.span("inflight_watchdog"):
                        self.cache.process_expired_inflight()
                except Exception:
                    log.exception("in-flight ack watchdog failed")
            if self.federation is not None:
                try:
                    self.federation.on_cycle_end()
                except Exception:
                    log.exception("federation cycle-end hook failed")
                    metrics.register_action_failure("federation")
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

    # -- the pipelined cycle -------------------------------------------------

    def _check_speculation(self, rec, spec: _Speculation):
        """The commit boundary's conflict check: what mutated since the
        speculative snapshot was staged, against what the speculation
        assumed. Returns ``(session or None, plan or None)``:

        - nothing mutated: the staged snapshot is adopted and the
          speculative session is the cycle's session (hit);
        - only decision-neutral changes (bind acks; jobs new since the
          stage, which the suffix solve covers; jobs gone; nodes that only
          shed tasks, on the promise checked at the commit): a fresh
          session opens and the speculative solve replays onto it by uid
          (partial);
        - anything else: the speculation is discarded (conflict) and the
          cycle solves serially.
        """
        delta = self.cache.speculation_delta(spec.ssn.spec_basis)
        clean = not (delta["epoch_moved"] or delta["nodes"]
                     or delta["jobs"] or delta["queues"])
        if clean and self.cache.adopt_speculative_snapshot(
                spec.ssn.spec_basis):
            ssn = spec.ssn
            ssn.speculative = False
            return ssn, _SpecCommitPlan(spec, "hit", promoted=True)
        if clean or delta["epoch_moved"] or delta["queues"]:
            # an epoch or queue move is never tolerable (ordering and
            # overuse inputs)
            self._abandon_speculation(spec, "conflict")
            return None, None
        with rec.span("open_session"):
            ssn = open_session(self.cache, self.conf.tiers,
                               self.conf.configurations,
                               time_fn=self.clock.now, device=self.device)
        avoid = self._delta_tolerable(spec, ssn, delta)
        if avoid is None:
            self._abandon_speculation(spec, "conflict")
            return ssn, None
        plan = _SpecCommitPlan(spec, "partial", promoted=False,
                               avoid_nodes=avoid)
        # the solution lives on in the plan; the speculative session (GC
        # window, pinned epoch) ends now, nothing journaled
        abandon_session(spec.ssn)
        return ssn, plan

    def _delta_tolerable(self, spec: _Speculation, ssn, delta):
        """May the speculative solve commit onto ``ssn`` despite the delta?
        Returns the nodes that only shed tasks, which the commit must find
        the solution avoided (possibly none), or None when the delta is
        intolerable: a changed node or known job whose solve inputs differ,
        a node that appeared or left."""
        sspec = spec.ssn
        avoid = set()
        for name in delta["nodes"]:
            a = sspec.nodes.get(name)
            b = ssn.nodes.get(name)
            if a is None and b is None:
                continue
            if a is None or b is None:
                return None
            if self._node_decision_equal(a, b):
                continue
            if self._node_completion_shrunk(a, b):
                avoid.add(name)
                continue
            return None
        for uid in delta["jobs"]:
            a = sspec.jobs.get(uid)
            if a is None:
                continue                # new: the suffix solve covers it
            b = ssn.jobs.get(uid)
            if b is None:
                continue                # gone: the remap refuses it
            if not self._job_decision_equal(a, b):
                return None
        return avoid

    @staticmethod
    def _node_decision_equal(a, b) -> bool:
        """Do two snapshot clones of one node give the solve the same
        inputs (accounting, capacity, schedulability, task population)?
        Task statuses are not compared: that is what makes bind acks
        tolerable."""
        if (a.allocatable is not b.allocatable
                or a.unschedulable != b.unschedulable
                or a.ready != b.ready
                or a.max_task_num != b.max_task_num
                or len(a.tasks) != len(b.tasks)
                or set(a.tasks) != set(b.tasks)
                or a.used_ports != b.used_ports):
            return False
        for f in ("idle", "used", "releasing", "pipelined"):
            if getattr(a, f) != getattr(b, f):
                return False
        return True

    @staticmethod
    def _solution_touches(mapped, avoid_nodes) -> bool:
        """Did the (remapped) speculative solution place a task on one of
        ``avoid_nodes``?"""
        from .ops.place import NO_NODE
        tn = np.asarray(mapped.task_node)
        placed = {mapped.node_t.names[int(n)]
                  for n in np.unique(tn[tn != NO_NODE])}
        return bool(placed & set(avoid_nodes))

    @staticmethod
    def _node_completion_shrunk(a, b) -> bool:
        """Did node ``b`` (fresh) differ from ``a`` (speculative) only by
        tasks leaving: identity and capacity unchanged, the fresh task set
        a strict subset, every surviving task unchanged?"""
        if (a.allocatable is not b.allocatable
                or a.unschedulable != b.unschedulable
                or a.ready != b.ready
                or a.max_task_num != b.max_task_num):
            return False
        if not set(b.tasks) < set(a.tasks):
            return False
        return all(b.tasks[u].status == a.tasks[u].status
                   and b.tasks[u].node_name == a.tasks[u].node_name
                   for u in b.tasks)

    @staticmethod
    def _job_decision_equal(a, b) -> bool:
        from .api import TaskStatus
        if (a.queue != b.queue or a.priority != b.priority
                or a.min_available != b.min_available
                or a.podgroup is None or b.podgroup is None
                or a.podgroup.phase != b.podgroup.phase
                or a.ready_task_num() != b.ready_task_num()
                or a.waiting_task_num() != b.waiting_task_num()):
            return False
        return set(a.task_status_index.get(TaskStatus.PENDING, {})) \
            == set(b.task_status_index.get(TaskStatus.PENDING, {}))

    def _commit_speculation(self, ssn, plan: _SpecCommitPlan,
                            action) -> None:
        """The allocate slot of a cycle whose conflict check passed: fetch
        the speculative solve, re-anchor it onto ``ssn`` by uid, continue
        the serial fixed point from it (gang rollbacks re-solve as the
        serial cycle would), then solve the jobs the speculation could not
        know (the suffix). Every placement replays through the serial
        cycle's funnels. A fetched solution that is unusable, broke the
        avoid promise or left the warm start's premise costs only the
        speculation: the slot runs the configured action, serially, on the
        same device."""
        from .actions import allocate as alloc
        alloc.LAST_FALLBACK.clear()
        mapped = ordered = None
        try:
            sol = alloc.finalize_speculative_dispatch(plan.pending)
            mapped, ordered = alloc.remap_speculative_solution(
                sol, plan.pending.ordered_jobs, ssn)
        except Exception:
            log.exception("speculative solve unusable; re-solving the "
                          "cycle serially")
        if mapped is not None and plan.avoid_nodes \
                and self._solution_touches(mapped, plan.avoid_nodes):
            mapped = None
        hint = plan.pending.assumed_hint
        if mapped is not None and hint is not None:
            kept = {mapped.jobs_list[jx].uid
                    for jx in range(len(mapped.jobs_list))
                    if mapped.job_kept[jx]}
            if kept != hint:
                mapped = None
        if mapped is None:
            self._finish_speculation(plan, "conflict")
            action.execute(ssn)
            self._warmstart_empty = self._allocate_kept_empty()
            return
        with obs_trace.span("speculate_commit", outcome=plan.outcome):
            alloc.LAST_STATS.pop("tensor_s", None)
            alloc.LAST_STATS.pop("tensor_incremental", None)
            stats = alloc._execute_fused(ssn, first_solution=mapped,
                                         first_ordered=ordered,
                                         first_assumed=hint)
            # the warm-start witness is the MAIN fixed point's verdict
            main_empty = bool(alloc.LAST_STATS.get("final_kept_empty"))
            suffix = ({j.uid for j in alloc._eligible_jobs(ssn)}
                      - plan.pending.eligible_uids)
            if suffix:
                alloc._execute_fused(ssn, only_jobs=suffix)
                main_empty = main_empty and bool(
                    alloc.LAST_STATS.get("final_kept_empty"))
            self._warmstart_empty = main_empty
            action.last_stats = stats
        self._finish_speculation(plan, plan.outcome)

    def _finish_speculation(self, plan: _SpecCommitPlan,
                            outcome: str) -> None:
        from .framework.framework import _retire_session_pin
        _retire_session_pin(plan.spec_ssn)
        metrics.register_speculation(outcome)
        self.last_speculation = {"outcome": outcome,
                                 "promoted": plan.promoted}

    def _abandon_speculation(self, spec: _Speculation,
                             outcome: str) -> None:
        basis = spec.ssn.spec_basis
        abandon_session(spec.ssn)       # retires the pinned epoch too
        if basis is not None:
            # give the moved dirty keys back (a no-op if a real snapshot
            # already reabsorbed them)
            self.cache.discard_speculative_snapshot(basis)
        metrics.register_speculation(outcome)
        self.last_speculation = {"outcome": outcome, "promoted": False}

    def drop_speculation(self) -> None:
        """Release the in-flight speculation with no verdict, as a process
        death does: its session's GC window and pinned epoch go; its
        staged dirt waits for the next real snapshot."""
        if self._spec is not None:
            spec, self._spec = self._spec, None
            abandon_session(spec.ssn)

    def _discard_speculation(self, outcome: str) -> None:
        if self._spec is not None:
            spec, self._spec = self._spec, None
            self._abandon_speculation(spec, outcome)

    @staticmethod
    def _allocate_kept_empty() -> bool:
        from .actions.allocate import LAST_STATS
        return bool(LAST_STATS.get("final_kept_empty"))

    def _allocate_engine(self, runnable) -> Optional[str]:
        """The engine the allocate slot will run, when the dispatch/fetch
        split serves it (the placement kernel's engines), else None."""
        from .actions.allocate import SPECULATIVE_ENGINES
        for name, action in runnable:
            if name not in _ALLOCATE_ACTIONS:
                continue
            engine, _ = action.configured_engine(self.conf.configurations)
            return engine if engine in SPECULATIVE_ENGINES else None
        return None

    def _dispatch_speculation(self, rec, runnable) -> None:
        """Stage 2 of the pipeline: open a speculative session on the
        post-commit state and dispatch the next cycle's solve. Nothing here
        touches the journal or the executors, so a crash between this and
        the next commit loses only the speculation. A failed dispatch costs
        only the speculation: the next cycle solves serially."""
        engine = self._allocate_engine(runnable)
        if engine is None:
            return
        with rec.span("speculate", engine=engine):
            sssn = None
            try:
                sssn = open_session(self.cache, self.conf.tiers,
                                    self.conf.configurations,
                                    time_fn=self.clock.now,
                                    device=self.device, speculative=True)
                from .actions.allocate import dispatch_speculative_solve
                # warm start at the ∅ fixed point iff this cycle's fixed
                # point converged there (a saturated backlog)
                hint = set() if self._warmstart_empty else None
                pending = dispatch_speculative_solve(sssn, engine,
                                                     assumed_hint=hint)
                if pending is None:
                    # the staged basis stays until the next real snapshot
                    # reabsorbs it, as in the JAX package
                    abandon_session(sssn)
                    return
                self._spec = _Speculation(sssn, pending)
            except Exception:
                log.exception("speculative dispatch failed; the next "
                              "cycle runs serially")
                if sssn is not None:
                    abandon_session(sssn)
                self._spec = None
                return
            except BaseException:
                # a process death in the dispatch: only the speculation is
                # lost; its GC window ends with it
                if sssn is not None:
                    abandon_session(sssn)
                self._spec = None
                raise
            if self.spec_fault_hook is not None:
                try:
                    self.spec_fault_hook(self._spec)
                except BaseException:
                    # the process dies between dispatch and commit: the
                    # speculation dies with it, its GC window too
                    spec, self._spec = self._spec, None
                    abandon_session(spec.ssn)
                    raise

    # -- event-driven fast admit ---------------------------------------------

    def fast_admit(self, max_gangs: int = 64) -> int:
        """Bind gangs that trivially fit between full cycles, so time to
        first bind drops below one period. Trivial: the whole gang fits
        one node's idle and future idle (pipelined reservations kept), no
        placement constraint, and for a PENDING podgroup the unconditional
        enqueue path (``min_resources`` None, EnqueueAction's gate). Binds
        go through the journaled ``bind_batch`` funnel; anything not
        provably trivial waits for the cycle. At most ``max_gangs`` gangs a
        call. Returns the tasks bound. A bind dirties the cache, so an
        in-flight speculation over the earlier state conflicts at its
        commit."""
        if not self.fast_admit_enabled:
            return 0
        if self.elector is not None and not self.elector.leading:
            return 0
        cache = self.cache
        if self.federation is not None:
            # a partition's ownership is enforced at session scope
            # (cache.snapshot_scope), and this path reads the whole-cluster
            # indexes directly: binding here could claim another
            # partition's job. Drain the feed so it cannot grow unconsumed
            cache.drain_new_jobs()
            return 0
        uids = cache.drain_new_jobs()
        if not uids:
            return 0
        from .api import PodGroupPhase
        gangs = tasks_bound = 0
        with obs_trace.span("fast_admit", jobs=len(uids)):
            for uid in uids:
                if gangs >= max_gangs:
                    break
                job = cache.jobs.get(uid)
                fit = self._trivial_fit(job)
                if fit is None:
                    continue
                node, gang = fit
                if job.podgroup.phase == PodGroupPhase.PENDING:
                    job.podgroup.phase = PodGroupPhase.INQUEUE
                    cache.mark_job_dirty(uid)
                    cache.update_job_status(job)
                # the funnel convention: the argument task carries the
                # placement and the cached task stays unplaced, which
                # routes bind_batch onto its fresh-placement path
                placed = []
                for task in gang:
                    ti = task.clone()
                    ti.node_name = node.name
                    placed.append(ti)
                cache.bind_batch(placed)
                gangs += 1
                tasks_bound += len(gang)
                if obs_audit.AUDIT.enabled:
                    for task in gang:
                        self._fast_admit_audit.append(
                            ("bind", task.uid, task.job, "fast-admit"))
        if gangs:
            metrics.register_fast_admit(gangs, tasks_bound)
        return tasks_bound

    def _trivial_fit(self, job):
        """(node, gang tasks) when the whole gang provably fits one node
        under the placer's resource rule with no interaction, else None:
        the first fitting node in cache order."""
        from .api import PodGroupPhase, Resource, TaskStatus
        cache = self.cache
        if job is None or job.podgroup is None:
            return None
        if job.podgroup.phase not in (PodGroupPhase.PENDING,
                                      PodGroupPhase.INQUEUE):
            return None
        if job.podgroup.phase == PodGroupPhase.PENDING \
                and job.podgroup.min_resources is not None:
            return None                 # enqueue's vote path
        if job.queue not in cache.queues:
            return None
        gang = [t for t in job.tasks.values()
                if t.status == TaskStatus.PENDING
                and not t.resreq.is_empty()]
        if not gang or len(gang) != len(job.tasks):
            return None                 # partly placed: the full cycle
        if not (0 < job.min_available <= len(gang)):
            return None
        total = Resource()
        for task in gang:
            # (this package's tasks carry no topology policy or revocable
            # zone, and its nodes no GPU devices or NUMA topology, which
            # the JAX package's gate also declines)
            if task.node_selector or task.affinity or task.tolerations:
                return None             # placement constraints
            total.add(task.init_resreq)
        inflight = set(cache.binding_tasks.values())
        for node in cache.nodes.values():
            if (not node.ready or node.unschedulable
                    or node.name in inflight):
                continue
            if any(t.get("effect") in ("NoSchedule", "NoExecute")
                   for t in node.taints):
                continue
            if node.max_task_num > 0 \
                    and len(node.tasks) + len(gang) > node.max_task_num:
                continue
            if total.less_equal(node.idle) \
                    and total.less_equal(node.future_idle()):
                return node, gang
        return None

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
            if self.fast_admit_enabled:
                # arrivals that came during the pacing sleep bind now
                try:
                    self.fast_admit()
                except Exception:
                    log.exception("fast-admit pass failed; the full cycle "
                                  "will pick the jobs up")
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
        shape-keyed compiles to warm: the placement kernel's library holds
        B1 and B6 (the zone-anchor mode a positive ``topology-weight``
        takes) alike. Pipelined, also ask the card its
        largest cluster once, make the side stream and pay the epoch pair's
        first pin. Returns the number of kernel libraries loaded; on the
        CPU it does nothing and returns 0."""
        if self.device.type != "cuda":
            return 0
        from .ops import build
        torch.empty(1, device=self.device)
        build.build_all(build.KERNELS)
        for name in build.KERNELS:
            build.load(name)
        if self.pipelined:
            from .actions.allocate import speculation_stream
            from .ops.place import max_cluster
            with torch.cuda.device(self.device):
                max_cluster()
            speculation_stream(self.device)
        if self.cache.nodes:
            self._prewarm_tensors()
            tc = self.cache.tensor_cache
            if self.pipelined and tc is not None:
                tc.prewarm_epoch_pair()
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

    def run_with_leader_election(self, store, name: str = "vc-scheduler",
                                 **lease_kwargs) -> None:
        """The HA entry point (cmd/scheduler/app/server.go:111-141): block
        until this replica holds the lease in ``store``, then run the
        loop; losing the lease stops it. ``lease_kwargs`` go to the
        LeaderElector (identity, lease_duration, renew_deadline,
        retry_period, ...)."""
        from .leaderelection import LeaderElector
        self._elector = LeaderElector(
            store, name, on_started_leading=self.run,
            on_stopped_leading=self.stop, **lease_kwargs)
        self.attach_elector(self._elector)
        self._elector.run()

    def start(self) -> threading.Thread:
        thread = threading.Thread(target=self.run, daemon=True,
                                  name="vc-scheduler")
        thread.start()
        return thread

    def stop(self) -> None:
        self._stop.set()
