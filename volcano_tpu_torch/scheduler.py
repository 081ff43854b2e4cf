"""The scheduler shell: one cycle is snapshot → open_session → actions →
close_session (mirrors pkg/scheduler/scheduler.go:90-110).

Every action the conf names must be one this package has, and a failing
action fails the cycle: nothing is skipped.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Union

import torch

from . import actions as _actions  # noqa: F401  (registers the actions)
from . import plugins as _plugins  # noqa: F401  (registers the plugins)
from .framework import (abandon_session, close_session, get_action,
                        get_plugin_builder, open_session,
                        parse_scheduler_conf, resolve_device)


class Scheduler:
    def __init__(self, cache, conf_text: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.cache = cache
        self.device = resolve_device(device)
        self.conf = parse_scheduler_conf(conf_text)
        # refuse a conf naming an action or plugin this package lacks now,
        # not in the middle of a cycle
        self.actions = [get_action(name) for name in self.conf.actions]
        for tier in self.conf.tiers:
            for opt in tier.plugins:
                get_plugin_builder(opt.name)
        self.last_cycle_s: Dict[str, float] = {}

    def run_once(self) -> None:
        """One scheduling cycle. ``last_cycle_s`` keeps its phases' host
        wall times in seconds ("open_session", each action by name,
        "close_session", "cycle"); an action that uses the device reads its
        result back before it returns, so its time includes the device's."""
        t0 = time.perf_counter()
        times = {}
        ssn = open_session(self.cache, self.conf.tiers,
                           self.conf.configurations, device=self.device)
        t = time.perf_counter()
        times["open_session"] = t - t0
        try:
            for action in self.actions:
                action.execute(ssn)
                now = time.perf_counter()
                times[action.name()] = now - t
                t = now
        except BaseException:
            abandon_session(ssn)
            raise
        close_session(ssn)
        now = time.perf_counter()
        times["close_session"] = now - t
        times["cycle"] = now - t0
        self.last_cycle_s = times
