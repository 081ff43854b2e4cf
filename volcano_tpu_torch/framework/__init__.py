"""Scheduler framework: Session, Statement, tiers, conf, registries."""

from .arguments import Arguments
from .conf import (Configuration, PluginOption, SchedulerConfiguration, Tier,
                   parse_scheduler_conf)
from .framework import close_session, open_session, resolve_device
from .registry import (get_action, get_plugin_builder, register_action,
                       register_plugin_builder)
from .session import (ABSTAIN, PERMIT, REJECT, Event, EventHandler, Session,
                      ValidateResult)
from .statement import Statement

__all__ = [
    "Arguments", "Configuration", "PluginOption", "SchedulerConfiguration",
    "Tier", "parse_scheduler_conf", "close_session", "open_session",
    "resolve_device", "get_action", "get_plugin_builder", "register_action",
    "register_plugin_builder", "ABSTAIN", "PERMIT", "REJECT", "Event",
    "EventHandler", "Session", "ValidateResult", "Statement",
]
