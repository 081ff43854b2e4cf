"""Scheduler framework: Session, Statement, tiers, conf, registries."""

from .arguments import Arguments
from .conf import (DEFAULT_SCHEDULER_CONF, Configuration, PluginOption,
                   SchedulerConfiguration, Tier, parse_scheduler_conf)
from .framework import (abandon_session, close_session, open_session,
                        resolve_device)
from .registry import (get_action, get_plugin_builder, register_action,
                       register_plugin_builder)
from .session import (ABSTAIN, PERMIT, REJECT, Event, EventHandler, Session,
                      ValidateResult)
from .statement import Statement

__all__ = [
    "Arguments", "DEFAULT_SCHEDULER_CONF", "Configuration", "PluginOption",
    "SchedulerConfiguration", "Tier", "parse_scheduler_conf",
    "abandon_session", "close_session", "open_session", "resolve_device",
    "get_action", "get_plugin_builder", "register_action",
    "register_plugin_builder", "ABSTAIN", "PERMIT", "REJECT", "Event",
    "EventHandler", "Session", "ValidateResult", "Statement",
]
