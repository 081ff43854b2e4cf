"""Scheduler configuration schema + YAML parsing.

Identical YAML schema to the reference so configs are a drop-in swap:
``actions`` comma string, ``tiers[].plugins[]`` with per-plugin enable flags
and arguments, per-action ``configurations`` blocks
(pkg/scheduler/conf/scheduler_conf.go:20-86, parsing
pkg/scheduler/util.go:44-92). A conf text drives this package and the JAX
package alike.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import yaml

from .arguments import Arguments

# The reference's default conf (pkg/scheduler/util.go:31-42): its allocate
# action runs the callbacks engine.
DEFAULT_SCHEDULER_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""

# The per-plugin enable flags: YAML tag (exactly as the reference's struct
# tags, scheduler_conf.go:45-81) -> internal flag name used by the session's
# tier dispatch. Missing flag means enabled.
ENABLE_FLAG_TAGS = {
    "enableJobOrder": "enabledJobOrder",
    "enableNamespaceOrder": "enabledNamespaceOrder",
    "enableHierarchy": "enabledHierarchy",
    "enableJobReady": "enabledJobReady",
    "enableJobPipelined": "enabledJobPipelined",
    "enableTaskOrder": "enabledTaskOrder",
    "enablePreemptable": "enabledPreemptable",
    "enableReclaimable": "enabledReclaimable",
    "enableQueueOrder": "enabledQueueOrder",
    "EnabledClusterOrder": "enabledClusterOrder",   # sic — reference tag
    "enablePredicate": "enabledPredicate",
    "enableBestNode": "enabledBestNode",
    "enableNodeOrder": "enabledNodeOrder",
    "enableTargetJob": "enabledTargetJob",
    "enableReservedNodes": "enabledReservedNodes",
    "enableJobEnqueued": "enabledJobEnqueued",
    "enabledVictim": "enabledVictim",               # sic — reference tag
    "enableJobStarving": "enabledJobStarving",
}
# internal names are also accepted as YAML keys for convenience
ENABLE_FLAG_TAGS.update({v: v for v in list(ENABLE_FLAG_TAGS.values())})


@dataclass
class PluginOption:
    name: str
    enabled: Dict[str, bool] = field(default_factory=dict)
    arguments: Arguments = field(default_factory=Arguments)

    def is_enabled(self, flag: str) -> bool:
        return self.enabled.get(flag, True)


@dataclass
class Tier:
    plugins: List[PluginOption] = field(default_factory=list)


@dataclass
class Configuration:
    """Per-action arguments block (conf/scheduler_conf.go Configurations)."""

    name: str
    arguments: Arguments = field(default_factory=Arguments)


@dataclass
class SchedulerConfiguration:
    actions: List[str] = field(default_factory=list)
    tiers: List[Tier] = field(default_factory=list)
    configurations: List[Configuration] = field(default_factory=list)


def parse_scheduler_conf(text: Optional[str] = None
                         ) -> SchedulerConfiguration:
    """Parse the scheduler YAML; None or an empty text gives the default
    conf (pkg/scheduler/util.go:31-42)."""
    raw = yaml.safe_load(text) if text else None
    if not raw:
        raw = yaml.safe_load(DEFAULT_SCHEDULER_CONF)

    actions = [a.strip() for a in str(raw.get("actions", "")).split(",") if a.strip()]

    tiers: List[Tier] = []
    for tier_raw in raw.get("tiers") or []:
        plugins = []
        for p in tier_raw.get("plugins") or []:
            enabled = {ENABLE_FLAG_TAGS[k]: bool(v) for k, v in p.items()
                       if k in ENABLE_FLAG_TAGS}
            args = Arguments(p.get("arguments") or {})
            plugins.append(PluginOption(name=p["name"], enabled=enabled,
                                        arguments=args))
        tiers.append(Tier(plugins=plugins))

    configurations = [
        Configuration(name=c["name"], arguments=Arguments(c.get("arguments") or {}))
        for c in raw.get("configurations") or []
    ]
    return SchedulerConfiguration(actions=actions, tiers=tiers,
                                  configurations=configurations)
