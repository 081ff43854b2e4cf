"""OpenSession/CloseSession (mirrors
pkg/scheduler/framework/framework.go:30-60)."""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from .conf import Configuration, Tier
from .job_updater import update_all
from .registry import get_plugin_builder
from .session import Session


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device a session solves on: the CUDA card by default. A caller
    that wants the CPU says so (``device="cpu"``, as the tests do); with no
    card and no such request this raises instead of quietly running on the
    CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to schedule on the CPU")
    return torch.device("cuda")


def open_session(cache, tiers: List[Tier],
                 configurations: List[Configuration] = (),
                 time_fn=None,
                 device: Optional[Union[str, torch.device]] = None) -> Session:
    ssn = Session(cache, tiers, list(configurations), resolve_device(device),
                  time_fn=time_fn)
    for tier in tiers:
        for opt in tier.plugins:
            plugin = get_plugin_builder(opt.name)(opt.arguments)
            ssn.plugins[plugin.name()] = plugin
            plugin.on_session_open(ssn)
    return ssn


def close_session(ssn: Session) -> None:
    for plugin in ssn.plugins.values():
        plugin.on_session_close(ssn)
    # writeback of job/podgroup status (job_updater.go:95-108)
    update_all(ssn)
