"""The admission service registry and dispatch, the JAX package's
``webhooks/router.py`` (Volcano's ``pkg/webhooks/router``): an
AdmissionService binds a path to a mutate or validate function for a set of
kinds and operations; the Router plays the HTTPS server's role, dispatching
the store's admission callbacks to the registered services in path order.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..store import AdmissionError


class AdmissionService:
    def __init__(self, path: str, kinds: List[str], operations: List[str],
                 func: Callable, mutating: bool = False):
        self.path = path
        self.kinds = set(kinds)
        self.operations = set(operations)
        self.func = func
        self.mutating = mutating


class Router:
    def __init__(self):
        self.services: List[AdmissionService] = []

    def register(self, service: AdmissionService) -> None:
        self.services.append(service)
        self.services.sort(key=lambda s: (not s.mutating, s.path))

    def hook(self, operation: str, kind: str, obj, old):
        """ObjectStore admission hook: mutating services run first (matching
        the reference's webhook ordering), then validators; a validator
        raising AdmissionError denies the request."""
        for service in self.services:
            if kind not in service.kinds or operation not in service.operations:
                continue
            result = service.func(operation, obj, old)
            if service.mutating and result is not None:
                obj = result
        return obj


def deny(message: str) -> None:
    raise AdmissionError(message)
