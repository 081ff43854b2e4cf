"""Admission over the wire (the JAX package's ``rpc/admission.py``): the
webhook router behind the sidecar's protocol, so writes that start outside
the scheduler process are defaulted and validated before they reach the
API server (cmd/webhook-manager/app/server.go:41-108).

The reference serves AdmissionReview over TLS HTTP; here an ``{"op":
"admit"}`` message arrives on the snapshot RPC's length-prefixed framing.
The Go shim's webhook front (shim/webhook.go) terminates the API server's
POSTs, turns the object into this schema and attaches the cluster state
the validators read (queues, podgroups), so the sidecar stays stateless a
request. shim/testdata/golden_admission.json pins both sides.

Request::

  {"v": 1, "op": "admit",
   "review": {"kind": "Job|Queue|PodGroup|Pod",
              "operation": "CREATE|UPDATE|DELETE",
              "object": {...}, "old": {...}|null,
              "context": {"queues": [...], "podgroups": [...]}}}

Response::

  {"v": 1, "allowed": true|false, "message": "...",
   "patched": {...}|null}        # the object, when a mutator changed it

Objects travel as JSON mirrors of the ``apis.objects`` dataclasses (enums
by value, Resource as the codec's RES); ``to_wire``/``from_wire`` follow
the dataclasses' type hints.
"""

from __future__ import annotations

import dataclasses
import enum
import re
import typing

from ..api.resource import Resource
from ..apis.objects import Job, Pod, PodGroupCR, QueueCR
from ..store import AdmissionError, ObjectStore
from ..webhooks.admission import register_webhooks
from .codec import VERSION, _res, _res_from

KINDS = {"Job": Job, "Queue": QueueCR, "PodGroup": PodGroupCR, "Pod": Pod}


def to_wire(obj):
    """dataclass / enum / Resource -> JSON-compatible structures."""
    if obj is None:
        return None
    if isinstance(obj, Resource):
        return _res(obj)
    if isinstance(obj, enum.Enum):
        return obj.value
    if dataclasses.is_dataclass(obj):
        return {f.name: to_wire(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: to_wire(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_wire(v) for v in obj]
    return obj


def _snake(name: str) -> str:
    return re.sub(r"(?<!^)([A-Z])", r"_\1", name).lower()


def _strip_optional(tp):
    if typing.get_origin(tp) is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def from_wire(tp, data):
    """A typed object from its wire form, by the dataclasses' type hints
    (the inverse of :func:`to_wire`)."""
    tp = _strip_optional(tp)
    if data is None:
        return None
    if tp is Resource:
        return _res_from(data)
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        return tp(data)
    if dataclasses.is_dataclass(tp):
        if not isinstance(data, dict):
            raise TypeError(f"{tp.__name__} expects an object, "
                            f"got {type(data).__name__}")
        hints = typing.get_type_hints(tp)
        names = {f.name for f in dataclasses.fields(tp)}
        kwargs = {}
        for key, value in data.items():
            # k8s camelCase aliases decode (a webhook front forwards
            # AdmissionReview objects as they are); any other key is a
            # malformed review and fails closed: dropping it would admit
            # an object with a defaulted field
            name = key if key in names else _snake(key)
            if name not in names:
                raise TypeError(f"{tp.__name__}: unknown field {key!r}")
            kwargs[name] = from_wire(hints[name], value)
        return tp(**kwargs)
    origin = typing.get_origin(tp)
    if origin in (list, tuple):
        if not isinstance(data, list):
            raise TypeError(f"expected a list, got {type(data).__name__}")
        (item_tp,) = typing.get_args(tp) or (typing.Any,)
        return [from_wire(item_tp, v) for v in data]
    if origin is dict:
        if not isinstance(data, dict):
            raise TypeError(f"expected an object, got {type(data).__name__}")
        args = typing.get_args(tp)
        val_tp = args[1] if len(args) == 2 else typing.Any
        return {k: from_wire(val_tp, v) for k, v in data.items()}
    return data


class AdmissionOverWire:
    """One ``admit`` review -> the webhook router's verdict.

    Each request seeds an ephemeral store with the review's context
    (already-admitted cluster state, so no hooks run on it), registers the
    webhook router on it and runs the hook the store would fire for this
    operation."""

    def admit(self, msg: dict) -> dict:
        if msg.get("v") != VERSION:
            return {"v": VERSION, "allowed": False,
                    "message": f"unsupported protocol version "
                               f"{msg.get('v')!r}", "patched": None}
        review = msg.get("review") or {}
        kind = review.get("kind", "")
        operation = review.get("operation", "CREATE")
        cls = KINDS.get(kind)
        if cls is None:
            return {"v": VERSION, "allowed": False,
                    "message": f"unsupported kind {kind!r}", "patched": None}
        try:
            obj = from_wire(cls, review.get("object") or {})
            old = (from_wire(cls, review["old"])
                   if review.get("old") else None)
            ctx = review.get("context") or {}
            ctx_objs = ([from_wire(QueueCR, qd)
                         for qd in ctx.get("queues") or []]
                        + [from_wire(PodGroupCR, pgd)
                           for pgd in ctx.get("podgroups") or []])
            # the context goes in before the hooks attach
            store = ObjectStore()
            for ctx_obj in ctx_objs:
                store.create(ctx_obj)
        except (TypeError, ValueError, KeyError, AttributeError) as exc:
            return {"v": VERSION, "allowed": False,
                    "message": f"malformed object: {exc}", "patched": None}
        before = to_wire(obj)
        router = register_webhooks(store)
        try:
            mutated = router.hook(operation, kind, obj, old)
        except AdmissionError as exc:
            return {"v": VERSION, "allowed": False, "message": str(exc),
                    "patched": None}
        patched = to_wire(mutated)
        return {"v": VERSION, "allowed": True, "message": "",
                "patched": None if patched == before else patched}
