"""The node mesh of the ``tpu-sharded`` engine: device slots, the 1-D mesh
over them and the node-sharded blocks solve (the JAX package's
ops/unified.py, its mesh half).

The JAX package shards the node axis over ``jax.devices()``; this package
shards it over *slots*. A slot is one shard of the node axis placed on a
device, and the slot list is the counterpart of ``jax.devices()``: slot ids
are the device ids of the health lattice (device_health.DEVICE_HEALTH), the
sharded engine's ``sharded-devices`` argument takes the first k slots, and a
quarantined slot leaves the mesh. All slots of a mesh lie on one CUDA device
(or all on the CPU): the shards of one solve run there as one thread-block
cluster (ops/blocks.py, ops/evict.py), and a mesh whose slots name more than
one CUDA device is refused at ``make_mesh``.

How many slots a process has, as XLA's host device count says how many
virtual CPU devices the JAX package has:

- ``set_devices(n, device)`` sets n slots (tests; ``None`` restores the
  default);
- else the environment variable ``VOLCANO_TORCH_MESH_SLOTS`` (read once, at
  the first call), e.g. ``VOLCANO_TORCH_MESH_SLOTS=8 python -m
  volcano_tpu_torch.sim --sharded``;
- else one slot.

Slots placed by ``set_devices`` carry their device; slots from the
environment or the default take the device of the session that asks
(``devices(default_device)``).

Decisions are mesh-size invariant by construction (ops/blocks.py): a
shard's candidates merge into the global top K in global-index tie order,
the round count is global, a node's contention is decided by its owner
shard and the verdicts are OR-ed. ``place_blocks_unified`` over any mesh
gives the single-device solve's bits.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .blocks import padded_task_len, place_blocks_unified  # noqa: F401

NODE_AXIS = "nodes"
SLOTS_ENV = "VOLCANO_TORCH_MESH_SLOTS"


class Slot(NamedTuple):
    """One shard of the node axis: its id (the lattice's device id) and the
    device its rows live on."""

    id: int
    device: torch.device


class Mesh(NamedTuple):
    """A 1-D mesh of slots over ``axis``."""

    devices: Tuple[Slot, ...]
    axis: str = NODE_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every slot lies on."""
        return self.devices[0].device


_SET: Optional[Tuple[int, Optional[torch.device]]] = None
_ENV_COUNT: Optional[int] = None
_MESH_CACHE: dict = {}


def _env_count() -> int:
    global _ENV_COUNT
    if _ENV_COUNT is None:
        raw = os.environ.get(SLOTS_ENV, "").strip()
        try:
            _ENV_COUNT = max(int(raw), 1) if raw else 1
        except ValueError:
            raise ValueError(f"{SLOTS_ENV}={raw!r}: not a slot count") \
                from None
    return _ENV_COUNT


def set_devices(n: Optional[int], device=None) -> None:
    """Give the process ``n`` slots on ``device`` (None: the device of the
    session that asks); ``n`` None returns to the environment's count or
    one slot."""
    global _SET
    if n is not None and n < 1:
        raise ValueError(f"set_devices: {n} slots")
    _SET = None if n is None else (
        int(n), None if device is None else torch.device(device))


def device_count() -> int:
    """The process's slot count."""
    return _SET[0] if _SET is not None else _env_count()


def devices(default_device=None) -> Tuple[Slot, ...]:
    """The process's slots, ids 0..n-1, on the device ``set_devices`` gave
    or else on ``default_device`` (the CUDA device when None)."""
    n, device = _SET if _SET is not None else (_env_count(), None)
    if device is None:
        device = torch.device(default_device if default_device is not None
                              else "cuda")
    return tuple(Slot(i, device) for i in range(n))


def make_mesh(slots: Optional[Sequence[Slot]] = None,
              axis: str = NODE_AXIS) -> Mesh:
    """The 1-D mesh over ``slots`` (the process's slots when None), cached
    per slot set. Raises when the slots lie on more than one device: the
    shards of one solve share one card's cluster."""
    slots = tuple(slots) if slots is not None else devices()
    if not slots:
        raise ValueError("make_mesh: no slots")
    key = (tuple((s.id, str(s.device)) for s in slots), axis)
    mesh = _MESH_CACHE.get(key)
    if mesh is None:
        places = {str(s.device) for s in slots}
        if len(places) > 1:
            raise ValueError(
                f"make_mesh: slots on {sorted(places)}: a mesh over more "
                f"than one device is not in volcano_tpu_torch (its shards "
                f"run as one thread-block cluster on one card)")
        mesh = Mesh(slots, axis)
        _MESH_CACHE[key] = mesh
    return mesh


def bucket_nodes_for_mesh(n: int, d: int) -> int:
    """Node-axis length after padding to a multiple of the mesh size.
    Callers pad with zero-capacity nodes (max_tasks 0), which the fit
    predicate can never select."""
    return n + (-n) % d


def place_scan_unified(mesh, *args, **kwargs):
    """The node-sharded scan (B5, the JAX package's unified.py:542-600):
    not in this package. No allocate engine reaches it; the tpu-sharded
    engine runs the blocks solve."""
    raise NotImplementedError(
        "place_scan_unified: the node-sharded scan (B5) is not in "
        "volcano_tpu_torch; the tpu-sharded engine runs the blocks solve "
        "(place_blocks_unified)")
