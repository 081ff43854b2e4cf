"""volcano_tpu_torch: the Volcano batch scheduler's allocate cycle in
PyTorch, with the placement solve as a hand-written CUDA kernel.

A port of the ``volcano_tpu`` package (JAX on a TPU), module for module under
the same paths and names. It runs the actions ``enqueue``, ``allocate-tpu``
(engine ``tpu-fused``) and ``backfill`` with the plugins ``priority``,
``gang``, ``nodeorder`` and ``binpack``; a conf naming anything else is
refused. Entry points solve on the CUDA card unless the caller passes
``device="cpu"``.
"""

from .scheduler import Scheduler

__all__ = ["Scheduler"]
