"""volcano_tpu_torch: the Volcano batch scheduler in PyTorch, with its
device solves as hand-written CUDA kernels.

A port of the ``volcano_tpu`` package (JAX on a TPU), module for module
under the same paths and names: the scheduler shell (``scheduler.py``),
the cache with its intent journal and resync queue, the actions and
plugins of ``deploy/scheduler.conf`` and of the reference's default conf,
and the sim's direct mode (``python -m volcano_tpu_torch.sim``). A conf
naming an action, plugin, engine or argument this package lacks is
refused by name when it loads. Entry points solve on the CUDA card unless
the caller passes ``device="cpu"``.

The in-process Volcano system (``system.py``: the object store, admission
webhooks, controllers, vcctl and the scheduler in one process) is the
entry point a user starts; ``cmd.py`` holds the control-plane binaries.
"""

from .scheduler import Scheduler

__version__ = "0.1.0"

__all__ = ["Scheduler", "__version__"]
