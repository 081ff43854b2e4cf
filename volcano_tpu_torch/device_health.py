"""Device-fault containment: classify the card's errors, and cool the
device down so a faulting card is not re-failed every cycle (the JAX
package's ``device_health.py``, retargeted from XLA's errors to what
PyTorch raises).

A batched solve can fail for different reasons, and the right response
differs:

- **Solver logic faults** (non-finite inputs —
  ``actions.allocate.SolverFault``): the card is fine, the inputs are
  wrong. The sequential placer finishes the cycle and the device engine
  runs again next cycle.
- **An out-of-memory error** from the caching allocator
  (``torch.cuda.OutOfMemoryError``): the card refused an allocation
  before any kernel ran on it. Retrying at once re-fails, so it opens the
  cool-down, and the sequential placer finishes the cycle.
- **A CUDA error raised at a synchronizing call or a fetch**: the card
  reports it, but it reports a hand kernel's own fault (an illegal
  address, a device-side assert) the same way and at the same place, so
  it is counted and opens the cool-down (after a sticky error the context
  is dead and cached device state is poison), and the action still
  fails: a broken kernel is never hidden behind a CPU cycle.
- **A kernel that fails to build, to launch or to give a well-formed
  wire** (``ops.build.KernelError``) is the program's fault: it
  classifies as None and stays a failed action.

``classify_device_fault`` names the kind of the card's errors (None for
everything else); ``actions.allocate.AllocateAction._with_fallback``
decides which of them the sequential placer may finish. The fleet window::

    OK --fault--> COOLDOWN (allocate degrades to the sequential placer;
                  the device is not touched)
    COOLDOWN --window expires--> PROBE (the next cycle tries the device
                  engine once)
    PROBE --success--> OK (counters reset)
    PROBE --fault--> COOLDOWN, window doubled (capped)

A sticky error needs no state of its own: each probe re-faults and the
window doubles to its cap, as in the JAX package.

Every transition is published to ``metrics`` (``device_faults{kind}``,
the ``device`` section of ``health_detail()``). The window runs on an
injectable ``time_fn`` so the sim and the tests drive it on virtual time;
``reset`` (a sim restart) clears it — health lives in process memory.
The JAX package's per-device lattice (attributed faults quarantine one
device of a mesh, a probe readmits it) comes with the multi-device solve
(ROADMAP item 10b): one card has only the fleet window.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

DEFAULT_COOLDOWN_S = 30.0
DEFAULT_MAX_COOLDOWN_S = 480.0

# markers of a CUDA error that leaves the context unusable (every later
# call on it fails): the card reports them at the next synchronizing call
_STICKY_MARKERS = ("illegal memory access", "illegal address",
                   "misaligned address", "illegal instruction",
                   "unspecified launch failure", "uncorrectable ECC",
                   "ECC error", "device-side assert")
# the prefix torch gives a CUDA error raised as a plain RuntimeError
_CUDA_ERROR_PREFIX = "CUDA error:"
# the kind of a CUDA error that is neither an OOM nor sticky: the JAX
# package's generic kind, so both packages count under one label
GENERIC_KIND = "xla"


class DeviceFaultError(RuntimeError):
    """A simulated device error (chaos.DeviceFaultInjector raises these
    with ``kind`` in {"oom", "device_lost", "slow"}), classified like the
    real error."""

    def __init__(self, kind: str, message: Optional[str] = None):
        super().__init__(message or f"simulated device fault: {kind}")
        self.kind = kind


def _is_cuda_error(exc: BaseException) -> bool:
    """A CUDA error torch raised: ``torch.AcceleratorError`` where the
    installation has it (matched on the type name, as the JAX package
    matches XlaRuntimeError's), else a RuntimeError whose message starts
    with ``CUDA error:``."""
    if type(exc).__name__ == "AcceleratorError":
        return True
    return isinstance(exc, RuntimeError) \
        and str(exc).startswith(_CUDA_ERROR_PREFIX)


def classify_device_fault(exc: BaseException) -> Optional[str]:
    """The device-fault kind of ``exc``: "oom" for the caching
    allocator's ``torch.cuda.OutOfMemoryError``, "device_lost" for a
    sticky CUDA error, GENERIC_KIND for another CUDA error, an injected
    ``DeviceFaultError``'s own kind; None for everything else — solver
    faults, a kernel that fails to build or to launch
    (``ops.build.KernelError``), type and shape errors."""
    if isinstance(exc, DeviceFaultError):
        return exc.kind
    from .ops.build import KernelError
    if isinstance(exc, KernelError):
        return None
    import torch
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return "oom"
    if not _is_cuda_error(exc):
        return None
    msg = str(exc)
    if "out of memory" in msg:
        return "oom"
    if any(m in msg for m in _STICKY_MARKERS):
        return "device_lost"
    return GENERIC_KIND


class DeviceHealth:
    """The fleet cool-down state machine (module-global ``DEVICE_HEALTH``
    instance; allocate consults it every cycle): the JAX package's
    single-device API, its D=1 case."""

    def __init__(self, cooldown_s: float = DEFAULT_COOLDOWN_S,
                 max_cooldown_s: float = DEFAULT_MAX_COOLDOWN_S,
                 time_fn=time.monotonic):
        self.cooldown_s = cooldown_s
        self.max_cooldown_s = max_cooldown_s
        self.time_fn = time_fn
        self._lock = threading.Lock()
        self.consecutive_faults = 0
        self.total_faults = 0
        self.last_kind: Optional[str] = None
        self._cooldown_until: Optional[float] = None

    def record_fault(self, kind: str) -> float:
        """A device fault occurred: open (or, after an expired window's
        failed probe, DOUBLE) the cool-down window. A fault reported while
        the window is still open is the same outage classified twice
        (e.g. the tensor refresh AND the solve both blow up in one cycle)
        — it updates ``last_kind`` but neither bumps the counters nor
        extends the window. Returns the window length in force. Also
        publishes ``device_faults{kind}`` for fresh faults, so call sites
        cannot double-count either."""
        with self._lock:
            now = self.time_fn()
            if self._cooldown_until is not None \
                    and now < self._cooldown_until:
                self.last_kind = kind
                return self._cooldown_until - now
            self.consecutive_faults += 1
            self.total_faults += 1
            self.last_kind = kind
            window = min(
                self.cooldown_s * (2 ** (self.consecutive_faults - 1)),
                self.max_cooldown_s)
            self._cooldown_until = now + window
        from . import metrics
        metrics.register_device_fault(kind)
        self._publish()
        return window

    def record_ok(self) -> None:
        """A device solve completed: close the machine back to OK. No-op
        when already OK — the hot path stays branch-cheap."""
        with self._lock:
            if self.consecutive_faults == 0 \
                    and self._cooldown_until is None:
                return
            self.consecutive_faults = 0
            self._cooldown_until = None
        self._publish()

    def available(self) -> bool:
        """May allocate dispatch to the device this cycle? True in OK and
        PROBE (window expired — one re-probe attempt is the only way to
        learn the device recovered), False inside the window."""
        with self._lock:
            until = self._cooldown_until
            return until is None or self.time_fn() >= until

    def cooldown_remaining(self) -> float:
        with self._lock:
            if self._cooldown_until is None:
                return 0.0
            return max(0.0, self._cooldown_until - self.time_fn())

    # -- introspection / lifecycle ---------------------------------------

    def detail(self) -> dict:
        with self._lock:
            until = self._cooldown_until
            now = self.time_fn()
            return {
                "available": until is None or now >= until,
                "consecutive_faults": self.consecutive_faults,
                "total_faults": self.total_faults,
                "last_kind": self.last_kind,
                "cooldown_remaining_s": round(max(0.0, (until - now)), 3)
                if until is not None else 0.0,
            }

    def reset(self, time_fn=None) -> None:
        """Full reset (tests / sim restart — health lives in process
        memory, so a simulated process death forgets the window exactly
        like a real one); optionally swap the time source."""
        with self._lock:
            self.consecutive_faults = 0
            self.total_faults = 0
            self.last_kind = None
            self._cooldown_until = None
            if time_fn is not None:
                self.time_fn = time_fn
        self._publish()

    def _publish(self) -> None:
        from . import metrics
        d = self.detail()
        metrics.set_device_health(d["available"], d)


DEVICE_HEALTH = DeviceHealth()
