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

The per-device lattice (the ``tpu-sharded`` engine's slots, ops/unified.py;
slot ids are its device ids): a fault ATTRIBUTED to one slot
(``attribute_device_fault``: an injected fault's ``device``) quarantines
that slot alone, and the mesh heals around it::

    ok --attributed fault--> quarantined (out of the mesh; window doubles
                             on each fresh fault, capped)
    quarantined --window expires--> probe (derived: a throwaway dry-run
                             solve pinned to the slot decides)
    probe --success--> ok (readmitted)     probe --fault--> quarantined
    ok --unattributed fault--> suspect (stays in the mesh; the fleet
                             window opens) --solve ok--> ok

All slots of a mesh share one card, so a real CUDA error names no slot:
it is unattributed and opens the fleet window, as on one device. Hence no
message is parsed for a slot id, as the JAX package's mesh of several
devices does.

Every transition is published to ``metrics`` (``device_faults{kind}``,
``device_quarantines{kind}``, readmissions, the healthy-slot gauge, the
``device`` section of ``health_detail()``). The windows run on an
injectable ``time_fn`` so the sim and the tests drive them on virtual
time; ``reset`` (a sim restart) clears them — health lives in process
memory.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional

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
    """A simulated device error (chaos.DeviceFaultInjector and
    chaos.MeshFaultInjector raise these with ``kind`` in {"oom",
    "device_lost", "slow"}), classified like the real error. ``device``
    carries the faulting slot's id when the injector models an attributed
    fault."""

    def __init__(self, kind: str, message: Optional[str] = None,
                 device: Optional[int] = None):
        super().__init__(message or f"simulated device fault: {kind}")
        self.kind = kind
        self.device = device


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


def attribute_device_fault(exc: BaseException,
                           devices: Optional[Iterable[int]] = None
                           ) -> Optional[int]:
    """Which slot does a classified fault name? The injected ``device``
    attribute. None when it names none (the suspect-all path) or one
    outside ``devices`` (a stale id of an earlier mesh must not quarantine
    a slot that was not solving)."""
    dev = getattr(exc, "device", None)
    if dev is None:
        return None
    dev = int(dev)
    if devices is not None and dev not in set(devices):
        return None
    return dev


class _DeviceRecord:
    """One slot's health. ``state`` is "ok" | "suspect" | "quarantined";
    probe is derived (quarantined with an expired window), so an advance of
    the virtual clock needs no transition."""

    __slots__ = ("state", "consecutive_faults", "total_faults",
                 "last_kind", "quarantined_until", "readmissions")

    def __init__(self):
        self.state = "ok"
        self.consecutive_faults = 0
        self.total_faults = 0
        self.last_kind: Optional[str] = None
        self.quarantined_until: Optional[float] = None
        self.readmissions = 0


class DeviceHealth:
    """The per-slot lattice and the fleet cool-down state machine
    (module-global ``DEVICE_HEALTH`` instance; allocate consults it every
    cycle). The fleet API (``record_fault`` with no device, ``record_ok``,
    ``available``, ``cooldown_remaining``) is the one-device case."""

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
        self._devices: Dict[int, _DeviceRecord] = {}

    # -- the fleet window (the one-device case) ----------------------------

    def record_fault(self, kind: str, device: Optional[int] = None) -> float:
        """A device fault occurred. With ``device`` it is attributed:
        quarantine that slot alone (``quarantine``), the fleet window
        stays closed. Without, open (or, after an expired window's failed
        probe, DOUBLE) the cool-down window and mark every known slot
        suspect. A fleet fault reported while the window is still open is
        the same outage classified twice (e.g. the tensor refresh AND the
        solve both blow up in one cycle) — it updates ``last_kind`` but
        neither bumps the counters nor extends the window. Returns the
        window length in force. Also publishes ``device_faults{kind}``
        for fresh faults, so call sites cannot double-count either."""
        if device is not None:
            return self.quarantine(device, kind)
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
            for rec in self._devices.values():
                if rec.state == "ok":
                    rec.state = "suspect"
                rec.last_kind = kind
        from . import metrics
        metrics.register_device_fault(kind)
        self._publish()
        return window

    def record_ok(self, device: Optional[int] = None) -> None:
        """A device solve completed: close the fleet machine back to OK and
        clear the suspect marks (the healthy mesh just proved itself);
        quarantined slots stay out until a probe. With ``device``, clear
        that slot's suspicion only. No-op when already OK — the hot path
        stays branch-cheap."""
        with self._lock:
            if device is not None:
                rec = self._devices.get(int(device))
                if rec is not None and rec.state == "suspect":
                    rec.state = "ok"
                return
            suspects = [r for r in self._devices.values()
                        if r.state == "suspect"]
            if self.consecutive_faults == 0 \
                    and self._cooldown_until is None and not suspects:
                return
            self.consecutive_faults = 0
            self._cooldown_until = None
            for rec in suspects:
                rec.state = "ok"
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

    # -- the per-slot lattice ----------------------------------------------

    def quarantine(self, device: int, kind: str) -> float:
        """An attributed fault: pull ``device`` out of the mesh. The fleet
        window's dedup and doubling, per slot: a fault inside the open
        window only updates ``last_kind``; a fresh one (the first, or a
        failed probe after expiry) doubles the window (capped). The caller
        retires the tensor epoch (the slot set changed). Returns the
        window length in force."""
        with self._lock:
            rec = self._devices.setdefault(int(device), _DeviceRecord())
            now = self.time_fn()
            if rec.quarantined_until is not None \
                    and now < rec.quarantined_until:
                rec.last_kind = kind
                return rec.quarantined_until - now
            rec.consecutive_faults += 1
            rec.total_faults += 1
            rec.last_kind = kind
            rec.state = "quarantined"
            window = min(
                self.cooldown_s * (2 ** (rec.consecutive_faults - 1)),
                self.max_cooldown_s)
            rec.quarantined_until = now + window
        from . import metrics
        metrics.register_device_fault(kind)
        metrics.register_device_quarantine(kind)
        self._publish()
        return window

    def readmit(self, device: int) -> None:
        """A quarantined slot's probe solve succeeded: back to OK, its
        counters reset. The caller retires the tensor epoch (the mesh
        grows)."""
        with self._lock:
            rec = self._devices.get(int(device))
            if rec is None or rec.state != "quarantined":
                return
            rec.state = "ok"
            rec.consecutive_faults = 0
            rec.quarantined_until = None
            rec.readmissions += 1
        from . import metrics
        metrics.register_device_readmission()
        self._publish()

    def healthy_devices(self, device_ids: Iterable[int]) -> List[int]:
        """The ids of ``device_ids`` a live solve may use, in order: all
        but the quarantined (suspect slots stay in; a probe slot stays out
        until its dry run readmits it). Registers unseen ids, so that an
        unattributed fault can suspect them."""
        with self._lock:
            out = []
            for did in device_ids:
                rec = self._devices.setdefault(int(did), _DeviceRecord())
                if rec.state != "quarantined":
                    out.append(did)
            return out

    def probe_candidates(self, device_ids: Iterable[int]) -> List[int]:
        """Quarantined slots whose window expired (the probe state), ready
        for a throwaway dry-run solve."""
        with self._lock:
            now = self.time_fn()
            return [did for did in device_ids
                    if (rec := self._devices.get(int(did))) is not None
                    and rec.state == "quarantined"
                    and rec.quarantined_until is not None
                    and now >= rec.quarantined_until]

    def device_state(self, device: int) -> str:
        """"ok" | "suspect" | "quarantined" | "probe" (derived)."""
        with self._lock:
            rec = self._devices.get(int(device))
            if rec is None:
                return "ok"
            if rec.state == "quarantined":
                if rec.quarantined_until is not None \
                        and self.time_fn() >= rec.quarantined_until:
                    return "probe"
                return "quarantined"
            return rec.state

    # -- introspection / lifecycle ---------------------------------------

    def detail(self) -> dict:
        with self._lock:
            until = self._cooldown_until
            now = self.time_fn()
            devices = {}
            healthy = quarantined = 0
            for did in sorted(self._devices):
                rec = self._devices[did]
                if rec.state == "quarantined":
                    quarantined += 1
                    state = ("probe" if rec.quarantined_until is not None
                             and now >= rec.quarantined_until
                             else "quarantined")
                    remaining = round(max(
                        0.0, (rec.quarantined_until or now) - now), 3)
                else:
                    healthy += 1
                    state = rec.state
                    remaining = 0.0
                devices[str(did)] = {
                    "state": state,
                    "consecutive_faults": rec.consecutive_faults,
                    "total_faults": rec.total_faults,
                    "last_kind": rec.last_kind,
                    "window_remaining_s": remaining,
                    "readmissions": rec.readmissions,
                }
            return {
                "available": until is None or now >= until,
                "consecutive_faults": self.consecutive_faults,
                "total_faults": self.total_faults,
                "last_kind": self.last_kind,
                "cooldown_remaining_s": round(max(0.0, (until - now)), 3)
                if until is not None else 0.0,
                "devices": devices,
                "devices_known": len(devices),
                "devices_healthy": healthy,
                "devices_quarantined": quarantined,
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
            self._devices = {}
            if time_fn is not None:
                self.time_fn = time_fn
        self._publish()

    def _publish(self) -> None:
        from . import metrics
        d = self.detail()
        metrics.set_device_health(d["available"], d)
        metrics.set_mesh_devices_healthy(d["devices_healthy"],
                                         d["devices_known"])


DEVICE_HEALTH = DeviceHealth()
