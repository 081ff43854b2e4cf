"""The admission front door's overload plane: the bounded pending-work
budget (``backpressure.py``). The JAX package's admission webhooks and
their router are not in this package yet."""

from .backpressure import (AdmissionBudget, BackpressureError,
                           estimate_job_bytes)

__all__ = ["AdmissionBudget", "BackpressureError", "estimate_job_bytes"]
