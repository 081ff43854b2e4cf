"""The admission front door: the webhooks (mutating defaults and
validating rules, registered as ObjectStore admission hooks, the in-process
form of Volcano's TLS webhook server in ``pkg/webhooks``), their router,
the batched submission path and its bounded pending-work budget
(``backpressure.py``)."""

from .admission import register_webhooks, submit_job_batch
from .backpressure import (AdmissionBudget, BackpressureError,
                           estimate_job_bytes)
from .router import AdmissionService, Router

__all__ = ["AdmissionBudget", "AdmissionService", "BackpressureError",
           "Router", "estimate_job_bytes", "register_webhooks",
           "submit_job_batch"]
