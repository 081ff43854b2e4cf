"""CRD-like object model of the object store (the JAX package's
``apis``): batch/v1alpha1 Job, scheduling/v1beta1 PodGroup and Queue,
bus/v1alpha1 Command, a minimal core/v1 Pod and the PVC objects. These
live in the ObjectStore; the cache's informers (cache/store_wiring.py)
build the scheduler's api infos from them.
"""

from .objects import (Command, Job, JobSpec, LifecyclePolicy, Pod, PodGroupCR,
                      PodTemplate, PriorityClass, QueueCR, TaskSpec)

__all__ = ["Command", "Job", "JobSpec", "LifecyclePolicy", "Pod",
           "PodGroupCR", "PodTemplate", "PriorityClass", "QueueCR",
           "TaskSpec"]
