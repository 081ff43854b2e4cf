"""Actions (mirrors pkg/scheduler/actions). Importing this
package registers the actions this package has: enqueue, allocate-tpu,
preempt, reclaim and backfill — the actions of deploy/scheduler.conf."""

from ..framework.registry import register_action
from .allocate import AllocateTPUAction
from .backfill import BackfillAction
from .base import Action
from .enqueue import EnqueueAction
from .preempt import PreemptAction
from .reclaim import ReclaimAction

register_action(EnqueueAction())
register_action(AllocateTPUAction())
register_action(PreemptAction())
register_action(ReclaimAction())
register_action(BackfillAction())

__all__ = ["Action", "AllocateTPUAction", "BackfillAction", "EnqueueAction",
           "PreemptAction", "ReclaimAction"]
