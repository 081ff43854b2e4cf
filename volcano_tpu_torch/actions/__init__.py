"""Actions (mirrors pkg/scheduler/actions). Importing this
package registers the actions this package has: enqueue, allocate-tpu and
backfill."""

from ..framework.registry import register_action
from .allocate import AllocateTPUAction
from .backfill import BackfillAction
from .base import Action
from .enqueue import EnqueueAction

register_action(EnqueueAction())
register_action(AllocateTPUAction())
register_action(BackfillAction())

__all__ = ["Action", "AllocateTPUAction", "BackfillAction", "EnqueueAction"]
