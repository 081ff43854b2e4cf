"""Actions (mirrors pkg/scheduler/actions). Importing this
package registers the actions this package has: enqueue, allocate (engine
callbacks by default), allocate-tpu (tpu-fused by default), preempt, reclaim
and backfill — the actions of deploy/scheduler.conf and of the reference's
default conf — the reservation's elect and reserve, and the elastic gangs'
grow-shrink stage."""

from ..framework.registry import register_action
from .allocate import AllocateAction, AllocateTPUAction
from .backfill import BackfillAction
from .base import Action
from .elect import ElectAction
from .enqueue import EnqueueAction
from .preempt import PreemptAction
from .reclaim import ReclaimAction
from .reserve import ReserveAction
# grow-shrink lives in the elastic_gang package; it imports actions.base,
# which this package's own import has already made available
from ..elastic_gang.grow_shrink import GrowShrinkAction

register_action(EnqueueAction())
register_action(AllocateAction())
register_action(AllocateTPUAction())
register_action(PreemptAction())
register_action(ReclaimAction())
register_action(BackfillAction())
register_action(ElectAction())
register_action(ReserveAction())
register_action(GrowShrinkAction())

__all__ = ["Action", "AllocateAction", "AllocateTPUAction", "BackfillAction",
           "ElectAction", "EnqueueAction", "GrowShrinkAction",
           "PreemptAction", "ReclaimAction", "ReserveAction"]
