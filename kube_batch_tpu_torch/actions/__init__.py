"""Built-in actions (registration side effect on import)."""

from kube_batch_tpu_torch.actions import (  # noqa: F401
    allocate,
    backfill,
    preempt,
    reclaim,
)

BUILTIN_ACTIONS = ("allocate", "backfill", "preempt", "reclaim")
