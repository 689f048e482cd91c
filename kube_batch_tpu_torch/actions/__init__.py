"""Built-in actions (registration side effect on import)."""

from kube_batch_tpu_torch.actions import allocate, backfill  # noqa: F401

BUILTIN_ACTIONS = ("allocate", "backfill")
