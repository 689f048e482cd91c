"""Domain types, resource vectors and the tensor snapshot."""

from kube_batch_tpu_torch.api.resource import ResourceSpec  # noqa: F401
from kube_batch_tpu_torch.api.snapshot import SnapshotTensors, from_numpy  # noqa: F401
from kube_batch_tpu_torch.api.types import PodGroupPhase, TaskStatus  # noqa: F401
