"""Workload generators (BASELINE configs 1–5)."""

from kube_batch_tpu_torch.models.workloads import build_config  # noqa: F401
