"""Weighted water-filling of cluster capacity into queue `deserved`.

Reference counterpart: plugins/proportion/proportion.go — iterative
redistribution of the cluster total among queues proportional to weight,
each queue clamped at its own total request and its surplus
redistributed; the port of kube_batch_tpu/ops/waterfill.py.  Q+1
iterations over [Q, R] always suffice: each clamps ≥1 queue-dim or
distributes all remaining capacity; the port stops earlier, at the first
iteration that changes nothing (the same result).  The third entry point
of kernel K7 (kernels/segment_sum.py · waterfill) computes it on the
card, its plain version on the CPU, both with the queue sums in blocks of
32 queues.
"""

from __future__ import annotations

import torch

from kube_batch_tpu_torch.kernels import segment_sum as _k7


def waterfill_deserved(
    weights: torch.Tensor,     # f32[Q]
    request,                   # f32[Q, R]  total request per queue, or the
                               # kernel's RequestRows to sum first
    total: torch.Tensor,       # f32[R]     cluster capacity
    queue_mask: torch.Tensor,  # bool[Q]
) -> torch.Tensor:
    """f32[Q, R]: each queue's deserved share of the cluster."""
    return _k7.waterfill(weights, request, total, queue_mask)
