"""Weighted water-filling of cluster capacity into queue `deserved`.

Reference counterpart: plugins/proportion/proportion.go — iterative
redistribution of the cluster total among queues proportional to weight,
each queue clamped at its own total request and its surplus
redistributed; the port of kube_batch_tpu/ops/waterfill.py.  Q+1
iterations over [Q, R] always suffice: each clamps ≥1 queue-dim or
distributes all remaining capacity.
"""

from __future__ import annotations

import torch


def _sum_queues(x: torch.Tensor) -> torch.Tensor:
    """Σ over the queue axis of f32[Q, R], strictly left to right — the
    order the reference's float32 reduction takes on the CPU, so the two
    agree to the bit."""
    acc = torch.zeros_like(x[0])
    for q in range(x.shape[0]):
        acc = acc + x[q]
    return acc


def waterfill_deserved(
    weights: torch.Tensor,     # f32[Q]
    request: torch.Tensor,     # f32[Q, R]  total request per queue
    total: torch.Tensor,       # f32[R]     cluster capacity
    queue_mask: torch.Tensor,  # bool[Q]
) -> torch.Tensor:
    """f32[Q, R]: each queue's deserved share of the cluster."""
    Q = weights.shape[0]
    request = torch.where(queue_mask[:, None], request, 0.0)
    deserved = torch.zeros_like(request)
    remaining = total.float()
    unsat = queue_mask[:, None] & torch.ones_like(request, dtype=torch.bool)
    for _ in range(Q + 1):
        w = torch.where(unsat, weights[:, None], 0.0)
        wsum = _sum_queues(w)
        inc = torch.where(
            wsum > 0.0, remaining[None, :] * w / torch.clamp(wsum, min=1e-9), 0.0
        )
        filled = deserved + inc
        hit = filled >= request
        filled = torch.minimum(filled, request)
        spent = _sum_queues(filled - deserved)
        deserved, remaining, unsat = (
            filled, torch.clamp(remaining - spent, min=0.0), unsat & ~hit
        )
    return deserved
