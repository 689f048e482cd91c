"""Proportion plugin: weighted fair queue shares.

Reference counterpart: plugins/proportion/proportion.go — per-queue
`deserved` by weighted water-filling of the cluster total, clamped by the
queue's own request (ops/waterfill.py); QueueOrderFn by
allocated/deserved; OverusedFn once deserved ⊑ allocated; ReclaimableFn
while the victim's queue stays at or above deserved after the eviction.
The port of kube_batch_tpu/plugins/proportion.py.
"""

from __future__ import annotations

import torch

from kube_batch_tpu_torch.api.snapshot import (
    allocated_mask,
    segment_sum,
    status_is,
)
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.framework.plugin import Plugin, register_plugin
from kube_batch_tpu_torch.framework.policy import (
    task_queue_of,
    virtual_start_times,
)
from kube_batch_tpu_torch.kernels.segment_sum import RequestRows
from kube_batch_tpu_torch.ops.waterfill import waterfill_deserved

BIG_SHARE = 1e9
DESERVED_AUX = "proportion/deserved"


def queue_allocated(snap, state) -> torch.Tensor:
    """f32[Q, R]: requests currently held per queue (pipelined count)."""
    held = (
        allocated_mask(state.task_state)
        | status_is(state.task_state, TaskStatus.PIPELINED)
    ) & snap.task_mask & (snap.task_job >= 0)
    idx = snap.segment_index("queue")
    seg = torch.where(held, idx.base, snap.num_queues)
    return segment_sum(
        torch.where(held[:, None], snap.task_req, 0.0), seg, snap.num_queues, idx
    )


def _request_rows(snap):
    """(valid bool[T], seg i32[T], the queue index): the rows that count
    toward a queue's request, and their queue (num_queues: dropped)."""
    valid = snap.task_mask & (snap.task_job >= 0)
    idx = snap.segment_index("queue")
    return valid, torch.where(valid, idx.base, snap.num_queues), idx


def queue_request(snap) -> torch.Tensor:
    """f32[Q, R]: total request of every task in the queue's jobs.  The
    cycle takes it inside `queue_deserved`; this form is its reference."""
    valid, seg, idx = _request_rows(snap)
    return segment_sum(
        torch.where(valid[:, None], snap.task_req, 0.0), seg, snap.num_queues, idx
    )


def queue_deserved(snap) -> torch.Tensor:
    """f32[Q, R] water-filled deserved (state-independent within a cycle):
    `queue_request` and its fill, in one K7 launch on the card (the sum
    skips the rows seg drops, so it takes task_req unmasked)."""
    _valid, seg, idx = _request_rows(snap)
    return waterfill_deserved(
        snap.queue_weight, RequestRows(snap.task_req, seg, idx.order, idx.offsets),
        snap.cluster_total, snap.queue_mask,
    )


def _deserved(snap, state) -> torch.Tensor:
    cached = state.aux.get(DESERVED_AUX)
    return cached if cached is not None else queue_deserved(snap)


def victim_stays_above_deserved(snap, state) -> torch.Tensor:
    """bool[T]: evicting this task leaves its queue at or above its
    deserved share on every meaningful dimension (counting dims excluded
    via besteffort_eps).  `after` is float32, as in the reference.  The
    one source of the deserved floor: the ReclaimableFn below and the
    reclaim action's inline victim gate both use it."""
    alloc = queue_allocated(snap, state)
    deserved = _deserved(snap, state)
    tq = task_queue_of(snap).long()
    after = alloc[tq] - snap.task_req
    return torch.all(
        (deserved[tq] <= after) | (deserved[tq] < snap.besteffort_eps[None, :]),
        dim=1,
    )


def reclaimable(snap, state, preemptor):  # noqa: ARG001
    return victim_stays_above_deserved(snap, state) | (snap.task_job < 0)


def queue_share(snap, state) -> torch.Tensor:
    """f32[Q]: max-dimension allocated/deserved ratio (lower = hungrier)."""
    alloc = queue_allocated(snap, state)
    deserved = _deserved(snap, state)
    ratio = torch.where(
        deserved > 0.0, alloc / torch.clamp(deserved, min=1e-9),
        torch.where(alloc > 0.0, BIG_SHARE, 0.0),
    )
    return ratio.max(dim=1).values


def overused(snap, state) -> torch.Tensor:
    """bool[Q]: deserved ⊑ allocated on every meaningful dim (counting
    dims excluded via besteffort_eps) → no more for this queue."""
    alloc = queue_allocated(snap, state)
    deserved = _deserved(snap, state)
    return torch.all(
        (deserved <= alloc) | (deserved < snap.besteffort_eps[None, :]), dim=1
    ) & snap.queue_mask


@register_plugin
class ProportionPlugin(Plugin):
    name = "proportion"

    def register(self, policy, tier: int) -> None:
        def queue_vtime(snap, state, base_rank, valid):
            """Virtual start times in allocated/deserved share space."""
            return virtual_start_times(
                task_queue_of(snap), base_rank, snap.task_req, valid,
                queue_allocated(snap, state), _deserved(snap, state),
                snap.num_queues,
            )

        policy.add_cycle_setup_fn(DESERVED_AUX, queue_deserved)
        if self.enabled_for("queueOrder"):
            policy.add_queue_order_fn(tier, queue_share)
            policy.add_queue_vtime_fn(tier, queue_vtime)
        if self.enabled_for("overused"):
            policy.add_overused_fn(overused)
        if self.enabled_for("reclaimable"):
            policy.add_reclaimable_fn(tier, reclaimable)
