"""DRF plugin: Dominant Resource Fairness job and namespace ordering.

Reference counterpart: plugins/drf/drf.go — per-job share = max over
resources of allocated_r / clusterTotal_r, lower share scheduled first;
the port of kube_batch_tpu/plugins/drf.py.  Shares are reductions over
the live AllocState, recomputed every auction round, so the in-cycle
feedback the reference gets from its EventHandlers falls out.
PreemptableFn: a victim is allowed only if its job's share after the
eviction stays at or above the preemptor job's share.
"""

from __future__ import annotations

import torch

from kube_batch_tpu_torch.api.snapshot import (
    allocated_mask,
    row_at,
    segment_sum,
    status_is,
    sum_req_per_job,
)
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.framework.plugin import Plugin, register_plugin
from kube_batch_tpu_torch.framework.policy import virtual_start_times


def _held(state) -> torch.Tensor:
    """Allocated or pipelined (the reference fires the same allocate
    EventHandlers for ssn.Pipeline)."""
    return allocated_mask(state.task_state) | status_is(
        state.task_state, TaskStatus.PIPELINED
    )


def job_allocated(snap, state) -> torch.Tensor:
    """f32[J, R]: resources currently held by each job's tasks."""
    return sum_req_per_job(snap, _held(state))


def share_of(alloc: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """Dominant share: max over resource dims of alloc/total."""
    return (alloc / torch.clamp(total, min=1e-9)).max(dim=-1).values


def job_share(snap, state) -> torch.Tensor:
    """f32[J]: dominant share (drf.go · calculateShare)."""
    return share_of(job_allocated(snap, state), snap.cluster_total)


def ns_allocated(snap, state) -> torch.Tensor:
    """f32[S, R]: resources currently held per namespace."""
    held = _held(state) & snap.task_mask & (snap.task_ns >= 0)
    S = snap.ns_weight.shape[0]
    idx = snap.segment_index("ns")
    seg = torch.where(held, idx.base, S)
    return segment_sum(torch.where(held[:, None], snap.task_req, 0.0), seg, S, idx)


def ns_share(snap, state) -> torch.Tensor:
    """f32[S]: weighted dominant share per namespace."""
    w = torch.clamp(snap.ns_weight, min=1e-9)[:, None]
    return share_of(ns_allocated(snap, state) / w, snap.cluster_total)


def preemptable(snap, state, preemptor):
    """bool[T]: the victim's job keeps at least the preemptor job's
    dominant share after the eviction (`after` in float32, as the
    reference computes it)."""
    alloc = job_allocated(snap, state)                         # f32[J, R]
    total = snap.cluster_total
    pj = torch.clamp(row_at(snap.task_job, preemptor), 0, snap.num_jobs - 1).long()
    preemptor_share = share_of(row_at(alloc, pj), total)
    tj = torch.clamp(snap.task_job, 0, snap.num_jobs - 1).long()
    victim_share_after = share_of(alloc[tj] - snap.task_req, total)
    return (victim_share_after >= preemptor_share) | (snap.task_job < 0)


@register_plugin
class DrfPlugin(Plugin):
    name = "drf"

    def register(self, policy, tier: int) -> None:
        def job_vtime(snap, state, base_rank, valid):
            """Per-task virtual start times in dominant-share space."""
            total = torch.clamp(snap.cluster_total, min=1e-9)[None, :].expand(
                snap.num_jobs, snap.num_resources
            )
            return virtual_start_times(
                snap.task_job, base_rank, snap.task_req, valid,
                job_allocated(snap, state), total, snap.num_jobs,
            )

        def ns_vtime(snap, state, base_rank, valid):
            """Virtual start times in weighted namespace-share space."""
            S = snap.ns_weight.shape[0]
            denom = torch.clamp(snap.cluster_total, min=1e-9)[None, :] * (
                torch.clamp(snap.ns_weight, min=1e-9)[:, None]
            )
            return virtual_start_times(
                snap.task_ns, base_rank, snap.task_req, valid,
                ns_allocated(snap, state), denom, S,
            )

        if self.enabled_for("jobOrder"):
            policy.add_job_order_fn(tier, job_share)
            policy.add_job_vtime_fn(tier, job_vtime)
        if self.enabled_for("namespaceOrder"):
            policy.add_namespace_order_fn(tier, ns_share)
            policy.add_namespace_vtime_fn(tier, ns_vtime)
        if self.enabled_for("preemptable"):
            policy.add_preemptable_fn(tier, preemptable)
