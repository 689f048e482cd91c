"""Reclaim action: cross-queue fair-share reclamation.

Reference counterpart: actions/reclaim/reclaim.go · Execute; the port of
kube_batch_tpu/actions/reclaim.py.  For pending tasks of queues below
their deserved share, evict allocated tasks of OTHER queues, gated by the
tiered Reclaimable veto and by reclaim's own stop-at-deserved check (the
victim's queue must stay at or above its water-filled `deserved` after
the eviction).  The same loop as preempt (ops/preemption.py) with the
cross-queue masks below; `setup_state` runs again inside the solve, so
the deserved floor is proportion's water-fill of this cycle.
"""

from __future__ import annotations

from kube_batch_tpu_torch.actions.backfill import non_besteffort_eligible
from kube_batch_tpu_torch.actions.preempt import snapshot_victims, wanting_jobs_mask
from kube_batch_tpu_torch.api.snapshot import row_at
from kube_batch_tpu_torch.framework.plugin import Action, register_action
from kube_batch_tpu_torch.framework.policy import task_queue_of
from kube_batch_tpu_torch.ops.preemption import preemption_rounds
from kube_batch_tpu_torch.plugins.proportion import victim_stays_above_deserved


def reclaim_victim_fn(policy):
    """Cross-queue victims.  The stop-at-deserved check is inline, not in
    the tier walk: under the default conf tier 1 (gang/conformance) is
    the decisive veto tier and proportion's tier-2 ReclaimableFn is never
    consulted — as upstream.  The loop re-runs this mask after every
    eviction, so the floor holds cumulatively."""

    def victim_fn(snap, state, p):
        tq = task_queue_of(snap)
        return (
            snapshot_victims(snap, state)
            & (tq != row_at(tq, p))                   # cross-queue only
            & victim_stays_above_deserved(snap, state)
            & policy.reclaimable_mask(snap, state, p)
        )

    return victim_fn


def make_reclaim_solver(policy, max_iters: int | None = None):
    """(snap, state[, pred, stats]) -> state.  Any valid job with pending
    work may reclaim; its queue reaching deserved (Overused, through the
    eligibility gate) stops it, and best-effort tasks never reclaim.
    `stats["reclaim_steps"]` receives the loop stats."""
    wanting = wanting_jobs_mask(policy)
    victim_fn = reclaim_victim_fn(policy)
    eligible = non_besteffort_eligible(policy)

    def solve(snap, state, pred=None, stats: dict | None = None):
        state = policy.setup_state(snap, state)
        if pred is None:
            pred = policy.predicate_mask(snap)
        st: dict = {}
        state = preemption_rounds(
            snap, state, pred, victim_fn, wanting, policy.rank_fn, eligible,
            snap.eps, max_iters=max_iters,
            dyn_predicate_row_fn=policy.dyn_predicate_row, stats=st,
        )
        if stats is not None:
            stats["reclaim_steps"] = [st]
        return state

    return solve


@register_action
class ReclaimAction(Action):
    name = "reclaim"
    solver_factory = staticmethod(make_reclaim_solver)
    evicting = True    # the cycle reports this action's RELEASING transitions
    evict_reason = "reclaimed"
