"""Backfill action: slot best-effort pods into leftover capacity.

Reference counterpart: actions/backfill/backfill.go · Execute — every
pending task with an EMPTY resource request goes to any predicate-passing
node; the port of kube_batch_tpu/actions/backfill.py.  One auction solve
restricted to the best-effort mask, with the zero score (an empty
ScoreSpec): round-robin tie dealing spreads the zero-score ties over the
feasible nodes, and pod-slot capacity still binds through the fit check.
"""

from __future__ import annotations

import torch

from kube_batch_tpu_torch.framework.plugin import Action, register_action
from kube_batch_tpu_torch.kernels.propose import ScoreSpec
from kube_batch_tpu_torch.ops.assignment import allocate_rounds

ZERO_SCORE = ScoreSpec()


def besteffort_mask(snap) -> torch.Tensor:
    """bool[T]: empty-request tasks (≙ TaskInfo.Resreq.IsEmpty())."""
    return torch.all(snap.task_req < snap.besteffort_eps, dim=1)


def non_besteffort_eligible(policy):
    """Policy-wide eligibility minus best-effort tasks (those are
    exclusively backfill's, ≙ allocate.go's empty-Resreq continue)."""

    def eligible(snap, state):
        return policy.eligible_fn(snap, state) & ~besteffort_mask(snap)

    return eligible


def backfill_eligible(snap, state):  # noqa: ARG001 — no queue/job gate
    return besteffort_mask(snap)


def make_backfill_solver(policy, max_rounds: int | None = None):
    def solve(snap, state, pred=None, stats: dict | None = None):
        state = policy.setup_state(snap, state)
        if pred is None:
            pred = policy.predicate_mask(snap)
        st: dict = {}
        state = allocate_rounds(
            snap, state, pred, ZERO_SCORE, policy.rank_fn, backfill_eligible,
            snap.eps,
            max_rounds=max_rounds,
            dyn_predicate_fn=policy.auction_dyn_predicate,
            global_serialize_fn=policy.global_serialize_fn,
            domain_serialize_fn=policy.domain_serialize_fn,
            serialize_mask=policy.serialize_mask(snap, state),
            stats=st,
        )
        if stats is not None:
            stats["backfill_rounds"] = [st["rounds"]]
            stats["backfill_cancelled"] = [st["cancelled"]]
        return state

    return solve


@register_action
class BackfillAction(Action):
    name = "backfill"
    solver_factory = staticmethod(make_backfill_solver)
