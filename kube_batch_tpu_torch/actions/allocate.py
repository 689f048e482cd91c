"""Allocate action: place pending tasks onto idle capacity.

Reference counterpart: actions/allocate/allocate.go · Execute; the port
of kube_batch_tpu/actions/allocate.py.  The serial queue→job→task loop is
two auction-round solves (ops/assignment.py):

1. against Idle — accepted placements become ALLOCATED;
2. against FutureIdle — leftover tasks that only fit once releasing
   resources free become PIPELINED (≙ ssn.Pipeline), consuming no Idle.

Queue fairness (Overused), gang validity (JobValid) and the tiered
ordering enter through the policy's eligible/rank functions,
re-evaluated every round.
"""

from __future__ import annotations

from kube_batch_tpu_torch.framework.plugin import Action, register_action
from kube_batch_tpu_torch.ops.assignment import allocate_rounds


def make_allocate_solver(policy, max_rounds: int | None = None):
    """(snap, state[, pred, stats]) -> state: the two-pass allocate solve.

    `max_rounds` bounds auction rounds per pass (None → the policy's
    `allocate.max_rounds`, failing that the number of tasks).
    `pred` is the cycle's static predicate mask when the caller already
    has it; `stats["allocate_rounds"]` receives the rounds of each pass."""
    from kube_batch_tpu_torch.actions.backfill import non_besteffort_eligible

    if max_rounds is None:
        max_rounds = policy.max_rounds
    eligible = non_besteffort_eligible(policy)
    spec = policy.score_spec()

    def solve(snap, state, pred=None, stats: dict | None = None):
        state = policy.setup_state(snap, state)
        if pred is None:
            pred = policy.predicate_mask(snap)
        serialize = policy.serialize_mask(snap, state)
        rounds = []
        for use_future in (False, True):
            st: dict = {}
            state = allocate_rounds(
                snap, state, pred, spec, policy.rank_fn, eligible, snap.eps,
                use_future=use_future,
                max_rounds=max_rounds,
                score_quantum=policy.score_quantum,
                dyn_predicate_fn=policy.dynamic_predicate_fn,
                global_serialize_fn=policy.global_serialize_fn,
                domain_serialize_fn=policy.domain_serialize_fn,
                serialize_mask=serialize,
                stats=st,
            )
            rounds.append(st["rounds"])
        if stats is not None:
            stats["allocate_rounds"] = rounds
        return state

    return solve


@register_action
class AllocateAction(Action):
    name = "allocate"
    solver_factory = staticmethod(make_allocate_solver)
