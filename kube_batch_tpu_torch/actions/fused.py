"""The cycle solver: the configured action pipeline as one call.

Reference counterpart: pkg/scheduler/scheduler.go · runOnce executing
`action.Execute(ssn)` in conf order; the port of the sequential path of
kube_batch_tpu/actions/fused.py · make_cycle_solver.  The solve returns
everything the host needs to commit the cycle: the final AllocState, one
RELEASING mask per evicting action (so each action's evictions commit
under its own reason), the JobReady mask (gang commit gate) and the
why-unschedulable failure tallies (kernel K4).
"""

from __future__ import annotations

from typing import Sequence

from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.ops.assignment import AllocState


def make_cycle_solver(policy, action_names: Sequence[str]):
    """(snap, state[, stats]) -> (state, evict_masks, job_ready, diag).

    Solvers come from the action registry (each Action class exposes
    `solver_factory`); an action without one raises KeyError.  The static
    predicate mask is computed once per cycle and shared by the actions
    and the diagnosis.  `evict_masks[name]` is bool[T]: the tasks action
    `name` newly marked RELEASING.  `stats` (optional dict) receives the
    auction rounds and preemption steps per pass."""
    from kube_batch_tpu_torch.framework.fit_errors import failure_counts
    from kube_batch_tpu_torch.framework.plugin import get_action

    solvers = []
    for name in action_names:
        action = get_action(name)
        factory = getattr(action, "solver_factory", None)
        if factory is None:
            raise KeyError(f"action {name!r} has no solver")
        solvers.append((name, factory(policy), getattr(action, "evicting", False)))
    releasing = int(TaskStatus.RELEASING)

    def cycle(snap, state: AllocState, stats: dict | None = None):
        pred = policy.predicate_mask(snap)
        evict_masks = {}
        for name, solve, evicting in solvers:
            prev = state.task_state
            state = solve(snap, state, pred=pred, stats=stats)
            if evicting:
                evict_masks[name] = ((state.task_state == releasing)
                                     & (prev != releasing) & snap.task_mask)
        job_ready = policy.job_ready_mask(snap, state)
        dyn = policy.dynamic_predicate_fn(snap, state, immediate=True)
        diag = failure_counts(snap, state, pred if dyn is None else pred & dyn)
        return state, evict_masks, job_ready, diag

    return cycle
