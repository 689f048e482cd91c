"""The cycle solver: the configured action pipeline as one call.

Reference counterpart: pkg/scheduler/scheduler.go · runOnce executing
`action.Execute(ssn)` in conf order; the port of kube_batch_tpu/actions/
fused.py · make_cycle_solver, build_joint_phases, _make_joint_cycle and
make_full_pipeline.  The solve returns everything the host needs to
commit the cycle: the final AllocState, one RELEASING mask per evicting
action (so each action's evictions commit under its own reason), the
JobReady mask (gang commit gate) and the why-unschedulable failure
tallies (kernel K4).

Two forms: the sequential one runs each action's solver in conf order;
the joint one (`joint=True`) folds the built-in actions into the tier
list of ops/joint.py · joint_rounds and solves them as one loop, with
the gated post-eviction admission sweep as its last tier.
"""

from __future__ import annotations

from typing import Sequence

from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.ops.assignment import AllocState


def make_cycle_solver(policy, action_names: Sequence[str], joint: bool = False):
    """(snap, state[, stats]) -> (state, evict_masks, job_ready, diag).

    `joint=True` returns the same contract computed by the joint solve
    (`make_joint_cycle`); a conf whose actions it cannot fold raises
    ValueError.

    Solvers come from the action registry (each Action class exposes
    `solver_factory`); an action without one raises KeyError.  The static
    predicate mask is computed once per cycle and shared by the actions
    and the diagnosis.  `evict_masks[name]` is bool[T]: the tasks action
    `name` newly marked RELEASING.  `stats` (optional dict) receives the
    auction rounds and preemption steps per pass."""
    from kube_batch_tpu_torch.framework.fit_errors import failure_counts
    from kube_batch_tpu_torch.framework.plugin import get_action

    if joint:
        return make_joint_cycle(policy, action_names)
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
        diag = failure_counts(snap, state, pred,
                              policy.auction_dyn_predicate(snap, state, immediate=True))
        return state, evict_masks, job_ready, diag

    return cycle


def build_joint_phases(policy, action_names: Sequence[str]) -> list:
    """Tier list of the joint solve: conf order becomes constraint bands
    — allocate's Idle and FutureIdle auctions, backfill's best-effort
    auction, preempt's inter- and intra-job eviction bands, reclaim's
    cross-queue band — each built from the mask factories its sequential
    action uses, plus the gated post-eviction admission sweep when any
    eviction band is configured (≙ kube_batch_tpu actions/fused.py ·
    build_joint_phases)."""
    from kube_batch_tpu_torch.actions.backfill import (
        ZERO_SCORE,
        backfill_eligible,
        non_besteffort_eligible,
    )
    from kube_batch_tpu_torch.actions.preempt import (
        preempt_eligible,
        preempt_victim_fn,
        preempt_victim_fn_intra,
        starving_jobs_mask,
        wanting_jobs_mask,
    )
    from kube_batch_tpu_torch.actions.reclaim import reclaim_victim_fn
    from kube_batch_tpu_torch.ops.joint import AuctionPhase, EvictPhase

    alloc_elig = non_besteffort_eligible(policy)
    spec = policy.score_spec()
    phases: list = []

    def admission(name, use_future, gated=False):
        return AuctionPhase(score_spec=spec, eligible_fn=alloc_elig,
                            use_future=use_future, max_steps=policy.max_rounds,
                            score_quantum=policy.score_quantum,
                            gated_on_evictions=gated, name=name)

    for i, name in enumerate(action_names):
        code = i + 1
        if name == "allocate":
            phases.append(admission("allocate:idle", False))
            phases.append(admission("allocate:future", True))
        elif name == "backfill":
            phases.append(AuctionPhase(score_spec=ZERO_SCORE,
                                       eligible_fn=backfill_eligible,
                                       use_future=False, name="backfill"))
        elif name == "preempt":
            elig = preempt_eligible(policy)
            phases.append(EvictPhase(victim_fn=preempt_victim_fn(policy),
                                     starving_fn=starving_jobs_mask(policy),
                                     eligible_fn=elig, evict_code=code,
                                     name="preempt:inter"))
            phases.append(EvictPhase(victim_fn=preempt_victim_fn_intra(policy),
                                     starving_fn=wanting_jobs_mask(policy),
                                     eligible_fn=elig, evict_code=code,
                                     name="preempt:intra"))
        elif name == "reclaim":
            phases.append(EvictPhase(victim_fn=reclaim_victim_fn(policy),
                                     starving_fn=wanting_jobs_mask(policy),
                                     eligible_fn=alloc_elig, evict_code=code,
                                     name="reclaim"))
        else:
            raise ValueError(f"action {name!r} has no joint-solve band")
    if any(isinstance(ph, EvictPhase) for ph in phases):
        # the post-eviction admission sweep over the freed capacity: one
        # more FutureIdle auction, run only when some eviction landed
        phases.append(admission("admission", True, gated=True))
    return phases


def make_joint_cycle(policy, action_names: Sequence[str]):
    """The joint-solve twin of the sequential cycle: the same
    (snap, state[, stats]) -> (state, evict_masks, job_ready, diag)
    contract from ONE `joint_rounds` solve, with the cycle setup, the
    static predicate mask and the serialize set computed once.  Only the
    four built-in action classes fold into the tier list: a custom action
    (or a custom class under a built-in name) raises ValueError."""
    from kube_batch_tpu_torch.actions.allocate import AllocateAction
    from kube_batch_tpu_torch.actions.backfill import BackfillAction
    from kube_batch_tpu_torch.actions.preempt import PreemptAction
    from kube_batch_tpu_torch.actions.reclaim import ReclaimAction
    from kube_batch_tpu_torch.framework.fit_errors import failure_counts
    from kube_batch_tpu_torch.framework.plugin import ACTION_REGISTRY
    from kube_batch_tpu_torch.ops.joint import joint_rounds

    builtin = {"allocate": AllocateAction, "backfill": BackfillAction,
               "preempt": PreemptAction, "reclaim": ReclaimAction}
    action_names = tuple(action_names)
    evicting = []
    for name in action_names:
        cls = builtin.get(name)
        if cls is None or ACTION_REGISTRY.get(name) is not cls:
            raise ValueError(f"action {name!r} is not a built-in solver; "
                             "the joint solve cannot fold it")
        if getattr(cls, "evicting", False):
            evicting.append(name)
    phases = build_joint_phases(policy, action_names)

    def cycle(snap, state: AllocState, stats: dict | None = None):
        state = policy.setup_state(snap, state)
        pred = policy.predicate_mask(snap)
        state, evict_code = joint_rounds(
            snap, state, phases, pred, policy.rank_fn, snap.eps,
            dyn_predicate_fn=policy.auction_dyn_predicate,
            dyn_predicate_row_fn=policy.dyn_predicate_row,
            global_serialize_fn=policy.global_serialize_fn,
            domain_serialize_fn=policy.domain_serialize_fn,
            serialize_mask=policy.serialize_mask(snap, state),
            stats=stats,
        )
        job_ready = policy.job_ready_mask(snap, state)
        diag = failure_counts(snap, state, pred,
                              policy.auction_dyn_predicate(snap, state, immediate=True))
        evict_masks = {
            name: (evict_code == action_names.index(name) + 1) & snap.task_mask
            for name in evicting
        }
        return state, evict_masks, job_ready, diag

    return cycle


def make_full_pipeline(policy, joint: bool = False):
    """The four-action pipeline in the reference's canonical order
    (allocate, backfill, preempt, reclaim — examples/scheduler.conf's
    actions)."""
    return make_cycle_solver(
        policy, ("allocate", "backfill", "preempt", "reclaim"), joint=joint
    )
