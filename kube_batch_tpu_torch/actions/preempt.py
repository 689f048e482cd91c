"""Preempt action: within-queue priority preemption for starving gangs.

Reference counterpart: actions/preempt/preempt.go · Execute; the port of
kube_batch_tpu/actions/preempt.py.  Per queue, while a starving (not
Ready) job exists, evict `Preemptable`-approved victims of less-deserving
jobs in the SAME queue until the preemptor fits the node's FutureIdle,
then pipeline the preemptor (ops/preemption.py).  The mode-specific
pieces are the masks below:

* starving jobs: valid (gang minMember still reachable), not ready, not
  pipelined-satisfiable, with pending work;
* victims: tasks allocated in the snapshot and in the live state, of a
  DIFFERENT job in the SAME queue whose job ranks after the preemptor's,
  intersected with the tiered Preemptable veto (first decisive tier
  wins: under the default conf gang ∧ conformance bind, drf's tier-2
  share veto does not).

Two phases, as in the reference: phase 1 between jobs, phase 2 within a
job (a higher-priority pending task displaces its own job's
lower-priority running task).  The host commits the evictions through
the session's funnel (`commit_victim_indices`).
"""

from __future__ import annotations

import numpy as np
import torch

from kube_batch_tpu_torch.actions.backfill import besteffort_mask
from kube_batch_tpu_torch.api.snapshot import (
    allocated_mask,
    count_per_job,
    row_at,
    status_is,
)
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.framework.plugin import Action, register_action
from kube_batch_tpu_torch.framework.policy import task_queue_of
from kube_batch_tpu_torch.ops.preemption import preemption_rounds


def wanting_jobs_mask(policy):
    """bool[J]: any valid job with pending work ("underRequest") — the
    trigger set shared by reclaim and preempt's phase 2."""

    def wanting(snap, state):
        pending_cnt = count_per_job(snap, status_is(state.task_state, TaskStatus.PENDING))
        return snap.job_mask & policy.job_valid_mask(snap, state) & (pending_cnt > 0)

    return wanting


def starving_jobs_mask(policy):
    """bool[J]: jobs entitled to trigger evictions right now."""

    def starving(snap, state):
        pending_cnt = count_per_job(snap, status_is(state.task_state, TaskStatus.PENDING))
        ready = policy.job_ready_mask(snap, state)
        pipelined = policy.job_pipelined_mask(snap, state)
        valid = policy.job_valid_mask(snap, state)
        return snap.job_mask & valid & ~ready & ~pipelined & (pending_cnt > 0)

    return starving


def snapshot_victims(snap, state) -> torch.Tensor:
    """bool[T]: tasks evictable at all — holding node resources both in
    the snapshot (really running on the cluster) and in the live state
    (not already chosen as a victim this cycle)."""
    return (allocated_mask(snap.task_state) & allocated_mask(state.task_state)
            & snap.task_mask & (snap.task_job >= 0))


def preempt_victim_fn(policy):
    """Phase-1 victims: BETWEEN jobs of one queue, job-rank gated."""

    def victim_fn(snap, state, p):
        tq = task_queue_of(snap)
        tj = torch.clamp(snap.task_job, 0, snap.num_jobs - 1).long()
        pj = torch.clamp(row_at(snap.task_job, p), 0, snap.num_jobs - 1).long()
        jrank = policy.job_rank(snap, state)
        return (
            snapshot_victims(snap, state)
            & (tq == row_at(tq, p))                  # same queue
            & (snap.task_job != row_at(snap.task_job, p))   # other jobs only
            & (jrank[tj] > row_at(jrank, pj))        # less-deserving jobs
            & policy.preemptable_mask(snap, state, p)
        )

    return victim_fn


def preempt_victim_fn_intra(policy):
    """Phase-2 victims: the preemptor's OWN job, strictly lower task
    priority (preempt.go's second loop)."""

    def victim_fn_intra(snap, state, p):
        return (
            snapshot_victims(snap, state)
            & (snap.task_job == row_at(snap.task_job, p))
            & (snap.task_prio < row_at(snap.task_prio, p))
            & policy.preemptable_mask(snap, state, p)
        )

    return victim_fn_intra


def preempt_eligible(policy):
    """The preemptor gate both phases share: the job is valid and the
    task is not best-effort.  Within-queue preemption ignores Overused
    (the reference's preempt never consults ssn.Overused)."""

    def eligible(snap, state):
        jv = policy.job_valid_mask(snap, state)
        tj = torch.clamp(snap.task_job, 0, snap.num_jobs - 1).long()
        return jv[tj] & (snap.task_job >= 0) & ~besteffort_mask(snap)

    return eligible


def make_preempt_solver(policy, max_iters: int | None = None):
    """(snap, state[, pred, stats]) -> state with victims RELEASING and
    preemptors PIPELINED: phase 1 between jobs, then phase 2 within a
    job.  `stats["preempt_steps"]` receives each phase's loop stats."""
    victim_fn = preempt_victim_fn(policy)
    victim_fn_intra = preempt_victim_fn_intra(policy)
    eligible = preempt_eligible(policy)
    starving = starving_jobs_mask(policy)
    # Phase 2 serves any valid job with pending work — including Ready
    # jobs whose higher-priority members wait behind lower ones.
    wanting = wanting_jobs_mask(policy)

    def solve(snap, state, pred=None, stats: dict | None = None):
        state = policy.setup_state(snap, state)
        if pred is None:
            pred = policy.predicate_mask(snap)
        phases = []
        for vfn, trigger in ((victim_fn, starving), (victim_fn_intra, wanting)):
            st: dict = {}
            state = preemption_rounds(
                snap, state, pred, vfn, trigger, policy.rank_fn, eligible,
                snap.eps, max_iters=max_iters,
                dyn_predicate_row_fn=policy.dyn_predicate_row, stats=st,
            )
            phases.append(st)
        if stats is not None:
            stats["preempt_steps"] = phases
        return state

    return solve


def commit_victim_indices(ssn, victims: np.ndarray, reason: str) -> int:
    """The one victim-commit funnel: clip padding rows, land evictions,
    return how many landed."""
    victims = victims[victims < ssn.meta.num_real_tasks]
    before = len(ssn.evicted)
    ssn.commit_evictions(victims.tolist(), reason)
    return len(ssn.evicted) - before


@register_action
class PreemptAction(Action):
    name = "preempt"
    solver_factory = staticmethod(make_preempt_solver)
    evicting = True    # the cycle reports this action's RELEASING transitions
    evict_reason = "preempted"
