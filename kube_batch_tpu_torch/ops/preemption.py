"""Batched transactional preemption: the what-if eviction loop.

Reference counterpart: actions/preempt/preempt.go · Execute and
actions/reclaim/reclaim.go · Execute — serial loops that, per starving
pending task, build a Statement, evict candidate victims ONE BY ONE until
the preemptor fits the node's FutureIdle, then pipeline the preemptor and
Commit — or Discard the Statement when the victims run out first.  The
port of kube_batch_tpu/ops/preemption.py, step for step.

The loop stays serial at eviction granularity: every veto (gang
minMember survival, proportion's deserved floor, DRF share order) depends
on how many victims are already gone.  One step either opens a plan
(picks the rank-first eligible preemptor and the node needing the fewest
victims), evicts one re-validated victim, finalizes (pipelines the
preemptor) the moment it fits, or rolls the plan back when the victims
run out; a failed node is excluded and the preemptor retries on the next
one.  Node visit order is fewest-victims-first, lowest index on ties.

Per step, on the step's device:

* kernel K6 (kernels/preempt_scan.py), one launch: with no plan open
  (`preempt_open`), the rank-first eligible preemptor, whether anything
  is evictable and whether any eligible task fits some node directly;
  with a plan open on node n (`preempt_continue`), the sacrifice-first
  victim on n;
* kernel K5 (kernels/victim_prefix.py), when a plan opens: per node the
  fewest victims whose release fits, the chosen node, its first victim;
* plain torch glue for the rank (B7), the veto masks and the updates,
  with the segment sums of the vetoes in kernel K7.

The reference runs the steps in a device `lax.while_loop`.  Here the host
drives them and reads ONE small flag vector per step — (progressed, plan
still open, preemptor, node, outcome) — because a step is not a fixed
point once `progressed` is false: with a preemptor and nothing evictable,
a further step could still open a plan.  `lax.cond(prov_active, ...)`
becomes a host branch on the flag read at the end of the previous step;
the direct-fit test is skipped while a plan is open, where it cannot
change a decision.  Every other decision of a step is a device tensor.

Float rules: the provisional victims' request sum (`prov_req_sum`) and
K5's prefix are float64, rounded once to float32; FutureIdle updates stay
float32 (exact on integer-valued requests).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from kube_batch_tpu_torch.api.snapshot import SnapshotTensors, fits
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.kernels import preempt_scan as _k6
from kube_batch_tpu_torch.kernels import victim_prefix as _k5
from kube_batch_tpu_torch.ops.assignment import AllocState, sort_by_segment

BIG_K = _k5.BIG_K

# victim_mask_fn(snap, state, p) -> bool[T] candidate victims of preemptor p
VictimMaskFn = Callable[[SnapshotTensors, AllocState, torch.Tensor], torch.Tensor]
# starving_fn(snap, state) -> bool[J] jobs allowed to preempt now
StarvingFn = Callable[[SnapshotTensors, AllocState], torch.Tensor]


def min_victims_per_node(
    snap: SnapshotTensors,
    future: torch.Tensor,         # f32[N, R] FutureIdle as of this step
    victims: torch.Tensor,        # bool[T] candidate victims (on their nodes)
    rank: torch.Tensor,           # i32[T] dense ranks; sacrifice = -rank
    preemptor_req: torch.Tensor,  # f32[R]
    eps: torch.Tensor,
    ok: torch.Tensor,             # bool[N] nodes the plan may open on
) -> tuple[torch.Tensor, torch.Tensor]:
    """(k i32[N], out i32[5]) of kernel K5: for every node the fewest
    victims, taken in sacrifice order, whose release makes the preemptor
    fit (0 when it fits with none, BIG_K when no prefix does), and the
    chosen node with its first victim (≙ kube_batch_tpu
    ops/preemption.py · _min_victims_per_node and choose_node).

    Sacrifice order is -rank; the sort key T-1-rank gives the same order
    within [0, T), as sort_by_segment needs.  Non-victims go to segment
    N and sort last."""
    T = victims.shape[0]
    N = future.shape[0]
    vnode = torch.where(victims, snap.task_node, N)
    perm, s_node = sort_by_segment(vnode, T - 1 - rank, N)
    return _k5.victim_prefix(perm, s_node, snap.task_req, future,
                             preemptor_req, eps, ok)


def _request_sum(mask: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """f32[R]: Σ req over masked rows, in float64, rounded once."""
    return torch.where(mask[:, None], req, 0.0).double().sum(0).float()


@dataclasses.dataclass
class _Plan:
    """Host view of the carry, read once per step."""

    active: bool = False     # a plan is open
    p: torch.Tensor | None = None   # its preemptor (0-dim device tensor)
    n: int = 0               # its node
    n_t: torch.Tensor | None = None


def preemption_rounds(
    snap: SnapshotTensors,
    state: AllocState,
    predicate_mask: torch.Tensor,    # bool[T, N]
    victim_mask_fn: VictimMaskFn,
    starving_fn: StarvingFn,
    rank_fn,
    eligible_fn,
    eps: torch.Tensor,
    max_iters: int | None = None,
    dyn_predicate_row_fn=None,       # (snap, state, p) -> bool[N] | None
    stats: dict | None = None,
) -> AllocState:
    """Serve starving jobs by evicting less-deserving work; returns the
    new AllocState (victims RELEASING, preemptors PIPELINED).

    `max_iters` bounds the steps (2T + 4N + 16 by default, as in the
    reference); an open plan left by truncation is discarded.  `stats`
    (optional dict) receives the step count, the loop's wall time and
    the steps by outcome."""
    T, N = snap.num_tasks, snap.num_nodes
    if max_iters is None:
        max_iters = 2 * T + 4 * N + 16
    dev = snap.device
    idx_t = torch.arange(T, device=dev)
    idx_n = torch.arange(N, device=dev)
    node_ok = snap.node_mask & snap.node_ready
    releasing, pipelined = int(TaskStatus.RELEASING), int(TaskStatus.PIPELINED)
    pending_code = int(TaskStatus.PENDING)

    st = state
    tried = torch.zeros(T, dtype=torch.bool, device=dev)
    prov = torch.zeros(T, dtype=torch.bool, device=dev)
    excl = torch.zeros(N, dtype=torch.bool, device=dev)
    excl_p = torch.full((), -1, dtype=torch.long, device=dev)
    plan = _Plan()
    tally = {"steps": 0, "opened": 0, "evicted": 0, "finalized": 0,
             "rolled_back": 0, "no_node": 0}
    t0 = time.perf_counter()
    progressed = True
    while progressed and tally["steps"] < max_iters:
        rank = rank_fn(snap, st)
        if plan.active:
            p, n_t = plan.p, plan.n_t
            have_p = active = torch.ones((), dtype=torch.bool, device=dev)
            opening = no_node = torch.zeros((), dtype=torch.bool, device=dev)
        else:
            pending = (st.task_state == pending_code) & snap.task_mask
            tj = torch.clamp(snap.task_job, 0, snap.num_jobs - 1).long()
            elig = (pending & starving_fn(snap, st)[tj] & (snap.task_job >= 0)
                    & eligible_fn(snap, st) & ~tried)
            scan = _k6.preempt_open(
                rank, elig, snap.task_state, st.task_state, snap.task_mask,
                prov, snap.task_req, st.node_future, node_ok, eps,
            )
            p = scan[0].long()
            have_p = scan[1].bool()
            any_possible_or_fit = scan[2].bool() | scan[3].bool()
            # failed-node exclusions are scoped to one preemptor
            excl = excl & (p == excl_p)
        victims = (victim_mask_fn(snap, st, p) & snap.task_mask
                   & (st.task_node >= 0) & ~prov)
        preq = snap.task_req[p]
        dyn_row = (dyn_predicate_row_fn(snap, st, p)
                   if dyn_predicate_row_fn is not None else None)
        if plan.active:
            scan = _k6.preempt_continue(rank, victims, st.task_node, plan.n)
            v, any_vic = scan[0].long(), scan[1].bool()
            fit_now = fits(preq, st.node_future[plan.n], eps)
            n = n_t
            progressed_t = have_p
        else:
            ok = predicate_mask[p] & node_ok & ~excl
            if dyn_row is not None:
                ok = ok & dyn_row
            _k, out = min_victims_per_node(snap, st.node_future, victims, rank,
                                           preq, eps, ok)
            n = out[0].long()
            node_found = out[1].bool()
            v, any_vic, fit_now = out[2].long(), out[3].bool(), out[4].bool()
            opening = have_p & node_found
            no_node = have_p & ~node_found
            active = opening
            progressed_t = have_p & any_possible_or_fit
        viable = (dyn_row[n] if dyn_row is not None
                  else torch.ones((), dtype=torch.bool, device=dev))
        finalize = active & viable & fit_now
        evict_step = active & viable & ~fit_now & any_vic
        fail = active & (~viable | (~fit_now & ~any_vic))

        is_p = idx_t == p
        is_v = (idx_t == v) & evict_step
        task_state = torch.where(is_v, releasing, st.task_state)
        task_state = torch.where(finalize & is_p, pipelined, task_state)
        # Discard: provisional victims return to their snapshot status
        task_state = torch.where(fail & prov, snap.task_state, task_state)
        task_node = torch.where(finalize & is_p, n.to(torch.int32), st.task_node)
        prov_req_sum = _request_sum(prov, snap.task_req)
        zero = torch.zeros_like(preq)
        delta = (torch.where(evict_step, snap.task_req[v], zero)
                 - torch.where(finalize, preq, zero)
                 - torch.where(fail, prov_req_sum, zero))
        node_future = st.node_future.index_add(0, n.view(1), delta[None, :])
        st = AllocState(task_state=task_state, task_node=task_node,
                        node_idle=st.node_idle, node_future=node_future,
                        aux=st.aux)

        closed = finalize | fail
        tried = tried | (is_p & (no_node | finalize))
        prov = ~closed & (prov | is_v)
        excl = torch.where(fail, excl | (idx_n == n), excl)
        excl_p = p
        flags = torch.stack([
            progressed_t.long(), evict_step.long(), n, opening.long(),
            finalize.long(), fail.long(), no_node.long(),
        ]).tolist()                                   # the step's one sync
        tally["steps"] += 1
        tally["opened"] += flags[3]
        tally["evicted"] += flags[1]
        tally["finalized"] += flags[4]
        tally["rolled_back"] += flags[5]
        tally["no_node"] += flags[6]
        progressed = bool(flags[0])
        plan = _Plan(active=bool(flags[1]), p=p, n=flags[2], n_t=n)

    if plan.active:
        # Truncated mid-plan: apply the Discard once, so truncation can
        # never commit a half-statement.
        prov_req_sum = _request_sum(prov, snap.task_req)
        st = AllocState(
            task_state=torch.where(prov, snap.task_state, st.task_state),
            task_node=st.task_node, node_idle=st.node_idle,
            node_future=st.node_future.index_add(
                0, plan.n_t.view(1), -prov_req_sum[None, :]),
            aux=st.aux,
        )
    if stats is not None:
        tally["ms"] = (time.perf_counter() - t0) * 1e3
        stats.update(tally)
    return st
