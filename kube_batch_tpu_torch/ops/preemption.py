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
  with a plan open on node n (`preempt_continue`), the step's whole
  classification: the sacrifice-first victim on n, whether the preemptor
  fits n now and whether its dynamic row still allows n (p and n read on
  the card, the outputs in a buffer the carry keeps);
* kernel K5 (kernels/victim_prefix.py), when a plan opens, in one
  launch: the candidate victims sorted by (node, sacrifice), per node the
  fewest victims whose release fits, the preemptor's node mask (with its
  inter-pod affinity row, tested in the same launch from the operand
  `dyn_predicate_row_fn` gives), the chosen node and its first victim;
* plain torch glue for the rank (B7), the veto masks and the updates,
  with the segment sums of the vetoes in kernel K7.

The reference runs the steps in a device `lax.while_loop`.  Here a step
is one body of the loop's step graphs (ops/graphs.py): the opening and
the continuing branch are each captured once on the card and replayed on
the same static state and carry (`land_step` writes a step's outputs
back into them inside the graph), and run eagerly on the CPU.  The host
reads ONE small flag vector per step — (progressed, plan still open,
node, outcome) — because a step is not a fixed point once `progressed`
is false: with a preemptor and nothing evictable, a further step could
still open a plan.  `lax.cond(prov_active, ...)` becomes the host's
choice of branch, on the flag read at the end of the previous step; the
direct-fit test is skipped while a plan is open, where it cannot change
a decision.  Every other decision of a step is a device tensor, and no
step reads one on the host (a device scalar indexes through `row_at`).

Float rules: the provisional victims' request sum (`prov_req_sum`) and
K5's prefix are float64, rounded once to float32; FutureIdle updates stay
float32 (exact on integer-valued requests).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from kube_batch_tpu_torch.api.snapshot import SnapshotTensors, row_at
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.kernels import preempt_scan as _k6
from kube_batch_tpu_torch.kernels import victim_prefix as _k5
from kube_batch_tpu_torch.ops import graphs
from kube_batch_tpu_torch.ops.assignment import AllocState, loop_copy

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
    """(k i32[N], out i32[5]) of kernel K5 for a given request and node
    mask: for every node the fewest victims, taken in sacrifice order,
    whose release makes the preemptor fit (0 when it fits with none,
    BIG_K when no prefix does), and the chosen node with its first victim
    (≙ kube_batch_tpu ops/preemption.py · _min_victims_per_node and
    choose_node).  `evict_step` calls K5 itself, with the preemptor's
    row of the request table and of the predicate mask."""
    N = future.shape[0]
    p = torch.zeros((), dtype=torch.int64, device=future.device)
    buf = _k5.victim_prefix(victims, snap.task_node, rank, snap.task_req, future, eps,
                            p, preemptor_req[None, :], ok[None, :], ok,
                            torch.zeros_like(ok), None)
    return buf[:N], buf[N:]


def _request_sum(mask: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """f32[R]: Σ req over masked rows, in float64, rounded once."""
    return torch.where(mask[:, None], req, 0.0).double().sum(0).float()


@dataclasses.dataclass
class EvictCarry:
    """The loop carry between steps, static for the whole loop: `tried`
    latches served preemptors (or those out of nodes), `prov` the open
    plan's provisional victims, `excl` the nodes whose plan failed for
    preemptor `excl_p`; the plan itself (open or not, as the host read
    it; its preemptor and node as device scalars, which no launch reads
    on the host); `scan`, the buffer a continuing step's kernel K6
    writes; the row indices the step compares p, v and n with."""

    tried: torch.Tensor       # bool[T]
    prov: torch.Tensor        # bool[T]
    excl: torch.Tensor        # bool[N]
    excl_p: torch.Tensor      # i64[] (-1: none)
    p: torch.Tensor           # i64[] its preemptor
    n_t: torch.Tensor         # i64[] its node
    idx_t: torch.Tensor       # i64[T] arange
    idx_n: torch.Tensor       # i64[N] arange
    active: bool = False      # a plan is open
    scan: _k6.ContinueBuffer | None = None

    @classmethod
    def fresh(cls, T: int, N: int, device) -> "EvictCarry":
        device = torch.device(device)
        return cls(
            tried=torch.zeros(T, dtype=torch.bool, device=device),
            prov=torch.zeros(T, dtype=torch.bool, device=device),
            excl=torch.zeros(N, dtype=torch.bool, device=device),
            excl_p=torch.full((), -1, dtype=torch.long, device=device),
            p=torch.zeros((), dtype=torch.long, device=device),
            n_t=torch.zeros((), dtype=torch.long, device=device),
            idx_t=torch.arange(T, device=device),
            idx_n=torch.arange(N, device=device),
            scan=_k6.ContinueBuffer(device) if device.type == "cuda" else None,
        )


@dataclasses.dataclass
class StepOut:
    """One step's results, all on the device: the new state and carry
    tensors, the flag vector the host reads — (progressed, plan still
    open, node, opened, finalized, rolled back, no node) — and the
    evicted row and rollback mask for the joint solve's attribution."""

    state: AllocState
    tried: torch.Tensor
    prov: torch.Tensor
    excl: torch.Tensor
    excl_p: torch.Tensor
    p: torch.Tensor
    n_t: torch.Tensor
    flags: torch.Tensor       # i64[7]
    is_v: torch.Tensor        # bool[T] the victim evicted this step
    fail: torch.Tensor        # bool[] the open plan rolled back
    scan: _k6.ContinueBuffer | None = None   # the carry's, passed on


FLAG_KEYS = ("progressed", "evicted", "node", "opened", "finalized",
             "rolled_back", "no_node")


def evict_step(
    snap: SnapshotTensors,
    st: AllocState,
    c: EvictCarry,
    predicate_mask: torch.Tensor,    # bool[T, N]
    victim_mask_fn: VictimMaskFn,
    starving_fn: StarvingFn,
    rank_fn,
    eligible_fn,
    eps: torch.Tensor,
    dyn_predicate_row_fn=None,       # (snap, state, p) -> bool[N] | AffinityRow | None
    elig: torch.Tensor | None = None,
) -> StepOut:
    """One eviction-granular Statement step (≙ the body of
    kube_batch_tpu ops/preemption.py · preemption_rounds, and of the
    evict tiers of ops/joint.py · joint_rounds): open a plan, evict one
    re-validated victim, finalize, or roll back.  Nothing is read on the
    host; the branch between opening and continuing a plan is the host's
    (`c.active`, read at the end of the previous step).  `elig` (bool[T],
    optional) is the preemptor candidates of this state — pending &
    starving[job] & job >= 0 & eligible & ~tried — when the caller has
    them (the joint loop's kernel K12 writes them), in place of calling
    `starving_fn` and `eligible_fn`."""
    N = snap.num_nodes
    dev = snap.device
    idx_t, idx_n = c.idx_t, c.idx_n
    node_ok = snap.node_mask & snap.node_ready
    releasing, pipelined = int(TaskStatus.RELEASING), int(TaskStatus.PIPELINED)
    excl = c.excl
    rank = rank_fn(snap, st)
    if c.active:
        p, n_t = c.p, c.n_t
        have_p = active = torch.ones((), dtype=torch.bool, device=dev)
        opening = no_node = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        if elig is None:
            pending = (st.task_state == int(TaskStatus.PENDING)) & snap.task_mask
            tj = torch.clamp(snap.task_job, 0, snap.num_jobs - 1).long()
            elig = (pending & starving_fn(snap, st)[tj] & (snap.task_job >= 0)
                    & eligible_fn(snap, st) & ~c.tried)
        scan = _k6.preempt_open(
            rank, elig, snap.task_state, st.task_state, snap.task_mask,
            c.prov, snap.task_req, st.node_future, node_ok, eps,
        )
        p = scan[0].long()
        have_p = scan[1].bool()
        any_possible_or_fit = scan[2].bool() | scan[3].bool()
        # failed-node exclusions are scoped to one preemptor
        excl = excl & (p == c.excl_p)
    victims = (victim_mask_fn(snap, st, p) & snap.task_mask
               & (st.task_node >= 0) & ~c.prov)
    preq = row_at(snap.task_req, p)
    dyn_row = (dyn_predicate_row_fn(snap, st, p)
               if dyn_predicate_row_fn is not None else None)
    if c.active:
        # K6: the victim on n, the fit at n and the row's cell at n, one
        # launch reading p and n on the card
        v, any_vic, fit_now, viable = _k6.preempt_continue(
            rank, victims, st.task_node, snap.task_req, st.node_future, eps, p, n_t,
            dyn_row, c.scan)
        if dyn_row is None:
            viable = None
        n = n_t
        progressed_t = have_p
    else:
        # K5: the victims' sort, every node's fewest victims, the node mask
        # predicate_mask[p] & node_ok & ~excl (& dyn_row) and the choice
        out = _k5.victim_prefix(victims, snap.task_node, rank, snap.task_req,
                                st.node_future, eps, p, snap.task_req, predicate_mask,
                                node_ok, excl, dyn_row)[N:]
        n = out[0].long()
        node_found = out[1].bool()
        v, any_vic, fit_now = out[2].long(), out[3].bool(), out[4].bool()
        opening = have_p & node_found
        no_node = have_p & ~node_found
        active = opening
        progressed_t = have_p & any_possible_or_fit
        # an opening step's node passed the preemptor's dynamic row inside
        # K5; a continuing step re-reads the row at its node (K6's viable)
        viable = None
    go = active if viable is None else active & viable
    stuck = ~fit_now & ~any_vic
    finalize = go & fit_now
    evict = go & ~fit_now & any_vic
    fail = active & (stuck if viable is None else ~viable | stuck)

    is_p = idx_t == p
    is_v = (idx_t == v) & evict
    task_state = torch.where(is_v, releasing, st.task_state)
    task_state = torch.where(finalize & is_p, pipelined, task_state)
    # Discard: provisional victims return to their snapshot status
    task_state = torch.where(fail & c.prov, snap.task_state, task_state)
    task_node = torch.where(finalize & is_p, n.to(torch.int32), st.task_node)
    prov_req_sum = _request_sum(c.prov, snap.task_req)
    zero = torch.zeros_like(preq)
    delta = (torch.where(evict, row_at(snap.task_req, v), zero)
             - torch.where(finalize, preq, zero)
             - torch.where(fail, prov_req_sum, zero))
    node_future = st.node_future.index_add(0, n.view(1), delta[None, :])
    closed = finalize | fail
    flags = torch.stack([
        progressed_t.long(), evict.long(), n, opening.long(),
        finalize.long(), fail.long(), no_node.long(),
    ])
    return StepOut(
        state=AllocState(task_state=task_state, task_node=task_node,
                         node_idle=st.node_idle, node_future=node_future,
                         aux=st.aux),
        tried=c.tried | (is_p & (no_node | finalize)),
        prov=~closed & (c.prov | is_v),
        excl=torch.where(fail, excl | (idx_n == n), excl),
        excl_p=p, p=p, n_t=n, flags=flags, is_v=is_v, fail=fail, scan=c.scan,
    )


def land_step(st: AllocState, c: EvictCarry, out: StepOut, flags: torch.Tensor) -> None:
    """Write a step's outputs back into the loop's static state, carry and
    flag vector, which the next step (the next replay) reads."""
    for dst, src in ((st.task_state, out.state.task_state),
                     (st.task_node, out.state.task_node),
                     (st.node_future, out.state.node_future),
                     (c.tried, out.tried), (c.prov, out.prov), (c.excl, out.excl),
                     (c.excl_p, out.excl_p), (c.p, out.p), (c.n_t, out.n_t),
                     (flags, out.flags)):
        dst.copy_(src)


def tally_step(tally: dict, flags: list[int]) -> None:
    """Count a step by its outcome (see `new_tally`)."""
    tally["steps"] += 1
    for key, flag in zip(FLAG_KEYS, flags):
        if key in tally:
            tally[key] += flag


def new_tally() -> dict:
    return {"steps": 0, "opened": 0, "evicted": 0, "finalized": 0,
            "rolled_back": 0, "no_node": 0}


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
    dyn_predicate_row_fn=None,       # (snap, state, p) -> bool[N] | AffinityRow | None
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
    st = loop_copy(state, writes_idle=False)
    c = EvictCarry.fresh(T, N, snap.device)
    flags = torch.zeros(len(FLAG_KEYS), dtype=torch.int64, device=snap.device)

    def step_body():
        out = evict_step(snap, st, c, predicate_mask, victim_mask_fn,
                         starving_fn, rank_fn, eligible_fn, eps,
                         dyn_predicate_row_fn)
        land_step(st, c, out, flags)

    tally = new_tally()
    t0 = time.perf_counter()
    progressed = True
    drv = graphs.loop_graphs(snap.device)
    try:
        while progressed and tally["steps"] < max_iters:
            drv.run("continue" if c.active else "open", step_body)
            f = drv.read(flags)                      # the step's one read
            tally_step(tally, f)
            c.active, progressed = bool(f[1]), bool(f[0])
    finally:
        drv.close()

    if c.active:
        # Truncated mid-plan: apply the Discard once, so truncation can
        # never commit a half-statement.
        prov_req_sum = _request_sum(c.prov, snap.task_req)
        st = AllocState(
            task_state=torch.where(c.prov, snap.task_state, st.task_state),
            task_node=st.task_node, node_idle=st.node_idle,
            node_future=st.node_future.index_add(
                0, c.n_t.view(1), -prov_req_sum[None, :]),
            aux=st.aux,
        )
    if stats is not None:
        tally["ms"] = (time.perf_counter() - t0) * 1e3
        stats.update(tally)
    return st
