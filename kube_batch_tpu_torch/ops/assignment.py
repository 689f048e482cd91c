"""Batched assignment: the allocate hot loop as host-driven auction rounds.

Reference counterpart: actions/allocate/allocate.go · Execute — a serial
loop (per queue → per job → per task) where each task runs PredicateNodes
+ PrioritizeNodes over all nodes and each placement mutates node Idle for
the next task.

Each auction round, as [T, N] tensor work on the snapshot's device:

1. every eligible pending task *proposes* its best feasible node — the
   (r mod k)-th of its k score-tied best nodes, r being its dense rank
   among active proposers (kernel K2, `kernels/propose.py`);
2. nodes resolve conflicts: proposers sorted by (node, global rank) are
   accepted while the node's running request total fits, and a global
   rank watermark trims the accepted set (kernel K3 resolve,
   `kernels/resolve.py`, one launch); the anti-affinity serialize steps
   trim it further (plain tensor glue);
3. accepted tasks are allocated: per-node deltas land in `node_future`
   (and `node_idle` in the Idle pass), `task_state`/`task_node` are
   written (kernel K3 apply).

The reference package runs the rounds in a device `lax.while_loop`.
Here a round (proposal, resolve, serialize steps and apply) is one body
of the loop's step graphs (ops/graphs.py): captured once on the card
and replayed, run eagerly on the CPU.  A round that accepts nothing
leaves the state unchanged, the reference's fixed point, so rounds run
in chunks of 1, 2, 4, ... up to the loop's chunk cap with ONE host read a
chunk: a device `done` flag gates every round of a chunk that starts
after the fixed point (it accepts, cancels and counts nothing), so
`rounds` and `cancelled` are the reference's.  The same loop runs the
pipelining pass (`use_future=True`): placements against FutureIdle
become PIPELINED and consume no Idle (≙ ssn.Pipeline).

`AllocState` is a plain dataclass; `allocate_rounds` updates the one it
is given IN PLACE (its rounds write static copies, copied back at the
end); `init_state` copies the snapshot fields, so the snapshot itself is
never mutated.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from kube_batch_tpu_torch.api.snapshot import SnapshotTensors
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.kernels import lex_rank, propose, resolve
from kube_batch_tpu_torch.kernels.resident import RoundResident
from kube_batch_tpu_torch.ops import graphs

NEG_INF = -1e30
INT32_MAX = 2**31 - 1
#: the steps of a round that cancel acceptances, in `stats["cancelled"]`
CANCEL_STEPS = ("resolve_watermark", "domain_serialize", "global_serialize")


def _count_cancelled(cancelled, step: int, before, after) -> None:
    """Add the acceptances `step` cancelled to the device counter."""
    if cancelled is not None:
        cancelled.narrow(0, step, 1).add_(torch.count_nonzero(before & ~after))


@dataclasses.dataclass
class AllocState:
    """The live placement state a cycle threads through its actions —
    the tensor analog of the Session's mutated Jobs/Nodes maps.

    `node_future` shadows FutureIdle (idle + releasing − pipelined
    placements); pipelined tasks consume it without touching `node_idle`.
    `aux` carries per-cycle plugin tensors computed once by
    `TensorPolicy.setup_state` (e.g. proportion's water-filled
    `deserved`)."""

    task_state: torch.Tensor   # i32[T]
    task_node: torch.Tensor    # i32[T]
    node_idle: torch.Tensor    # f32[N, R]
    node_future: torch.Tensor  # f32[N, R]
    aux: dict = dataclasses.field(default_factory=dict)


def loop_copy(state: AllocState, writes_idle: bool) -> AllocState:
    """The static copy of a state that a loop's bodies write (the step
    graphs' buffers, ops/graphs.py): task_state, task_node, node_future,
    and node_idle when the loop writes it (else shared, as `aux` is)."""
    return AllocState(
        task_state=state.task_state.clone(), task_node=state.task_node.clone(),
        node_idle=state.node_idle.clone() if writes_idle else state.node_idle,
        node_future=state.node_future.clone(), aux=state.aux)


def init_state(snap: SnapshotTensors) -> AllocState:
    return AllocState(
        task_state=snap.task_state.clone(),
        task_node=snap.task_node.clone(),
        node_idle=snap.node_idle.clone(),
        node_future=snap.node_idle + snap.node_releasing,
    )


RankFn = Callable[[SnapshotTensors, AllocState], torch.Tensor]
EligibleFn = Callable[[SnapshotTensors, AllocState], torch.Tensor]


class LexOrder:
    """Chained stable sorts, least significant key first: after keys
    k0..km have been pushed, `rank()` is the dense rank of lexsort over
    them (the LAST key is the primary), full ties kept in index order.
    Pushing one more key continues the same chain, so a caller that
    needs the rank of a prefix of its keys (rank_fn's vtime keys) sorts
    each key once.  `push` queues a key; `rank()` (and `perm`) apply the
    queued run of keys in one call of kernel K8
    (`kernels/lex_rank.py · lex_push_many`), which also yields the rank."""

    def __init__(self, num: int, device) -> None:
        self.num, self.device = num, device
        self._perm: torch.Tensor | None = None   # None: the identity
        self._rank: torch.Tensor | None = None
        self._queue: list[torch.Tensor] = []

    def push(self, key: torch.Tensor) -> None:
        self._queue.append(key)

    def _flush(self) -> None:
        if self._queue:
            self._perm, self._rank = lex_rank.lex_push_many(self._perm, self._queue)
            self._queue = []

    @property
    def perm(self) -> torch.Tensor:
        self._flush()
        if self._perm is None:
            self._perm = torch.arange(self.num, device=self.device)
        return self._perm

    def rank(self) -> torch.Tensor:
        self._flush()
        if self._rank is None:
            self._rank = torch.arange(self.num, dtype=torch.int32, device=self.device)
        return self._rank


def rank_from_keys(keys: list[torch.Tensor], num: int) -> torch.Tensor:
    """Tiered lexicographic keys (least significant first) → dense ranks
    (i32[num], 0 = first), in one K8 call."""
    order = LexOrder(num, keys[0].device)
    for k in keys:
        order.push(k)
    return order.rank()


def sort_by_segment(
    seg: torch.Tensor, rank: torch.Tensor, num_segments: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable sort by (seg, rank) with seg in [0, num_segments] and rank in
    [0, T): the order of lexsort((rank, seg)), as one radix sort of the
    int64 key seg·T + rank (kernel K8).  Returns (perm, sorted segment
    ids)."""
    return lex_rank.sort_by_segment(seg, rank, num_segments)


def tie_ordinal(
    active: torch.Tensor, rank: torch.Tensor, ties: torch.Tensor
) -> torch.Tensor:
    """i32[T]: which of its tied best nodes each task proposes — its
    dense rank among active proposers (stable sort of rank) mod its tie
    count, so m equal tasks facing the same m-way tie take m different
    nodes in one round (≙ _round_robin_proposals)."""
    T = active.shape[0]
    order = torch.argsort(torch.where(active, rank, INT32_MAX), stable=True)
    active_rank = torch.empty(T, dtype=torch.int32, device=active.device)
    active_rank[order] = torch.arange(T, dtype=torch.int32, device=active.device)
    return torch.remainder(active_rank, torch.clamp(ties, min=1))


def resolve_conflicts(
    prop_node: torch.Tensor,   # i32[T] proposed node (0 where ~active)
    active: torch.Tensor,      # bool[T]
    rank: torch.Tensor,        # i32[T]
    task_req: torch.Tensor,    # f32[T, R]
    avail: torch.Tensor,       # f32[N, R]
    eps: torch.Tensor,         # f32[R]
    one_per_node: bool = False,
    serialize_mask: torch.Tensor | None = None,  # bool[T]
    cancelled: torch.Tensor | None = None,       # i64[len(CANCEL_STEPS)]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """bool[T]: which proposals are accepted this round, plus the
    (perm, sorted node ids) of the (node, rank) sort for the apply step.

    Per node, the best-ranked prefix whose cumulative request fits the
    available capacity is accepted (with `one_per_node` / the per-node
    `serialize_mask` count); then the global rank watermark cancels
    acceptances ranked above the best-ranked rejected-but-feasible task,
    so the hungry task gets first pick next round (≙ the reference
    placing strictly in rank order), and `cancelled[0]` gains what it
    cancelled.  All of it, the sort included, is one call of kernel K3
    (`kernels/resolve.py · resolve`); nothing is read on the host.  See
    kube_batch_tpu/ops/assignment.py · _resolve_conflicts."""
    return resolve.resolve(prop_node, active, rank, task_req, avail, eps,
                           one_per_node, serialize_mask, cancelled)


def auction_round(
    snap: SnapshotTensors,
    state: AllocState,
    predicate_mask: torch.Tensor,   # bool[T, N] static feasibility
    score_spec,                     # propose.ScoreSpec
    rank_fn: RankFn,
    eligible_fn: EligibleFn,
    eps: torch.Tensor,              # f32[R]
    use_future: bool = False,
    one_per_node: bool = False,
    score_quantum: float = 0.0,
    dyn_predicate_fn=None,
    global_serialize_fn=None,
    domain_serialize_fn=None,
    serialize_mask: torch.Tensor | None = None,
    cancelled: torch.Tensor | None = None,
    eligible: torch.Tensor | None = None,
    scratch: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One auction round up to its apply: every eligible pending task
    proposes (K2), nodes resolve conflicts (K3 resolve), the serialize
    steps trim the accepted set.  `dyn_predicate_fn` gives K2 a bool[T, N]
    mask or the affinity words (`TensorPolicy.auction_dyn_predicate`).
    The dynamic predicate, the score terms and the global serialize set
    share one `RoundResident`: the first of them that reads the resident
    tables builds them (kernel K11), once a round and never past its
    apply, which writes the state.
    `eligible` (bool[T], optional) is this state's pending & eligible
    mask when the caller has it (the joint loop's kernel K12 writes it),
    in place of calling `eligible_fn`.  Returns (accept bool[T], perm,
    sorted node ids) for `apply_round`; nothing is read on the host.
    `cancelled` (i64[3], on the device) gains the acceptances each step
    of CANCEL_STEPS cancelled.  `scratch` is K2's (`propose.best_scratch`,
    kept by the loop; None: one of the round's own)."""
    avail = state.node_future if use_future else state.node_idle
    if eligible is None:
        pending = (state.task_state == int(TaskStatus.PENDING)) & snap.task_mask
        eligible = pending & eligible_fn(snap, state)
    resident = RoundResident(with_now=not use_future)
    dyn = (
        dyn_predicate_fn(snap, state, not use_future, resident)
        if dyn_predicate_fn is not None else None
    )
    extras = score_spec.extra_terms(snap, state, resident)
    # pass 1 leaves the eligible list and its tie summaries here for pass 2
    if scratch is None:
        scratch = propose.best_scratch(snap.num_tasks, snap.num_nodes, snap.device)
    best, cnt, active = propose.propose_best(
        predicate_mask, dyn, snap.task_req, avail, eps, snap.node_mask,
        eligible, state.node_future, snap.node_cap, score_spec, extras,
        score_quantum, scratch,
    )
    rank = rank_fn(snap, state)
    k = tie_ordinal(active, rank, cnt)
    prop_node = propose.propose_pick(
        predicate_mask, dyn, snap.task_req, avail, eps, snap.node_mask,
        eligible, state.node_future, snap.node_cap, score_spec, extras,
        score_quantum, best, active, k, scratch,
    )
    accept, perm, s_node = resolve_conflicts(
        prop_node, active, rank, snap.task_req, avail, eps,
        one_per_node=one_per_node, serialize_mask=serialize_mask,
        cancelled=cancelled,
    )
    if domain_serialize_fn is not None and snap.node_key_domain.shape[1]:
        kept = _domain_serialize(
            snap, state, accept, prop_node, rank, domain_serialize_fn
        )
        _count_cancelled(cancelled, 1, accept, kept)
        accept = kept
    if global_serialize_fn is not None:
        gmask = global_serialize_fn(snap, state, resident)
        if gmask is not None:
            kept = _global_serialize(accept, rank, gmask)
            _count_cancelled(cancelled, 2, accept, kept)
            accept = kept
    return accept, perm, s_node


def apply_round(snap, state, accept, perm, s_node, use_future: bool) -> None:
    """Allocate the accepted proposals in place (K3 apply): per-node
    deltas into node_future (and node_idle in the Idle pass), the task
    rows' state and node.  A round that accepted nothing changes
    nothing."""
    new_status = int(TaskStatus.PIPELINED if use_future else TaskStatus.ALLOCATED)
    resolve.apply(
        perm, s_node, accept, snap.task_req, state.node_future,
        state.node_idle, use_future, new_status, state.task_state,
        state.task_node,
    )


def allocate_rounds(
    snap: SnapshotTensors,
    state: AllocState,
    predicate_mask: torch.Tensor,   # bool[T, N] static feasibility
    score_spec,                     # propose.ScoreSpec
    rank_fn: RankFn,
    eligible_fn: EligibleFn,
    eps: torch.Tensor,              # f32[R]
    use_future: bool = False,
    max_rounds: int | None = None,
    one_per_node: bool = False,
    score_quantum: float = 0.0,
    dyn_predicate_fn=None,     # (snap, state, immediate, resident) -> mask | words | None
    global_serialize_fn=None,  # (snap, state, resident) -> bool[T] | None
    domain_serialize_fn=None,  # (snap, state) -> bool[T] | None
    serialize_mask: torch.Tensor | None = None,  # bool[T] | None
    stats: dict | None = None,
) -> AllocState:
    """Run auction rounds to a fixed point (≙ kube_batch_tpu
    ops/assignment.py · allocate_rounds), updating `state` in place.

    `max_rounds` defaults to T: ≥1 task is accepted per round until the
    fixed point.  `score_quantum` > 0 floors scores to that grid before
    the argmax, so near-equal nodes tie and round-robin dealing spreads
    proposals across them.  `serialize_mask` is the anti-affinity
    per-node serialization set (None when the snapshot has no such
    terms).  `stats["rounds"]` receives the number of rounds run, the
    last one (which accepts nothing) included, and `stats["cancelled"]`
    the acceptances each step of CANCEL_STEPS cancelled over them
    (counted on the device, read once).

    Each round is the body `round_body` below, run by the loop's step
    graphs (ops/graphs.py) on static copies of the state, in chunks of 1,
    2, 4, ... rounds (at most the step graphs' `chunk_cap`, never past
    `max_rounds`) with one read of `ctl` = [done, rounds] a chunk.  A
    round that starts with `done` set is gated: it accepts nothing and
    adds nothing to `cancelled` or to the round count.  Any other round
    counts, and sets `done` when it accepts nothing."""
    if max_rounds is None:
        max_rounds = snap.num_tasks
    dev = snap.device
    st = loop_copy(state, writes_idle=not use_future)
    ctl = torch.zeros(2, dtype=torch.int64, device=dev)     # [done, rounds]
    cancelled = round_cancelled = None
    if stats is not None:
        cancelled = torch.zeros(len(CANCEL_STEPS), dtype=torch.int64, device=dev)
        round_cancelled = torch.zeros_like(cancelled)
    scratch = propose.best_scratch(snap.num_tasks, snap.num_nodes, dev)

    def round_body():
        if round_cancelled is not None:
            round_cancelled.zero_()
        accept, perm, s_node = auction_round(
            snap, st, predicate_mask, score_spec, rank_fn, eligible_fn,
            eps, use_future, one_per_node, score_quantum, dyn_predicate_fn,
            global_serialize_fn, domain_serialize_fn, serialize_mask,
            round_cancelled, None, scratch,
        )
        live = ctl[0] == 0
        accept = accept & live
        apply_round(snap, st, accept, perm, s_node, use_future)
        if cancelled is not None:
            cancelled.add_(round_cancelled * live)
        ctl[1:].add_(live.long())
        ctl[:1].bitwise_or_((~accept.any()).long())

    drv = graphs.loop_graphs(dev)
    ran, chunk, rounds = 0, 1, 0
    try:
        while ran < max_rounds:
            k = min(chunk, max_rounds - ran)
            for _ in range(k):
                drv.run("round", round_body)
            ran += k
            done, rounds = drv.read(ctl)             # the chunk's one read
            if done:
                break
            chunk = min(2 * chunk, drv.chunk_cap)
    finally:
        drv.close()
    for a, b in ((state.task_state, st.task_state), (state.task_node, st.task_node),
                 (state.node_idle, st.node_idle), (state.node_future, st.node_future)):
        if a is not b:
            a.copy_(b)
    if stats is not None:
        stats["rounds"] = rounds
        stats["cancelled"] = dict(zip(CANCEL_STEPS, cancelled.tolist()))
    return state


def _domain_serialize(snap, state, accept, prop_node, rank, domain_serialize_fn):
    """At most ONE domain-anti-involved task lands per topology DOMAIN
    per round; the rank watermark is re-applied after cancellation
    (≙ the reference loop body's domain-serialize step)."""
    part_mask = domain_serialize_fn(snap, state)
    if part_mask is None:
        return accept
    D = snap.domain_mask.shape[0]
    node_of = torch.clamp(prop_node, 0, snap.num_nodes - 1).long()
    for tk in range(snap.node_key_domain.shape[1]):
        part = part_mask & accept
        dom = snap.node_key_domain[node_of, tk]
        seg = torch.where(part, dom, D).long()
        minr = torch.full((D + 1,), INT32_MAX, dtype=torch.int32,
                          device=rank.device)
        minr = minr.scatter_reduce(
            0, seg, torch.where(part, rank, INT32_MAX), reduce="amin",
        )[:D]
        keep = ~part | (rank == minr[torch.clamp(dom, 0, D - 1).long()])
        cancelled = accept & ~keep
        accept = accept & keep
        min_cancelled = torch.where(cancelled, rank, INT32_MAX).amin()
        accept = accept & (rank < min_cancelled)
    return accept


def _global_serialize(accept, rank, gmask):
    """At most ONE globally-serialized task (affinity bootstrap claimant)
    lands per round: the rank-first ACCEPTED claimant is kept, and the
    rank watermark is re-applied after cancellation."""
    gmask = gmask & accept
    best_g = torch.where(gmask, rank, INT32_MAX).amin()
    cancelled = gmask & (rank != best_g)
    accept = accept & (~gmask | (rank == best_g))
    min_cancelled = torch.where(cancelled, rank, INT32_MAX).amin()
    return accept & (rank < min_cancelled)
