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
   accepted while the node's running request total fits
   (kernel K3 resolve, `kernels/resolve.py`), then a global rank
   watermark and the anti-affinity serialize steps trim the accepted set
   (plain tensor glue);
3. accepted tasks are allocated: per-node deltas land in `node_future`
   (and `node_idle` in the Idle pass), `task_state`/`task_node` are
   written (kernel K3 apply).

The reference package runs the rounds in a device `lax.while_loop`;
PyTorch has none, so the host drives them and reads one `progress` flag
per round.  A round that accepts nothing leaves the state unchanged, so
the loop ends there, exactly like the reference's fixed point.  The
same loop runs the pipelining pass (`use_future=True`): placements
against FutureIdle become PIPELINED and consume no Idle (≙ ssn.Pipeline).

`AllocState` is a plain dataclass the loop updates IN PLACE (the apply
kernel writes its tensors); `init_state` copies the snapshot fields, so
the snapshot itself is never mutated.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from kube_batch_tpu_torch.api.snapshot import SnapshotTensors
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.kernels import lex_rank, propose, resolve

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
    available capacity is accepted (kernel K3 resolve, with
    `one_per_node` / the per-node `serialize_mask` count); then the
    global rank watermark cancels acceptances ranked above the
    best-ranked rejected-but-feasible task, so the hungry task gets
    first pick next round (≙ the reference placing strictly in rank
    order).  See kube_batch_tpu/ops/assignment.py · _resolve_conflicts."""
    T, N = rank.shape[0], avail.shape[0]
    node_key = torch.where(active, prop_node, N)          # inactive sort last
    # K3's own (node, rank) sort: one stable torch.sort of node·T + rank
    s_key, perm = torch.sort(node_key.long() * T + rank.long(), stable=True)
    s_node = torch.div(s_key, T, rounding_mode="floor")
    accept = resolve.resolve(
        perm, s_node, task_req, avail, eps, one_per_node, serialize_mask
    )
    rejected = active & ~accept
    watermark = torch.where(rejected, rank, INT32_MAX).amin()
    kept = accept & (rank < watermark)
    _count_cancelled(cancelled, 0, accept, kept)
    return kept, perm, s_node


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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One auction round up to its apply: every eligible pending task
    proposes (K2), nodes resolve conflicts (K3 resolve), the serialize
    steps trim the accepted set.  `dyn_predicate_fn` gives K2 a bool[T, N]
    mask or the affinity words (`TensorPolicy.auction_dyn_predicate`).
    Returns (accept bool[T], perm, sorted node ids) for `apply_round`;
    nothing is read on the host.  `cancelled` (i64[3], on the device)
    gains the acceptances each step of CANCEL_STEPS cancelled."""
    avail = state.node_future if use_future else state.node_idle
    pending = (state.task_state == int(TaskStatus.PENDING)) & snap.task_mask
    eligible = pending & eligible_fn(snap, state)
    dyn = (
        dyn_predicate_fn(snap, state, not use_future)
        if dyn_predicate_fn is not None else None
    )
    extras = score_spec.extra_terms(snap, state)
    best, cnt, active = propose.propose_best(
        predicate_mask, dyn, snap.task_req, avail, eps, snap.node_mask,
        eligible, state.node_future, snap.node_cap, score_spec, extras,
        score_quantum,
    )
    rank = rank_fn(snap, state)
    k = tie_ordinal(active, rank, cnt)
    prop_node = propose.propose_pick(
        predicate_mask, dyn, snap.task_req, avail, eps, snap.node_mask,
        eligible, state.node_future, snap.node_cap, score_spec, extras,
        score_quantum, best, active, k,
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
        gmask = global_serialize_fn(snap, state)
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
    dyn_predicate_fn=None,     # (snap, state, immediate) -> bool[T, N] | None
    global_serialize_fn=None,  # (snap, state) -> bool[T] | None
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
    terms).  `stats["rounds"]` receives the number of rounds run and
    `stats["cancelled"]` the acceptances each step of CANCEL_STEPS
    cancelled over them (counted on the device, read once)."""
    if max_rounds is None:
        max_rounds = snap.num_tasks
    cancelled = (None if stats is None else
                 torch.zeros(len(CANCEL_STEPS), dtype=torch.int64, device=snap.device))
    rounds = 0
    for _ in range(max_rounds):
        rounds += 1
        accept, perm, s_node = auction_round(
            snap, state, predicate_mask, score_spec, rank_fn, eligible_fn,
            eps, use_future, one_per_node, score_quantum, dyn_predicate_fn,
            global_serialize_fn, domain_serialize_fn, serialize_mask, cancelled,
        )
        if not bool(accept.any()):
            break
        apply_round(snap, state, accept, perm, s_node, use_future)
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
