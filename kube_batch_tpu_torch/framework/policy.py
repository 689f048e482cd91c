"""TensorPolicy: the configuration-time half of the session framework.

Reference counterpart: framework/session_plugins.go — the extension
point registries (AddJobOrderFn/AddPredicateFn/AddNodeOrderFn/...) and
their tiered evaluators; the port of kube_batch_tpu/framework/policy.py.

Every registered fn is a plain function over `(SnapshotTensors,
AllocState)`.  Tier semantics are preserved exactly: order fns stack
into lexicographic keys (first decisive tier wins — rank_from_keys), and
AND/OR masks combine as in the reference.

Node-order fns carry a `kind`: "least_requested" and "balanced" are
evaluated inside the propose kernel (K2); every other fn is an additive
term the kernel adds after them (`score_spec`): a [T, N] term the policy
weights, or (kind CLASS_TERM) a `kernels/propose.py · ClassTerm` whose
own kernel applies the weight.
"""

from __future__ import annotations

from typing import Callable

import torch

from kube_batch_tpu_torch.api.snapshot import SnapshotTensors, task_queue_of
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.kernels import lex_rank
from kube_batch_tpu_torch.kernels.affinity import AffinityRow
from kube_batch_tpu_torch.kernels.propose import ScoreSpec
from kube_batch_tpu_torch.ops.assignment import (
    AllocState,
    LexOrder,
    rank_from_keys,
)

#: node-order kinds the propose kernel computes itself
KERNEL_SCORE_KINDS = ("least_requested", "balanced")
#: node-order kind of a fn (snap, state, weight, resident) -> ClassTerm |
#: None that applies the weight in its kernel (nodeorder's pod-affinity
#: score, kernel K13)
CLASS_TERM = "class_term"


def virtual_start_times(
    seg: torch.Tensor,        # i32[T] segment id per task (queue or job)
    base_rank: torch.Tensor,  # i32[T] within-segment service order
    req: torch.Tensor,        # f32[T, R]
    valid: torch.Tensor,      # bool[T] tasks contending for placement now
    alloc_seg: torch.Tensor,  # f32[S, R] resources the segment already holds
    denom_seg: torch.Tensor,  # f32[S, R] fair-share denominator
    num_segs: int,
) -> torch.Tensor:
    """f32[T]: weighted-fair-queueing virtual start times — max over
    resource dims of (alloc_seg + within-segment prefix of earlier
    tasks) / denom (≙ kube_batch_tpu framework/policy.py ·
    virtual_start_times).  The within-segment prefix is float64 (the
    api/snapshot.py precision rule) and rounds once, with the segment's
    allocation, to float32.  Kernel K8's `vtime` (`kernels/lex_rank.py`):
    the sort by (segment, rank) and the scan in one launch up to 16,384
    rows."""
    return lex_rank.vtime(seg, base_rank, req, valid, alloc_seg, denom_seg, num_segs)


class TensorPolicy:
    """Aggregated plugin policy for one SchedulerConf."""

    def __init__(self, num_tiers: int) -> None:
        self.num_tiers = num_tiers
        self.queue_order: list[list[Callable]] = [[] for _ in range(num_tiers)]
        self.namespace_order: list[list[Callable]] = [[] for _ in range(num_tiers)]
        self.job_order: list[list[Callable]] = [[] for _ in range(num_tiers)]
        self.task_order: list[list[Callable]] = [[] for _ in range(num_tiers)]
        self.predicates: list[Callable] = []
        # State-dependent predicates (snap, state, immediate) ->
        # bool[T, N] | None (None = no constraint for this snapshot),
        # re-evaluated every auction round.
        self.dynamic_predicates: list[Callable] = []
        # Their single-task row forms (snap, state, p) -> bool[N] |
        # AffinityRow | None, evaluated once per preemption step.
        self.dynamic_predicate_rows: list[Callable] = []
        # Their words forms (snap, state, immediate, resident) ->
        # AffinityWords | None, or None where a predicate has none.
        self.dynamic_predicate_words: list[Callable | None] = []
        # (snap, state, resident) -> bool[T] | None
        self.global_serialize: list[Callable] = []
        self.domain_serialize: list[Callable] = []
        # Per-node anti-affinity serialization set, snapshot-static:
        # (snap, state) -> bool[T] | None.
        self.node_serialize: list[Callable] = []
        self.node_scores: list[tuple[float, Callable, str | None]] = []
        self.job_valid: list[Callable] = []
        self.job_ready: list[Callable] = []
        self.job_pipelined: list[Callable] = []
        self.overused: list[Callable] = []
        self.queue_vtime: list[list[Callable]] = [[] for _ in range(num_tiers)]
        self.ns_vtime: list[list[Callable]] = [[] for _ in range(num_tiers)]
        self.job_vtime: list[list[Callable]] = [[] for _ in range(num_tiers)]
        self.cycle_setup: list[tuple[str, Callable]] = []
        # Victim vetoes (snap, state, preemptor) -> bool[T], per tier.
        self.preemptable: list[list[Callable]] = [[] for _ in range(num_tiers)]
        self.reclaimable: list[list[Callable]] = [[] for _ in range(num_tiers)]
        self.score_quantum = 0.0
        self.max_rounds: int | None = None
        # (cpu, memory) dims of the balanced-allocation score
        self.balanced_dims: tuple[int, int] = (0, 1)

    # -- registration (≙ session_plugins.go Add*Fn) ---------------------
    def add_queue_order_fn(self, tier: int, fn) -> None:
        self.queue_order[tier].append(fn)

    def add_namespace_order_fn(self, tier: int, fn) -> None:
        self.namespace_order[tier].append(fn)

    def add_namespace_vtime_fn(self, tier: int, fn) -> None:
        self.ns_vtime[tier].append(fn)

    def add_job_order_fn(self, tier: int, fn) -> None:
        self.job_order[tier].append(fn)

    def add_task_order_fn(self, tier: int, fn) -> None:
        self.task_order[tier].append(fn)

    def add_predicate_fn(self, fn) -> None:
        self.predicates.append(fn)

    def add_dynamic_predicate_fn(self, fn, row_fn, words_fn=None) -> None:
        self.dynamic_predicates.append(fn)
        self.dynamic_predicate_rows.append(row_fn)
        self.dynamic_predicate_words.append(words_fn)

    def add_global_serialize_fn(self, fn) -> None:
        self.global_serialize.append(fn)

    def add_domain_serialize_fn(self, fn) -> None:
        self.domain_serialize.append(fn)

    def add_node_serialize_fn(self, fn) -> None:
        self.node_serialize.append(fn)

    def add_node_order_fn(
        self, weight: float, fn, state_dependent: bool = True,
        kind: str | None = None,
    ) -> None:
        """`kind` names a term the propose kernel computes itself
        (KERNEL_SCORE_KINDS) or a class term (CLASS_TERM: the fn takes
        (snap, state, weight, resident) and returns the weighted
        ClassTerm); any other fn (snap, state, resident) returns its
        unweighted f32[T, N] term.  Each returns None when its term is
        exactly zero."""
        self.node_scores.append((weight, fn, kind))
        if state_dependent and self.score_quantum == 0.0:
            self.score_quantum = 0.5

    def add_job_valid_fn(self, fn) -> None:
        self.job_valid.append(fn)

    def add_job_ready_fn(self, fn) -> None:
        self.job_ready.append(fn)

    def add_job_pipelined_fn(self, fn) -> None:
        self.job_pipelined.append(fn)

    def add_preemptable_fn(self, tier: int, fn) -> None:
        self.preemptable[tier].append(fn)

    def add_reclaimable_fn(self, tier: int, fn) -> None:
        self.reclaimable[tier].append(fn)

    def add_overused_fn(self, fn) -> None:
        self.overused.append(fn)

    def add_queue_vtime_fn(self, tier: int, fn) -> None:
        self.queue_vtime[tier].append(fn)

    def add_job_vtime_fn(self, tier: int, fn) -> None:
        self.job_vtime[tier].append(fn)

    def add_cycle_setup_fn(self, name: str, fn) -> None:
        """Register a snapshot-only value computed once per solve and
        carried in AllocState.aux[name]."""
        self.cycle_setup.append((name, fn))

    def setup_state(self, snap: SnapshotTensors, state: AllocState) -> AllocState:
        for name, fn in self.cycle_setup:
            state.aux[name] = fn(snap)
        return state

    # -- evaluators -----------------------------------------------------
    def predicate_mask(self, snap: SnapshotTensors) -> torch.Tensor:
        """bool[T, N]: AND of all plugin predicates."""
        if len(self.predicates) == 1:
            return self.predicates[0](snap)
        m = torch.ones((snap.num_tasks, snap.num_nodes), dtype=torch.bool,
                       device=snap.device)
        for fn in self.predicates:
            m = m & fn(snap)
        return m

    def dynamic_predicate_fn(self, snap, state, immediate: bool = False,
                             resident=None):
        """bool[T, N] AND of the state-dependent predicates, or None when
        none constrains this snapshot (the auction then skips them).
        Every fn, and every score and global-serialize fn, takes
        `resident`: the auction round's `kernels/resident.py ·
        RoundResident`, or None outside a round."""
        m = None
        for fn in self.dynamic_predicates:
            part = fn(snap, state, immediate, resident)
            if part is not None:
                m = part if m is None else m & part
        return m

    def dyn_predicate_words(self, snap, state, immediate: bool = False,
                            resident=None):
        """The dynamic predicates in the words form kernel K2 tests itself
        (`kernels/affinity.py · AffinityWords`) when the only one
        registered is inter-pod affinity; None otherwise, and when it
        does not constrain this snapshot."""
        if len(self.dynamic_predicate_words) != 1:
            return None
        words_fn = self.dynamic_predicate_words[0]
        return None if words_fn is None else words_fn(snap, state, immediate, resident)

    def auction_dyn_predicate(self, snap, state, immediate: bool = False,
                              resident=None):
        """What an auction round hands kernel K2: the words form when the
        policy has one, else the mask of `dynamic_predicate_fn`, or None."""
        words = self.dyn_predicate_words(snap, state, immediate, resident)
        return words if words is not None else self.dynamic_predicate_fn(
            snap, state, immediate, resident)

    @property
    def dyn_predicate_row(self):
        """(snap, state, p) -> bool[N] | AffinityRow | None: the dynamic
        predicates for ONE task (the preemptor of a preemption step; `p`
        may be a 0-dim device tensor), None when none constrains this
        snapshot; the property itself is None when no dynamic predicate
        is registered (≙ kube_batch_tpu framework/policy.py ·
        dyn_predicate_row).  A row fn may give the inter-pod affinity
        operand (`kernels/affinity.py · AffinityRow`), which kernel K5
        tests itself, or a bool[N] row; plain rows are ANDed into the
        operand's mask (a second operand is taken as its row), as kernel
        K2 takes a mask or words."""
        if not self.dynamic_predicate_rows:
            return None
        row_fns = list(self.dynamic_predicate_rows)

        def row(snap, state, p):
            m = None
            for row_fn in row_fns:
                part = row_fn(snap, state, p)
                if part is None:
                    continue
                if m is None:
                    m = part
                elif isinstance(m, AffinityRow):
                    m = m.and_mask(part.row() if isinstance(part, AffinityRow) else part)
                elif isinstance(part, AffinityRow):
                    m = part.and_mask(m)
                else:
                    m = m & part
            return m

        return row

    @staticmethod
    def _or_of(fns_list):
        if not fns_list:
            return None
        fns = list(fns_list)

        def mask(snap, state, *args):
            m = None
            for fn in fns:
                part = fn(snap, state, *args)
                if part is not None:
                    m = part if m is None else m | part
            return m

        return mask

    @property
    def global_serialize_fn(self):
        return self._or_of(self.global_serialize)

    @property
    def domain_serialize_fn(self):
        return self._or_of(self.domain_serialize)

    def serialize_mask(self, snap, state):
        """bool[T] per-node anti-affinity serialization set, or None."""
        return self._or_of(self.node_serialize)(snap, state) \
            if self.node_serialize else None

    def score_spec(self) -> ScoreSpec:
        """The weighted node-order sum (≙ util.PrioritizeNodes) as the
        propose kernel evaluates it: the kernel's own terms first, then
        the additive terms in registration order.  Raises when the
        registration order cannot be expressed that way."""
        w_lr = w_bal = None
        extras = []
        for i, (w, fn, kind) in enumerate(self.node_scores):
            if kind in KERNEL_SCORE_KINDS:
                # Addition is commutative: the kernel's two terms may come
                # in either order, but only ahead of every additive term.
                if i >= 2 or extras:
                    raise NotImplementedError(
                        f"node-order term {kind!r} registered after an "
                        "additive term: the propose kernel sums its own "
                        "terms first"
                    )
                if kind == "least_requested":
                    w_lr = w
                else:
                    w_bal = w
            elif kind == CLASS_TERM:
                extras.append(_weighted_in_kernel(w, fn))
            else:
                extras.append(_weighted(w, fn))
        d0, d1 = self.balanced_dims
        return ScoreSpec(
            w_lr=w_lr, w_bal=w_bal, d0=d0, d1=d1, extra_fns=tuple(extras)
        )

    def rank_fn(self, snap: SnapshotTensors, state: AllocState) -> torch.Tensor:
        """i32[T]: global scheduling-order ranks from the tiered
        queue > job > task lexicographic ordering, with the vtime keys
        slotted in at their own tier (≙ kube_batch_tpu
        framework/policy.py · rank_fn)."""
        tq = task_queue_of(snap).long()
        tj = torch.clamp(snap.task_job, 0, snap.num_jobs - 1).long()
        tns = torch.clamp(snap.task_ns, 0, snap.ns_weight.shape[0] - 1).long()
        vtime_levels = [self.job_vtime, self.ns_vtime, self.queue_vtime]
        valid = None
        if any(any(map(len, level)) for level in vtime_levels):
            pending = (state.task_state == int(TaskStatus.PENDING)) & snap.task_mask
            valid = pending & self.eligible_fn(snap, state)

        # Keys are pushed least significant first; a vtime key takes the
        # rank of the keys pushed before it as its base order.
        order = LexOrder(snap.num_tasks, snap.device)
        order.push(snap.task_order.float())
        for tier_fns in reversed(self.task_order):
            for fn in reversed(tier_fns):
                order.push(fn(snap, state))

        def level(static_fns, vtime_fns, gather):
            for t in range(len(static_fns) - 1, -1, -1):
                for fn in reversed(static_fns[t]):
                    order.push(gather(fn(snap, state)))
                for fn in reversed(vtime_fns[t]):
                    order.push(fn(snap, state, order.rank(), valid))

        level(self.job_order, self.job_vtime, lambda k: k[tj])
        level(self.namespace_order, self.ns_vtime, lambda k: k[tns])
        level(self.queue_order, self.queue_vtime, lambda k: k[tq])
        return order.rank()

    def job_rank(self, snap, state) -> torch.Tensor:
        """i32[J]: job-level ranks (preempt's less-deserving-job gate)."""
        keys: list[torch.Tensor] = [snap.job_order.float()]
        for tier_fns in reversed(self.job_order):
            for fn in reversed(tier_fns):
                keys.append(fn(snap, state))
        return rank_from_keys(keys, snap.num_jobs)

    def job_valid_mask(self, snap, state) -> torch.Tensor:
        m = snap.job_mask
        for fn in self.job_valid:
            m = m & fn(snap, state)
        return m

    def job_ready_mask(self, snap, state) -> torch.Tensor:
        m = snap.job_mask
        for fn in self.job_ready:
            m = m & fn(snap, state)
        return m

    def job_pipelined_mask(self, snap, state) -> torch.Tensor:
        """bool[J] (≙ ssn.JobPipelined): would the gang gate be met once
        pipelined placements land?  A job that waits on releasing
        resources does not preempt."""
        m = snap.job_mask
        for fn in self.job_pipelined:
            m = m & fn(snap, state)
        return m

    def overused_mask(self, snap, state) -> torch.Tensor:
        m = torch.zeros(snap.num_queues, dtype=torch.bool, device=snap.device)
        for fn in self.overused:
            m = m | fn(snap, state)
        return m

    def eligible_fn(self, snap, state) -> torch.Tensor:
        """bool[T]: may this pending task be placed right now — its job
        valid (gang), its queue not overused (proportion)."""
        jv = self.job_valid_mask(snap, state)
        over = self.overused_mask(snap, state)
        tj = torch.clamp(snap.task_job, 0, snap.num_jobs - 1).long()
        tq = task_queue_of(snap).long()
        return jv[tj] & ~over[tq] & (snap.task_job >= 0)

    def _veto_intersection(self, tiers, snap, state, preemptor) -> torch.Tensor:
        """bool[T] victim permission: within the FIRST tier that has any
        registered fn, intersect the plugins' answers; later tiers are
        ignored (≙ session_plugins.go · Preemptable/Reclaimable, which
        return at the first tier whose plugins decided)."""
        for tier_fns in tiers:
            if tier_fns:
                m = torch.ones(snap.num_tasks, dtype=torch.bool, device=snap.device)
                for fn in tier_fns:
                    m = m & fn(snap, state, preemptor)
                return m
        return torch.ones(snap.num_tasks, dtype=torch.bool, device=snap.device)

    def preemptable_mask(self, snap, state, preemptor) -> torch.Tensor:
        return self._veto_intersection(self.preemptable, snap, state, preemptor)

    def reclaimable_mask(self, snap, state, preemptor) -> torch.Tensor:
        return self._veto_intersection(self.reclaimable, snap, state, preemptor)


def _weighted_in_kernel(w: float, fn):
    """(snap, state, resident) -> fn(snap, state, w, resident): a class
    term whose kernel takes the weight as an argument."""

    def term(snap, state, resident=None):
        return fn(snap, state, w, resident)

    return term


def _weighted(w: float, fn):
    """(snap, state, resident) -> w·fn(snap, state, resident) in float32,
    or None when the term is exactly zero for this snapshot.  The weight
    is a float32 CPU scalar made once: a scalar operand of a device
    product, copied to no device (a captured round cannot copy from
    pageable host memory)."""
    w32 = torch.tensor(w, dtype=torch.float32)

    def term(snap, state, resident=None):
        raw = fn(snap, state, resident)
        if raw is None:
            return None
        return w32 * raw

    return term
