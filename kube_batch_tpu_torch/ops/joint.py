"""Joint single-solve cycle: the action pipeline as ONE tier loop.

Reference counterpart: kube_batch_tpu/ops/joint.py · joint_rounds — the
configured actions become constraint tiers that a `phase` register walks:
auction tiers (allocate's Idle and FutureIdle passes, backfill, the
gated post-eviction admission sweep) and evict tiers (preempt's two
phases, reclaim).  Each iteration runs one step of the current tier —
an auction round or one eviction-granular Statement step — or, when the
tier is done, advances: an open plan is discarded, the per-tier carry
reset, the phase moved on.  `evict_code` (i32[T], 0 = kept, i+1 =
evicted by conf action i) attributes every eviction; a rolled-back
plan clears its codes.

The reference runs the loop in one device `lax.while_loop` with
`lax.cond` / `lax.switch` between the tiers.  Here the host drives it,
as ops/preemption.py drives the preemption loop, and branches between an
auction step and an evict step.  Each iteration computes the current
tier's masks once (its `eligible_fn`, and an evict tier's
`starving_fn`) and launches kernel K12 (kernels/joint_tier.py) once, fed
by the step it follows (the auction round's accept mask, or the evict
step's flag vector): the tier's work test, the `tier_done =
~progressed | step >= max_steps | ~has_work` test of the reference's
loop body, and, when done, the advance applied in place.  K12 writes
the tier's work mask, which the next step takes in place of computing
the masks again, and packs the step's flags with its own [done,
has_work, phase] into one buffer: the host reads ONE vector per
iteration.  K12 and the tier's masks stay host-launched between the
steps (K12 takes the step count and `step <= 1` from the host).  The
steps themselves are the port's own machinery: ops/assignment.py ·
auction_round / apply_round (K2, K3, the serialize steps, one resident
table build per round) and ops/preemption.py · evict_step (K5, K6, the
plan open / continue branch), each one body of the loop's step graphs
(ops/graphs.py; a graph per tier and branch, captured on the card and
replayed, eager on the CPU) on static state, carry, eviction codes,
work mask and step outputs, with the joint solve's differences kept: a
tier ends when its work test is empty, and an open plan left at a
tier's step bound is discarded by the advance.

Float rules: the discarded plan's request sum is float64, rounded once
(as the preemption loop's); the auction apply is K3's float64 per-node
deltas rounded once, where the reference's joint apply is an fp32
segment sum — equal on integer-valued requests (ROADMAP §C).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import torch

from kube_batch_tpu_torch.api.snapshot import SnapshotTensors
from kube_batch_tpu_torch.kernels import joint_tier as _k12
from kube_batch_tpu_torch.kernels import propose
from kube_batch_tpu_torch.ops import graphs
from kube_batch_tpu_torch.ops.assignment import (
    AllocState,
    apply_round,
    auction_round,
    loop_copy,
)
from kube_batch_tpu_torch.ops.preemption import (
    FLAG_KEYS,
    EvictCarry,
    evict_step,
    land_step,
    new_tally,
    tally_step,
)

MaskFn = Callable[[SnapshotTensors, AllocState], torch.Tensor]


@dataclasses.dataclass(frozen=True, eq=False)
class AuctionPhase:
    """One placement band: an auction-rounds tier (allocate's Idle or
    FutureIdle pass, backfill, or the joint admission sweep).
    `max_steps=None` resolves to the sequential loop's default bound
    (T).  `gated_on_evictions` marks the admission sweep: it only runs
    when a prior tier actually evicted something."""

    score_spec: object        # kernels/propose.py · ScoreSpec
    eligible_fn: MaskFn
    use_future: bool
    max_steps: int | None = None
    score_quantum: float = 0.0
    gated_on_evictions: bool = False
    name: str = "auction"


@dataclasses.dataclass(frozen=True, eq=False)
class EvictPhase:
    """One victim-selection band: Statement steps (preempt phase 1/2 or
    reclaim), attributed to conf action `evict_code - 1`.
    `max_steps=None` resolves to the preemption loop's default bound
    (2T + 4N + 16)."""

    victim_fn: Callable
    starving_fn: MaskFn
    eligible_fn: MaskFn
    evict_code: int
    max_steps: int | None = None
    name: str = "evict"


def _max_steps(ph, T: int, N: int) -> int:
    if ph.max_steps is not None:
        return int(ph.max_steps)
    if isinstance(ph, AuctionPhase):
        return T
    return 2 * T + 4 * N + 16


def joint_rounds(
    snap: SnapshotTensors,
    state: AllocState,
    phases: Sequence[AuctionPhase | EvictPhase],
    predicate_mask: torch.Tensor,   # bool[T, N] static feasibility
    rank_fn: MaskFn,
    eps: torch.Tensor,              # f32[R]
    dyn_predicate_fn=None,          # (snap, state, immediate, resident) -> mask | words | None
    dyn_predicate_row_fn=None,      # (snap, state, p) -> bool[N] | AffinityRow | None
    global_serialize_fn=None,       # (snap, state, resident) -> bool[T] | None
    domain_serialize_fn=None,       # (snap, state) -> bool[T] | None
    serialize_mask: torch.Tensor | None = None,   # bool[T] | None
    stats: dict | None = None,
) -> tuple[AllocState, torch.Tensor]:
    """Run the tier list to completion; returns (state, evict_code).
    `stats["joint_tiers"]` (optional) receives, per tier, its name, kind,
    steps, wall ms and the tasks it placed (auction tiers) or its steps
    by outcome (evict tiers)."""
    T, N = snap.num_tasks, snap.num_nodes
    dev = snap.device
    evict_code = torch.zeros(T, dtype=torch.int32, device=dev)
    if not phases:
        return state, evict_code
    st = loop_copy(state, writes_idle=True)     # the Idle passes write node_idle
    c = EvictCarry.fresh(T, N, dev)
    phase_reg = torch.zeros(1, dtype=torch.int32, device=dev)
    work, read = _k12.tier_buffers(T, dev)
    accept = torch.zeros(T, dtype=torch.bool, device=dev)    # an auction step's
    flags = torch.zeros(len(FLAG_KEYS), dtype=torch.int64, device=dev)  # an evict step's
    scratch = propose.best_scratch(T, N, dev)

    def auction_body(ph):
        def body():
            acc, perm, s_node = auction_round(
                snap, st, predicate_mask, ph.score_spec, rank_fn,
                ph.eligible_fn, eps, ph.use_future, False, ph.score_quantum,
                dyn_predicate_fn, global_serialize_fn, domain_serialize_fn,
                serialize_mask, None, work, scratch,
            )
            apply_round(snap, st, acc, perm, s_node, ph.use_future)
            accept.copy_(acc)
        return body

    def evict_body(ph):
        def body():
            out = evict_step(snap, st, c, predicate_mask, ph.victim_fn,
                             ph.starving_fn, rank_fn, ph.eligible_fn, eps,
                             dyn_predicate_row_fn, work)
            # the codes before the carry moves on: a rollback clears the
            # codes of the plan's victims as they were before this step
            evict_code.masked_fill_(out.is_v, ph.evict_code)
            evict_code.masked_fill_(out.fail & c.prov, 0)
            land_step(st, c, out, flags)
        return body

    bodies = [auction_body(ph) if isinstance(ph, AuctionPhase) else evict_body(ph)
              for ph in phases]
    drv = graphs.loop_graphs(dev)
    step_out = None                  # the last step's accept mask or flags
    phase, step = 0, 0
    tiers = []
    tally, placed = new_tally(), 0
    t0 = time.perf_counter()
    try:
        while phase < len(phases):
            ph = phases[phase]
            auction = isinstance(ph, AuctionPhase)
            _k12.tier_control(
                _k12.AUCTION if auction else _k12.EVICT,
                auction and ph.gated_on_evictions, step, _max_steps(ph, T, N),
                step_out, st.task_state, snap.task_state, snap.task_mask,
                ph.eligible_fn(snap, st),
                None if auction else ph.starving_fn(snap, st),
                snap.task_job, c.tried, c.prov, evict_code, snap.task_req,
                st.node_future, c.excl, phase_reg, work, read, step <= 1,
            )
            f = drv.read(read)           # the iteration's one read
            done = f[_k12.STEP_FLAGS]
            if step_out is not None:
                if auction:
                    placed += f[0]
                else:
                    tally_step(tally, f[:_k12.STEP_FLAGS])
                    c.active = bool(f[1])
            if done:
                # K12 applied the advance: an open plan is discarded and
                # tried / prov / excl are cleared in place; `work` is void
                line = {"tier": ph.name, "kind": "auction" if auction else "evict",
                        "steps": step, "ms": (time.perf_counter() - t0) * 1e3}
                if auction:
                    line["placed"] = placed
                else:
                    line.update({k: v for k, v in tally.items() if k != "steps"})
                tiers.append(line)
                c.active = False
                c.excl_p.fill_(-1)
                step_out = None
                tally, placed = new_tally(), 0
                phase, step = phase + 1, 0
                t0 = time.perf_counter()
                continue
            if auction:
                drv.run((phase, "auction"), bodies[phase])
                step_out = accept
            else:
                drv.run((phase, "continue" if c.active else "open"), bodies[phase])
                step_out = flags
            step += 1
    finally:
        drv.close()
    if stats is not None:
        stats["joint_tiers"] = tiers
    return st, evict_code
