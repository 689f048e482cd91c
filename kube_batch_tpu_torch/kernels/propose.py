"""K2 · propose (CUDA C++, `csrc/propose.cu`), two entry points.

Replaces the propose half of kube_batch_tpu/ops/assignment.py ·
allocate_rounds, the least_requested / balanced terms of
plugins/nodeorder.py summed by framework/policy.py · score_fn, and
_round_robin_proposals.  What bounds it on the card and what its design
does about that is noted in the source.

* `propose_best` (pass 1): per task row, the max masked score, the count
  of feasible nodes tied at it, and whether any node is feasible.
* `propose_pick` (pass 2): per active row, the (k+1)-th tied node in node
  order; 0 for inactive rows.

On the card the two passes share one scratch buffer (`best_scratch(T, N,
device)`, sized from T and N only): pass 1 lists the eligible rows there
and leaves each listed row's (max, ties) over every CHUNK_N nodes, and
pass 2 reads them to rescore only the chunk that holds the chosen tie.
Both take it as their last argument; pass 1 allocates its own when given
None, pass 2 raises without one.  On the CPU it is None and ignored.
`pick_by_chunks_plain` renders pass 2's selection from the summaries.

`dyn`, the dynamic predicate, is None, a bool[T, N] mask, or the inter-pod
affinity predicate as `kernels/affinity.py · AffinityWords`, whose cells
the kernel tests itself (K10's cell test, in K2's tiles).

The score is `((0 + w_lr·lr) + w_bal·bal) + extra0 + extra1`, where the
two node-order terms are computed on the fly and the extras are
precomputed, already weighted terms: a f32[T, N] tensor (node affinity,
computed once a cycle), or a `ClassTerm`, a table f32[C, N] with each
task's class cls i32[T], read at row cls[t] (the pod-affinity score,
kernel K13's table, one row per class of preference rows).  The plain versions below repeat the kernel's arithmetic in the
same order, one resource dim at a time, so both are bit-identical to
each other and to the reference on CPU.

Each wrapper runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from kube_batch_tpu_torch.kernels import build
from kube_batch_tpu_torch.kernels.affinity import (
    AffinityWords,
    affinity_cells_plain,
    words,
)

NEG_INF = -1e30
MAX_SCORE = 10.0
#: Rows per chunk of the plain version (bounds its [rows, N] temporaries).
PLAIN_ROWS = 4096
#: pass 1's listed rows per work item, and the work items it splits the
#: row groups into at most beyond one each (csrc/propose.cu)
BEST_ROWS = 32
BEST_ITEMS_TARGET = 1024
#: nodes of a tie summary pass 1 leaves for pass 2: a warp's share of a
#: node tile (csrc/propose.cu · CHUNK_N)
CHUNK_N = 32


@dataclasses.dataclass(frozen=True)
class ClassTerm:
    """An additive, already weighted score term held once per class of
    task rows: row t of the term is `table[cls[t]]` (table f32[C, N], cls
    i32[T]).  The kernel reads the row in place; the plain version
    gathers the rows it scores."""

    table: torch.Tensor
    cls: torch.Tensor

    def rows(self, sl) -> torch.Tensor:
        """f32[rows, N]: the term's rows `sl`."""
        return self.table[self.cls[sl].long()]

    def dense(self) -> torch.Tensor:
        """f32[T, N]: the term as a tensor (tests and yardsticks)."""
        return self.table[self.cls.long()]


def chunk_ties_bytes(chunk: int = CHUNK_N) -> int:
    """Bytes of a summary's tie count: u8 below 256 nodes, else u16."""
    return 1 if chunk < 256 else 2


def best_scratch_bytes(T: int, N: int, chunk: int = CHUNK_N) -> int:
    """Scratch of the two passes (csrc/propose.cu · scratch_layout): the
    count, the eligible rows' list, a counter per row group, the partials
    of split row groups, and each listed row's chunk summaries (max f32
    and a tie count per `chunk` nodes; a build of propose.cu with another
    CHUNK_N takes its own)."""
    def align(n):
        return (n + 255) // 256 * 256

    groups = -(-T // BEST_ROWS)
    P = BEST_ROWS * (groups + BEST_ITEMS_TARGET)
    TC = T * -(-N // chunk)
    return (256 + align(T * 4) + align(groups * 4) + 2 * align(P * 4) + align(P)
            + align(TC * 4) + TC * chunk_ties_bytes(chunk))


def best_scratch(T: int, N: int, device) -> torch.Tensor | None:
    """The scratch of one round's two passes on the card (None on the
    CPU, whose plain versions need none)."""
    if torch.device(device).type == "cpu":
        return None
    return torch.empty(best_scratch_bytes(T, N), dtype=torch.uint8, device=device)


@dataclasses.dataclass(frozen=True)
class ScoreSpec:
    """The node-order score in a form the kernel can evaluate.

    `w_lr` / `w_bal` weight the least-requested and balanced-allocation
    terms (None = not registered); `extra_fns` are callables
    `(snap, state, resident=None) -> f32[T, N] | ClassTerm | None`
    returning an already weighted additive term, or None when the term is exactly
    zero for this snapshot (`resident`: the auction round's
    `kernels/resident.py · RoundResident`, or None).  An empty spec is
    the zero score (backfill)."""

    w_lr: float | None = None
    w_bal: float | None = None
    d0: int = 0
    d1: int = 1
    extra_fns: tuple = ()

    def extra_terms(self, snap, state, resident=None) -> list:
        out = []
        for fn in self.extra_fns:
            term = fn(snap, state, resident)
            if term is not None:
                out.append(term)
        return out


def quantum_scale(score_quantum: float) -> float:
    """The float32 multiplier of the score floor: 1/quantum rounded to
    float32, as the reference's weak-typed Python float is (0 = off)."""
    return float(np.float32(1.0 / score_quantum)) if score_quantum > 0.0 else 0.0


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def masked_scores_plain(
    pred, dyn, req, avail, eps, node_mask, eligible, future, cap,
    spec: ScoreSpec, extras, inv_q: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(feas bool[T, N], masked and floored score f32[T, N]) for the rows
    given — the kernel's per-cell arithmetic in the same order."""
    dev = req.device
    R = req.shape[1]
    feas = pred & node_mask[None, :] & eligible[:, None]
    if isinstance(dyn, AffinityWords):
        feas = feas & affinity_cells_plain(dyn)
    elif dyn is not None:
        feas = feas & dyn
    for r in range(R):
        feas = feas & ((req[:, None, r] <= avail[None, :, r])
                       | (req[:, None, r] < eps[r]))
    s = torch.zeros(feas.shape, dtype=torch.float32, device=dev)
    if spec.w_lr is not None:
        num = torch.zeros_like(s)
        cnt = torch.zeros((req.shape[0], 1), dtype=torch.float32, device=dev)
        for r in range(R):
            idle_after = future[None, :, r] - req[:, None, r]
            frac = torch.clamp(idle_after, min=0.0) / torch.clamp(
                cap[None, :, r], min=1e-9
            )
            w = (req[:, r] > 0.0).float()[:, None]
            num = num + frac * w
            cnt = cnt + w
        lr = num / torch.clamp(cnt, min=1.0) * _f32(MAX_SCORE, dev)
        s = s + _f32(spec.w_lr, dev) * lr
    if spec.w_bal is not None and R >= 2:
        fr = []
        for r in (spec.d0, spec.d1):
            used_after = (cap[None, :, r] - future[None, :, r]) + req[:, None, r]
            fr.append(torch.clamp(
                used_after / torch.clamp(cap[None, :, r], min=1e-9), 0.0, 1.0
            ))
        bal = (1.0 - torch.abs(fr[0] - fr[1])) * _f32(MAX_SCORE, dev)
        s = s + _f32(spec.w_bal, dev) * bal
    for term in extras:
        s = s + term
    s = torch.where(feas, s, _f32(NEG_INF, dev))
    if inv_q > 0.0:
        s = torch.floor(s * _f32(inv_q, dev))
    return feas, s


def _row_chunks(T: int):
    for lo in range(0, T, PLAIN_ROWS):
        yield slice(lo, min(T, lo + PLAIN_ROWS))


def _chunk_args(rows, pred, dyn, req, eligible, extras):
    if isinstance(dyn, AffinityWords):
        dyn = dyn.rows(rows)
    elif dyn is not None:
        dyn = dyn[rows]
    return pred[rows], dyn, req[rows], eligible[rows], [
        e.rows(rows) if isinstance(e, ClassTerm) else e[rows] for e in extras]


def propose_best_plain(pred, dyn, req, avail, eps, node_mask, eligible,
                       future, cap, spec, extras, score_quantum):
    inv_q = quantum_scale(score_quantum)
    T = req.shape[0]
    best = torch.empty(T, dtype=torch.float32, device=req.device)
    ties = torch.empty(T, dtype=torch.int32, device=req.device)
    active = torch.empty(T, dtype=torch.bool, device=req.device)
    for rows in _row_chunks(T):
        p, d, q, e, x = _chunk_args(rows, pred, dyn, req, eligible, extras)
        feas, s = masked_scores_plain(
            p, d, q, avail, eps, node_mask, e, future, cap, spec, x, inv_q
        )
        b = s.max(dim=1).values
        best[rows] = b
        ties[rows] = (feas & (s >= b[:, None])).sum(dim=1).int()
        active[rows] = feas.any(dim=1)
    return best, ties, active


def propose_pick_plain(pred, dyn, req, avail, eps, node_mask, eligible,
                       future, cap, spec, extras, score_quantum, best, active, k):
    del active  # inactive rows have no tied node: argmax gives 0
    inv_q = quantum_scale(score_quantum)
    T = req.shape[0]
    prop = torch.empty(T, dtype=torch.int32, device=req.device)
    for rows in _row_chunks(T):
        p, d, q, e, x = _chunk_args(rows, pred, dyn, req, eligible, extras)
        feas, s = masked_scores_plain(
            p, d, q, avail, eps, node_mask, e, future, cap, spec, x, inv_q
        )
        tied = feas & (s >= best[rows, None])
        ordinal = torch.cumsum(tied.int(), dim=1)
        pick = tied & (ordinal == (k[rows] + 1)[:, None])
        prop[rows] = torch.argmax(pick.to(torch.uint8), dim=1).int()
    return prop


def chunk_summaries_plain(feas, s, chunk: int = CHUNK_N):
    """(max f32[rows, C], ties i32[rows, C]) of the feasible scores of
    every `chunk` consecutive nodes (C = ceil(N / chunk)): -inf and 0
    where a chunk has no feasible cell."""
    rows, N = s.shape
    C = -(-N // chunk)
    pad = C * chunk - N
    sm = torch.where(feas, s, float("-inf"))
    sm = torch.nn.functional.pad(sm, (0, pad), value=float("-inf")).view(rows, C, chunk)
    fp = torch.nn.functional.pad(feas, (0, pad), value=False).view(rows, C, chunk)
    m = sm.max(dim=2).values
    return m, (fp & (sm == m[:, :, None])).sum(dim=2).int()


def pick_by_chunks_plain(feas, s, best, active, k, chunk: int = CHUNK_N):
    """Pass 2 as the kernel does it, from the chunk summaries: per active
    row the chunk holding the (k+1)-th tie (ties counted where a chunk's
    max is the row's best), then that chunk's nodes rescored; 0 for
    inactive rows.  `feas` and `s` are the rows' masked, floored scores
    (masked_scores_plain)."""
    rows, N = s.shape
    cmax, cties = chunk_summaries_plain(feas, s, chunk)
    cnt = torch.where(cmax == best[:, None], cties, 0)
    incl = torch.cumsum(cnt, dim=1)
    k = k.long()
    j = torch.argmax((incl > k[:, None]).to(torch.uint8), dim=1)
    found = active & (incl[:, -1] > k)
    target = k - (incl - cnt).gather(1, j[:, None])[:, 0]
    node = j[:, None] * chunk + torch.arange(chunk, device=s.device)
    inside = node < N
    nodec = torch.clamp(node, max=N - 1)
    tied = inside & feas.gather(1, nodec) & (s.gather(1, nodec) >= best[:, None])
    pick = tied & (torch.cumsum(tied.int(), dim=1) == (target + 1)[:, None])
    within = torch.argmax(pick.to(torch.uint8), dim=1)
    chosen = node.gather(1, within[:, None])[:, 0]
    return torch.where(found & pick.any(dim=1), chosen, 0).int()


def _launch_args(pred, dyn, req, avail, eps, node_mask, eligible, future,
                 cap, spec, extras, score_quantum):
    if len(extras) > 2:
        raise NotImplementedError(
            "propose kernel takes at most two precomputed score terms"
        )
    if spec.w_bal is not None and req.shape[1] < 2:
        raise NotImplementedError("balanced score needs two resource dims")
    t = [a.contiguous() for a in (pred, req, avail, eps, node_mask, eligible,
                                  future, cap)]
    T, R = req.shape
    N = avail.shape[0]
    x, c = [None, None], [None, None]
    for i, e in enumerate(extras):
        if isinstance(e, ClassTerm):
            x[i], c[i] = e.table.contiguous(), e.cls.contiguous()
            if (x[i].dim() != 2 or x[i].shape[1] != N or c[i].shape != (T,)
                    or c[i].dtype != torch.int32):
                raise ValueError("propose: class term of another shape")
        else:
            x[i] = e.contiguous()
    if isinstance(dyn, AffinityWords):
        w = [dyn.task_words.contiguous(), dyn.thr.contiguous(),
             dyn.node_words.contiguous()]
        if w[0].shape[0] != T or w[2].shape[0] != N:
            raise ValueError("propose: affinity words of another shape")
        mask, kw, k2w = None, words(dyn.K), words(dyn.K2)
    else:
        w, mask, kw, k2w = [None, None, None], dyn, 0, 0
        if mask is not None:
            mask = mask.contiguous()
    return [
        build.ptr(t[0]), build.ptr(mask),
        build.ptr(t[1]), build.ptr(t[2]), build.ptr(t[3]), build.ptr(t[4]),
        build.ptr(t[5]), build.ptr(t[6]), build.ptr(t[7]),
        build.ptr(x[0]), build.ptr(x[1]), build.ptr(c[0]), build.ptr(c[1]),
        build.ptr(w[0]), build.ptr(w[1]), build.ptr(w[2]), kw, k2w, T, N, R,
        int(spec.w_lr is not None), float(spec.w_lr or 0.0),
        int(spec.w_bal is not None), float(spec.w_bal or 0.0),
        spec.d0, spec.d1, quantum_scale(score_quantum),
    ], (t, x, c, w, mask)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_COMMON = [_P] * 16 + [_I] * 6 + [_F, _I, _F, _I, _I, _F]
_SIGNATURES = {
    "kb_propose_best": _COMMON + [_P, _P, _P, _P, _P],
    "kb_propose_pick": _COMMON + [_P, _P, _P, _P, _P, _P],
}


def _fn(name: str):
    return build.function("propose", name, _SIGNATURES[name])


def _check_device(req) -> bool:
    """True for CUDA, False for CPU; raise for anything else."""
    if req.device.type == "cpu":
        return False
    if req.device.type != "cuda":
        raise RuntimeError(f"propose: unsupported device {req.device}")
    return True


def propose_best(pred, dyn, req, avail, eps, node_mask, eligible, future,
                 cap, spec: ScoreSpec, extras, score_quantum: float, scratch=None):
    """(best f32[T], ties i32[T], active bool[T]) — pass 1.  On the card
    only the eligible rows are walked (listed by the kernel itself); the
    others get the plain version's answer for a row with no feasible
    node.  `scratch` (`best_scratch`, or None: one of its own) receives
    the list and the chunk summaries pass 2 reads."""
    if not _check_device(req):
        return propose_best_plain(pred, dyn, req, avail, eps, node_mask,
                                  eligible, future, cap, spec, extras,
                                  score_quantum)
    fn = _fn("kb_propose_best")
    args, _keep = _launch_args(pred, dyn, req, avail, eps, node_mask,
                               eligible, future, cap, spec, extras,
                               score_quantum)
    T, N = req.shape[0], avail.shape[0]
    best = torch.empty(T, dtype=torch.float32, device=req.device)
    ties = torch.empty(T, dtype=torch.int32, device=req.device)
    active = torch.empty(T, dtype=torch.bool, device=req.device)
    if scratch is None:
        scratch = best_scratch(T, N, req.device)
    elif scratch.numel() < best_scratch_bytes(T, N) or scratch.device != req.device:
        raise ValueError("propose_best: scratch smaller than best_scratch_bytes(T, N)")
    err = fn(*args, build.ptr(best), build.ptr(ties), build.ptr(active),
             build.ptr(scratch), build.stream_handle(req.device))
    build.check(err, "propose_best")
    propose_best.launches += 1
    return best, ties, active


def propose_pick(pred, dyn, req, avail, eps, node_mask, eligible, future,
                 cap, spec: ScoreSpec, extras, score_quantum: float,
                 best, active, k, scratch=None):
    """prop_node i32[T] — pass 2 (k = active_rank mod max(ties, 1)).  On
    the card `scratch` is the one pass 1 of this round filled (its list
    and chunk summaries), with pass 1's inputs; without it pass 2
    raises."""
    if not _check_device(req):
        return propose_pick_plain(pred, dyn, req, avail, eps, node_mask,
                                  eligible, future, cap, spec, extras,
                                  score_quantum, best, active, k)
    T, N = req.shape[0], avail.shape[0]
    if (scratch is None or scratch.numel() < best_scratch_bytes(T, N)
            or scratch.device != req.device):
        raise ValueError("propose_pick needs the scratch pass 1 of this round filled")
    fn = _fn("kb_propose_pick")
    args, _keep = _launch_args(pred, dyn, req, avail, eps, node_mask,
                               eligible, future, cap, spec, extras,
                               score_quantum)
    best, active, k = best.contiguous(), active.contiguous(), k.int().contiguous()
    prop = torch.empty(req.shape[0], dtype=torch.int32, device=req.device)
    err = fn(*args, build.ptr(best), build.ptr(active), build.ptr(k),
             build.ptr(prop), build.ptr(scratch), build.stream_handle(req.device))
    build.check(err, "propose_pick")
    propose_pick.launches += 1
    return prop


propose_best.launches = 0
propose_pick.launches = 0
