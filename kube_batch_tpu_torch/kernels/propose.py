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

`dyn`, the dynamic predicate, is None, a bool[T, N] mask, or the inter-pod
affinity predicate as `kernels/affinity.py · AffinityWords`, whose cells
the kernel tests itself (K10's cell test, in K2's tiles).

The score is `((0 + w_lr·lr) + w_bal·bal) + extra0 + extra1`, where the
two node-order terms are computed on the fly and the extras are
precomputed, already weighted [T, N] terms (node affinity, pod-affinity
score).  The plain versions below repeat the kernel's arithmetic in the
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


@dataclasses.dataclass(frozen=True)
class ScoreSpec:
    """The node-order score in a form the kernel can evaluate.

    `w_lr` / `w_bal` weight the least-requested and balanced-allocation
    terms (None = not registered); `extra_fns` are callables
    `(snap, state) -> f32[T, N] | None` returning an already weighted
    additive term, or None when the term is exactly zero for this
    snapshot.  An empty spec is the zero score (backfill)."""

    w_lr: float | None = None
    w_bal: float | None = None
    d0: int = 0
    d1: int = 1
    extra_fns: tuple = ()

    def extra_terms(self, snap, state) -> list[torch.Tensor]:
        out = []
        for fn in self.extra_fns:
            term = fn(snap, state)
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
    return pred[rows], dyn, req[rows], eligible[rows], [e[rows] for e in extras]


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


def _launch_args(pred, dyn, req, avail, eps, node_mask, eligible, future,
                 cap, spec, extras, score_quantum):
    if len(extras) > 2:
        raise NotImplementedError(
            "propose kernel takes at most two precomputed score terms"
        )
    if spec.w_bal is not None and req.shape[1] < 2:
        raise NotImplementedError("balanced score needs two resource dims")
    x = [e.contiguous() for e in extras] + [None, None]
    t = [a.contiguous() for a in (pred, req, avail, eps, node_mask, eligible,
                                  future, cap)]
    T, R = req.shape
    N = avail.shape[0]
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
        build.ptr(x[0]), build.ptr(x[1]),
        build.ptr(w[0]), build.ptr(w[1]), build.ptr(w[2]), kw, k2w, T, N, R,
        int(spec.w_lr is not None), float(spec.w_lr or 0.0),
        int(spec.w_bal is not None), float(spec.w_bal or 0.0),
        spec.d0, spec.d1, quantum_scale(score_quantum),
    ], (t, x, w, mask)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_COMMON = [_P] * 14 + [_I] * 6 + [_F, _I, _F, _I, _I, _F]
_SIGNATURES = {
    "kb_propose_best": _COMMON + [_P, _P, _P, _P],
    "kb_propose_pick": _COMMON + [_P, _P, _P, _P, _P],
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
                 cap, spec: ScoreSpec, extras, score_quantum: float):
    """(best f32[T], ties i32[T], active bool[T]) — pass 1."""
    if not _check_device(req):
        return propose_best_plain(pred, dyn, req, avail, eps, node_mask,
                                  eligible, future, cap, spec, extras,
                                  score_quantum)
    fn = _fn("kb_propose_best")
    args, _keep = _launch_args(pred, dyn, req, avail, eps, node_mask,
                               eligible, future, cap, spec, extras,
                               score_quantum)
    T = req.shape[0]
    best = torch.empty(T, dtype=torch.float32, device=req.device)
    ties = torch.empty(T, dtype=torch.int32, device=req.device)
    active = torch.empty(T, dtype=torch.bool, device=req.device)
    err = fn(*args, build.ptr(best), build.ptr(ties), build.ptr(active),
             build.stream_handle(req.device))
    build.check(err, "propose_best")
    propose_best.launches += 1
    return best, ties, active


def propose_pick(pred, dyn, req, avail, eps, node_mask, eligible, future,
                 cap, spec: ScoreSpec, extras, score_quantum: float,
                 best, active, k):
    """prop_node i32[T] — pass 2 (k = active_rank mod max(ties, 1))."""
    if not _check_device(req):
        return propose_pick_plain(pred, dyn, req, avail, eps, node_mask,
                                  eligible, future, cap, spec, extras,
                                  score_quantum, best, active, k)
    fn = _fn("kb_propose_pick")
    args, _keep = _launch_args(pred, dyn, req, avail, eps, node_mask,
                               eligible, future, cap, spec, extras,
                               score_quantum)
    best, active, k = best.contiguous(), active.contiguous(), k.int().contiguous()
    prop = torch.empty(req.shape[0], dtype=torch.int32, device=req.device)
    err = fn(*args, build.ptr(best), build.ptr(active), build.ptr(k),
             build.ptr(prop), build.stream_handle(req.device))
    build.check(err, "propose_pick")
    propose_pick.launches += 1
    return prop


propose_best.launches = 0
propose_pick.launches = 0
