"""K7 · segment sums and the water-fill of queue shares (CUDA C++,
`csrc/segment_sum.cu`), two entry points.

Replaces the segment sums of kube_batch_tpu (api/snapshot.py ·
count_per_job / sum_req_per_job and the jax.ops.segment_sum calls of
plugins/drf.py, proportion.py and predicates.py; the port's single site is
api/snapshot.py · segment_sum) and ops/waterfill.py · waterfill_deserved.
What bounds it on the card and its design are noted in the source.

`segment_sum` sorts the segment ids (stable torch.sort) and launches one
block per segment; floats accumulate in float64 and are rounded once to
float32, integers and bools accumulate in int64 and return int32 counts.
The result does not depend on the order of summation: each segment's rows
are added in a fixed order by a fixed-shape tree.

Each wrapper runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import math

import torch

from kube_batch_tpu_torch.kernels import build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
MAX_R = 32


def _cuda(t, what: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {t.device}")
    return True


def segment_sum_plain(values, seg, num_segments: int) -> torch.Tensor:
    idx = seg.long()
    if values.is_floating_point():
        acc = torch.zeros((num_segments + 1,) + tuple(values.shape[1:]),
                          dtype=torch.float64, device=values.device)
        acc.index_add_(0, idx, values.double())
        return acc[:num_segments].float()
    acc = torch.zeros((num_segments + 1,) + tuple(values.shape[1:]),
                      dtype=torch.int64, device=values.device)
    acc.index_add_(0, idx, values.long())
    return acc[:num_segments].int()


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum rows of `values` ([T] or [T, ...]) into `num_segments`
    segments by `seg` (i32/i64[T], in [0, num_segments]); rows whose
    `seg` equals `num_segments` are dropped (the padding sentinel).
    float32 values return float32 sums, integer and bool values int32
    counts."""
    if not _cuda(values, "segment_sum"):
        return segment_sum_plain(values, seg, num_segments)
    if values.is_floating_point():
        if values.dtype != torch.float32:
            raise ValueError(f"segment_sum takes float32 values, got {values.dtype}")
        vals, dtype, out_dtype = values.contiguous(), 0, torch.float32
    else:
        vals, dtype, out_dtype = values.to(torch.int32).contiguous(), 1, torch.int32
    T = seg.shape[0]
    if vals.shape[0] != T:
        raise ValueError("segment_sum: values and seg differ in rows")
    C = math.prod(vals.shape[1:])
    out = torch.empty((num_segments,) + tuple(vals.shape[1:]), dtype=out_dtype,
                      device=vals.device)
    if num_segments == 0 or C == 0:
        return out
    s_seg, perm = torch.sort(seg.to(torch.int32), stable=True)
    fn = build.library("segment_sum").kb_segment_sum
    fn.argtypes = [_P, _P, _P, _I, _L, _I, _I, _P, _P]
    fn.restype = ctypes.c_int
    err = fn(build.ptr(s_seg), build.ptr(perm), build.ptr(vals), dtype, T, C,
             num_segments, build.ptr(out), build.stream_handle(vals.device))
    build.check(err, "segment_sum")
    segment_sum.launches += 1
    return out


def _sum_queues(x: torch.Tensor) -> torch.Tensor:
    """Σ over the queue axis of f32[Q, R], strictly left to right — the
    order the reference's float32 reduction takes on the CPU, so the two
    agree to the bit."""
    acc = torch.zeros_like(x[0])
    for q in range(x.shape[0]):
        acc = acc + x[q]
    return acc


def waterfill_plain(weights, request, total, queue_mask) -> torch.Tensor:
    Q = weights.shape[0]
    request = torch.where(queue_mask[:, None], request, 0.0)
    deserved = torch.zeros_like(request)
    remaining = total.float()
    unsat = queue_mask[:, None] & torch.ones_like(request, dtype=torch.bool)
    for _ in range(Q + 1):
        w = torch.where(unsat, weights[:, None], 0.0)
        wsum = _sum_queues(w)
        inc = torch.where(
            wsum > 0.0, remaining[None, :] * w / torch.clamp(wsum, min=1e-9), 0.0
        )
        filled = deserved + inc
        hit = filled >= request
        filled = torch.minimum(filled, request)
        spent = _sum_queues(filled - deserved)
        deserved, remaining, unsat = (
            filled, torch.clamp(remaining - spent, min=0.0), unsat & ~hit
        )
    return deserved


def waterfill(weights: torch.Tensor, request: torch.Tensor, total: torch.Tensor,
              queue_mask: torch.Tensor) -> torch.Tensor:
    """f32[Q, R]: weighted water-filling of `total` (f32[R]) into queues
    by `weights` (f32[Q]), each clamped at its `request` (f32[Q, R]);
    masked-out queues get nothing (≙ ops/waterfill.py)."""
    if not _cuda(weights, "waterfill"):
        return waterfill_plain(weights, request, total, queue_mask)
    Q, R = request.shape
    if R > MAX_R:
        raise ValueError(f"waterfill: at most {MAX_R} resource dims, got {R}")
    c = [x.contiguous() for x in (weights.float(), request.float(), total.float(),
                                  queue_mask.to(torch.bool))]
    unsat = torch.empty((Q, R), dtype=torch.bool, device=weights.device)
    deserved = torch.empty((Q, R), dtype=torch.float32, device=weights.device)
    fn = build.library("segment_sum").kb_waterfill
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _P, _P, _P]
    fn.restype = ctypes.c_int
    err = fn(*(build.ptr(x) for x in c), Q, R, build.ptr(unsat),
             build.ptr(deserved), build.stream_handle(weights.device))
    build.check(err, "waterfill")
    waterfill.launches += 1
    return deserved


segment_sum.launches = 0
waterfill.launches = 0
