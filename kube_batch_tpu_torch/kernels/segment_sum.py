"""K7 · segment sums, segment counts and the water-fill of queue shares
(CUDA C++, `csrc/segment_sum.cu`), three entry points.

Replaces the segment sums of kube_batch_tpu (api/snapshot.py ·
count_per_job / sum_req_per_job and the jax.ops.segment_sum calls of
plugins/drf.py, proportion.py and predicates.py; the port's single site is
api/snapshot.py · segment_sum) and ops/waterfill.py · waterfill_deserved.
What bounds it on the card and its design are noted in the source.

`segment_sum` (float32 values) takes the segment index of the ids'
base (api/snapshot.py · SegmentIndex: `order` and `offsets`, built once
per pack) and launches one block per segment, which walks its rows in
that order and skips the rows whose `seg` is not the segment; the sums
are float64, rounded once to float32, in a fixed partition and a fixed
combine tree, so two runs are bitwise equal.  A call on the card without
an index raises: nothing sorts per call.  A call is one launch, after a
memset of the tickets when long segments are split into runs (their
float64 partials and tickets share one allocation with the output).  `segment_count` (int32 or bool
values) needs no index: one launch of warp-aggregated integer atomics
into an output zeroed in the same stream.

Each wrapper runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from kube_batch_tpu_torch.kernels import build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
MAX_R = 32
_SIGNATURES = {
    "kb_segment_sum": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "kb_segment_count": [_P, _P, _I, _L, _I, _I, _P, _P],
    "kb_waterfill": [_P, _P, _P, _P, _I, _I, _P, _P, _P],
}


def _fn(name: str):
    return build.function("segment_sum", name, _SIGNATURES[name])


@functools.lru_cache(maxsize=256)
def sum_shape(T: int, S: int) -> tuple[int, int]:
    """(threads per block, runs per segment) of a float sum of T rows into
    S segments, from the shapes alone: threads a power of two from 32 to
    256 near the mean segment T / S, and runs so that a segment of the
    mean length gives each thread about one position (a long segment a
    few), at most 64."""
    mean = T / max(S, 1)
    threads = 32
    while threads < 256 and threads < mean:
        threads *= 2
    return threads, max(1, min(64, -(-T // (max(S, 1) * threads))))


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


def _seg32(seg: torch.Tensor, T: int, what: str) -> torch.Tensor:
    if seg.shape[0] != T:
        raise ValueError(f"{what}: values and seg differ in rows")
    if seg.dtype != torch.int32:
        return seg.to(torch.int32)
    return seg if seg.is_contiguous() else seg.contiguous()


def segment_sum(values: torch.Tensor, seg: torch.Tensor, num_segments: int,
                order: torch.Tensor | None = None,
                offsets: torch.Tensor | None = None) -> torch.Tensor:
    """f32: the rows of float32 `values` ([T] or [T, ...]) summed into
    `num_segments` segments by `seg` (i32[T], in [0, num_segments]);
    rows whose `seg` equals `num_segments` are dropped (the padding
    sentinel).  On the card `order` i32[T] and `offsets`
    i32[num_segments + 1] must be the stable order of the rows by a base
    id vector with seg in {base, num_segments} row by row (api/snapshot.py
    · SegmentIndex); the CPU ignores them."""
    if not values.is_cuda:
        _cuda(values, "segment_sum")      # raises for another device than the CPU
        return segment_sum_plain(values, seg, num_segments)
    if values.dtype != torch.float32:
        raise ValueError(f"segment_sum takes float32 values, got {values.dtype}"
                         " (segment_count takes counts)")
    if order is None or offsets is None:
        raise ValueError("segment_sum on the card needs the segment index of "
                         "its base (SnapshotTensors.segment_index)")
    T = values.shape[0]
    seg32 = _seg32(seg, T, "segment_sum")
    if (order.shape[0] != T or offsets.shape[0] != num_segments + 1
            or order.dtype != torch.int32 or offsets.dtype != torch.int32):
        raise ValueError("segment_sum: the index does not match the rows or segments")
    vals = values if values.is_contiguous() else values.contiguous()
    C = math.prod(vals.shape[1:])
    S = num_segments
    shape = (S,) + tuple(vals.shape[1:])
    if S == 0 or C == 0:
        return vals.new_empty(shape)
    threads, runs = sum_shape(T, S)
    ticket = partial = None
    if runs > 1:
        # one allocation: the sums f32[S, C] (padded to 8 bytes), the
        # float64 partials f64[S, runs, C], the tickets i32[S] (zeroed by
        # kb_segment_sum)
        head = S * C + (S * C & 1)
        buf = vals.new_empty(head + 2 * S * runs * C + S)
        out = buf[:S * C].view(shape)
        partial = buf.data_ptr() + 4 * head
        ticket = partial + 8 * S * runs * C
    else:
        out = vals.new_empty(shape)
    err = _fn("kb_segment_sum")(
        order.data_ptr(), offsets.data_ptr(), seg32.data_ptr(), vals.data_ptr(), C,
        S, threads, runs, out.data_ptr(), partial, ticket,
        build.stream_handle(vals.device))
    build.check(err, "segment_sum")
    segment_sum.launches += 1
    return out


def segment_count(values: torch.Tensor, seg: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """i32: the rows of integer or bool `values` ([T] or [T, ...]) added
    into `num_segments` segments by `seg`, as `segment_sum` does for
    floats; no index is needed."""
    if not values.is_cuda:
        _cuda(values, "segment_count")    # raises for another device than the CPU
        return segment_sum_plain(values, seg, num_segments)
    if values.is_floating_point():
        raise ValueError("segment_count takes integer or bool values")
    T = values.shape[0]
    seg32 = _seg32(seg, T, "segment_count")
    if values.dtype == torch.bool:
        vals, dtype = values, 2
    else:
        vals, dtype = values.to(torch.int32), 1
    vals = vals if vals.is_contiguous() else vals.contiguous()
    C = math.prod(vals.shape[1:])
    out = torch.empty((num_segments,) + tuple(vals.shape[1:]), dtype=torch.int32,
                      device=vals.device)
    if num_segments == 0 or C == 0:
        return out
    err = _fn("kb_segment_count")(
        seg32.data_ptr(), vals.data_ptr(), dtype, T, C, num_segments,
        out.data_ptr(), build.stream_handle(vals.device))
    build.check(err, "segment_count")
    segment_count.launches += 1
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
    err = _fn("kb_waterfill")(*(build.ptr(x) for x in c), Q, R, build.ptr(unsat),
             build.ptr(deserved), build.stream_handle(weights.device))
    build.check(err, "waterfill")
    waterfill.launches += 1
    return deserved


segment_sum.launches = 0
segment_count.launches = 0
waterfill.launches = 0
