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

`waterfill` fills f32[Q, R] requests (one launch, a warp a resource
column, any R), or — given `RequestRows`, the rows of the queue-request
sum and the queue index — takes the sum as `segment_sum` does and fills
it in the same launch (plugins/proportion.py · queue_deserved).  Its
queue sums go in blocks of 32 queues (`_sum_queues`), and it stops at
the fixed point of the iteration; the plain version does both alike.

Each wrapper runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from kube_batch_tpu_torch.kernels import build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "kb_segment_sum": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "kb_segment_count": [_P, _P, _I, _L, _I, _I, _P, _P],
    "kb_waterfill": [_P, _P, _P, _P, _I, _I, _P, _I, _I, _P, _L, _P],
    "kb_queue_deserved": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                          _I, _I, _P, _P],
    "kb_fill_static_smem": [_I, _P],
}
# the fill: shared memory, static and dynamic together, a block takes
# without opting in above 48 KB, and warps a block of the fill-only launch
SMEM_LIMIT = 48 * 1024
FILL_WARPS = 4
QUEUE_BLOCK = 32     # queues a fill sum adds in order before adding the blocks


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


@functools.lru_cache(maxsize=256)
def fill_plan(Q: int, R: int, warps: int, static: int = 0) -> tuple[int, int, int]:
    """(W, dynamic shared bytes, scratch floats) of a fill of Q queues by
    a block of `warps` warps whose kernel holds `static` bytes of static
    shared memory: W warps fill, one column each at a time, while the
    weights and W columns' state (csrc/segment_sum.cu · fill_columns: 4 ·
    (33 + 100 · W) · ceil(Q / 32) bytes) fit SMEM_LIMIT less `static`;
    past one column's, the state goes to a global scratch of that many
    floats a block."""
    NB = -(-Q // QUEUE_BLOCK)
    top = max(1, min(warps, R))
    for W in range(top, 0, -1):
        floats = 33 * NB + 100 * NB * W
        if 4 * floats + static <= SMEM_LIMIT:
            return W, 4 * floats, 0
    return top, 0, 33 * NB + 100 * NB * top


@functools.cache
def static_smem(fused: bool) -> int:
    """Bytes of static shared memory of the fill's kernel as built: the
    fused one (`kb_queue_deserved`, which also holds the sum's) or the
    fill-only one."""
    out = ctypes.c_int64()
    build.check(_fn("kb_fill_static_smem")(int(fused), ctypes.byref(out)), "waterfill")
    return out.value


@dataclasses.dataclass(frozen=True)
class RequestRows:
    """The queue request as the rows `waterfill` sums before it fills:
    `values` f32[T, R] summed by `seg` (i32[T] in [0, Q]; Q drops the
    row) along the queue index `order` / `offsets` (api/snapshot.py ·
    SegmentIndex, required on the card; the CPU ignores it)."""

    values: torch.Tensor
    seg: torch.Tensor
    order: torch.Tensor | None = None
    offsets: torch.Tensor | None = None


def _sum_queues(x: torch.Tensor) -> torch.Tensor:
    """Σ over the queue axis of f32[Q, R] in blocks of 32 queues: each
    block from 0 in queue order, then the block sums from 0 in block
    order.  It is XLA's order on the CPU for the reference's sums at Q ≤
    32 and at multiples of 32 (the two agree to the bit there), and the
    kernel's.  The padding adds +0.0, which leaves a sum that starts at
    +0.0 unchanged."""
    Q = x.shape[0]
    NB = -(-Q // QUEUE_BLOCK)
    padded = x.new_zeros((NB * QUEUE_BLOCK,) + tuple(x.shape[1:]))
    padded[:Q] = x
    padded = padded.view((NB, QUEUE_BLOCK) + tuple(x.shape[1:]))
    block = torch.zeros_like(padded[:, 0])
    for k in range(QUEUE_BLOCK):
        block = block + padded[:, k]
    acc = torch.zeros_like(x[0])
    for b in range(NB):
        acc = acc + block[b]
    return acc


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def waterfill_plain(weights, request, total, queue_mask, stats=None) -> torch.Tensor:
    """The fill in PyTorch.  It stops at the first iteration that leaves
    the carry (deserved, remaining, unsat) bitwise unchanged — the
    iteration is a function of the carry, so every later one would too —
    or after Q + 1; `stats["iterations"]` gets the iterations it ran."""
    Q = weights.shape[0]
    if isinstance(request, RequestRows):
        request = segment_sum_plain(request.values, request.seg, Q)
    request = torch.where(queue_mask[:, None], request, 0.0)
    deserved = torch.zeros_like(request)
    remaining = total.float()
    unsat = queue_mask[:, None] & torch.ones_like(request, dtype=torch.bool)
    it = 0
    while it <= Q:
        it += 1
        w = torch.where(unsat, weights[:, None], 0.0)
        wsum = _sum_queues(w)
        inc = torch.where(
            wsum > 0.0, remaining[None, :] * w / torch.clamp(wsum, min=1e-9), 0.0
        )
        filled = deserved + inc
        hit = filled >= request
        filled = torch.minimum(filled, request)
        spent = _sum_queues(filled - deserved)
        left = torch.clamp(remaining - spent, min=0.0)
        still = unsat & ~hit
        fixed = (_same_bits(filled, deserved) and _same_bits(left, remaining)
                 and torch.equal(still, unsat))
        deserved, remaining, unsat = filled, left, still
        if fixed:
            break
    if stats is not None:
        stats["iterations"] = it
    return deserved


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()


# Tickets of kb_queue_deserved, i32 a queue and one more, kept per device
# and stream and zero between calls (the kernel clears each ticket after
# its last taker).  Calls on one stream run in order, so one buffer serves
# them all.
_tickets: dict = {}


def _tickets_for(dev, stream: int, n: int) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = _tickets[key] = torch.zeros(max(n, 64), dtype=torch.int32, device=dev)
    return buf


def waterfill(weights: torch.Tensor, request, total: torch.Tensor,
              queue_mask: torch.Tensor) -> torch.Tensor:
    """f32[Q, R]: weighted water-filling of `total` (f32[R]) into queues
    by `weights` (f32[Q]), each clamped at its `request` — f32[Q, R], or
    `RequestRows` to sum first in the same launch; masked-out queues get
    nothing (≙ ops/waterfill.py)."""
    if not _cuda(weights, "waterfill"):
        return waterfill_plain(weights, request, total, queue_mask)
    Q, R = weights.shape[0], total.shape[0]
    w, t = _f32(weights), _f32(total)
    m = queue_mask
    if m.dtype != torch.bool or not m.is_contiguous():
        m = m.to(torch.bool).contiguous()
    if m.shape != (Q,):
        raise ValueError("waterfill: weights and queue_mask differ in queues")
    dev = w.device
    if Q == 0 or R == 0:
        return w.new_zeros((Q, R))
    stream = build.stream_handle(dev)
    if isinstance(request, RequestRows):
        out = _queue_deserved(w, request, t, m, Q, R, stream)
    else:
        req = _f32(request)
        if req.shape != (Q, R):
            raise ValueError(f"waterfill: request {tuple(req.shape)}, want {(Q, R)}")
        W, smem, floats = fill_plan(Q, R, FILL_WARPS, static_smem(False))
        blocks = -(-R // W)
        buf = w.new_empty(Q * R + blocks * floats)
        out = buf[:Q * R].view(Q, R)
        err = _fn("kb_waterfill")(
            w.data_ptr(), req.data_ptr(), t.data_ptr(), m.data_ptr(), Q, R, out.data_ptr(),
            W, smem, buf.data_ptr() + 4 * Q * R if floats else None, floats, stream)
        build.check(err, "waterfill")
    waterfill.launches += 1
    return out


def _queue_deserved(w, rows: RequestRows, t, m, Q: int, R: int, stream: int):
    """The queue sums of `rows` (as `segment_sum`) and their fill, one launch."""
    vals, order, offsets = _f32(rows.values), rows.order, rows.offsets
    if order is None or offsets is None:
        raise ValueError("waterfill on the card needs the queue segment index")
    T = vals.shape[0]
    seg32 = _seg32(rows.seg, T, "waterfill")
    if (vals.shape != (T, R) or order.shape != (T,) or offsets.shape != (Q + 1,)
            or order.dtype != torch.int32 or offsets.dtype != torch.int32):
        raise ValueError("waterfill: the request rows do not match the index or the queues")
    threads, runs = sum_shape(T, Q)
    W, smem, floats = fill_plan(Q, R, threads // 32, static_smem(True))
    # one allocation: deserved f32[Q, R], the sums f32[Q, R], the float64
    # partials f64[Q, runs, R] when runs > 1 (at an even float, so 8-byte
    # aligned), the fill's scratch when its state passes shared memory
    head = 2 * Q * R
    part = 2 * Q * runs * R if runs > 1 else 0
    buf = w.new_empty(head + part + floats)
    base = buf.data_ptr()
    out = buf[:Q * R].view(Q, R)
    err = _fn("kb_queue_deserved")(
        order.data_ptr(), offsets.data_ptr(), seg32.data_ptr(), vals.data_ptr(),
        w.data_ptr(), t.data_ptr(), m.data_ptr(), Q, R, threads, runs, base + 4 * Q * R,
        base + 4 * head if part else None, _tickets_for(w.device, stream, Q + 1).data_ptr(),
        out.data_ptr(), W, smem, base + 4 * (head + part) if floats else None, stream)
    build.check(err, "waterfill")
    return out


segment_sum.launches = 0
segment_count.launches = 0
waterfill.launches = 0
