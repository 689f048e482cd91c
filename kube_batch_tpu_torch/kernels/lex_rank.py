"""K8 · lex_rank: stable radix sorts for the tiered rank and the tail of
the WFQ virtual start times (CUDA C++, `csrc/lex_rank.cu`), three entry
points.

Replaces kube_batch_tpu/framework/policy.py · rank_fn (its lexsort of the
tiered order keys into dense ranks) and virtual_start_times, and
ops/assignment.py · rank_from_keys and the (segment, rank) sort of
_segment_prefix as vtime uses it.  What bounds the kernels and their
design are noted in the source.

* `lex_push_many(perm, keys)` — m more keys of a least-significant-first
  chain, in one call: the result of m successive stable sorts
  perm ← perm[argsort(key[perm], stable)], and its dense rank.  Keys are
  float32 (-0.0 == +0.0, NaN last, as a stable torch.argsort and
  jnp.lexsort order them), as every order key of the policy is.  Up to
  16,384 rows every pass of every key is one launch.
* `sort_by_segment(seg, rank, num_segments)` — the stable sort by the
  key seg·T + rank over the bits that key needs (seg in
  [0, num_segments], rank in [0, T)): returns (perm, sorted seg ids).
  One launch up to 16,384 rows.
* `vtime(seg, base_rank, req, valid, alloc_seg, denom_seg, num_segs)` —
  one call of framework/policy.py · virtual_start_times: rows sorted by
  (segment key, base rank), the float64 within-segment prefix of the
  valid requests, the start times and their ratio to the fair-share
  denominator, max over resource dims, in task order.  One launch up to
  16,384 rows (the sort and the scan in one block); above, the
  `sort_by_segment` of the segment key and a three-kernel tail.

Each wrapper runs its plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from kube_batch_tpu_torch.kernels import build
from kube_batch_tpu_torch.kernels.resolve import segment_exclusive_prefix

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "kb_lex_push_many": [_P, _I, _P, _L, _P, _P, _P, _P],
    "kb_sort_by_segment": [_P, _P, _L, _I, _I, _I, _P, _P, _P, _P],
    "kb_vtime": [_P, _P, _P, _P, _P, _L, _L, _P, _L, _L, _I, _I, _I, _I, _P, _P],
    "kb_vtime_sorted": [_P, _P, _P, _P, _L, _I, _P, _L, _L, _P, _L, _L, _I, _P, _P, _P],
}
CTA_MAX_T = 16384   # rows a one-block sort holds in shared memory
TILE = 2048         # rows per block of a wide pass
MAX_RADIX = 512     # counters per pass of a wide sort (digits of up to 9 bits)
VT_TILE = 1024      # rows per block of the vtime prefix
MAX_R = 8
BIG_VTIME = 1e30


def _fn(name: str):
    return build.function("lex_rank", name, _SIGNATURES[name])


def _cuda(t, what: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {t.device}")
    return True


def _dense_rank(perm: torch.Tensor) -> torch.Tensor:
    num = perm.shape[0]
    rank = torch.empty(num, dtype=torch.int32, device=perm.device)
    rank[perm] = torch.arange(num, dtype=torch.int32, device=perm.device)
    return rank


def wide_scratch_bytes(T: int, code_bytes: int, passes: int) -> int:
    """Scratch of a sort above CTA_MAX_T rows (csrc/lex_rank.cu ·
    wide_layout): codes and row ids double-buffered, then per pass the
    digit counts, each tile's published counts and a ticket."""
    def align(n):
        return (n + 255) // 256 * 256

    tiles = -(-T // TILE)
    return (align(2 * T * code_bytes) + align(2 * T * 4)
            + 4 * (passes * MAX_RADIX * (1 + tiles) + passes))


def lex_push_many_plain(perm, keys):
    if perm is None:
        perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in keys:
        perm = perm[torch.argsort(key[perm], stable=True)]
    return perm, _dense_rank(perm)


def lex_push_many(perm: torch.Tensor | None, keys):
    """(perm i64[T], rank i32[T]): `perm` (None: the identity) re-sorted
    stably by each key of `keys` in turn, least significant first — m
    `lex_push` calls in one — and the dense rank of the result
    (rank[perm_out[i]] = i)."""
    if not keys:
        raise ValueError("lex_push_many needs at least one key")
    if not _cuda(keys[0], "lex_push_many"):
        return lex_push_many_plain(perm, keys)
    dev = keys[0].device
    T = keys[0].shape[0]
    keys = [k.contiguous() for k in keys]
    for k in keys:
        if k.dtype != torch.float32 or k.shape != (T,) or k.device != dev:
            raise ValueError(f"lex_push_many takes float32 keys of {T} rows on {dev}, "
                             f"got {k.dtype} {tuple(k.shape)} on {k.device}")
    if perm is not None:
        if perm.dtype != torch.int64 or perm.shape != (T,):
            raise ValueError("lex_push_many: perm must be int64 of the keys' rows")
        perm = perm.contiguous()
    out = torch.empty(T, dtype=torch.int64, device=dev)
    rank = torch.empty(T, dtype=torch.int32, device=dev)
    if T == 0:
        return out, rank
    scratch = (torch.empty(wide_scratch_bytes(T, 4, 4), dtype=torch.uint8, device=dev)
               if T > CTA_MAX_T else None)
    ptrs = (ctypes.c_void_p * len(keys))(*(k.data_ptr() for k in keys))
    err = _fn("kb_lex_push_many")(ptrs, len(keys), build.ptr(perm), T, build.ptr(scratch),
                                  build.ptr(out), build.ptr(rank), build.stream_handle(dev))
    build.check(err, "lex_push_many")
    lex_push_many.launches += 1
    return out, rank


def lex_push(perm: torch.Tensor, key: torch.Tensor):
    """One key: `lex_push_many(perm, [key])`."""
    return lex_push_many(perm, [key])


def sort_by_segment_plain(seg, rank, num_segments: int):
    T = seg.shape[0]
    key = seg.long() * T + rank.long()
    skey, perm = torch.sort(key, stable=True)
    return perm, torch.div(skey, T, rounding_mode="floor")


def sort_passes(T: int, num_segments: int) -> int:
    """8-bit radix passes the key seg·T + rank needs, seg ≤ num_segments."""
    return max(1, -(-((num_segments + 1) * T - 1).bit_length() // 8))


def sort_plan(T: int, num_segments: int) -> tuple[int, int, int]:
    """(code bytes, digit bits, passes) of the sort of seg·T + rank: one
    block of 8-bit passes up to CTA_MAX_T rows when the key fits 32 bits;
    else digits of at most 9 bits, as few passes as the key needs (a key
    below 2^18 takes two 9-bit passes)."""
    key_bits = max(1, ((num_segments + 1) * T - 1).bit_length())
    code_bytes = 4 if key_bits <= 32 else 8
    if T <= CTA_MAX_T and code_bytes == 4:
        return code_bytes, 8, sort_passes(T, num_segments)
    passes = -(-key_bits // 9)
    return code_bytes, -(-key_bits // passes), passes


def sort_by_segment(seg: torch.Tensor, rank: torch.Tensor, num_segments: int):
    """(perm i64[T], sorted segment ids i64[T]): the stable sort by
    (seg, rank), seg in [0, num_segments] and rank in [0, T)."""
    if not _cuda(seg, "sort_by_segment"):
        return sort_by_segment_plain(seg, rank, num_segments)
    T = seg.shape[0]
    dev = seg.device
    perm = torch.empty(T, dtype=torch.int64, device=dev)
    s_seg = torch.empty(T, dtype=torch.int64, device=dev)
    if T == 0:
        return perm, s_seg
    seg32 = seg.to(torch.int32).contiguous()
    rank32 = rank.to(torch.int32).contiguous()
    code_bytes, bits, passes = sort_plan(T, num_segments)
    scratch = (None if T <= CTA_MAX_T and code_bytes == 4 else
               torch.empty(wide_scratch_bytes(T, code_bytes, passes), dtype=torch.uint8,
                           device=dev))
    err = _fn("kb_sort_by_segment")(
        build.ptr(seg32), build.ptr(rank32), T, code_bytes, bits, passes,
        build.ptr(scratch), build.ptr(perm), build.ptr(s_seg), build.stream_handle(dev))
    build.check(err, "sort_by_segment")
    sort_by_segment.launches += 1
    return perm, s_seg


def segment_key(seg, valid, num_segs: int):
    """The sort's segment of each row: its segment clamped into [0, S)
    when valid, S (after every segment) when not."""
    return torch.where(valid, torch.clamp(seg, 0, num_segs - 1), num_segs)


def vtime_plain(seg, base_rank, req, valid, alloc_seg, denom_seg, num_segs: int):
    perm, s_seg = sort_by_segment_plain(segment_key(seg, valid, num_segs), base_rank,
                                        num_segs)
    return vtime_sorted_plain(perm, s_seg, req, valid, alloc_seg, denom_seg, num_segs)


def vtime_sorted_plain(perm, s_seg, req, valid, alloc_seg, denom_seg, num_segs: int):
    r = torch.where(valid[:, None], req, 0.0)
    before, _ = segment_exclusive_prefix(s_seg, r[perm])
    s = torch.clamp(s_seg, 0, num_segs - 1)
    start = (alloc_seg[s].double() + before).float()
    denom = denom_seg[s]
    ratio = torch.where(
        denom > 0.0, start / torch.clamp(denom, min=1e-9),
        torch.where(start > 0.0, BIG_VTIME, 0.0),
    )
    out = torch.zeros(perm.shape[0], dtype=torch.float32, device=perm.device)
    out[perm] = ratio.max(dim=-1).values
    return out


_VTIME_DTYPES = (torch.int32, torch.int32, torch.float32, torch.bool, torch.float32,
                 torch.float32)


def _vtime_args_ok(seg, base_rank, req, valid, alloc_seg, denom_seg, num_segs) -> bool:
    """One pass of cheap attribute tests (a call at 65,536 rows is mostly
    host time): the dtypes, the shapes, the card, the contiguous rows."""
    T, R = req.shape
    return ((seg.dtype, base_rank.dtype, req.dtype, valid.dtype, alloc_seg.dtype,
             denom_seg.dtype) == _VTIME_DTYPES
            and seg.shape == base_rank.shape == valid.shape == (T,)
            and alloc_seg.shape == denom_seg.shape == (num_segs, R)
            and 1 <= R <= MAX_R and num_segs >= 1
            and seg.is_cuda and base_rank.is_cuda and valid.is_cuda
            and alloc_seg.is_cuda and denom_seg.is_cuda
            and seg.is_contiguous() and base_rank.is_contiguous()
            and valid.is_contiguous() and req.is_contiguous())


def vtime(seg: torch.Tensor, base_rank: torch.Tensor, req: torch.Tensor,
          valid: torch.Tensor, alloc_seg: torch.Tensor, denom_seg: torch.Tensor,
          num_segs: int) -> torch.Tensor:
    """f32[T] virtual start times in task order: seg and base_rank i32[T]
    (base_rank a dense rank, in [0, T)), requests f32[T, R], valid
    bool[T] (all four contiguous), the segments' allocation and
    denominator f32[S, R] (any strides; S = num_segs >= 1, 1 <= R <=
    MAX_R), all on the card.  Nothing is converted: other arguments
    raise.  Up to CTA_MAX_T rows (and (S + 1)·T <= 2^32) one launch,
    which allocates nothing but the output; above, `sort_by_segment` and
    the three-kernel tail."""
    if not _cuda(req, "vtime"):
        return vtime_plain(seg, base_rank, req, valid, alloc_seg, denom_seg, num_segs)
    if not _vtime_args_ok(seg, base_rank, req, valid, alloc_seg, denom_seg, num_segs):
        raise ValueError(
            "vtime takes int32 seg and base_rank, float32 req, bool valid (contiguous, "
            "T rows) and float32 alloc_seg and denom_seg of [num_segs, R], on the card; "
            f"got {[(x.dtype, tuple(x.shape), x.device.type) for x in (seg, base_rank, req, valid, alloc_seg, denom_seg)]}, "
            f"num_segs = {num_segs}")
    T, R = req.shape
    dev = req.device
    out = torch.empty(T, dtype=torch.float32, device=dev)
    if T == 0:
        return out
    code_bytes, _bits, passes = sort_plan(T, num_segs)
    if T <= CTA_MAX_T and code_bytes == 4:
        err = _fn("kb_vtime")(seg.data_ptr(), base_rank.data_ptr(), req.data_ptr(),
                              valid.data_ptr(), alloc_seg.data_ptr(), alloc_seg.stride(0),
                              alloc_seg.stride(1), denom_seg.data_ptr(), denom_seg.stride(0),
                              denom_seg.stride(1), T, R, num_segs, passes, out.data_ptr(),
                              build.stream_handle(dev))
    else:
        perm, s_seg = sort_by_segment(segment_key(seg, valid, num_segs), base_rank,
                                      num_segs)
        scratch = torch.empty((-(-T // VT_TILE) + T) * R, dtype=torch.float64, device=dev)
        err = _fn("kb_vtime_sorted")(
            perm.data_ptr(), s_seg.data_ptr(), req.data_ptr(), valid.data_ptr(), T, R,
            alloc_seg.data_ptr(), alloc_seg.stride(0), alloc_seg.stride(1),
            denom_seg.data_ptr(), denom_seg.stride(0), denom_seg.stride(1), num_segs,
            scratch.data_ptr(), out.data_ptr(), build.stream_handle(dev))
    build.check(err, "vtime")
    vtime.launches += 1
    return out


lex_push_many.launches = 0
sort_by_segment.launches = 0
vtime.launches = 0
