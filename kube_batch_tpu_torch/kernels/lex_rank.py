"""K8 · lex_rank: stable radix sorts for the tiered rank and the tail of
the WFQ virtual start times (CUDA C++, `csrc/lex_rank.cu`), three entry
points.

Replaces kube_batch_tpu/framework/policy.py · rank_fn (its lexsort of the
tiered order keys into dense ranks) and virtual_start_times, and
ops/assignment.py · rank_from_keys and the (segment, rank) sort of
_segment_prefix as vtime uses it.  What bounds the kernels and their
design are noted in the source.

* `lex_push(perm, key)` — one more key of a least-significant-first
  chain: returns (perm[argsort(key[perm], stable)], its dense rank).
  Keys are float32 (-0.0 == +0.0, NaN last, as a stable torch.argsort
  and jnp.lexsort order them), as every order key of the policy is.
* `sort_by_segment(seg, rank, num_segments)` — the stable sort by the
  int64 key seg·T + rank over the bits that key needs (seg in
  [0, num_segments], rank in [0, T)): returns (perm, sorted seg ids).
* `vtime(perm, s_seg, req, valid, alloc_seg, denom_seg, num_segs)` —
  over rows sorted by (segment, base rank): the float64 within-segment
  prefix of the valid requests, the start times and their ratio to the
  fair-share denominator, max over resource dims, in task order.

Each wrapper runs its plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from kube_batch_tpu_torch.kernels import build
from kube_batch_tpu_torch.kernels.resolve import segment_exclusive_prefix

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
TILE = 2048      # rows per block of a radix pass
VT_TILE = 1024   # rows per block of the vtime prefix
MAX_R = 8
BIG_VTIME = 1e30


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


def lex_push_plain(perm, key):
    out = perm[torch.argsort(key[perm], stable=True)]
    return out, _dense_rank(out)


def lex_push(perm: torch.Tensor, key: torch.Tensor):
    """(perm i64[T], rank i32[T]): `perm` re-sorted stably by key[perm],
    and the dense rank of the result (rank[perm_out[i]] = i)."""
    if not _cuda(perm, "lex_push"):
        return lex_push_plain(perm, key)
    if key.dtype != torch.float32:
        raise ValueError(f"lex_push takes float32 keys, got {key.dtype}")
    T = perm.shape[0]
    perm = perm.long().contiguous()
    key = key.contiguous()
    dev = perm.device
    out = torch.empty(T, dtype=torch.int64, device=dev)
    rank = torch.empty(T, dtype=torch.int32, device=dev)
    if T == 0:
        return out, rank
    n_tiles = -(-T // TILE)
    codes = torch.empty(2 * T, dtype=torch.int32, device=dev)
    tmp = torch.empty(T, dtype=torch.int64, device=dev)
    hist = torch.empty(256 * n_tiles, dtype=torch.int32, device=dev)
    fn = build.library("lex_rank").kb_lex_push
    fn.argtypes = [_P, _P, _L, _P, _P, _P, _P, _P, _P]
    fn.restype = ctypes.c_int
    err = fn(build.ptr(key), build.ptr(perm), T,
             build.ptr(codes), build.ptr(tmp), build.ptr(hist), build.ptr(out),
             build.ptr(rank), build.stream_handle(dev))
    build.check(err, "lex_push")
    lex_push.launches += 1
    return out, rank


def sort_by_segment_plain(seg, rank, num_segments: int):
    T = seg.shape[0]
    key = seg.long() * T + rank.long()
    skey, perm = torch.sort(key, stable=True)
    return perm, torch.div(skey, T, rounding_mode="floor")


def sort_passes(T: int, num_segments: int) -> int:
    """8-bit radix passes the key seg·T + rank needs, seg ≤ num_segments."""
    return max(1, -(-((num_segments + 1) * T - 1).bit_length() // 8))


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
    n_tiles = -(-T // TILE)
    seg32 = seg.to(torch.int32).contiguous()
    rank32 = rank.to(torch.int32).contiguous()
    codes = torch.empty(2 * T, dtype=torch.int64, device=dev)
    tmp = torch.empty(T, dtype=torch.int64, device=dev)
    hist = torch.empty(256 * n_tiles, dtype=torch.int32, device=dev)
    fn = build.library("lex_rank").kb_sort_by_segment
    fn.argtypes = [_P, _P, _L, _I, _P, _P, _P, _P, _P, _P]
    fn.restype = ctypes.c_int
    err = fn(build.ptr(seg32), build.ptr(rank32), T, sort_passes(T, num_segments),
             build.ptr(codes), build.ptr(tmp), build.ptr(hist), build.ptr(perm),
             build.ptr(s_seg), build.stream_handle(dev))
    build.check(err, "sort_by_segment")
    sort_by_segment.launches += 1
    return perm, s_seg


def vtime_plain(perm, s_seg, req, valid, alloc_seg, denom_seg, num_segs: int):
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


def vtime(perm: torch.Tensor, s_seg: torch.Tensor, req: torch.Tensor,
          valid: torch.Tensor, alloc_seg: torch.Tensor, denom_seg: torch.Tensor,
          num_segs: int) -> torch.Tensor:
    """f32[T] virtual start times in task order, from rows sorted by
    (segment, base rank) (`perm`, `s_seg` of sort_by_segment; invalid
    rows in segment num_segs), requests f32[T, R], and the segments'
    allocation and denominator f32[S, R]."""
    if not _cuda(perm, "vtime"):
        return vtime_plain(perm, s_seg, req, valid, alloc_seg, denom_seg, num_segs)
    T, R = req.shape
    if R > MAX_R:
        raise ValueError(f"vtime: at most {MAX_R} resource dims, got {R}")
    dev = perm.device
    out = torch.empty(T, dtype=torch.float32, device=dev)
    if T == 0:
        return out
    c = [x.contiguous() for x in (perm.long(), s_seg.long(), req.float(),
                                  valid.to(torch.bool))]
    alloc = alloc_seg.float().contiguous()
    denom = denom_seg.float().contiguous()
    tile_sum = torch.empty((-(-T // VT_TILE), R), dtype=torch.float64, device=dev)
    excl = torch.empty((T, R), dtype=torch.float64, device=dev)
    fn = build.library("lex_rank").kb_vtime
    fn.argtypes = [_P, _P, _P, _P, _L, _I, _P, _P, _I, _P, _P, _P, _P]
    fn.restype = ctypes.c_int
    err = fn(*(build.ptr(x) for x in c), T, R, build.ptr(alloc), build.ptr(denom),
             num_segs, build.ptr(tile_sum), build.ptr(excl), build.ptr(out),
             build.stream_handle(dev))
    build.check(err, "vtime")
    vtime.launches += 1
    return out


lex_push.launches = 0
sort_by_segment.launches = 0
vtime.launches = 0
