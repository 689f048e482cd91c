"""K5 · victim prefix (CUDA C++, `csrc/victim_prefix.cu`).

Replaces kube_batch_tpu/ops/preemption.py · _min_victims_per_node and
the feasible argmin node of choose_node.  What bounds it on the card, its
design and its float64 prefix rule are noted in the source.

Takes the candidate victims sorted by (node, sacrifice): `perm` (int64,
sorted position → task row) and `s_node` (int64, sorted position → the
victim's node; N for non-victims, which sort last).  Returns
(k i32[N], out i32[5]) where k[n] is the fewest victims of node n whose
release makes the preemptor fit its FutureIdle (0 when it fits with none,
BIG_K when no prefix does), and out is
[n_best, any_feasible, first victim on n_best, any victim on n_best,
fits n_best with no victim] — n_best the lowest-index feasible node with
the smallest k, 0 when no node is feasible.  Everything stays on the
device: the caller reads nothing back.

The wrapper runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from kube_batch_tpu_torch.kernels import build
from kube_batch_tpu_torch.kernels.resolve import segment_exclusive_prefix

BIG_K = (2**31 - 1) // 4
MAX_R = 8

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _fits(req, avail, eps):
    return torch.all((req <= avail) | (req < eps), dim=-1)


def victim_prefix_plain(perm, s_node, task_req, future, preq, eps, ok):
    T = perm.shape[0]
    N = future.shape[0]
    dev = perm.device
    real = s_node < N
    node = torch.clamp(s_node, max=N - 1)
    s_req = torch.where(real[:, None], task_req[perm], 0.0)
    before, is_start = segment_exclusive_prefix(s_node, s_req)
    gain = (before + s_req.double()).float()
    s_fit = _fits(preq[None, :], future[node] + gain, eps) & real
    idx = torch.arange(T, device=dev)
    start_idx = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    kcand = torch.where(s_fit, idx - start_idx + 1, BIG_K)
    k_with = torch.full((N + 1,), BIG_K, dtype=torch.int64, device=dev)
    k_with = k_with.scatter_reduce(0, torch.where(real, s_node, N), kcand,
                                   reduce="amin")[:N]
    fit0 = _fits(preq[None, :], future, eps)
    k = torch.where(fit0, 0, k_with).to(torch.int32)
    feasible = (k < BIG_K) & ok
    kk = torch.where(feasible, k, BIG_K)
    n_best = torch.argmax((feasible & (kk == kk.min())).to(torch.int32))
    start = torch.searchsorted(s_node, n_best.view(1)).clamp(max=T - 1)[0]
    any_vic = (s_node[start] == n_best) & (T > 0)
    out = torch.stack([
        n_best,
        feasible.any().long(),
        torch.where(any_vic, perm[start], 0),
        any_vic.long(),
        fit0[n_best].long(),
    ]).to(torch.int32)
    return k, out


def victim_prefix(perm, s_node, task_req, future, preq, eps, ok):
    """(k i32[N], out i32[5]) — see the module docstring."""
    if perm.device.type == "cpu":
        return victim_prefix_plain(perm, s_node, task_req, future, preq, eps, ok)
    if perm.device.type != "cuda":
        raise RuntimeError(f"victim_prefix: unsupported device {perm.device}")
    T = perm.shape[0]
    N, R = future.shape
    if R > MAX_R:
        raise ValueError(f"victim_prefix: at most {MAX_R} resource dims, got {R}")
    if perm.dtype != torch.int64 or s_node.dtype != torch.int64:
        raise ValueError("victim_prefix: perm and s_node must be int64")
    c = [x.contiguous() for x in (perm, s_node, task_req, future, preq, eps)]
    okc = ok.to(torch.bool).contiguous()
    k = torch.empty(N, dtype=torch.int32, device=perm.device)
    out = torch.empty(5, dtype=torch.int32, device=perm.device)
    fn = build.library("victim_prefix").kb_victim_prefix
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _P, _P, _P]
    fn.restype = ctypes.c_int
    err = fn(*(build.ptr(x) for x in c), build.ptr(okc), T, N, R,
             build.ptr(k), build.ptr(out), build.stream_handle(perm.device))
    build.check(err, "victim_prefix")
    victim_prefix.launches += 1
    return k, out


victim_prefix.launches = 0
