"""K5 · victim prefix (CUDA C++, `csrc/victim_prefix.cu`).

Replaces kube_batch_tpu/ops/preemption.py · _min_victims_per_node and
choose_node's feasible mask and argmin node: the whole node choice of an
opening preemption step, in one launch up to CTA_MAX_T rows.  What bounds
it on the card, its two sort routes and its float64 prefix rule are
noted in the source.

`victim_prefix(victims, task_node, rank, req, future, eps, p, preq_rows,
pred, node_ok, excl, dyn_row)` takes the candidate victims (bool[T], on
their nodes task_node i32[T]) with their dense ranks (i32[T], in
[0, T); sacrifice order is T-1-rank, ties by row), their requests
f32[T, R], FutureIdle f32[N, R] and eps f32[R]; the preemptor `p` as an
int64 device scalar, its request row p of `preq_rows` f32[P, R] and its
predicate row p of `pred` bool[P, N]; node_ok, excl and the optional
dyn_row: a bool[N] row, or the preemptor's inter-pod affinity row as
`kernels/affinity.py · AffinityRow` (with its optional bool[N] mask),
which the kernel tests node by node itself (kernel K10's row test, in
this launch).  A node may take the plan when pred[p] & node_ok & ~excl
(& dyn_row).  It returns one buffer i32[N + 5]: k[N], where k[n] is
the fewest victims of node n whose release makes the preemptor fit its
FutureIdle (0 when it fits with none, BIG_K when no prefix does), then
[n_best, any_feasible, first victim on n_best, any victim on n_best,
fits n_best with no victim] — n_best the lowest-index allowed node with
the smallest k, 0 when none is feasible.  Nothing is read on the host.

The wrapper runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
Above CTA_MAX_T rows (or when (N + 1)·T passes 2^32) it sorts with K8's
`sort_by_segment` and launches the walk over the sorted rows.
"""

from __future__ import annotations

import ctypes

import torch

from kube_batch_tpu_torch.kernels import build
from kube_batch_tpu_torch.kernels import lex_rank
from kube_batch_tpu_torch.kernels.affinity import AffinityRow
from kube_batch_tpu_torch.kernels.resolve import segment_exclusive_prefix

BIG_K = (2**31 - 1) // 4
MAX_R = 8
CTA_MAX_T = lex_rank.CTA_MAX_T
#: the block chooses its sort (counting, or radix for a long run); the
#: radix route forced, for the check script's comparison
ROUTE_AUTO, ROUTE_RADIX = 0, 1

_P, _I = ctypes.c_void_p, ctypes.c_int
_ROW = [_P] * 10 + [_I] * 3      # the row operand (affinity.AffinityRow.kernel_args)
_NO_ROW = (None,) * 10 + (0, 0, 0)
_SIGNATURES = {
    "kb_victim_choose": [_P] * 12 + _ROW + [_I] * 5 + [_P, _P],
    "kb_victim_walk": [_P] * 11 + _ROW + [_I] * 3 + [_P, _P],
}


def _fn(name: str):
    return build.function("victim_prefix", name, _SIGNATURES[name])


def _fits(req, avail, eps):
    return torch.all((req <= avail) | (req < eps), dim=-1)


def victim_walk_plain(perm, s_node, task_req, future, preq, eps, ok):
    """(k i32[N], out i32[5]) from victims sorted by (node, sacrifice):
    `perm` (sorted position → row) and `s_node` (sorted position → node,
    N for non-victims, which sort last), the preemptor's request `preq`
    and the allowed nodes `ok`."""
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


def _allowed(p, pred, node_ok, excl, dyn_row):
    ok = pred[p] & node_ok & ~excl
    if isinstance(dyn_row, AffinityRow):
        dyn_row = dyn_row.row_plain()
    return ok if dyn_row is None else ok & dyn_row


def victim_prefix_plain(victims, task_node, rank, req, future, eps, p, preq_rows,
                        pred, node_ok, excl, dyn_row):
    T, N = victims.shape[0], future.shape[0]
    vnode = torch.where(victims, task_node, N)
    perm, s_node = lex_rank.sort_by_segment_plain(vnode, T - 1 - rank, N)
    k, out = victim_walk_plain(perm, s_node, req, future, preq_rows[p], eps,
                               _allowed(p, pred, node_ok, excl, dyn_row))
    return torch.cat([k, out])


_DTYPES = (torch.bool, torch.int32, torch.int32, torch.float32, torch.float32,
           torch.float32, torch.int64, torch.float32, torch.bool, torch.bool, torch.bool)


def _args_ok(victims, task_node, rank, req, future, eps, p, preq_rows, pred, node_ok,
             excl, dyn_row, row) -> bool:
    """One pass of attribute tests (the call is host-bound): dtypes,
    shapes, the card, contiguous rows (the row operand checks its own)."""
    T, R = req.shape
    N = future.shape[0]
    return ((victims.dtype, task_node.dtype, rank.dtype, req.dtype, future.dtype,
             eps.dtype, p.dtype, preq_rows.dtype, pred.dtype, node_ok.dtype,
             excl.dtype) == _DTYPES
            and victims.shape == task_node.shape == rank.shape == (T,)
            and future.shape == (N, R) and eps.shape == (R,) and p.numel() == 1
            and preq_rows.shape[1:] == (R,) and pred.shape[1:] == (N,)
            and node_ok.shape == excl.shape == (N,)
            and (dyn_row is None or (dyn_row.dtype == torch.bool and dyn_row.shape == (N,)
                                     and dyn_row.is_cuda and dyn_row.is_contiguous()))
            and (row is None or row.resident.N == N)
            and 1 <= R <= MAX_R and T >= 1 and N >= 1
            and victims.is_cuda and task_node.is_cuda and rank.is_cuda and req.is_cuda
            and future.is_cuda and eps.is_cuda and p.is_cuda and preq_rows.is_cuda
            and pred.is_cuda and node_ok.is_cuda and excl.is_cuda
            and victims.is_contiguous() and task_node.is_contiguous()
            and rank.is_contiguous() and req.is_contiguous() and future.is_contiguous()
            and eps.is_contiguous() and preq_rows.is_contiguous() and pred.is_contiguous()
            and node_ok.is_contiguous() and excl.is_contiguous())


def victim_prefix(victims, task_node, rank, req, future, eps, p, preq_rows, pred,
                  node_ok, excl, dyn_row, *, route: int = ROUTE_AUTO):
    """i32[N + 5]: k[N], then the choice — see the module docstring.
    Every tensor on the card, contiguous, of the dtypes above; nothing is
    converted (others raise)."""
    if victims.device.type == "cpu":
        return victim_prefix_plain(victims, task_node, rank, req, future, eps, p,
                                   preq_rows, pred, node_ok, excl, dyn_row)
    if victims.device.type != "cuda":
        raise RuntimeError(f"victim_prefix: unsupported device {victims.device}")
    row = dyn_row if isinstance(dyn_row, AffinityRow) else None
    if row is not None:
        dyn_row = row.mask
    if not _args_ok(victims, task_node, rank, req, future, eps, p, preq_rows, pred,
                    node_ok, excl, dyn_row, row):
        raise ValueError(
            "victim_prefix takes bool victims, int32 task_node and rank, float32 req, "
            "future and eps, an int64 p, float32 preq_rows, bool pred, node_ok, excl and "
            "dyn_row (or None, or an AffinityRow of N nodes), contiguous, on the card; got "
            f"{[(x.dtype, tuple(x.shape), x.device.type) for x in (victims, task_node, rank, req, future, eps, p, preq_rows, pred, node_ok, excl) if x is not None]}")
    T, R = req.shape
    N = future.shape[0]
    dev = req.device
    out = torch.empty(N + 5, dtype=torch.int32, device=dev)
    stream = build.stream_handle(dev)
    row_args = _NO_ROW if row is None else row.kernel_args("victim_prefix", dev)
    if T <= CTA_MAX_T and (N + 1) * T <= 2**32:
        err = _fn("kb_victim_choose")(
            victims.data_ptr(), task_node.data_ptr(), rank.data_ptr(), req.data_ptr(),
            future.data_ptr(), eps.data_ptr(), p.data_ptr(), preq_rows.data_ptr(),
            pred.data_ptr(), node_ok.data_ptr(), excl.data_ptr(),
            None if dyn_row is None else dyn_row.data_ptr(), *row_args, T, N, R,
            lex_rank.sort_passes(T, N), route, out.data_ptr(), stream)
    else:
        perm, s_node = lex_rank.sort_by_segment(torch.where(victims, task_node, N),
                                                T - 1 - rank, N)
        err = _fn("kb_victim_walk")(
            perm.data_ptr(), s_node.data_ptr(), req.data_ptr(), future.data_ptr(),
            eps.data_ptr(), p.data_ptr(), preq_rows.data_ptr(), pred.data_ptr(),
            node_ok.data_ptr(), excl.data_ptr(),
            None if dyn_row is None else dyn_row.data_ptr(), *row_args, T, N, R,
            out.data_ptr(), stream)
    build.check(err, "victim_prefix")
    victim_prefix.launches += 1
    return out


victim_prefix.launches = 0
