"""K3 · resolve conflicts and apply placements (CUDA C++,
`csrc/resolve.cu`), two entry points.

Replaces kube_batch_tpu/ops/assignment.py · _segment_prefix,
_resolve_conflicts (before its global watermark, which stays torch glue in
ops/assignment.py) and the apply step of allocate_rounds.  What bounds it
on the card, its design and its float64 prefix rule are noted in the
source.

Both take the proposers sorted by (node, rank): `perm` (int64, sorted
position → task row) and `s_node` (int64, sorted position → proposed
node; N for inactive rows, which sort last).

Each wrapper runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from kube_batch_tpu_torch.kernels import build


def segment_exclusive_prefix(
    s_seg: torch.Tensor, s_vals: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(before f64[T, C], is_start bool[T]) for rows already sorted by
    segment id `s_seg`: before[i] is the sum of `s_vals` over the earlier
    rows of row i's segment, is_start marks each segment's first row.

    float64 makes the prefix exact for integer values below 2**53 (the
    precision rule noted in csrc/resolve.cu).  One contiguous 1-D scan
    per column: a scan along dim 0 of the [T, C] matrix runs as a strided
    outer-dim scan on CUDA, about 10 ms per call at T = 65536 (profiled
    on an H100), where a contiguous one takes microseconds."""
    T = s_seg.shape[0]
    v = s_vals.double()
    incl = torch.stack([torch.cumsum(col, dim=0) for col in v.T.contiguous()],
                       dim=1)
    is_start = torch.ones(T, dtype=torch.bool, device=s_seg.device)
    is_start[1:] = s_seg[1:] != s_seg[:-1]
    idx = torch.arange(T, device=s_seg.device)
    start_idx = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    before = incl - (incl[start_idx] - v[start_idx]) - v
    return before, is_start


def resolve_plain(perm, s_node, task_req, avail, eps, one_per_node,
                  serialize_mask):
    T = perm.shape[0]
    N = avail.shape[0]
    real = s_node < N
    node = torch.clamp(s_node, max=N - 1)
    s_req32 = task_req[perm]
    before, is_start = segment_exclusive_prefix(s_node, s_req32)
    within = before + s_req32.double()
    fit = torch.all(
        (within <= avail[node].double()) | (s_req32 < eps), dim=1
    )
    s_accept = real & fit
    if one_per_node:
        s_accept = s_accept & is_start
    elif serialize_mask is not None:
        # at most one accepted serialize-set member per node: the first
        s_part = serialize_mask[perm] & s_accept
        seg_before, _ = segment_exclusive_prefix(s_node, s_part[:, None])
        s_accept = s_accept & (~s_part | (seg_before[:, 0] == 0))
    accept = torch.zeros(T, dtype=torch.bool, device=perm.device)
    accept[perm] = s_accept
    return accept


def apply_plain(perm, s_node, accept, task_req, node_future, node_idle,
                use_future, new_status, task_state, task_node):
    N = node_future.shape[0]
    s_acc = accept[perm] & (s_node < N)
    seg = torch.where(s_acc, s_node, N)
    delta = torch.zeros((N + 1, task_req.shape[1]), dtype=torch.float64,
                        device=perm.device)
    delta.index_add_(0, seg, torch.where(s_acc[:, None],
                                         task_req[perm].double(), 0.0))
    touched = torch.zeros(N + 1, dtype=torch.bool, device=perm.device)
    touched[seg] = True
    d = delta[:N].float()
    t = touched[:N, None]
    node_future.copy_(torch.where(t, node_future - d, node_future))
    if not use_future:
        node_idle.copy_(torch.where(t, node_idle - d, node_idle))
    rows = perm[s_acc]
    task_state[rows] = new_status
    task_node[rows] = s_node[s_acc].int()


def _cuda(t) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"resolve: unsupported device {t.device}")
    return True


_P, _I = ctypes.c_void_p, ctypes.c_int


def resolve(perm, s_node, task_req, avail, eps, one_per_node: bool,
            serialize_mask) -> torch.Tensor:
    """bool[T]: per-node prefix-fit acceptance (before the watermark)."""
    if not _cuda(perm):
        return resolve_plain(perm, s_node, task_req, avail, eps,
                             one_per_node, serialize_mask)
    fn = build.library("resolve").kb_resolve
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P]
    fn.restype = ctypes.c_int
    T = perm.shape[0]
    N, R = avail.shape
    accept = torch.zeros(T, dtype=torch.bool, device=perm.device)
    c = [x.contiguous() for x in (perm, s_node, task_req, avail, eps)]
    ser = None if serialize_mask is None else serialize_mask.contiguous()
    err = fn(*(build.ptr(x) for x in c), build.ptr(ser), int(one_per_node),
             T, N, R, build.ptr(accept), build.stream_handle(perm.device))
    build.check(err, "resolve")
    resolve.launches += 1
    return accept


def apply(perm, s_node, accept, task_req, node_future, node_idle,
          use_future: bool, new_status: int, task_state, task_node) -> None:
    """Land accepted placements in place: node_future (and node_idle in
    the Idle pass) lose each node's summed accepted requests;
    task_state/task_node of accepted rows are set."""
    if not _cuda(perm):
        apply_plain(perm, s_node, accept, task_req, node_future, node_idle,
                    use_future, new_status, task_state, task_node)
        return
    for t in (node_future, node_idle, task_state, task_node):
        if not t.is_contiguous():
            raise ValueError("apply updates contiguous tensors in place")
    fn = build.library("resolve").kb_apply
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
    fn.restype = ctypes.c_int
    T = perm.shape[0]
    N, R = node_future.shape
    c = [x.contiguous() for x in (perm, s_node, accept, task_req)]
    err = fn(*(build.ptr(x) for x in c), int(use_future), int(new_status),
             T, N, R, build.ptr(node_future), build.ptr(node_idle),
             build.ptr(task_state), build.ptr(task_node),
             build.stream_handle(perm.device))
    build.check(err, "apply")
    apply.launches += 1


resolve.launches = 0
apply.launches = 0
