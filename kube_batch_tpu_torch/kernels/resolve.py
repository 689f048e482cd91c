"""K3 · resolve conflicts and apply placements (CUDA C++,
`csrc/resolve.cu`), two entry points.

`resolve` replaces kube_batch_tpu/ops/assignment.py · _resolve_conflicts
whole (with its _segment_prefix): the (node, rank) sort of the round's
proposers, the per-node prefix fit, one_per_node, the per-node serialize
count and the global rank watermark, in one launch; `apply` replaces the
apply step of allocate_rounds.  What bounds each on the card, their
designs and the float64 prefix rule are noted in the source.

`resolve` returns the watermarked acceptances and the (node, rank) order
of the proposers for `apply`: `perm` (int64, sorted position → task row)
and `s_node` (int64, sorted position → proposed node; N for inactive
rows, which sort last).

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


INT32_MAX = 2**31 - 1


def sort_plain(prop_node, active, rank, num_nodes: int):
    """(perm, s_node): the stable sort of node_key·T + rank, node_key =
    N for an inactive row (node, then rank, then row; inactive rows
    last)."""
    T = rank.shape[0]
    node_key = torch.where(active, prop_node, num_nodes)
    s_key, perm = torch.sort(node_key.long() * T + rank.long(), stable=True)
    return perm, torch.div(s_key, T, rounding_mode="floor")


def prefix_accept_plain(perm, s_node, task_req, avail, eps, one_per_node,
                        serialize_mask):
    """bool[T]: the per-node prefix-fit acceptance over the sorted
    proposers, before the watermark."""
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


def resolve_plain(prop_node, active, rank, task_req, avail, eps,
                  one_per_node=False, serialize_mask=None, cancelled=None):
    """(kept, perm, s_node): the sort, the prefix fit and the watermark,
    in plain torch; `cancelled[0]` gains the acceptances the watermark
    cancelled."""
    perm, s_node = sort_plain(prop_node, active, rank, avail.shape[0])
    accept = prefix_accept_plain(perm, s_node, task_req, avail, eps,
                                 one_per_node, serialize_mask)
    rejected = active & ~accept
    watermark = torch.where(rejected, rank, INT32_MAX).amin()
    kept = accept & (rank < watermark)
    if cancelled is not None:
        cancelled.narrow(0, 0, 1).add_(torch.count_nonzero(accept & ~kept))
    return kept, perm, s_node


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


MAX_R = 8
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "kb_resolve": [_P] * 7 + [_I] * 4 + [_P] * 6,
    "kb_apply": [_P] * 4 + [_I] * 2 + [ctypes.c_int64] + [_I] * 2 + [_P] * 6,
    "kb_resolve_plan": [_I, _P, _P],
}


def _fn(name: str):
    return build.function("resolve", name, _SIGNATURES[name])


_RESOLVE_DTYPES = (torch.int32, torch.bool, torch.int32, torch.float32,
                   torch.float32, torch.float32)
_plans: dict[int, tuple[int, int]] = {}


def plan(T: int) -> tuple[int, int]:
    """(blocks, scratch bytes) of `resolve` over T rows on this card: the
    thread blocks of its cluster (0: the card places none) and the device
    memory it keeps the rows in where the cluster's shared memory does
    not hold them (0: none).  Asked of the kernel once per T."""
    got = _plans.get(T)
    if got is None:
        blocks, scratch = ctypes.c_int(0), ctypes.c_int64(0)
        build.check(_fn("kb_resolve_plan")(T, ctypes.byref(blocks), ctypes.byref(scratch)),
                    "resolve_plan")
        got = _plans[T] = (blocks.value, scratch.value)
    return got


def _resolve_args_ok(prop_node, active, rank, task_req, avail, eps,
                     serialize_mask, cancelled) -> bool:
    """One pass of attribute tests (the call is host-bound): dtypes,
    shapes, the card, contiguous rows."""
    T, R = task_req.shape
    N = avail.shape[0]
    return ((prop_node.dtype, active.dtype, rank.dtype, task_req.dtype,
             avail.dtype, eps.dtype) == _RESOLVE_DTYPES
            and prop_node.shape == active.shape == rank.shape == (T,)
            and avail.shape == (N, R) and eps.shape == (R,)
            and 1 <= R <= MAX_R and T >= 1 and N >= 1
            and prop_node.is_cuda and active.is_cuda and rank.is_cuda
            and task_req.is_cuda and avail.is_cuda and eps.is_cuda
            and prop_node.is_contiguous() and active.is_contiguous()
            and rank.is_contiguous() and task_req.is_contiguous()
            and avail.is_contiguous() and eps.is_contiguous()
            and (serialize_mask is None
                 or (serialize_mask.dtype == torch.bool and serialize_mask.shape == (T,)
                     and serialize_mask.is_cuda and serialize_mask.is_contiguous()))
            and (cancelled is None
                 or (cancelled.dtype == torch.int64 and cancelled.numel() >= 1
                     and cancelled.is_cuda and cancelled.is_contiguous())))


# kb_resolve's row scratch past 131,072 rows, by (device, stream): every
# launch writes what it reads there, so one buffer serves the calls of a
# stream (which run in order); grown when a call has more rows.  Kept, not
# allocated a call, so a captured round bakes in one that outlives it.
_row_scratch: dict = {}


def _row_scratch_for(dev, stream: int, nbytes: int) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _row_scratch.get(key)
    if buf is None or buf.numel() * 4 < nbytes:
        buf = _row_scratch[key] = torch.empty(-(-nbytes // 4), dtype=torch.int32,
                                              device=dev)
    return buf


def resolve(prop_node, active, rank, task_req, avail, eps,
            one_per_node: bool = False, serialize_mask=None, cancelled=None):
    """(kept bool[T], perm i64[T], s_node i64[T]) of one auction round:
    prop_node i32[T] (read where active, in [0, N)), active bool[T], rank
    i32[T] in [0, T), task_req f32[T, R], avail f32[N, R], eps f32[R], the
    optional serialize_mask bool[T] and the device counter cancelled i64
    (its element 0 gains the acceptances the watermark cancelled).  Every
    tensor on the card, contiguous, of those dtypes; nothing is converted
    (others raise).  The kernel takes any T (past 131,072 rows on an H100
    through a device-memory scratch of 16 bytes a row, kept per device and
    stream)."""
    if prop_node.device.type == "cpu":
        return resolve_plain(prop_node, active, rank, task_req, avail, eps,
                             one_per_node, serialize_mask, cancelled)
    if prop_node.device.type != "cuda":
        raise RuntimeError(f"resolve: unsupported device {prop_node.device}")
    if not _resolve_args_ok(prop_node, active, rank, task_req, avail, eps,
                            serialize_mask, cancelled):
        raise ValueError(
            "resolve takes int32 prop_node and rank, bool active, float32 task_req, "
            "avail and eps, bool serialize_mask and int64 cancelled (or None), "
            "contiguous, on the card; got "
            f"{[(x.dtype, tuple(x.shape), x.device.type) for x in (prop_node, active, rank, task_req, avail, eps, serialize_mask, cancelled) if x is not None]}")
    T, R = task_req.shape
    N = avail.shape[0]
    dev = task_req.device
    blocks, scratch_bytes = plan(T)
    if blocks == 0:
        raise RuntimeError(f"resolve: this card places no cluster for {T} task rows")
    perm = torch.empty(T, dtype=torch.int64, device=dev)
    s_node = torch.empty(T, dtype=torch.int64, device=dev)
    kept = torch.empty(T, dtype=torch.bool, device=dev)
    stream = build.stream_handle(dev)
    scratch = _row_scratch_for(dev, stream, scratch_bytes) if scratch_bytes else None
    err = _fn("kb_resolve")(
        prop_node.data_ptr(), active.data_ptr(), rank.data_ptr(), task_req.data_ptr(),
        avail.data_ptr(), eps.data_ptr(),
        None if serialize_mask is None else serialize_mask.data_ptr(),
        int(one_per_node), T, N, R, perm.data_ptr(), s_node.data_ptr(), kept.data_ptr(),
        None if cancelled is None else cancelled.data_ptr(),
        None if scratch is None else scratch.data_ptr(), stream)
    build.check(err, "resolve")
    resolve.launches += 1
    return kept, perm, s_node


# kb_apply's persistent scratch, by (device, stream): zero between calls
# (the kernel leaves it so); grown, zeroed, when a call has more nodes.
# Calls on one stream run in order, so one buffer serves them all, and a
# stream of its own (a graph's capture stream) gets its own.  Its layout
# (csrc/resolve.cu · ApplyScratch): f64[N, MAX_R + 1], then u64[N].
_apply_scratch: dict = {}


def _apply_scratch_for(dev, stream: int, N: int) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _apply_scratch.get(key)
    need = N * (MAX_R + 2) * 8
    if buf is None or buf.numel() < need:
        buf = _apply_scratch[key] = torch.zeros(need, dtype=torch.uint8, device=dev)
    return buf


def apply(perm, s_node, accept, task_req, node_future, node_idle,
          use_future: bool, new_status: int, task_state, task_node) -> None:
    """Land accepted placements in place: node_future (and node_idle in
    the Idle pass) lose each node's summed accepted requests;
    task_state/task_node of accepted rows are set.  On the card: one
    launch over the sorted positions (`perm`, `s_node` from `resolve`),
    any T; the float64 sums of runs that span blocks meet in a scratch
    kept per device and stream, zero between calls (allocated at the
    first call, and again only for more nodes)."""
    if not _cuda(perm):
        apply_plain(perm, s_node, accept, task_req, node_future, node_idle,
                    use_future, new_status, task_state, task_node)
        return
    T = perm.shape[0]
    N, R = node_future.shape
    if not ((perm.dtype, s_node.dtype, accept.dtype, task_req.dtype, node_future.dtype,
             node_idle.dtype, task_state.dtype, task_node.dtype) == _APPLY_DTYPES
            and s_node.shape == accept.shape == (T,) and task_req.shape[1:] == (R,)
            and node_idle.shape == (N, R) and 1 <= R <= MAX_R and N >= 1
            and all(x.is_cuda and x.is_contiguous() for x in (
                perm, s_node, accept, task_req, node_future, node_idle, task_state,
                task_node))):
        raise ValueError(
            "apply takes int64 perm and s_node, bool accept, float32 task_req, "
            "node_future and node_idle, int32 task_state and task_node, contiguous, on "
            "the card; got "
            f"{[(x.dtype, tuple(x.shape), x.device.type) for x in (perm, s_node, accept, task_req, node_future, node_idle, task_state, task_node)]}")
    dev = perm.device
    stream = build.stream_handle(dev)
    scratch = _apply_scratch_for(dev, stream, N)
    err = _fn("kb_apply")(
        perm.data_ptr(), s_node.data_ptr(), accept.data_ptr(), task_req.data_ptr(),
        int(use_future), int(new_status), T, N, R, node_future.data_ptr(),
        node_idle.data_ptr(), task_state.data_ptr(), task_node.data_ptr(),
        scratch.data_ptr(), stream)
    build.check(err, "apply")
    apply.launches += 1


_APPLY_DTYPES = (torch.int64, torch.int64, torch.bool, torch.float32, torch.float32,
                 torch.float32, torch.int32, torch.int32)


resolve.launches = 0
apply.launches = 0
