"""K6 · the per-step scans of the preemption loop (CUDA C++,
`csrc/preempt_scan.cu`), two entry points; each step launches one.

Replaces the [T]- and [T, N]-wide reductions of the step body of
kube_batch_tpu/ops/preemption.py · preemption_rounds.  What bounds it on
the card and its design are noted in the source.

* `preempt_open` (no plan is open) → i32[4] [p_new, any_eligible,
  any_victim_possible, any_direct_fit]: the rank-first eligible task
  (lowest index on ties, 0 when none), whether any task is evictable at
  all, and whether any eligible task fits some ready node's FutureIdle
  directly.
* `preempt_continue` (a plan is open) → (v i64[], any_victim, fit_now,
  viable bool[]): the continuing step's whole classification — the
  victim on the plan's node n with the smallest sacrifice (−rank; lowest
  index on ties, 0 when none), whether n holds one, whether the
  preemptor p fits n's FutureIdle, and whether p's dynamic row (a bool[N]
  row, or the inter-pod affinity row operand `kernels/affinity.py ·
  AffinityRow` with its optional mask) allows n (True without a row).
  p and n are the plan's int64 device scalars, read on the card.  The
  outputs are views of a `ContinueBuffer` the caller keeps (the
  preemption loop's carry), so a call allocates nothing.

The direct-fit test is a boolean any() over elementwise fp32 compares,
with no accumulation, so it is exact in any order.

`preempt_open` launches a grid over the whole card (tiles of eligible
rows × ready nodes, a global found flag that stops every block after the
first fit, the argmin as a 64-bit atomic on the packed key rank·2³² + t,
the last block writing the outputs): a memset of its scratch words, which
share one allocation with the outputs, and one launch per call;
`preempt_continue` is one launch of a grid over the rows, its scratch in
the kept buffer and cleared by its last block.  The ctypes functions are
bound once.

Each wrapper runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from kube_batch_tpu_torch.kernels import build
from kube_batch_tpu_torch.kernels.affinity import AffinityRow

INT32_MAX = 2**31 - 1
MAX_R = 8
SCRATCH_WORDS = 6        # preempt_open's scratch: key (2 words), found, possible, ticket
_ALLOCATED = (1, 3, 4, 5)   # api/types.py · ALLOCATED_STATUSES

_P, _I = ctypes.c_void_p, ctypes.c_int
_ROW = [_P] * 10 + [_I] * 3      # the row operand (affinity.AffinityRow.kernel_args)
_NO_ROW = (None,) * 10 + (0, 0, 0)
_SIGNATURES = {
    "kb_preempt_open": [_I, _I, _I] + [_P] * 10 + [_P, _P, _P],
    "kb_preempt_continue": [_I, _I] + [_P] * 9 + _ROW + [_P, _P],
}


def _fn(name: str):
    return build.function("preempt_scan", name, _SIGNATURES[name])


def _allocated(state):
    m = torch.zeros_like(state, dtype=torch.bool)
    for s in _ALLOCATED:
        m = m | (state == s)
    return m


def preempt_open_plain(rank, elig, snap_state, live_state, task_mask, prov,
                       task_req, future, node_ok, eps):
    p_new = torch.argmin(torch.where(elig, rank, INT32_MAX))
    possible = (_allocated(snap_state) & _allocated(live_state) & task_mask
                & ~prov).any()
    # fits(req[t], future[n]) over the eligible rows and ready nodes only
    # (the gather keeps the CPU's work to the rows that matter), one
    # resource dim at a time; every dim is compared, with no host branch
    req = task_req[elig]
    avail = future[node_ok]
    small = req < eps
    fit = torch.ones(req.shape[0], avail.shape[0], dtype=torch.bool, device=req.device)
    for r in range(req.shape[1]):
        fit &= (req[:, None, r] <= avail[None, :, r]) | small[:, None, r]
    return torch.stack([p_new, elig.any().long(), possible.long(),
                        fit.any().long()]).to(torch.int32)


class ContinueBuffer:
    """preempt_continue's outputs and scratch words in one allocation of
    32 bytes, zeroed once and kept across the steps of a preemption loop:
    `outputs` are (v i64[], any_victim, fit_now, viable bool[]), views
    made once; bytes 16-27 are the kernel's scratch, zero between calls
    (its last block clears them)."""

    BYTES = 32

    def __init__(self, device) -> None:
        self.buf = torch.zeros(self.BYTES, dtype=torch.uint8, device=device)
        b = self.buf
        self.outputs = (b[:8].view(torch.int64)[0], b[8:9].view(torch.bool)[0],
                        b[9:10].view(torch.bool)[0], b[10:11].view(torch.bool)[0])


def _row_plain(dyn_row):
    return dyn_row.row_plain() if isinstance(dyn_row, AffinityRow) else dyn_row


def preempt_continue_plain(rank, victims, task_node, task_req, future, eps, p, n,
                           dyn_row=None):
    T = rank.shape[0]
    on_n = victims & (task_node == n)
    v = torch.argmin(torch.where(on_n, T - 1 - rank, INT32_MAX))
    preq = task_req[p]
    fit_now = torch.all((preq <= future[n]) | (preq < eps))
    row = _row_plain(dyn_row)
    viable = (torch.ones((), dtype=torch.bool, device=rank.device) if row is None
              else row[n])
    return v, on_n.any(), fit_now, viable


def _on_card(t, what: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {t.device}")
    return True


def preempt_open(rank, elig, snap_state, live_state, task_mask, prov,
                 task_req, future, node_ok, eps):
    """i32[4] — see the module docstring."""
    if not rank.is_cuda:
        _on_card(rank, "preempt_open")    # raises for another device than the CPU
        return preempt_open_plain(rank, elig, snap_state, live_state, task_mask,
                                  prov, task_req, future, node_ok, eps)
    T = rank.shape[0]
    N, R = future.shape
    if R > MAX_R:
        raise ValueError(f"preempt_open: at most {MAX_R} resource dims, got {R}")
    # the contiguous tensors are kept (not only their pointers) until the
    # launch is queued
    c = [x if x.is_contiguous() else x.contiguous()
         for x in (rank, elig, snap_state, live_state, task_mask, prov, task_req,
                   future, node_ok, eps)]
    # the four outputs, then the scratch words (zeroed by kb_preempt_open),
    # 8-byte aligned for the 64-bit key
    buf = rank.new_empty(4 + SCRATCH_WORDS, dtype=torch.int32)
    ptr = buf.data_ptr()
    err = _fn("kb_preempt_open")(T, N, R, *(x.data_ptr() for x in c), ptr, ptr + 16,
                                 build.stream_handle(rank.device))
    build.check(err, "preempt_open")
    preempt_open.launches += 1
    return buf[:4]


def _continue_args_ok(rank, victims, task_node, task_req, future, eps, p, n, mask,
                      row) -> bool:
    """One pass of attribute tests (the call is host-bound): dtypes,
    shapes, the card."""
    T, R = task_req.shape
    N = future.shape[0]
    return (rank.dtype == torch.int32 and victims.dtype == torch.bool
            and task_node.dtype == torch.int32 and task_req.dtype == torch.float32
            and future.dtype == torch.float32 and eps.dtype == torch.float32
            and p.dtype == torch.int64 and n.dtype == torch.int64
            and rank.shape == victims.shape == task_node.shape == (T,)
            and future.shape == (N, R) and eps.shape == (R,) and p.numel() == 1
            and n.numel() == 1 and 1 <= R <= MAX_R and T >= 1
            and victims.is_cuda and task_node.is_cuda and task_req.is_cuda
            and future.is_cuda and eps.is_cuda and p.is_cuda and n.is_cuda
            and (mask is None or (mask.dtype == torch.bool and mask.shape == (N,)
                                  and mask.is_cuda))
            and (row is None or row.resident.N == N))


def preempt_continue(rank, victims, task_node, task_req, future, eps, p, n,
                     dyn_row=None, out: ContinueBuffer | None = None):
    """(v, any_victim, fit_now, viable) — see the module docstring.  On
    the card every tensor is of the dtypes above (nothing is converted;
    others raise; a tensor that is not contiguous is copied), and the
    outputs are views of `out` (a new ContinueBuffer when None)."""
    if not _on_card(rank, "preempt_continue"):
        return preempt_continue_plain(rank, victims, task_node, task_req, future, eps, p,
                                      n, dyn_row)
    row = dyn_row if isinstance(dyn_row, AffinityRow) else None
    mask = row.mask if row is not None else dyn_row
    if not _continue_args_ok(rank, victims, task_node, task_req, future, eps, p, n, mask,
                             row):
        raise ValueError(
            "preempt_continue takes int32 rank and task_node, bool victims, float32 "
            "task_req, future and eps, int64 p and n, and a bool[N] row or an "
            "AffinityRow of N nodes or None, on the card; got "
            f"{[(x.dtype, tuple(x.shape), x.device.type) for x in (rank, victims, task_node, task_req, future, eps, p, n)]}")
    # the contiguous tensors are kept (not only their pointers) until the
    # launch is queued
    args = [None if x is None else x if x.is_contiguous() else x.contiguous()
            for x in (rank, victims, task_node, task_req, future, eps, p, n, mask)]
    if out is None:
        out = ContinueBuffer(rank.device)
    row_args = _NO_ROW if row is None else row.kernel_args("preempt_continue", rank.device)
    T, R = task_req.shape
    err = _fn("kb_preempt_continue")(
        T, R, *[None if x is None else x.data_ptr() for x in args], *row_args,
        out.buf.data_ptr(), build.stream_handle(rank.device))
    build.check(err, "preempt_continue")
    preempt_continue.launches += 1
    return out.outputs


preempt_open.launches = 0
preempt_continue.launches = 0
