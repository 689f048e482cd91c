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
* `preempt_continue` (a plan is open on node `n`) → i32[2] [v,
  any_victim]: the victim on n with the smallest sacrifice (−rank;
  lowest index on ties, 0 when none).

The direct-fit test is a boolean any() over elementwise fp32 compares,
with no accumulation, so it is exact in any order.

`preempt_open` launches a grid over the whole card (tiles of eligible
rows × ready nodes, a global found flag that stops every block after the
first fit, the argmin as a 64-bit atomic on the packed key rank·2³² + t,
the last block writing the outputs): a memset of its scratch words, which
share one allocation with the outputs, and one launch per call;
`preempt_continue` is one block.  The ctypes functions are bound once.

Each wrapper runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from kube_batch_tpu_torch.kernels import build

INT32_MAX = 2**31 - 1
MAX_R = 8
SCRATCH_WORDS = 6        # preempt_open's scratch: key (2 words), found, possible, ticket
_ALLOCATED = (1, 3, 4, 5)   # api/types.py · ALLOCATED_STATUSES

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "kb_preempt_open": [_I, _I, _I] + [_P] * 10 + [_P, _P, _P],
    "kb_preempt_continue": [_I, _P, _P, _P, _I, _P, _P],
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


def preempt_continue_plain(rank, victims, task_node, n: int):
    T = rank.shape[0]
    on_n = victims & (task_node == n)
    v = torch.argmin(torch.where(on_n, T - 1 - rank, INT32_MAX))
    return torch.stack([v, on_n.any().long()]).to(torch.int32)


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


def preempt_continue(rank, victims, task_node, n: int):
    """i32[2] — see the module docstring."""
    if not _on_card(rank, "preempt_continue"):
        return preempt_continue_plain(rank, victims, task_node, n)
    c = [x.contiguous() for x in (rank, victims, task_node)]
    out = torch.empty(2, dtype=torch.int32, device=rank.device)
    err = _fn("kb_preempt_continue")(rank.shape[0], *(build.ptr(x) for x in c),
                                     int(n), build.ptr(out),
                                     build.stream_handle(rank.device))
    build.check(err, "preempt_continue")
    preempt_continue.launches += 1
    return out


preempt_open.launches = 0
preempt_continue.launches = 0
