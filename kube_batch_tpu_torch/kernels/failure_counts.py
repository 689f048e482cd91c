"""K4 · failure tallies (Triton), one launch per cycle.

Replaces kube_batch_tpu/framework/fit_errors.py · failure_counts: per
task, over the real and ready nodes, the count of predicate-vetoed nodes,
of nodes short on each resource dim (`req[r] > idle[r] and req[r] >=
eps[r]` among predicate-passing nodes that do not fit), and of fitting
nodes.

Bound on the card: bytes — the bool[T, N] mask is read once (0.54 GB at
the flagship shapes); the [N, R] idle rows stay in L2 and the outputs are
(2 + R) int32 per task.  Design: one program per block of BLOCK_T task
rows walks the node axis in BLOCK_N tiles and reduces boolean compares
into int32 counters; fit is recomputed on the fly, never stored.

Why Triton here and CUDA C++ for K1-K3: this is a pure row reduction of
boolean compares into integer counts, exact in any order.  It has no
float-order or FMA hazard and no segment walk, and Triton's block
reduction says it in a few lines.

`failure_counts` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
`triton` is imported, and the kernel defined, only when it first launches.
"""

from __future__ import annotations

import torch

BLOCK_T = 16
BLOCK_N = 256
#: Rows per chunk of the plain version (bounds its [rows, N] temporaries).
PLAIN_ROWS = 4096

def failure_counts_plain(pred, task_req, node_idle, eps, node_ok):
    """(predicate_failed i32[T], insufficient i32[T, R], feasible i32[T])."""
    T, R = task_req.shape
    dev = task_req.device
    pf = torch.empty(T, dtype=torch.int32, device=dev)
    ins = torch.empty((T, R), dtype=torch.int32, device=dev)
    fe = torch.empty(T, dtype=torch.int32, device=dev)
    ok = node_ok[None, :]
    for lo in range(0, T, PLAIN_ROWS):
        rows = slice(lo, min(T, lo + PLAIN_ROWS))
        p = pred[rows]
        q = task_req[rows]
        fit = torch.all(
            (q[:, None, :] <= node_idle[None, :, :]) | (q[:, None, :] < eps),
            dim=-1,
        )
        pf[rows] = ((~p) & ok).sum(dim=1).int()
        unfit = p & ~fit & ok
        fe[rows] = (p & fit & ok).sum(dim=1).int()
        for r in range(R):
            short = unfit & (q[:, None, r] > node_idle[None, :, r]) & (
                q[:, r] >= eps[r]
            )[:, None]
            ins[rows, r] = short.sum(dim=1).int()
    return pf, ins, fe


_kernel = None


def _compile():
    """Define the Triton kernel at first launch (this module is imported
    on machines without triton).  `tl` is bound as a module global here
    because Triton resolves the kernel's names in its module scope."""
    global _kernel, tl
    if _kernel is not None:
        return _kernel
    import triton
    import triton.language as tl

    @triton.jit
    def kernel(pred_ptr, req_ptr, idle_ptr, eps_ptr, ok_ptr,
               pf_ptr, ins_ptr, fe_ptr, T, N,
               R: tl.constexpr, RP: tl.constexpr,
               BT: tl.constexpr, BN: tl.constexpr):
        rows = tl.program_id(0) * BT + tl.arange(0, BT)
        rmask = rows < T
        rcol = tl.arange(0, RP)
        pf = tl.zeros([BT], dtype=tl.int32)
        fe = tl.zeros([BT], dtype=tl.int32)
        ins = tl.zeros([BT, RP], dtype=tl.int32)
        for n0 in range(0, N, BN):
            cols = n0 + tl.arange(0, BN)
            cmask = cols < N
            m2 = rmask[:, None] & cmask[None, :]
            p = tl.load(pred_ptr + rows[:, None].to(tl.int64) * N + cols[None, :],
                        mask=m2, other=0).to(tl.int32)
            ok = tl.load(ok_ptr + cols, mask=cmask, other=0).to(tl.int32)
            okb = (ok[None, :] != 0) & m2
            fit = m2
            for r in tl.static_range(R):
                q = tl.load(req_ptr + rows * R + r, mask=rmask, other=0.0)
                e = tl.load(eps_ptr + r)
                idle = tl.load(idle_ptr + cols * R + r, mask=cmask, other=0.0)
                fit = fit & ((q[:, None] <= idle[None, :]) | (q[:, None] < e))
            fit_i = fit.to(tl.int32)
            passed = (p != 0) & okb
            pf += tl.sum(((p == 0) & okb).to(tl.int32), axis=1)
            fe += tl.sum((passed & (fit_i != 0)).to(tl.int32), axis=1)
            unfit = passed & (fit_i == 0)
            for r in tl.static_range(R):
                q = tl.load(req_ptr + rows * R + r, mask=rmask, other=0.0)
                e = tl.load(eps_ptr + r)
                idle = tl.load(idle_ptr + cols * R + r, mask=cmask, other=0.0)
                short = unfit & (q[:, None] > idle[None, :]) & (q >= e)[:, None]
                cnt = tl.sum(short.to(tl.int32), axis=1)
                ins += tl.where(rcol[None, :] == r, cnt[:, None], 0)
        tl.store(pf_ptr + rows, pf, mask=rmask)
        tl.store(fe_ptr + rows, fe, mask=rmask)
        tl.store(ins_ptr + rows[:, None] * R + rcol[None, :], ins,
                 mask=rmask[:, None] & (rcol[None, :] < R))

    _kernel = kernel
    return kernel


def failure_counts(pred, task_req, node_idle, eps, node_ok):
    """Per-task tallies over the nodes where `node_ok` (real and ready)."""
    dev = task_req.device
    if dev.type == "cpu":
        return failure_counts_plain(pred, task_req, node_idle, eps, node_ok)
    if dev.type != "cuda":
        raise RuntimeError(f"failure_counts: unsupported device {dev}")
    import triton

    kernel = _compile()
    T, R = task_req.shape
    N = node_idle.shape[0]
    pf = torch.empty(T, dtype=torch.int32, device=dev)
    ins = torch.empty((T, R), dtype=torch.int32, device=dev)
    fe = torch.empty(T, dtype=torch.int32, device=dev)
    if T:
        kernel[(triton.cdiv(T, BLOCK_T),)](
            pred.contiguous().view(torch.uint8), task_req.contiguous(),
            node_idle.contiguous(), eps.contiguous(),
            node_ok.contiguous().view(torch.uint8), pf, ins, fe, T, N,
            R=R, RP=triton.next_power_of_2(R), BT=BLOCK_T, BN=BLOCK_N,
            num_warps=4,
        )
        failure_counts.launches += 1
    return pf, ins, fe


failure_counts.launches = 0
