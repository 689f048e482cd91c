"""K4 · failure tallies (CUDA C++, `csrc/failure_counts.cu`), one launch
per cycle.

Replaces kube_batch_tpu/framework/fit_errors.py · failure_counts: per
task, over the real and ready nodes, the count of nodes its predicates
veto, of nodes short on each resource dim (`req[r] > idle[r] and req[r]
>= eps[r]` among predicate-passing nodes that do not fit), and of
fitting nodes; and the count of real and ready nodes.  What bounds it on
the card and its design are noted in the source.

The predicate is the static mask `pred` ANDed with the dynamic
predicates `dyn`, which come as a second bool[T, N] mask, as the inter-pod
affinity words of kernel K10 (`kernels/affinity.py · AffinityWords`,
tested inside the launch with kernel K2's test, once per class of rows
with equal requests and words and per node), or as None.  The plain version ANDs `pred` with the words' plain cell test
(`affinity.affinity_cells_plain`).

`failure_counts` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors (or raises); it never falls back from one to the
other.  The ctypes function is bound once.
"""

from __future__ import annotations

import ctypes

import torch

from kube_batch_tpu_torch.kernels import build
from kube_batch_tpu_torch.kernels.affinity import AffinityWords, affinity_cells_plain
from kube_batch_tpu_torch.kernels.resident import words

MAX_R = 8
MAX_WORDS = 8            # words a vocabulary (K, K2 <= 256)
#: Rows per chunk of the plain version (bounds its [rows, N] temporaries).
PLAIN_ROWS = 4096

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_P] * 5 + [_I] * 2 + [_P] * 4 + [_I] * 3 + [_P] * 5


def _outputs(T: int, R: int, dev):
    """(pf i32[T], ins i32[T, R], fe i32[T], nodes i32[]) in one allocation."""
    buf = torch.empty(T * (2 + R) + 1, dtype=torch.int32, device=dev)
    return (buf[:T], buf[T:T + T * R].view(T, R), buf[T + T * R:T * (2 + R)],
            buf[T * (2 + R)])


def failure_counts_plain(pred, dyn, task_req, node_idle, eps, node_ok):
    """(predicate_failed i32[T], insufficient i32[T, R], feasible i32[T],
    nodes i32[])."""
    T, R = task_req.shape
    pf, ins, fe, nodes = _outputs(T, R, task_req.device)
    nodes.copy_(node_ok.sum())
    ok = node_ok[None, :]
    for lo in range(0, T, PLAIN_ROWS):
        rows = slice(lo, min(T, lo + PLAIN_ROWS))
        p = pred[rows]
        if isinstance(dyn, AffinityWords):
            p = p & affinity_cells_plain(dyn.rows(rows))
        elif dyn is not None:
            p = p & dyn[rows]
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
    return pf, ins, fe, nodes


def _args_ok(pred, mask, task_req, node_idle, eps, node_ok, w) -> bool:
    """One pass of attribute tests (the call's host time counts): dtypes,
    shapes, the card; the words' own shapes are tested apart."""
    T, R = task_req.shape
    N = node_idle.shape[0]
    return (pred.dtype == torch.bool and task_req.dtype == torch.float32
            and node_idle.dtype == torch.float32 and eps.dtype == torch.float32
            and node_ok.dtype == torch.bool and pred.shape == (T, N)
            and node_idle.shape == (N, R) and eps.shape == (R,) and node_ok.shape == (N,)
            and 1 <= R <= MAX_R and pred.is_cuda and task_req.is_cuda and node_idle.is_cuda
            and eps.is_cuda and node_ok.is_cuda
            and (mask is None or (mask.dtype == torch.bool and mask.shape == (T, N)
                                  and mask.is_cuda))
            and (w is None or (w.task_words.dtype == torch.int32 and w.task_words.is_cuda
                               and w.node_words.dtype == torch.int32
                               and w.node_words.is_cuda and w.thr.dtype == torch.int32
                               and w.thr.is_cuda)))


_kernel = None


def failure_counts(pred, dyn, task_req, node_idle, eps, node_ok):
    """(predicate_failed, insufficient, feasible, nodes) over the nodes
    where `node_ok` (real and ready), the predicate `pred` & `dyn` — see
    the module docstring.  On the card nothing is converted (other dtypes
    raise); a tensor that is not contiguous is copied."""
    global _kernel
    dev = task_req.device
    if dev.type == "cpu":
        return failure_counts_plain(pred, dyn, task_req, node_idle, eps, node_ok)
    if dev.type != "cuda":
        raise RuntimeError(f"failure_counts: unsupported device {dev}")
    T, R = task_req.shape
    N = node_idle.shape[0]
    w = dyn if isinstance(dyn, AffinityWords) else None
    mask = None if w is not None else dyn
    if not _args_ok(pred, mask, task_req, node_idle, eps, node_ok, w):
        raise ValueError(
            "failure_counts takes bool pred [T, N] and node_ok [N], float32 task_req "
            f"[T, R <= {MAX_R}], node_idle [N, R] and eps [R], and a bool [T, N] mask, "
            "AffinityWords or None as dyn, on the card; got "
            f"{[(x.dtype, tuple(x.shape), x.device.type) for x in (pred, mask, task_req, node_idle, eps, node_ok) if x is not None]}")
    KW = K2W = 0
    tw = thr = nwd = None
    if w is not None:
        KW, K2W = words(w.K), words(w.K2)
        nw = 3 * KW + 2 * K2W
        if (KW > MAX_WORDS or K2W > MAX_WORDS or w.task_words.shape != (T, nw)
                or w.node_words.shape != (N, nw) or w.thr.shape != (T, 2)):
            raise ValueError(f"failure_counts: affinity words of {nw} words a row for "
                             f"{T} tasks and {N} nodes, vocabularies of at most "
                             f"{32 * MAX_WORDS} columns")
        tw, thr, nwd = w.task_words, w.thr, w.node_words
    pf, ins, fe, nodes = _outputs(T, R, dev)
    if T:
        if _kernel is None:
            _kernel = build.function("failure_counts", "kb_failure_counts", _SIGNATURE)
        # the contiguous tensors are kept (not only their pointers) until
        # the launch is queued
        c = [None if x is None else x if x.is_contiguous() else x.contiguous()
             for x in (pred, mask, tw, thr, nwd, task_req, node_idle, eps, node_ok)]
        err = _kernel(*(None if x is None else x.data_ptr() for x in c[:5]), KW, K2W,
                      *(x.data_ptr() for x in c[5:]), T, N, R, pf.data_ptr(),
                      ins.data_ptr(), fe.data_ptr(), nodes.data_ptr(),
                      build.stream_handle(dev))
        build.check(err, "failure_counts")
        failure_counts.launches += 1
    else:
        nodes.copy_(node_ok.sum())
    return pf, ins, fe, nodes


failure_counts.launches = 0
