"""K1 · the static predicate mask (CUDA C++, `csrc/predicate_mask.cu`).

Replaces kube_batch_tpu/plugins/predicates.py · PredicatesPlugin.register
.predicate (via framework/policy.py · predicate_mask).  What bounds it on
the card and what its design does about that is noted in the source.

The multi-hot tables hold only 0 and 1 (the packers write 1.0 and
nothing else), so each of the reference's product-and-compare tests is a
set test on bit words: the plain version and the kernel pack every table
into uint32 words (`pack_words`, kept as int32) and test words.

`predicate_mask` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from kube_batch_tpu_torch.kernels import build


@dataclasses.dataclass(frozen=True)
class PredicateFlags:
    """Which static predicates are on (≙ predicates.go's Enable toggles)."""

    selector: bool = True
    taints: bool = True
    ports: bool = True
    ready: bool = True
    pressure: tuple[bool, bool, bool] = (False, False, False)
    volume: bool = True

    @property
    def bits(self) -> int:
        b = (self.selector * 1) | (self.taints * 2) | (self.ports * 4) \
            | (self.ready * 8) | (self.volume * 128)
        for d, on in enumerate(self.pressure):
            if on:
                b |= 16 << d
        return b


def pack_words(x: torch.Tensor) -> torch.Tensor:
    """int32[M, ceil(W / 32)]: bit c % 32 of word c // 32 is 1 where
    x[:, c] != 0 (a uint32 word kept in int32).  One bit position at a
    time, so a wide table (a label per node) costs a byte a column."""
    M, W = x.shape
    nw = -(-W // 32)
    bits = torch.zeros((M, nw * 32), dtype=torch.bool, device=x.device)
    bits[:, :W] = x != 0
    bits = bits.view(M, nw, 32)
    words = torch.zeros((M, nw), dtype=torch.int64, device=x.device)
    for b in range(32):
        words |= bits[:, :, b].long() << b
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def node_miss_words(snap) -> torch.Tensor:
    """int32[N, ceil(G / 32)]: bit g set where the node carries none of
    volume group g's allowed labels (1 − node_ok_g, with node_ok_g =
    labels @ selᵀ > 0.5 on 0/1 rows: the label sets intersect)."""
    labels, sel = pack_words(snap.node_labels), pack_words(snap.vol_group_sel)
    meets = ((labels[:, None, :] & sel[None, :, :]) != 0).any(dim=2)
    return pack_words((~meets).float())


def _all_subset(a, b) -> torch.Tensor:
    """bool[T, N]: row t of `a` ⊆ row n of `b`, word by word."""
    ok = torch.ones((a.shape[0], b.shape[0]), dtype=torch.bool, device=a.device)
    for k in range(a.shape[1]):
        ok &= (a[:, k, None] & ~b[None, :, k]) == 0
    return ok


def _all_disjoint(a, b) -> torch.Tensor:
    ok = torch.ones((a.shape[0], b.shape[0]), dtype=torch.bool, device=a.device)
    for k in range(a.shape[1]):
        ok &= (a[:, k, None] & b[None, :, k]) == 0
    return ok


def predicate_mask_plain(snap, flags: PredicateFlags) -> torch.Tensor:
    """bool[T, N]: the reference predicate as set tests on bit words, in
    its order (selector, taints, ports, ready, pressure, volume pin,
    volume groups)."""
    T, N = snap.num_tasks, snap.num_nodes
    ok = torch.ones((T, N), dtype=torch.bool, device=snap.device)
    if flags.selector:
        ok &= _all_subset(pack_words(snap.task_sel), pack_words(snap.node_labels))
    if flags.taints:
        ok &= _all_subset(pack_words(snap.node_taints),
                          pack_words(snap.task_tol)).T
    if flags.ports:
        ok &= _all_disjoint(pack_words(snap.task_ports), pack_words(snap.node_ports))
    if flags.ready:
        ok &= snap.node_ready[None, :]
    for dim, on in enumerate(flags.pressure):
        if on:
            ok &= (snap.node_pressure[None, :, dim] <= 0.5)
    if flags.volume:
        node_ids = torch.arange(N, dtype=torch.int32, device=snap.device)
        pinned = snap.task_vol_node
        ok &= (pinned == -1)[:, None] | (pinned[:, None] == node_ids[None, :])
        if snap.task_vol_groups.shape[1]:
            ok &= _all_disjoint(pack_words(snap.task_vol_groups), node_miss_words(snap))
    return ok


_FIELDS = ("task_sel", "node_labels", "task_tol", "node_taints", "task_ports",
           "node_ports", "node_ready", "node_pressure", "task_vol_node",
           "task_vol_groups", "vol_group_sel")
_DTYPES = (torch.float32,) * 6 + (torch.bool, torch.float32, torch.int32,
                                  torch.float32, torch.float32)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = ([_P, _P, _I] * 3 + [_P] * 5 + [_I] * 4 + [_P] * 3)


def word_count(T: int, N: int, widths) -> int:
    """int32 words of the kernel's packed buffer: the task words [T][TW],
    the node words [TW][N], the node_ok bytes and the used words."""
    tw = sum(-(-w // 32) for w in widths)
    return T * tw + tw * N + -(-N // 4) + tw


def predicate_mask(snap, flags: PredicateFlags) -> torch.Tensor:
    """bool[T, N] static feasibility of every (task, node) pair.  On the
    card every field must be contiguous, of its snapshot dtype (float32
    tables, bool node_ready, int32 task_vol_node); others raise."""
    dev = snap.device
    if dev.type == "cpu":
        return predicate_mask_plain(snap, flags)
    if dev.type != "cuda":
        raise RuntimeError(f"predicate_mask: unsupported device {dev}")
    f = [getattr(snap, name) for name in _FIELDS]
    T, N = snap.num_tasks, snap.num_nodes
    if not (all(x.dtype == d and x.is_cuda and x.is_contiguous()
                for x, d in zip(f, _DTYPES))
            and f[0].shape[0] == f[2].shape[0] == f[4].shape[0] == f[9].shape[0] == T
            and f[1].shape[0] == f[3].shape[0] == f[5].shape[0] == N
            and f[0].shape[1] == f[1].shape[1] == f[10].shape[1]
            and f[2].shape[1] == f[3].shape[1] and f[4].shape[1] == f[5].shape[1]
            and f[9].shape[1] == f[10].shape[0]
            and f[6].shape == (N,) and f[7].shape == (N, 3) and f[8].shape == (T,)):
        raise ValueError(
            "predicate_mask takes contiguous float32 tables, bool node_ready and int32 "
            f"task_vol_node on the card; got {[(n, x.dtype, tuple(x.shape)) for n, x in zip(_FIELDS, f)]}")
    L, V, P, G = f[0].shape[1], f[2].shape[1], f[4].shape[1], f[9].shape[1]
    words = torch.empty(word_count(T, N, (L, V, P, G)), dtype=torch.int32, device=dev)
    out = torch.empty((T, N), dtype=torch.bool, device=dev)
    err = build.function("predicate_mask", "kb_predicate_mask", _SIGNATURE)(
        f[0].data_ptr(), f[1].data_ptr(), L, f[2].data_ptr(), f[3].data_ptr(), V,
        f[4].data_ptr(), f[5].data_ptr(), P, f[6].data_ptr(), f[7].data_ptr(),
        f[8].data_ptr(), f[9].data_ptr(), f[10].data_ptr(), G, T, N, flags.bits,
        words.data_ptr(), out.data_ptr(), build.stream_handle(dev),
    )
    build.check(err, "predicate_mask")
    predicate_mask.launches += 1
    return out


predicate_mask.launches = 0
