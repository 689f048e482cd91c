"""K1 · the static predicate mask (CUDA C++, `csrc/predicate_mask.cu`).

Replaces kube_batch_tpu/plugins/predicates.py · PredicatesPlugin.register
.predicate (via framework/policy.py · predicate_mask).  What bounds it on
the card and what its design does about that is noted in the source.

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


def node_miss_groups(snap) -> torch.Tensor:
    """f32[N, G]: 1 where the node carries none of the volume group's
    allowed labels (1 − node_ok_g, with node_ok_g = labels @ selᵀ > 0.5)."""
    node_ok_g = (snap.node_labels @ snap.vol_group_sel.T) > 0.5
    return 1.0 - node_ok_g.float()


def predicate_mask_plain(snap, flags: PredicateFlags) -> torch.Tensor:
    """bool[T, N], the reference predicate's arithmetic in plain torch."""
    T, N = snap.num_tasks, snap.num_nodes
    ok = torch.ones((T, N), dtype=torch.bool, device=snap.device)
    if flags.selector:
        want = snap.task_sel.sum(dim=1, keepdim=True)
        have = snap.task_sel @ snap.node_labels.T
        ok &= have >= want
    if flags.taints:
        total = snap.node_taints.sum(dim=1)[None, :]
        tolerated = snap.task_tol @ snap.node_taints.T
        ok &= (total - tolerated) <= 0.5
    if flags.ports:
        ok &= (snap.task_ports @ snap.node_ports.T) <= 0.5
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
            ok &= (snap.task_vol_groups @ node_miss_groups(snap).T) <= 0.5
    return ok


def predicate_mask(snap, flags: PredicateFlags) -> torch.Tensor:
    """bool[T, N] static feasibility of every (task, node) pair."""
    dev = snap.device
    if dev.type == "cpu":
        return predicate_mask_plain(snap, flags)
    if dev.type != "cuda":
        raise RuntimeError(f"predicate_mask: unsupported device {dev}")
    lib = build.library("predicate_mask")
    fn = lib.kb_predicate_mask
    P = ctypes.c_void_p
    I = ctypes.c_int
    fn.argtypes = [P, P, I, P, P, I, P, P, I, P, P, P, P, P, I, I, I, I, P, P]
    fn.restype = ctypes.c_int
    T, N = snap.num_tasks, snap.num_nodes
    G = snap.task_vol_groups.shape[1]
    miss = node_miss_groups(snap).contiguous() if (flags.volume and G) else None
    out = torch.empty((T, N), dtype=torch.bool, device=dev)
    c = [t.contiguous() for t in (
        snap.task_sel, snap.node_labels, snap.task_tol, snap.node_taints,
        snap.task_ports, snap.node_ports, snap.node_ready, snap.node_pressure,
        snap.task_vol_node, snap.task_vol_groups,
    )]
    err = fn(
        build.ptr(c[0]), build.ptr(c[1]), c[0].shape[1],
        build.ptr(c[2]), build.ptr(c[3]), c[2].shape[1],
        build.ptr(c[4]), build.ptr(c[5]), c[4].shape[1],
        build.ptr(c[6]), build.ptr(c[7]), build.ptr(c[8]), build.ptr(c[9]),
        build.ptr(miss), G, T, N, flags.bits, build.ptr(out),
        build.stream_handle(dev),
    )
    build.check(err, "predicate_mask")
    predicate_mask.launches += 1
    return out


predicate_mask.launches = 0
