"""K11 · the resident label tables of the inter-pod affinity predicate
(CUDA C++, `csrc/resident_tables.cu`).

Replaces kube_batch_tpu/plugins/predicates.py · resident_podlabels,
_resident_mask and resident_domain_labels.  What bounds it on the card
and what its design does about that is noted in the source.

`resident_tables(...)` → (Hb, Ab, Hd, Ad): bool[N, K] node tables and,
when the snapshot carries topology-scoped terms (K2 > 0), bool[D, K]
domain tables (None otherwise), all from one launch.  A resident is a
real task holding a node: allocated or pipelined, plus Releasing with
`include_releasing`.

The wrapper runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from kube_batch_tpu_torch.api.types import ALLOCATED_STATUSES, TaskStatus
from kube_batch_tpu_torch.kernels import build
from kube_batch_tpu_torch.kernels import segment_sum as _k7

_P, _I = ctypes.c_void_p, ctypes.c_int
_HELD = tuple(sorted(int(s) for s in ALLOCATED_STATUSES | {TaskStatus.PIPELINED}))


def resident_mask(task_state, task_node, task_mask, include_releasing: bool):
    """bool[T]: real tasks holding a node (allocated or pipelined; plus
    Releasing ones with `include_releasing`)."""
    placed = (task_node >= 0) & task_mask
    held = torch.zeros_like(placed)
    for s in _HELD:
        held = held | (task_state == s)
    if include_releasing:
        held = held | (task_state == int(TaskStatus.RELEASING))
    return held & placed


def resident_tables_plain(podlabels, anti, anti_topo, task_node, task_state,
                          task_mask, node_key_domain, term_key, term_label,
                          num_nodes: int, num_domains: int,
                          include_releasing: bool):
    """The reference's segment sums and `> 0`, in plain torch."""
    N, D = num_nodes, num_domains
    held = resident_mask(task_state, task_node, task_mask, include_releasing)
    seg = torch.where(held, task_node, N)
    w = held.float()[:, None]
    Hb = _k7.segment_sum_plain(podlabels * w, seg, N) > 0
    Ab = _k7.segment_sum_plain(anti * w, seg, N) > 0
    if not anti_topo.shape[1]:
        return Hb, Ab, None, None
    K = podlabels.shape[1]
    node_of = torch.clamp(task_node, 0, N - 1).long()
    onehot_lab = torch.nn.functional.one_hot(term_label.long(), K).float()  # [K2, K]
    Hd = torch.zeros((D, K), dtype=torch.float32, device=podlabels.device)
    Ad = torch.zeros((D, K), dtype=torch.float32, device=podlabels.device)
    for tk in range(node_key_domain.shape[1]):
        seg = torch.where(held, node_key_domain[node_of, tk], D)
        Hd = Hd + _k7.segment_sum_plain(podlabels * w, seg, D)
        anti_this_key = anti_topo * (term_key == tk).float()[None, :]
        Ad = Ad + _k7.segment_sum_plain((anti_this_key @ onehot_lab) * w, seg, D)
    return Hb, Ab, Hd > 0, Ad > 0


_DTYPES = (torch.float32,) * 3 + (torch.int32,) * 2 + (torch.bool,) + (torch.int32,) * 3


def resident_tables(podlabels, anti, anti_topo, task_node, task_state, task_mask,
                    node_key_domain, term_key, term_label, num_nodes: int,
                    num_domains: int, include_releasing: bool = False):
    """(Hb, Ab, Hd, Ad) — see the module docstring.  The task-side
    fields are the snapshot's (`task_podlabels`, `task_anti`,
    `task_anti_topo`, ..., `topo_term_label`); `task_node` and
    `task_state` the live state's."""
    args = (podlabels, anti, anti_topo, task_node, task_state, task_mask,
            node_key_domain, term_key, term_label)
    dev = task_state.device
    if dev.type == "cpu":
        return resident_tables_plain(*args, num_nodes, num_domains,
                                     include_releasing)
    if dev.type != "cuda":
        raise RuntimeError(f"resident_tables: unsupported device {dev}")
    T, K = podlabels.shape
    K2 = anti_topo.shape[1]
    TK = node_key_domain.shape[1] if K2 else 0
    N, D = num_nodes, num_domains
    c = [x.contiguous() for x in args]
    for x, want in zip(c, _DTYPES):
        if x.dtype != want or x.device != dev:
            raise TypeError(f"resident_tables: expected {want} on {dev}, got "
                            f"{x.dtype} on {x.device}")
    Hb = torch.zeros((N, K), dtype=torch.bool, device=dev)
    Ab = torch.zeros((N, K), dtype=torch.bool, device=dev)
    Hd = torch.zeros((D, K), dtype=torch.bool, device=dev) if K2 else None
    Ad = torch.zeros((D, K), dtype=torch.bool, device=dev) if K2 else None
    fn = build.library("resident_tables").kb_resident_tables
    fn.argtypes = [_P] * 9 + [_I] * 5 + [_P] * 5
    fn.restype = ctypes.c_int
    err = fn(*(build.ptr(x) for x in c), T, K, K2, TK, int(include_releasing),
             build.ptr(Hb), build.ptr(Ab), build.ptr(Hd), build.ptr(Ad),
             build.stream_handle(dev))
    build.check(err, "resident_tables")
    resident_tables.launches += 1
    return Hb, Ab, Hd, Ad


resident_tables.launches = 0
