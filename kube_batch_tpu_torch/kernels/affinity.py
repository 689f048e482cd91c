"""K10 · the inter-pod affinity predicate against the resident tables
(CUDA C++, `csrc/affinity_mask.cu`), two entry points.

Replaces kube_batch_tpu/plugins/predicates.py · _topo_feasibility,
_affinity_candidate_ok, pod_affinity_predicate (the bool[T, N] mask) and
pod_affinity_row (one task's bool[N] row).  What bounds it on the card
and its design are noted in the source.

Both take the snapshot's task-side fields
    aff, anti, labels      f32[T, K]   task_aff, task_anti, task_podlabels
    aff_topo, anti_topo    f32[T, K2]  task_aff_topo, task_anti_topo
    term_key, term_label   i32[K2]     topo_term_key, topo_term_label
    node_key_domain        i32[N, TK]
and the resident tables of kernel K11 (kernels/resident.py):

* `affinity_mask(..., Hb, Hb_anti, Ab_anti, Hd, Hd_now, Ad_now)` →
  bool[T, N]: required affinity against the future-oriented tables (Hb,
  Hd; the bootstrap waiver reads Hb.any(0)), anti-affinity and symmetry
  against the `_anti` / `_now` tables (the Releasing-inclusive ones in
  the Idle pass, the same tables otherwise);
* `affinity_row(..., Hb, Ab, Hd, Ad, p)` → bool[N]: the same for task `p`
  (an int or a 0-dim device tensor, never read on the host) against one
  table set.

Every operand is 0/1, so every count is an exact integer: the kernel and
the plain version (the reference's float matrix products) agree bit for
bit.  Each wrapper runs the plain version for CPU tensors and launches
the kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from kube_batch_tpu_torch.kernels import build

MAX_WIDTH = 256          # K and K2 (8 words of 32 bits each)
_P, _I = ctypes.c_void_p, ctypes.c_int


def present_table(node_key_domain, term_key, term_label, Hd):
    """f32[N, K2]: is term j's label present in node n's domain."""
    A = node_key_domain[:, term_key.long()].long()             # [N, K2]
    return Hd[A, term_label.long()[None, :]].float()


def affinity_mask_plain(aff, anti, labels, aff_topo, anti_topo, term_key,
                        term_label, node_key_domain, Hb, Hb_anti, Ab_anti,
                        Hd, Hd_now, Ad_now):
    Hf = Hb.float()
    need = aff.sum(dim=1, keepdim=True)
    have = aff @ Hf.T
    term_exists = Hb.any(dim=0)
    bootstrap = (
        aff * (labels > 0).float() * (~term_exists).float()[None, :]
    ).sum(dim=1, keepdim=True)
    aff_ok = have + bootstrap >= need
    anti_hit = anti @ Hb_anti.float().T
    sym_hit = labels @ Ab_anti.float().T
    ok = aff_ok & (anti_hit <= 0.5) & (sym_hit <= 0.5)
    if not aff_topo.shape[1]:
        return ok
    present = present_table(node_key_domain, term_key, term_label, Hd)
    need2 = aff_topo.sum(dim=1, keepdim=True)
    have2 = aff_topo @ present.T                               # [T, N]
    label = term_label.long()
    exists2 = term_exists[label]                               # bool[K2]
    boot2 = (aff_topo * labels[:, label] * (~exists2).float()[None, :]
             ).sum(dim=1, keepdim=True)
    anti2 = anti_topo @ present_table(node_key_domain, term_key, term_label, Hd_now).T
    sym2 = torch.zeros_like(anti2)
    for tk in range(node_key_domain.shape[1]):
        Ad_n = Ad_now[node_key_domain[:, tk].long()].float()   # [N, K]
        sym2 = sym2 + labels @ Ad_n.T
    return ok & (have2 + boot2 >= need2) & (anti2 <= 0.5) & (sym2 <= 0.5)


def affinity_row_plain(aff, anti, labels, aff_topo, anti_topo, term_key,
                       term_label, node_key_domain, Hb, Ab, Hd, Ad, p):
    Hf = Hb.float()
    a = aff[p]                                                 # f32[K]
    own = labels[p]
    term_exists = Hb.any(dim=0)
    have = Hf @ a                                              # f32[N]
    bootstrap = (a * (own > 0).float() * (~term_exists).float()).sum()
    ok = (have + bootstrap >= a.sum()) & (Hf @ anti[p] <= 0.5) \
        & (Ab.float() @ own <= 0.5)
    if not aff_topo.shape[1]:
        return ok
    label = term_label.long()
    present = present_table(node_key_domain, term_key, term_label, Hd)
    a2 = aff_topo[p]
    have2 = present @ a2                                       # f32[N]
    boot2 = (a2 * own[label] * (~term_exists[label]).float()).sum()
    anti2 = present @ anti_topo[p]
    sym2 = torch.zeros(Hb.shape[0], dtype=torch.float32, device=Hb.device)
    for tk in range(node_key_domain.shape[1]):
        sym2 = sym2 + Ad[node_key_domain[:, tk].long()].float() @ own
    return ok & (have2 + boot2 >= a2.sum()) & (anti2 <= 0.5) & (sym2 <= 0.5)


def _on_card(t, what: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {t.device}")
    return True


def _inputs(what, fields, tables):
    """Contiguous, type-checked inputs and the scratch of one launch."""
    aff, anti, labels, aff_topo, anti_topo, term_key, term_label, nkd = fields
    dev = aff.device
    T, K = aff.shape
    K2 = aff_topo.shape[1]
    if K > MAX_WIDTH or K2 > MAX_WIDTH:
        raise ValueError(f"{what}: vocabularies of at most {MAX_WIDTH} columns, "
                         f"got K={K}, K2={K2}")
    f = [x.contiguous() for x in fields]
    for x, want in zip(f, (torch.float32,) * 5 + (torch.int32,) * 3):
        if x.dtype != want or x.device != dev:
            raise TypeError(f"{what}: expected {want} on {dev}, got {x.dtype} "
                            f"on {x.device}")
    t = [None if x is None else x.contiguous() for x in tables]
    for x in t:
        if x is not None and (x.dtype != torch.bool or x.device != dev):
            raise TypeError(f"{what}: resident tables must be bool on {dev}")
    N = t[0].shape[0]
    TK = nkd.shape[1] if K2 else 0
    nw = 3 * ((K + 31) // 32) + 2 * ((K2 + 31) // 32)
    scratch = (
        torch.empty((N, nw), dtype=torch.int32, device=dev),
        torch.zeros((K + 31) // 32, dtype=torch.int32, device=dev),
    )
    return f, t, (T, N, K, K2, TK, nw), scratch


def affinity_mask(aff, anti, labels, aff_topo, anti_topo, term_key, term_label,
                  node_key_domain, Hb, Hb_anti, Ab_anti, Hd, Hd_now, Ad_now):
    """bool[T, N] — see the module docstring."""
    fields = (aff, anti, labels, aff_topo, anti_topo, term_key, term_label,
              node_key_domain)
    tables = (Hb, Hb_anti, Ab_anti, Hd, Hd_now, Ad_now)
    if not _on_card(aff, "affinity_mask"):
        return affinity_mask_plain(*fields, *tables)
    f, t, (T, N, K, K2, TK, nw), (node_words, exists) = _inputs(
        "affinity_mask", fields, tables)
    dev = aff.device
    task_words = torch.empty((T, nw), dtype=torch.int32, device=dev)
    thr = torch.empty((T, 2), dtype=torch.int32, device=dev)
    out = torch.empty((T, N), dtype=torch.bool, device=dev)
    fn = build.library("affinity_mask").kb_affinity_mask
    fn.argtypes = [_P] * 14 + [_I] * 5 + [_P] * 6
    fn.restype = ctypes.c_int
    err = fn(*(build.ptr(x) for x in f), *(build.ptr(x) for x in t),
             T, N, K, K2, TK, build.ptr(node_words), build.ptr(exists),
             build.ptr(task_words), build.ptr(thr), build.ptr(out),
             build.stream_handle(dev))
    build.check(err, "affinity_mask")
    affinity_mask.launches += 1
    return out


def affinity_row(aff, anti, labels, aff_topo, anti_topo, term_key, term_label,
                 node_key_domain, Hb, Ab, Hd, Ad, p):
    """bool[N] — see the module docstring."""
    fields = (aff, anti, labels, aff_topo, anti_topo, term_key, term_label,
              node_key_domain)
    if not _on_card(aff, "affinity_row"):
        return affinity_row_plain(*fields, Hb, Ab, Hd, Ad, p)
    f, t, (T, N, K, K2, TK, nw), (node_words, exists) = _inputs(
        "affinity_row", fields, (Hb, Ab, Hd, Ad))
    dev = aff.device
    p_dev = torch.as_tensor(p, device=dev).to(torch.int64).reshape(1)
    task_words = torch.empty((1, nw), dtype=torch.int32, device=dev)
    thr = torch.empty((1, 2), dtype=torch.int32, device=dev)
    out = torch.empty(N, dtype=torch.bool, device=dev)
    fn = build.library("affinity_mask").kb_affinity_row
    fn.argtypes = [_P] * 13 + [_I] * 5 + [_P] * 6
    fn.restype = ctypes.c_int
    err = fn(*(build.ptr(x) for x in f), *(build.ptr(x) for x in t),
             build.ptr(p_dev), T, N, K, K2, TK, build.ptr(node_words),
             build.ptr(exists), build.ptr(task_words), build.ptr(thr),
             build.ptr(out), build.stream_handle(dev))
    build.check(err, "affinity_row")
    affinity_row.launches += 1
    return out


affinity_mask.launches = 0
affinity_row.launches = 0
