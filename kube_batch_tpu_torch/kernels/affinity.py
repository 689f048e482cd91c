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
  table set;
* `affinity_words(..., Hb, Hb_anti, Ab_anti, Hd, Hd_now, Ad_now,
  task_words)` → `AffinityWords`: the mask's operands as 32-bit words and
  per-task thresholds, nothing per cell.  Kernel K2 takes it in place of
  the mask and tests each cell in its own tiles (`kernels/propose.py`).
  `task_words` (i32[T, NW], or None to build them) read only the
  snapshot, so a caller keeps `result.task_words` for the next call on
  the same snapshot.

Every operand is 0/1, so every count is an exact integer: the kernel and
the plain version (the reference's float matrix products) agree bit for
bit.  Each wrapper runs the plain version for CPU tensors and launches
the kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from kube_batch_tpu_torch.kernels import build

MAX_WIDTH = 256          # K and K2 (8 words of 32 bits each)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "kb_affinity_mask": [_P] * 14 + [_I] * 5 + [_P] * 6,
    "kb_affinity_row": [_P] * 13 + [_I] * 5 + [_P] * 6,
    "kb_affinity_words": [_P] * 14 + [_I] * 6 + [_P] * 5,
}


def _fn(name: str):
    return build.function("affinity_mask", name, _SIGNATURES[name])


def words(width: int) -> int:
    """32-bit words of a vocabulary of `width` columns."""
    return (width + 31) // 32


@dataclasses.dataclass(frozen=True)
class AffinityWords:
    """The inter-pod affinity predicate as words: a cell (t, n) is
    feasible when popcount(aff_t & Hb_n) >= thr[t, 0], popcount(aff_topo_t
    & present_n) >= thr[t, 1], and anti_t & Hb_anti_n, labels_t & sym_n
    and anti_topo_t & present_now_n are all 0.  Word groups, in order:
    node_words [Hb | Hb_anti | sym | present | present_now] and
    task_words [aff | anti | labels | aff_topo | anti_topo], K, K, K, K2
    and K2 columns of bits (`words(K)` / `words(K2)` words each)."""

    node_words: torch.Tensor   # i32[N, NW]
    task_words: torch.Tensor   # i32[T, NW]
    thr: torch.Tensor          # i32[T, 2]
    K: int
    K2: int

    def rows(self, sl) -> "AffinityWords":
        """The same predicate for the task rows `sl`."""
        return dataclasses.replace(self, task_words=self.task_words[sl], thr=self.thr[sl])


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


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """bool[..., W] → i32[..., words(W)]: bit b of word w is column 32w + b."""
    W = bits.shape[-1]
    nw = words(W)
    padded = torch.zeros(bits.shape[:-1] + (nw * 32,), dtype=torch.int64,
                         device=bits.device)
    padded[..., :W] = bits.long()
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    v = (padded.view(bits.shape[:-1] + (nw, 32)) << shifts).sum(dim=-1)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def task_words_plain(aff, anti, labels, aff_topo, anti_topo) -> torch.Tensor:
    """i32[T, NW]: [aff | anti | labels | aff_topo | anti_topo] as bits."""
    return torch.cat([_pack(x > 0) for x in (aff, anti, labels, aff_topo, anti_topo)],
                     dim=1)


def affinity_words_plain(aff, anti, labels, aff_topo, anti_topo, term_key,
                         term_label, node_key_domain, Hb, Hb_anti, Ab_anti,
                         Hd, Hd_now, Ad_now, task_words=None) -> AffinityWords:
    K, K2 = aff.shape[1], aff_topo.shape[1]
    sym = Ab_anti
    node = [Hb, Hb_anti]
    if K2:
        for tk in range(node_key_domain.shape[1]):
            sym = sym | Ad_now[node_key_domain[:, tk].long()]
        pres = present_table(node_key_domain, term_key, term_label, Hd) > 0
        now = present_table(node_key_domain, term_key, term_label, Hd_now) > 0
    else:
        pres = now = torch.zeros((Hb.shape[0], 0), dtype=torch.bool, device=Hb.device)
    node_words = torch.cat([_pack(x) for x in node + [sym, pres, now]], dim=1)
    if task_words is None:
        task_words = task_words_plain(aff, anti, labels, aff_topo, anti_topo)
    exists = Hb.any(dim=0)
    A, L = aff > 0, labels > 0
    thr0 = A.sum(dim=1) - (A & L & ~exists[None, :]).sum(dim=1)
    At = aff_topo > 0
    label = term_label.long()
    thr1 = At.sum(dim=1) - (At & L[:, label] & ~exists[label][None, :]).sum(dim=1)
    thr = torch.stack([thr0, thr1], dim=1).to(torch.int32)
    return AffinityWords(node_words, task_words, thr, K, K2)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 holding a 32-bit word."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def affinity_cells_plain(w: AffinityWords) -> torch.Tensor:
    """bool[T, N]: the cell test of `w` (kernel K2's words form, and pass
    3 of the mask)."""
    KW, K2W = words(w.K), words(w.K2)
    tw = w.task_words.long() & 0xFFFFFFFF
    nw = w.node_words.long() & 0xFFFFFFFF

    def group(g, j):
        base = g * KW if g < 3 else 3 * KW + (g - 3) * K2W
        return tw[:, None, base + j] & nw[None, :, base + j]

    T, N = tw.shape[0], nw.shape[0]
    have = torch.zeros((T, N), dtype=torch.int64, device=tw.device)
    hit = torch.zeros((T, N), dtype=torch.bool, device=tw.device)
    for j in range(KW):
        have += _popcount(group(0, j))
        hit |= (group(1, j) | group(2, j)) != 0
    have2 = torch.zeros_like(have)
    for j in range(K2W):
        have2 += _popcount(group(3, j))
        hit |= group(4, j) != 0
    thr = w.thr.long()
    return (have >= thr[:, :1]) & (have2 >= thr[:, 1:]) & ~hit


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
    nw = 3 * words(K) + 2 * words(K2)
    return f, t, (T, N, K, K2, TK, nw)


def _scratch(N: int, nw: int, K: int, dev):
    """The node words and the zeroed term-exists words of one launch."""
    return (torch.empty((N, nw), dtype=torch.int32, device=dev),
            torch.zeros(words(K), dtype=torch.int32, device=dev))


def affinity_mask(aff, anti, labels, aff_topo, anti_topo, term_key, term_label,
                  node_key_domain, Hb, Hb_anti, Ab_anti, Hd, Hd_now, Ad_now):
    """bool[T, N] — see the module docstring."""
    fields = (aff, anti, labels, aff_topo, anti_topo, term_key, term_label,
              node_key_domain)
    tables = (Hb, Hb_anti, Ab_anti, Hd, Hd_now, Ad_now)
    if not _on_card(aff, "affinity_mask"):
        return affinity_mask_plain(*fields, *tables)
    f, t, (T, N, K, K2, TK, nw) = _inputs("affinity_mask", fields, tables)
    dev = aff.device
    node_words, exists = _scratch(N, nw, K, dev)
    task_words = torch.empty((T, nw), dtype=torch.int32, device=dev)
    thr = torch.empty((T, 2), dtype=torch.int32, device=dev)
    out = torch.empty((T, N), dtype=torch.bool, device=dev)
    err = _fn("kb_affinity_mask")(*(build.ptr(x) for x in f), *(build.ptr(x) for x in t),
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
    f, t, (T, N, K, K2, TK, nw) = _inputs("affinity_row", fields, (Hb, Ab, Hd, Ad))
    dev = aff.device
    node_words, exists = _scratch(N, nw, K, dev)
    p_dev = torch.as_tensor(p, device=dev).to(torch.int64).reshape(1)
    task_words = torch.empty((1, nw), dtype=torch.int32, device=dev)
    thr = torch.empty((1, 2), dtype=torch.int32, device=dev)
    out = torch.empty(N, dtype=torch.bool, device=dev)
    err = _fn("kb_affinity_row")(*(build.ptr(x) for x in f), *(build.ptr(x) for x in t),
             build.ptr(p_dev), T, N, K, K2, TK, build.ptr(node_words),
             build.ptr(exists), build.ptr(task_words), build.ptr(thr),
             build.ptr(out), build.stream_handle(dev))
    build.check(err, "affinity_row")
    affinity_row.launches += 1
    return out


def affinity_words(aff, anti, labels, aff_topo, anti_topo, term_key, term_label,
                   node_key_domain, Hb, Hb_anti, Ab_anti, Hd, Hd_now, Ad_now,
                   task_words) -> AffinityWords:
    """AffinityWords — see the module docstring (`task_words` None: build
    them)."""
    fields = (aff, anti, labels, aff_topo, anti_topo, term_key, term_label,
              node_key_domain)
    tables = (Hb, Hb_anti, Ab_anti, Hd, Hd_now, Ad_now)
    if not _on_card(aff, "affinity_words"):
        return affinity_words_plain(*fields, *tables, task_words)
    f, t, (T, N, K, K2, TK, nw) = _inputs("affinity_words", fields, tables)
    dev = aff.device
    build_tw = task_words is None
    if build_tw:
        task_words = torch.empty((T, nw), dtype=torch.int32, device=dev)
    elif task_words.shape != (T, nw) or task_words.dtype != torch.int32:
        raise ValueError(f"affinity_words: task words must be int32 of shape {(T, nw)}")
    # node words, thresholds and the term-exists words in one allocation
    buf = torch.empty(N * nw + 2 * T + max(words(K), 1), dtype=torch.int32, device=dev)
    node_words = buf[:N * nw].view(N, nw)
    thr = buf[N * nw:N * nw + 2 * T].view(T, 2)
    err = _fn("kb_affinity_words")(
        *(build.ptr(x) for x in f), *(build.ptr(x) for x in t), T, N, K, K2, TK,
        int(build_tw), build.ptr(node_words), build.ptr(buf[N * nw + 2 * T:]),
        build.ptr(task_words), build.ptr(thr), build.stream_handle(dev))
    build.check(err, "affinity_words")
    affinity_words.launches += 1
    return AffinityWords(node_words, task_words.contiguous(), thr, K, K2)


affinity_mask.launches = 0
affinity_row.launches = 0
affinity_words.launches = 0
