"""K10 · the inter-pod affinity predicate against the resident tables
(CUDA C++, `csrc/affinity_mask.cu` and `csrc/affinity_row.cuh`), five
entry points and a row operand.

Replaces kube_batch_tpu/plugins/predicates.py · _topo_feasibility,
_affinity_candidate_ok, pod_affinity_predicate (the bool[T, N] mask) and
pod_affinity_row (one task's bool[N] row).  What bounds it on the card
and its design are noted in the source.

The snapshot's task-side fields are
    aff, anti, labels      f32[T, K]   task_aff, task_anti, task_podlabels
    aff_topo, anti_topo    f32[T, K2]  task_aff_topo, task_anti_topo
    term_key, term_label   i32[K2]     topo_term_key, topo_term_label
    node_key_domain        i32[N, TK]
and the resident tables come from kernel K11 as `kernels/resident.py ·
ResidentWords` (word tables and term_exists).  Required affinity reads
the future-oriented tables (Hb, Hd; the bootstrap waiver reads
term_exists), anti-affinity and symmetry the `_now` tables — the
Releasing-inclusive ones when the build was asked for them (the Idle
pass), the same tables otherwise:

* `affinity_task_words(aff, anti, labels, aff_topo, anti_topo)` →
  i32[T, NW]: the task words [aff | anti | labels | aff_topo |
  anti_topo] as bits.  They read only the snapshot: built once per
  snapshot and kept (`SnapshotTensors.affinity_task_words`); K11 reads
  its label rows from them.
* `affinity_mask(fields..., resident)` → bool[T, N] (no path launches
  it since the failure tallies take the words form; an entry still);
* `affinity_row(fields..., resident, p, task_words)` → bool[N]: the same
  for task `p` (an int or a 0-dim device tensor, never read on the host)
  against the future tables, from the kept task words (the card reads
  them, the plain version the fields);
* `AffinityRow`: the row of one task as an operand — the fields, the
  kept task words, the state's K11 tables and p — that kernel K5 tests
  node by node inside its own launch (`kernels/victim_prefix.py`) and
  kernel K6 at a continuing step's node (`kernels/preempt_scan.py`), so
  no preemption step launches anything for the row; its `row()` is the
  row above;
* `affinity_words(task_words, term_key, term_label, node_key_domain,
  resident)` → `AffinityWords`: the mask's operands as 32-bit words and
  per-task thresholds, nothing per cell.  Kernel K2 takes it in place of
  the mask and tests each cell in its own tiles (`kernels/propose.py`),
  and so does kernel K4 for the cycle's failure tallies
  (`kernels/failure_counts.py`), with the same test
  (`csrc/affinity_words.cuh`).

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
from kube_batch_tpu_torch.kernels.resident import ResidentWords, pack, unpack, words

MAX_WIDTH = 256          # K and K2 (8 words of 32 bits each)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "kb_affinity_mask": [_P] * 15 + [_I] * 5 + [_P] * 5,
    "kb_affinity_row": [_P] * 10 + [_I] * 4 + [_P] * 2,
    "kb_affinity_words": [_P] * 11 + [_I] * 5 + [_P] * 3,
    "kb_affinity_task_words": [_P] * 6 + [_I] * 3 + [_P] * 2,
}


def _fn(name: str):
    return build.function("affinity_mask", name, _SIGNATURES[name])


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
                        term_label, node_key_domain, resident: ResidentWords):
    Hb, _, Hd, _ = resident.tables()
    Hb_anti, Ab_anti, Hd_now, Ad_now = resident.tables(now=True)
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
                       term_label, node_key_domain, resident: ResidentWords, p):
    Hb, Ab, Hd, Ad = resident.tables()
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


def task_words_plain(aff, anti, labels, aff_topo, anti_topo) -> torch.Tensor:
    """i32[T, NW]: [aff | anti | labels | aff_topo | anti_topo] as bits."""
    return torch.cat([pack(x > 0) for x in (aff, anti, labels, aff_topo, anti_topo)],
                     dim=1)


def affinity_words_plain(task_words, term_key, term_label, node_key_domain,
                         resident: ResidentWords) -> AffinityWords:
    K, K2 = resident.K, resident.K2
    KW, K2W = words(K), words(K2)
    Hb, _, Hd, _ = resident.tables()
    Hb_anti, sym, Hd_now, Ad_now = resident.tables(now=True)
    node = [Hb, Hb_anti]
    if K2:
        for tk in range(node_key_domain.shape[1]):
            sym = sym | Ad_now[node_key_domain[:, tk].long()]
        pres = present_table(node_key_domain, term_key, term_label, Hd) > 0
        now = present_table(node_key_domain, term_key, term_label, Hd_now) > 0
    else:
        pres = now = torch.zeros((Hb.shape[0], 0), dtype=torch.bool, device=Hb.device)
    node_words = torch.cat([pack(x) for x in node + [sym, pres, now]], dim=1)
    exists = Hb.any(dim=0)
    A = unpack(task_words[:, :KW], K)
    L = unpack(task_words[:, 2 * KW:3 * KW], K)
    At = unpack(task_words[:, 3 * KW:3 * KW + K2W], K2)
    thr0 = A.sum(dim=1) - (A & L & ~exists[None, :]).sum(dim=1)
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


# K11's tables as the kernels read them: the `_now` set on the anti /
# symmetry side (the future set itself when the build has no `_now` set)
_KERNEL_TABLES = ("Hb", "Hb_now", "Ab_now", "Hd", "Hd_now", "Ad_now", "term_exists")
# the row form: the future set, read in both orientations
_ROW_TABLES = ("Hb", "Ab", "Hd", "Ad", "term_exists")


def _check(what, tensors, dtypes, dev) -> None:
    for x, want in zip(tensors, dtypes):
        if x is not None and (x.dtype != want or x.device != dev
                              or not x.is_contiguous()):
            raise TypeError(f"{what}: expected contiguous {want} on {dev}, got "
                            f"{x.dtype} on {x.device}")


def _tables(what, resident: ResidentWords, dev, names=_KERNEL_TABLES):
    """Addresses of K11's word tables in the kernels' order [Hb, Hb_anti,
    Ab_anti, Hd, Hd_now, Ad_now, exists] (`names`), its buffer checked."""
    if resident.K > MAX_WIDTH or resident.K2 > MAX_WIDTH:
        raise ValueError(f"{what}: vocabularies of at most {MAX_WIDTH} columns, "
                         f"got K={resident.K}, K2={resident.K2}")
    _check(what, (resident.buf,), (torch.int32,), dev)
    return tuple(resident.address(n) for n in names)


_FIELD_DTYPES = (torch.float32,) * 5 + (torch.int32,) * 3


def _scratch(T: int, N: int, nw: int, dev):
    """Node words, task words and thresholds of one mask launch, in one
    allocation."""
    buf = torch.empty(N * nw + T * nw + 2 * T, dtype=torch.int32, device=dev)
    return (buf[:N * nw].view(N, nw), buf[N * nw:(N + T) * nw].view(T, nw),
            buf[(N + T) * nw:].view(T, 2))


def affinity_task_words(aff, anti, labels, aff_topo, anti_topo):
    """i32[T, NW] — see the module docstring."""
    fields = (aff, anti, labels, aff_topo, anti_topo)
    if not _on_card(aff, "affinity_task_words"):
        return task_words_plain(*fields)
    dev = aff.device
    (T, K), K2 = aff.shape, aff_topo.shape[1]
    if K > MAX_WIDTH or K2 > MAX_WIDTH:
        raise ValueError(f"affinity_task_words: vocabularies of at most {MAX_WIDTH} "
                         f"columns, got K={K}, K2={K2}")
    _check("affinity_task_words", fields, _FIELD_DTYPES, dev)
    out = torch.empty((T, 3 * words(K) + 2 * words(K2)), dtype=torch.int32, device=dev)
    # the label of a topology term is not read without thresholds
    err = _fn("kb_affinity_task_words")(*(x.data_ptr() for x in fields), None, T, K,
                                        K2, out.data_ptr(), build.stream_handle(dev))
    build.check(err, "affinity_task_words")
    affinity_task_words.launches += 1
    return out


def affinity_mask(aff, anti, labels, aff_topo, anti_topo, term_key, term_label,
                  node_key_domain, resident: ResidentWords):
    """bool[T, N] — see the module docstring."""
    fields = (aff, anti, labels, aff_topo, anti_topo, term_key, term_label,
              node_key_domain)
    if not _on_card(aff, "affinity_mask"):
        return affinity_mask_plain(*fields, resident)
    dev = aff.device
    _check("affinity_mask", fields, _FIELD_DTYPES, dev)
    tables = _tables("affinity_mask", resident, dev)
    (T, K), K2, N = aff.shape, aff_topo.shape[1], resident.N
    TK = node_key_domain.shape[1] if K2 else 0
    nw = 3 * words(K) + 2 * words(K2)
    node_words, task_words, thr = _scratch(T, N, nw, dev)
    out = torch.empty((T, N), dtype=torch.bool, device=dev)
    err = _fn("kb_affinity_mask")(
        *(x.data_ptr() for x in fields), *tables, T, N, K, K2, TK,
        node_words.data_ptr(), task_words.data_ptr(), thr.data_ptr(), out.data_ptr(),
        build.stream_handle(dev))
    build.check(err, "affinity_mask")
    affinity_mask.launches += 1
    return out


def _row_operand(what, resident: ResidentWords, task_words, term_key, term_label,
                 node_key_domain, p) -> tuple:
    """The row operand's C arguments, checked: task words, the future
    tables [Hb, Ab, Hd, Ad, exists], the snapshot's node_key_domain and
    term arrays, p, and K, K2, TK (affinity_row.cuh · Operand)."""
    dev = task_words.device
    _check(what, (task_words, term_key, term_label, node_key_domain, p),
           (torch.int32,) * 4 + (torch.int64,), dev)
    K, K2 = resident.K, resident.K2
    if task_words.shape[1] != 3 * words(K) + 2 * words(K2) or p.numel() != 1:
        raise ValueError(f"{what}: task words of {3 * words(K) + 2 * words(K2)} words "
                         "a row and one preemptor")
    tables = _tables(what, resident, dev, _ROW_TABLES)
    TK = node_key_domain.shape[1] if K2 else 0
    return (task_words.data_ptr(), *tables, node_key_domain.data_ptr(),
            term_key.data_ptr(), term_label.data_ptr(), p.data_ptr(), K, K2, TK)


def _device_scalar(x, dev) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=torch.int64,
                                                              device=dev)


def affinity_row(aff, anti, labels, aff_topo, anti_topo, term_key, term_label,
                 node_key_domain, resident: ResidentWords, p, task_words=None):
    """bool[N] — see the module docstring.  On the card `task_words` (the
    snapshot's kept words) are required and `p` is an int64 device
    scalar (an int is moved there)."""
    fields = (aff, anti, labels, aff_topo, anti_topo, term_key, term_label,
              node_key_domain)
    if not _on_card(aff, "affinity_row"):
        return affinity_row_plain(*fields, resident, p)
    dev = aff.device
    if task_words is None:
        raise ValueError("affinity_row on the card reads the snapshot's task words")
    args = _row_operand("affinity_row", resident, task_words, term_key, term_label,
                        node_key_domain, _device_scalar(p, dev))
    out = torch.empty(resident.N, dtype=torch.bool, device=dev)
    err = _fn("kb_affinity_row")(*args[:10], resident.N, *args[10:], out.data_ptr(),
                                 build.stream_handle(dev))
    build.check(err, "affinity_row")
    affinity_row.launches += 1
    return out


@dataclasses.dataclass(frozen=True)
class AffinityRow:
    """pod_affinity_row of one task as the operand kernel K5 tests node by
    node inside its own launch (its node mask), in place of a bool[N]
    row: the snapshot's fields (`fields`, the plain version's input),
    its kept task words, this state's K11 tables (`resident`, future
    set) and the preemptor `p` (an int64 device scalar, or an int on the
    CPU).  `mask` (bool[N], optional) is ANDed in: the rows of other
    dynamic predicates that have no operand form."""

    fields: tuple
    task_words: torch.Tensor
    resident: ResidentWords
    p: torch.Tensor
    mask: torch.Tensor | None = None

    def row(self) -> torch.Tensor:
        """bool[N]: the whole row (`affinity_row`; the plain version on
        the CPU)."""
        r = affinity_row(*self.fields, self.resident, self.p, self.task_words)
        return r if self.mask is None else r & self.mask

    def row_plain(self) -> torch.Tensor:
        """bool[N]: the row by the plain version (the reference's
        products), on any device: what K5's plain version is fed."""
        r = affinity_row_plain(*self.fields, self.resident, self.p)
        return r if self.mask is None else r & self.mask

    def and_mask(self, m: torch.Tensor) -> "AffinityRow":
        """The same predicate ANDed with a bool[N] row."""
        return dataclasses.replace(self, mask=m if self.mask is None else self.mask & m)

    def kernel_args(self, what: str, dev) -> tuple:
        """The operand's C arguments for kernel `what` on device `dev`
        (`csrc/affinity_row.cuh · Operand`), checked: every table of the
        operand on `dev`."""
        if self.task_words.device != dev:
            raise ValueError(f"{what}: the affinity row operand lies on "
                             f"{self.task_words.device}, the other operands on {dev}")
        term_key, term_label, nkd = self.fields[5:8]
        return _row_operand(what, self.resident, self.task_words, term_key, term_label,
                            nkd, self.p)



def affinity_words(task_words, term_key, term_label, node_key_domain,
                   resident: ResidentWords) -> AffinityWords:
    """AffinityWords — see the module docstring."""
    args = (task_words, term_key, term_label, node_key_domain)
    if not _on_card(task_words, "affinity_words"):
        return affinity_words_plain(*args, resident)
    dev = task_words.device
    _check("affinity_words", args, (torch.int32,) * 4, dev)
    tables = _tables("affinity_words", resident, dev)
    K, K2 = resident.K, resident.K2
    T, N = task_words.shape[0], resident.N
    TK = node_key_domain.shape[1] if K2 else 0
    nw = 3 * words(K) + 2 * words(K2)
    if task_words.shape[1] != nw:
        raise ValueError(f"affinity_words: task words must have {nw} words a row")
    # node words and thresholds in one allocation
    buf = torch.empty(N * nw + 2 * T, dtype=torch.int32, device=dev)
    node_words, thr = buf[:N * nw].view(N, nw), buf[N * nw:].view(T, 2)
    err = _fn("kb_affinity_words")(
        *(x.data_ptr() for x in args), *tables, T, N, K, K2, TK, node_words.data_ptr(),
        thr.data_ptr(), build.stream_handle(dev))
    build.check(err, "affinity_words")
    affinity_words.launches += 1
    return AffinityWords(node_words, task_words, thr, K, K2)


affinity_task_words.launches = 0
affinity_mask.launches = 0
affinity_row.launches = 0
affinity_words.launches = 0
