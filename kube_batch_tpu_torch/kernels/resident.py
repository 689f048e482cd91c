"""K11 · the resident label tables of the inter-pod affinity predicate,
as 32-bit words (CUDA C++, `csrc/resident_tables.cu`).

Replaces kube_batch_tpu/plugins/predicates.py · resident_podlabels,
_resident_mask and resident_domain_labels, and the Hb.any(0) of
bootstrap_mask.  What bounds it on the card and what its design does
about that is noted in the source.

`resident_words(task_words, ...)` → `ResidentWords`: from one launch,
the node tables Hb, Ab ([N, words(K)]) of the future residents
(allocated or pipelined) and, `with_now`, Hb_now, Ab_now of those plus
the Releasing ones; when the snapshot has topology-scoped terms (K2 >
0) the domain tables Hd, Ad (and Hd_now, Ad_now) [D, words(K)]; and
`term_exists` [words(K)] = Hb.any(0).  Bit b of word w is column
32w + b.  The rows are read from kernel K10's task words
(`kernels/affinity.py · task_words`), not from the float label fields.

A `ResidentWords` describes the state it was built from and nothing
later: every build has a buffer of its own, so a later build never
writes a table a consumer still holds.  An auction round hands its
consumers (the dynamic predicate, `bootstrap_mask`, the pod-affinity
score) one `RoundResident`, which the first of them fills; the round
makes it afresh, so no build crosses `apply_round`.

The wrapper runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from kube_batch_tpu_torch.api.types import ALLOCATED_STATUSES, TaskStatus
from kube_batch_tpu_torch.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_HELD = tuple(sorted(int(s) for s in ALLOCATED_STATUSES | {TaskStatus.PIPELINED}))
_SIGNATURE = [_P] * 7 + [_I] * 8 + [_P] * 2
_DTYPES = (torch.int32,) * 3 + (torch.bool,) + (torch.int32,) * 3


def words(width: int) -> int:
    """32-bit words of a vocabulary of `width` columns."""
    return (width + 31) // 32


def unpack(w: torch.Tensor, width: int) -> torch.Tensor:
    """i32[..., words(width)] → bool[..., width] (bit b of word w is
    column 32w + b)."""
    shifts = torch.arange(32, dtype=torch.int64, device=w.device)
    bits = (w.long()[..., None] >> shifts) & 1
    return bits.reshape(w.shape[:-1] + (w.shape[-1] * 32,))[..., :width] != 0


def pack(bits: torch.Tensor) -> torch.Tensor:
    """bool[..., W] → i32[..., words(W)], the inverse of `unpack`."""
    W = bits.shape[-1]
    nw = words(W)
    padded = torch.zeros(bits.shape[:-1] + (nw * 32,), dtype=torch.int64,
                         device=bits.device)
    padded[..., :W] = bits.long()
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    v = (padded.view(bits.shape[:-1] + (nw, 32)) << shifts).sum(dim=-1)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


_TABLES = ("Hb", "Ab", "Hb_now", "Ab_now", "Hd", "Ad", "Hd_now", "Ad_now",
           "term_exists")


class ResidentWords:
    """The resident tables of one state as words (see the module
    docstring), in one i32 buffer: the node sets Hb, Ab [, Hb_now,
    Ab_now] ([N, words(K)] each), the domain sets Hd, Ad [, Hd_now,
    Ad_now] ([D, words(K)] each, with topology-scoped terms only) and
    term_exists [words(K)].  Without `with_now` the `_now` tables are the
    future ones; without topology-scoped terms the domain tables are
    None.  Each table is a view made at first use; a kernel takes its
    address (`address`) and makes none."""

    def __init__(self, buf: torch.Tensor, N: int, D: int, K: int, K2: int,
                 with_now: bool) -> None:
        self.buf, self.N, self.D, self.K, self.K2 = buf, N, D, K, K2
        self.with_now = with_now
        KW = words(K)
        node_sets, dom_sets, _ = _layout(N, D, KW, with_now, K2 > 0)
        n, d, base = N * KW, D * KW, node_sets * N * KW
        now = 2 if with_now else 0
        # (word offset, rows) of each table; None: no such table
        dom = (lambda i: (base + i * d, D)) if dom_sets else (lambda i: None)
        self._where = dict(zip(_TABLES, (
            (0, N), (n, N), (now * n, N), ((now + 1) * n, N),
            dom(0), dom(1), dom(now), dom(now + 1), (base + dom_sets * d, None))))
        self._views: dict = {}

    def __getattr__(self, name):
        if name not in _TABLES:
            raise AttributeError(name)
        view = self._views.get(name)
        if view is None and self._where[name] is not None:
            off, rows = self._where[name]
            KW = words(self.K)
            flat = self.buf[off:off + (KW if rows is None else rows * KW)]
            view = self._views[name] = flat if rows is None else flat.view(rows, KW)
        return view

    def address(self, name: str) -> int | None:
        """Device address of table `name` (None when it does not exist)."""
        where = self._where[name]
        return None if where is None else self.buf.data_ptr() + 4 * where[0]

    def tables(self, now: bool = False):
        """(Hb, Ab, Hd, Ad) unpacked to bool (the `_now` set with `now`),
        as the reference's resident_podlabels / resident_domain_labels
        return them."""
        src = ((self.Hb_now, self.Ab_now, self.Hd_now, self.Ad_now) if now
               else (self.Hb, self.Ab, self.Hd, self.Ad))
        return tuple(None if x is None else unpack(x, self.K) for x in src)


class RoundResident:
    """The resident tables of one auction round's state: empty until the
    first consumer that reads them builds them (`plugins/predicates.py ·
    round_words`), then handed to the rest.  `with_now`: the round is the
    Idle pass, whose predicate also reads the Releasing-inclusive set."""

    __slots__ = ("with_now", "words")

    def __init__(self, with_now: bool) -> None:
        self.with_now = with_now
        self.words: ResidentWords | None = None


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


def _layout(N: int, D: int, KW: int, with_now: bool, domains: bool):
    """Word offsets and shapes of the tables in the one buffer, in the
    kernel's order: node sets, domain sets, term_exists."""
    node_sets = 4 if with_now else 2
    dom_sets = (4 if with_now else 2) if domains else 0
    size = (node_sets * N + dom_sets * D + 1) * KW
    return node_sets, dom_sets, size


def resident_words_plain(task_words, task_node, task_state, task_mask,
                         node_key_domain, term_key, term_label, num_nodes: int,
                         num_domains: int, K: int, K2: int,
                         with_now: bool) -> ResidentWords:
    """The reference's segment sums and `> 0`, on the unpacked task
    words, packed back to words."""
    N, D = num_nodes, num_domains
    KW, K2W = words(K), words(K2)
    tw = task_words
    anti, labels = unpack(tw[:, KW:2 * KW], K), unpack(tw[:, 2 * KW:3 * KW], K)
    anti_topo = unpack(tw[:, 3 * KW + K2W:3 * KW + 2 * K2W], K2)
    domains = K2 > 0
    TK = node_key_domain.shape[1] if domains else 0
    node_of = torch.clamp(task_node, 0, N - 1).long()
    onehot = torch.nn.functional.one_hot(term_label.long(), K).float()    # [K2, K]

    def presence(rows, held, seg, S):
        acc = torch.zeros((S + 1, rows.shape[1]), dtype=torch.int32, device=rows.device)
        acc.index_add_(0, torch.where(held, seg, S).long(), rows.int())
        return acc[:S] > 0

    def tables(held):
        node = [presence(labels, held, task_node, N), presence(anti, held, task_node, N)]
        dom = []
        if domains:
            Hd = torch.zeros((D, K), dtype=torch.bool, device=tw.device)
            Ad = torch.zeros((D, K), dtype=torch.bool, device=tw.device)
            for tk in range(TK):
                seg = node_key_domain[node_of, tk]
                Hd |= presence(labels, held, seg, D)
                # 0/1 products summed over at most K2 terms: exact in float32
                anti_lab = (anti_topo & (term_key == tk)[None, :]).float() @ onehot
                Ad |= presence(anti_lab > 0, held, seg, D)
            dom = [Hd, Ad]
        return node, dom

    fut_node, fut_dom = tables(resident_mask(task_state, task_node, task_mask, False))
    now_node, now_dom = (tables(resident_mask(task_state, task_node, task_mask, True))
                         if with_now else ([], []))
    parts = [pack(x).reshape(-1) for x in fut_node + now_node + fut_dom + now_dom]
    parts.append(pack(fut_node[0].any(dim=0)))
    buf = torch.cat(parts)
    return ResidentWords(buf, N, D, K, K2, with_now)


def resident_words(task_words, task_node, task_state, task_mask, node_key_domain,
                   term_key, term_label, num_nodes: int, num_domains: int, K: int,
                   K2: int, with_now: bool = False) -> ResidentWords:
    """ResidentWords — see the module docstring.  `task_words` are K10's
    (i32[T, 3 words(K) + 2 words(K2)]), `node_key_domain`, `term_key`
    and `term_label` the snapshot's, `task_node` and `task_state` the
    live state's."""
    args = (task_words, task_node, task_state, task_mask, node_key_domain, term_key,
            term_label)
    dev = task_state.device
    if dev.type == "cpu":
        return resident_words_plain(*args, num_nodes, num_domains, K, K2, with_now)
    if dev.type != "cuda":
        raise RuntimeError(f"resident_words: unsupported device {dev}")
    N, D = num_nodes, num_domains
    KW, K2W = words(K), words(K2)
    T = task_words.shape[0]
    for x, want in zip(args, _DTYPES):
        if x.dtype != want or x.device != dev or not x.is_contiguous():
            raise TypeError(f"resident_words: expected contiguous {want} on {dev}, "
                            f"got {x.dtype} on {x.device}")
    if task_words.shape[1] != 3 * KW + 2 * K2W:
        raise ValueError("resident_words: task words do not match K and K2")
    domains = K2 > 0
    TK = node_key_domain.shape[1] if domains else 0
    buf = torch.empty(_layout(N, D, KW, with_now, domains)[2], dtype=torch.int32,
                      device=dev)
    err = build.function("resident_tables", "kb_resident_words", _SIGNATURE)(
        *(x.data_ptr() for x in args), T, N, D, KW, K2W, TK, int(with_now),
        int(domains), buf.data_ptr(), build.stream_handle(dev))
    build.check(err, "resident_words")
    resident_words.launches += 1
    return ResidentWords(buf, N, D, K, K2, with_now)


resident_words.launches = 0
