"""K13 · nodeorder's pod-affinity score, one row per class of preference
rows (CUDA C++, `csrc/podaff_score.cu`).

Replaces kube_batch_tpu/plugins/nodeorder.py · pod_affinity_score.  What
bounds it on the card and what its design does about that is noted in
the source.

The term depends on a task only through its preference row
[task_podpref | task_podpref_topo], and the tasks of a gang share one.
`pref_classes(pref, pref_topo)` groups the rows into classes once a
cycle (`PrefClasses`: the class of each row, the class rows, their
denominators, each class's nonzero weights as lists (`class_lists`, the
kernel's operand) and the output buffer), and each auction round
`podaff_score(classes, Hb, Hd, node_key_domain, term_key, term_label, w)`
writes the weighted table f32[C, N] into the classes' buffer from
kernel K11's packed resident words, which it reads as words.  Kernel K2
reads the table at row cls[t] (`kernels/propose.py · ClassTerm`, whose
`dense()` gathers the [T, N] score for the tests).

For one (class, node) cell, in this order (both versions):

    node_raw = Σ over k ascending of rows[c, k] where Hb(n, k) is set
    topo_raw = Σ over k2 ascending of rows_topo[c, k2] where
               Hd(node_key_domain[n, term_key[k2]], term_label[k2]) is set
    raw      = node_raw + topo_raw        (topo_raw only when K2 > 0)
    out      = w · ((raw / denom[c]) · 10)

so kernel and plain version agree bit for bit for any weights, and
both agree with the reference's float32 products wherever those sums
are exact (every world of this repository).

The wrapper runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
`plan` reports the launch the kernel makes for given operands.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from kube_batch_tpu_torch.kernels import build
from kube_batch_tpu_torch.kernels.affinity import present_table
from kube_batch_tpu_torch.kernels.resident import unpack, words

MAX_SCORE = 10.0
#: the kernel's widest vocabulary, in words (csrc/podaff_score.cu · MAX_WORDS)
MAX_WORDS = 8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURE = [_P] * 8 + [_I] * 6 + [_F, _P, _P]
_PLAN_SIGNATURE = [_I] * 6 + [_P]
#: the fields of `plan`, in the C entry's order (csrc/podaff_score.cu · kb_podaff_plan)
PLAN_FIELDS = ("classes_per_block", "chunks", "grid_x", "grid_y", "words_in_registers",
               "hd_in_shared", "smem_bytes")


@dataclasses.dataclass(frozen=True)
class PrefClasses:
    """The distinct preference rows of one snapshot: `cls` i32[T] (the
    class of each task row), `rows` f32[C, K] and `rows_topo` f32[C, K2]
    (the class rows, in the lexicographic order of `torch.unique`),
    `denom` f32[C] = max(Σ_k rows + Σ_k2 rows_topo, 1e-9) (each sum in
    ascending order, the second added only when K2 > 0, as the
    reference's two sums), `out` f32[C, N], the buffer every `podaff_score`
    call of the cycle writes (a table is valid until the next call), and
    `lists`, `counts` (`class_lists`), which the kernel reads in place of
    the rows."""

    cls: torch.Tensor
    rows: torch.Tensor
    rows_topo: torch.Tensor
    denom: torch.Tensor
    out: torch.Tensor
    lists: torch.Tensor
    counts: torch.Tensor

    @property
    def C(self) -> int:
        return self.rows.shape[0]


def ordered_sum(rows: torch.Tensor) -> torch.Tensor:
    """f32[C]: each row summed in ascending column order, starting at 0."""
    acc = torch.zeros(rows.shape[0], dtype=torch.float32, device=rows.device)
    for k in range(rows.shape[1]):
        acc = acc + rows[:, k]
    return acc


def class_lists(rows: torch.Tensor, rows_topo: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each class's nonzero weights, the kernel's operand: `lists`
    i32[C, K + K2, 2], the node-level part at [0, K) and the topology
    part at [K, K + K2), each the (k, w) entries of the row's nonzero
    weights in ascending k (w as float32 bits) followed by (k, +0) for
    its zero weights; and `counts` i32[C, 2], the nonzero weights of
    each part."""
    parts, counts = [], []
    for r in (rows, rows_topo):
        nonzero = r != 0
        order = torch.sort((~nonzero).to(torch.int32), dim=1, stable=True).indices
        w = torch.where(nonzero.gather(1, order), r.gather(1, order), 0.0)
        parts.append(torch.stack([order.to(torch.int32), w.view(torch.int32)], dim=-1))
        counts.append(nonzero.sum(dim=1, dtype=torch.int32))
    return torch.cat(parts, dim=1).contiguous(), torch.stack(counts, dim=1).contiguous()


def pref_classes(pref: torch.Tensor, pref_topo: torch.Tensor, num_nodes: int) -> PrefClasses:
    """The classes of the rows [pref | pref_topo] (f32[T, K], f32[T, K2]).
    Reads C on the host: call it at a cycle's setup, never in a round."""
    K = pref.shape[1]
    uniq, inverse = torch.unique(torch.cat([pref, pref_topo], dim=1), dim=0,
                                 return_inverse=True)
    rows, rows_topo = uniq[:, :K].contiguous(), uniq[:, K:].contiguous()
    total = ordered_sum(rows)
    if rows_topo.shape[1]:
        total = total + ordered_sum(rows_topo)
    denom = torch.clamp(total, min=1e-9)
    out = torch.empty((rows.shape[0], num_nodes), dtype=torch.float32, device=pref.device)
    return PrefClasses(inverse.to(torch.int32), rows, rows_topo, denom, out,
                       *class_lists(rows, rows_topo))


def podaff_score_plain(classes: PrefClasses, Hb, Hd, node_key_domain, term_key,
                       term_label, w: float) -> torch.Tensor:
    """The kernel's arithmetic in its order, into `classes.out`."""
    K, K2 = classes.rows.shape[1], classes.rows_topo.shape[1]
    N = Hb.shape[0]
    C = classes.C
    hb = unpack(Hb, K)                                               # bool[N, K]
    zero = torch.zeros((), dtype=torch.float32, device=Hb.device)

    def walk(bits, rows):
        raw = torch.zeros((C, N), dtype=torch.float32, device=Hb.device)
        for k in range(rows.shape[1]):
            raw = raw + torch.where(bits[None, :, k], rows[:, k, None], zero)
        return raw

    raw = walk(hb, classes.rows)
    if K2:
        present = present_table(node_key_domain, term_key, term_label, unpack(Hd, K)) != 0
        raw = raw + walk(present, classes.rows_topo)
    score = raw / classes.denom[:, None] * MAX_SCORE
    return classes.out.copy_(score * w)


def podaff_score(classes: PrefClasses, Hb, Hd, node_key_domain, term_key, term_label,
                 w: float) -> torch.Tensor:
    """The weighted table f32[C, N] (`classes.out`) of this state's
    resident words: `Hb` i32[N, words(K)] and `Hd` i32[D, words(K)] (None
    when K2 = 0) are K11's future tables; `w` the plugin weight, a
    Python float passed to the kernel (nothing is copied to the card)."""
    dev = Hb.device
    if dev.type == "cpu":
        return podaff_score_plain(classes, Hb, Hd, node_key_domain, term_key,
                                  term_label, w)
    if dev.type != "cuda":
        raise RuntimeError(f"podaff_score: unsupported device {dev}")
    C, K = classes.rows.shape
    K2, N = classes.rows_topo.shape[1], Hb.shape[0]
    if words(K) > MAX_WORDS or words(K2) > MAX_WORDS:
        raise NotImplementedError(
            f"podaff_score: vocabularies past {32 * MAX_WORDS} columns")
    if Hb.shape[1] != words(K) or (K2 and (Hd is None or Hd.shape[1] != words(K))):
        raise ValueError("podaff_score: resident words of another vocabulary")
    if classes.out.shape != (C, N):
        raise ValueError("podaff_score: output buffer of another shape")
    lists, counts = classes.lists, classes.counts
    if lists.shape != (C, K + K2, 2) or counts.shape != (C, 2):
        raise ValueError("podaff_score: class lists of another shape")
    if lists.data_ptr() % 8 or counts.data_ptr() % 8:
        raise ValueError("podaff_score: lists not 8-byte aligned")
    f32 = (classes.denom, classes.out)
    i32 = (lists, counts, Hb, node_key_domain, term_key, term_label) + ((Hd,) if K2 else ())
    for x, want in [(x, torch.float32) for x in f32] + [(x, torch.int32) for x in i32]:
        if x.dtype != want or x.device != dev or not x.is_contiguous():
            raise TypeError(f"podaff_score: expected contiguous {want} on {dev}, "
                            f"got {x.dtype} on {x.device}")
    err = build.function("podaff_score", "kb_podaff_score", _SIGNATURE)(
        build.ptr(lists), build.ptr(counts), build.ptr(classes.denom), build.ptr(Hb),
        build.ptr(Hd if K2 else None), build.ptr(node_key_domain), build.ptr(term_key),
        build.ptr(term_label), C, N, K, K2, Hd.shape[0] if K2 else 0,
        node_key_domain.shape[1], float(w), build.ptr(classes.out), build.stream_handle(dev))
    build.check(err, "podaff_score")
    podaff_score.launches += 1
    return classes.out


podaff_score.launches = 0


def plan(classes: PrefClasses, Hb, Hd, node_key_domain) -> dict:
    """The launch `podaff_score` makes for these operands on the current
    card (`PLAN_FIELDS`): classes a block, the grid, whether a node's
    words sit in registers and Hd in shared memory (else it is read from
    global memory), the dynamic shared memory.  Needs the built kernel."""
    C, K = classes.rows.shape
    K2 = classes.rows_topo.shape[1]
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    build.function("podaff_score", "kb_podaff_plan", _PLAN_SIGNATURE)(
        C, Hb.shape[0], K, K2, Hd.shape[0] if K2 else 0, node_key_domain.shape[1],
        ctypes.cast(out, ctypes.c_void_p))
    return dict(zip(PLAN_FIELDS, out))
