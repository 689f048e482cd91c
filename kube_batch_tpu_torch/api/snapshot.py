"""Dense tensor snapshot of the cluster — the device-side ClusterInfo.

Reference counterpart: pkg/scheduler/api/cluster_info.go · ClusterInfo
(maps of JobInfo/NodeInfo/QueueInfo) plus the per-object accounting in
job_info.go / node_info.go.  Those maps become one dataclass of padded,
statically-shaped tensors on ONE explicit device; every plugin and action
is a plain function `SnapshotTensors -> tensors`.

Shape legend (all padded):
    T — tasks (pods)        J — jobs (pod groups)
    N — nodes               Q — queues
    R — resource dims       L — label vocab     V — taint vocab
    P — host-port vocab     K — pod-label vocab

Label/taint/port vocabularies turn the reference's string-keyed
selector/taint matching into products over multi-hot matrices; the packer
interns the strings (cache/packer.py).

Precision rule: sums of resource requests over tasks (segment sums and
segment prefixes) are accumulated in float64 and rounded once to
float32.  They are exact for integer-valued requests below 2**53, and
they do not depend on the order of accumulation, so the CPU and the
card agree bit for bit.  Everything else that bears on a decision stays
float32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from kube_batch_tpu_torch.api.types import (
    ALLOCATED_STATUSES,
    READY_STATUSES,
    VALID_STATUSES,
    TaskStatus,
)
from kube_batch_tpu_torch.kernels import lex_rank as _k8
from kube_batch_tpu_torch.kernels import segment_sum as _k7

# Sentinel index for "no node / no job / no queue".
NONE_IDX = -1

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
}


@dataclasses.dataclass
class SnapshotTensors:
    """One consistent view of the cluster as tensors on one device.

    Produced by `from_numpy` over the packer's fields; consumed by every
    plugin/action.  Padding rows have mask == False and are inert
    everywhere (requests 0, capacities 0, job/queue index NONE_IDX).
    Field meanings are those of `kube_batch_tpu.api.snapshot`.
    """

    # -- tasks ----------------------------------------------------------
    task_req: torch.Tensor        # f32[T, R]
    task_state: torch.Tensor      # i32[T]
    task_job: torch.Tensor        # i32[T]
    task_node: torch.Tensor       # i32[T]
    task_prio: torch.Tensor       # f32[T]
    task_order: torch.Tensor      # i32[T]
    task_mask: torch.Tensor       # bool[T]
    task_sel: torch.Tensor        # f32[T, L]
    task_pref: torch.Tensor       # f32[T, L]
    task_tol: torch.Tensor        # f32[T, V]
    task_ports: torch.Tensor      # f32[T, P]
    task_critical: torch.Tensor   # bool[T]
    task_podlabels: torch.Tensor  # f32[T, K]
    task_aff: torch.Tensor        # f32[T, K]
    task_anti: torch.Tensor       # f32[T, K]
    task_podpref: torch.Tensor    # f32[T, K]
    task_aff_topo: torch.Tensor   # f32[T, K2]
    task_anti_topo: torch.Tensor  # f32[T, K2]
    task_podpref_topo: torch.Tensor  # f32[T, K2 | 0]
    topo_term_key: torch.Tensor   # i32[K2]
    topo_term_label: torch.Tensor  # i32[K2]
    node_key_domain: torch.Tensor  # i32[N, TK]
    domain_mask: torch.Tensor     # bool[D]
    task_vol_node: torch.Tensor   # i32[T]
    task_vol_groups: torch.Tensor  # f32[T, G]
    vol_group_sel: torch.Tensor   # f32[G, L]
    # -- jobs -----------------------------------------------------------
    job_queue: torch.Tensor       # i32[J]
    job_min: torch.Tensor         # i32[J]
    job_prio: torch.Tensor        # f32[J]
    job_order: torch.Tensor       # i32[J]
    job_mask: torch.Tensor        # bool[J]
    # -- nodes ----------------------------------------------------------
    node_cap: torch.Tensor        # f32[N, R]
    node_idle: torch.Tensor       # f32[N, R]
    node_releasing: torch.Tensor  # f32[N, R]
    node_labels: torch.Tensor     # f32[N, L]
    node_taints: torch.Tensor     # f32[N, V]
    node_ports: torch.Tensor      # f32[N, P]
    node_ready: torch.Tensor      # bool[N]
    node_pressure: torch.Tensor   # f32[N, 3]
    node_mask: torch.Tensor       # bool[N]
    # -- queues / namespaces / budgets ----------------------------------
    queue_weight: torch.Tensor    # f32[Q]
    queue_mask: torch.Tensor      # bool[Q]
    task_ns: torch.Tensor         # i32[T]
    ns_weight: torch.Tensor       # f32[S]
    ns_mask: torch.Tensor         # bool[S]
    task_pdbs: torch.Tensor       # f32[T, B]
    pdb_min: torch.Tensor         # i32[B]
    # -- cluster --------------------------------------------------------
    cluster_total: torch.Tensor   # f32[R]
    eps: torch.Tensor             # f32[R]
    besteffort_eps: torch.Tensor  # f32[R]

    @property
    def device(self) -> torch.device:
        return self.task_req.device

    @property
    def num_tasks(self) -> int:
        return self.task_req.shape[0]

    @property
    def num_jobs(self) -> int:
        return self.job_min.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.node_cap.shape[0]

    @property
    def num_queues(self) -> int:
        return self.queue_weight.shape[0]

    @property
    def num_resources(self) -> int:
        return self.task_req.shape[1]

    def affinity_task_words(self) -> "torch.Tensor | None":
        """The inter-pod affinity task words of kernel K10
        (`kernels/affinity.py · affinity_words`) once a call built them
        for this snapshot; carried to the next pack's snapshot as the
        segment indexes are (`TASK_WORDS_FIELDS`)."""
        return self.__dict__.get("_affinity_task_words")

    def keep_affinity_task_words(self, task_words: torch.Tensor) -> None:
        self.__dict__["_affinity_task_words"] = task_words

    def segment_index(self, kind: str) -> "SegmentIndex":
        """The segment index of one base id vector ("job", "queue" or
        "ns", see `SEGMENT_BASES`), built at its first use after a pack
        and kept beside the snapshot.  The incremental packer carries it
        to the next pack's snapshot only when that pack wrote none of its
        base's fields (`carry_segment_indexes`); nothing else writes them
        between packs."""
        kept = self.__dict__.setdefault("_segment_index", {})
        idx = kept.get(kind)
        if idx is None:
            base, S = segment_base(self, kind)
            idx = kept[kind] = build_segment_index(base, S)
        return idx


FIELDS = tuple(f.name for f in dataclasses.fields(SnapshotTensors))


def from_numpy(
    fields: Mapping[str, Any], device: torch.device | str
) -> SnapshotTensors:
    """Move packed numpy fields (this package's `pack_snapshot_loop`
    output, or the reference package's `pack_snapshot_host` leaves) onto
    `device` as a SnapshotTensors.  Keys outside the dataclass are
    ignored; dtypes are kept (f32 / i32 / bool).  Every field is a COPY,
    on the CPU too: the incremental packer patches its host arrays in
    place, and a snapshot that shared their memory would follow them."""
    return SnapshotTensors(
        **{name: to_device(fields[name], device, name) for name in FIELDS}
    )


def to_device(arr, device: torch.device | str, name: str = "") -> torch.Tensor:
    """A copy of one packed numpy field on `device`, dtype kept."""
    arr = np.ascontiguousarray(np.asarray(arr))
    dtype = _TORCH_DTYPES.get(arr.dtype)
    if dtype is None:
        raise TypeError(f"field {name}: unsupported dtype {arr.dtype}")
    return torch.from_numpy(arr).to(device=device, dtype=dtype, copy=True)


# ---------------------------------------------------------------------------
# segment reductions (float64 accumulation, see the precision rule above)
# ---------------------------------------------------------------------------

#: base id vector of each segment index → the snapshot fields it reads
SEGMENT_BASES = {
    "job": ("task_job",),
    "queue": ("task_job", "job_queue"),
    "ns": ("task_ns",),
}


#: the snapshot fields kernel K10's task words read
TASK_WORDS_FIELDS = ("task_aff", "task_anti", "task_podlabels", "task_aff_topo",
                     "task_anti_topo")


@dataclasses.dataclass(frozen=True)
class SegmentIndex:
    """The rows of a snapshot in the stable order of one base id vector:
    segment s holds rows order[offsets[s] : offsets[s + 1]], ascending.
    Rows whose base lies outside [0, num_segments) sort after every
    segment and belong to none.  Every segment sum over this base passes
    seg = where(mask, base, num_segments), so kernel K7 walks a segment's
    rows here and skips those masked out, with no sort per call."""

    base: torch.Tensor      # i32[T]
    order: torch.Tensor     # i32[T]
    offsets: torch.Tensor   # i32[num_segments + 1]
    num_segments: int


def row_at(x: torch.Tensor, i) -> torch.Tensor:
    """x[i] for an index that may be a 0-dim device tensor (a preemption
    step's p or v), gathered on the device: `x[i]` would read such an
    index on the host, which a captured step cannot."""
    if not isinstance(i, torch.Tensor):
        return x[i]
    return x.index_select(0, i.reshape(1)).squeeze(0)


def task_queue_of(snap: SnapshotTensors) -> torch.Tensor:
    """i32[T]: each task's queue index via its job (padding → 0, masked)."""
    job = torch.clamp(snap.task_job, 0, snap.num_jobs - 1).long()
    return torch.clamp(snap.job_queue[job], 0, snap.num_queues - 1)


def segment_base(snap: SnapshotTensors, kind: str) -> tuple[torch.Tensor, int]:
    """(base i32[T], number of segments) of one segment index kind."""
    if kind == "job":
        return snap.task_job, snap.num_jobs
    if kind == "queue":
        return task_queue_of(snap), snap.num_queues
    if kind == "ns":
        # clamped into range: the namespace sums mask out tasks without one
        S = snap.ns_weight.shape[0]
        return torch.clamp(snap.task_ns, 0, S - 1), S
    raise KeyError(f"no segment index {kind!r} (one of {sorted(SEGMENT_BASES)})")


def build_segment_index(base: torch.Tensor, num_segments: int) -> SegmentIndex:
    """The stable sort of the rows by `base`: K8's `sort_by_segment` on
    the card, torch.sort(stable=True) on the CPU; offsets by searchsorted."""
    T, dev = base.shape[0], base.device
    key = torch.where((base >= 0) & (base < num_segments), base,
                      num_segments).to(torch.int32)
    if dev.type == "cuda":
        perm, s_seg = _k8.sort_by_segment(
            key, torch.arange(T, dtype=torch.int32, device=dev), num_segments)
    else:
        s_seg, perm = torch.sort(key, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=s_seg.dtype, device=dev)
    offsets = torch.searchsorted(s_seg, bounds, out_int32=True)
    return SegmentIndex(base.to(torch.int32), perm.to(torch.int32), offsets,
                        num_segments)


def carry_segment_indexes(prev: SnapshotTensors, new: SnapshotTensors,
                          written) -> None:
    """Give `new` (the next pack's snapshot) the segment indexes of
    `prev` whose base fields are not among the fields this pack wrote,
    and its affinity task words when the pack wrote none of
    `TASK_WORDS_FIELDS`."""
    kept = prev.__dict__.get("_segment_index", {})
    written = set(written)
    carried = {kind: idx for kind, idx in kept.items()
               if not written.intersection(SEGMENT_BASES[kind])}
    new.__dict__["_segment_index"] = carried
    words = prev.affinity_task_words()
    if words is not None and not written.intersection(TASK_WORDS_FIELDS):
        new.keep_affinity_task_words(words)


def segment_sum(
    values: torch.Tensor, seg: torch.Tensor, num_segments: int,
    index: SegmentIndex | None = None,
) -> torch.Tensor:
    """Sum rows of `values` into `num_segments` segments; rows whose
    `seg` equals `num_segments` are dropped (the padding sentinel).
    Floats accumulate in float64 and return float32; integers and bools
    return int32 counts.  Kernel K7 on the card (float sums need the
    segment `index` of the base `seg` was taken from: seg is, row by row,
    index.base or num_segments), its plain version on the CPU
    (kernels/segment_sum.py)."""
    if not values.is_floating_point():
        return _k7.segment_count(values, seg, num_segments)
    if index is None:
        return _k7.segment_sum(values, seg, num_segments)
    return _k7.segment_sum(values, seg, num_segments, index.order, index.offsets)


# ---------------------------------------------------------------------------
# derived quantities (the accounting rules of job_info.go / node_info.go
# as whole-snapshot reductions)
# ---------------------------------------------------------------------------

def status_is(task_state: torch.Tensor, *statuses: TaskStatus) -> torch.Tensor:
    """bool[T] mask of tasks in any of the given statuses."""
    m = torch.zeros_like(task_state, dtype=torch.bool)
    for s in statuses:
        m = m | (task_state == int(s))
    return m


def allocated_mask(task_state: torch.Tensor) -> torch.Tensor:
    """Tasks occupying node resources (job_info.go · AllocatedStatus)."""
    return status_is(task_state, *ALLOCATED_STATUSES)


def count_per_job(snap: SnapshotTensors, task_mask: torch.Tensor) -> torch.Tensor:
    """i32[J]: number of masked tasks per job (padding-safe)."""
    m = task_mask & snap.task_mask
    seg = torch.where(m, snap.task_job, snap.num_jobs)
    return segment_sum(m, seg, snap.num_jobs)


def sum_req_per_job(snap: SnapshotTensors, task_mask: torch.Tensor) -> torch.Tensor:
    """f32[J, R]: summed requests of masked tasks per job."""
    m = task_mask & snap.task_mask
    idx = snap.segment_index("job")
    seg = torch.where(m, idx.base, snap.num_jobs)
    return segment_sum(
        torch.where(m[:, None], snap.task_req, 0.0), seg, snap.num_jobs, idx
    )


def job_ready_counts(
    snap: SnapshotTensors, task_state: torch.Tensor | None = None
) -> torch.Tensor:
    """i32[J]: tasks per job already holding resources (ReadyTaskNum)."""
    ts = snap.task_state if task_state is None else task_state
    return count_per_job(snap, status_is(ts, *READY_STATUSES))


def job_valid_counts(
    snap: SnapshotTensors, task_state: torch.Tensor | None = None
) -> torch.Tensor:
    """i32[J]: tasks that could still become ready (ValidTaskNum)."""
    ts = snap.task_state if task_state is None else task_state
    return count_per_job(snap, status_is(ts, *VALID_STATUSES))


def fits(req: torch.Tensor, avail: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Batched LessEqual with per-dim slack (resource_info.go · LessEqual):
    req f32[..., R], avail f32[..., R], eps f32[R] → bool[...]."""
    return torch.all((req <= avail) | (req < eps), dim=-1)


# ---------------------------------------------------------------------------
# padding helpers (host side)
# ---------------------------------------------------------------------------

def bucket(n: int, minimum: int = 8) -> int:
    """Round `n` up to a padding bucket (next power of two, ≥ minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_rows(arr: np.ndarray, rows: int, fill: Any = 0) -> np.ndarray:
    """Pad axis 0 of `arr` to `rows` with `fill`."""
    if arr.shape[0] > rows:
        raise ValueError(f"cannot pad {arr.shape[0]} rows down to {rows}")
    if arr.shape[0] == rows:
        return arr
    pad_shape = (rows - arr.shape[0],) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)], axis=0)
