"""Incremental tensor pack: patch the previous cycle's arrays in place.

Reference counterpart: cache/cache.go · Snapshot rebuilds the ClusterInfo
deep copy every cycle — affordable in Go at 1 Hz, but the tensor
equivalent (``pack_snapshot_full``: vocabulary interning + multi-hot
construction over every pod) costs hundreds of milliseconds of host
Python at 50k pods (PERF.md), the dominant cost of a steady-state cycle.  The cache is event-sourced, so
the pack doesn't need to be O(cluster): this packer keeps the previous
pack's padded numpy arrays plus intern tables (`PackInternals`) and, for
each cycle, patches exactly the rows whose pods/nodes changed.

The DEVICE side is row-granular too: dirty rows are tracked per field,
and a steady cycle ships only those rows, all fields at once, through
kernel K9 (``kernels/row_patch.py``: the dirty rows gathered from the host
arrays straight into a pinned staging slot, and one launch that writes
them into the live device buffers) instead of re-uploading
every touched array in full.  Whole-array upload remains the fallback
once the dirty fraction of a field crosses ``ROW_PATCH_MAX_FRAC`` (a
dense patch costs more than a fresh copy past that), and is what full
rebuilds use.  The host-patch / upload split is kept in
``last_host_ms`` / ``last_h2d_ms`` and the bytes shipped in
``last_h2d_bytes``; the pack modes are counted in ``full_packs``,
``incremental_packs`` and ``row_patched_packs``.

Aliasing: the reference's device arrays are immutable, so its previous
snapshot survives a row patch.  Here K9 writes INTO the buffers of the
previous SnapshotTensors, so a snapshot is valid only until the next
pack; a reader that keeps one across cycles must clone it.

Patch vocabulary (drained from the cache's `PackDirty` journal, under
the cache lock):

* pod status/node transitions  → two [T] rows (task_state, task_node)
* pod deletions                → swap-compact with the last real row
  (real rows stay a contiguous prefix, the invariant every
  ``meta.num_real_tasks`` consumer relies on)
* pod additions                → append a row, IF every string the pod
  carries — including topology-scoped affinity terms and volume-group
  claims — is already interned (vocabularies only ever grow on a full
  rebuild — "rebuild fully only on vocab growth")
* pod-group additions/updates  → append/patch a job row
* node accounting changes      → per-node rows (idle/releasing/cap/
  pressure/ports) + cluster_total

Topology-domain and volume-group GEOMETRY (node_key_domain,
topo_term_*, domain_mask, vol_group_sel) is whole-cluster state, but
every mutation that can change it (node object changes, claim /
storage-class churn, a term outside the interned vocabularies) already
forces a full rebuild — so a cluster that merely *has* affinity or
volume constraints no longer pays the full-pack cliff every cycle: its
steady status churn row-patches like everyone else's, and the geometry
arrays ride along untouched.

Everything else — object-set changes (nodes, queues, namespaces, PDBs,
volumes), vocabulary growth, bucket overflow — falls back to a full
``pack_snapshot_full`` rebuild.  Falling back is always safe: the
rebuild ignores the half-patched arrays entirely (and reuses the
per-job column blocks of unchanged jobs, see packer.JobBlock).

Row order note: a fresh full pack sorts tasks by (job, creation);
swap-compaction perturbs that order.  Every kernel orders by explicit
rank keys (task_order/task_prio/...), never by row index, so the only
observable difference is the tie-break among tasks with fully identical
keys — the reference breaks those ties arbitrarily too
(util.SelectBestNode).

Concurrency: `pack()` runs entirely under the cache lock, as do all
cache mutators, so a pack observes every mutation either fully before
or fully after — the reference's mutex-held-Snapshot guarantee.
`verify_against_live()` re-checks the packed mutable fields against the
live cache (still under the lock) and is the mechanical enforcement of
that invariant; `check = True` runs it after every pack.

The port of kube_batch_tpu/cache/incremental.py without the mesh, the
metrics and the trace spans.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time

import numpy as np
import torch

from kube_batch_tpu_torch.api.snapshot import (
    NONE_IDX,
    bucket,
    carry_segment_indexes,
    from_numpy,
    to_device,
)
from kube_batch_tpu_torch.cache.cache import CacheResyncing, SchedulerCache
from kube_batch_tpu_torch.cache.packer import (
    PackInternals,
    SnapshotMeta,
    pack_snapshot_full,
    resolve_claims,
    split_topo_term,
)
from kube_batch_tpu_torch.device import resolve_device
from kube_batch_tpu_torch.kernels import row_patch as _k9

log = logging.getLogger(__name__)

_TASK_FIELDS = (
    "task_req", "task_state", "task_job", "task_node", "task_prio",
    "task_order", "task_mask", "task_sel", "task_pref", "task_tol",
    "task_ports", "task_critical", "task_podlabels", "task_aff",
    "task_anti", "task_podpref", "task_aff_topo", "task_anti_topo",
    "task_podpref_topo", "task_vol_node", "task_vol_groups", "task_ns",
    "task_pdbs",
)
# Padding fill per field (defaults to 0 / False via the array dtype).
_TASK_FILL = {
    "task_job": NONE_IDX,
    "task_node": NONE_IDX,
    "task_ns": NONE_IDX,
    "task_vol_node": NONE_IDX,
}


class _FullRebuild(Exception):
    def __init__(self, reason: str) -> None:
        super().__init__(reason)
        self.reason = reason


class _RowChanges:
    """Dirty-row ledger for one incremental pack: field → set of dirty
    row indices, or None meaning the WHOLE array must re-upload."""

    __slots__ = ("fields",)

    def __init__(self) -> None:
        self.fields: dict[str, set | None] = {}

    def rows(self, field: str, *idx: int) -> None:
        cur = self.fields.get(field, False)
        if cur is False:
            self.fields[field] = set(idx)
        elif cur is not None:
            cur.update(idx)

    def whole(self, field: str) -> None:
        self.fields[field] = None

    def __bool__(self) -> bool:
        return bool(self.fields)

    def __len__(self) -> int:
        return len(self.fields)


class IncrementalPacker:
    """One per scheduler (it owns a `PackDirty` journal on the cache).
    Packs land on `device` ("cuda" by default)."""

    #: Past this dirty fraction of a field's rows, ship the whole array
    #: instead of a row patch (a dense scatter moves more bytes than a
    #: fresh copy once indices + values approach the array itself).
    ROW_PATCH_MAX_FRAC = 0.25

    def __init__(self, cache: SchedulerCache,
                 device: str | torch.device = "cuda") -> None:
        self.cache = cache
        self.device = resolve_device(device)
        self._dirty = cache.register_dirty_listener()
        self._snap = None
        self._meta: SnapshotMeta | None = None
        self._ints: PackInternals | None = None
        self._task_row: dict[str, int] = {}
        self._job_row: dict[str, int] = {}
        self._node_row: dict[str, int] = {}
        self._queue_row: dict[str, int] = {}
        self._ns_row: dict[str, int] = {}
        self.full_packs = 0
        self.incremental_packs = 0
        self.row_patched_packs = 0
        self.last_mode = ""
        # H2D bytes the LAST pack shipped (whole arrays + row patches),
        # counted exactly as the reference packer counts them.
        self.last_h2d_bytes = 0
        # Wall milliseconds of the last pack's host work (journal patch
        # or full rebuild) and of its transfer to the device (whole
        # arrays and K9's staged copy and launch, synchronized).
        self.last_host_ms = 0.0
        self.last_h2d_ms = 0.0
        # Operator escape hatch (pack_mode="full"): every pack rebuilds
        # from scratch; device state is identical either way.
        self.force_full = False
        # Why each full rebuild happened (journal full_reason or the
        # incremental path's bail-out reason).
        self.fallback_reasons: collections.Counter = collections.Counter()
        # PodGroups affected by the mutations this pack absorbed (None
        # after a full rebuild = "all"): close_session refreshes exactly
        # these instead of recomputing every job's status each cycle.
        self.last_groups: set[str] | None = None
        self.check = False

    # -- entry point ----------------------------------------------------

    def pack(self):
        """(SnapshotTensors, SnapshotMeta) for the current cache state.
        The snapshot stays valid until the next pack (row patches write
        into its buffers)."""
        with self.cache.lock():
            if self.cache.is_resyncing():
                # The quiesce guard cache.snapshot() applies, extended to
                # incremental packs (which never call snapshot).  The
                # journal is left intact; the first cycle after the hold
                # releases packs everything.
                raise CacheResyncing(
                    "cache mirror is quiesced; skip this cycle"
                )
            d = self._dirty
            affected = set(d.groups)
            if self._snap is None or d.full or self.force_full:
                reason = d.full_reason or (
                    "first-pack" if self._snap is None else "forced"
                )
                out = self._full(reason)
                self.last_groups = None  # object set changed: refresh all
            else:
                try:
                    out = self._incremental()
                    self.last_groups = affected
                except _FullRebuild as exc:
                    out = self._full(exc.reason)
                    self.last_groups = None
            if self.check:
                self.verify_against_live()
            return out

    def _synced_ms(self, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return (time.perf_counter() - t0) * 1e3

    # -- full rebuild ---------------------------------------------------

    def _full(self, reason: str):
        d = self._dirty
        # Only jobs whose MEMBERSHIP the journal touched (pod add/delete)
        # need their column blocks re-derived; status churn never
        # invalidates a block (mutable fields are re-read from the live
        # pods anyway).
        invalid = frozenset(d.reset_groups)
        # pack_mode="full" rebuilds from NOTHING (no job blocks, no node
        # or domain geometry), so a stale-cache bug cannot survive the
        # very mode meant to flush it.
        prev = None if self.force_full else self._ints
        t0 = time.perf_counter()
        _, meta, ints = pack_snapshot_full(
            self.cache.snapshot(shared=True), device=None,
            prev=prev, invalid_jobs=invalid,
        )
        self.last_host_ms = (time.perf_counter() - t0) * 1e3
        nbytes = sum(arr.nbytes for arr in ints.arrays.values())
        t0 = time.perf_counter()
        snap = from_numpy(ints.arrays, self.device)
        self.last_h2d_ms = self._synced_ms(t0)
        self.last_h2d_bytes = nbytes
        self._snap, self._meta, self._ints = snap, meta, ints
        self._task_row = {u: i for i, u in enumerate(ints.task_uids)}
        self._job_row = {n: i for i, n in enumerate(ints.job_names)}
        self._node_row = {n: i for i, n in enumerate(ints.node_names)}
        self._queue_row = {n: i for i, n in enumerate(ints.queue_names)}
        self._ns_row = {n: i for i, n in enumerate(ints.ns_names)}
        d.clear()
        self.full_packs += 1
        self.fallback_reasons[reason] += 1
        self.last_mode = f"full:{reason}"
        log.debug("full pack (%s): T=%d N=%d", reason,
                  len(ints.task_uids), len(ints.node_names))
        return snap, meta

    # -- incremental patching ------------------------------------------

    def _incremental(self):
        ints, d = self._ints, self._dirty
        a = ints.arrays

        changed = _RowChanges()
        rows_changed = False

        t0 = time.perf_counter()
        for name in d.added_jobs:
            rows_changed |= self._upsert_job(name, changed)
        for uid in d.deleted_pods:
            rows_changed |= self._delete_row(uid, changed)
        for uid in d.added_pods:
            rows_changed |= self._append_pod(uid, changed)
        for uid in d.status_pods:
            self._patch_status(uid, changed)
        if d.nodes:
            view = self._health_view()
            for name in d.nodes:
                self._patch_node(name, changed, view)
            real_n = len(ints.node_names)
            a["cluster_total"] = (
                a["node_cap"][:real_n].sum(axis=0).astype(np.float32)
            )
            changed.whole("cluster_total")
        if rows_changed:
            self._meta = self._meta.replace_rows(ints)
        self.last_host_ms = (time.perf_counter() - t0) * 1e3

        row_patched = False
        t0 = time.perf_counter()
        if changed:
            try:
                row_patched = self._upload(changed)
            except Exception:
                # Device upload failed (e.g. out of memory): the host
                # arrays are patched but the device buffers are stale —
                # force the next pack to rebuild rather than serve them.
                d.mark_full("upload-failed")
                raise
        else:
            self.last_h2d_bytes = 0
        self.last_h2d_ms = self._synced_ms(t0)
        # Drain the journal only once the device state is consistent.
        d.clear()
        self.incremental_packs += 1
        if row_patched:
            self.row_patched_packs += 1
        self.last_mode = f"incremental:{len(changed)}-arrays"
        return self._snap, self._meta

    def _upload(self, changed: _RowChanges) -> bool:
        """Ship this pack's dirty state to the device: row patches for
        sparsely-dirty fields (one K9 launch for all of them), a fresh
        whole-array copy for the rest.  Returns True when at least one
        field went as a row patch.  Accounts every byte in
        last_h2d_bytes as the reference does."""
        a = self._ints.arrays
        whole: dict[str, np.ndarray] = {}
        patch: dict[str, np.ndarray] = {}
        frac = self.ROW_PATCH_MAX_FRAC
        for f, rows in changed.fields.items():
            arr = a[f]
            if rows is not None and arr.ndim:
                # The patch payload as it will actually ship: indices
                # padded to their bucket plus one row of values each.
                row_nb = arr.dtype.itemsize * (
                    int(np.prod(arr.shape[1:])) if arr.ndim > 1 else 1
                )
                payload = bucket(len(rows), minimum=2) * (4 + row_nb)
            if (
                rows is None
                or arr.ndim == 0
                or frac <= 0  # row patching disabled (comparisons)
                or len(rows) > max(1, int(arr.shape[0] * frac))
                # a "patch" bigger than the array is just a worse copy
                # (small padded arrays with a handful of dirty rows)
                or payload >= arr.nbytes
            ):
                whole[f] = arr
            else:
                patch[f] = np.fromiter(
                    sorted(rows), np.int32, count=len(rows))
        nbytes = sum(arr.nbytes for arr in whole.values())
        if patch:
            nbytes += self._row_patch(patch)
        uploaded = {f: to_device(arr, self.device) for f, arr in whole.items()}
        prev = self._snap
        self._snap = dataclasses.replace(prev, **uploaded)
        # the segment indexes of K7 stay valid while their base fields do
        carry_segment_indexes(prev, self._snap, changed.fields)
        self.last_h2d_bytes = nbytes
        return bool(patch)

    def _row_patch(self, patch: dict[str, np.ndarray]) -> int:
        """K9 for the sparsely-dirty fields (field → sorted int32 rows):
        the rows are padded to their bucket by repeating the first row (as
        the reference pads; its scatter compiles once per bucket), and the
        kernel's wrapper gathers each field's rows straight from the host
        array into its staging slot.  Returns the bytes the reference
        counts: the padded indices and one row of values each."""
        a = self._ints.arrays
        arrays, rows_l, nbytes = [], [], 0
        for f, ridx in patch.items():
            kp = bucket(len(ridx), minimum=2)
            if kp != len(ridx):
                ridx = np.concatenate([
                    ridx, np.full(kp - len(ridx), ridx[0], np.int32),
                ])
            arr = a[f]
            arrays.append(arr)
            rows_l.append(ridx)
            nbytes += ridx.nbytes + kp * (arr.nbytes // arr.shape[0])
        _k9.row_patch([getattr(self._snap, f) for f in patch], arrays, rows_l)
        return nbytes

    # -- jobs -----------------------------------------------------------

    def _upsert_job(self, name: str, changed: _RowChanges) -> bool:
        job = self.cache._jobs.get(name)
        if job is None:
            return False  # deleted since (full rebuild already flagged)
        a = self._ints.arrays
        j = self._job_row.get(name)
        if j is None:
            if not job.queue or job.queue not in self._queue_row:
                return False  # invisible (unknown queue): same filter as snapshot()
            j = len(self._ints.job_names)
            if j >= a["job_min"].shape[0]:
                raise _FullRebuild("job-bucket-overflow")
            self._ints.job_names.append(name)
            self._job_row[name] = j
            a["job_queue"][j] = self._queue_row[job.queue]
            a["job_mask"][j] = True
            changed.rows("job_queue", j)
            changed.rows("job_mask", j)
            # A group arriving AFTER its pods (shell job): its existing
            # tasks become visible now.
            for pod in sorted(job.tasks.values(), key=lambda p: p.creation):
                self._append_pod(pod.uid, changed)
        a["job_min"][j] = job.min_available
        a["job_prio"][j] = job.priority
        a["job_order"][j] = job.pod_group.creation
        changed.rows("job_min", j)
        changed.rows("job_prio", j)
        changed.rows("job_order", j)
        return True

    # -- pods -----------------------------------------------------------

    def _delete_row(self, uid: str, changed: _RowChanges) -> bool:
        row = self._task_row.pop(uid, None)
        if row is None:
            return False  # was never packed (unmanaged/shell/invisible)
        ints = self._ints
        # Membership changed through the INCREMENTAL path: the cached
        # column block no longer matches this job, and the journal mark
        # that recorded it dies with this pack's d.clear() — drop the
        # block now or a later full rebuild could revalidate a
        # same-uid-set ghost (delete + re-add of one uid in one journal
        # window) against stale pod data.
        group = ints.task_pods[row].group
        if group:
            ints.job_blocks.pop(group, None)
        a = ints.arrays
        last = len(ints.task_uids) - 1
        if row != last:
            for f in _TASK_FIELDS:
                a[f][row] = a[f][last]
            moved_uid = ints.task_uids[last]
            ints.task_uids[row] = moved_uid
            ints.task_pods[row] = ints.task_pods[last]
            self._task_row[moved_uid] = row
        for f in _TASK_FIELDS:
            a[f][last] = _TASK_FILL.get(f, 0)
            changed.rows(f, row, last)
        ints.task_uids.pop()
        ints.task_pods.pop()
        return True

    def _append_pod(self, uid: str, changed: _RowChanges) -> bool:
        if uid in self._task_row:
            return False
        pod = self.cache._pods.get(uid)
        if pod is None:
            return False  # added then deleted between packs
        if pod.group is None:
            return False  # unmanaged: visible only through node accounting
        j = self._job_row.get(pod.group)
        if j is None:
            return False  # shell/invisible job; its group arrival rebuilds
        ints = self._ints
        a = ints.arrays
        t = len(ints.task_uids)
        if t >= a["task_state"].shape[0]:
            raise _FullRebuild("task-bucket-overflow")
        ns = self._ns_row.get(pod.namespace)
        if ns is None:
            raise _FullRebuild("new-namespace")

        lab, tnt, prt, pl, tt = (
            ints.lab_idx, ints.tnt_idx, ints.prt_idx, ints.pl_idx,
            ints.tt_idx,
        )

        def _intern(idx, keys, what):
            out = []
            for k in keys:
                i = idx.get(k)
                if i is None:
                    raise _FullRebuild(f"vocab-growth:{what}")
                out.append(i)
            return out

        sel_ix = _intern(lab, [f"{k}={v}" for k, v in pod.selector.items()],
                         "label")
        pref_ix = _intern(lab, list(pod.preferences), "label")
        tol_ix = _intern(tnt, pod.tolerations, "taint")
        prt_ix = _intern(prt, pod.ports, "port")
        own_ix = _intern(pl, [f"{k}={v}" for k, v in pod.labels.items()],
                         "podlabel")

        def _terms(terms, what):
            """Node-level terms → pod-label cols; topology-scoped terms
            → topo-term cols (both against the PACKED vocabularies —
            an uninterned term is vocabulary growth, exactly like a
            fresh label)."""
            node_ix, topo_ix = [], []
            for term in terms:
                tk, labterm = split_topo_term(term)
                if tk is None:
                    i = pl.get(labterm)
                    if i is None:
                        raise _FullRebuild(f"vocab-growth:{what}")
                    node_ix.append(i)
                else:
                    ti = tt.get((tk, labterm))
                    if ti is None:
                        raise _FullRebuild("vocab-growth:topo-term")
                    topo_ix.append(ti)
            return node_ix, topo_ix

        aff_ix, aff_topo_ix = _terms(pod.affinity, "affinity")
        anti_ix, anti_topo_ix = _terms(pod.anti_affinity, "anti-affinity")
        ppref_node: list[tuple[int, float]] = []
        ppref_topo: list[tuple[int, float]] = []
        for term, w in pod.pod_prefs.items():
            tk, labterm = split_topo_term(term)
            if tk is None:
                i = pl.get(labterm)
                if i is None:
                    raise _FullRebuild("vocab-growth:pod-pref")
                ppref_node.append((i, w))
            else:
                ti = tt.get((tk, labterm))
                if ti is None:
                    raise _FullRebuild("vocab-growth:topo-term")
                if a["task_podpref_topo"].shape[1] == 0:
                    # The packed snapshot statically skipped the soft
                    # topo-pref matmul (zero width); widening it is a
                    # shape change only a rebuild can make.
                    raise _FullRebuild("soft-topo-pref-growth")
                ppref_topo.append((ti, w))

        # Volume feasibility for the new pod, against the PACKED volume
        # groups (packer.resolve_claims — the one shared state
        # machine): bound claims pin, constrained claims set their
        # existing group bit, unknown claims/classes mark infeasible —
        # a constrained claim missing from the packed group vocab is
        # geometry growth (new vol_group_sel column → rebuild).
        vol_node = NONE_IDX
        vol_groups_ix: list[int] = []
        if pod.claims:
            vol_node, vol_groups_ix, grows = resolve_claims(
                pod.claims, self.cache._claims,
                self.cache._storage_classes, self._node_row.get,
                ints.g_idx,
            )
            if grows:
                raise _FullRebuild("vol-group-growth")

        a["task_req"][t] = self._meta.spec.pod_vec(pod)
        a["task_state"][t] = int(pod.status)
        a["task_job"][t] = j
        a["task_node"][t] = (
            self._node_row.get(pod.node, NONE_IDX)
            if pod.node is not None else NONE_IDX
        )
        a["task_prio"][t] = pod.priority
        a["task_order"][t] = pod.creation
        a["task_mask"][t] = True
        a["task_critical"][t] = pod.critical
        a["task_vol_node"][t] = vol_node
        a["task_ns"][t] = ns
        for f, ixs in (("task_sel", sel_ix), ("task_tol", tol_ix),
                       ("task_ports", prt_ix), ("task_podlabels", own_ix),
                       ("task_aff", aff_ix), ("task_anti", anti_ix),
                       ("task_aff_topo", aff_topo_ix),
                       ("task_anti_topo", anti_topo_ix),
                       ("task_vol_groups", vol_groups_ix)):
            for i in ixs:
                a[f][t, i] = 1.0
        for i, w in zip(pref_ix, pod.preferences.values()):
            a["task_pref"][t, i] = w
        for i, w in ppref_node:
            a["task_podpref"][t, i] = w
        for i, w in ppref_topo:
            a["task_podpref_topo"][t, i] = w
        if pod.labels:
            for bi, bname in enumerate(self._ints.pdb_names):
                pdb = self.cache._pdbs.get(bname)
                if pdb is not None and pdb.selector and pdb.matches(pod):
                    a["task_pdbs"][t, bi] = 1.0
        ints.task_uids.append(uid)
        ints.task_pods.append(pod)
        self._task_row[uid] = t
        # Same discipline as _delete_row: this job's cached block is
        # stale the moment a row is appended outside a full rebuild.
        ints.job_blocks.pop(pod.group, None)
        for f in _TASK_FIELDS:
            changed.rows(f, t)
        return True

    def _patch_status(self, uid: str, changed: _RowChanges) -> None:
        row = self._task_row.get(uid)
        if row is None:
            return
        pod = self.cache._pods.get(uid)
        if pod is None:
            return  # deleted later in the journal; delete was processed first
        a = self._ints.arrays
        a["task_state"][row] = int(pod.status)
        a["task_node"][row] = (
            self._node_row.get(pod.node, NONE_IDX)
            if pod.node is not None else NONE_IDX
        )
        changed.rows("task_state", row)
        changed.rows("task_node", row)

    # -- nodes ----------------------------------------------------------

    def _health_view(self) -> tuple[frozenset, dict, int | None]:
        """(cordoned names, probation canary remaining, pods-dim index)
        from the cache's attached health ledger — the incremental
        twin of the full pack reading HostSnapshot.cordoned/
        canary_pods.  Empty views when no ledger is wired."""
        health = getattr(self.cache, "health", None)
        if health is not None:
            cordoned, canary = health.pack_view()
        else:
            cordoned, canary = frozenset(), {}
        names = self.cache.spec.names
        pods_ix = names.index("pods") if "pods" in names else None
        return cordoned, canary, pods_ix

    def _patch_node(self, name: str, changed: _RowChanges,
                    view: tuple | None = None) -> None:
        row = self._node_row.get(name)
        if row is None:
            return  # unready/deleted: excluded from the pack
        info = self.cache._nodes.get(name)
        if info is None:
            return
        cordoned, canary, pods_ix = (
            view if view is not None else self._health_view()
        )
        a = self._ints.arrays
        a["node_cap"][row] = info.allocatable
        a["node_idle"][row] = info.idle
        # Same health masking as the full pack: cordons (ledger +
        # spec.unschedulable) fold into node_ready; a probation node's
        # pod-slot idle clamps to its remaining canary.
        a["node_ready"][row] = info.node.schedulable(cordoned)
        cap = canary.get(name)
        if cap is not None and pods_ix is not None:
            a["node_idle"][row, pods_ix] = min(
                a["node_idle"][row, pods_ix], float(cap)
            )
        a["node_releasing"][row] = info.releasing
        a["node_pressure"][row] = (
            info.node.memory_pressure,
            info.node.disk_pressure,
            info.node.pid_pressure,
        )
        occupied: set[int] = set()
        for resident in info.tasks.values():
            occupied.update(resident.ports)
        a["node_ports"][row] = 0.0
        for p in occupied:
            i = self._ints.prt_idx.get(p)
            if i is None:
                raise _FullRebuild("vocab-growth:port")
            a["node_ports"][row, i] = 1.0
        for f in ("node_cap", "node_idle", "node_releasing",
                  "node_pressure", "node_ports", "node_ready"):
            changed.rows(f, row)

    # -- host-side reads ------------------------------------------------

    def host_task_state(self) -> np.ndarray:
        """Padded i32[Tp] task_state as of the LAST pack — a fresh copy
        (the packer patches its arrays in place between cycles)."""
        return self._ints.arrays["task_state"].copy()

    def host_field(self, name: str) -> np.ndarray | None:
        """Read-only zero-copy view of one packed host array (None when
        the field is not packed).  Writes through the view raise — the
        underlying arrays are this packer's live patch state."""
        arr = self._ints.arrays.get(name)
        if arr is None:
            return None
        view = arr.view()
        view.flags.writeable = False
        return view

    def host_alloc_state(self):
        """Initial AllocState on the device, built from the pack's HOST
        arrays (equal to `ops.assignment.init_state` of the snapshot)."""
        from kube_batch_tpu_torch.ops.assignment import AllocState

        a = self._ints.arrays
        return AllocState(
            task_state=to_device(a["task_state"], self.device),
            task_node=to_device(a["task_node"], self.device),
            node_idle=to_device(a["node_idle"], self.device),
            node_future=to_device(a["node_idle"] + a["node_releasing"],
                                  self.device),
        )

    # -- mechanical invariant check ------------------------------------

    def verify_against_live(self) -> None:
        """Assert every MUTABLE packed field matches the LIVE cache:
        pod status/node rows, node accounting, job rows (min/prio/
        order/queue), PDB membership bits, and — now that affinity/
        volume clusters pack incrementally — the volume pin/group and
        topology-term rows of claim/affinity-bearing pods.  Called
        under the cache lock this is trivially true — which is exactly
        the invariant: any future code packing outside the lock, or
        mutating without marking, fails here.  Enabled per pack by
        `check = True`.
        """
        with self.cache.lock():
            a = self._ints.arrays
            tt = self._ints.tt_idx
            for uid, row in self._task_row.items():
                pod = self.cache._pods.get(uid)
                assert pod is not None, f"packed pod {uid} vanished"
                assert a["task_state"][row] == int(pod.status), (
                    f"pod {pod.name}: packed state "
                    f"{a['task_state'][row]} != live {int(pod.status)}"
                )
                want = (
                    self._node_row.get(pod.node, NONE_IDX)
                    if pod.node is not None else NONE_IDX
                )
                assert a["task_node"][row] == want, (
                    f"pod {pod.name}: packed node row "
                    f"{a['task_node'][row]} != live {want}"
                )
                # PDB membership: the packed multi-hot must match a
                # fresh evaluation of every budget's selector.
                for bi, bname in enumerate(self._ints.pdb_names):
                    pdb = self.cache._pdbs.get(bname)
                    member = bool(
                        pdb is not None and pdb.selector and pdb.matches(pod)
                    )
                    assert bool(a["task_pdbs"][row, bi]) == member, (
                        f"pod {pod.name}: packed pdb[{bname}] bit "
                        f"{bool(a['task_pdbs'][row, bi])} != live {member}"
                    )
                if pod.claims:
                    self._verify_vol_row(pod, row, a)
                if pod.affinity or pod.anti_affinity:
                    for attr, field in (("affinity", "task_aff_topo"),
                                        ("anti_affinity",
                                         "task_anti_topo")):
                        want_cols = set()
                        for term in getattr(pod, attr):
                            tk, labterm = split_topo_term(term)
                            if tk is not None:
                                want_cols.add(tt[(tk, labterm)])
                        got = set(np.nonzero(a[field][row])[0].tolist())
                        assert got == want_cols, (
                            f"pod {pod.name}: packed {field} cols {got} "
                            f"!= live terms {want_cols}"
                        )
            cordoned, canary, pods_ix = self._health_view()
            for nname, row in self._node_row.items():
                info = self.cache._nodes.get(nname)
                assert info is not None, f"packed node {nname} vanished"
                expected_idle = info.idle
                cap = canary.get(nname)
                if cap is not None and pods_ix is not None:
                    # The pack deliberately clamps a probation node's
                    # pod-slot idle to its remaining canary.
                    expected_idle = expected_idle.copy()
                    expected_idle[pods_ix] = min(
                        expected_idle[pods_ix], float(cap)
                    )
                # rtol covers the f32 quantization of f64 byte counts.
                np.testing.assert_allclose(
                    a["node_idle"][row], expected_idle, rtol=1e-5,
                    err_msg=nname,
                )
                np.testing.assert_allclose(
                    a["node_releasing"][row], info.releasing, rtol=1e-5,
                    err_msg=nname,
                )
                want_ready = info.node.schedulable(cordoned)
                assert bool(a["node_ready"][row]) == want_ready, (
                    f"node {nname}: packed ready bit "
                    f"{bool(a['node_ready'][row])} != live {want_ready} "
                    "(cordon/unschedulable mask out of sync)"
                )
            for jname, row in self._job_row.items():
                job = self.cache._jobs.get(jname)
                assert job is not None, f"packed job {jname} vanished"
                assert a["job_min"][row] == job.min_available, (
                    f"job {jname}: packed min {a['job_min'][row]} != "
                    f"live {job.min_available}"
                )
                assert a["job_prio"][row] == job.priority, (
                    f"job {jname}: packed prio {a['job_prio'][row]} != "
                    f"live {job.priority}"
                )
                assert a["job_order"][row] == job.pod_group.creation, (
                    f"job {jname}: packed order {a['job_order'][row]} != "
                    f"live {job.pod_group.creation}"
                )
                want_q = self._queue_row.get(job.queue, NONE_IDX)
                assert a["job_queue"][row] == want_q, (
                    f"job {jname}: packed queue row {a['job_queue'][row]}"
                    f" != live {want_q}"
                )
    def _verify_vol_row(self, pod, row: int, a: dict) -> None:
        """Recompute the pod's volume pin/groups against the live
        claim/storage-class maps and the PACKED group vocabulary,
        through the same resolver the packs use."""
        want_node, want_list, _grows = resolve_claims(
            pod.claims, self.cache._claims,
            self.cache._storage_classes, self._node_row.get,
            self._ints.g_idx,
        )
        want_groups = set(want_list)
        assert a["task_vol_node"][row] == want_node, (
            f"pod {pod.name}: packed vol pin {a['task_vol_node'][row]} "
            f"!= live {want_node}"
        )
        got = set(np.nonzero(a["task_vol_groups"][row])[0].tolist())
        assert got == want_groups, (
            f"pod {pod.name}: packed vol groups {got} != live "
            f"{want_groups}"
        )
