"""Snapshot packer: HostSnapshot → SnapshotTensors (+ decode metadata).

This is the host-to-device boundary — the analog of the reference handing
the freshly copied ClusterInfo to OpenSession (framework/framework.go ·
OpenSession), except that "handing over" means building dense padded
arrays once per cycle and moving them to the device in one call
(`api.snapshot.from_numpy`).

Orderings are stable (sorted by name/creation), so identical cluster
states produce identical tensors, and bucketed padding keeps the set of
distinct shapes small (api.snapshot.bucket).

Two implementations share this contract bit for bit:

* ``pack_snapshot_full`` — the path every cycle takes (directly with
  ``Scheduler(pack_mode="full")``, or as the incremental packer's
  rebuild): one fused pass per pod collects every immutable column into
  a per-job ``JobBlock``; the global arrays assemble from those blocks
  with ``np.concatenate`` and fancy indexing.  Blocks are cached in
  ``PackInternals.job_blocks`` and reused across rebuilds, so a rebuild
  re-derives only the jobs whose task sets changed.
* ``pack_snapshot_loop`` — the per-pod/per-field loop form, kept as the
  witness: tests hold the vectorized pack equal to it and to the
  reference package's pack (tests/test_torch_pack.py,
  tests/test_torch_incremental.py).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools

import numpy as np
import torch

from kube_batch_tpu_torch.api.resource import ResourceSpec
from kube_batch_tpu_torch.api.snapshot import (
    FIELDS,
    NONE_IDX,
    SnapshotTensors,
    bucket,
    from_numpy,
    pad_rows,
)
from kube_batch_tpu_torch.cache.cache import HostSnapshot
from kube_batch_tpu_torch.cache.cluster import Pod


@dataclasses.dataclass(frozen=True)
class SnapshotMeta:
    """Host-side decode table for one packed snapshot: maps tensor row
    indices back to cache objects, and records the interned vocabularies."""

    spec: ResourceSpec
    task_uids: tuple[str, ...]
    task_pods: tuple[Pod, ...]
    job_names: tuple[str, ...]
    node_names: tuple[str, ...]
    queue_names: tuple[str, ...]
    label_vocab: tuple[str, ...]
    taint_vocab: tuple[str, ...]
    port_vocab: tuple[int, ...]
    podlabel_vocab: tuple[str, ...] = ()

    @property
    def num_real_tasks(self) -> int:
        return len(self.task_uids)

    @property
    def num_real_nodes(self) -> int:
        return len(self.node_names)

        return len(self.node_names)

    def replace_rows(self, ints: "PackInternals") -> "SnapshotMeta":
        """Meta rebuilt from the packer's current ROW state (after
        swap-compaction / appends), every other field carried over via
        dataclasses.replace — so a future SnapshotMeta field can never
        be silently dropped from an incrementally rebuilt meta (the
        old field-by-field reconstruction would have zeroed it)."""
        return dataclasses.replace(
            self,
            task_uids=tuple(ints.task_uids),
            task_pods=tuple(ints.task_pods),
            job_names=tuple(ints.job_names),
            node_names=tuple(ints.node_names),
            queue_names=tuple(ints.queue_names),
        )


@dataclasses.dataclass
class PackInternals:
    """Everything the incremental packer needs to patch a previous pack
    in place: the PADDED host-side numpy arrays that produced the device
    snapshot (same values, mutable), plus the intern tables and the
    per-job column cache the vectorized full pack reuses across
    rebuilds.  Only produced by the pack functions in this module."""

    arrays: dict[str, "np.ndarray"]    # SnapshotTensors field → padded array
    task_uids: list[str]
    task_pods: list
    job_names: list[str]
    node_names: list[str]
    queue_names: list[str]
    ns_names: list[str]
    pdb_names: list[str]
    lab_idx: dict[str, int]
    tnt_idx: dict[str, int]
    prt_idx: dict[int, int]
    pl_idx: dict[str, int]
    # Topology / volume geometry intern tables (empty when the snapshot
    # carries no topo terms / constrained claims): the incremental
    # packer patches topo/volume rows against these instead of
    # full-rebuilding whenever the geometry is merely PRESENT.
    tt_idx: dict = dataclasses.field(default_factory=dict)   # (key, lab) → col
    tk_idx: dict = dataclasses.field(default_factory=dict)   # topo key → idx
    g_idx: dict = dataclasses.field(default_factory=dict)    # claim → vol group
    # Per-job immutable column cache (vectorized full pack only; the
    # loop baseline leaves it empty).  Keyed by job name; a rebuild
    # revalidates each block against the live task-uid set and the
    # journal's touched-group set before reuse.
    job_blocks: dict = dataclasses.field(default_factory=dict)
    # Node-geometry caches (vectorized full pack only): multi-hot
    # node_labels/node_taints and the topology-domain table, reused
    # across rebuilds while the cache's node_version and the relevant
    # vocabularies are unchanged.
    node_geom: tuple | None = None      # (key, node_labels, node_taints)
    domain_geom: tuple | None = None    # (key, nkd, Dp, domain_mask)


def _multi_hot(items_per_row: list[list[int]], rows: int, width: int) -> np.ndarray:
    out = np.zeros((rows, width), dtype=np.float32)
    for i, items in enumerate(items_per_row):
        for j in items:
            out[i, j] = 1.0
    return out


def split_topo_term(term: str) -> tuple[str | None, str]:
    """'zone:app=web' → ('zone', 'app=web'); 'app=web' → (None, 'app=web').

    A ':' counts as a topology-key separator only before the first '='
    (label values may legally contain colons).
    """
    colon = term.find(":")
    eq = term.find("=")
    if colon > 0 and (eq < 0 or colon < eq):
        return term[:colon], term[colon + 1:]
    return None, term



_VOL_INFEASIBLE = -2  # conflicting/unknown claims: no node can satisfy


def resolve_claims(pod_claims, claims, storage_classes,
                   node_row_get, g_idx) -> tuple[int, list, bool]:
    """THE volume-feasibility state machine for one pod's claims —
    (vol_node, group columns, uninterned-constrained-claim flag).

    A bound claim pins the pod to its node (two different pins, an
    unknown PVC, or an unknown StorageClass make it infeasible
    everywhere); an unbound constrained claim sets its volume-group
    bit.  Shared by the vectorized full pack, the incremental
    packer's append, and verify_against_live so the three can never
    drift (the frozen loop baseline deliberately keeps its own copy —
    it is the differential the others are tested against).  The flag
    is True when an unbound claim is CONSTRAINED (its StorageClass
    carries allowed labels) but missing from `g_idx`: new geometry
    only a full rebuild can represent — impossible during a full pack,
    a rebuild trigger for the incremental append."""
    vol_node = NONE_IDX
    groups: list[int] = []
    grows = False
    for cname in pod_claims:
        claim = claims.get(cname)
        if claim is None:
            vol_node = _VOL_INFEASIBLE  # unknown PVC
            continue
        if claim.bound_node is not None:
            pin = node_row_get(claim.bound_node, _VOL_INFEASIBLE)
            if vol_node == NONE_IDX:
                vol_node = pin
            elif vol_node != pin:
                vol_node = _VOL_INFEASIBLE  # two different pins
        elif cname in g_idx:
            groups.append(g_idx[cname])
        elif (
            claim.storage_class
            and claim.storage_class not in storage_classes
        ):
            vol_node = _VOL_INFEASIBLE  # unknown StorageClass
        else:
            sc = storage_classes.get(claim.storage_class)
            if sc is not None and sc.allowed_node_labels:
                grows = True
    return vol_node, groups, grows


# ---------------------------------------------------------------------------
# per-job column blocks (the vectorized pack's unit of caching)
# ---------------------------------------------------------------------------



#: JobBlock sparse feature attributes: (rows list, raw-key list[, weights]).
_SPARSE_ATTRS = (
    "sel", "pref", "tol", "ports", "podlab",
    "aff_n", "anti_n", "ppref_n", "aff_t", "anti_t", "ppref_t",
)

_EMPTY_SPARSE: tuple = ((), ())
_EMPTY_SPARSE_W: tuple = ((), (), ())


class JobBlock:
    """One job's IMMUTABLE task columns: dense per-pod vectors
    (request/priority/order/critical, as numpy slices of a batch-built
    parent array) plus sparse (row, raw-key[, weight]) feature entries
    — interning happens at assembly time against whatever vocabulary
    the current pack derives, so a cached block survives vocabulary
    drift between rebuilds.

    Mutable pod fields (status, node) are deliberately NOT cached: the
    pack re-reads them from `pods` every time.  `pods` holds LIVE Pod
    references, which is why a `prev` internals may only be fed back
    into packs of the SAME cache via shared snapshots (the incremental
    packer's discipline — cache mutators touch exactly the pods whose
    journal marks invalidate their block).  Validity is membership: a
    block is reusable iff the job's task-uid set is unchanged AND the
    pack-dirty journal didn't touch the group (the journal catches the
    same-uid-respawn edge a set compare cannot)."""

    __slots__ = (
        "pods", "uids", "uid_set", "req", "prio", "order", "critical",
        "has_sparse", "ns_uniform", "ns_list",
        "sel", "pref", "tol", "ports", "podlab",
        "aff_n", "anti_n", "ppref_n", "aff_t", "anti_t", "ppref_t",
        "labeled_rows", "claim_rows",
        "label_keys", "taint_keys", "port_keys", "podlabel_keys",
        "topo_keys", "topo_terms",
    )


def _build_blocks(jobs: list[tuple[str, object]],
                  spec: ResourceSpec) -> dict[str, JobBlock]:
    """Build JobBlocks for `jobs` in ONE fused pass over all their pods:
    the dense columns convert to numpy once for the whole batch and are
    sliced back into per-job views, so rebuilding 3k small jobs costs a
    handful of numpy calls, not 3k × fields of them."""
    blocks: dict[str, JobBlock] = {}
    pods_all: list[Pod] = []
    spans: list[tuple[str, JobBlock, int, int]] = []
    for jname, job in jobs:
        b = JobBlock()
        pods = sorted(job.tasks.values(), key=lambda p: p.creation)
        start = len(pods_all)
        pods_all.extend(pods)
        b.pods = pods
        b.uids = [p.uid for p in pods]
        b.uid_set = frozenset(b.uids)
        spans.append((jname, b, start, len(pods_all)))
        blocks[jname] = b

    m = len(pods_all)
    req_all = (
        np.stack([spec.pod_vec(p) for p in pods_all], axis=0)
        .astype(np.float32)
        if pods_all else np.zeros((0, spec.num), np.float32)
    )
    prio_all = np.fromiter(
        (p.priority for p in pods_all), np.float32, count=m)
    order_all = np.fromiter(
        (p.creation for p in pods_all), np.int32, count=m)
    critical_all = np.fromiter(
        (p.critical for p in pods_all), bool, count=m)

    # Sparse features, per job (rows are job-local; raw keys).  The
    # empty-attribute guards skip ~all inner loops on a typical fleet.
    for jname, b, start, end in spans:
        sel_r: list = []; sel_k: list = []          # noqa: E702
        pref_r: list = []; pref_k: list = []        # noqa: E702
        pref_w: list = []
        tol_r: list = []; tol_k: list = []          # noqa: E702
        prt_r: list = []; prt_k: list = []          # noqa: E702
        pl_r: list = []; pl_k: list = []            # noqa: E702
        affn_r: list = []; affn_k: list = []        # noqa: E702
        antin_r: list = []; antin_k: list = []      # noqa: E702
        pprefn_r: list = []; pprefn_k: list = []    # noqa: E702
        pprefn_w: list = []
        afft_r: list = []; afft_k: list = []        # noqa: E702
        antit_r: list = []; antit_k: list = []      # noqa: E702
        ppreft_r: list = []; ppreft_k: list = []    # noqa: E702
        ppreft_w: list = []
        labeled: list[int] = []
        claim_rows: list[int] = []
        ns_uniform: str | None = None
        ns_list: list[str] | None = None

        for i, p in enumerate(b.pods):
            ns = p.namespace
            if ns_list is None:
                if ns_uniform is None:
                    ns_uniform = ns
                elif ns != ns_uniform:
                    # Rare mixed-namespace job: fall back to a list.
                    ns_list = [ns_uniform] * i
                    ns_list.append(ns)
            else:
                ns_list.append(ns)
            if p.selector:
                for k, v in p.selector.items():
                    sel_r.append(i)
                    sel_k.append(f"{k}={v}")
            if p.preferences:
                for lab, w in p.preferences.items():
                    pref_r.append(i)
                    pref_k.append(lab)
                    pref_w.append(w)
            if p.tolerations:
                for t in p.tolerations:
                    tol_r.append(i)
                    tol_k.append(t)
            if p.ports:
                for pt in p.ports:
                    prt_r.append(i)
                    prt_k.append(pt)
            if p.labels:
                labeled.append(i)
                for k, v in p.labels.items():
                    pl_r.append(i)
                    pl_k.append(f"{k}={v}")
            if p.affinity:
                for term in p.affinity:
                    tk, lab = split_topo_term(term)
                    if tk is None:
                        affn_r.append(i)
                        affn_k.append(lab)
                    else:
                        afft_r.append(i)
                        afft_k.append((tk, lab))
            if p.anti_affinity:
                for term in p.anti_affinity:
                    tk, lab = split_topo_term(term)
                    if tk is None:
                        antin_r.append(i)
                        antin_k.append(lab)
                    else:
                        antit_r.append(i)
                        antit_k.append((tk, lab))
            if p.pod_prefs:
                for term, w in p.pod_prefs.items():
                    tk, lab = split_topo_term(term)
                    if tk is None:
                        pprefn_r.append(i)
                        pprefn_k.append(lab)
                        pprefn_w.append(w)
                    else:
                        ppreft_r.append(i)
                        ppreft_k.append((tk, lab))
                        ppreft_w.append(w)
            if p.claims:
                claim_rows.append(i)

        b.req = req_all[start:end]
        b.prio = prio_all[start:end]
        b.order = order_all[start:end]
        b.critical = critical_all[start:end]
        b.ns_uniform = ns_uniform if ns_list is None else None
        b.ns_list = ns_list
        b.sel = (sel_r, sel_k) if sel_r else _EMPTY_SPARSE
        b.pref = (pref_r, pref_k, pref_w) if pref_r else _EMPTY_SPARSE_W
        b.tol = (tol_r, tol_k) if tol_r else _EMPTY_SPARSE
        b.ports = (prt_r, prt_k) if prt_r else _EMPTY_SPARSE
        b.podlab = (pl_r, pl_k) if pl_r else _EMPTY_SPARSE
        b.aff_n = (affn_r, affn_k) if affn_r else _EMPTY_SPARSE
        b.anti_n = (antin_r, antin_k) if antin_r else _EMPTY_SPARSE
        b.ppref_n = (
            (pprefn_r, pprefn_k, pprefn_w) if pprefn_r else _EMPTY_SPARSE_W
        )
        b.aff_t = (afft_r, afft_k) if afft_r else _EMPTY_SPARSE
        b.anti_t = (antit_r, antit_k) if antit_r else _EMPTY_SPARSE
        b.ppref_t = (
            (ppreft_r, ppreft_k, ppreft_w) if ppreft_r else _EMPTY_SPARSE_W
        )
        # One-flag fast path: a block with no sparse entries contributes
        # nothing to any vocabulary or multi-hot (every vocab key comes
        # from a sparse entry), so assembly can skip it outright.
        b.has_sparse = bool(
            sel_r or pref_r or tol_r or prt_r or pl_r or affn_r
            or antin_r or pprefn_r or afft_r or antit_r or ppreft_r
        )
        b.labeled_rows = labeled
        b.claim_rows = claim_rows
        # Vocabulary contributions (what the loop baseline's intern
        # pass would have added for this job's pods).
        b.label_keys = frozenset(sel_k) | frozenset(pref_k)
        b.taint_keys = frozenset(tol_k)
        b.port_keys = frozenset(prt_k)
        b.podlabel_keys = (
            frozenset(pl_k) | frozenset(affn_k) | frozenset(antin_k)
            | frozenset(pprefn_k)
            | frozenset(lab for _tk, lab in afft_k)
            | frozenset(lab for _tk, lab in antit_k)
            | frozenset(lab for _tk, lab in ppreft_k)
        )
        b.topo_keys = (
            frozenset(tk for tk, _lab in afft_k)
            | frozenset(tk for tk, _lab in antit_k)
            | frozenset(tk for tk, _lab in ppreft_k)
        )
        b.topo_terms = (
            frozenset(afft_k) | frozenset(antit_k) | frozenset(ppreft_k)
        )
    return blocks


def _cat(parts: list[np.ndarray], dtype, width: int | None = None) -> np.ndarray:
    if parts:
        return np.concatenate(parts, axis=0)
    shape = (0,) if width is None else (0, width)
    return np.zeros(shape, dtype)


def pack_snapshot_full(
    host: HostSnapshot,
    device: torch.device | str | None = "cuda",
    prev: PackInternals | None = None,
    invalid_jobs=frozenset(),
) -> tuple[SnapshotTensors | None, SnapshotMeta, PackInternals]:
    """Vectorized full pack: (SnapshotTensors on `device`, decode
    metadata, PackInternals).

    `prev` is the previous pack's PackInternals: its per-job column
    blocks are reused for every job whose task-uid set is unchanged and
    whose group the caller's `invalid_jobs` (the journal's touched-group
    set) doesn't name — a rebuild then re-derives only changed jobs and
    assembles the rest by concatenation.  Safe to omit (cold pack).

    `device=None` skips the transfer (the snapshot is None): the caller
    ships `PackInternals.arrays` itself, as the incremental packer does.
    The transfer copies, so the returned tensors never alias the host
    arrays the incremental packer patches in place."""
    spec = host.spec

    queue_names = sorted(host.queues)
    queue_idx = {n: i for i, n in enumerate(queue_names)}
    job_names = sorted(host.jobs)
    node_names = sorted(host.nodes)
    node_idx = {n: i for i, n in enumerate(node_names)}

    # -- per-job blocks (cached across rebuilds) ------------------------
    prev_blocks = prev.job_blocks if prev is not None else {}
    blocks: dict[str, JobBlock] = {}
    stale: list[tuple[str, object]] = []
    for jname in job_names:
        job = host.jobs[jname]
        b = prev_blocks.get(jname)
        if (
            b is None
            or jname in invalid_jobs
            or job.tasks.keys() != b.uid_set
            # O(1) identity spot check: a block caches LIVE Pod
            # references (mutable status/node are re-read through
            # them), so it is only reusable while the snapshot still
            # hands out the SAME objects — true for the incremental
            # packer's shared snapshots of one cache, false for
            # copied (shared=False) snapshots, which replace every
            # pod object and therefore invalidate every block here.
            or (b.pods and job.tasks.get(b.uids[0]) is not b.pods[0])
        ):
            stale.append((jname, job))
            continue
        blocks[jname] = b
    if stale:
        blocks.update(_build_blocks(stale, spec))
    blocklist = [blocks[jname] for jname in job_names]
    counts = np.fromiter(
        (len(b.uids) for b in blocklist), np.int64, count=len(blocklist))
    offsets = np.zeros(len(job_names), np.int64)
    if len(job_names):
        np.cumsum(counts[:-1], out=offsets[1:])
    sparse_blocks = [
        (b, off) for b, off in zip(blocklist, offsets) if b.has_sparse
    ]

    # Every task of every snapshot job, in stable order (per-job sorted
    # by creation; mirrors the loop baseline exactly).  Running tasks
    # are included: preempt/reclaim search over them, and gang
    # readiness counts them.  Unmanaged pods ("Others") are visible
    # only through node_idle.
    tasks: list[Pod] = []
    for b in blocklist:
        tasks.extend(b.pods)
    T = len(tasks)
    task_job_np = np.repeat(
        np.arange(len(job_names), dtype=np.int32), counts
    ) if len(job_names) else np.zeros(0, np.int32)

    # -- intern vocabularies (union of cached per-block key sets) -------
    labels: set[str] = set()
    taints: set[str] = set()
    ports: set[int] = set()
    podlabels: set[str] = set()
    topo_keys: set[str] = set()
    topo_terms: set[tuple[str, str]] = set()
    # ONE pass over sparse-bearing blocks collects both the vocabulary
    # unions and the per-feature (row, key[, weight]) accumulators the
    # multi-hot assembly consumes — every vocab key originates from a
    # sparse entry, so sparse-free blocks contribute nothing.
    _acc: dict[str, tuple[list, list, list]] = {
        attr: ([], [], []) for attr in _SPARSE_ATTRS
    }
    for b, off in sparse_blocks:
        if b.label_keys:
            labels |= b.label_keys
        if b.taint_keys:
            taints |= b.taint_keys
        if b.port_keys:
            ports |= b.port_keys
        if b.podlabel_keys:
            podlabels |= b.podlabel_keys
        if b.topo_keys:
            topo_keys |= b.topo_keys
            topo_terms |= b.topo_terms
        for attr in _SPARSE_ATTRS:
            entry = getattr(b, attr)
            r = entry[0]
            if r:
                rows_parts, keys, weights = _acc[attr]
                rows_parts.append(np.asarray(r, np.int64) + off)
                keys.extend(entry[1])
                if len(entry) == 3:
                    weights.extend(entry[2])
    # Storage-class allowed labels enter the node-label vocab so volume
    # feasibility is one more multi-hot product.
    constrained_claims: list[str] = []
    for b, off in zip(blocklist, offsets):
        for i in b.claim_rows:
            pod = tasks[off + i]
            for cname in pod.claims:
                claim = host.claims.get(cname)
                if claim is None or claim.bound_node is not None:
                    continue
                sc = host.storage_classes.get(claim.storage_class)
                if sc is not None and sc.allowed_node_labels:
                    labels.update(sc.allowed_node_labels)
                    constrained_claims.append(cname)

    node_resident_ports: dict[str, set[int]] = {}
    for nname in node_names:
        info = host.nodes[nname]
        if info.node.labels:
            labels.update(f"{k}={v}" for k, v in info.node.labels.items())
        if info.node.taints:
            taints.update(info.node.taints)
        occupied = set()
        for resident in info.tasks.values():
            if resident.ports:
                occupied.update(resident.ports)
        node_resident_ports[nname] = occupied
        ports.update(occupied)

    label_vocab = tuple(sorted(labels))
    taint_vocab = tuple(sorted(taints))
    port_vocab = tuple(sorted(ports))
    podlabel_vocab = tuple(sorted(podlabels))
    lab_idx = {s: i for i, s in enumerate(label_vocab)}
    tnt_idx = {s: i for i, s in enumerate(taint_vocab)}
    prt_idx = {p: i for i, p in enumerate(port_vocab)}
    pl_idx = {s: i for i, s in enumerate(podlabel_vocab)}

    J, N, Q = len(job_names), len(node_names), len(queue_names)
    Tp, Jp, Np = bucket(T), bucket(J), bucket(N)
    Qp = bucket(Q)
    L, V, P = bucket(len(label_vocab)), bucket(len(taint_vocab)), bucket(len(port_vocab))
    K = bucket(len(podlabel_vocab))

    # -- task tensors (assembled from blocks) ---------------------------
    task_req = _cat([b.req for b in blocklist], np.float32, width=spec.num)
    # IntEnum converts in C inside fromiter (no per-pod int() call);
    # values match the loop baseline's int(p.status) exactly.
    task_state = np.fromiter(
        (p.status for p in tasks), np.int32, count=T)
    _nget = node_idx.get
    task_node = np.fromiter(
        (_nget(p.node, NONE_IDX) if p.node else NONE_IDX
         for p in tasks),
        np.int32, count=T,
    )
    task_prio = _cat([b.prio for b in blocklist], np.float32)
    task_order = _cat([b.order for b in blocklist], np.int32)
    task_critical = _cat([b.critical for b in blocklist], bool)

    def _sparse(attr: str, weighted: bool = False):
        """Concatenated (global rows, raw keys[, weights]) from the
        single block pass above."""
        rows_parts, keys, weights = _acc[attr]
        rows = _cat(rows_parts, np.int64)
        if weighted:
            return rows, keys, np.asarray(weights, np.float32)
        return rows, keys

    def _hot(rows: np.ndarray, keys: list, idx: dict, width: int,
             weights: np.ndarray | None = None) -> np.ndarray:
        # Allocated at the PADDED row count so the later pad_rows call
        # is a no-op instead of a second full-array copy.
        out = np.zeros((Tp, width), dtype=np.float32)
        if len(rows):
            cols = np.fromiter(
                (idx[k] for k in keys), np.int64, count=len(keys))
            out[rows, cols] = 1.0 if weights is None else weights
        return out

    sel_rows, sel_keys = _sparse("sel")
    task_sel = _hot(sel_rows, sel_keys, lab_idx, L)
    pref_rows, pref_keys, pref_w = _sparse("pref", weighted=True)
    task_pref = _hot(pref_rows, pref_keys, lab_idx, L, pref_w)
    tol_rows, tol_keys = _sparse("tol")
    task_tol = _hot(tol_rows, tol_keys, tnt_idx, V)
    prt_rows, prt_keys = _sparse("ports")
    task_ports = _hot(prt_rows, prt_keys, prt_idx, P)
    pl_rows, pl_keys = _sparse("podlab")
    task_podlabels = _hot(pl_rows, pl_keys, pl_idx, K)
    affn_rows, affn_keys = _sparse("aff_n")
    task_aff = _hot(affn_rows, affn_keys, pl_idx, K)
    antin_rows, antin_keys = _sparse("anti_n")
    task_anti = _hot(antin_rows, antin_keys, pl_idx, K)
    pprefn_rows, pprefn_keys, pprefn_w = _sparse("ppref_n", weighted=True)
    task_podpref = _hot(pprefn_rows, pprefn_keys, pl_idx, K, pprefn_w)

    # Node-level terms index the pod-label vocab; topology-scoped terms
    # ("zone:app=web") index the (key, label) topo-term vocab.
    topo_term_list = sorted(topo_terms)
    tt_idx = {t: i for i, t in enumerate(topo_term_list)}
    topo_key_list = sorted(topo_keys)
    tk_idx = {k: i for i, k in enumerate(topo_key_list)}
    K2r = len(topo_term_list)

    # -- job tensors ----------------------------------------------------
    job_queue = np.fromiter(
        (queue_idx[host.jobs[n].queue] for n in job_names), np.int32,
        count=J,
    )
    job_min = np.fromiter(
        (host.jobs[n].min_available for n in job_names), np.int32, count=J)
    job_prio = np.fromiter(
        (host.jobs[n].priority for n in job_names), np.float32, count=J)
    job_order = np.fromiter(
        (host.jobs[n].pod_group.creation for n in job_names), np.int32,
        count=J,
    )

    # -- node tensors ---------------------------------------------------
    if node_names:
        node_cap = np.stack(
            [host.nodes[n].allocatable for n in node_names], axis=0
        ).astype(np.float32)
        node_idle = np.stack(
            [host.nodes[n].idle for n in node_names], axis=0
        ).astype(np.float32)
        node_rel = np.stack(
            [host.nodes[n].releasing for n in node_names], axis=0
        ).astype(np.float32)
    else:
        node_cap = node_idle = node_rel = np.zeros((0, spec.num), np.float32)
    # -- node-health view (kube_batch_tpu/health/) ----------------------
    # Quarantined and externally-cordoned (spec.unschedulable) nodes
    # fold into the node_ready bit: still IN the snapshot (residents
    # keep their accounting, preempt can still evict them) but masked
    # out of every placement, pipelining and preemption target — the
    # predicates plugin, ops/preemption and fit_errors all consume
    # this one bit.  Probation nodes re-admit canary-capped: their
    # visible pod-slot idle is clamped to the remaining canary, so the
    # solver can place at most that many new pods per pack.
    cordoned = host.cordoned
    node_ready_np = np.fromiter(
        (host.nodes[n].node.schedulable(cordoned) for n in node_names),
        bool, count=N,
    ) if node_names else np.zeros(0, bool)
    canary = host.canary_pods
    if canary and node_names and "pods" in spec.names:
        pods_ix = spec.index("pods")
        for ni, n in enumerate(node_names):
            cap = canary.get(n)
            if cap is not None:
                node_idle[ni, pods_ix] = min(
                    node_idle[ni, pods_ix], float(cap)
                )
    # node_labels/node_taints depend only on the node OBJECTS and the
    # interned vocabularies — both keyed here, so rebuilds triggered by
    # pod-side churn reuse the previous matrices untouched.
    node_geom_key = (host.node_version, Np, label_vocab, taint_vocab)
    _ng = prev.node_geom if prev is not None else None
    if _ng is not None and host.node_version >= 0 and _ng[0] == node_geom_key:
        node_labels, node_taints = _ng[1], _ng[2]
    else:
        node_labels = _multi_hot(
            [
                [lab_idx[f"{k}={v}"]
                 for k, v in host.nodes[n].node.labels.items()]
                for n in node_names
            ],
            Np,
            L,
        )
        node_taints = _multi_hot(
            [[tnt_idx[t] for t in host.nodes[n].node.taints]
             for n in node_names],
            Np, V,
        )
    node_geom = (node_geom_key, node_labels, node_taints)
    node_ports = _multi_hot(
        [[prt_idx[p] for p in node_resident_ports[n]] for n in node_names],
        Np, P,
    )
    node_pressure = np.array(
        [
            [
                host.nodes[n].node.memory_pressure,
                host.nodes[n].node.disk_pressure,
                host.nodes[n].node.pid_pressure,
            ]
            for n in node_names
        ],
        dtype=np.float32,
    ) if node_names else np.zeros((0, 3), np.float32)

    # -- topology domains (only when topo-scoped terms exist) -----------
    # Domain = the set of nodes sharing a topology label's value; a node
    # missing the label gets a PRIVATE fallback domain (it can never
    # co-locate with anything under that key).  The last padded domain
    # row is a dead domain that padded topology-key columns point at.
    if K2r:
        TKr = len(topo_key_list)
        TKp = bucket(TKr, minimum=1)
        K2 = bucket(K2r, minimum=8)
        dom_key = (host.node_version, tuple(topo_key_list), N)
        _dg = prev.domain_geom if prev is not None else None
        if _dg is not None and host.node_version >= 0 and _dg[0] == dom_key:
            nkd, Dp, domain_mask_np = _dg[1], _dg[2], _dg[3]
        else:
            dom_idx: dict[str, int] = {}
            fallback_count = 0
            nkd = np.zeros((N, TKp), dtype=np.int32)
            for ti, tk in enumerate(topo_key_list):
                for ni, nname in enumerate(node_names):
                    val = host.nodes[nname].node.labels.get(tk)
                    if val is None:
                        # Private fallback domain; ids live after the
                        # interned block — marked negative here, remapped
                        # once dom_idx is final.
                        fallback_count += 1
                        nkd[ni, ti] = -fallback_count
                    else:
                        key = f"{tk}={val}"
                        if key not in dom_idx:
                            dom_idx[key] = len(dom_idx)
                        nkd[ni, ti] = dom_idx[key]
            Dm = len(dom_idx)
            nkd = np.where(nkd < 0, Dm + (-nkd - 1), nkd)
            D_real = Dm + fallback_count
            Dp = bucket(D_real + 1, minimum=8)
            nkd[:, TKr:] = Dp - 1  # dead domain for padded key columns
            domain_mask_np = np.zeros(Dp, bool)
            domain_mask_np[:D_real] = True
        domain_geom = (dom_key, nkd, Dp, domain_mask_np)
        node_key_domain = nkd
        # Padded term columns carry key/label 0 — harmless, since their
        # task_aff_topo/task_anti_topo columns are all-zero.
        topo_term_key = pad_rows(np.array(
            [tk_idx[t[0]] for t in topo_term_list], dtype=np.int32
        ), K2)
        topo_term_label = pad_rows(np.array(
            [pl_idx[t[1]] for t in topo_term_list], dtype=np.int32
        ), K2)
        afft_rows, afft_keys = _sparse("aff_t")
        antit_rows, antit_keys = _sparse("anti_t")
        ppreft_rows, ppreft_keys, ppreft_w = _sparse("ppref_t", weighted=True)

        def _hot_topo(rows, keys, width, weights=None):
            out = np.zeros((Tp, width), np.float32)
            if len(rows) and width:
                cols = np.fromiter(
                    (tt_idx[k] for k in keys), np.int64, count=len(keys))
                out[rows, cols] = 1.0 if weights is None else weights
            return out

        task_aff_topo = _hot_topo(afft_rows, afft_keys, K2)
        task_anti_topo = _hot_topo(antit_rows, antit_keys, K2)
        # Zero-width when no task carries a soft topo pref, so snapshots
        # using only HARD topo terms statically skip the extra domain
        # scoring matmul (same convention as every other optional vocab).
        task_podpref_topo = _hot_topo(
            ppreft_rows, ppreft_keys, K2 if len(ppreft_rows) else 0,
            ppreft_w,
        )
    else:  # static zero-width: kernels skip all domain math
        TKp, K2, Dp = 0, 0, 0
        domain_geom = None
        node_key_domain = np.zeros((N, 0), np.int32)
        topo_term_key = np.zeros(0, np.int32)
        topo_term_label = np.zeros(0, np.int32)
        task_aff_topo = np.zeros((Tp, 0), np.float32)
        task_anti_topo = np.zeros((Tp, 0), np.float32)
        task_podpref_topo = np.zeros((Tp, 0), np.float32)
        domain_mask_np = np.zeros(0, bool)

    # -- volume feasibility (claims → pins / allowed-label groups) ------
    group_names = sorted(set(constrained_claims))
    g_idx = {c: i for i, c in enumerate(group_names)}
    G = bucket(len(group_names), minimum=8) if group_names else 0
    task_vol_node = np.full(Tp, NONE_IDX, np.int32)
    task_vol_groups = np.zeros((Tp, G), np.float32)
    vol_group_sel = np.zeros((G, L), np.float32)
    for cname in group_names:
        sc = host.storage_classes[host.claims[cname].storage_class]
        for lab in sc.allowed_node_labels:
            vol_group_sel[g_idx[cname], lab_idx[lab]] = 1.0
    for b, off in zip(blocklist, offsets):
        for i in b.claim_rows:
            ti = off + i
            vol_node, vgroups, _grows = resolve_claims(
                tasks[ti].claims, host.claims, host.storage_classes,
                node_idx.get, g_idx,
            )
            task_vol_node[ti] = vol_node
            for gcol in vgroups:
                task_vol_groups[ti, gcol] = 1.0

    queue_weight = np.fromiter(
        (host.queues[n].weight for n in queue_names), np.float32, count=Q)

    # -- namespaces: declared weights + implicit weight-1 for the rest --
    ns_all: set[str] = set(host.namespaces)
    for b in blocklist:
        if b.ns_list is not None:
            ns_all.update(b.ns_list)
        elif b.ns_uniform is not None:
            ns_all.add(b.ns_uniform)
    ns_names = sorted(ns_all) or ["default"]
    ns_idx = {n: i for i, n in enumerate(ns_names)}
    S = len(ns_names)
    Sp = bucket(S)
    task_ns = np.full(Tp, NONE_IDX, np.int32)
    for b, off in zip(blocklist, offsets):
        n = len(b.uids)
        if b.ns_list is None:
            if n:
                task_ns[off:off + n] = ns_idx[b.ns_uniform]
        else:
            task_ns[off:off + n] = np.fromiter(
                (ns_idx[v] for v in b.ns_list), np.int32, count=n)
    ns_weight = np.fromiter(
        (
            host.namespaces[n].weight if n in host.namespaces else 1.0
            for n in ns_names
        ),
        np.float32, count=S,
    )

    # -- PDBs: EVERY matching budget per pod (intersection semantics —
    # a pod under several budgets is evictable only if all survive) ----
    pdb_names = sorted(host.pdbs)
    Bp = bucket(len(pdb_names)) if pdb_names else 0
    task_pdbs = np.zeros((Tp, Bp), np.float32)
    if pdb_names:
        pdb_objs = [host.pdbs[n] for n in pdb_names]
        for b, off in zip(blocklist, offsets):
            for i in b.labeled_rows:
                pod = tasks[off + i]
                for bi, pdb in enumerate(pdb_objs):
                    if pdb.selector and pdb.matches(pod):
                        task_pdbs[off + i, bi] = 1.0
    # Dynamic floor forms (percentages / maxUnavailable) resolve to an
    # absolute floor HERE, against the live matched counts; membership
    # churn on a dynamic budget forces a repack (cache.add_pod /
    # delete_pod mark full), so this can never go stale between packs.
    pdb_min = np.array(
        [
            host.pdbs[n].effective_floor(
                int(task_pdbs[:, bi].sum())
            )
            for bi, n in enumerate(pdb_names)
        ],
        dtype=np.int32,
    ) if pdb_names else np.zeros(0, np.int32)

    arrays: dict[str, np.ndarray] = {
        "task_req": pad_rows(task_req, Tp),
        "task_state": pad_rows(task_state, Tp),
        "task_job": pad_rows(task_job_np, Tp, NONE_IDX),
        "task_node": pad_rows(task_node, Tp, NONE_IDX),
        "task_prio": pad_rows(task_prio, Tp),
        "task_order": pad_rows(task_order, Tp),
        "task_mask": pad_rows(np.ones(T, bool), Tp, False),
        "task_sel": pad_rows(task_sel, Tp),
        "task_pref": pad_rows(task_pref, Tp),
        "task_tol": pad_rows(task_tol, Tp),
        "task_ports": pad_rows(task_ports, Tp),
        "task_critical": pad_rows(task_critical, Tp, False),
        "task_podlabels": pad_rows(task_podlabels, Tp),
        "task_aff": pad_rows(task_aff, Tp),
        "task_anti": pad_rows(task_anti, Tp),
        "task_podpref": pad_rows(task_podpref, Tp),
        "task_aff_topo": pad_rows(task_aff_topo, Tp),
        "task_anti_topo": pad_rows(task_anti_topo, Tp),
        "task_podpref_topo": pad_rows(task_podpref_topo, Tp),
        "topo_term_key": topo_term_key,
        "topo_term_label": topo_term_label,
        "node_key_domain": pad_rows(node_key_domain, Np, Dp - 1 if Dp else 0),
        "domain_mask": domain_mask_np,
        "task_vol_node": pad_rows(task_vol_node, Tp, NONE_IDX),
        "task_vol_groups": pad_rows(task_vol_groups, Tp),
        "vol_group_sel": vol_group_sel,
        "job_queue": pad_rows(job_queue, Jp, NONE_IDX),
        "job_min": pad_rows(job_min, Jp),
        "job_prio": pad_rows(job_prio, Jp),
        "job_order": pad_rows(job_order, Jp),
        "job_mask": pad_rows(np.ones(J, bool), Jp, False),
        "node_cap": pad_rows(node_cap, Np),
        "node_idle": pad_rows(node_idle, Np),
        "node_releasing": pad_rows(node_rel, Np),
        "node_labels": pad_rows(node_labels, Np),
        "node_taints": pad_rows(node_taints, Np),
        "node_ports": pad_rows(node_ports, Np),
        "node_ready": pad_rows(node_ready_np, Np, False),
        "node_pressure": pad_rows(node_pressure, Np),
        "node_mask": pad_rows(np.ones(N, bool), Np, False),
        "queue_weight": pad_rows(queue_weight, Qp),
        "queue_mask": pad_rows(np.ones(Q, bool), Qp, False),
        "task_ns": pad_rows(task_ns, Tp, NONE_IDX),
        "ns_weight": pad_rows(ns_weight, Sp),
        "ns_mask": pad_rows(np.ones(S, bool), Sp, False),
        "task_pdbs": pad_rows(task_pdbs, Tp),
        "pdb_min": pad_rows(pdb_min, Bp) if Bp else pdb_min,
        "cluster_total": node_cap.sum(axis=0).astype(np.float32)
        if len(node_names)
        else np.zeros(spec.num, np.float32),
        "eps": spec.eps.astype(np.float32),
        "besteffort_eps": spec.besteffort_eps.astype(np.float32),
    }
    snap = None if device is None else from_numpy(arrays, device)
    uid_list: list[str] = []
    for b in blocklist:
        uid_list.extend(b.uids)
    meta = SnapshotMeta(
        spec=spec,
        task_uids=tuple(uid_list),
        task_pods=tuple(tasks),
        job_names=tuple(job_names),
        node_names=tuple(node_names),
        queue_names=tuple(queue_names),
        label_vocab=label_vocab,
        taint_vocab=taint_vocab,
        port_vocab=port_vocab,
        podlabel_vocab=podlabel_vocab,
    )
    internals = PackInternals(
        arrays=arrays,
        task_uids=uid_list,
        task_pods=list(tasks),
        job_names=list(job_names),
        node_names=list(node_names),
        queue_names=list(queue_names),
        ns_names=list(ns_names),
        pdb_names=list(pdb_names),
        lab_idx=lab_idx,
        tnt_idx=tnt_idx,
        prt_idx=prt_idx,
        pl_idx=pl_idx,
        tt_idx=tt_idx,
        tk_idx=tk_idx,
        g_idx=g_idx,
        job_blocks=blocks,
        node_geom=node_geom,
        domain_geom=domain_geom,
    )
    return snap, meta, internals


def pack_snapshot_loop(
    host: HostSnapshot,
    min_buckets: dict[str, int] | None = None,
) -> tuple[dict[str, np.ndarray], SnapshotMeta]:
    """The per-pod/per-field loop pack: HostSnapshot → (padded numpy
    fields of SnapshotTensors, decode metadata).  The reference package
    pins its vectorized pack bit-identical to this form; the port packs
    with it directly and moves the fields to the device with
    `api.snapshot.from_numpy`."""
    spec = host.spec

    queue_names = sorted(host.queues)
    queue_idx = {n: i for i, n in enumerate(queue_names)}
    job_names = sorted(host.jobs)
    job_idx = {n: i for i, n in enumerate(job_names)}
    node_names = sorted(host.nodes)
    node_idx = {n: i for i, n in enumerate(node_names)}

    # Every task of every snapshot job, in stable order.  Running tasks are
    # included: preempt/reclaim search over them, and gang readiness counts
    # them.  Unmanaged pods ("Others") are visible only through node_idle.
    tasks: list[Pod] = []
    task_job: list[int] = []
    for jname in job_names:
        job = host.jobs[jname]
        for pod in sorted(job.tasks.values(), key=lambda p: p.creation):
            tasks.append(pod)
            task_job.append(job_idx[jname])

    # -- intern vocabularies -------------------------------------------
    labels: set[str] = set()
    taints: set[str] = set()
    ports: set[int] = set()
    podlabels: set[str] = set()
    topo_keys: set[str] = set()
    topo_terms: set[tuple[str, str]] = set()  # (topology key, "k=v" label)

    def _intern_terms(terms) -> None:
        for term in terms:
            tk, lab = split_topo_term(term)
            podlabels.add(lab)
            if tk is not None:
                topo_keys.add(tk)
                topo_terms.add((tk, lab))

    for pod in tasks:
        # empty-attribute guards: most pods carry no selector/taints/
        # ports, and skipping the no-op set.update calls removes ~200k
        # of them per 50k-pod pack
        if pod.selector:
            labels.update(f"{k}={v}" for k, v in pod.selector.items())
        if pod.preferences:
            labels.update(pod.preferences)
        if pod.tolerations:
            taints.update(pod.tolerations)
        if pod.ports:
            ports.update(pod.ports)
        if pod.labels:
            podlabels.update(f"{k}={v}" for k, v in pod.labels.items())
        if pod.affinity:
            _intern_terms(pod.affinity)
        if pod.anti_affinity:
            _intern_terms(pod.anti_affinity)
        if pod.pod_prefs:
            # Soft co-location terms intern exactly like the hard ones:
            # node-level terms into the pod-label vocab, topology-scoped
            # terms ("zone:app=web") into the topo-term vocab — scored
            # per DOMAIN by nodeorder's pod_affinity_score.
            _intern_terms(pod.pod_prefs)
    # Storage-class allowed labels enter the node-label vocab so volume
    # feasibility is one more multi-hot product.
    constrained_claims: list[str] = []
    for pod in tasks:
        if pod.claims:
            for cname in pod.claims:
                claim = host.claims.get(cname)
                if claim is None or claim.bound_node is not None:
                    continue
                sc = host.storage_classes.get(claim.storage_class)
                if sc is not None and sc.allowed_node_labels:
                    labels.update(sc.allowed_node_labels)
                    constrained_claims.append(cname)

    node_resident_ports: dict[str, set[int]] = {}
    for nname in node_names:
        info = host.nodes[nname]
        labels.update(f"{k}={v}" for k, v in info.node.labels.items())
        taints.update(info.node.taints)
        occupied = set()
        for resident in info.tasks.values():
            occupied.update(resident.ports)
        node_resident_ports[nname] = occupied
        ports.update(occupied)

    label_vocab = tuple(sorted(labels))
    taint_vocab = tuple(sorted(taints))
    port_vocab = tuple(sorted(ports))
    podlabel_vocab = tuple(sorted(podlabels))
    lab_idx = {s: i for i, s in enumerate(label_vocab)}
    tnt_idx = {s: i for i, s in enumerate(taint_vocab)}
    prt_idx = {p: i for i, p in enumerate(port_vocab)}
    pl_idx = {s: i for i, s in enumerate(podlabel_vocab)}

    T, J, N, Q = len(tasks), len(job_names), len(node_names), len(queue_names)
    mb = min_buckets or {}
    Tp = bucket(max(T, mb.get("T", 0)))
    Jp = bucket(max(J, mb.get("J", 0)))
    Np = bucket(max(N, mb.get("N", 0)))
    Qp = bucket(Q)
    L, V, P = bucket(len(label_vocab)), bucket(len(taint_vocab)), bucket(len(port_vocab))
    K = bucket(len(podlabel_vocab))

    # -- task tensors ---------------------------------------------------
    task_req = np.stack(
        [spec.pod_vec(p) for p in tasks], axis=0
    ).astype(np.float32) if tasks else np.zeros((0, spec.num), np.float32)
    task_state = np.array([int(p.status) for p in tasks], dtype=np.int32)
    task_node = np.array(
        [node_idx.get(p.node, NONE_IDX) if p.node else NONE_IDX for p in tasks],
        dtype=np.int32,
    )
    task_prio = np.array([p.priority for p in tasks], dtype=np.float32)
    task_order = np.array([p.creation for p in tasks], dtype=np.int32)
    _empty: list = []
    task_sel = _multi_hot(
        [
            [lab_idx[f"{k}={v}"] for k, v in p.selector.items()]
            if p.selector else _empty
            for p in tasks
        ], T, L,
    )
    task_pref = np.zeros((T, L), dtype=np.float32)
    for i, p in enumerate(tasks):
        if p.preferences:
            for lab, w in p.preferences.items():
                task_pref[i, lab_idx[lab]] = w
    task_tol = _multi_hot(
        [[tnt_idx[t] for t in p.tolerations] if p.tolerations else _empty
         for p in tasks], T, V,
    )
    task_ports = _multi_hot(
        [[prt_idx[pt] for pt in p.ports] if p.ports else _empty
         for p in tasks], T, P,
    )
    task_critical = np.array([p.critical for p in tasks], dtype=bool)
    task_podlabels = _multi_hot(
        [[pl_idx[f"{k}={v}"] for k, v in p.labels.items()] if p.labels else _empty
         for p in tasks], T, K,
    )

    # Node-level terms index the pod-label vocab; topology-scoped terms
    # ("zone:app=web") index the (key, label) topo-term vocab.
    topo_term_list = sorted(topo_terms)
    tt_idx = {t: i for i, t in enumerate(topo_term_list)}
    topo_key_list = sorted(topo_keys)
    tk_idx = {k: i for i, k in enumerate(topo_key_list)}
    K2r = len(topo_term_list)

    def _split_rows(attr: str) -> tuple[list[list[int]], list[list[int]]]:
        node_rows, topo_rows = [], []
        for p in tasks:
            terms = getattr(p, attr)
            if not terms:
                node_rows.append(_empty)
                topo_rows.append(_empty)
                continue
            nr, tr = [], []
            for term in terms:
                tk, lab = split_topo_term(term)
                if tk is None:
                    nr.append(pl_idx[lab])
                else:
                    tr.append(tt_idx[(tk, lab)])
            node_rows.append(nr)
            topo_rows.append(tr)
        return node_rows, topo_rows

    aff_rows, aff_topo_rows = _split_rows("affinity")
    anti_rows, anti_topo_rows = _split_rows("anti_affinity")
    task_aff = _multi_hot(aff_rows, T, K)
    task_anti = _multi_hot(anti_rows, T, K)
    task_podpref = np.zeros((T, K), dtype=np.float32)
    podpref_topo_entries: list[tuple[int, int, float]] = []  # (row, term, w)
    for i, p in enumerate(tasks):
        if p.pod_prefs:
            for term, w in p.pod_prefs.items():
                tk, lab = split_topo_term(term)
                if tk is None:
                    task_podpref[i, pl_idx[lab]] = w
                else:
                    podpref_topo_entries.append((i, tt_idx[(tk, lab)], w))

    # -- job tensors ----------------------------------------------------
    job_queue = np.array(
        [queue_idx[host.jobs[n].queue] for n in job_names], dtype=np.int32
    )
    job_min = np.array([host.jobs[n].min_available for n in job_names], dtype=np.int32)
    job_prio = np.array([host.jobs[n].priority for n in job_names], dtype=np.float32)
    job_order = np.array(
        [host.jobs[n].pod_group.creation for n in job_names], dtype=np.int32
    )

    # -- node tensors ---------------------------------------------------
    if node_names:
        node_cap = np.stack(
            [host.nodes[n].allocatable for n in node_names], axis=0
        ).astype(np.float32)
        node_idle = np.stack(
            [host.nodes[n].idle for n in node_names], axis=0
        ).astype(np.float32)
        node_rel = np.stack(
            [host.nodes[n].releasing for n in node_names], axis=0
        ).astype(np.float32)
    else:
        node_cap = node_idle = node_rel = np.zeros((0, spec.num), np.float32)
    cordoned = host.cordoned
    node_ready_np = np.array(
        [host.nodes[n].node.schedulable(cordoned) for n in node_names],
        dtype=bool,
    ) if node_names else np.zeros(0, bool)
    canary = host.canary_pods
    if canary and node_names and "pods" in spec.names:
        pods_ix = spec.index("pods")
        for ni, n in enumerate(node_names):
            cap = canary.get(n)
            if cap is not None:
                node_idle[ni, pods_ix] = min(
                    node_idle[ni, pods_ix], float(cap)
                )
    node_labels = _multi_hot(
        [
            [lab_idx[f"{k}={v}"] for k, v in host.nodes[n].node.labels.items()]
            for n in node_names
        ],
        N,
        L,
    )
    node_taints = _multi_hot(
        [[tnt_idx[t] for t in host.nodes[n].node.taints] for n in node_names], N, V
    )
    node_ports = _multi_hot(
        [[prt_idx[p] for p in node_resident_ports[n]] for n in node_names], N, P
    )
    node_pressure = np.array(
        [
            [
                host.nodes[n].node.memory_pressure,
                host.nodes[n].node.disk_pressure,
                host.nodes[n].node.pid_pressure,
            ]
            for n in node_names
        ],
        dtype=np.float32,
    ) if node_names else np.zeros((0, 3), np.float32)

    # -- topology domains (only when topo-scoped terms exist) -----------
    if K2r:
        TKr = len(topo_key_list)
        TKp = bucket(TKr, minimum=1)
        K2 = bucket(K2r, minimum=8)
        dom_idx: dict[str, int] = {}
        fallback_count = 0
        nkd = np.zeros((N, TKp), dtype=np.int32)
        for ti, tk in enumerate(topo_key_list):
            for ni, nname in enumerate(node_names):
                val = host.nodes[nname].node.labels.get(tk)
                if val is None:
                    fallback_count += 1
                    nkd[ni, ti] = -fallback_count
                else:
                    key = f"{tk}={val}"
                    if key not in dom_idx:
                        dom_idx[key] = len(dom_idx)
                    nkd[ni, ti] = dom_idx[key]
        Dm = len(dom_idx)
        nkd = np.where(nkd < 0, Dm + (-nkd - 1), nkd)
        D_real = Dm + fallback_count
        Dp = bucket(D_real + 1, minimum=8)
        dead = Dp - 1
        nkd[:, TKr:] = dead
        node_key_domain = nkd
        topo_term_key = pad_rows(np.array(
            [tk_idx[t[0]] for t in topo_term_list], dtype=np.int32
        ), K2)
        topo_term_label = pad_rows(np.array(
            [pl_idx[t[1]] for t in topo_term_list], dtype=np.int32
        ), K2)
        task_aff_topo = _multi_hot(aff_topo_rows, T, K2)
        task_anti_topo = _multi_hot(anti_topo_rows, T, K2)
        task_podpref_topo = np.zeros(
            (T, K2 if podpref_topo_entries else 0), np.float32
        )
        for row, term, w in podpref_topo_entries:
            task_podpref_topo[row, term] = w
        domain_mask_np = np.zeros(Dp, bool)
        domain_mask_np[:D_real] = True
    else:  # static zero-width: kernels skip all domain math
        TKp, K2, Dp = 0, 0, 0
        node_key_domain = np.zeros((N, 0), np.int32)
        topo_term_key = np.zeros(0, np.int32)
        topo_term_label = np.zeros(0, np.int32)
        task_aff_topo = np.zeros((T, 0), np.float32)
        task_anti_topo = np.zeros((T, 0), np.float32)
        task_podpref_topo = np.zeros((T, 0), np.float32)
        domain_mask_np = np.zeros(0, bool)

    # -- volume feasibility (claims → pins / allowed-label groups) ------
    INFEASIBLE = -2  # conflicting/unknown claims: no node can satisfy
    group_names = sorted(set(constrained_claims))
    g_idx = {c: i for i, c in enumerate(group_names)}
    G = bucket(len(group_names), minimum=8) if group_names else 0
    task_vol_node = np.full(T, NONE_IDX, np.int32)
    task_vol_groups = np.zeros((T, G), np.float32)
    vol_group_sel = np.zeros((G, L), np.float32)
    for cname in group_names:
        sc = host.storage_classes[host.claims[cname].storage_class]
        for lab in sc.allowed_node_labels:
            vol_group_sel[g_idx[cname], lab_idx[lab]] = 1.0
    for ti, pod in enumerate(tasks):
        if not pod.claims:
            continue
        for cname in pod.claims:
            claim = host.claims.get(cname)
            if claim is None:
                task_vol_node[ti] = INFEASIBLE  # unknown PVC
                continue
            if claim.bound_node is not None:
                pin = node_idx.get(claim.bound_node, INFEASIBLE)
                if task_vol_node[ti] == NONE_IDX:
                    task_vol_node[ti] = pin
                elif task_vol_node[ti] != pin:
                    task_vol_node[ti] = INFEASIBLE  # two different pins
            elif cname in g_idx:
                task_vol_groups[ti, g_idx[cname]] = 1.0
            elif (
                claim.storage_class
                and claim.storage_class not in host.storage_classes
            ):
                task_vol_node[ti] = INFEASIBLE  # unknown StorageClass

    queue_weight = np.array(
        [host.queues[n].weight for n in queue_names], dtype=np.float32
    )

    # -- namespaces: declared weights + implicit weight-1 for the rest --
    ns_names = sorted(
        set(host.namespaces) | {p.namespace for p in tasks}
    ) or ["default"]
    ns_idx = {n: i for i, n in enumerate(ns_names)}
    S = len(ns_names)
    Sp = bucket(S)
    task_ns = np.array(
        [ns_idx[p.namespace] for p in tasks], dtype=np.int32
    ) if tasks else np.zeros(0, np.int32)
    ns_weight = np.array(
        [
            host.namespaces[n].weight if n in host.namespaces else 1.0
            for n in ns_names
        ],
        dtype=np.float32,
    )

    # -- PDBs: EVERY matching budget per pod --------------------------
    pdb_names = sorted(host.pdbs)
    Bp = bucket(len(pdb_names)) if pdb_names else 0
    task_pdbs = np.zeros((T, Bp), np.float32)
    if pdb_names:
        pdb_objs = [host.pdbs[n] for n in pdb_names]
        for ti, pod in enumerate(tasks):
            if not pod.labels:
                continue
            for bi, pdb in enumerate(pdb_objs):
                if pdb.selector and pdb.matches(pod):
                    task_pdbs[ti, bi] = 1.0
    pdb_min = np.array(
        [
            host.pdbs[n].effective_floor(
                int(task_pdbs[:, bi].sum())
            )
            for bi, n in enumerate(pdb_names)
        ],
        dtype=np.int32,
    ) if pdb_names else np.zeros(0, np.int32)

    arrays: dict[str, np.ndarray] = {
        "task_req": pad_rows(task_req, Tp),
        "task_state": pad_rows(task_state, Tp),
        "task_job": pad_rows(np.array(task_job, np.int32), Tp, NONE_IDX),
        "task_node": pad_rows(task_node, Tp, NONE_IDX),
        "task_prio": pad_rows(task_prio, Tp),
        "task_order": pad_rows(task_order, Tp),
        "task_mask": pad_rows(np.ones(T, bool), Tp, False),
        "task_sel": pad_rows(task_sel, Tp),
        "task_pref": pad_rows(task_pref, Tp),
        "task_tol": pad_rows(task_tol, Tp),
        "task_ports": pad_rows(task_ports, Tp),
        "task_critical": pad_rows(task_critical, Tp, False),
        "task_podlabels": pad_rows(task_podlabels, Tp),
        "task_aff": pad_rows(task_aff, Tp),
        "task_anti": pad_rows(task_anti, Tp),
        "task_podpref": pad_rows(task_podpref, Tp),
        "task_aff_topo": pad_rows(task_aff_topo, Tp),
        "task_anti_topo": pad_rows(task_anti_topo, Tp),
        "task_podpref_topo": pad_rows(task_podpref_topo, Tp),
        "topo_term_key": topo_term_key,
        "topo_term_label": topo_term_label,
        "node_key_domain": pad_rows(node_key_domain, Np, Dp - 1 if Dp else 0),
        "domain_mask": domain_mask_np,
        "task_vol_node": pad_rows(task_vol_node, Tp, NONE_IDX),
        "task_vol_groups": pad_rows(task_vol_groups, Tp),
        "vol_group_sel": vol_group_sel,
        "job_queue": pad_rows(job_queue, Jp, NONE_IDX),
        "job_min": pad_rows(job_min, Jp),
        "job_prio": pad_rows(job_prio, Jp),
        "job_order": pad_rows(job_order, Jp),
        "job_mask": pad_rows(np.ones(J, bool), Jp, False),
        "node_cap": pad_rows(node_cap, Np),
        "node_idle": pad_rows(node_idle, Np),
        "node_releasing": pad_rows(node_rel, Np),
        "node_labels": pad_rows(node_labels, Np),
        "node_taints": pad_rows(node_taints, Np),
        "node_ports": pad_rows(node_ports, Np),
        "node_ready": pad_rows(node_ready_np, Np, False),
        "node_pressure": pad_rows(node_pressure, Np),
        "node_mask": pad_rows(np.ones(N, bool), Np, False),
        "queue_weight": pad_rows(queue_weight, Qp),
        "queue_mask": pad_rows(np.ones(Q, bool), Qp, False),
        "task_ns": pad_rows(task_ns, Tp, NONE_IDX),
        "ns_weight": pad_rows(ns_weight, Sp),
        "ns_mask": pad_rows(np.ones(S, bool), Sp, False),
        "task_pdbs": pad_rows(task_pdbs, Tp),
        "pdb_min": pad_rows(pdb_min, Bp) if Bp else pdb_min,
        "cluster_total": node_cap.sum(axis=0).astype(np.float32)
        if len(node_names)
        else np.zeros(spec.num, np.float32),
        "eps": spec.eps.astype(np.float32),
        "besteffort_eps": spec.besteffort_eps.astype(np.float32),
    }
    meta = SnapshotMeta(
        spec=spec,
        task_uids=tuple(p.uid for p in tasks),
        task_pods=tuple(tasks),
        job_names=tuple(job_names),
        node_names=tuple(node_names),
        queue_names=tuple(queue_names),
        label_vocab=label_vocab,
        taint_vocab=taint_vocab,
        port_vocab=port_vocab,
        podlabel_vocab=podlabel_vocab,
    )
    return arrays, meta


# -- the active-set projection ------------------------------------------

@functools.cache
def snapshot_dim_axes() -> dict[str, dict[int, str]]:
    """field → {axis: "T" | "J" | "N"} for the primary dims, derived
    mechanically (≙ kube_batch_tpu cache/packer.py · snapshot_dim_axes):
    one tiny world packed twice, the second time with a forced bucket per
    dim, and the axes that moved read off.  Built once per process; the
    probe world takes uids from a counter of its own, so building it
    shifts no later world's uids or creation order."""
    from kube_batch_tpu_torch.cache import cluster
    from kube_batch_tpu_torch.models.workloads import config1_gang_small

    saved = cluster._uid_counter
    cluster._uid_counter = itertools.count()
    try:
        cache, _sim = config1_gang_small()
    finally:
        cluster._uid_counter = saved
    host = cache.snapshot()
    probes = {"T": 1024, "J": 256, "N": 512}  # unique, above any tiny bucket
    a, _ = pack_snapshot_loop(host)
    b, _ = pack_snapshot_loop(host, min_buckets=probes)
    rev = {bucket(v): k for k, v in probes.items()}
    axes: dict[str, dict[int, str]] = {}
    for name in FIELDS:
        for i, (da, db) in enumerate(zip(a[name].shape, b[name].shape)):
            if da != db:
                axes.setdefault(name, {})[i] = rev[db]
    return axes


def gather_tasks(snap: SnapshotTensors, idx: torch.Tensor,
                 valid: torch.Tensor) -> SnapshotTensors:
    """The snapshot of the task rows `idx` (int64[P] on the snapshot's
    device): every task-axis field gathered (`index_select`), `task_mask`
    ANDed with `valid` (bool[P]: the fill rows of a padded index are no
    task), the job- and node-axis fields shared with `snap` (≙
    kube_batch_tpu cache/packer.py · gather_tasks).  A fresh snapshot:
    nothing kept beside `snap` comes with it (its segment indexes are
    built over T rows), except the rows `idx` of its kept affinity task
    words, which are computed row by row.  Valid, like `snap`, until the
    next pack."""
    axes = snapshot_dim_axes()
    fields = {}
    for name in FIELDS:
        x = getattr(snap, name)
        for i, dim in axes.get(name, {}).items():
            if dim == "T":
                x = x.index_select(i, idx)
        fields[name] = x
    fields["task_mask"] = fields["task_mask"] & valid
    sub = SnapshotTensors(**fields)
    words = snap.affinity_task_words()
    if words is not None:
        sub.keep_affinity_task_words(words.index_select(0, idx))
    return sub
