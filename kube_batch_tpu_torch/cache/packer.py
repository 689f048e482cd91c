"""Snapshot packer: HostSnapshot → padded numpy fields (+ decode metadata).

This is the host-to-device boundary — the analog of the reference handing
the freshly copied ClusterInfo to OpenSession (framework/framework.go ·
OpenSession), except that "handing over" means building dense padded
arrays once per cycle and moving them to the device in one call
(`api.snapshot.from_numpy`).

Orderings are stable (sorted by name/creation), so identical cluster
states produce identical tensors, and bucketed padding keeps the set of
distinct shapes small (api.snapshot.bucket).

Only the loop form of `kube_batch_tpu.cache.packer` is ported in this
slice; its output is bit-identical to the reference package's
`pack_snapshot_host` (pinned by tests/test_torch_pack.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kube_batch_tpu_torch.api.resource import ResourceSpec
from kube_batch_tpu_torch.api.snapshot import NONE_IDX, bucket, pad_rows
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
