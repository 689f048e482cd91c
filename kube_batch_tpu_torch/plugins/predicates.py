"""Predicates plugin: node feasibility.

Reference counterpart: plugins/predicates/predicates.go — the upstream
k8s predicates (MatchNodeSelector, PodFitsHostPorts,
PodToleratesNodeTaints, node condition/pressure checks, volume binding)
per (task, node) pair; the port of kube_batch_tpu/plugins/predicates.py.

The static predicates become one bool[T, N] mask, computed by kernel K1
(kernels/predicate_mask.py).  Resource fit is deliberately NOT here,
exactly like the reference: actions check `Resreq ⊑ Idle` themselves.

Inter-pod affinity is a DYNAMIC predicate — placements earlier in the
same cycle change feasibility — re-evaluated every auction round (and,
as a row, every preemption step): kernel K11 (kernels/resident.py)
builds the resident label tables per node and per topology domain,
kernel K10 (kernels/affinity.py) the predicate against them: as words
for the auction rounds (kernel K2 tests the cells itself;
`pod_affinity_words`, the task words kept for the snapshot's life), as
the bool[T, N] mask for the cycle's failure tallies, or as the one
task's bool[N] row for a preemption step.  The per-task serialize sets
stay torch: they are [T] reductions over snapshot-static columns.  When no task of the
snapshot carries a required affinity or anti-affinity term, the
predicate is all-true, the serialize sets are empty and neither kernel
launches (`affinity_active`).

Arguments (≙ predicates.go's `predicate.*Enable` toggles):
    predicate.NodeSelectorEnable    (default true)
    predicate.TaintsEnable          (default true)
    predicate.HostPortsEnable       (default true)
    predicate.NodeReadyEnable       (default true)
    predicate.PodAffinityEnable     (default true)
    predicate.MemoryPressureEnable  (default false)
    predicate.DiskPressureEnable    (default false)
    predicate.PidPressureEnable     (default false)
    predicate.VolumeBindingEnable   (default true)
"""

from __future__ import annotations

import torch

from kube_batch_tpu_torch.framework.plugin import Plugin, register_plugin
from kube_batch_tpu_torch.kernels import affinity as _k10
from kube_batch_tpu_torch.kernels import resident as _k11
from kube_batch_tpu_torch.kernels.predicate_mask import (
    PredicateFlags,
    predicate_mask,
)

AFFINITY_AUX = "predicates/affinity_active"


@register_plugin
class PredicatesPlugin(Plugin):
    name = "predicates"

    def register(self, policy, tier: int) -> None:  # noqa: ARG002
        if not self.enabled_for("predicate"):
            return
        flags = PredicateFlags(
            selector=self.args.get_bool("predicate.NodeSelectorEnable", True),
            taints=self.args.get_bool("predicate.TaintsEnable", True),
            ports=self.args.get_bool("predicate.HostPortsEnable", True),
            ready=self.args.get_bool("predicate.NodeReadyEnable", True),
            pressure=(
                self.args.get_bool("predicate.MemoryPressureEnable", False),
                self.args.get_bool("predicate.DiskPressureEnable", False),
                self.args.get_bool("predicate.PidPressureEnable", False),
            ),
            volume=self.args.get_bool("predicate.VolumeBindingEnable", True),
        )
        policy.add_predicate_fn(lambda snap: predicate_mask(snap, flags))

        if self.args.get_bool("predicate.PodAffinityEnable", True):
            policy.add_cycle_setup_fn(AFFINITY_AUX, _affinity_terms_present)
            policy.add_dynamic_predicate_fn(
                pod_affinity_predicate, row_fn=pod_affinity_row,
                words_fn=pod_affinity_words,
            )
            policy.add_node_serialize_fn(anti_serialize_mask)
            policy.add_global_serialize_fn(bootstrap_mask)
            policy.add_domain_serialize_fn(topo_anti_participants)


def _affinity_terms_present(snap) -> bool:
    """Snapshot-static: does any task carry a required affinity or
    anti-affinity term (node- or topology-scoped)?  Without one, every
    term of the affinity predicate is vacuous: need = 0, anti_hit = 0,
    and no resident carries an anti term, so sym_hit = 0."""
    return bool(
        (snap.task_aff != 0).any() or (snap.task_anti != 0).any()
        or (snap.task_aff_topo != 0).any() or (snap.task_anti_topo != 0).any()
    )


def affinity_active(snap, state) -> bool:
    flag = state.aux.get(AFFINITY_AUX)
    if flag is None:
        flag = state.aux[AFFINITY_AUX] = _affinity_terms_present(snap)
    return flag


def resident_tables(snap, state, include_releasing: bool = False):
    """(Hb, Ab, Hd, Ad) of the state's residents, kernel K11
    (kernels/resident.py): bool[N, K] label / anti-term presence per
    node and, when the snapshot has topology-scoped terms, bool[D, K]
    per topology domain (None otherwise)."""
    return _k11.resident_tables(
        snap.task_podlabels, snap.task_anti, snap.task_anti_topo,
        state.task_node, state.task_state, snap.task_mask,
        snap.node_key_domain, snap.topo_term_key, snap.topo_term_label,
        snap.num_nodes, snap.domain_mask.shape[0], include_releasing,
    )


def _fields(snap):
    return (snap.task_aff, snap.task_anti, snap.task_podlabels,
            snap.task_aff_topo, snap.task_anti_topo, snap.topo_term_key,
            snap.topo_term_label, snap.node_key_domain)


def _predicate_tables(snap, state, immediate: bool):
    """(Hb, Hb_now, Ab_now, Hd, Hd_now, Ad_now): the future-oriented
    tables, and the anti / symmetry side's, which also see Releasing
    residents in the Idle pass (`immediate`)."""
    Hb, Ab, Hd, Ad = resident_tables(snap, state)
    if not immediate:
        return Hb, Hb, Ab, Hd, Hd, Ad
    Hb_now, Ab_now, Hd_now, Ad_now = resident_tables(snap, state, include_releasing=True)
    return Hb, Hb_now, Ab_now, Hd, Hd_now, Ad_now


def pod_affinity_predicate(snap, state, immediate: bool = False):
    """bool[T, N] inter-pod affinity/anti-affinity feasibility, or None
    when no task carries such a term (≙ kube_batch_tpu
    plugins/predicates.py · pod_affinity_predicate):

    * required affinity: every term names a label some resident of the
      node (domain) carries — with the k8s bootstrap rule (a term no pod
      in the cluster matches is waived for a task carrying the label);
    * anti-affinity: no resident carries any of the task's anti terms;
    * symmetry: no resident's anti term matches the task's own labels.

    `immediate` (the Idle pass) makes the anti/symmetry side also see
    RELEASING residents.  The tables come from kernel K11, the mask from
    kernel K10 (kernels/affinity.py)."""
    if not affinity_active(snap, state):
        return None
    return _k10.affinity_mask(*_fields(snap), *_predicate_tables(snap, state, immediate))


def pod_affinity_words(snap, state, immediate: bool = False):
    """pod_affinity_predicate as `kernels/affinity.py · AffinityWords`, for
    kernel K2 to test in its own tiles: the same tables, the node words
    and thresholds of this state, the task words built at the snapshot's
    first call and kept on it (`SnapshotTensors.affinity_task_words`).
    None when no task carries such a term."""
    if not affinity_active(snap, state):
        return None
    w = _k10.affinity_words(*_fields(snap), *_predicate_tables(snap, state, immediate),
                            snap.affinity_task_words())
    snap.keep_affinity_task_words(w.task_words)
    return w


def pod_affinity_row(snap, state, p):
    """bool[N]: pod_affinity_predicate for ONE task (the preemptor of a
    preemption step; `p` may be a 0-dim device tensor) — O(N·K) instead
    of the [T, N] matrix; future-oriented, since the preemptor pipelines
    onto FutureIdle after its victims leave.  None when no task carries
    an affinity term (≙ kube_batch_tpu plugins/predicates.py ·
    pod_affinity_row).  Kernels K11 and K10."""
    if not affinity_active(snap, state):
        return None
    Hb, Ab, Hd, Ad = resident_tables(snap, state)
    return _k10.affinity_row(*_fields(snap), Hb, Ab, Hd, Ad, p)


def anti_serialize_mask(snap, state):
    """bool[T]: tasks that may land at most ONE per node per round — they
    declare anti terms or carry a label some task's anti term names
    (≙ the serialize_mask of kube_batch_tpu ops/assignment.py ·
    allocate_rounds).  None when no affinity term exists."""
    if not affinity_active(snap, state):
        return None
    anti_union = (snap.task_anti > 0).any(dim=0)
    return (snap.task_anti > 0).any(dim=1) | (
        (snap.task_podlabels > 0) & anti_union[None, :]
    ).any(dim=1)


def bootstrap_mask(snap, state):
    """bool[T]: pending tasks whose required affinity currently relies
    on the bootstrap waiver — at most one is accepted per round
    globally.  None when no affinity term exists."""
    if not affinity_active(snap, state):
        return None
    Hb, _, _, _ = resident_tables(snap, state)
    term_exists = Hb.any(dim=0)
    m = ((snap.task_aff > 0) & ~term_exists[None, :]).any(dim=1)
    if snap.task_aff_topo.shape[1]:
        exists2 = term_exists[snap.topo_term_label.long()]
        m = m | ((snap.task_aff_topo > 0) & ~exists2[None, :]).any(dim=1)
    return m & snap.task_mask


def topo_anti_participants(snap, state):
    """bool[T]: tasks involved in DOMAIN-scoped anti-affinity — at most
    one acceptance per topology domain per round.  None without topo
    anti terms."""
    if not snap.task_anti_topo.shape[1] or not affinity_active(snap, state):
        return None
    used2 = (snap.task_anti_topo > 0).any(dim=0)                # bool[K2]
    K = snap.task_podlabels.shape[1]
    anti_union2 = torch.zeros(K, dtype=torch.bool, device=snap.device)
    anti_union2[snap.topo_term_label.long()[used2]] = True
    return (
        (snap.task_anti_topo > 0).any(dim=1)
        | ((snap.task_podlabels > 0) & anti_union2[None, :]).any(dim=1)
    ) & snap.task_mask
