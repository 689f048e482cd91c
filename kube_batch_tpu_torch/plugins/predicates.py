"""Predicates plugin: node feasibility.

Reference counterpart: plugins/predicates/predicates.go — the upstream
k8s predicates (MatchNodeSelector, PodFitsHostPorts,
PodToleratesNodeTaints, node condition/pressure checks, volume binding)
per (task, node) pair; the port of kube_batch_tpu/plugins/predicates.py.

The static predicates become one bool[T, N] mask, computed by kernel K1
(kernels/predicate_mask.py).  Resource fit is deliberately NOT here,
exactly like the reference: actions check `Resreq ⊑ Idle` themselves.

Inter-pod affinity is a DYNAMIC predicate — placements earlier in the
same cycle change feasibility — re-evaluated every auction round in plain
torch: segment sums of resident labels into [N, K] / [D, K] tables, then
[T, K] @ [K, N] products (no TF32; the operands are 0/1).  When no task
of the snapshot carries a required affinity or anti-affinity term, the
predicate is all-true, the serialize sets are empty and nothing is
evaluated (`affinity_active`).

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

from kube_batch_tpu_torch.api.snapshot import (
    allocated_mask,
    segment_sum,
    status_is,
)
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.framework.plugin import Plugin, register_plugin
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
                pod_affinity_predicate, row_fn=pod_affinity_row
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


def _resident_mask(snap, state, include_releasing: bool):
    placed = (state.task_node >= 0) & snap.task_mask
    held = (
        allocated_mask(state.task_state)
        | status_is(state.task_state, TaskStatus.PIPELINED)
    ) & placed
    if include_releasing:
        held = held | (status_is(state.task_state, TaskStatus.RELEASING) & placed)
    return held


def resident_podlabels(snap, state, include_releasing: bool = False):
    """(Hb, Ab): bool[N, K] label / anti-term presence among each node's
    residents (allocated statuses or pipelined with a node; plus
    RELEASING ones when `include_releasing`)."""
    held = _resident_mask(snap, state, include_releasing)
    seg = torch.where(held, state.task_node, snap.num_nodes)
    w = held.float()[:, None]
    Hb = segment_sum(snap.task_podlabels * w, seg, snap.num_nodes) > 0
    Ab = segment_sum(snap.task_anti * w, seg, snap.num_nodes) > 0
    return Hb, Ab


def resident_domain_labels(snap, state, include_releasing: bool = False):
    """(Hd, Ad): bool[D, K] label / anti-term-label presence among each
    topology DOMAIN's residents (domain ids are disjoint across keys)."""
    TK = snap.node_key_domain.shape[1]
    D = snap.domain_mask.shape[0]
    K = snap.task_podlabels.shape[1]
    held = _resident_mask(snap, state, include_releasing)
    w = held.float()[:, None]
    node_of = torch.clamp(state.task_node, 0, snap.num_nodes - 1).long()
    onehot_lab = torch.nn.functional.one_hot(
        snap.topo_term_label.long(), K
    ).float()                                                   # [K2, K]
    Hd = torch.zeros((D, K), dtype=torch.float32, device=snap.device)
    Ad = torch.zeros((D, K), dtype=torch.float32, device=snap.device)
    for tk in range(TK):
        seg = torch.where(held, snap.node_key_domain[node_of, tk], D)
        Hd = Hd + segment_sum(snap.task_podlabels * w, seg, D)
        anti_this_key = snap.task_anti_topo * (snap.topo_term_key == tk).float()[None, :]
        anti_lab = anti_this_key @ onehot_lab                   # [T, K]
        Ad = Ad + segment_sum(anti_lab * w, seg, D)
    return Hd > 0, Ad > 0


def _present(snap, Hd):
    """f32[N, K2]: is term k2's label present in node n's domain."""
    A = snap.node_key_domain[:, snap.topo_term_key.long()].long()   # [N, K2]
    return Hd[A, snap.topo_term_label.long()[None, :]].float()


def _topo_feasibility(snap, Hb, Hd, Ad_now, Hd_now):
    """(aff_ok, anti_sym_ok): bool[T, N] for the topology-scoped terms."""
    present = _present(snap, Hd)
    need = snap.task_aff_topo.sum(dim=1, keepdim=True)
    have = snap.task_aff_topo @ present.T                       # [T, N]
    label = snap.topo_term_label.long()
    exists = Hb.any(dim=0)[label]                               # bool[K2]
    own_at_term = snap.task_podlabels[:, label]                 # [T, K2]
    bootstrap = (
        snap.task_aff_topo * own_at_term * (~exists).float()[None, :]
    ).sum(dim=1, keepdim=True)
    aff_ok = have + bootstrap >= need

    anti_hit = snap.task_anti_topo @ _present(snap, Hd_now).T   # [T, N]
    sym_hit = torch.zeros_like(anti_hit)
    for tk in range(snap.node_key_domain.shape[1]):
        Ad_n = Ad_now[snap.node_key_domain[:, tk].long()].float()   # [N, K]
        sym_hit = sym_hit + snap.task_podlabels @ Ad_n.T
    return aff_ok, (anti_hit <= 0.5) & (sym_hit <= 0.5)


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
    RELEASING residents."""
    if not affinity_active(snap, state):
        return None
    Hb, Ab = resident_podlabels(snap, state)
    if immediate:
        Hb_anti, Ab_anti = resident_podlabels(snap, state, include_releasing=True)
    else:
        Hb_anti, Ab_anti = Hb, Ab
    Hf = Hb.float()
    need = snap.task_aff.sum(dim=1, keepdim=True)
    have = snap.task_aff @ Hf.T
    term_exists = Hb.any(dim=0)
    bootstrap = (
        snap.task_aff * (snap.task_podlabels > 0).float() * (~term_exists).float()[None, :]
    ).sum(dim=1, keepdim=True)
    aff_ok = have + bootstrap >= need
    anti_hit = snap.task_anti @ Hb_anti.float().T
    sym_hit = snap.task_podlabels @ Ab_anti.float().T
    ok = aff_ok & (anti_hit <= 0.5) & (sym_hit <= 0.5)
    if snap.task_aff_topo.shape[1]:
        Hd, Ad = resident_domain_labels(snap, state)
        if immediate:
            Hd_now, Ad_now = resident_domain_labels(
                snap, state, include_releasing=True
            )
        else:
            Hd_now, Ad_now = Hd, Ad
        topo_aff_ok, topo_anti_ok = _topo_feasibility(snap, Hb, Hd, Ad_now, Hd_now)
        ok = ok & topo_aff_ok & topo_anti_ok
    return ok


def pod_affinity_row(snap, state, p):
    """bool[N]: pod_affinity_predicate for ONE task (the preemptor of a
    preemption step; `p` may be a 0-dim device tensor) — O(N·K) instead
    of the [T, N] matrix; future-oriented, since the preemptor pipelines
    onto FutureIdle after its victims leave.  None when no task carries
    an affinity term (≙ kube_batch_tpu plugins/predicates.py ·
    pod_affinity_row)."""
    if not affinity_active(snap, state):
        return None
    Hb, Ab = resident_podlabels(snap, state)
    Hf = Hb.float()
    aff = snap.task_aff[p]                                      # f32[K]
    own = snap.task_podlabels[p]
    term_exists = Hb.any(dim=0)
    need = aff.sum()
    have = Hf @ aff                                             # f32[N]
    bootstrap = (aff * (own > 0).float() * (~term_exists).float()).sum()
    aff_ok = have + bootstrap >= need
    anti_hit = Hf @ snap.task_anti[p]
    sym_hit = Ab.float() @ own
    ok = aff_ok & (anti_hit <= 0.5) & (sym_hit <= 0.5)
    if snap.task_aff_topo.shape[1]:
        Hd, Ad = resident_domain_labels(snap, state)
        label = snap.topo_term_label.long()
        A = snap.node_key_domain[:, snap.topo_term_key.long()].long()   # [N, K2]
        present = Hd[A, label[None, :]].float()
        aff2 = snap.task_aff_topo[p]
        have2 = present @ aff2                                  # f32[N]
        exists2 = term_exists[label]
        boot2 = (aff2 * own[label] * (~exists2).float()).sum()
        anti2 = present @ snap.task_anti_topo[p]
        sym2 = torch.zeros(snap.num_nodes, dtype=torch.float32, device=snap.device)
        for tk in range(snap.node_key_domain.shape[1]):
            Ad_n = Ad[snap.node_key_domain[:, tk].long()].float()   # [N, K]
            sym2 = sym2 + Ad_n @ own
        ok = ok & (have2 + boot2 >= aff2.sum()) & (anti2 <= 0.5) & (sym2 <= 0.5)
    return ok


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
    Hb, _ = resident_podlabels(snap, state)
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
