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
builds the resident label tables per node and per topology domain as
words, both resident sets in one launch, from kernel K10's task words
(built once per snapshot and kept, `task_words`); kernel K10
(kernels/affinity.py) the predicate against them: as words for the
auction rounds (kernel K2 tests the cells itself; `pod_affinity_words`),
as the bool[T, N] mask for the cycle's failure tallies, or as the one
task's row for a preemption step (an operand kernel K5 tests inside
its own launch, `pod_affinity_row`).  An auction round hands
`pod_affinity_words`, `bootstrap_mask` and nodeorder's pod-affinity
score one `RoundResident` (their `resident` argument): the first to
read the tables builds them (`round_words`), the others take that
build; called without one, each builds its own from the state it is
given.  The per-task serialize sets
stay torch: they are [T] reductions over snapshot-static columns.  When
no task of the snapshot carries a required affinity or anti-affinity
term, the predicate is all-true, the serialize sets are empty and
neither kernel launches for it (`affinity_active`).

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
from kube_batch_tpu_torch.kernels.resident import ResidentWords, pack, unpack, words
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


def task_words(snap) -> torch.Tensor:
    """i32[T, NW]: the snapshot's inter-pod affinity task words (kernel
    K10's `affinity_task_words`), built at the first call and kept on it
    (`SnapshotTensors.affinity_task_words`)."""
    w = snap.affinity_task_words()
    if w is None:
        w = _k10.affinity_task_words(snap.task_aff, snap.task_anti, snap.task_podlabels,
                                     snap.task_aff_topo, snap.task_anti_topo)
        snap.keep_affinity_task_words(w)
    return w


def resident_words(snap, state, with_now: bool = False) -> ResidentWords:
    """The state's resident tables as words, kernel K11
    (kernels/resident.py): label / anti-term presence per node and, when
    the snapshot has topology-scoped terms, per topology domain; the
    Releasing-inclusive `_now` set too with `with_now`."""
    return _k11.resident_words(
        task_words(snap), state.task_node, state.task_state, snap.task_mask,
        snap.node_key_domain, snap.topo_term_key, snap.topo_term_label,
        snap.num_nodes, snap.domain_mask.shape[0], snap.task_podlabels.shape[1],
        snap.task_aff_topo.shape[1], with_now,
    )


def round_words(snap, state, immediate: bool, resident) -> ResidentWords:
    """The resident tables of this state: the auction round's (`resident`,
    a `kernels/resident.py · RoundResident`, built here if no consumer
    of the round has built them yet), or a build of our own without one.
    The Idle pass (`immediate`) reads the Releasing-inclusive set."""
    if resident is None:
        return resident_words(snap, state, immediate)
    if immediate and not resident.with_now:
        raise ValueError("the Idle pass needs resident tables built with_now")
    if resident.words is None:
        resident.words = resident_words(snap, state, resident.with_now)
    return resident.words


def _fields(snap):
    return (snap.task_aff, snap.task_anti, snap.task_podlabels,
            snap.task_aff_topo, snap.task_anti_topo, snap.topo_term_key,
            snap.topo_term_label, snap.node_key_domain)


def pod_affinity_predicate(snap, state, immediate: bool = False, resident=None):
    """bool[T, N] inter-pod affinity/anti-affinity feasibility, or None
    when no task carries such a term (≙ kube_batch_tpu
    plugins/predicates.py · pod_affinity_predicate):

    * required affinity: every term names a label some resident of the
      node (domain) carries — with the k8s bootstrap rule (a term no pod
      in the cluster matches is waived for a task carrying the label);
    * anti-affinity: no resident carries any of the task's anti terms;
    * symmetry: no resident's anti term matches the task's own labels.

    `immediate` (the Idle pass) makes the anti/symmetry side also see
    RELEASING residents.  The tables come from kernel K11 (`resident`,
    or a build of this state), the mask from kernel K10
    (kernels/affinity.py)."""
    if not affinity_active(snap, state):
        return None
    return _k10.affinity_mask(*_fields(snap),
                              round_words(snap, state, immediate, resident))


def pod_affinity_words(snap, state, immediate: bool = False, resident=None):
    """pod_affinity_predicate as `kernels/affinity.py · AffinityWords`, for
    kernel K2 to test in its own tiles: the node words and thresholds of
    this state's tables (`resident`, or a build of its own), the task
    words kept on the snapshot (`task_words`).  None when no task
    carries such a term."""
    if not affinity_active(snap, state):
        return None
    return _k10.affinity_words(task_words(snap), snap.topo_term_key, snap.topo_term_label,
                               snap.node_key_domain,
                               round_words(snap, state, immediate, resident))


def pod_affinity_row(snap, state, p):
    """pod_affinity_predicate for ONE task (the preemptor of a
    preemption step; `p` a 0-dim device tensor, or an int), future-
    oriented, since the preemptor pipelines onto FutureIdle after its
    victims leave (≙ kube_batch_tpu plugins/predicates.py ·
    pod_affinity_row), as `kernels/affinity.py · AffinityRow`: this
    state's K11 tables (a build of its own), the snapshot's kept task
    words and p.  Kernel K5 tests it node by node inside its own launch
    (an opening step), kernel K6 at the plan's node (a continuing step);
    `.row()` gives the bool[N] row and `.cell(n)` one cell (kernel K10).
    None when no task carries an affinity term."""
    if not affinity_active(snap, state):
        return None
    if not isinstance(p, torch.Tensor):
        p = torch.tensor(p, dtype=torch.int64, device=snap.device)
    return _k10.AffinityRow(_fields(snap), task_words(snap), resident_words(snap, state), p)


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


def bootstrap_mask(snap, state, resident=None):
    """bool[T]: pending tasks whose required affinity currently relies
    on the bootstrap waiver — at most one is accepted per round
    globally.  None when no affinity term exists.  The term-exists words
    (Hb.any(0)) come from kernel K11 (`resident`, or a build of this
    state) and are tested against the task words' aff and aff_topo
    groups, the latter gathered through topo_term_label."""
    if not affinity_active(snap, state):
        return None
    rw = round_words(snap, state, False, resident)
    tw = task_words(snap)
    KW, K2W = words(rw.K), words(rw.K2)
    exists = rw.term_exists
    m = ((tw[:, :KW] & ~exists) != 0).any(dim=1)
    if rw.K2:
        exists2 = pack(unpack(exists, rw.K)[snap.topo_term_label.long()])
        m = m | ((tw[:, 3 * KW:3 * KW + K2W] & ~exists2) != 0).any(dim=1)
    return m & snap.task_mask


def topo_anti_participants(snap, state):
    """bool[T]: tasks involved in DOMAIN-scoped anti-affinity — at most
    one acceptance per topology domain per round.  None without topo
    anti terms."""
    if not snap.task_anti_topo.shape[1] or not affinity_active(snap, state):
        return None
    used2 = (snap.task_anti_topo > 0).any(dim=0)                # bool[K2]
    K = snap.task_podlabels.shape[1]
    # the labels of the used terms, unused ones sent to a spare column K
    # (a fill by index: a mask index would read a count on the host, an
    # assignment would copy its value from the host)
    anti_union2 = torch.zeros(K + 1, dtype=torch.bool, device=snap.device)
    anti_union2.index_fill_(0, torch.where(used2, snap.topo_term_label.long(), K), True)
    anti_union2 = anti_union2[:K]
    return (
        (snap.task_anti_topo > 0).any(dim=1)
        | ((snap.task_podlabels > 0) & anti_union2[None, :]).any(dim=1)
    ) & snap.task_mask
