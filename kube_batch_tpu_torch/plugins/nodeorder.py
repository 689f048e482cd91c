"""Nodeorder plugin: node scoring for placement quality.

Reference counterpart: plugins/nodeorder/nodeorder.go — NodeOrderFn as a
weighted sum of upstream k8s priorities; the port of
kube_batch_tpu/plugins/nodeorder.py.

* least-requested:  mean over requested dims of idle_after / capacity,
  × 10 — prefer emptier nodes;
* balanced-allocation:  10 − |cpu_frac − mem_frac| · 10 with
  frac = (used + req) / capacity;
* node-affinity:  Σ weights of preferred labels the node carries,
  normalized to 0–10;
* pod-affinity score:  weighted soft co-location terms matched by the
  node's (or its domain's) residents, normalized to 0–10.

The first two read the live `node_future` and are computed inside the
propose kernel (K2); their formulas live in kernels/propose.py and
kernels/csrc/propose.cu.  The other two are additive terms, returned as
None when they are exactly zero for the snapshot (no task states such a
preference), so the kernel skips them: node affinity a [T, N] product
made once a cycle, the pod-affinity score a table of one row per class
of preference rows (kernel K13, each round), read by K2 at each task's
class.

Arguments (≙ nodeorder.go's Arguments):
    nodeorder.leastrequested.weight     (default 1)
    nodeorder.balancedresource.weight   (default 1)
    nodeorder.nodeaffinity.weight       (default 1)
    nodeorder.podaffinity.weight        (default 1)
    nodeorder.balancedresource.dim0/dim1 (default 0, 1)
    nodeorder.quantum                   (score grid; default 0.5 when a
                                         state-dependent score is on)
"""

from __future__ import annotations

import torch

from kube_batch_tpu_torch.framework.plugin import Plugin, register_plugin
from kube_batch_tpu_torch.framework.policy import CLASS_TERM
from kube_batch_tpu_torch.kernels import podaff_score as _k13
from kube_batch_tpu_torch.kernels.propose import ClassTerm

MAX_SCORE = 10.0
NODE_AFFINITY_AUX = "nodeorder/node_affinity"
PODPREF_AUX = "nodeorder/podpref_classes"


def node_affinity_term(snap):
    """f32[T, N] node-affinity score (unweighted), or None when no task
    has a preferred node label."""
    if not bool((snap.task_pref != 0).any()):
        return None
    raw = snap.task_pref @ snap.node_labels.T
    denom = torch.clamp(snap.task_pref.sum(dim=1), min=1e-9)
    return raw / denom[:, None] * MAX_SCORE


def _podpref_present(snap) -> bool:
    return bool((snap.task_podpref != 0).any()) or bool(
        snap.task_podpref_topo.shape[1]
        and (snap.task_podpref_topo != 0).any()
    )


def podpref_classes(snap):
    """The snapshot's classes of preference rows [task_podpref |
    task_podpref_topo] (`kernels/podaff_score.py · PrefClasses`), or None
    when no task states a soft pod-affinity term: the plugin's cycle
    setup, outside any round (it reads the number of classes)."""
    if not _podpref_present(snap):
        return None
    return _k13.pref_classes(snap.task_podpref, snap.task_podpref_topo, snap.num_nodes)


def pod_affinity_score(snap, state, weight: float = 1.0, resident=None):
    """Preferred co-location score (≙ InterPodAffinityPriority) times
    `weight`, as a `ClassTerm`: kernel K13's table f32[C, N] of this
    state's resident words, one row per class of preference rows, and
    each task's class; or None when no task states a soft pod-affinity
    term.  The classes come from the cycle's setup (`podpref_classes`,
    built here when the state has none); the words from kernel K11
    (`resident`, the auction round's `RoundResident`, or a build of this
    state).  The table is the classes' one buffer, rewritten by the next
    call."""
    if PODPREF_AUX in state.aux:
        classes = state.aux[PODPREF_AUX]
    else:
        classes = state.aux[PODPREF_AUX] = podpref_classes(snap)
    if classes is None:
        return None
    from kube_batch_tpu_torch.plugins.predicates import round_words

    rw = round_words(snap, state, False, resident)
    table = _k13.podaff_score(classes, rw.Hb, rw.Hd, snap.node_key_domain,
                         snap.topo_term_key, snap.topo_term_label, weight)
    return ClassTerm(table, classes.cls)


@register_plugin
class NodeOrderPlugin(Plugin):
    name = "nodeorder"

    def register(self, policy, tier: int) -> None:  # noqa: ARG002
        if not self.enabled_for("nodeOrder"):
            return
        w_least = self.args.get_float("nodeorder.leastrequested.weight", 1.0)
        w_bal = self.args.get_float("nodeorder.balancedresource.weight", 1.0)
        w_aff = self.args.get_float("nodeorder.nodeaffinity.weight", 1.0)
        w_podaff = self.args.get_float("nodeorder.podaffinity.weight", 1.0)
        d0 = self.args.get_int("nodeorder.balancedresource.dim0", 0)
        d1 = self.args.get_int("nodeorder.balancedresource.dim1", 1)

        if w_least:
            policy.add_node_order_fn(w_least, None, kind="least_requested")
        if w_bal:
            policy.add_node_order_fn(w_bal, None, kind="balanced")
            policy.balanced_dims = (d0, d1)
        if w_aff:
            policy.add_cycle_setup_fn(NODE_AFFINITY_AUX, node_affinity_term)

            def node_affinity(snap, state, resident=None):  # noqa: ARG001
                if NODE_AFFINITY_AUX in state.aux:
                    return state.aux[NODE_AFFINITY_AUX]
                return node_affinity_term(snap)

            policy.add_node_order_fn(w_aff, node_affinity, state_dependent=False)
        if w_podaff:
            policy.add_cycle_setup_fn(PODPREF_AUX, podpref_classes)
            policy.add_node_order_fn(w_podaff, pod_affinity_score, kind=CLASS_TERM)
        quantum = self.args.get_float("nodeorder.quantum", 0.0)
        if quantum > 0.0:
            policy.score_quantum = quantum
