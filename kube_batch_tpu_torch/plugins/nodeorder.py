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
kernels/csrc/propose.cu.  The other two are additive [T, N] terms,
returned as None when they are exactly zero for the snapshot (no task
states such a preference), so the kernel skips them.

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

MAX_SCORE = 10.0
NODE_AFFINITY_AUX = "nodeorder/node_affinity"
PODPREF_AUX = "nodeorder/podpref_active"


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


def pod_affinity_score(snap, state, resident=None):
    """f32[T, N] preferred co-location score (≙ InterPodAffinityPriority),
    or None when no task states a soft pod-affinity term.  The resident
    tables come from kernel K11 (`resident`, the auction round's
    `RoundResident`, or a build of this state), unpacked to float; the
    weighted [T, K] @ [K, N] products stay torch.matmul in float32 (TF32
    is off, kube_batch_tpu_torch.device), as the reference leaves them to
    XLA."""
    active = state.aux.get(PODPREF_AUX)
    if active is None:
        active = state.aux[PODPREF_AUX] = _podpref_present(snap)
    if not active:
        return None
    from kube_batch_tpu_torch.kernels.affinity import present_table
    from kube_batch_tpu_torch.plugins.predicates import round_words

    Hb, _, Hd, _ = round_words(snap, state, False, resident).tables()
    raw = snap.task_podpref @ Hb.float().T
    total_w = snap.task_podpref.sum(dim=1)
    if snap.task_podpref_topo.shape[1]:
        present = present_table(snap.node_key_domain, snap.topo_term_key,
                                snap.topo_term_label, Hd)
        raw = raw + snap.task_podpref_topo @ present.T
        total_w = total_w + snap.task_podpref_topo.sum(dim=1)
    denom = torch.clamp(total_w, min=1e-9)
    return raw / denom[:, None] * MAX_SCORE


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
            policy.add_node_order_fn(w_podaff, pod_affinity_score)
        quantum = self.args.get_float("nodeorder.quantum", 0.0)
        if quantum > 0.0:
            policy.score_quantum = quantum
