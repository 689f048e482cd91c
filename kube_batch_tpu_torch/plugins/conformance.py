"""Conformance plugin: never evict cluster-critical pods.

Reference counterpart: plugins/conformance/conformance.go — a
PreemptableFn/ReclaimableFn over the packed `task_critical` bit (pods in
kube-system or of the system-cluster-critical / system-node-critical
priority classes); the port of kube_batch_tpu/plugins/conformance.py.
"""

from __future__ import annotations

from kube_batch_tpu_torch.framework.plugin import Plugin, register_plugin


def not_critical(snap, state, preemptor):  # noqa: ARG001
    return ~snap.task_critical


@register_plugin
class ConformancePlugin(Plugin):
    name = "conformance"

    def register(self, policy, tier: int) -> None:
        if self.enabled_for("preemptable"):
            policy.add_preemptable_fn(tier, not_critical)
        if self.enabled_for("reclaimable"):
            policy.add_reclaimable_fn(tier, not_critical)
