"""Priority plugin: order tasks/jobs by priority value.

Reference counterpart: plugins/priority/priority.go — TaskOrderFn by pod
spec.priority, JobOrderFn by PodGroup priority-class value.  Keys are
negated priorities (order keys sort ascending).
"""

from __future__ import annotations

from kube_batch_tpu_torch.framework.plugin import Plugin, register_plugin


@register_plugin
class PriorityPlugin(Plugin):
    name = "priority"

    def register(self, policy, tier: int) -> None:
        if self.enabled_for("taskOrder"):
            policy.add_task_order_fn(tier, lambda snap, state: -snap.task_prio)
        if self.enabled_for("jobOrder"):
            policy.add_job_order_fn(tier, lambda snap, state: -snap.job_prio)
