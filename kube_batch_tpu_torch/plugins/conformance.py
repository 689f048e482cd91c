"""Conformance plugin: never evict cluster-critical pods.

Reference counterpart: plugins/conformance/conformance.go — a
PreemptableFn/ReclaimableFn over the packed `task_critical` bit.  Both
extension points belong to the preempt and reclaim actions, which are
not ported yet (ROADMAP A6); in the allocate/backfill cycle of this
package the plugin registers nothing, exactly as its reference twin
contributes nothing to those actions.
"""

from __future__ import annotations

from kube_batch_tpu_torch.framework.plugin import Plugin, register_plugin


@register_plugin
class ConformancePlugin(Plugin):
    name = "conformance"
