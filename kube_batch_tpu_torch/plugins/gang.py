"""Gang plugin: all-or-nothing minMember scheduling.

Reference counterpart: plugins/gang/gang.go; the port of
kube_batch_tpu/plugins/gang.py.
* JobValidFn: enough tasks could still become ready (ValidTaskNum ≥ min);
* JobReadyFn: binds dispatch only once ReadyTaskNum ≥ MinAvailable;
* JobOrderFn: jobs still fighting for their gang come first;
* OnSessionClose: "job cannot reach minMember" events and conditions.
The PreemptableFn comes with the preempt action (ROADMAP A6).
"""

from __future__ import annotations

from kube_batch_tpu_torch.api.snapshot import job_ready_counts, job_valid_counts
from kube_batch_tpu_torch.api.types import PodGroupCondition
from kube_batch_tpu_torch.framework.plugin import Plugin, register_plugin


def job_valid(snap, state):
    return job_valid_counts(snap, state.task_state) >= snap.job_min


def job_ready(snap, state):
    return job_ready_counts(snap, state.task_state) >= snap.job_min


@register_plugin
class GangPlugin(Plugin):
    name = "gang"

    def register(self, policy, tier: int) -> None:
        if self.enabled_for("jobValid"):
            policy.add_job_valid_fn(job_valid)
        if self.enabled_for("jobReady"):
            policy.add_job_ready_fn(job_ready)
        if self.enabled_for("jobOrder"):
            # unready gangs first (key 0.0), satisfied gangs later (1.0)
            policy.add_job_order_fn(
                tier, lambda snap, state: job_ready(snap, state).float()
            )

    def on_session_close(self, ssn) -> None:
        """Unschedulable events + PodGroup conditions for unready gangs
        (≙ gang.go · OnSessionClose), counted on the packed snapshot."""
        ready_counts = ssn.snapshot_ready_counts()
        job_min = ssn.host_fields["job_min"]
        name_to_idx = {n: i for i, n in enumerate(ssn.meta.job_names)}
        for name in ssn.unready_jobs():
            j = name_to_idx.get(name)
            if j is None:
                continue
            msg = (
                f"gang unschedulable: job {name} has {int(ready_counts[j])} "
                f"ready, needs minMember {int(job_min[j])}"
            )
            ssn.cache.record_event("PodGroup", name, "Unschedulable", msg)
            ssn.cache.add_job_condition(
                name,
                PodGroupCondition(
                    type="Unschedulable", reason="NotEnoughResources",
                    message=msg,
                ),
            )
