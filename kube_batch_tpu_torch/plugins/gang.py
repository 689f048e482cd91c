"""Gang plugin: all-or-nothing minMember scheduling.

Reference counterpart: plugins/gang/gang.go; the port of
kube_batch_tpu/plugins/gang.py.
* JobValidFn: enough tasks could still become ready (ValidTaskNum ≥ min);
* JobReadyFn: binds dispatch only once ReadyTaskNum ≥ MinAvailable;
* JobPipelinedFn: ready + pipelined members already reach minMember;
* JobOrderFn: jobs still fighting for their gang come first;
* PreemptableFn / ReclaimableFn: veto a victim whose job would fall
  below minMember;
* OnSessionClose: "job cannot reach minMember" events and conditions.
"""

from __future__ import annotations

import torch

from kube_batch_tpu_torch.api.snapshot import (
    count_per_job,
    job_ready_counts,
    job_valid_counts,
    status_is,
)
from kube_batch_tpu_torch.api.types import (
    READY_STATUSES,
    PodGroupCondition,
    TaskStatus,
)
from kube_batch_tpu_torch.framework.plugin import Plugin, register_plugin


def job_valid(snap, state):
    return job_valid_counts(snap, state.task_state) >= snap.job_min


def job_ready(snap, state):
    return job_ready_counts(snap, state.task_state) >= snap.job_min


def job_pipelined(snap, state):
    """Ready + pipelined members suffice: the job may wait on releasing
    resources instead of being preempted for."""
    cnt = count_per_job(
        snap, status_is(state.task_state, *READY_STATUSES, TaskStatus.PIPELINED)
    )
    return cnt >= snap.job_min


def preemptable(snap, state, preemptor):  # noqa: ARG001
    """bool[T]: evicting the task leaves its job at or above minMember."""
    ready = job_ready_counts(snap, state.task_state)
    tj = torch.clamp(snap.task_job, 0, snap.num_jobs - 1).long()
    survives = ready[tj] - 1 >= snap.job_min[tj]
    return survives | (snap.task_job < 0)


@register_plugin
class GangPlugin(Plugin):
    name = "gang"

    def register(self, policy, tier: int) -> None:
        if self.enabled_for("jobValid"):
            policy.add_job_valid_fn(job_valid)
        if self.enabled_for("jobReady"):
            policy.add_job_ready_fn(job_ready)
            policy.add_job_pipelined_fn(job_pipelined)
        if self.enabled_for("jobOrder"):
            # unready gangs first (key 0.0), satisfied gangs later (1.0)
            policy.add_job_order_fn(
                tier, lambda snap, state: job_ready(snap, state).float()
            )
        if self.enabled_for("preemptable"):
            policy.add_preemptable_fn(tier, preemptable)
        if self.enabled_for("reclaimable"):
            policy.add_reclaimable_fn(tier, preemptable)

    def on_session_close(self, ssn) -> None:
        """Unschedulable events + PodGroup conditions for unready gangs
        (≙ gang.go · OnSessionClose), counted on the packed snapshot."""
        ready_counts = ssn.snapshot_ready_counts()
        job_min = ssn.host_field("job_min")
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
