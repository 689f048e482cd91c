"""PDB plugin: PodDisruptionBudget-aware eviction vetoes.

Reference counterpart: the PDB the reference carries on each job
(api/job_info.go · JobInfo.PDB), honored when filtering preemption and
reclaim victims; the port of kube_batch_tpu/plugins/pdb.py.  The packer
resolves each pod's matching budgets into the multi-hot `task_pdbs`
(f32[T, B]) and the floors into `pdb_min` (i32[B]); the veto is two
products per preemption step against the LIVE state, so cumulative
evictions within one plan keep every floor.  A pod under several budgets
is evictable only if ALL of them keep their floor.  The operands are 0/1
and the sums stay below 2**24, so the float32 products are exact (TF32
is off, device.py).
"""

from __future__ import annotations

import torch

from kube_batch_tpu_torch.api.snapshot import allocated_mask
from kube_batch_tpu_torch.framework.plugin import Plugin, register_plugin


def pdb_healthy_counts(snap, state) -> torch.Tensor:
    """i32[B]: currently-healthy (resource-holding) members per budget."""
    member = (allocated_mask(state.task_state) & snap.task_mask).float()
    return (member @ snap.task_pdbs).to(torch.int32)


def veto(snap, state, preemptor):  # noqa: ARG001 — budgets are global
    if snap.pdb_min.shape[0] == 0:  # no budgets in this snapshot
        return torch.ones(snap.num_tasks, dtype=torch.bool, device=snap.device)
    healthy = pdb_healthy_counts(snap, state)
    # a budget is at its floor when losing one more member violates it
    at_floor = (healthy - 1 < snap.pdb_min).float()
    return snap.task_pdbs @ at_floor <= 0.5


@register_plugin
class PdbPlugin(Plugin):
    name = "pdb"

    def register(self, policy, tier: int) -> None:
        if self.enabled_for("preemptable"):
            policy.add_preemptable_fn(tier, veto)
        if self.enabled_for("reclaimable"):
            policy.add_reclaimable_fn(tier, veto)
