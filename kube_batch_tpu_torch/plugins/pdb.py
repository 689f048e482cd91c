"""PDB plugin: PodDisruptionBudget-aware eviction vetoes.

Reference counterpart: the PDB the reference carries on each job
(api/job_info.go · JobInfo.PDB), honored when filtering preemption and
reclaim victims.  Its veto belongs to the preempt and reclaim actions,
which are not ported yet (ROADMAP A6); in the allocate/backfill cycle of
this package the plugin registers nothing, exactly as its reference twin
contributes nothing to those actions.  The packer still resolves
`task_pdbs` / `pdb_min`.
"""

from __future__ import annotations

from kube_batch_tpu_torch.framework.plugin import Plugin, register_plugin


@register_plugin
class PdbPlugin(Plugin):
    name = "pdb"
