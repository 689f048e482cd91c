"""Session: one scheduling cycle's runtime state and commit funnel.

Reference counterpart: framework/framework.go (OpenSession/CloseSession)
and framework/session.go; the port of kube_batch_tpu/framework/session.py
on the simulator path.  A Session owns one packed snapshot on the
scheduler's device (from the scheduler's IncrementalPacker, so it is
valid until the next cycle's pack) and the cycle's final state; cluster
effects happen only through its two funnels: `commit_evictions`
(preempt / reclaim victims, right after the solve) and `close_session`,
which dispatches binds for every job passing the JobReady gate (gang
all-or-nothing: an unready job's tentative placements are dropped with
zero cluster effect).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from kube_batch_tpu_torch.api.types import READY_STATUSES, TaskStatus
from kube_batch_tpu_torch.cache.cache import SchedulerCache
from kube_batch_tpu_torch.cache.incremental import IncrementalPacker
from kube_batch_tpu_torch.framework.conf import SchedulerConf
from kube_batch_tpu_torch.framework.plugin import Plugin, get_plugin_builder
from kube_batch_tpu_torch.framework.policy import TensorPolicy
from kube_batch_tpu_torch.ops.assignment import AllocState, init_state


def build_policy(conf: SchedulerConf) -> tuple[TensorPolicy, list[Plugin]]:
    """Instantiate plugins from conf and let them register their tensor
    fns — once per configuration."""
    from kube_batch_tpu_torch.framework.plugin import ensure_registered

    ensure_registered()
    policy = TensorPolicy(num_tiers=len(conf.tiers))
    args = conf.args_dict
    unknown = set(args) - {"allocate.max_rounds"}
    if unknown:
        raise ValueError(
            f"unknown scheduler.conf arguments: {sorted(unknown)} "
            "(supported: allocate.max_rounds)"
        )
    if "allocate.max_rounds" in args:
        mr = args["allocate.max_rounds"]
        if isinstance(mr, bool) or not isinstance(mr, int) or mr < 1:
            raise ValueError(
                f"allocate.max_rounds must be an integer >= 1, got {mr!r}"
            )
        policy.max_rounds = mr
    plugins: list[Plugin] = []
    for tier_idx, tier in enumerate(conf.tiers):
        for pconf in tier.plugins:
            plugin = get_plugin_builder(pconf.name)(pconf.args_dict)
            plugin.set_enabled(dict(pconf.enabled))
            plugin.register(policy, tier_idx)
            plugins.append(plugin)
    return policy, plugins


class Session:
    """One cycle: snapshot in, bind decisions out."""

    def __init__(
        self,
        cache: SchedulerCache,
        policy: TensorPolicy,
        plugins: Sequence[Plugin],
        packer: IncrementalPacker,
    ) -> None:
        self.cache = cache
        self.policy = policy
        self.plugins = list(plugins)
        # The packer holds the cache lock for the whole pack: a full
        # rebuild reads live Pod fields, an incremental pack drains the
        # journal; either way no mutation lands halfway through.
        self.snap, self.meta = packer.pack()
        # The packer already holds the padded host task_state.
        self.initial_task_state = packer.host_task_state()
        self._packer = packer
        self.state: AllocState = init_state(self.snap)
        # PodGroups whose statuses need recomputing at close: the groups
        # this pack's mutations touched (None = all, after a full
        # rebuild); this cycle's binds and evictions add theirs.
        self._refresh_groups: set[str] | None = (
            None if packer.last_groups is None else set(packer.last_groups)
        )
        self.bound: list[tuple[str, str]] = []     # (pod name, node)
        self.evicted: list[tuple[str, str]] = []   # (pod name, reason)
        # Host copies of the cycle's results (set by `finish`).
        self.host_task_state: np.ndarray | None = None
        self.host_task_node: np.ndarray | None = None
        self.job_ready: np.ndarray | None = None
        self.diag: dict | None = None

    def host_field(self, name: str) -> np.ndarray:
        """Read-only host view of a packed field (the packer's arrays:
        valid until the next pack, writes raise)."""
        return self._packer.host_field(name)

    def _note_group(self, pod) -> None:
        if self._refresh_groups is not None and pod.group:
            self._refresh_groups.add(pod.group)

    def finish(self, state: AllocState, job_ready: torch.Tensor, diag) -> None:
        """Install the solve's results; one device-to-host copy each of
        task_state, task_node and the gang gate."""
        self.state = state
        self.host_task_state = state.task_state.cpu().numpy()
        self.host_task_node = state.task_node.cpu().numpy()
        self.job_ready = job_ready.cpu().numpy()
        self.diag = diag

    def commit_evictions(self, victim_idx, reason: str) -> None:
        """Land evictions decided by preempt / reclaim through the cache
        (≙ Statement.Commit replaying Evict); a refused eviction is not
        recorded."""
        for t in victim_idx:
            pod = self.meta.task_pods[int(t)]
            if self.cache.evict(pod.uid, reason):
                self.evicted.append((pod.name, reason))
                self._note_group(pod)

    def dispatch_binds(self) -> list[tuple[str, str]]:
        """Bind every newly allocated task of every JobReady job (gang
        commit; ≙ session.go · Allocate's deferred dispatch).  Pipelined
        placements wait for their resources and are not bound."""
        task_job = self.host_field("task_job")
        newly = np.nonzero(
            (self.host_task_state == int(TaskStatus.ALLOCATED))
            & (self.initial_task_state == int(TaskStatus.PENDING))
        )[0]
        for t in newly:
            if t >= self.meta.num_real_tasks:
                continue
            j = task_job[t]
            if j < 0 or not self.job_ready[j]:
                continue  # gang gate: unready job's placements are dropped
            pod = self.meta.task_pods[t]
            node_name = self.meta.node_names[self.host_task_node[t]]
            if self.cache.bind(pod.uid, node_name):
                self.bound.append((pod.name, node_name))
                self._note_group(pod)
        return self.bound

    def snapshot_ready_counts(self) -> np.ndarray:
        """i32[J]: ready members per job as of the packed snapshot."""
        ready = np.isin(self.initial_task_state, [int(s) for s in READY_STATUSES])
        task_job = self.host_field("task_job")
        J = self.snap.num_jobs
        valid = ready & (task_job >= 0)
        return np.bincount(task_job[valid], minlength=J)[:J]

    def unready_jobs(self) -> list[str]:
        """Names of jobs that failed the gang gate this cycle."""
        return [
            name for j, name in enumerate(self.meta.job_names)
            if not self.job_ready[j]
        ]


def open_session(cache, policy, plugins, packer) -> Session:
    """≙ framework.go · OpenSession: pack + plugin open hooks."""
    ssn = Session(cache, policy, plugins, packer)
    for plugin in ssn.plugins:
        plugin.on_session_open(ssn)
    return ssn


def close_session(ssn: Session, diagnose: bool = True) -> None:
    """≙ framework.go · CloseSession: dispatch gang-gated binds, emit
    why-unschedulable events, run plugin close hooks, write back job
    status — of the groups this cycle's pack, binds and evictions
    touched (every live job after a full rebuild)."""
    from kube_batch_tpu_torch.framework.fit_errors import diagnose_pending

    ssn.dispatch_binds()
    if diagnose:
        for pod_name, namespace, message in diagnose_pending(ssn):
            ssn.cache.record_event(
                "Pod" if pod_name else "Scheduler",
                pod_name, "FailedScheduling", message, namespace=namespace,
            )
    for plugin in ssn.plugins:
        plugin.on_session_close(ssn)
    ssn.cache.refresh_job_statuses(ssn._refresh_groups)
