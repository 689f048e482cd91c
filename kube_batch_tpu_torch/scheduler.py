"""Scheduler: the cycle loop (≙ pkg/scheduler/scheduler.go · Scheduler).

The port of kube_batch_tpu/scheduler.py · Scheduler.run_once, reduced to
the simulator path: snapshot → pack → cycle solve on the device → each
evicting action's victims committed under its own reason → gang-gated
binds → PodGroup status.  The commit pipeline, incremental pack, compile
bank, guardrails, health ledger and mesh are later slices (ROADMAP
A7–A10).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from kube_batch_tpu_torch.actions.fused import make_cycle_solver
from kube_batch_tpu_torch.actions.preempt import commit_victim_indices
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.device import resolve_device
from kube_batch_tpu_torch.framework.conf import SchedulerConf, default_conf
from kube_batch_tpu_torch.framework.plugin import get_action
from kube_batch_tpu_torch.framework.session import (
    Session,
    build_policy,
    close_session,
    open_session,
)


class Scheduler:
    """Runs scheduling cycles of one conf against one cache on `device`
    ("cuda" by default; raises when no CUDA device is present)."""

    def __init__(self, cache, conf: SchedulerConf | None = None,
                 device: str | torch.device = "cuda") -> None:
        self.device = resolve_device(device)
        self.cache = cache
        self.conf = conf if conf is not None else default_conf()
        self.policy, self.plugins = build_policy(self.conf)
        self.cycle = make_cycle_solver(self.policy, self.conf.actions)
        self._ran = False
        self._evict_reasons = {
            name: getattr(get_action(name), "evict_reason", name)
            for name in self.conf.actions
        }
        #: per-phase wall milliseconds, auction rounds, preemption steps
        #: and evictions per action of the last cycle
        self.last_timings: dict[str, float] = {}
        self.last_stats: dict = {}

    def _idle(self) -> bool:
        """Nothing to schedule: a cycle already ran and no pod is Pending
        and no failed bind awaits a retry (≙ runOnce on an idle cluster)."""
        if not self._ran:
            return False
        with self.cache.lock():
            return not self.cache._resync and not any(
                p.status == TaskStatus.PENDING for p in self.cache._pods.values()
            )

    def run_once(self) -> Session | None:
        """One cycle; returns its Session, or None for a skipped idle
        cycle."""
        self.cache.drain_resync()  # failed binds are Pending again
        if self._idle():
            return None
        t0 = time.perf_counter()
        ssn = open_session(self.cache, self.policy, self.plugins, self.device)
        t1 = time.perf_counter()
        stats: dict = {}
        state, evict, job_ready, diag = self.cycle(ssn.snap, ssn.state, stats)
        ssn.finish(state, job_ready, diag)   # device-to-host copies sync
        host_evict = {name: m.cpu().numpy() for name, m in evict.items()}
        t2 = time.perf_counter()
        evicted = {}
        for name in self.conf.actions:       # conf order, each its own reason
            if name in host_evict:
                evicted[name] = commit_victim_indices(
                    ssn, np.nonzero(host_evict[name])[0], self._evict_reasons[name]
                )
        if evicted:
            stats["evicted"] = evicted
        close_session(ssn)
        t3 = time.perf_counter()
        self._ran = True
        self.last_stats = stats
        self.last_timings = {
            "pack_ms": (t1 - t0) * 1e3,
            "solve_ms": (t2 - t1) * 1e3,
            "dispatch_ms": (t3 - t2) * 1e3,
        }
        return ssn
