"""Scheduler: the cycle loop (≙ pkg/scheduler/scheduler.go · Scheduler).

The port of kube_batch_tpu/scheduler.py · Scheduler.run_once, reduced to
the simulator path: incremental pack → cycle solve on the device → each
evicting action's victims committed under its own reason → gang-gated
binds → PodGroup status.  The pack is event-driven by default: the
scheduler's IncrementalPacker patches only the rows whose pods, jobs or
nodes changed since the last cycle (cache/incremental.py) and
`pack_mode="full"` rebuilds every cycle instead; decisions are the same
either way.  `joint_solve` (or KB_TPU_JOINT_SOLVE=1) runs the cycle as
the joint single solve (ops/joint.py) instead of the actions in sequence;
a conf it cannot fold takes the sequential path, as in the reference,
and `last_stats["cycle"]` says which one ran.  The commit pipeline,
compile bank, guardrails, health ledger and mesh are later slices
(ROADMAP A7–A10).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from kube_batch_tpu_torch.actions.fused import make_cycle_solver
from kube_batch_tpu_torch.actions.preempt import commit_victim_indices
from kube_batch_tpu_torch.cache.cache import CacheResyncing
from kube_batch_tpu_torch.cache.incremental import IncrementalPacker
from kube_batch_tpu_torch.device import resolve_device
from kube_batch_tpu_torch.framework.conf import SchedulerConf, default_conf
from kube_batch_tpu_torch.framework.plugin import get_action
from kube_batch_tpu_torch.framework.session import (
    Session,
    build_policy,
    close_session,
    open_session,
)

PACK_MODES = ("incremental", "full")


class Scheduler:
    """Runs scheduling cycles of one conf against one cache on `device`
    ("cuda" by default; raises when no CUDA device is present).
    `pack_mode` "incremental" (default) patches the previous cycle's
    pack, "full" rebuilds it every cycle (the escape hatch).
    `joint_solve` True runs the joint single solve, False the actions in
    sequence; None (the default) reads KB_TPU_JOINT_SOLVE ("1" = joint),
    as the reference does."""

    def __init__(self, cache, conf: SchedulerConf | None = None,
                 device: str | torch.device = "cuda",
                 pack_mode: str = "incremental",
                 joint_solve: bool | None = None) -> None:
        if pack_mode not in PACK_MODES:
            raise ValueError(
                f"pack_mode must be one of {PACK_MODES}, got {pack_mode!r}"
            )
        self.device = resolve_device(device)
        self.cache = cache
        self.conf = conf if conf is not None else default_conf()
        self.policy, self.plugins = build_policy(self.conf)
        if joint_solve is None:
            joint_solve = os.environ.get("KB_TPU_JOINT_SOLVE") == "1"
        self.cycle, self.cycle_kind = None, "sequential"
        if joint_solve:
            try:
                self.cycle = make_cycle_solver(self.policy, self.conf.actions,
                                               joint=True)
                self.cycle_kind = "joint"
            except ValueError as exc:
                logging.warning("joint solve unavailable, sequential cycle: %s",
                                exc)
        if self.cycle is None:
            self.cycle = make_cycle_solver(self.policy, self.conf.actions)
        self.packer = IncrementalPacker(cache, device=self.device)
        self.packer.force_full = pack_mode == "full"
        self.pack_mode = pack_mode
        # The idle skip is armed once a cycle has solved; the journal
        # version last refreshed while idle.
        self._idle_armed = False
        self._idle_refreshed_version = 0
        self._evict_reasons = {
            name: getattr(get_action(name), "evict_reason", name)
            for name in self.conf.actions
        }
        #: per-phase wall milliseconds, auction rounds, preemption steps
        #: (the joint solve: steps and ms per tier), evictions per action
        #: and the cycle kind of the last cycle
        self.last_timings: dict[str, float] = {}
        self.last_stats: dict = {}

    def _skip_idle(self) -> bool:
        """True when the cycle can be skipped outright: a cycle already
        solved, no pod is Pending or Releasing and no failed bind awaits a
        retry (≙ runOnce on an idle cluster).  Status transitions that did
        land since the last pack (Bound → Running) still get their
        PodGroup statuses refreshed — once per journal version; the
        journal itself is left intact for the next real pack."""
        if not self._idle_armed or self.cache.is_resyncing():
            return False
        if self.cache.has_pending_work():
            return False
        d = self.packer._dirty
        with self.cache.lock():
            if d.version == self._idle_refreshed_version:
                groups = None
            else:
                groups = set(d.groups)
                self._idle_refreshed_version = d.version
        if groups:
            self.cache.refresh_job_statuses(groups)
        return True

    def run_once(self) -> Session | None:
        """One cycle; returns its Session, or None for a skipped idle or
        quiesced cycle."""
        self.cache.drain_resync()  # failed binds are Pending again
        if self._skip_idle():
            return None
        t0 = time.perf_counter()
        try:
            ssn = open_session(self.cache, self.policy, self.plugins,
                               self.packer)
        except CacheResyncing:
            return None  # quiesced mirror: the journal keeps every mark
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
        self._idle_armed = True
        # The pack drained the journal; idle-refresh marks restart.
        self._idle_refreshed_version = 0
        stats["cycle"] = self.cycle_kind
        stats["pack_mode"] = self.packer.last_mode
        stats["pack_h2d_bytes"] = self.packer.last_h2d_bytes
        self.last_stats = stats
        self.last_timings = {
            "pack_ms": (t1 - t0) * 1e3,
            "pack_host_ms": self.packer.last_host_ms,
            "pack_h2d_ms": self.packer.last_h2d_ms,
            "solve_ms": (t2 - t1) * 1e3,
            "dispatch_ms": (t3 - t2) * 1e3,
        }
        return ssn
