#!/usr/bin/env python3
"""Chip smoke test of kube_batch_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, `nvcc`
and `triton`.  Phases (any failure exits non-zero):

1. card and build — the card's name and power limit, torch/CUDA
   versions, and the build of every CUDA kernel from this checkout's
   sources (one nvcc per source, all at once), timed;
2. slice parity — config 3, config 4 (oversubscribed), a mid-size
   config 5 (500 nodes, 5,000 pods) and a feature world that turns on
   every kernel option of the default conf (affinity terms, preferences,
   volumes, ports, taints), 2 cycles each on the card and on the CPU.
   Between the cycles the simulator ticks and a second wave of the
   world's own jobs arrives (config 4 keeps its unplaced pods), and the
   first bind of some pods is refused, so cycle 2 packs bound and
   running pods and re-places failed binds.  Binds, final task_state /
   task_node, job_ready and the failure tallies must be identical, and
   every kernel call of the card run is held against its plain version
   on its own inputs;
3. the main path — full-size config 5 (5,000 nodes, 47,524 pods, padded
   T=65536, N=8192) for 2 cycles on the card through `Scheduler.run_once`,
   with a second wave of 15,000 pods arriving after cycle 1, which
   oversubscribes the cluster.  Every kernel's launch counter is set to 0
   just before and read just after; asserts that every kernel launched,
   that no node is over-committed, that gangs bind all-or-nothing and
   that every bind lands on a node the predicate mask allows;
4. kernels — each kernel against its plain PyTorch version on the card,
   on the inputs the main path gave it in cycle 2: the predicate mask and
   failure tallies of that cycle, and the auction round whose resolve
   rejected the most proposals.  Outputs exactly equal; kernel / plain /
   library times (median of CUDA-event timed runs after a warm-up) and
   the least time the card could take.

The last two lines are the `kernels` JSON object and
{"ok": true, "device": {...}}.  Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
# The port must never reach the reference package or JAX.
for _blocked in ("jax", "jaxlib", "flax", "kube_batch_tpu"):
    sys.modules[_blocked] = None

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
F64_OPS_PER_S = 34e12       # H100 SXM float64 outside the tensor cores

KERNELS = {
    # name: (route, source, replaces)
    "predicate_mask": ("cuda", "kube_batch_tpu_torch/kernels/csrc/predicate_mask.cu",
                       "kube_batch_tpu/plugins/predicates.py:84"),
    "propose_best": ("cuda", "kube_batch_tpu_torch/kernels/csrc/propose.cu",
                     "kube_batch_tpu/ops/assignment.py:339"),
    "propose_pick": ("cuda", "kube_batch_tpu_torch/kernels/csrc/propose.cu",
                     "kube_batch_tpu/ops/assignment.py:117"),
    "resolve": ("cuda", "kube_batch_tpu_torch/kernels/csrc/resolve.cu",
                "kube_batch_tpu/ops/assignment.py:216"),
    "apply": ("cuda", "kube_batch_tpu_torch/kernels/csrc/resolve.cu",
              "kube_batch_tpu/ops/assignment.py:421"),
    "failure_counts": ("triton", "kube_batch_tpu_torch/kernels/failure_counts.py",
                       "kube_batch_tpu/framework/fit_errors.py:32"),
}

MAIN_WAVE_PODS = 15000   # second wave of the main path (T stays 65536)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, warmup: int = 2, runs: int = 7) -> float:
    """Median wall time of one call on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def bound(nbytes: float, ops: float, op_rate: float = F32_OPS_PER_S):
    """(least time in ms, "bytes" | "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(pairs) -> float:
    err = 0.0
    for a, b in pairs:
        if a.shape != b.shape:
            fail(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
        if a.numel():
            err = max(err, float((a.double() - b.double()).abs().max()))
    return err


def require_equal(name: str, pairs) -> float:
    import torch

    for i, (a, b) in enumerate(pairs):
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"{name}: output {i} differs from the plain version "
                 f"(max abs err {max_abs_err([(a, b)])})")
    return max_abs_err(pairs)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_card_and_build():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({
        "phase": "card", "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }))
    from kube_batch_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    for name, text in sorted(build.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"ptxas[{name}]: {line.strip()}")
    log(json.dumps({"phase": "build", "nvcc_parallel_s": round(build_s, 3)}))


# ---------------------------------------------------------------------------
# worlds
# ---------------------------------------------------------------------------

_POD_SPEC = ("request", "priority", "namespace", "selector", "labels",
             "affinity", "anti_affinity", "pod_prefs", "preferences",
             "tolerations", "ports", "claims")


def arrivals(cache, sim, n_pods: int) -> int:
    """A second wave of the world's own jobs: its first jobs, in
    submission order, submitted again under new names (same requests,
    gangs, queues and constraints) until `n_pods` pods have arrived."""
    from kube_batch_tpu_torch.cache.cluster import Pod, PodGroup

    with cache.lock():
        jobs = [(j.pod_group, list(j.tasks.values()))
                for j in cache._jobs.values()]
    sent = 0
    for group, pods in jobs:
        if sent >= n_pods:
            break
        if not pods:
            continue
        sim.submit(
            PodGroup(name=f"late-{group.name}", queue=group.queue,
                     min_member=group.min_member, priority=group.priority),
            [Pod(name=f"late-{p.name}", **{f: getattr(p, f) for f in _POD_SPEC})
             for p in pods],
        )
        sent += len(pods)
    return sent


class RefuseFirstBinds:
    """Binder that refuses the first bind of every 23rd pod (by a hash of
    its name) and passes every other bind to the simulator.  The cache
    resets a refused pod to Pending and queues it for resync; the next
    cycle drains the queue and places the pod again."""

    def __init__(self, sim) -> None:
        self.sim = sim
        self.refused: set[str] = set()

    def bind(self, pod, node_name: str) -> None:
        if pod.name not in self.refused and zlib.crc32(pod.name.encode()) % 23 == 0:
            self.refused.add(pod.name)
            raise RuntimeError("bind refused once by the smoke test")
        self.sim.bind(pod, node_name)


def _feature_world():
    """Every kernel option of the default conf at once: selectors,
    taints, host ports, volume pins and volume groups (K1); required
    node- and zone-scoped affinity / anti-affinity, soft pod-affinity
    and preferred node labels (K2's dynamic mask and both additive
    score terms; K3's serialize set and the domain / bootstrap serialize
    glue)."""
    import random

    from kube_batch_tpu_torch.cache.cluster import Claim, PodGroup, StorageClass
    from kube_batch_tpu_torch.models.workloads import DEFAULT_SPEC, GI, _node, _pod
    from kube_batch_tpu_torch.sim.simulator import make_world

    rng = random.Random(0)
    cache, sim = make_world(DEFAULT_SPEC)
    for i in range(64):
        sim.add_node(_node(
            f"n{i}", cpu_milli=16000, mem=64 * GI,
            labels={"zone": f"z{i % 4}", "disk": "ssd" if i % 3 == 0 else "hdd"},
            taints=(frozenset({"gpu=only:NoSchedule"}) if i % 8 == 0
                    else frozenset()),
        ))
    sim.add_storage_class(StorageClass(
        name="ssd-local", allowed_node_labels=frozenset({"disk=ssd"})
    ))
    sim.add_claim(Claim(name="pinned", bound_node="n5"))
    sim.add_claim(Claim(name="fast", storage_class="ssd-local"))
    apps = ["web", "cache", "db", "api", "batch"]
    for j in range(60):
        app = apps[j % len(apps)]
        kw = {"labels": {"app": app}}
        if app == "web":
            kw["anti_affinity"] = frozenset({"app=web"})
            kw["ports"] = frozenset({8080})
        elif app == "cache":
            kw["affinity"] = frozenset({"app=cache"})
        elif app == "db":
            kw["anti_affinity"] = frozenset({"zone:app=db"})
            kw["pod_prefs"] = {"app=web": 2.0, "zone:app=cache": 1.0}
            kw["claims"] = frozenset({"fast"})
        elif app == "api":
            kw["affinity"] = frozenset({"zone:app=web"})
            kw["preferences"] = {"disk=ssd": 3.0, "zone=z1": 1.0}
            kw["selector"] = {"zone": rng.choice(["z0", "z1", "z2"])}
        else:
            kw["tolerations"] = frozenset({"gpu=only:NoSchedule"})
            if j == 4:
                kw["claims"] = frozenset({"pinned"})
        n = rng.choice([2, 4, 6])
        sim.submit(PodGroup(name=f"{app}{j}", queue="default",
                            min_member=n if app == "cache" else 1), [
            _pod(f"{app}{j}-{i}", cpu=rng.choice([500, 1000, 2000]),
                 mem=rng.choice([1, 2, 4]) * GI, **kw)
            for i in range(n)
        ])
    return cache, sim


# world: (builder, pods of the second wave)
PARITY_WORLDS = {
    "config3": (lambda: _config(3), 300),
    "config4": (lambda: _config(4), 0),
    "config5_mid": (lambda: _config(5, n_nodes=500, target_pods=5000), 1500),
    "features": (_feature_world, 60),
}


def _config(n: int, **kw):
    from kube_batch_tpu_torch.models.workloads import build_config

    return build_config(n, seed=0, **kw)


# ---------------------------------------------------------------------------
# recording the kernels' inputs on a run
# ---------------------------------------------------------------------------

# Argument positions each wrapper's caller writes in place after (or,
# for apply, during) the call: these are cloned when recorded.
_MUTATED = {
    "predicate_mask": (),
    "propose_best": (3, 7),      # avail, node_future
    "propose_pick": (3, 7),
    "resolve": (3,),             # avail
    "apply": (4, 5, 8, 9),       # node_future, node_idle, task_state, task_node
    "failure_counts": (2,),      # node_idle
}


class Recorder:
    """While active, every kernel wrapper call of the scheduler goes
    through unchanged (it launches and counts as before) and its inputs
    are kept: `calls[name]` lists (cycle, round, args).  A cycle starts
    at its predicate-mask call and a round at its propose_best call."""

    def __init__(self) -> None:
        import kube_batch_tpu_torch.plugins.predicates as plug
        from kube_batch_tpu_torch.kernels import failure_counts, propose, resolve

        self.sites = [
            (plug, "predicate_mask", "predicate_mask"),
            (propose, "propose_best", "propose_best"),
            (propose, "propose_pick", "propose_pick"),
            (resolve, "resolve", "resolve"),
            (resolve, "apply", "apply"),
            (failure_counts, "failure_counts", "failure_counts"),
        ]
        self.calls = {name: [] for name in _MUTATED}
        self.cycle = self.round = -1
        self._saved = []

    def _wrap(self, name, fn):
        mutated = _MUTATED[name]

        def wrapper(*args):
            if name == "predicate_mask":
                self.cycle += 1
            elif name == "propose_best":
                self.round += 1
            kept = tuple(a.clone() if i in mutated else a
                         for i, a in enumerate(args))
            self.calls[name].append((self.cycle, self.round, kept))
            return fn(*args)

        return wrapper

    def __enter__(self):
        for mod, attr, name in self.sites:
            fn = getattr(mod, attr)
            w = self._wrap(name, fn)
            # A wrapper counts its launches on its module's global name,
            # which is `w` while patched: `w` counts on from `fn`'s count.
            w.launches = fn.launches
            self._saved.append((mod, attr, fn, w, fn.launches))
            setattr(mod, attr, w)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn, w, start in self._saved:
            setattr(mod, attr, fn)
            fn.launches += w.launches - start
        self._saved = []


# ---------------------------------------------------------------------------
# kernel against plain version, on recorded inputs
# ---------------------------------------------------------------------------

def _fresh_apply_args(args):
    return tuple(a.clone() if i in _MUTATED["apply"] else a
                 for i, a in enumerate(args))


def check_call(name: str, args):
    """Run kernel and plain version on `args`; require equal outputs.
    Returns (max_abs_err, {what: count of non-trivial outputs})."""
    from kube_batch_tpu_torch.kernels import failure_counts as k4
    from kube_batch_tpu_torch.kernels import predicate_mask as k1
    from kube_batch_tpu_torch.kernels import propose as k2
    from kube_batch_tpu_torch.kernels import resolve as k3

    if name == "predicate_mask":
        snap = args[0]
        out = k1.predicate_mask(*args)
        err = require_equal(name, [(out, k1.predicate_mask_plain(*args))])
        real = snap.task_mask[:, None] & snap.node_mask[None, :]
        return err, {"real_cells": int(real.sum()),
                     "vetoed_cells": int((real & ~out).sum())}
    if name == "propose_best":
        out = k2.propose_best(*args)
        err = require_equal(name, list(zip(out, k2.propose_best_plain(*args))))
        best, ties, active = out
        return err, {"active": int(active.sum()),
                     "multi_tie_rows": int((active & (ties > 1)).sum())}
    if name == "propose_pick":
        out = k2.propose_pick(*args)
        err = require_equal(name, [(out, k2.propose_pick_plain(*args))])
        active, k = args[13], args[14]
        return err, {"active": int(active.sum()),
                     "picked_past_first_tie": int((active & (k > 0)).sum())}
    if name == "resolve":
        perm, s_node, avail = args[0], args[1], args[3]
        out = k3.resolve(*args)
        err = require_equal(name, [(out, k3.resolve_plain(*args))])
        proposers = int((s_node < avail.shape[0]).sum())
        accepted = int(out[perm][s_node < avail.shape[0]].sum())
        return err, {"proposers": proposers, "accepted": accepted,
                     "rejected": proposers - accepted}
    if name == "apply":
        a_k, a_p = _fresh_apply_args(args), _fresh_apply_args(args)
        k3.apply(*a_k)
        k3.apply_plain(*a_p)
        err = require_equal(name, [(a_k[i], a_p[i]) for i in (4, 5, 8, 9)])
        return err, {"accepted": int(args[2].sum()),
                     "rows_changed": int((a_k[8] != args[8]).sum())}
    if name == "failure_counts":
        out = k4.failure_counts(*args)
        err = require_equal(name, list(zip(out, k4.failure_counts_plain(*args))))
        pf, ins, fe = out
        return err, {"rows_predicate_failed": int((pf > 0).sum()),
                     "rows_insufficient": int((ins > 0).any(dim=1).sum()),
                     "rows_feasible": int((fe > 0).sum())}
    raise KeyError(name)


def check_all(rec: Recorder) -> dict:
    """Hold every recorded call against the plain version; sum the
    non-trivial-output counts per kernel."""
    totals = {}
    for name, calls in rec.calls.items():
        acc = {"calls": len(calls)}
        for _cycle, _round, args in calls:
            _, counts = check_call(name, args)
            for k, v in counts.items():
                acc[k] = acc.get(k, 0) + v
        totals[name] = acc
    return totals


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def _run(world: str, device: str, record: bool):
    from kube_batch_tpu_torch.scheduler import Scheduler

    build, wave = PARITY_WORLDS[world]
    cache, sim = build()
    binder = RefuseFirstBinds(sim)
    cache.binder = binder
    sched = Scheduler(cache, device=device)
    rec = Recorder() if record else None
    cycles = []
    for cycle in range(2):
        if rec is not None:
            with rec:
                ssn = sched.run_once()
        else:
            ssn = sched.run_once()
        if ssn is None:
            fail(f"{world}: cycle {cycle} found nothing to solve")
        cycles.append({
            "binds": list(ssn.bound),
            "task_state": ssn.host_task_state.copy(),
            "task_node": ssn.host_task_node.copy(),
            "job_ready": ssn.job_ready.copy(),
            "diag": {k: v.cpu().numpy() for k, v in ssn.diag.items()},
            "rounds": dict(sched.last_stats),
        })
        sim.tick()
        if cycle == 0 and wave:
            arrivals(cache, sim, wave)
    return cycles, len(binder.refused), rec


def _same(a, b) -> bool:
    import numpy as np

    if a["binds"] != b["binds"]:
        return False
    for key in ("task_state", "task_node", "job_ready"):
        if not np.array_equal(a[key], b[key]):
            return False
    return a["diag"].keys() == b["diag"].keys() and all(
        np.array_equal(a["diag"][k], b["diag"][k]) for k in a["diag"]
    )


def phase_parity():
    seen = {}
    for world in PARITY_WORLDS:
        t0 = time.perf_counter()
        gpu, refused, rec = _run(world, "cuda", record=True)
        t1 = time.perf_counter()
        cpu, _, _ = _run(world, "cpu", record=False)
        t2 = time.perf_counter()
        for c, (g, h) in enumerate(zip(gpu, cpu)):
            if not _same(g, h):
                fail(f"{world}: cycle {c} decisions or failure tallies differ "
                     "between cuda and cpu")
        checks = check_all(rec)
        for name, acc in checks.items():
            for k, v in acc.items():
                seen[(name, k)] = seen.get((name, k), 0) + v
        log(json.dumps({
            "phase": "parity", "world": world, "cycles": 2,
            "bound_per_cycle": [len(c["binds"]) for c in gpu],
            "rounds_per_cycle": [c["rounds"] for c in gpu],
            "binds_refused_once": refused,
            "cuda_s": round(t1 - t0, 3), "cpu_s": round(t2 - t1, 3),
            "identical": True,
        }))
        log(json.dumps({"phase": "parity-kernels", "world": world,
                        "equal_to_plain": True, **checks}))
    # every check must have met a non-trivial case somewhere
    for key in (("predicate_mask", "vetoed_cells"), ("propose_best", "multi_tie_rows"),
                ("propose_pick", "picked_past_first_tie"), ("resolve", "rejected"),
                ("apply", "rows_changed"), ("failure_counts", "rows_predicate_failed"),
                ("failure_counts", "rows_insufficient")):
        if seen.get(key, 0) <= 0:
            fail(f"parity worlds never gave {key[0]} a case with {key[1]} > 0")


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def _check_invariants(cache, snap_checks):
    import numpy as np

    from kube_batch_tpu_torch.api.types import READY_STATUSES, TaskStatus

    with cache.lock():
        for name, info in cache._nodes.items():
            if np.any(info.used > info.allocatable):
                fail(f"node {name} over-committed: used {info.used} > "
                     f"allocatable {info.allocatable}")
        placed = {TaskStatus.BINDING, TaskStatus.BOUND, TaskStatus.RUNNING}
        for jname, job in cache._jobs.items():
            pods = job.tasks.values()
            if any(p.status in placed for p in pods):
                held = sum(1 for p in pods if p.status in READY_STATUSES)
                if held < job.min_available:
                    fail(f"gang {jname}: {held} members placed, "
                         f"min_member {job.min_available}")
    for pred_np, task_idx, node_idx, binds in snap_checks:
        for pod_name, node_name in binds:
            t, n = task_idx[pod_name], node_idx[node_name]
            if not pred_np[t, n]:
                fail(f"bind {pod_name} -> {node_name} violates the predicate mask")


def phase_main_path(device, wave: int = MAIN_WAVE_PODS, **world_kw):
    import torch

    from kube_batch_tpu_torch import kernels
    from kube_batch_tpu_torch.kernels.predicate_mask import (
        PredicateFlags,
        predicate_mask_plain,
    )
    from kube_batch_tpu_torch.models.workloads import config5_full
    from kube_batch_tpu_torch.scheduler import Scheduler

    cache, sim = config5_full(seed=0, **world_kw)
    sched = Scheduler(cache, device=device)
    cuda = device.type == "cuda"
    rec = Recorder()
    sessions = []
    kernels.reset_counts()
    with rec:
        for cycle in range(2):
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            ssn = sched.run_once()
            wall_ms = (time.perf_counter() - t0) * 1e3
            if ssn is None:
                fail(f"main path: cycle {cycle} found nothing to solve")
            rec_line = {"phase": "main-path", "cycle": cycle,
                        "tasks": ssn.meta.num_real_tasks,
                        "bound": len(ssn.bound), "wall_ms": round(wall_ms, 3)}
            rec_line.update(sched.last_stats)
            rec_line.update({k: round(v, 3) for k, v in sched.last_timings.items()})
            if cuda:
                rec_line["peak_mem_bytes"] = torch.cuda.max_memory_allocated(device)
            log(json.dumps(rec_line))
            sessions.append(ssn)
            sim.tick()
            if cycle == 0:
                t0 = time.perf_counter()
                n = arrivals(cache, sim, wave)
                log(json.dumps({"phase": "main-path-arrivals", "pods": n,
                                "submit_ms": round((time.perf_counter() - t0) * 1e3, 3)}))
    counts = kernels.counts()
    log(json.dumps({"phase": "main-path-launches", **counts}))
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    if sessions[1].snap.num_tasks != sessions[0].snap.num_tasks:
        fail("the second wave changed the padded task count")
    if not sessions[0].bound or not sessions[1].bound:
        fail("a main-path cycle bound nothing")
    # independent predicate check (plain version; launches nothing)
    snap_checks = []
    for ssn in sessions:
        pred = predicate_mask_plain(ssn.snap, PredicateFlags()).cpu().numpy()
        snap_checks.append((
            pred,
            {p.name: i for i, p in enumerate(ssn.meta.task_pods)},
            {n: i for i, n in enumerate(ssn.meta.node_names)},
            ssn.bound,
        ))
        del pred
    _check_invariants(cache, snap_checks)
    log(json.dumps({"phase": "invariants", "capacity": True, "gang": True,
                    "predicate": True}))
    return counts, rec


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def _pick_round(rec: Recorder):
    """The last cycle's auction round whose resolve rejected the most
    proposals, among rounds that applied placements: its (propose_best,
    propose_pick, resolve, apply) inputs and that count."""
    from kube_batch_tpu_torch.kernels import resolve as k3

    last = max(c for c, _, _ in rec.calls["predicate_mask"])
    by_round = {}
    for name in ("propose_best", "propose_pick", "resolve", "apply"):
        for cycle, rnd, args in rec.calls[name]:
            if cycle == last:
                by_round.setdefault(rnd, {})[name] = args
    best, best_rej = None, -1
    for _rnd, calls in sorted(by_round.items()):
        if len(calls) < 4:
            continue
        perm, s_node, avail = (calls["resolve"][i] for i in (0, 1, 3))
        real = s_node < avail.shape[0]
        rej = int(real.sum()) - int(k3.resolve(*calls["resolve"])[perm][real].sum())
        if rej > best_rej:
            best, best_rej = calls, rej
    if best is None:
        fail("main path: no auction round of cycle 2 applied placements")
    if best_rej <= 0:
        fail("main path: no auction round of cycle 2 rejected a proposal")
    return best, best_rej


def _live_width(a, b) -> int:
    """Vocabulary columns some task or node actually uses."""
    return int((a.any(dim=0) | b.any(dim=0)).sum()) if a.shape[1] else 0


def _work_counts(args, prop, active):
    """Cells each propose pass must touch, from this round's data: fit
    checks (eligible rows on real, predicate-passing nodes), feasible
    cells (scored), and for the pick pass the cells up to each active
    row's chosen node."""
    import torch

    from kube_batch_tpu_torch.kernels.propose import (
        PLAIN_ROWS,
        masked_scores_plain,
        quantum_scale,
    )

    (pred, dyn, req, avail, eps, node_mask, eligible, future, cap, spec,
     extras, quantum) = args
    T, N = pred.shape
    cols = torch.arange(N, device=pred.device)
    fit_cells = feas_cells = scan_cells = scan_feas = 0
    for lo in range(0, T, PLAIN_ROWS):
        rows = slice(lo, min(T, lo + PLAIN_ROWS))
        e = eligible[rows]
        static = pred[rows] if dyn is None else pred[rows] & dyn[rows]
        feas, _ = masked_scores_plain(
            pred[rows], None if dyn is None else dyn[rows], req[rows], avail,
            eps, node_mask, e, future, cap, spec, [x[rows] for x in extras],
            quantum_scale(quantum),
        )
        fit_cells += int((static & node_mask[None, :] & e[:, None]).sum())
        feas_cells += int(feas.sum())
        scanned = active[rows, None] & (cols[None, :] <= prop[rows, None])
        scan_cells += int(scanned.sum())
        scan_feas += int((scanned & feas).sum())
    return fit_cells, feas_cells, scan_cells, scan_feas


def _score_ops(spec, R: int) -> int:
    ops = 2  # mask select, quantum floor
    if spec.w_lr is not None:
        ops += 7 * R + 4
    if spec.w_bal is not None:
        ops += 16
    return ops


def phase_kernels(rec: Recorder):
    import torch

    from kube_batch_tpu_torch.kernels import failure_counts as k4
    from kube_batch_tpu_torch.kernels import predicate_mask as k1
    from kube_batch_tpu_torch.kernels import propose as k2
    from kube_batch_tpu_torch.kernels import resolve as k3

    out = {}

    def record(name, args, ms, plain_ms, b, library_ms=None):
        err, counts = check_call(name, args)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b,
                         library_ms=library_ms)
        log(json.dumps({"phase": "kernel", "name": name, "inputs": counts,
                        "max_abs_err": err, "ms": round(ms, 4),
                        "plain_ms": round(plain_ms, 4),
                        "library_ms": None if library_ms is None else round(library_ms, 4),
                        "bound_ms": round(b[0], 4), "bound_by": b[1]}))

    # K1, cycle 2's call
    args = rec.calls["predicate_mask"][-1][2]
    snap = args[0]
    T, N, R = snap.num_tasks, snap.num_nodes, snap.num_resources
    W = (_live_width(snap.task_sel, snap.node_labels)
         + _live_width(snap.task_tol, snap.node_taints)
         + _live_width(snap.task_ports, snap.node_ports)
         + int(snap.task_vol_groups.any(dim=0).sum()))
    in_bytes = sum(x.numel() * x.element_size() for x in (
        snap.task_sel, snap.node_labels, snap.task_tol, snap.node_taints,
        snap.task_ports, snap.node_ports, snap.node_ready, snap.node_pressure,
        snap.task_vol_node, snap.task_vol_groups))
    record("predicate_mask", args,
           time_ms(lambda: k1.predicate_mask(*args)),
           time_ms(lambda: k1.predicate_mask_plain(*args)),
           bound(in_bytes + T * N, T * N * (2 * W + 6)),
           # The one-call PyTorch form of this function is the selector /
           # taint / port products by torch.matmul with their compares.
           time_ms(lambda: k1.predicate_mask_plain(*args)))
    log(json.dumps({"phase": "kernel-note", "name": "predicate_mask",
                    "live_vocabulary_columns": W}))

    # K2 and K3 on one auction round of cycle 2
    rnd, rejected = _pick_round(rec)
    bargs, pargs, rargs, aargs = (rnd[k] for k in (
        "propose_best", "propose_pick", "resolve", "apply"))
    spec = bargs[9]
    best, ties, active = k2.propose_best(*bargs)
    prop = k2.propose_pick(*pargs)
    fit_cells, feas_cells, scan_cells, scan_feas = _work_counts(bargs, prop, active)
    log(json.dumps({"phase": "round-inputs", "eligible": int(bargs[6].sum()),
                    "active": int(active.sum()), "rejected": rejected,
                    "fit_cells": fit_cells,
                    "feasible_cells": feas_cells, "pick_cells": scan_cells}))
    sops = _score_ops(spec, R)
    n_extra = len(bargs[10]) + (bargs[1] is not None)
    small = T * R * 4 + 3 * N * R * 4 + N + T
    record("propose_best", bargs,
           time_ms(lambda: k2.propose_best(*bargs)),
           time_ms(lambda: k2.propose_best_plain(*bargs), warmup=1, runs=3),
           bound(T * N + small + 9 * T + n_extra * 4 * T * N,
                 fit_cells * 2 * R + feas_cells * sops))
    record("propose_pick", pargs,
           time_ms(lambda: k2.propose_pick(*pargs)),
           time_ms(lambda: k2.propose_pick_plain(*pargs), warmup=1, runs=3),
           bound(scan_cells + small + 13 * T + n_extra * 4 * scan_cells,
                 scan_cells * 2 * R + scan_feas * sops))
    n_active = int((rargs[1] < N).sum())
    record("resolve", rargs,
           time_ms(lambda: k3.resolve(*rargs)),
           time_ms(lambda: k3.resolve_plain(*rargs)),
           bound(16 * T + n_active * R * 4 + N * R * 4 + 2 * T,
                 n_active * R * 3, F64_OPS_PER_S))
    accept, perm, s_node = aargs[2], aargs[0], aargs[1]
    n_acc = int(accept.sum())
    touched = int(torch.unique(s_node[accept[perm]]).numel())
    ka, pa = _fresh_apply_args(aargs), _fresh_apply_args(aargs)
    record("apply", aargs,
           time_ms(lambda: k3.apply(*ka)),
           time_ms(lambda: k3.apply_plain(*pa)),
           bound(17 * T + n_acc * (R * 4 + 8) + touched * R * 4 * 4,
                 n_acc * R, F64_OPS_PER_S))

    # K4, cycle 2's call (the cycle's final node_idle)
    fargs = rec.calls["failure_counts"][-1][2]
    record("failure_counts", fargs,
           time_ms(lambda: k4.failure_counts(*fargs)),
           time_ms(lambda: k4.failure_counts_plain(*fargs)),
           bound(T * N + T * R * 4 + N * R * 4 + N + (2 + R) * 4 * T,
                 T * N * (5 * R + 4)))
    pf, ins, fe = k4.failure_counts(*fargs)
    if not bool((ins > 0).any()):
        fail("main path: cycle 2's failure tallies found no insufficient node")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not os.path.isdir(os.path.join(ROOT, "kube_batch_tpu_torch", "kernels")):
        fail("kube_batch_tpu_torch not found beside chip_smoke.py; run it "
             "from the root of a checkout")
    sys.path.insert(0, ROOT)
    from kube_batch_tpu_torch.device import resolve_device

    device = resolve_device("cuda")
    phase_card_and_build()
    phase_parity()
    counts, rec = phase_main_path(device)
    records = phase_kernels(rec)

    kernels_line = []
    for name, (route, source, replaces) in KERNELS.items():
        r = records[name]
        kernels_line.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
