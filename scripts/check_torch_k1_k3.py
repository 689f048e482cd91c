#!/usr/bin/env python3
"""Build every CUDA kernel of the port and hold K3 `resolve` (the whole of
`_resolve_conflicts` in one launch) and K1 `predicate_mask` (set tests on
bit words, 16-byte row stores) against their plain versions on the card,
on chip_smoke.py's edge inputs (`phase_k3_edge`, `phase_k1_edge`); then
time both on the rounds and calls of the port's paths and, given a parent
checkout, beside the parent's sequences.

    python3 scripts/check_torch_k1_k3.py [--edge-only] [--parent PARENT]

Run from the root of a checkout on a machine with a CUDA card and nvcc
(about five minutes; `--edge-only` stops after the edge phases, about a
minute).  PARENT is the root of a checkout of the parent commit (for
example a `git archive` unpacked into a directory that .gitignore lists);
its resolve.cu and predicate_mask.cu are built beside this checkout's.
Prints the card's name and power limit, the build and its ptxas report,
one JSON line per edge case, then, after recording chip_smoke's main path
(config 5 full, 2 cycles), affinity path and the preempt path's card run:

* `k1-timing`: K1 on the main path's cycle-2 call (T = 65,536, N =
  8,192), on chip_smoke.k1_edge_snap at the same shape with 33-column
  vocabularies and every predicate on, on chip_smoke.k1_hostname_snap
  (a label per node, 8,192 tasks and nodes: many tiles of used words)
  and on the parity feature world:
  this checkout's wrapper, its plain version, the reference's products
  by torch.matmul (`chip_smoke.predicate_matmul`) and with PARENT the
  parent's sequence (its miss-group glue and its kernel, built from
  PARENT's source), with chip_smoke.predicate_bound — every output equal.
* `k3-timing`: on the main path's round that chip_smoke times
  (`_pick_round`), the affinity path's last recorded round and the
  preempt path's round with the most eligible rows: this checkout's
  `ops/assignment.py · resolve_conflicts` (one K3 launch: the rank-order
  scatter and a sort by node), the plain version, and with PARENT the parent's resolve_conflicts (the key glue,
  a stable torch.sort, the parent's K3 kernel, the watermark glue and
  the cancelled count) — kept, perm, s_node and the count equal.  Each with ms (CUDA events),
  device ms and device operations a call (torch.profiler over 50 calls)
  and host µs a call (30 batches of 20 calls issued back to back: median
  and least), beside chip_smoke.resolve_bound.
* `k3-slope` (with PARENT): the parent's K3 kernel alone and this
  checkout's whole call on T = 65,536 rows of which a run of 1, 64,
  1,024, 4,096 or 16,384 proposers sits on one node.

Exits non-zero on the first difference.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _blocked in ("jax", "jaxlib", "flax", "kube_batch_tpu"):
    sys.modules[_blocked] = None

INT32_MAX = 2**31 - 1
SLOPE_RUNS = (1, 64, 1024, 4096, 16384)
P, I = ctypes.c_void_p, ctypes.c_int


def _module(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build_libs(device, sources: dict) -> dict:
    return _module("check_torch_k2_k8", os.path.join(
        ROOT, "scripts", "check_torch_k2_k8.py"))._build_libs(device, sources)


def host_device(fn) -> dict:
    """ms (CUDA events), device ms and device operations a call
    (torch.profiler over 50 calls; each kernel's ms also per recorded
    launch), host µs a call (30 batches of 20 calls issued back to back:
    the median and the least)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    for _ in range(5):
        fn()
    times = []
    for _ in range(30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        times.append((time.perf_counter() - t0) / 20)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    return {"ms": round(chip_smoke.time_ms(fn), 4),
            "device_ms": round(sum(e.device_time_total for e in events) / 50 / 1e3, 4),
            "device_operations": round(sum(e.count for e in events) / 50, 3),
            "device_ms_by_name": {e.key[:40]: round(e.device_time_total / 50 / 1e3, 4)
                                  for e in events},
            # the profiler may miss launches of a cluster kernel (K3 resolve:
            # 24 to 44 of 50 recorded), so a kernel's time is also given
            # per recorded launch
            "device_ms_per_launch_by_name": {
                e.key[:40]: round(e.device_time_total / max(e.count, 1) / 1e3, 4)
                for e in events},
            "host_us": round(float(np.median(times)) * 1e6, 2),
            "host_us_min": round(float(np.min(times)) * 1e6, 2)}


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def _parent_predicate(lib, snap, flags):
    """The parent's K1 call: its miss-group glue (a product and compares)
    and its kernel, through ctypes."""
    import torch

    from kube_batch_tpu_torch.kernels import build

    fn = lib.kb_predicate_mask
    fn.argtypes, fn.restype = [P, P, I, P, P, I, P, P, I, P, P, P, P, P, I, I, I, I, P, P], I
    T, N = snap.num_tasks, snap.num_nodes
    G = snap.task_vol_groups.shape[1]
    stream = build.stream_handle(snap.device)

    def call():
        miss = None
        if flags.volume and G:
            miss = (1.0 - ((snap.node_labels @ snap.vol_group_sel.T) > 0.5).float()).contiguous()
        out = torch.empty((T, N), dtype=torch.bool, device=snap.device)
        build.check(fn(
            build.ptr(snap.task_sel), build.ptr(snap.node_labels), snap.task_sel.shape[1],
            build.ptr(snap.task_tol), build.ptr(snap.node_taints), snap.task_tol.shape[1],
            build.ptr(snap.task_ports), build.ptr(snap.node_ports), snap.task_ports.shape[1],
            build.ptr(snap.node_ready), build.ptr(snap.node_pressure),
            build.ptr(snap.task_vol_node), build.ptr(snap.task_vol_groups), build.ptr(miss),
            G, T, N, flags.bits, build.ptr(out), stream), "parent predicate_mask")
        return out

    return call


def k1_timings(device, cases: dict, libs: dict) -> None:
    import chip_smoke

    from kube_batch_tpu_torch.kernels import predicate_mask as k1

    for name, (snap, flags) in cases.items():
        want = k1.predicate_mask_plain(snap, flags)
        calls = {"this": lambda: k1.predicate_mask(snap, flags),
                 "plain": lambda: k1.predicate_mask_plain(snap, flags),
                 "matmul": lambda: chip_smoke.predicate_matmul(snap, flags)}
        if "parent_predicate_mask" in libs:
            calls["parent"] = _parent_predicate(libs["parent_predicate_mask"], snap, flags)
        for who, call in calls.items():
            chip_smoke.require_equal(f"predicate_mask {name} {who}", [(call(), want)])
        b, W = chip_smoke.predicate_bound(snap)
        line = {"phase": "k1-timing", "case": name, "tasks": snap.num_tasks,
                "nodes": snap.num_nodes, "live_vocabulary_columns": W,
                "bound_ms": round(b[0], 6), "bound_by": b[1]}
        for who, call in calls.items():
            line[who] = host_device(call)
        print(json.dumps(line), flush=True)


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def _parent_resolve(lib, args):
    """The parent's resolve_conflicts on K3's arguments: the key glue, a
    stable torch.sort, the parent's K3 kernel through ctypes, the
    watermark glue and the cancelled count."""
    import torch

    from kube_batch_tpu_torch.kernels import build

    fn = lib.kb_resolve
    fn.argtypes, fn.restype = [P, P, P, P, P, P, I, I, I, I, P, P], I
    prop, active, rank, req, avail, eps, one_per_node, ser, cancelled = args
    T, (N, R) = rank.shape[0], avail.shape
    stream = build.stream_handle(rank.device)

    def call(counter=cancelled):
        node_key = torch.where(active, prop, N)
        s_key, perm = torch.sort(node_key.long() * T + rank.long(), stable=True)
        s_node = torch.div(s_key, T, rounding_mode="floor")
        accept = torch.zeros(T, dtype=torch.bool, device=rank.device)
        build.check(fn(build.ptr(perm), build.ptr(s_node), build.ptr(req), build.ptr(avail),
                       build.ptr(eps), build.ptr(ser), int(one_per_node), T, N, R,
                       build.ptr(accept), stream), "parent resolve")
        rejected = active & ~accept
        watermark = torch.where(rejected, rank, INT32_MAX).amin()
        kept = accept & (rank < watermark)
        if counter is not None:
            counter.narrow(0, 0, 1).add_(torch.count_nonzero(accept & ~kept))
        return kept, perm, s_node

    return call


def _same(name, got, want, counter_got, counter_want):
    """kept, perm and s_node (and the counters) equal."""
    import chip_smoke

    pairs = list(zip(got, want))
    if counter_got is not None:
        pairs.append((counter_got, counter_want))
    chip_smoke.require_equal(name, pairs)


def k3_timings(device, rounds: dict, libs: dict) -> None:
    import chip_smoke

    from kube_batch_tpu_torch.kernels import resolve as k3
    from kube_batch_tpu_torch.ops.assignment import resolve_conflicts

    for name, args in rounds.items():
        prop, active, rank, req, avail, eps, opn, ser, cancelled = args
        head = args[:8]
        counter = None if cancelled is None else cancelled.clone()
        want_counter = None if cancelled is None else cancelled.clone()
        want = k3.resolve_plain(*head, want_counter)
        variants = {
            "this": lambda c=None: resolve_conflicts(*head, cancelled=c),
            "plain": lambda c=None: k3.resolve_plain(*head, c),
        }
        if "parent_resolve" in libs:
            variants["parent"] = _parent_resolve(libs["parent_resolve"], args)
        for who, call in variants.items():
            c = None if counter is None else counter.clone()
            _same(f"resolve {name} {who}", call(c), want, c, want_counter)
        b = chip_smoke.resolve_bound(args)
        line = {"phase": "k3-timing", "round": name, "tasks": rank.shape[0],
                "blocks": k3.plan(rank.shape[0])[0],
                "nodes": avail.shape[0], "proposers": int(active.sum()),
                "longest_run": chip_smoke.longest_run(args), "kept": int(want[0].sum()),
                "serialize": ser is not None, "one_per_node": bool(opn),
                "bound_ms": round(b[0], 6), "bound_by": b[1]}
        for who, call in variants.items():
            c = None if counter is None else counter.clone()
            line[who] = host_device(lambda call=call, c=c: call(c))
        print(json.dumps(line), flush=True)


def slope_inputs(device, run: int, T: int = 65536, N: int = 8192):
    """K3's arguments with `run` proposers on node 0 and no others."""
    import torch

    g = torch.Generator().manual_seed(run)
    active = torch.zeros(T, dtype=torch.bool)
    rows = torch.randperm(T, generator=g)[:run]
    active[rows] = True
    prop = torch.zeros(T, dtype=torch.int32)
    rank = torch.randperm(T, generator=g).int()
    req = torch.randint(1, 9, (T, 4), generator=g).float() * torch.tensor(
        [500.0, float(1 << 30), 1.0, 1.0])
    avail = torch.full((N, 4), 0.0)
    avail[0] = req[rows].sum(dim=0) / 2
    args = (prop, active, rank, req, avail, torch.full((4,), 0.5), False, None,
            torch.zeros(3, dtype=torch.int64))
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)


def k3_slope(device, libs: dict) -> None:
    import torch

    import chip_smoke

    from kube_batch_tpu_torch.kernels import build
    from kube_batch_tpu_torch.kernels import resolve as k3

    fn = libs["parent_resolve"].kb_resolve
    fn.argtypes, fn.restype = [P, P, P, P, P, P, I, I, I, I, P, P], I
    for run in SLOPE_RUNS:
        args = slope_inputs(device, run)
        prop, active, rank, req, avail, eps = args[:6]
        T, (N, R) = rank.shape[0], avail.shape
        node_key = torch.where(active, prop, N)
        s_key, perm = torch.sort(node_key.long() * T + rank.long(), stable=True)
        s_node = torch.div(s_key, T, rounding_mode="floor")
        accept = torch.zeros(T, dtype=torch.bool, device=device)
        stream = build.stream_handle(device)

        def parent_k3():
            build.check(fn(build.ptr(perm), build.ptr(s_node), build.ptr(req),
                           build.ptr(avail), build.ptr(eps), None, 0, T, N, R,
                           build.ptr(accept), stream), "parent resolve")

        parent_k3()
        want = k3.prefix_accept_plain(perm, s_node, req, avail, eps, False, None)
        chip_smoke.require_equal(f"parent K3 run {run}", [(accept, want)])
        got, want3, _ = chip_smoke.resolve_pair(args)
        chip_smoke.require_equal(f"resolve run {run}", list(zip(got, want3)))
        print(json.dumps({"phase": "k3-slope", "tasks": T, "run": run,
                          "parent_k3_ms": round(chip_smoke.time_ms(parent_k3), 4),
                          "this_ms": round(chip_smoke.time_ms(
                              lambda: k3.resolve(*args[:8], None)), 4)}), flush=True)


# ---------------------------------------------------------------------------
# the recorded paths
# ---------------------------------------------------------------------------

def recorded(device):
    """(K1 cases, K3 rounds) from chip_smoke's main path, affinity path,
    the preempt path's card run and the parity feature world."""
    import torch

    import chip_smoke

    from kube_batch_tpu_torch.cache.packer import pack_snapshot_full
    from kube_batch_tpu_torch.kernels import predicate_mask as k1

    _counts, rec = chip_smoke.phase_main_path(device)
    main_args = rec.calls["predicate_mask"][-1][2]
    rounds = {"main": chip_smoke._pick_round(rec)[0]["resolve"]}
    del rec
    _counts, arec = chip_smoke.phase_affinity_path(device)
    rounds["affinity"] = arec.calls["resolve"][-1][2]
    del arec
    _cycles, prec, _cache, _ssn = chip_smoke.preempt_cycles("cuda", record=True)
    by_round = {}
    for name in ("propose_best", "resolve"):
        for cycle, rnd, args in prec.calls[name]:
            by_round.setdefault((cycle, rnd), {})[name] = args
    full = [r for r in by_round.values() if len(r) == 2]
    rounds["preempt"] = max(full, key=lambda r: int(r["propose_best"][6].sum()))["resolve"]
    del prec
    cache, _sim = chip_smoke._feature_world()
    fsnap, _meta, _internals = pack_snapshot_full(cache.snapshot(), device)
    all_on = k1.PredicateFlags(pressure=(True, True, True))
    cases = {"main": tuple(main_args),
             "live_vocabulary_33": (chip_smoke.k1_edge_snap(device, 65536, 8192, 33), all_on),
             "hostname_labels": (chip_smoke.k1_hostname_snap(device, 8192, 8192), all_on),
             "feature_world": (fsnap, k1.PredicateFlags())}
    torch.cuda.synchronize()
    return cases, rounds


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch

    parent, edge_only = None, False
    while argv:
        if argv[0] == "--parent" and len(argv) > 1:
            parent, argv = os.path.abspath(argv[1]), argv[2:]
        elif argv[0] == "--edge-only":
            edge_only, argv = True, argv[1:]
        else:
            chip_smoke.fail(f"usage: {sys.argv[0]} [--edge-only] [--parent PARENT]")
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false")
    device = torch.device("cuda")
    chip_smoke.phase_card_and_build()
    errs = {"resolve": chip_smoke.phase_k3_edge(device),
            "predicate_mask": chip_smoke.phase_k1_edge(device)}
    print(json.dumps({"phase": "edge", "max_abs_err": errs}), flush=True)
    if not edge_only:
        libs = {}
        if parent:
            csrc = os.path.join(parent, "kube_batch_tpu_torch", "kernels", "csrc")
            libs = _build_libs(device, {
                "parent_resolve": os.path.join(csrc, "resolve.cu"),
                "parent_predicate_mask": os.path.join(csrc, "predicate_mask.cu")})
        cases, rounds = recorded(device)
        k1_timings(device, cases, libs)
        k3_timings(device, rounds, libs)
        if libs:
            k3_slope(device, libs)
    torch.cuda.synchronize()
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
