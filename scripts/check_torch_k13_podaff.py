#!/usr/bin/env python3
"""Build every CUDA kernel of the port and hold K13 (nodeorder's
pod-affinity score as a class table) and K2 (which reads it at each
task's class) against their plain versions on the card, on chip_smoke.py's
edge inputs (`phase_k13_edge`, `phase_k2_edge`, `phase_words_edge`);
then time K13 at the affinity path's shapes and, given a parent
checkout, an affinity round of the parent against this checkout.

    python3 scripts/check_torch_k13_podaff.py [--edge-only] [--parent PARENT]

Run from the root of a checkout on a machine with a CUDA card and nvcc
(`--edge-only`: a few minutes; with PARENT about ten more).  PARENT is
the root of a checkout of the parent commit (for example a `git archive`
unpacked into a directory that .gitignore lists).  Prints the card's name
and power limit, the build, one JSON line per edge case, then:

* `k13-timing`: K13 on `chip_smoke.k13_edge_inputs("affinity_shape")`
  (T = 65,536 tasks in C = 17 classes, N = 8,192, K = K2 = 32, D = 256):
  ms (CUDA events), device ms and device operations a call
  (torch.profiler over 50 calls) and host µs a call; the plain
  version's ms; the same function in library calls over the class rows
  and over every task's row (`chip_smoke.podaff_library`); the bound
  (`chip_smoke.podaff_bound`).
* `affinity-round-ab` (with PARENT): the affinity path (config 5 with
  affinity terms at full size, 2 cycles, chip_smoke's second wave after
  cycle 1) with its loops captured, in a fresh process run from each of
  PARENT, this checkout, this checkout, PARENT: per cycle the solve and
  wall ms, the auction rounds, ms a round, and in cycle 2 the card's time
  inside the round replays (CUDA events around each replay) and its ms
  a replay; the device nodes of each captured round graph; the peak of
  `torch.cuda.max_memory_allocated` over the two cycles; K13 launches.  A
  last line says whether every run made the same decisions (binds and
  ready jobs of every cycle, as sets).

Exits non-zero on the first difference.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _blocked in ("jax", "jaxlib", "flax", "kube_batch_tpu"):
    sys.modules[_blocked] = None


def _k1_k3():
    spec = importlib.util.spec_from_file_location(
        "check_torch_k1_k3", os.path.join(ROOT, "scripts", "check_torch_k1_k3.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k13_timing(device) -> None:
    import chip_smoke
    from kube_batch_tpu_torch.kernels import podaff_score as k13

    args = chip_smoke.k13_edge_inputs(device, "affinity_shape")
    classes = args[0]
    got, want = chip_smoke.podaff_pair(args)
    chip_smoke.require_equal("podaff_score at the affinity shape", [(got, want)])
    timing = _k1_k3().host_device(lambda: k13.podaff_score(*args))
    b = chip_smoke.podaff_bound(args)
    print(json.dumps({
        "phase": "k13-timing", "card": chip_smoke.CARD.get("line"),
        "tasks": classes.cls.shape[0], "classes": classes.C, "nodes": got.shape[1],
        "K": classes.rows.shape[1], "K2": classes.rows_topo.shape[1], **timing,
        "plain_ms": round(chip_smoke.time_ms(lambda: k13.podaff_score_plain(*args)), 4),
        "library_cn_ms": round(chip_smoke.time_ms(chip_smoke.podaff_library(args, False)), 4),
        "library_tn_ms": round(chip_smoke.time_ms(chip_smoke.podaff_library(args, True),
                                                  warmup=1, runs=3), 4),
        "bound_ms": round(b[0], 6), "bound_by": b[1]}), flush=True)


_ROUND = r"""
import itertools, json, sys, time
sys.path.insert(0, ".")
for _blocked in ("jax", "jaxlib", "flax", "kube_batch_tpu"):
    sys.modules[_blocked] = None
import torch
import chip_smoke
import kube_batch_tpu_torch.cache.cluster as cluster
from kube_batch_tpu_torch import kernels
from kube_batch_tpu_torch.ops import graphs
from kube_batch_tpu_torch.scheduler import Scheduler

chip_smoke.phase_card_and_build()
dev = torch.device("cuda")
cluster._uid_counter = itertools.count()
cache, sim = chip_smoke.config5_affinity()
sched = Scheduler(cache, device=dev)
graphs.reset_totals()
kernels.reset_counts()
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats(dev)
cycles = []
for cycle in range(2):
    replays, replay_ms = graphs.totals["replays"], graphs.totals["replay_ms"]
    graphs.TIME_REPLAYS = cycle == 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ssn = sched.run_once()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    graphs.TIME_REPLAYS = False
    st = sched.last_stats
    rounds = sum(st.get("allocate_rounds", [])) + sum(st.get("backfill_rounds", []))
    line = {"cycle": cycle + 1, "solve_ms": sched.last_timings["solve_ms"], "wall_ms": wall,
            "rounds": rounds, "ms_per_round": sched.last_timings["solve_ms"] / max(rounds, 1),
            "replays": graphs.totals["replays"] - replays,
            "binds": sorted(map(list, ssn.bound)),
            "ready": sorted(n for j, n in enumerate(ssn.meta.job_names) if ssn.job_ready[j])}
    if cycle == 1:
        dev_ms = graphs.totals["replay_ms"] - replay_ms
        line["replay_device_ms"] = dev_ms
        line["device_ms_per_replay"] = dev_ms / max(line["replays"], 1)
    cycles.append(line)
    sim.tick()
    if cycle == 0:
        chip_smoke.arrivals(cache, sim, chip_smoke.MAIN_WAVE_PODS)
counts = kernels.counts()
print("RESULT " + json.dumps({
    "cycles": cycles, "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
    "round_graph_nodes": graphs.totals["nodes"],
    "podaff_score_launches": counts.get("podaff_score")}))
"""


def affinity_round_ab(parent: str) -> None:
    decisions = []
    for i, tree in enumerate((parent, ROOT, ROOT, parent)):
        proc = subprocess.run([sys.executable, "-c", _ROUND], cwd=tree,
                              capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"{tree}: the affinity run failed")
        r = json.loads([x for x in proc.stdout.splitlines()
                        if x.startswith("RESULT ")][-1][len("RESULT "):])
        decisions.append([(c["binds"], c["ready"]) for c in r["cycles"]])
        print(json.dumps({
            "phase": "affinity-round-ab", "run": i,
            "tree": "parent" if tree == parent else "this",
            "cycles": [{k: (round(v, 4) if isinstance(v, float) else v)
                        for k, v in c.items() if k not in ("binds", "ready")}
                       | {"binds": len(c["binds"])} for c in r["cycles"]],
            "max_memory_allocated": r["max_memory_allocated"],
            "round_graph_nodes": r["round_graph_nodes"],
            "podaff_score_launches": r["podaff_score_launches"]}), flush=True)
    same = all(d == decisions[0] for d in decisions)
    print(json.dumps({"phase": "affinity-round-ab", "same_decisions": same}), flush=True)
    if not same:
        raise SystemExit("affinity-round-ab: the runs decided differently")


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke

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
    errs = {"podaff_score": chip_smoke.phase_k13_edge(device),
            **chip_smoke.phase_k2_edge(device), **chip_smoke.phase_words_edge(device)}
    print(json.dumps({"phase": "edge", "max_abs_err": errs}), flush=True)
    if not edge_only:
        k13_timing(device)
        if parent:
            affinity_round_ab(parent)
    torch.cuda.synchronize()
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
