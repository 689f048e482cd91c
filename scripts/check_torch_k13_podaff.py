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
* `k13-phases`: device ms a launch at the affinity shape of this
  checkout's K13 (and with PARENT, of PARENT's) built whole and cut after
  each of its phases (`K13_CUTS`): the launch, the loads, the present
  bits, (PARENT's) the class lists; each built from the tree's source
  with the package's nvcc flags into `.chip_proof/k13_build/` and run
  through a fresh copy of the tree's own wrapper.
* `k13-parent-timing` (with PARENT): PARENT's K13 built so, and this
  checkout's kernel on the same inputs (`affinity_shape` and `c_eq_t`),
  their tables equal, each timed in turns parent, this, this, parent:
  ms (CUDA events), device ms a launch and host µs a call, with this
  checkout's launch plan (`kernels/podaff_score.py · plan`).
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


# Where a kernel variant stops (`k13_phases`): per tree, each cut's name,
# the source line it goes before and what it inserts there, a return and
# a global store that keeps what the phases before it computed.  A tree
# whose source lacks an anchor (another version of the kernel) skips
# its cuts.
K13_CUTS = {
    "this": (("launch", "  const Smem s = carve<ONE>(smem, d);", "  if (d.C >= 0) return;\n"),
             ("loads", "  // 2. this node's present bits", "  if (d.C >= 0) return;\n"),
             ("present_bits", "  // 3. each chunk of classes",
              "  if (pr0 == 0x9e3779b9u && hb0 == 7u) out[0] = 0.f;\n"
              "  if (d.C >= 0) return;\n")),
    "parent": (("launch", "  uint32_t* s_hb = reinterpret_cast<uint32_t*>(smem);",
                "  if (a.C >= 0) return;\n"),
               ("present_bits", "  const int chunks = (a.C + a.CC - 1) / a.CC;",
                "  if (s_pr[tid] == 0x9e3779b9u) a.out[0] = 0.f;\n  if (a.C >= 0) return;\n"),
               ("lists", "    if (!live) continue;",
                "    if (s_nn[0] == 0x7fffffff) a.out[0] = 0.f;\n    if (a.C >= 0) return;\n")),
}


def _k13_wrappers(trees: dict) -> dict:
    """{(tree, cut): K13 wrapper}: each tree's `kernels/podaff_score.py ·
    podaff_score` (a fresh copy of the module) with its C entry taken from
    a library built from the tree's `csrc/podaff_score.cu` (cut = "full")
    and from each variant of K13_CUTS[tree]; every library
    built with the package's nvcc flags, all at once, into
    .chip_proof/k13_build/."""
    import ctypes
    import types

    from kube_batch_tpu_torch.kernels import build

    out_dir = os.path.join(ROOT, ".chip_proof", "k13_build")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for tree, root in trees.items():
        kernels = os.path.join(root, "kube_batch_tpu_torch", "kernels")
        with open(os.path.join(kernels, "csrc", "podaff_score.cu")) as f:
            text = f.read()
        variants = {"full": text}
        for cut, anchor, insert in K13_CUTS[tree]:
            if text.count(anchor) == 1:
                variants[cut] = text.replace(anchor, insert + anchor)
        for cut, body in variants.items():
            src = os.path.join(out_dir, f"{tree}_{cut}.cu")
            with open(src, "w") as f:
                f.write(body)
            lib = src[:-3] + ".so"
            procs[tree, cut] = (os.path.join(kernels, "podaff_score.py"), lib, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    wrappers = {}
    for (tree, cut), (module_path, lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for K13 {tree} {cut}:\n{log}")
        spec = importlib.util.spec_from_file_location(f"k13_{tree}_{cut}", module_path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        loaded = ctypes.CDLL(lib)

        def function(name, symbol, argtypes, loaded=loaded):
            fn = getattr(loaded, symbol)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
            return fn

        mod.build = types.SimpleNamespace(function=function, ptr=build.ptr, check=build.check,
                                          stream_handle=build.stream_handle)
        wrappers[tree, cut] = mod.podaff_score
    return wrappers


def k13_phases(device, wrappers: dict) -> None:
    """Device ms a launch of each tree's K13 cut after each phase, at the
    affinity shape: where a launch's time goes."""
    import dataclasses

    import torch

    import chip_smoke

    host_device = _k1_k3().host_device
    args = chip_smoke.k13_edge_inputs(device, "affinity_shape")
    classes, rest = args[0], args[1:]
    for tree in sorted({t for t, _ in wrappers}):
        ms = {}
        for (t, cut), fn in wrappers.items():
            if t == tree:
                mine = dataclasses.replace(classes, out=torch.empty_like(classes.out))
                ms[cut] = host_device(lambda: fn(mine, *rest))["device_ms"]
        print(json.dumps({"phase": "k13-phases", "tree": tree,
                          "card": chip_smoke.CARD.get("line"), "device_ms": ms}), flush=True)


def k13_parent_timing(device, parent_call) -> None:
    import dataclasses

    import torch

    import chip_smoke
    from kube_batch_tpu_torch.kernels import podaff_score as k13

    host_device = _k1_k3().host_device
    for case in ("affinity_shape", "c_eq_t"):
        args = chip_smoke.k13_edge_inputs(device, case)
        classes, rest = args[0], args[1:]
        mine = dataclasses.replace(classes, out=torch.empty_like(classes.out))
        theirs = dataclasses.replace(classes, out=torch.empty_like(classes.out))
        calls = {"parent": lambda: parent_call(theirs, *rest),
                 "this": lambda: k13.podaff_score(mine, *rest)}
        chip_smoke.require_equal(f"podaff_score {case} parent",
                                 [(calls["this"](), calls["parent"]())])
        runs = [(who, host_device(calls[who])) for who in ("parent", "this", "this", "parent")]
        print(json.dumps({
            "phase": "k13-parent-timing", "case": case, "card": chip_smoke.CARD.get("line"),
            "tasks": classes.cls.shape[0], "classes": classes.C, "nodes": rest[0].shape[0],
            "plan": k13.plan(*args[:4]),
            "runs": [{"tree": who, **{k: t[k] for k in ("ms", "device_ms",
                                                         "device_operations", "host_us",
                                                         "host_us_min")}}
                     for who, t in runs]}), flush=True)
        del args, classes, rest, mine, theirs, calls


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
        wrappers = _k13_wrappers({"this": ROOT, **({"parent": parent} if parent else {})})
        k13_phases(device, wrappers)
        if parent:
            k13_parent_timing(device, wrappers["parent", "full"])
            affinity_round_ab(parent)
    torch.cuda.synchronize()
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
