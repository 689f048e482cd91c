#!/usr/bin/env python3
"""Build every CUDA kernel of the port and hold K5 `victim_prefix` (the
opening step's node choice in one launch) and K2's pass 2 (one chunk
rescored a row, from pass 1's tie summaries) against their plain versions
on the card, on chip_smoke.py's edge inputs (`phase_k5_edge`,
`phase_k2_edge`, `phase_words_edge`); then time both beside other designs
and, given a parent checkout, beside the parent's kernels.

    python3 scripts/check_torch_k5_pick.py [--parent PARENT]

Run from the root of a checkout on a machine with a CUDA card and nvcc
(a few minutes).  PARENT is the root of a checkout of the parent commit
(for example a `git archive` unpacked into a directory that .gitignore
lists).  Prints the card's name and power limit, the build and its
ptxas report, one JSON line per edge case, then:

* `k5-timing`: K5 on chip_smoke.k5_edge_inputs at the preempt path's
  width (T = 8,192, N = 512; about 5,000 candidate victims, runs of up
  to 21) and with one node holding 1,000 victims: this checkout's call
  on its own route (counting sort, or radix past LONG_RUN) and forced to
  the radix route (the two sort designs), the plain version, and with
  PARENT the parent's node choice (the where, the subtraction, the
  parent's K8 sort_by_segment, the mask and the parent's K5 kernel, both
  built from PARENT's sources) — every output equal.
* `k5-host`: per tree, in a fresh process run from it (PARENT, this
  checkout, this checkout, PARENT), the node choice as that tree's
  evict_step makes it at T = 8,192, N = 512: ms (CUDA events), device
  ms by kernel (torch.profiler over 50 calls) and host µs a call (30
  batches of 20 calls issued back to back: the median and the least).
* `pick-timing`: K2's two passes at T = 65,536 and N = 8,192 (the main
  path's widths) on chip_smoke.k2_words_inputs, the mask form with all,
  23 %, 7.5 % and 1 % of the rows eligible and the words form with 23 %,
  7.5 % and 1 %: this checkout's kernels (`this`), the other size of
  tie summary (`chunk32`: one per warp's 32 nodes, pass 2 rescoring 32
  cells, or `chunk256`: one per 256-node tile; built from this
  checkout's `propose.cu` by text substitution) and with PARENT the
  parent's two passes (its pass 2 rescores each row from node 0 to its
  tie), all through the same ctypes calls with their launch arguments
  made once, beside this checkout's wrappers as the rounds call them
  (`wrapper_best_ms`, `wrapper_ms`) and pass 2 beside
  chip_smoke.propose_pick_bound — every output equal.

Times are medians of CUDA-event runs (chip_smoke.time_ms) unless said.
Exits non-zero on the first difference.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _blocked in ("jax", "jaxlib", "flax", "kube_batch_tpu"):
    sys.modules[_blocked] = None

K5_SHAPE = (8192, 512)       # (T, N): the preempt path's
K5_CASES = ("random", "long_run")
PICK_SHAPE = (65536, 8192)   # (T, N): the main path's
PICK_CASES = (("mask", 1.0), ("mask", 0.23), ("mask", 0.075), ("mask", 0.01),
              ("words", 0.23), ("words", 0.075), ("words", 0.01))
HOST_ROUNDS = 1   # parent, this, this, parent
# the other summary size, by the one this checkout's propose.cu keeps
CHUNK_VARIANTS = {
    "chunk32": ("constexpr int CHUNK_N = TILE_N;", "constexpr int CHUNK_N = WARP_N;"),
    "chunk256": ("constexpr int CHUNK_N = WARP_N;", "constexpr int CHUNK_N = TILE_N;"),
}


def _module(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _checks():
    """scripts/check_torch_k2_k8.py, for its `_build_libs`."""
    return _module("check_torch_k2_k8", os.path.join(ROOT, "scripts", "check_torch_k2_k8.py"))


def _variant_source() -> tuple[str, str]:
    """(name, path) of propose.cu built with the other summary size:
    per warp's 32 nodes when this checkout keeps one per node tile, and
    the other way round."""
    from kube_batch_tpu_torch.kernels import build

    with open(os.path.join(build.CSRC, "propose.cu")) as f:
        text = f.read()
    name, (old, new) = next((n, sub) for n, sub in CHUNK_VARIANTS.items()
                            if text.count(sub[0]) == 1)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    path = os.path.join(build.BUILD_DIR, f"variant_{name}.cu")
    with open(path, "w") as f:
        f.write(text.replace(old, new))
    return name, path


def _parent_choice(libs, device, args):
    """The parent's node choice on K5's arguments: its evict_step's
    glue around the parent's K8 sort and K5 kernel, through ctypes."""
    import torch

    from kube_batch_tpu_torch.kernels import build
    from kube_batch_tpu_torch.kernels import lex_rank as k8

    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    sort = libs["parent_lex_rank"].kb_sort_by_segment
    sort.argtypes, sort.restype = k8._SIGNATURES["kb_sort_by_segment"], ctypes.c_int
    k5 = libs["parent_victim_prefix"].kb_victim_prefix
    k5.argtypes, k5.restype = [P, P, P, P, P, P, P, L, I, I, P, P, P], ctypes.c_int
    (victims, task_node, rank, req, future, eps, p, preq_rows, pred, node_ok, excl,
     dyn) = args
    T, (N, R) = victims.shape[0], future.shape
    preq = preq_rows[p]
    code_bytes, bits, passes = k8.sort_plan(T, N)
    stream = build.stream_handle(device)

    def call():
        vnode = torch.where(victims, task_node, N)
        sac = T - 1 - rank
        perm = torch.empty(T, dtype=torch.int64, device=device)
        s_node = torch.empty(T, dtype=torch.int64, device=device)
        build.check(sort(build.ptr(vnode), build.ptr(sac), T, code_bytes, bits, passes, None,
                         build.ptr(perm), build.ptr(s_node), stream), "parent sort")
        ok = pred[p] & node_ok & ~excl
        if dyn is not None:
            ok = ok & dyn
        k = torch.empty(N, dtype=torch.int32, device=device)
        out = torch.empty(5, dtype=torch.int32, device=device)
        build.check(k5(build.ptr(perm), build.ptr(s_node), build.ptr(req), build.ptr(future),
                       build.ptr(preq), build.ptr(eps), build.ptr(ok), T, N, R, build.ptr(k),
                       build.ptr(out), stream), "parent victim_prefix")
        return torch.cat([k, out])

    return call


def k5_timings(device, parent: str | None) -> None:
    import chip_smoke

    from kube_batch_tpu_torch.kernels import victim_prefix as k5

    libs = {}
    if parent:
        csrc = os.path.join(parent, "kube_batch_tpu_torch", "kernels", "csrc")
        libs = _checks()._build_libs(device, {
            "parent_lex_rank": os.path.join(csrc, "lex_rank.cu"),
            "parent_victim_prefix": os.path.join(csrc, "victim_prefix.cu")})
    for case in K5_CASES:
        args = chip_smoke.k5_edge_inputs(device, *K5_SHAPE, case)
        want = k5.victim_prefix_plain(*args)
        calls = {"ms": lambda: k5.victim_prefix(*args),
                 "radix_route_ms": lambda: k5.victim_prefix(*args, route=k5.ROUTE_RADIX)}
        if libs:
            calls["parent_ms"] = _parent_choice(libs, device, args)
        for name, call in calls.items():
            chip_smoke.require_equal(f"victim_prefix {case} {name}", [(call(), want)])
        line = {"phase": "k5-timing", "case": case, "tasks": K5_SHAPE[0],
                "nodes": K5_SHAPE[1], **chip_smoke.victim_prefix_work(args)}
        for name, call in calls.items():
            line[name] = round(chip_smoke.time_ms(call), 4)
        line["plain_ms"] = round(chip_smoke.time_ms(lambda: k5.victim_prefix_plain(*args)), 4)
        b = chip_smoke.victim_prefix_bound(args)
        line.update(bound_ms=round(b[0], 6), bound_by=b[1])
        print(json.dumps(line), flush=True)


def k5_host() -> None:
    """One process's `k5-host` line, for the checkout it runs from: the
    node choice as that checkout's evict_step makes it."""
    import inspect
    import types

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kube_batch_tpu_torch.kernels import build
    from kube_batch_tpu_torch.kernels import victim_prefix as k5
    from kube_batch_tpu_torch.ops import preemption

    smoke = _module("smoke_of_check", os.path.join(ROOT, "chip_smoke.py"))
    build.build_all(("lex_rank", "victim_prefix"))
    device = torch.device("cuda")
    args = smoke.k5_edge_inputs(device, *K5_SHAPE, "random")
    (victims, task_node, rank, req, future, eps, p, preq_rows, pred, node_ok, excl,
     dyn) = args
    if len(inspect.signature(k5.victim_prefix).parameters) >= 12:
        def choose():
            return k5.victim_prefix(*args)
    else:
        snap = types.SimpleNamespace(task_node=task_node, task_req=req)
        preq = preq_rows[p]   # evict_step takes it before the branch

        def choose():
            ok = pred[p] & node_ok & ~excl
            if dyn is not None:
                ok = ok & dyn
            return preemption.min_victims_per_node(snap, future, victims, rank, preq, eps, ok)

    with profile(activities=[ProfilerActivity.CUDA]):   # the tracer's start-up
        torch.zeros(1, device=device).add_(1)
        torch.cuda.synchronize()
    for _ in range(20):
        choose()
    times = []
    for _ in range(30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            choose()
        times.append((time.perf_counter() - t0) / 20)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            choose()
        torch.cuda.synchronize()
    kernel_ms = {e.key[:40]: round(e.device_time_total / 50 / 1e3, 4)
                 for e in prof.key_averages() if e.device_time_total > 0}
    print(json.dumps({"phase": "k5-host", "tree": os.getcwd(),
                      "ms": round(smoke.time_ms(choose), 4), "device_ms": kernel_ms,
                      "device_total_ms": round(sum(kernel_ms.values()), 4),
                      "device_operations": sum(e.count for e in prof.key_averages()
                                               if e.device_time_total > 0) / 50,
                      "host_us": round(float(np.median(times)) * 1e6, 2),
                      "host_us_min": round(float(np.min(times)) * 1e6, 2)}), flush=True)


def k5_host_runs(parent: str | None) -> None:
    trees = [parent, ROOT, ROOT, parent] * HOST_ROUNDS if parent else [ROOT]
    for tree in trees:
        env = dict(os.environ, PYTHONPATH=tree)
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--k5-host"],
                             cwd=tree, env=env, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise RuntimeError(f"k5-host in {tree} failed:\n{out.stdout}\n{out.stderr}")
        print(out.stdout, end="", flush=True)


def _design_calls(lib, device, a, scratch, takes_scratch: bool):
    """(pass 1, pass 2 given (best, active, k)) through `lib`'s
    kb_propose_best / kb_propose_pick on the arguments `a`, with the
    launch arguments and outputs made once, so that every design is
    timed through the same calls (the parent's pass 2 takes no
    scratch).  Pass 1 returns (best, ties, active), pass 2 the node."""
    import torch

    from kube_batch_tpu_torch.kernels import build
    from kube_batch_tpu_torch.kernels import propose as k2

    best_fn, pick_fn = lib.kb_propose_best, lib.kb_propose_pick
    best_fn.argtypes, best_fn.restype = k2._SIGNATURES["kb_propose_best"], ctypes.c_int
    sig = k2._SIGNATURES["kb_propose_pick"]
    pick_fn.argtypes = sig if takes_scratch else sig[:-2] + [ctypes.c_void_p]
    pick_fn.restype = ctypes.c_int
    la, keep = k2._launch_args(*a)
    T = a[2].shape[0]
    outs = [torch.empty(T, dtype=dt, device=device)
            for dt in (torch.float32, torch.int32, torch.bool)]
    prop = torch.empty(T, dtype=torch.int32, device=device)
    stream = build.stream_handle(device)
    extra = [build.ptr(scratch)] if takes_scratch else []

    def pass1():
        build.check(best_fn(*la, *(build.ptr(x) for x in outs), build.ptr(scratch), stream),
                    "propose_best (design)")
        return outs

    def pass2(best, active, k):
        build.check(pick_fn(*la, build.ptr(best), build.ptr(active), build.ptr(k),
                            build.ptr(prop), *extra, stream), "propose_pick (design)")
        return prop

    pass1.keep = keep   # the launch arguments' tensors live as long as the calls
    return pass1, pass2


def pick_timings(device, parent: str | None) -> None:
    import chip_smoke
    import numpy as np
    import torch

    from kube_batch_tpu_torch.kernels import affinity as k10
    from kube_batch_tpu_torch.kernels import build
    from kube_batch_tpu_torch.kernels import propose as k2

    variant, source = _variant_source()
    sources = {variant: source}
    if parent:
        sources["parent"] = os.path.join(parent, "kube_batch_tpu_torch", "kernels", "csrc",
                                         "propose.cu")
    libs = {"this": build.library("propose"), **_checks()._build_libs(device, sources)}
    args, fields, resident = chip_smoke.k2_words_inputs(device, *PICK_SHAPE, K=32, K2=32)
    tw = k10.affinity_task_words(*fields[:5])
    words = k10.affinity_words(tw, fields[5], fields[6], fields[7], resident)
    T, N = args[0].shape
    # the largest layout, summaries per 32 nodes (the parent's need less)
    big = k2.best_scratch_bytes(T, N, 32)
    rng = np.random.default_rng(3)
    for form, share in PICK_CASES:
        a = list(args)
        a[1] = words if form == "words" else None
        a[6] = torch.from_numpy(rng.random(T) < share).to(device)
        scratch = k2.best_scratch(T, N, device)
        best, ties, active = k2.propose_best(*a, scratch)
        k = torch.remainder(torch.arange(T, device=device, dtype=torch.int32),
                            torch.clamp(ties, min=1))
        prop = k2.propose_pick(*a, best, active, k, scratch)
        chip_smoke.require_equal(f"propose_pick {form} {share}",
                                 [(prop, k2.propose_pick_plain(*a, best, active, k))])
        line = {"phase": "pick-timing", "form": form, "tasks": T, "nodes": N,
                "eligible": int(a[6].sum()), "active": int(active.sum()),
                "multi_tie_rows": int((active & (ties > 1)).sum()),
                "wrapper_best_ms": round(chip_smoke.time_ms(
                    lambda: k2.propose_best(*a, scratch)), 4),
                "wrapper_ms": round(chip_smoke.time_ms(
                    lambda: k2.propose_pick(*a, best, active, k, scratch)), 4)}
        for name, lib in libs.items():
            other_scratch = torch.empty(big, dtype=torch.uint8, device=device)
            pass1, pass2 = _design_calls(lib, device, a, other_scratch, name != "parent")
            chip_smoke.require_equal(f"propose_best {name} {form} {share}",
                                     list(zip(pass1(), (best, ties, active))))
            chip_smoke.require_equal(f"propose_pick {name} {form} {share}",
                                     [(pass2(best, active, k), prop)])
            line[f"{name}_best_ms"] = round(chip_smoke.time_ms(pass1), 4)
            line[f"{name}_ms"] = round(chip_smoke.time_ms(lambda: pass2(best, active, k)), 4)
        _feas, scan, scan_feas = chip_smoke._work_counts(a, prop, active)
        b = chip_smoke.propose_pick_bound(a + [best, active, k], scan, scan_feas)
        line.update(bound_ms=round(b[0], 6), bound_by=b[1], pick_cells=scan)
        print(json.dumps(line), flush=True)


def main(argv) -> int:
    if argv[:1] == ["--k5-host"]:
        sys.path.insert(0, os.getcwd())
        k5_host()
        return 0
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch

    parent = None
    if argv[:1] == ["--parent"]:
        parent = os.path.abspath(argv[1])
    elif argv:
        chip_smoke.fail(f"usage: {sys.argv[0]} [--parent PARENT]")
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false")
    device = torch.device("cuda")
    chip_smoke.phase_card_and_build()
    errs = {"victim_prefix": chip_smoke.phase_k5_edge(device)}
    errs.update(chip_smoke.phase_k2_edge(device))
    words = chip_smoke.phase_words_edge(device)
    errs = {k: max(v, words.get(k, 0.0)) for k, v in errs.items()}
    print(json.dumps({"phase": "edge", "max_abs_err": errs}), flush=True)
    k5_timings(device, parent)
    pick_timings(device, parent)
    torch.cuda.synchronize()
    k5_host_runs(parent)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
