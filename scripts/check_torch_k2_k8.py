#!/usr/bin/env python3
"""Build every CUDA kernel of the port and hold K2's pass 1
(`propose_best`, eligible rows only) and K8's one-launch `vtime` against
their plain versions on the card, on chip_smoke.py's edge inputs
(`phase_k2_edge`, `phase_vtime_edge`, `phase_words_edge`); then time both
at full width, beside other designs of pass 1 and, given a parent
checkout, beside the parent's kernels.

    python3 scripts/check_torch_k2_k8.py [--parent PARENT]

Run from the root of a checkout on a machine with a CUDA card and nvcc:
the quick first call after editing `kernels/csrc/propose.cu` or
`lex_rank.cu` (a few minutes).  PARENT is the root of a checkout of the
parent commit (for example a `git archive` unpacked into a directory
that .gitignore lists).  Prints the card's name and power limit, the
build and its ptxas report, one JSON line per edge case, then:

* `k2-timing`: `propose_best` at T = 65,536 and N = 8,192 (the main
  path's widths) on chip_smoke.k2_words_inputs (random requests, 81
  request classes), in the mask form with all, 23 %, 7.5 % and 1 % of
  the rows eligible and in the words form (32 labels and terms) with
  23 %, 7.5 % and 1 %, each beside its eligible-row bound
  (chip_smoke.propose_best_bound) and beside two other designs built
  from this checkout's `propose.cu` by text substitution (`VARIANTS`):
  `no_split` (a block a row group over every node: a grid of
  ceil(T / 32) blocks, those past the eligible list exiting at once) and
  `persistent` (a grid of as many blocks as are resident at once,
  looping over the work items); with PARENT, the parent's pass 1 too.
  Every design's outputs must equal this checkout's.
* `vtime-timing`: `virtual_start_times` at 8,192 rows (one launch) and
  65,536 rows (the sort and the tail), each beside its plain version;
  with PARENT, the parent's sort and tail at 8,192 rows.
* `vtime-host`: the ms of one `virtual_start_times` call (CUDA events,
  as chip_smoke.time_ms times it), its device ms by kernel
  (torch.profiler over 50 calls) and its host µs (over 30
  batches of 20 calls issued back to back, each batch started with the
  card idle: the median, and the least, which other load on the host
  inflates least), and the part of it that the segment key and
  `sort_by_segment` take, at (65,536 rows, 4,096 segments, none
  valid: the main path's widest call), (65,536, 3, 20 % valid) and
  (8,192, 500, 10 %: the preempt path's width), with drf's broadcast
  denominator; then `vtime-host-profile`: cProfile's own time per call
  of the ten costliest functions at 65,536 rows and 4,096 segments.
  Each in a fresh process run from this checkout, or (HOST_ROUNDS
  times) from PARENT, this checkout, this checkout and PARENT.

Times are medians of CUDA-event runs (chip_smoke.time_ms) unless said.
Exits non-zero on the first difference.
"""

from __future__ import annotations

import cProfile
import json
import os
import pstats
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _blocked in ("jax", "jaxlib", "flax", "kube_batch_tpu"):
    sys.modules[_blocked] = None

K2_SHAPE = (65536, 8192)                   # (T, N) of the K2 timings
K2_CASES = (("mask", 1.0), ("mask", 0.23), ("mask", 0.075), ("mask", 0.01),
            ("words", 0.23), ("words", 0.075), ("words", 0.01))
VTIME_SHAPES = ((8192, 250), (65536, 3))   # (T, S) of the vtime timings
VTIME_HOST_CASES = ((65536, 4096, 0.0), (65536, 3, 0.2), (8192, 500, 0.1))
HOST_ROUNDS = 2   # parent, this, this, parent: the host's load drifts

# Other designs of pass 1, as (old, new) substitutions in propose.cu.
VARIANTS = {
    "no_split": [("constexpr int ITEMS_TARGET = 1024;",
                  "constexpr int ITEMS_TARGET = 1;")],
    "persistent": [(
        "  const int grid = groups > split ? groups : split;\n",
        "  int per_sm = 0, dev = 0, sms = 0;\n"
        "  const int occ = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n"
        "      &per_sm, propose_best_kernel<W>, THREADS, smem);\n"
        "  if (occ) return occ;\n"
        "  cudaGetDevice(&dev);\n"
        "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
        "  const int grid = (per_sm > 0 ? per_sm : 1) * sms;\n")],
}


def _build_libs(device, sources: dict) -> dict:
    """Compile each {name: .cu path} with the package's nvcc flags, all at
    once; the loaded libraries by name."""
    import ctypes

    from kube_batch_tpu_torch.kernels import build

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        out = os.path.join(build.BUILD_DIR, f"check_{name}.so")
        procs[name] = (subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, src],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for name, (p, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(out)
    return libs


def _variant_sources() -> dict:
    from kube_batch_tpu_torch.kernels import build

    with open(os.path.join(build.CSRC, "propose.cu")) as f:
        base = f.read()
    out = {}
    for name, subs in VARIANTS.items():
        text = base
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not in propose.cu once")
            text = text.replace(old, new)
        path = os.path.join(build.BUILD_DIR, f"variant_{name}.cu")
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
        out[name] = path
    return out


def _pass1_caller(lib, device):
    """propose_best through `lib`'s kb_propose_best, given a scratch of
    this checkout's size (at least what any earlier tree needs)."""
    import ctypes

    import torch

    from kube_batch_tpu_torch.kernels import build
    from kube_batch_tpu_torch.kernels import propose as k2

    fn = lib.kb_propose_best
    sig = k2._SIGNATURES["kb_propose_best"]
    fn.argtypes = sig
    fn.restype = ctypes.c_int

    def call(*args):
        la, _keep = k2._launch_args(*args)
        T, N = args[2].shape[0], args[3].shape[0]
        best = torch.empty(T, dtype=torch.float32, device=device)
        ties = torch.empty(T, dtype=torch.int32, device=device)
        active = torch.empty(T, dtype=torch.bool, device=device)
        scratch = k2.best_scratch(T, N, device)
        build.check(fn(*la, build.ptr(best), build.ptr(ties), build.ptr(active), build.ptr(scratch),
                       build.stream_handle(device)), "propose_best (other design)")
        return best, ties, active

    return call


def k2_timings(device, parent: str | None) -> None:
    import chip_smoke
    import numpy as np
    import torch

    from kube_batch_tpu_torch.kernels import affinity as k10
    from kube_batch_tpu_torch.kernels import propose as k2

    sources = _variant_sources()
    if parent:
        sources["parent"] = os.path.join(parent, "kube_batch_tpu_torch", "kernels", "csrc",
                                         "propose.cu")
    libs = _build_libs(device, sources)
    others = {name: _pass1_caller(lib, device) for name, lib in libs.items()}
    args, fields, resident = chip_smoke.k2_words_inputs(device, *K2_SHAPE, K=32, K2=32)
    tw = k10.affinity_task_words(*fields[:5])
    words = k10.affinity_words(tw, fields[5], fields[6], fields[7], resident)
    T, N = args[0].shape
    rng = np.random.default_rng(3)
    for form, share in K2_CASES:
        a = list(args)
        a[1] = words if form == "words" else None
        a[6] = torch.from_numpy(rng.random(T) < share).to(device)
        scratch = k2.best_scratch(T, N, device)
        got = k2.propose_best(*a, scratch)
        chip_smoke.require_equal(f"propose_best {form} {share}",
                                 list(zip(got, k2.propose_best_plain(*a))))
        for name, call in others.items():
            chip_smoke.require_equal(f"propose_best {name} {form} {share}",
                                     list(zip(call(*a), got)))
        best, ties, active = got
        prop = k2.propose_pick(*a, best, active,
                               torch.remainder(torch.arange(T, device=device,
                                                            dtype=torch.int32),
                                               torch.clamp(ties, min=1)), scratch)
        feas, _scan, _scan_feas = chip_smoke._work_counts(a, prop, active)
        b = chip_smoke.propose_best_bound(a, feas)
        eligible = int(a[6].sum())
        line = {"phase": "k2-timing", "form": form, "tasks": T, "nodes": N,
                "eligible": eligible, "eligible_share": round(eligible / T, 6),
                "request_classes": chip_smoke.request_classes(a),
                "active": int(active.sum()),
                "ms": round(chip_smoke.time_ms(lambda: k2.propose_best(*a)), 4)}
        for name, call in others.items():
            line[f"{name}_ms"] = round(chip_smoke.time_ms(lambda: call(*a)), 4)
        line.update(bound_ms=round(b[0], 6), bound_by=b[1])
        print(json.dumps(line), flush=True)


def _parent_vtime(lib, device, args):
    """The parent's virtual_start_times: segment key, its sort, its tail."""
    import ctypes

    import torch

    from kube_batch_tpu_torch.kernels import build
    from kube_batch_tpu_torch.kernels import lex_rank as k8

    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    sort = lib.kb_sort_by_segment
    sort.argtypes, sort.restype = k8._SIGNATURES["kb_sort_by_segment"], ctypes.c_int
    tail = lib.kb_vtime
    tail.argtypes = [P, P, P, P, L, I, P, P, I, P, P, P, P]
    tail.restype = ctypes.c_int
    seg, base_rank, req, valid, alloc, denom, S = args
    T, R = req.shape

    def call():
        perm = torch.empty(T, dtype=torch.int64, device=device)
        s_seg = torch.empty(T, dtype=torch.int64, device=device)
        code_bytes, bits, passes = k8.sort_plan(T, S)
        seg32 = k8.segment_key(seg, valid, S).to(torch.int32)
        build.check(sort(build.ptr(seg32), build.ptr(base_rank), T, code_bytes, bits, passes,
                         None, build.ptr(perm), build.ptr(s_seg),
                         build.stream_handle(device)), "parent sort")
        out = torch.empty(T, dtype=torch.float32, device=device)
        tiles = -(-T // k8.VT_TILE)
        scratch = torch.empty((tiles + T) * R, dtype=torch.float64, device=device)
        build.check(tail(build.ptr(perm), build.ptr(s_seg), build.ptr(req), build.ptr(valid),
                         T, R, build.ptr(alloc.contiguous()), build.ptr(denom.contiguous()),
                         S, build.ptr(scratch), build.ptr(scratch[tiles * R:]),
                         build.ptr(out), build.stream_handle(device)), "parent vtime")
        return out

    return call


def vtime_timings(device, parent: str | None) -> None:
    import chip_smoke
    import numpy as np
    import torch

    from kube_batch_tpu_torch.framework.policy import virtual_start_times
    from kube_batch_tpu_torch.kernels import lex_rank as k8

    lib = None
    if parent:
        lib = _build_libs(device, {"parent_lex_rank": os.path.join(
            parent, "kube_batch_tpu_torch", "kernels", "csrc", "lex_rank.cu")})[
                "parent_lex_rank"]
    rng = np.random.default_rng(5)
    for T, S in VTIME_SHAPES:
        R = 4

        def on(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        args = (on(rng.integers(0, S, T).astype(np.int32)),
                on(rng.permutation(T).astype(np.int32)),
                on(rng.integers(0, 4000, (T, R)).astype(np.float32)),
                on(rng.random(T) < 0.3),
                on(rng.integers(0, 100000, (S, R)).astype(np.float32)),
                on(rng.integers(1, 900000, (S, R)).astype(np.float32)), S)
        chip_smoke.require_equal(f"vtime {T}", [(k8.vtime(*args), k8.vtime_plain(*args))])
        line = {"phase": "vtime-timing", "rows": T, "segments": S,
                "one_launch": T <= k8.CTA_MAX_T,
                "ms": round(chip_smoke.time_ms(lambda: virtual_start_times(*args)), 4),
                "plain_ms": round(chip_smoke.time_ms(lambda: k8.vtime_plain(*args)), 4),
                "bound_ms": round(chip_smoke.vtime_bound(args)[0], 6)}
        if lib is not None and T <= k8.CTA_MAX_T:
            old = _parent_vtime(lib, device, args)
            chip_smoke.require_equal(f"vtime parent {T}", [(old(), k8.vtime(*args))])
            line["parent_ms"] = round(chip_smoke.time_ms(old), 4)
        print(json.dumps(line), flush=True)


def vtime_host() -> None:
    """One process's `vtime-host` lines, for the checkout it runs from."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kube_batch_tpu_torch.framework.policy import virtual_start_times
    from kube_batch_tpu_torch.kernels import build
    from kube_batch_tpu_torch.kernels import lex_rank as k8

    build.build_all(("lex_rank",))
    device = torch.device("cuda")
    rng = np.random.default_rng(0)
    with profile(activities=[ProfilerActivity.CUDA]):   # the tracer's start-up
        torch.zeros(1, device=device).add_(1)
        torch.cuda.synchronize()

    def issue_us(fn, reps=30, batch=20, prof=None):
        for _ in range(20):
            fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            if prof is not None:
                prof.enable()
            t0 = time.perf_counter()
            for _ in range(batch):
                fn()
            times.append((time.perf_counter() - t0) / batch)
            if prof is not None:
                prof.disable()
        torch.cuda.synchronize()
        return float(np.median(times)) * 1e6, float(np.min(times)) * 1e6

    def event_ms(fn, warmup=2, runs=7):   # chip_smoke.time_ms's method
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
        return float(np.median(times))

    for T, S, share in VTIME_HOST_CASES:
        def on(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        args = (on(rng.integers(0, S, T).astype(np.int32)),
                on(rng.permutation(T).astype(np.int32)),
                on(rng.integers(0, 4000, (T, 4)).astype(np.float32)), on(rng.random(T) < share),
                on(rng.integers(0, 100000, (S, 4)).astype(np.float32)),
                on(np.full(4, 5e5, np.float32))[None, :].expand(S, 4), S)
        seg, base_rank, valid = args[0], args[1], args[3]

        def sort_only():
            k8.sort_by_segment(torch.where(valid, torch.clamp(seg, 0, S - 1), S), base_rank, S)

        call_us, call_min = issue_us(lambda: virtual_start_times(*args))
        sort_us, sort_min = issue_us(sort_only)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                virtual_start_times(*args)
            torch.cuda.synchronize()
        kernel_ms = {e.key[:40]: round(e.device_time_total / 50 / 1e3, 4)
                     for e in prof.key_averages() if e.device_time_total > 0}
        print(json.dumps({"phase": "vtime-host", "tree": os.getcwd(), "rows": T,
                          "segments": S,
                          "ms": round(event_ms(lambda: virtual_start_times(*args)), 4),
                          "device_ms": kernel_ms,
                          "device_total_ms": round(sum(kernel_ms.values()), 4),
                          "host_us": round(call_us, 2),
                          "host_us_min": round(call_min, 2),
                          "sort_host_us": round(sort_us, 2),
                          "sort_host_us_min": round(sort_min, 2)}), flush=True)
        if (T, S) == VTIME_HOST_CASES[0][:2]:
            prof = cProfile.Profile()
            issue_us(lambda: virtual_start_times(*args), reps=10, prof=prof)
            stats = pstats.Stats(prof).stats   # (file, line, name) -> (cc, nc, tt, ct, callers)
            top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:10]
            print(json.dumps({"phase": "vtime-host-profile", "tree": os.getcwd(),
                              "own_us_per_call": {
                                  f"{os.path.basename(k[0])}:{k[1]}:{k[2]}":
                                  round(v[2] / (10 * 20) * 1e6, 2) for k, v in top}}),
                  flush=True)


def vtime_host_runs(parent: str | None) -> None:
    trees = [parent, ROOT, ROOT, parent] * HOST_ROUNDS if parent else [ROOT]
    for tree in trees:
        env = dict(os.environ, PYTHONPATH=tree)
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--vtime-host"],
                             cwd=tree, env=env, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise RuntimeError(f"vtime-host in {tree} failed:\n{out.stdout}\n{out.stderr}")
        print(out.stdout, end="", flush=True)


def main(argv) -> int:
    if argv[:1] == ["--vtime-host"]:
        sys.path.insert(0, os.getcwd())
        vtime_host()
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
    errs = {"vtime": chip_smoke.phase_vtime_edge(device)}
    errs.update(chip_smoke.phase_k2_edge(device))
    words = chip_smoke.phase_words_edge(device)
    errs = {k: max(v, words.get(k, 0.0)) for k, v in errs.items()}
    print(json.dumps({"phase": "edge", "max_abs_err": errs}), flush=True)
    k2_timings(device, parent)
    vtime_timings(device, parent)
    torch.cuda.synchronize()
    vtime_host_runs(parent)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
