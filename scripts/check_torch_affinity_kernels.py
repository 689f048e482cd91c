#!/usr/bin/env python3
"""Build kernels K10, K11 and K12 and hold each against its plain version
on the card, on seeded synthetic inputs at the main path's widths.

    python3 scripts/check_torch_affinity_kernels.py [--tasks 65536] [--nodes 8192]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
The inputs (numpy, seed 0) have the shapes of the config-5 affinity world:
K = 32 pod labels, K2 = 32 topology terms, two real topology keys plus
two padded key columns that point at the dead domain, padded nodes and
tasks, residents in every status.  K11 (`resident_words`) builds both
resident sets and the future set alone; K10 reads them (task words,
mask in both orientations, rows, words); K12 (`tier_control`) runs
every tier kind after no step, an auction round and an evict step with
and without an open plan, at and below its step bound.  Every output
must equal the plain version's exactly; prints one JSON line per kernel
(equal; ms of the kernel and of the plain version, median of 7
CUDA-event runs; for K11 and K12 also the host µs of one call, 200
calls queued without a wait, and the device µs of each kernel a call
launches, torch.profiler; for K11 the host µs of its one buffer
allocation alone) and exits non-zero on the first difference.
The first line is the card's name and power limit as nvidia-smi gives
them, then the build's ptxas report (registers, spills).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_ms(fn, runs: int = 7) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def host_and_device(fn, calls: int = 200, traced: int = 20) -> dict:
    """Host µs of one call (calls queued back to back, then one wait) and
    the device µs of each kernel a call launches (torch.profiler)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(traced):
            fn()
        torch.cuda.synchronize()
    device_us = {}
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if total:
            device_us[e.key[:48]] = round(total / traced, 3)
    return {"host_us_per_call": round(host_us, 3), "device_us_per_call": device_us}


def inputs(T: int, N: int, seed: int = 0):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    K, K2, TK, D = 32, 32, 4, 256
    Tr, Nr = T * 3 // 4, N * 5 // 8
    dev = torch.device("cuda")

    def hot(rows, width, p):
        m = (rng.random((rows, width)) < p).astype(np.float32)
        m[Tr:] = 0.0
        return m

    labels = hot(T, K, 0.08)
    labels[:, 20:] = 0.0                       # padded label columns
    aff = hot(T, K, 0.01)
    anti = hot(T, K, 0.005)
    aff_topo = hot(T, K2, 0.02)
    anti_topo = hot(T, K2, 0.005)
    term_key = np.r_[np.zeros(16), np.ones(16)].astype(np.int32)
    term_label = np.r_[np.arange(16), np.arange(16)].astype(np.int32)
    aff_topo[:, 30:] = anti_topo[:, 30:] = 0.0
    term_key[30:], term_label[30:] = 0, 0     # padded term columns
    nkd = np.full((N, TK), D - 1, np.int32)   # padded nodes: the dead domain
    nkd[:Nr, 0] = np.arange(Nr) // 40          # racks
    nkd[:Nr, 1] = 200 + np.arange(Nr) % 3      # zones
    task_state = rng.integers(0, 10, T).astype(np.int32)
    task_node = rng.integers(-1, Nr, T).astype(np.int32)
    task_mask = np.arange(T) < Tr
    f = [torch.from_numpy(x).to(dev) for x in (
        labels, aff, anti, aff_topo, anti_topo, term_key, term_label, nkd,
        task_state, task_node, task_mask)]
    return dict(zip(("labels", "aff", "anti", "aff_topo", "anti_topo", "term_key",
                     "term_label", "nkd", "task_state", "task_node", "task_mask"), f)), D


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", type=int, default=65536)
    ap.add_argument("--nodes", type=int, default=8192)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from kube_batch_tpu_torch.kernels import affinity as k10
    from kube_batch_tpu_torch.kernels import build
    from kube_batch_tpu_torch.kernels import joint_tier as k12
    from kube_batch_tpu_torch.kernels import resident as k11

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    t0 = time.perf_counter()
    build.build_all(("resident_tables", "affinity_mask", "joint_tier"))
    print(json.dumps({"build_s": round(time.perf_counter() - t0, 3)}), flush=True)
    for name, text in sorted(build.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}", flush=True)
    x, D = inputs(args.tasks, args.nodes)
    T, N = args.tasks, args.nodes
    ok = True

    def same(name, a, b):
        nonlocal ok
        for i, (u, v) in enumerate(zip(a, b)):
            if (u is None) != (v is None) or (u is not None and not torch.equal(u, v)):
                print(json.dumps({"kernel": name, "output": i, "equal": False}), flush=True)
                ok = False
                return False
        return True

    def tables_equal(name, got, want):
        pairs = [(getattr(got, f), getattr(want, f)) for f in (
            "Hb", "Ab", "Hb_now", "Ab_now", "Hd", "Ad", "Hd_now", "Ad_now", "term_exists")]
        return same(name, [a for a, _ in pairs], [b for _, b in pairs])

    fields = (x["aff"], x["anti"], x["labels"], x["aff_topo"], x["anti_topo"],
              x["term_key"], x["term_label"], x["nkd"])
    tw = k10.affinity_task_words(*fields[:5])
    eq = same("affinity_task_words", [tw], [k10.task_words_plain(*fields[:5])])
    print(json.dumps({
        "kernel": "affinity_task_words", "equal": eq,
        "ms": round(time_ms(lambda: k10.affinity_task_words(*fields[:5])), 4),
        "plain_ms": round(time_ms(lambda: k10.task_words_plain(*fields[:5])), 4),
    }), flush=True)
    K, K2 = x["labels"].shape[1], x["aff_topo"].shape[1]
    res = {}
    for now in (False, True):
        res_args = (tw, x["task_node"], x["task_state"], x["task_mask"], x["nkd"],
                    x["term_key"], x["term_label"], N, D, K, K2, now)
        got = k11.resident_words(*res_args)
        eq = tables_equal(f"resident_words[{now}]", got, k11.resident_words_plain(*res_args))
        res[now] = got
        print(json.dumps({
            "kernel": "resident_words", "with_now": now, "equal": eq,
            "present_bits": int(k11.unpack(got.Hb, K).sum()),
            "ms": round(time_ms(lambda: k11.resident_words(*res_args)), 4),
            "plain_ms": round(time_ms(lambda: k11.resident_words_plain(*res_args)), 4),
            **host_and_device(lambda: k11.resident_words(*res_args)),
            # the build's one allocation alone (its table buffer)
            "alloc_host_us_per_call": host_and_device(lambda: torch.empty(
                got.buf.numel(), dtype=torch.int32, device=got.buf.device))["host_us_per_call"],
        }), flush=True)
    for imm in (False, True):
        got = k10.affinity_mask(*fields, res[imm])
        want = k10.affinity_mask_plain(*fields, res[imm])
        eq = same(f"affinity_mask[{imm}]", [got], [want])
        words = k10.affinity_words(tw, *fields[5:], res[imm])
        eq_w = same(f"affinity_words[{imm}]", [k10.affinity_cells_plain(words)], [want])
        print(json.dumps({
            "kernel": "affinity_mask", "immediate": imm, "equal": eq, "words_equal": eq_w,
            "infeasible_cells": int((~got).sum()),
            "ms": round(time_ms(lambda: k10.affinity_mask(*fields, res[imm])), 4),
            "words_ms": round(time_ms(lambda: k10.affinity_words(tw, *fields[5:],
                                                                  res[imm])), 4),
            "plain_ms": round(time_ms(lambda: k10.affinity_mask_plain(*fields, res[imm]),
                                      runs=3), 4),
        }), flush=True)
        del want
    rows = [int(t) for t in torch.nonzero(x["aff"].any(1) | x["aff_topo"].any(1)
                                          | x["anti"].any(1))[:64, 0]] + [0, T - 1]
    bad = 0
    for p in rows:
        p_dev = torch.tensor(p, device="cuda")
        got = k10.affinity_row(*fields, res[False], p_dev, tw)
        if not torch.equal(got, k10.affinity_row_plain(*fields, res[False], p)):
            bad += 1
    ok = ok and bad == 0
    p_dev = torch.tensor(rows[0], device="cuda")
    print(json.dumps({
        "kernel": "affinity_row", "rows": len(rows), "equal": bad == 0,
        "ms": round(time_ms(lambda: k10.affinity_row(*fields, res[False], p_dev, tw)), 4),
        "plain_ms": round(time_ms(lambda: k10.affinity_row_plain(*fields, res[False],
                                                                 rows[0])), 4),
    }), flush=True)

    import numpy as np

    rng = np.random.default_rng(1)
    Tk, Nk, J, R = 8192, 512, 1024, 4
    cases = total = 0
    for kind in (k12.AUCTION, k12.EVICT):
        for gated in (0, 1):
            for after in ("none", "auction", "evict", "evict_open"):
                if after == "evict_open" and kind == k12.AUCTION:
                    continue
                for progressed, step in ((1, 3), (0, 3), (1, 1000)):
                    base = {
                        "task_state": torch.from_numpy(rng.integers(0, 8, Tk).astype(np.int32)),
                        "snap_state": torch.from_numpy(rng.integers(0, 8, Tk).astype(np.int32)),
                        "task_mask": torch.from_numpy(rng.random(Tk) < 0.9),
                        "elig": torch.from_numpy(rng.random(Tk) < 0.01),
                        "starving": torch.from_numpy(rng.random(J) < 0.5),
                        "task_job": torch.from_numpy(rng.integers(-1, J, Tk).astype(np.int32)),
                        "tried": torch.from_numpy(rng.random(Tk) < 0.3),
                        "prov": torch.from_numpy(rng.random(Tk) < 0.002),
                        "code": torch.from_numpy((rng.random(Tk) < 0.001).astype(np.int32) * 3),
                        "task_req": torch.from_numpy(rng.integers(0, 8, (Tk, R)).astype(np.float32) * 1000),
                        "node_future": torch.from_numpy(rng.integers(-4, 16, (Nk, R)).astype(np.float32) * 1000),
                        "excl": torch.from_numpy(rng.random(Nk) < 0.1),
                        "phase": torch.tensor([2], dtype=torch.int32),
                        "work": torch.zeros(Tk, dtype=torch.bool),
                        "read": torch.zeros(k12.READ, dtype=torch.int64),
                    }
                    step_out = (None if after == "none" else
                                torch.from_numpy((rng.random(Tk) < 0.01) & bool(progressed))
                                if after == "auction" else
                                torch.tensor([progressed, int(after == "evict_open"), 17,
                                              1, 0, 0, 0], dtype=torch.int64))
                    a = {k: v.cuda() for k, v in base.items()}
                    b = {k: v.clone().cuda() for k, v in base.items()}
                    so = None if step_out is None else step_out.cuda()
                    k12.tier_control(kind, gated, step, 1000, so, *a.values())
                    k12.tier_control_plain(kind, gated, step, 1000, so, *b.values())
                    eq = same(f"tier_control[{kind},{gated},{after},{progressed},{step}]",
                              list(a.values()), list(b.values()))
                    cases += eq
                    total += 1
    a = {k: v.cuda() for k, v in base.items()}
    flags = torch.tensor([1, 1, 17, 1, 0, 0, 0], dtype=torch.int64, device="cuda")

    def one_step():
        k12.tier_control(k12.EVICT, 0, 3, 1000, flags, *a.values(), False)

    print(json.dumps({"kernel": "tier_control", "cases": total, "equal_cases": cases,
                      "ms": round(time_ms(one_step), 4), **host_and_device(one_step)}),
          flush=True)
    ok = ok and cases == total
    print(json.dumps({"ok": ok, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
