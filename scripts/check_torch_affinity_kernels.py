#!/usr/bin/env python3
"""Build kernels K10, K11 and K12 and hold each against its plain version
on the card, on seeded synthetic inputs at the main path's widths.

    python3 scripts/check_torch_affinity_kernels.py [--tasks 65536] [--nodes 8192]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
The inputs (numpy, seed 0) have the shapes of the config-5 affinity world:
K = 32 pod labels, K2 = 32 topology terms, two real topology keys plus
two padded key columns that point at the dead domain, padded nodes and
tasks, residents in every status.  Every output must equal the plain
version's exactly; prints one JSON line per kernel (equal, ms of the
kernel and of the plain version, median of 7 CUDA-event runs) and exits
non-zero on the first difference.  The first line is the card's name and
power limit as nvidia-smi gives them.
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

    res_args = (x["labels"], x["anti"], x["anti_topo"], x["task_node"], x["task_state"],
                x["task_mask"], x["nkd"], x["term_key"], x["term_label"], N, D)
    tables = {}
    for rel in (False, True):
        got = k11.resident_tables(*res_args, rel)
        want = k11.resident_tables_plain(*res_args, rel)
        eq = same(f"resident_tables[{rel}]", got, want)
        tables[rel] = got
        print(json.dumps({
            "kernel": "resident_tables", "include_releasing": rel, "equal": eq,
            "present_cells": [int(t.sum()) for t in got],
            "ms": round(time_ms(lambda: k11.resident_tables(*res_args, rel)), 4),
            "plain_ms": round(time_ms(lambda: k11.resident_tables_plain(*res_args, rel)), 4),
        }), flush=True)
    fields = (x["aff"], x["anti"], x["labels"], x["aff_topo"], x["anti_topo"],
              x["term_key"], x["term_label"], x["nkd"])
    Hb, Ab, Hd, Ad = tables[False]
    Hbn, Abn, Hdn, Adn = tables[True]
    for imm, tb in ((False, (Hb, Hb, Ab, Hd, Hd, Ad)), (True, (Hb, Hbn, Abn, Hd, Hdn, Adn))):
        got = k10.affinity_mask(*fields, *tb)
        want = k10.affinity_mask_plain(*fields, *tb)
        eq = same(f"affinity_mask[{imm}]", [got], [want])
        print(json.dumps({
            "kernel": "affinity_mask", "immediate": imm, "equal": eq,
            "infeasible_cells": int((~got).sum()),
            "ms": round(time_ms(lambda: k10.affinity_mask(*fields, *tb)), 4),
            "plain_ms": round(time_ms(lambda: k10.affinity_mask_plain(*fields, *tb), runs=3), 4),
        }), flush=True)
        del want
    rows = [int(t) for t in torch.nonzero(x["aff"].any(1) | x["aff_topo"].any(1)
                                          | x["anti"].any(1))[:64, 0]] + [0, T - 1]
    bad = 0
    for p in rows:
        p_dev = torch.tensor(p, device="cuda")
        got = k10.affinity_row(*fields, Hb, Ab, Hd, Ad, p_dev)
        if not torch.equal(got, k10.affinity_row_plain(*fields, Hb, Ab, Hd, Ad, p)):
            bad += 1
    ok = ok and bad == 0
    p_dev = torch.tensor(rows[0], device="cuda")
    print(json.dumps({
        "kernel": "affinity_row", "rows": len(rows), "equal": bad == 0,
        "ms": round(time_ms(lambda: k10.affinity_row(*fields, Hb, Ab, Hd, Ad, p_dev)), 4),
        "plain_ms": round(time_ms(lambda: k10.affinity_row_plain(*fields, Hb, Ab, Hd, Ad, rows[0])), 4),
    }), flush=True)

    import numpy as np

    rng = np.random.default_rng(1)
    Tk, Nk, J, R = 8192, 512, 1024, 4
    cases = 0
    for kind in (k12.AUCTION, k12.EVICT):
        for gated in (0, 1):
            for prov_active in (0, 1):
                for progressed, step in ((1, 3), (0, 3), (1, 10**6)):
                    base = {
                        "carry": torch.tensor([progressed, prov_active, 17], dtype=torch.int32),
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
                    }
                    a = {k: v.cuda() for k, v in base.items()}
                    b = {k: v.clone().cuda() for k, v in base.items()}
                    fa = k12.tier_control(kind, gated, step, 1000, *a.values())
                    fb = k12.tier_control_plain(kind, gated, step, 1000, *b.values())
                    eq = same(f"tier_control[{kind},{gated},{prov_active},{progressed},{step}]",
                              [fa.cpu()] + list(a.values()), [fb.cpu()] + list(b.values()))
                    cases += eq
    a = {k: v.cuda() for k, v in base.items()}
    print(json.dumps({"kernel": "tier_control", "cases": 24, "equal_cases": cases,
                      "ms": round(time_ms(lambda: k12.tier_control(
                          k12.EVICT, 0, 0, 1, *a.values())), 4)}), flush=True)
    ok = ok and cases == 24
    print(json.dumps({"ok": ok, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
