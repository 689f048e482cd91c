#!/usr/bin/env python3
"""Check and time the loops' step graphs on the card.

    python3 scripts/check_torch_step_graphs.py [--worlds W,...] [--paths P,...]
        [--profile-affinity]

Builds the kernels, then for each named chip_smoke parity world (default:
all of them) and each named path (main, host_cycle, affinity, preempt,
joint; default: none) runs it twice on the card: with its loops eager
(`ops/graphs.py · eager_graphs`, every body launched from Python, one
auction round a read) and with its loops captured (the default form:
each body a CUDA-graph replay after its first).  The two runs must
decide alike, their stats included (rounds, cancellations, steps by
outcome, joint tiers).  Each prints chip_smoke's `step-graphs` line: the
graphs captured, replays, nodes per graph, host reads, capture ms, ms
per round or step of both runs and, on the affinity and preempt paths,
cycle 2's idle share (the card's time outside the replays, timed by
CUDA events).  A failure is printed with its traceback and the script
goes on to the next; it exits 1 if any failed.  The card's name and
power limit come first.

`--profile-affinity` first traces three eager auction rounds of the
affinity path's first cycle (rounds 100-102) with torch.profiler and
prints the device ms a round by kernel name, largest first: what a
captured round of that path spends its device time on.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


@contextlib.contextmanager
def eager_loops():
    from kube_batch_tpu_torch.ops import graphs

    saved, graphs.loop_graphs = graphs.loop_graphs, graphs.eager_graphs
    try:
        yield
    finally:
        graphs.loop_graphs = saved


def _timed(run):
    t0 = time.perf_counter()
    out = run()
    return out, time.perf_counter() - t0


def check(label: str, run) -> None:
    with eager_loops():
        recorded, seconds = _timed(run)
    chip_smoke.phase_captured(label, run, recorded, seconds)


def profile_affinity(device, first: int = 100, rounds: int = 3) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kube_batch_tpu_torch.ops import assignment

    real, seen, prof = assignment.auction_round, [0], []

    def traced(*args):
        seen[0] += 1
        if seen[0] == first:
            torch.cuda.synchronize()
            prof.append(profile(activities=[ProfilerActivity.CUDA]))
            prof[0].start()
        out = real(*args)
        if seen[0] == first + rounds - 1:
            torch.cuda.synchronize()
            prof[0].stop()
        return out

    assignment.auction_round = traced
    try:
        with eager_loops():
            chip_smoke.path_cycles(device, chip_smoke.config5_affinity, 1, lambda *_: None)
    finally:
        assignment.auction_round = real
    by_name: dict = {}
    for e in prof[0].events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + e.device_time / 1e3
    total = sum(by_name.values())
    print(json.dumps({"phase": "affinity-round-profile", "rounds": rounds,
                      "device_ms_per_round": round(total / rounds, 4),
                      "by_kernel_ms_per_round": {k: round(v / rounds, 4) for k, v in sorted(
                          by_name.items(), key=lambda kv: -kv[1])[:25]}}), flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", default=",".join(chip_smoke.PARITY_WORLDS))
    ap.add_argument("--paths", default="")
    ap.add_argument("--profile-affinity", action="store_true")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"python": sys.version.split()[0], "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    chip_smoke.phase_card_and_build()
    device = torch.device("cuda")
    if args.profile_affinity:
        profile_affinity(device)
    runs = {
        "main": lambda: chip_smoke.main_cycles(device),
        "host_cycle": lambda: chip_smoke.host_cycles(device),
        "affinity": lambda: chip_smoke.affinity_cycles(device, timed=1),
        "preempt": lambda: chip_smoke.evict_cycles(device, False, timed=1),
        "joint": lambda: chip_smoke.evict_cycles(device, True),
    }
    failed = []
    items = [(f"parity:{w}", (lambda w=w: chip_smoke._run(w, "cuda", record=False)[0]))
             for w in args.worlds.split(",") if w]
    items += [(p, runs[p]) for p in args.paths.split(",") if p]
    for label, run in items:
        try:
            check(label, run)
        except (Exception, SystemExit):
            traceback.print_exc()
            sys.stdout.flush()
            failed.append(label)
    print(json.dumps({"failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
