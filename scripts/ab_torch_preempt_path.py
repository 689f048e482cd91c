#!/usr/bin/env python3
"""Time the port's preempt path in two or more checkouts, in turns, on one card.

    python3 scripts/ab_torch_preempt_path.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout of this repository (for example
a `git archive` of another commit unpacked into a directory that
.gitignore lists).  For each, in the order given, a fresh process run
from that checkout drives `chip_smoke.preempt_cycles("cuda")`: full
config 4 under examples/scheduler.conf for 3 cycles with the preemption
wave after cycle 1, on the card, with that checkout's own kernels
(built into its own `kube_batch_tpu_torch/kernels/_build/`).  One JSON
line per run gives each cycle's solve ms, binds and evictions and each
preemption loop's steps and ms per step; a last line says whether every
run made the same decisions (the same binds and evictions, in any
order).  Runs in one call share one card, so the checkouts compare;
calls on different machines do not.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_RUN = r"""
import json, sys, time
sys.path.insert(0, ".")
import chip_smoke
t0 = time.perf_counter()
cycles = chip_smoke.preempt_cycles("cuda", record=False)[0]
out = []
for c in cycles:
    loops = []
    for key in ("preempt_steps", "reclaim_steps"):
        for loop in c["rounds"].get(key, []):
            loops.append({"loop": key, "steps": loop["steps"],
                          "ms_per_step": loop["ms"] / max(loop["steps"], 1)})
    out.append({"solve_ms": c["timings"]["solve_ms"], "binds": c["binds"],
                "evicted": c["evicted"], "loops": loops})
print("RESULT " + json.dumps({"cycles": out, "s": time.perf_counter() - t0}))
"""


def run(tree: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", _RUN], cwd=tree,
                          capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"{tree}: the preempt path failed")
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main(trees: list[str]) -> int:
    if len(trees) < 2:
        raise SystemExit(__doc__)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed", flush=True)
    decisions = []
    for i, tree in enumerate(trees):
        r = run(os.path.abspath(tree))
        # as sets: bind and eviction lists follow the pack's row order,
        # which the incremental pack permutes (swap-compaction, appends)
        decisions.append([(sorted(map(tuple, c["binds"])),
                           sorted(map(tuple, c["evicted"])))
                          for c in r["cycles"]])
        print(json.dumps({
            "run": i, "tree": tree, "seconds": round(r["s"], 1),
            "cycles": [{"solve_ms": round(c["solve_ms"], 1),
                        "binds": len(c["binds"]), "evicted": len(c["evicted"]),
                        "loops": [{"loop": lp["loop"], "steps": lp["steps"],
                                   "ms_per_step": round(lp["ms_per_step"], 4)}
                                  for lp in c["loops"]]}
                       for c in r["cycles"]],
        }), flush=True)
    same = all(d == decisions[0] for d in decisions)
    print(json.dumps({"same_decisions": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
