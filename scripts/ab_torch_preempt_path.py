#!/usr/bin/env python3
"""Time the port's preempt path, its joint path, its affinity path and
kernels K7 and K6 in two or more checkouts, in turns, on one card.

    python3 scripts/ab_torch_preempt_path.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout of this repository (for example
a `git archive` of another commit unpacked into a directory that
.gitignore lists).

First this script's own checkout records the kernel inputs to time (in a
process of its own): the preempt path's cycle-2 inputs that chip_smoke.py
times (`timing_inputs`: K6 `preempt_open`'s no-fit opening step with the
most eligible tasks and K7's widest float sum, 8,192 rows) and the main
path's widest float sum (config 5 full, 65,536 rows; `main_timing_input`),
with the segment index each sum was given.  They are saved to a
temporary directory inside this checkout for the runs that follow.

Then, for each checkout in the order given, a fresh process run from it
drives, on the card with that checkout's own kernels (built into its own
`kube_batch_tpu_torch/kernels/_build/`):
  * `chip_smoke.preempt_cycles("cuda")`: full config 4 under
    examples/scheduler.conf for 3 cycles, the preemption wave after
    cycle 1;
  * the same world and wave with `joint_solve=True`, 3 cycles;
  * the affinity path: full-size config 5 with inter-pod affinity terms
    (`chip_smoke.config5_affinity`) under the default conf, 2 cycles,
    chip_smoke's second wave of MAIN_WAVE_PODS pods after cycle 1;
  * K7's segment_sum on both recorded sums and K6's preempt_open on the
    recorded step (median of 7 CUDA-event runs after 2 warm-ups; a
    checkout whose segment_sum takes no index is called without one),
    each output held against the plain version.
One JSON line per run gives each cycle's solve ms, binds, evictions and
each loop's or joint tier's steps and ms per step (the affinity path:
auction rounds and solve ms per round), and the kernel times;
a last line says whether every run made the same decisions (binds,
evictions and ready jobs of every cycle, as sets).  Runs in one call
share one card, so the checkouts compare; calls on different machines
do not.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CAPTURE = r"""
import sys
sys.path.insert(0, ".")
import torch
import chip_smoke

device = torch.device("cuda")
chip_smoke.phase_card_and_build()
_cycles, rec, _cache, _ssn = chip_smoke.preempt_cycles("cuda", record=True)
picked = chip_smoke.timing_inputs(rec)
del rec
_counts, mrec = chip_smoke.phase_main_path(device)
picked["segment_sum_main"] = chip_smoke.main_timing_input(mrec)
torch.save({k: [a.cpu() if torch.is_tensor(a) else a for a in v]
            for k, v in picked.items()}, sys.argv[1])
"""

_RUN = r"""
import inspect, json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke
from kube_batch_tpu_torch.kernels import preempt_scan as k6
from kube_batch_tpu_torch.kernels import segment_sum as k7
from kube_batch_tpu_torch.scheduler import Scheduler


def ready(ssn, job_ready):
    return sorted(n for j, n in enumerate(ssn.meta.job_names) if job_ready[j])


def loops(stats):
    out = []
    for key in ("preempt_steps", "reclaim_steps"):
        for loop in stats.get(key, []):
            out.append({"loop": key, "steps": loop["steps"],
                        "ms_per_step": loop["ms"] / max(loop["steps"], 1)})
    for t in stats.get("joint_tiers", []):
        out.append({"loop": t["tier"], "steps": t["steps"],
                    "ms_per_step": t["ms"] / max(t["steps"], 1)})
    return out


t0 = time.perf_counter()
paths = {}
cycles, _rec, _cache, sessions = chip_smoke.preempt_cycles("cuda", record=False)
paths["sequential"] = [
    {"solve_ms": c["timings"]["solve_ms"], "binds": c["binds"], "evicted": c["evicted"],
     "ready": ready(s, c["job_ready"]), "loops": loops(c["rounds"])}
    for c, s in zip(cycles, sessions)]
del sessions, _cache
cache, sim = chip_smoke.preempt_world()
sched = Scheduler(cache, conf=chip_smoke.scheduler_conf(), device="cuda",
                  joint_solve=True)
joint = []
for cycle in range(3):
    ssn = sched.run_once()
    assert sched.last_stats["cycle"] == "joint"
    joint.append({"solve_ms": sched.last_timings["solve_ms"], "binds": list(ssn.bound),
                  "evicted": list(ssn.evicted), "ready": ready(ssn, ssn.job_ready),
                  "loops": loops(sched.last_stats)})
    sim.tick()
    if cycle == 0:
        chip_smoke.preempt_wave(sim)
paths["joint"] = joint
cache, sim = chip_smoke.config5_affinity()
sched = Scheduler(cache, device="cuda")
affinity = []
for cycle in range(2):
    ssn = sched.run_once()
    st = sched.last_stats
    rounds = sum(st.get("allocate_rounds", [])) + sum(st.get("backfill_rounds", []))
    affinity.append({"solve_ms": sched.last_timings["solve_ms"], "binds": list(ssn.bound),
                     "evicted": [], "ready": ready(ssn, ssn.job_ready),
                     "loops": [{"loop": "auction", "steps": rounds,
                                "ms_per_step": sched.last_timings["solve_ms"]
                                / max(rounds, 1)}]})
    sim.tick()
    if cycle == 0:
        chip_smoke.arrivals(cache, sim, chip_smoke.MAIN_WAVE_PODS)
paths["affinity"] = affinity
del cache, sim, sched, ssn
paths_s = time.perf_counter() - t0

inputs = torch.load(sys.argv[1])
dev = torch.device("cuda")
with_index = len(inspect.signature(k7.segment_sum).parameters) > 3
kern = {}
for name in ("segment_sum", "segment_sum_main"):
    values, seg, S, order, offsets = [a.to(dev) if torch.is_tensor(a) else a
                                      for a in inputs[name]]
    args = (values, seg, S, order, offsets) if with_index else (values, seg, S)
    out = k7.segment_sum(*args)
    if not torch.equal(out, k7.segment_sum_plain(values, seg, S)):
        raise SystemExit(f"{name}: the kernel differs from the plain version")
    kern[name] = {"ms": chip_smoke.time_ms(lambda: k7.segment_sum(*args)),
                  "out": out.double().sum().item()}
args = [a.to(dev) for a in inputs["preempt_open"]]
out = k6.preempt_open(*args)
if not torch.equal(out, k6.preempt_open_plain(*args)):
    raise SystemExit("preempt_open: the kernel differs from the plain version")
kern["preempt_open"] = {"ms": chip_smoke.time_ms(lambda: k6.preempt_open(*args)),
                        "out": out.tolist()}
print("RESULT " + json.dumps({"paths": paths, "kernels": kern, "s": paths_s,
                              "segment_sum_takes_index": with_index}))
"""


def _python(tree: str, code: str, *args: str, timeout: int = 1800):
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=tree,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"{tree}: the run failed")
    return proc.stdout


def run(tree: str, inputs: str) -> dict:
    out = _python(tree, _RUN, inputs)
    line = [x for x in out.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def _decisions(paths: dict):
    # as sets: bind and eviction lists follow the pack's row order, which
    # the incremental pack permutes (swap-compaction, appends)
    return {kind: [(sorted(map(tuple, c["binds"])), sorted(map(tuple, c["evicted"])),
                    c["ready"]) for c in cycles]
            for kind, cycles in paths.items()}


def main(trees: list[str]) -> int:
    if len(trees) < 2:
        raise SystemExit(__doc__)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed", flush=True)
    decisions, outputs = [], []
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        inputs = os.path.join(tmp, "kernel_inputs.pt")
        _python(ROOT, _CAPTURE, inputs)
        for i, tree in enumerate(trees):
            r = run(os.path.abspath(tree), inputs)
            decisions.append(_decisions(r["paths"]))
            outputs.append({k: v["out"] for k, v in r["kernels"].items()})
            print(json.dumps({
                "run": i, "tree": tree, "seconds": round(r["s"], 1),
                "segment_sum_takes_index": r["segment_sum_takes_index"],
                "kernels_ms": {k: round(v["ms"], 4) for k, v in r["kernels"].items()},
                **{kind: [{"solve_ms": round(c["solve_ms"], 1), "binds": len(c["binds"]),
                           "evicted": len(c["evicted"]), "ready_jobs": len(c["ready"]),
                           "loops": [{"loop": lp["loop"], "steps": lp["steps"],
                                      "ms_per_step": round(lp["ms_per_step"], 4)}
                                     for lp in c["loops"]]}
                          for c in cycles]
                   for kind, cycles in r["paths"].items()},
            }), flush=True)
    same = all(d == decisions[0] for d in decisions)
    same_out = all(o == outputs[0] for o in outputs)
    print(json.dumps({"same_decisions": same, "same_kernel_outputs": same_out}),
          flush=True)
    return 0 if same and same_out else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
