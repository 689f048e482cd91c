#!/usr/bin/env python3
"""Time the port's preempt path, its joint path, its affinity path and
kernels K7, K6, K2's two passes, K5's node choice and K8's virtual start
times in two or more checkouts, in turns, on one card.

    python3 scripts/ab_torch_preempt_path.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout of this repository (for example
a `git archive` of another commit unpacked into a directory that
.gitignore lists).

First this script's own checkout records the kernel inputs to time (in a
process of its own): the preempt path's cycle-2 inputs that chip_smoke.py
times (`timing_inputs`: K6 `preempt_open`'s no-fit opening step with the
most eligible tasks and K7's widest float sum, 8,192 rows) and the main
path's widest float sum (config 5 full, 65,536 rows; `main_timing_input`),
with the segment index each sum was given; the widest recorded
`virtual_start_times` call of each of the two paths (8,192 and 65,536
rows); K2 `propose_best`'s inputs on the main path's cycle-2 round that
chip_smoke times (`_pick_round`) and on the affinity path's last recorded
round (the affinity words, cycle 2; a class score term, kernel K13's
table, as the [T, N] tensor it stands for), and K2 `propose_pick`'s on those two
rounds and on the preempt path's round with the most eligible rows; the
inputs of the preempt path's cycle-2 opening step with the most
candidate victims (K5's node choice: the victims, their nodes and ranks,
the preemptor as a device scalar and its node-mask inputs).  They are
saved to a temporary directory inside this checkout for the runs that
follow.

Then, for each checkout in the order given, a fresh process run from it
drives, on the card with that checkout's own kernels (built into its own
`kube_batch_tpu_torch/kernels/_build/`):
  * `chip_smoke.preempt_cycles("cuda")`: full config 4 under
    examples/scheduler.conf for 3 cycles, the preemption wave after
    cycle 1;
  * the same world and wave with `joint_solve=True`, 3 cycles;
  * the main path: config 5 full under the default conf, 2 cycles,
    chip_smoke's second wave of MAIN_WAVE_PODS pods after cycle 1; and
    the affinity path: full-size config 5 with inter-pod affinity terms
    (`chip_smoke.config5_affinity`), the same way, with (a checkout with
    step graphs) cycle 2's round replays timed by CUDA events (the card's
    ms inside them, and per replay) and the peak of
    `torch.cuda.max_memory_allocated` over its two cycles;
  * K7's segment_sum on both recorded sums and K6's preempt_open on the
    recorded step (median of 7 CUDA-event runs after 2 warm-ups; a
    checkout whose segment_sum takes no index is called without one),
    K2's propose_best on both recorded rounds (the affinity round in the
    words form and given the mask of the same cells), propose_pick on
    those rounds and the preempt path's (a checkout whose pass 2 takes
    pass 1's scratch is given one that pass 1 has just filled), the
    opening step's node choice (a checkout whose K5 takes the preemptor
    and the mask inputs: its one call; else the mask composed with
    torch and `ops/preemption.py · min_victims_per_node`, which sorts
    with K8 and launches K5) and
    `framework/policy.py · virtual_start_times` on both recorded calls
    (the whole call: a parent's sort and tail, or one launch), each
    output held against the plain version;
  * on the preempt path, K8's launches a preemption step (lex_push_many,
    sort_by_segment, vtime) and the device operations a step, and a
    opening and a continuing step apart (`chip_smoke.PreemptWindows` of
    this script's own checkout: 40 steps of cycle 2 traced by
    torch.profiler, marked by each step's one K6 launch);
  * the device operations per joint step by tier kind, on 40 auction
    steps of the joint run's cycle 1 and 40 evict steps of its cycle 2
    traced with torch.profiler by this script's own checkout's
    `chip_smoke.JointWindows`, which wraps that checkout's K12
    `tier_control(kind, gated, step, ...)` (called once an iteration);
  * the device operations per auction round on the main path (40 rounds
    of cycle 2 from its third) and the affinity path (40 rounds of cycle
    1 from its 100th), traced by this script's own checkout's
    `chip_smoke.AuctionWindows`, which wraps the run checkout's K2
    `propose_best` (called once a round).
A checkout whose loops replay captured step graphs
(`kube_batch_tpu_torch/ops/graphs.py`) calls K2 and K6 from Python only
to warm and capture a body: its preemption steps and auction rounds are
not traced by wrapping them; its graphs' totals of each path (graphs
captured, replays, nodes per graph by body kind, host reads, capture
ms) are reported instead.  The joint windows trace it as any checkout
(K12 stays a host launch an iteration).
One JSON line per run gives each cycle's solve ms, binds, evictions and
each loop's or joint tier's steps and ms per step (the main and
affinity paths: auction rounds and solve ms per round), the kernel
times, the launches per joint step, per preemption step and per auction
round;
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


def cpu(args):
    return [a.cpu() if torch.is_tensor(a) else a for a in args]


def widest_vtime(rec):
    return max((a for _c, _r, a in rec.calls["vtime"]), key=lambda a: a[2].shape[0])


def portable_k2(args):
    # propose_best's arguments in types torch.load takes back: the score
    # spec as its weights, the affinity words as their fields
    pred, dyn, req, avail, eps, node_mask, elig, future, cap, spec, extras, q = args
    if dyn is not None and not torch.is_tensor(dyn):
        dyn = {"node_words": dyn.node_words.cpu(), "task_words": dyn.task_words.cpu(),
               "thr": dyn.thr.cpu(), "K": dyn.K, "K2": dyn.K2}
    elif dyn is not None:
        dyn = dyn.cpu()
    # a class term (kernel K13's table read at each task's class) goes as
    # the [T, N] tensor it stands for, which every checkout's K2 takes
    extras = [e.dense() if hasattr(e, "dense") else e for e in extras]
    return {"tensors": cpu([pred, req, avail, eps, node_mask, elig, future, cap]),
            "dyn": dyn, "spec": [spec.w_lr, spec.w_bal, spec.d0, spec.d1],
            "extras": cpu(extras), "quantum": q}


def portable_pick(args):
    # propose_pick's: pass 1's, then best, active and k
    return {**portable_k2(args[:12]), "pick": cpu(args[12:15])}


device = torch.device("cuda")
chip_smoke.phase_card_and_build()
_cycles, rec, _cache, _ssn = chip_smoke.preempt_cycles("cuda", record=True)
picked = {k: cpu(v) for k, v in chip_smoke.timing_inputs(rec).items()}
picked["vtime_preempt"] = cpu(widest_vtime(rec))
first = min(c for c, _r, _a in rec.calls["predicate_mask"])
picked["k5"] = cpu(max((a for c, _r, a in rec.calls["victim_prefix"] if c == first),
                       key=lambda a: int(a[0].sum())))
from kube_batch_tpu_torch.kernels import victim_prefix as k5
picked["k5_want"] = k5.victim_prefix_plain(*picked["k5"])
picked["pick_preempt"] = portable_pick(max((a for _c, _r, a in rec.calls["propose_pick"]),
                                           key=lambda a: int(a[6].sum())))
del rec
_counts, mrec = chip_smoke.phase_main_path(device)
picked["segment_sum_main"] = cpu(chip_smoke.main_timing_input(mrec))
picked["vtime_main"] = cpu(widest_vtime(mrec))
picked["k2_main"] = portable_k2(chip_smoke._pick_round(mrec)[0]["propose_best"])
picked["pick_main"] = portable_pick(chip_smoke._pick_round(mrec)[0]["propose_pick"])
del mrec
_counts, arec = chip_smoke.phase_affinity_path(device)
picked["k2_affinity"] = portable_k2(arec.calls["propose_best"][-1][2])
picked["pick_affinity"] = portable_pick(arec.calls["propose_pick"][-1][2])
del arec
torch.save(picked, sys.argv[1])
"""

_RUN = r"""
import importlib.util, inspect, json, os, sys, time, types
sys.path.insert(0, ".")
import torch
import chip_smoke
from kube_batch_tpu_torch import kernels
from kube_batch_tpu_torch.framework.policy import virtual_start_times
from kube_batch_tpu_torch.kernels import affinity as k10
from kube_batch_tpu_torch.kernels import joint_tier
from kube_batch_tpu_torch.kernels import preempt_scan as k6
from kube_batch_tpu_torch.kernels import propose as k2
from kube_batch_tpu_torch.kernels import segment_sum as k7
from kube_batch_tpu_torch.kernels import victim_prefix as k5
from kube_batch_tpu_torch.models.workloads import config5_full
from kube_batch_tpu_torch.ops import preemption as ops_preemption
from kube_batch_tpu_torch.scheduler import Scheduler

spec = importlib.util.spec_from_file_location(
    "ab_launch_counter", os.path.join(sys.argv[2], "chip_smoke.py"))
counter = importlib.util.module_from_spec(spec)
spec.loader.exec_module(counter)
# a checkout whose loops replay captured step graphs launches K2 and K6
# from Python only when it captures: its rounds and steps are not traced
# by wrapping them, its graphs' totals are reported instead
if importlib.util.find_spec("kube_batch_tpu_torch.ops.graphs") is not None:
    from kube_batch_tpu_torch.ops import graphs
else:
    graphs = None
graph_totals = {}


def totals_of(path):
    if graphs is not None:
        graph_totals[path] = {k: v for k, v in graphs.totals.items()}
        graphs.reset_totals()


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


def traced_k6(real, window):
    def wrapper(*args):
        window.hook()
        return real(*args)

    # the wrapper counts its launches on its module's global name
    wrapper.launches = real.launches
    return wrapper


t0 = time.perf_counter()
paths = {}
step_window = counter.PreemptWindows() if graphs is None else None
real_k6 = (k6.preempt_open, k6.preempt_continue)
if step_window is not None:
    k6.preempt_open, k6.preempt_continue = (traced_k6(f, step_window) for f in real_k6)
totals_of(None)
kernels.reset_counts()
cycles, _rec, _cache, sessions = chip_smoke.preempt_cycles("cuda", record=False)
preempt_counts = kernels.counts()
totals_of("sequential")
k6.preempt_open, k6.preempt_continue = real_k6
step_ops = step_window.result() if step_window is not None else None
steps = sum(loop["steps"] for c in cycles for key in ("preempt_steps", "reclaim_steps")
            for loop in c["rounds"].get(key, []))
preempt_launches = {"steps": steps, **{
    k: {"launches": preempt_counts[k], "per_step": round(preempt_counts[k] / max(steps, 1), 3)}
    for k in ("lex_push_many", "sort_by_segment", "vtime")}}
paths["sequential"] = [
    {"solve_ms": c["timings"]["solve_ms"], "binds": c["binds"], "evicted": c["evicted"],
     "ready": ready(s, c["job_ready"]), "loops": loops(c["rounds"])}
    for c, s in zip(cycles, sessions)]
del sessions, _cache
cache, sim = chip_smoke.preempt_world()
sched = Scheduler(cache, conf=chip_smoke.scheduler_conf(), device="cuda",
                  joint_solve=True)
windows = counter.JointWindows()
real = joint_tier.tier_control


def traced(*args):
    windows.hook(args)
    return real(*args)


# the wrapper counts its launches on its module's global name
traced.launches = real.launches
joint_tier.tier_control = traced
joint = []
for cycle in range(3):
    windows.cycle = cycle
    ssn = sched.run_once()
    assert sched.last_stats["cycle"] == "joint"
    joint.append({"solve_ms": sched.last_timings["solve_ms"], "binds": list(ssn.bound),
                  "evicted": list(ssn.evicted), "ready": ready(ssn, ssn.job_ready),
                  "loops": loops(sched.last_stats)})
    sim.tick()
    if cycle == 0:
        chip_smoke.preempt_wave(sim)
joint_tier.tier_control = real
launches = windows.result()
totals_of("joint")
paths["joint"] = joint
del cache, sim, sched, ssn


def traced_k2(real, window):
    def wrapper(*args):
        window.hook()
        return real(*args)

    # the wrapper counts its launches on its module's global name
    wrapper.launches = real.launches
    return wrapper


def auction_cycles(cache, sim, window, timed=False):
    # two cycles of the default conf with chip_smoke's second wave after
    # the first, K2's pass 1 hooked to `window`; `timed` (a checkout with
    # step graphs): cycle 2's replays timed by CUDA events, and the peak
    # of max_memory_allocated over both cycles
    real_k2 = k2.propose_best
    if window is not None:
        k2.propose_best = traced_k2(real_k2, window)
    sched = Scheduler(cache, device="cuda")
    timed = timed and graphs is not None
    if timed:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out = []
    for cycle in range(2):
        if timed and cycle == 1:
            replays, replay_ms = graphs.totals["replays"], graphs.totals["replay_ms"]
            graphs.TIME_REPLAYS = True
        ssn = sched.run_once()
        device = {}
        if timed and cycle == 1:
            torch.cuda.synchronize()
            graphs.TIME_REPLAYS = False
            n = graphs.totals["replays"] - replays
            device = {"replays": n, "replay_device_ms": graphs.totals["replay_ms"] - replay_ms}
            device["device_ms_per_replay"] = device["replay_device_ms"] / max(n, 1)
        st = sched.last_stats
        rounds = sum(st.get("allocate_rounds", [])) + sum(st.get("backfill_rounds", []))
        out.append({"solve_ms": sched.last_timings["solve_ms"], "binds": list(ssn.bound),
                    "evicted": [], "ready": ready(ssn, ssn.job_ready),
                    "loops": [{"loop": "auction", "steps": rounds,
                               "ms_per_step": sched.last_timings["solve_ms"]
                               / max(rounds, 1)}], **device})
        sim.tick()
        if cycle == 0:
            chip_smoke.arrivals(cache, sim, chip_smoke.MAIN_WAVE_PODS)
    k2.propose_best = real_k2
    if timed:
        out[-1]["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out, None if window is None else window.result()


round_ops = {}
# the main path: config 5 full; the window starts at cycle 2's third round
cache, sim = config5_full(seed=0)
paths["main"], round_ops["main"] = auction_cycles(
    cache, sim, counter.AuctionWindows(skip=6) if graphs is None else None)
totals_of("main")
cache, sim = chip_smoke.config5_affinity()
paths["affinity"], round_ops["affinity"] = auction_cycles(
    cache, sim, counter.AuctionWindows(skip=100) if graphs is None else None, timed=True)
totals_of("affinity")
del cache, sim
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


def k2_args(p):
    pred, req, avail, eps, node_mask, elig, future, cap = (x.to(dev) for x in p["tensors"])
    dyn = p["dyn"]
    if isinstance(dyn, dict):
        dyn = k10.AffinityWords(node_words=dyn["node_words"].to(dev),
                                task_words=dyn["task_words"].to(dev),
                                thr=dyn["thr"].to(dev), K=dyn["K"], K2=dyn["K2"])
    elif dyn is not None:
        dyn = dyn.to(dev)
    w_lr, w_bal, d0, d1 = p["spec"]
    return [pred, dyn, req, avail, eps, node_mask, elig, future, cap,
            k2.ScoreSpec(w_lr=w_lr, w_bal=w_bal, d0=d0, d1=d1),
            [x.to(dev) for x in p["extras"]], p["quantum"]]


# K2 pass 1: the main path's round (no dynamic predicate) and the
# affinity path's last recorded round, in the words form and given the
# mask of the same cells
k2_cases = {"k2_main": k2_args(inputs["k2_main"]), "k2_affinity": k2_args(inputs["k2_affinity"])}
words = k2_cases["k2_affinity"][1]
mask_form = list(k2_cases["k2_affinity"])
mask_form[1] = torch.cat([k10.affinity_cells_plain(words.rows(slice(lo, lo + 4096)))
                          for lo in range(0, words.task_words.shape[0], 4096)])
k2_cases["k2_affinity_mask_form"] = mask_form
for name, a in k2_cases.items():
    out = k2.propose_best(*a)
    for x, y in zip(out, k2.propose_best_plain(*a)):
        if not torch.equal(x, y):
            raise SystemExit(f"{name}: propose_best differs from the plain version")
    kern[name] = {"ms": chip_smoke.time_ms(lambda: k2.propose_best(*a)),
                  "eligible": int(a[6].sum()),
                  "out": [out[0].double().sum().item(), int(out[1].sum()), int(out[2].sum())]}
# K2 pass 2 on the main, affinity (both forms) and preempt rounds
takes_scratch = "scratch" in inspect.signature(k2.propose_pick).parameters
pick_cases = {name: (k2_args(inputs[name]), [x.to(dev) for x in inputs[name]["pick"]])
              for name in ("pick_main", "pick_affinity", "pick_preempt")}
pick_mask = list(pick_cases["pick_affinity"][0])
pick_mask[1] = mask_form[1]
pick_cases["pick_affinity_mask_form"] = (pick_mask, pick_cases["pick_affinity"][1])
for name, (a, extra) in pick_cases.items():
    if takes_scratch:
        scratch = k2.best_scratch(a[2].shape[0], a[3].shape[0], dev)
        k2.propose_best(*a, scratch)
        pick_call = (lambda a, extra, scratch: lambda: k2.propose_pick(*a, *extra, scratch))(
            a, extra, scratch)
    else:
        pick_call = (lambda a, extra: lambda: k2.propose_pick(*a, *extra))(a, extra)
    out = pick_call()
    if not torch.equal(out, k2.propose_pick_plain(*a, *extra)):
        raise SystemExit(f"{name}: propose_pick differs from the plain version")
    kern[name] = {"ms": chip_smoke.time_ms(pick_call), "active": int(extra[1].sum()),
                  "out": out.double().sum().item()}
# K5: the opening step's node choice, as each checkout's evict_step makes it
k5_args = [a.to(dev) if torch.is_tensor(a) else a for a in inputs["k5"]]
(victims, task_node, rank, req, future, eps, p, preq_rows, pred, node_ok, excl,
 dyn_row) = k5_args
N = future.shape[0]
if len(inspect.signature(k5.victim_prefix).parameters) >= 12:
    def choose():
        return k5.victim_prefix(*k5_args)
else:
    snap5 = types.SimpleNamespace(task_node=task_node, task_req=req)
    preq = preq_rows[p]   # evict_step takes it before the branch

    def choose():
        ok = pred[p] & node_ok & ~excl
        if dyn_row is not None:
            ok = ok & dyn_row
        return torch.cat(ops_preemption.min_victims_per_node(
            snap5, future, victims, rank, preq, eps, ok))
out = choose()
if not torch.equal(out.cpu(), inputs["k5_want"]):
    raise SystemExit("node choice: differs from the plain version")
kern["k5_node_choice"] = {"ms": chip_smoke.time_ms(choose), "victims": int(victims.sum()),
                          "out": out.tolist()}
# K8 vtime: one virtual_start_times call at the preempt path's and the
# main path's widths, against the same call on the CPU (the plain version)
for name in ("vtime_preempt", "vtime_main"):
    args = [a.to(dev) if torch.is_tensor(a) else a for a in inputs[name]]
    out = virtual_start_times(*args)
    if not torch.equal(out.cpu(), virtual_start_times(*inputs[name])):
        raise SystemExit(f"{name}: virtual_start_times differs from the plain version")
    kern[name] = {"ms": chip_smoke.time_ms(lambda: virtual_start_times(*args)),
                  "rows": args[2].shape[0], "out": out.double().sum().item()}
print("RESULT " + json.dumps({"paths": paths, "kernels": kern, "s": paths_s,
                              "segment_sum_takes_index": with_index,
                              "joint_launches": launches,
                              "preempt_launches": preempt_launches,
                              "preempt_step_ops": step_ops, "round_ops": round_ops,
                              "graphs": graph_totals}))
"""


def _python(tree: str, code: str, *args: str, timeout: int = 1800):
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=tree,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"{tree}: the run failed")
    return proc.stdout


def run(tree: str, inputs: str) -> dict:
    out = _python(tree, _RUN, inputs, ROOT)
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
                "k2_eligible": {k: v["eligible"] for k, v in r["kernels"].items()
                                if "eligible" in v},
                "joint_launches": r["joint_launches"],
                "preempt_launches": r["preempt_launches"],
                "preempt_step_ops": r["preempt_step_ops"],
                "round_ops": r["round_ops"],
                "graphs": r.get("graphs", {}),
                **{kind: [{"solve_ms": round(c["solve_ms"], 1), "binds": len(c["binds"]),
                           "evicted": len(c["evicted"]), "ready_jobs": len(c["ready"]),
                           "loops": [{"loop": lp["loop"], "steps": lp["steps"],
                                      "ms_per_step": round(lp["ms_per_step"], 4)}
                                     for lp in c["loops"]],
                           **{k: c[k] for k in ("replays", "replay_device_ms",
                                                "device_ms_per_replay",
                                                "max_memory_allocated") if k in c}}
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
