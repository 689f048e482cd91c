"""Run scheduling cycles on a simulated world.

    python -m kube_batch_tpu_torch --workload 5 --cycles 2 [--device cpu]
    python -m kube_batch_tpu_torch --workload 4 --conf examples/scheduler.conf --cycles 3
    python -m kube_batch_tpu_torch --workload 5 --cycles 3 --pack-mode full
    python -m kube_batch_tpu_torch --workload 4 --conf examples/scheduler.conf --joint-solve on
    python -m kube_batch_tpu_torch --workload affinity --cycles 2

Builds BASELINE config N (models/workloads.py) in the simulator, runs
`--cycles` cycles of the default conf (or of the scheduler.conf at
`--conf PATH`, e.g. with the preempt and reclaim actions) with a
simulator tick between them, and prints one JSON line per cycle: pods
bound, pods evicted per evicting action, auction rounds per pass,
preemption steps per loop, the pack mode and its H2D bytes, and the
cycle's wall time split into pack (host patch, H2D) / solve / dispatch.
`--pack-mode full` rebuilds the pack every cycle instead of patching the
previous one (the default, "incremental").  `--joint-solve on` runs each
cycle as the joint single solve (ops/joint.py; the line then carries
each tier's steps and ms, and "cycle_kind": "joint"); `off` forces the
sequential cycle; without the flag KB_TPU_JOINT_SOLVE decides.
`--workload affinity` is config 5 with inter-pod affinity terms
(models/workloads.py · config5_affinity_world: 5,000 nodes in racks of 40,
parameter-server anti-affinity, MPI rack affinity, soft rack / zone
preferences) at full size; a cut size is built from Python with
`config5_affinity(n_nodes=..., target_pods=...)`.

`--profile DIR` traces the cycles with torch.profiler, after one
untraced warm-up cycle on a twin world: DIR receives the Chrome trace
and the per-operator table, and one more JSON line gives the device
time per kernel (top 15), the summed device time, the traced wall time,
the traced cycles' own wall time (sum of their `run_once` calls) and
the share of that cycle wall the device was busy.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kube_batch_tpu_torch")
    ap.add_argument("--workload", default="1",
                    choices=[str(n) for n in range(1, 6)] + ["affinity"])
    ap.add_argument("--cycles", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--conf", metavar="PATH", default=None,
                    help="scheduler.conf to run instead of the default conf")
    ap.add_argument("--pack-mode", choices=("incremental", "full"),
                    default="incremental")
    ap.add_argument("--joint-solve", choices=("on", "off"), default=None)
    ap.add_argument("--profile", metavar="DIR", default=None)
    args = ap.parse_args(argv)

    from kube_batch_tpu_torch.framework.conf import parse_conf
    from kube_batch_tpu_torch.scheduler import Scheduler

    conf = None
    if args.conf:
        with open(args.conf) as f:
            conf = parse_conf(f.read())
    cache, sim = _world(args)
    joint = None if args.joint_solve is None else args.joint_solve == "on"
    sched = Scheduler(cache, conf=conf, device=args.device,
                      pack_mode=args.pack_mode, joint_solve=joint)
    if args.profile:
        return _profiled(sched, sim, args)
    _cycles(sched, sim, args.cycles)
    return 0


def _world(args):
    """(cache, sim) of the chosen workload."""
    from kube_batch_tpu_torch.models.workloads import build_config, config5_affinity

    if args.workload == "affinity":
        return config5_affinity(seed=args.seed)

    n = int(args.workload)
    return build_config(n, **({} if n == 1 else {"seed": args.seed}))


def _cycles(sched, sim, cycles: int) -> float:
    """Run and report `cycles` cycles; returns their summed wall ms."""
    import time

    total_ms = 0.0
    for cycle in range(cycles):
        t0 = time.perf_counter()
        ssn = sched.run_once()
        total_ms += (time.perf_counter() - t0) * 1e3
        line = {"cycle": cycle, "device": str(sched.device),
                "bound": 0 if ssn is None else len(ssn.bound)}
        if ssn is not None:
            line.update({("cycle_kind" if k == "cycle" else k): v
                         for k, v in sched.last_stats.items()})
            line.update({k: round(v, 3) for k, v in sched.last_timings.items()})
        print(json.dumps(line), flush=True)
        sim.tick()
    return total_ms


def _profiled(sched, sim, args) -> int:
    """Trace one warm cycle: a first cycle on a twin world (same config
    and seed) pays the one-time costs — kernel builds and loads, Triton
    compilation, library initialisation — outside the trace."""
    import os
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kube_batch_tpu_torch.scheduler import Scheduler

    Scheduler(_world(args)[0], conf=sched.conf, device=sched.device,
              pack_mode=sched.pack_mode,
              joint_solve=sched.cycle_kind == "joint").run_once()
    os.makedirs(args.profile, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if sched.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        cycle_ms = _cycles(sched, sim, args.cycles)
        if sched.device.type == "cuda":
            torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    events = prof.key_averages()
    with open(os.path.join(args.profile, "ops.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
    # device-side events only (kernels, copies, memsets): an operator's
    # CPU-side event repeats the time of the kernels it launched
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in events
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda k: -k[1],
    )
    device_ms = sum(k[1] for k in kernels)
    print(json.dumps({
        "profile": args.profile, "traced_wall_ms": round(wall_ms, 3),
        "cycle_wall_ms": round(cycle_ms, 3), "device_ms": round(device_ms, 3),
        "device_busy_share": round(device_ms / cycle_ms, 4) if cycle_ms else None,
        "top": [{"name": n[:80], "device_ms": round(ms, 3), "calls": c}
                for n, ms, c in kernels[:15]],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
