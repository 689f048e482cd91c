#!/usr/bin/env python3
"""Full-size preempt path on the CPU: the PyTorch port against the JAX package.

    JAX_PLATFORMS=cpu python scripts/check_torch_preempt_config4.py

Builds BASELINE config 4 (500 nodes, 5,000 pods, seed 0) in each
package, runs `Scheduler.run_once` under examples/scheduler.conf for 3
cycles with a simulator tick between them, and submits after cycle 1 the
wave of chip_smoke.py's preempt path (`chip_smoke.preempt_wave` over
`PREEMPT_WAVE`: 40 prod gangs at priority 10,000, 10 batch gangs at
priority 100, 125 gangs of a new queue `research` of weight 4), built
with each package's own types.  Per cycle it prints each package's binds
and evictions and, for the port, the evictions per action and each
preemption loop's steps; then whether the two packages agree on the
binds, the evictions (pod, reason) as a set — the reference's
incremental pack orders rows differently once evicted pods are
recreated — every pod's state and node, and every job's readiness.
Exits 1 when they differ.  Takes about 15 minutes on 8 CPU cores.
"""

from __future__ import annotations

import itertools
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from chip_smoke import WAVE_PREFIXES, preempt_wave  # noqa: E402
from test_torch_pack import PACKAGES  # noqa: E402

CONF = os.path.join(ROOT, "examples", "scheduler.conf")


def run(pkg: str) -> list[dict]:
    cl, wl, _sim_mod = PACKAGES[pkg]
    cl._uid_counter = itertools.count()
    cache, sim = wl.build_config(4, seed=0)
    if pkg == "jax":
        from kube_batch_tpu.scheduler import Scheduler

        sched = Scheduler(cache, conf_path=CONF, schedule_period=0.0)
    else:
        from kube_batch_tpu_torch.framework.conf import parse_conf
        from kube_batch_tpu_torch.scheduler import Scheduler

        with open(CONF) as f:
            sched = Scheduler(cache, conf=parse_conf(f.read()), device="cpu")
    out = []
    for cycle in range(3):
        t0 = time.perf_counter()
        ssn = sched.run_once()
        if pkg == "jax":
            ts, tn, ready = ssn.host_task_state(), ssn.host_task_node(), ssn.job_ready()
        else:
            ts, tn, ready = ssn.host_task_state, ssn.host_task_node, ssn.job_ready
        meta = ssn.meta
        out.append({
            "bound": sorted(ssn.bound),
            "evicted": sorted(ssn.evicted),
            "tasks": {p.name: (int(ts[t]), meta.node_names[tn[t]] if tn[t] >= 0 else None)
                      for t, p in enumerate(meta.task_pods)},
            "ready": {name: bool(ready[j]) for j, name in enumerate(meta.job_names)},
        })
        line = {"package": pkg, "cycle": cycle + 1, "bound": len(ssn.bound),
                "evicted": len(ssn.evicted), "s": round(time.perf_counter() - t0, 1)}
        if pkg == "torch":
            stats = sched.last_stats
            line["evicted_per_action"] = stats.get("evicted")
            line["steps"] = [loop["steps"] for key in ("preempt_steps", "reclaim_steps")
                             for loop in stats.get(key, [])]
        print(line, flush=True)
        sim.tick()
        if cycle == 0:
            preempt_wave(sim, cl, wl)
    return out


def main() -> int:
    ref, port = run("jax"), run("torch")
    ok = True
    for c, (a, b) in enumerate(zip(ref, port)):
        same = {k: a[k] == b[k] for k in ("bound", "evicted", "tasks", "ready")}
        ok = ok and all(same.values())
        print({"cycle": c + 1, **same}, flush=True)
    wave_binds = sum(1 for pod, _ in port[2]["bound"]
                     if pod.startswith(WAVE_PREFIXES))
    print({"wave_binds_cycle3": wave_binds, "identical": ok}, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
