#!/usr/bin/env python3
"""Time the port's main path on one card, alone and beside a busy host.

    python3 scripts/probe_torch_main_path.py

Builds the kernels as chip_smoke does, then drives
`chip_smoke.phase_main_path` (config 5 full, 2 cycles with the 15,000-pod
wave after cycle 1) three times in one process: twice alone (the first
run pays the one-time costs of loading kernels and compiling Triton),
then once while a spawned worker runs the preempt path's CPU twin
(`chip_smoke.preempt_cycles_cpu`), as it does during chip_smoke's main
path.  chip_smoke prints its usual main-path lines; this script prints a
`probe` line before each run.  Run it from the root of a checkout; it
needs one card and about a minute.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke
    from kube_batch_tpu_torch.device import resolve_device

    device = resolve_device("cuda")
    chip_smoke.phase_card_and_build()
    for run in ("alone", "alone again"):
        print(json.dumps({"probe": run}), flush=True)
        chip_smoke.phase_main_path(device)
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        pool.apply_async(chip_smoke.preempt_cycles_cpu, (ROOT,))
        time.sleep(20)   # let the worker reach its cycles
        print(json.dumps({"probe": "beside the preempt path's CPU twin"}), flush=True)
        chip_smoke.phase_main_path(device)
    finally:
        pool.terminate()
        pool.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
