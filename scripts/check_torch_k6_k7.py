#!/usr/bin/env python3
"""Build every CUDA kernel of the port and hold K7 (segment sums and
counts) and K6's preempt_open against their plain versions on the card,
on the edge inputs of chip_smoke.py (`phase_edge_inputs`).

    python3 scripts/check_torch_k6_k7.py

Run from the root of a checkout on a machine with a CUDA card and nvcc:
the quick first call after editing `kernels/csrc/segment_sum.cu` or
`preempt_scan.cu` (well under a minute).  Prints the card's name and
power limit, the build, one JSON line per edge case (the widest K6 case
timed), then K7's segment_sum timed beside one float64 index_add_ on
seeded queue-like sums (3 of 8 segments used, 45 % of the rows kept) of
8,192 and 65,536 rows, and exits non-zero on the first difference.
Last, the split of a call's time between host and card for K7's
segment_sum and segment_count, index_add_ and K6's preempt_open (the
fit_last_cell edge input): host µs per call of 200 calls queued without
a wait, and device µs per call of each kernel over 20 calls traced with
torch.profiler.  Then the host µs of the stream handle every wrapper
reads (`build.stream_handle`: torch's private
`torch._C._cuda_getCurrentRawStream`) against torch's public
`current_stream(device).cuda_stream`, alone and inside K7's and K6's
wrappers.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    for blocked in ("jax", "jaxlib", "flax", "kube_batch_tpu"):
        sys.modules[blocked] = None
    import numpy as np
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false")
    chip_smoke.phase_card_and_build()
    device = torch.device("cuda")
    errs = chip_smoke.phase_edge_inputs(device)
    print(json.dumps({"edge_max_abs_err": errs}), flush=True)
    from kube_batch_tpu_torch.api.snapshot import build_segment_index
    from kube_batch_tpu_torch.kernels import preempt_scan as k6
    from kube_batch_tpu_torch.kernels import segment_sum as k7

    rng = np.random.default_rng(0)
    sum_args = None
    for T in (8192, 65536):
        base = torch.from_numpy(rng.integers(0, 3, T).astype(np.int32)).to(device)
        keep = torch.from_numpy(rng.random(T) < 0.45).to(device)
        values = torch.from_numpy(
            (rng.integers(0, 64, (T, 4)) * 1000).astype(np.float32)).to(device)
        idx = build_segment_index(base, 8)
        seg = torch.where(keep, idx.base, 8)
        args = (values, seg, 8, idx.order, idx.offsets)
        sum_args = sum_args or args
        ms, plain_ms, library_ms, b = chip_smoke.segment_sum_timing(args)
        chip_smoke.require_equal("segment_sum", [
            (k7.segment_sum(*args), k7.segment_sum_plain(values, seg, 8))])
        print(json.dumps({"segment_sum_rows": T, "ms": ms, "plain_ms": plain_ms,
                          "library_ms": library_ms, "bound_ms": b[0]}), flush=True)
        acc = torch.zeros((9, 4), dtype=torch.float64, device=device)
        i64, v64 = seg.long(), values.double()
        for name, fn in (("segment_sum", lambda: k7.segment_sum(*args)),
                         ("index_add_", lambda: acc.index_add_(0, i64, v64)),
                         ("segment_count", lambda: k7.segment_count(keep, seg, 8))):
            print(json.dumps({"rows": T, "call": name, **host_and_device(fn)}), flush=True)
    args, _want = chip_smoke.k6_edge_inputs(device)["fit_last_cell"]
    print(json.dumps({"call": "preempt_open",
                      **host_and_device(lambda: k6.preempt_open(*args))}), flush=True)
    stream_handle_forms(device, {
        "segment_sum": lambda: k7.segment_sum(*sum_args),
        "preempt_open": lambda: k6.preempt_open(*args)})
    return 0


def stream_handle_forms(device, calls: dict, n: int = 20000) -> None:
    """Host µs per call of the two ways to read the current stream's
    handle, alone (n calls) and inside each wrapper of `calls`, the
    forms in turns (public, private, private, public)."""
    import torch

    from kube_batch_tpu_torch.kernels import build

    forms = {
        "public": lambda dev: torch.cuda.current_stream(dev).cuda_stream,
        "private": build.stream_handle,
    }
    assert forms["public"](device) == forms["private"](device)
    for name in ("public", "private", "private", "public"):
        handle = forms[name]
        t0 = time.perf_counter()
        for _ in range(n):
            handle(device)
        alone_us = (time.perf_counter() - t0) / n * 1e6
        build.stream_handle = handle
        try:
            wrapped = {k: host_and_device(fn)["host_us_per_call"] for k, fn in calls.items()}
        finally:
            build.stream_handle = forms["private"]
        print(json.dumps({"stream_handle": name, "torch": torch.__version__,
                          "alone_us": alone_us, "wrapper_host_us": wrapped}), flush=True)


def host_and_device(fn, calls: int = 200, traced: int = 20) -> dict:
    """Host µs per call (calls queued back to back, then one wait) and
    device µs per call of each kernel the calls launch (torch.profiler)."""
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
            device_us[e.key[:48]] = total / traced
    return {"host_us_per_call": host_us, "device_us_per_call": device_us}


if __name__ == "__main__":
    sys.exit(main())
