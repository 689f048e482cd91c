#!/usr/bin/env python3
"""Build every CUDA kernel of the port and hold K8 (lex_push_many,
sort_by_segment), K10's affinity_words and K2's words form against their
plain versions on the card, on the edge inputs of chip_smoke.py
(`phase_k8_edge`, `phase_words_edge`).

    python3 scripts/check_torch_k8_k10.py

Run from the root of a checkout on a machine with a CUDA card and nvcc:
the quick first call after editing `kernels/csrc/lex_rank.cu`,
`affinity_mask.cu` or `propose.cu` (about a minute).  Prints the card's
name and power limit, the build, one JSON line per edge case, then
times (median of CUDA-event runs, chip_smoke.time_ms) on seeded keys:
lex_push_many with 1 and 13 keys at 8,192 and 65,536 rows beside the
same chain of stable torch.argsort calls, and sort_by_segment beside a
stable torch.sort of the int64 key at (8,192 rows, 512 segments),
(65,536, 3) and (65,536, 8,192); and the host µs of one lex_push_many
call, 200 calls queued without a wait.  Exits non-zero on the first
difference.
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
    print(json.dumps({"k8_edge_max_abs_err": chip_smoke.phase_k8_edge(device)}), flush=True)
    print(json.dumps({"words_edge_max_abs_err": chip_smoke.phase_words_edge(device)}),
          flush=True)
    from kube_batch_tpu_torch.kernels import lex_rank as k8

    rng = np.random.default_rng(0)
    for T in (8192, 65536):
        for m in (1, 13):
            keys = [torch.from_numpy(rng.integers(0, 5, T).astype(np.float32)).to(device)
                    for _ in range(m)]

            def library():
                perm = torch.arange(T, device=device)
                for k in keys:
                    perm = perm[torch.argsort(k[perm], stable=True)]
                return perm

            print(json.dumps({
                "name": "lex_push_many", "rows": T, "keys": m,
                "ms": chip_smoke.time_ms(lambda: k8.lex_push_many(None, keys)),
                "library_ms": chip_smoke.time_ms(library)}), flush=True)
            if T == 8192 and m == 13:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    k8.lex_push_many(None, keys)
                host_us = (time.perf_counter() - t0) / 200 * 1e6
                torch.cuda.synchronize()
                print(json.dumps({"name": "lex_push_many", "rows": T, "keys": m,
                                  "host_us_per_call": round(host_us, 2)}), flush=True)
    for T, S in ((8192, 512), (65536, 3), (65536, 8192)):
        seg = torch.from_numpy(rng.integers(0, S + 1, T).astype(np.int32)).to(device)
        rank = torch.from_numpy(rng.permutation(T).astype(np.int32)).to(device)
        key = seg.long() * T + rank.long()
        print(json.dumps({
            "name": "sort_by_segment", "rows": T, "segments": S,
            "plan": list(k8.sort_plan(T, S)),
            "ms": chip_smoke.time_ms(lambda: k8.sort_by_segment(seg, rank, S)),
            "library_ms": chip_smoke.time_ms(lambda: torch.sort(key, stable=True))}),
            flush=True)
    torch.cuda.synchronize()
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
