#!/usr/bin/env python3
"""Build every CUDA kernel of the port and run chip_smoke.py's
`subset-diag` phase alone: the active-set diagnosis
(`framework/fit_errors.py · failure_counts_subset`: K1, K11, K10's words
or mask and K4 on the gathered pending rows) on the final states of the
main path's cycle 2, the affinity path's cycle 2 and the card run of the
parity world `chip_smoke.SUBSET_WORLD`, each held against the full
tallies of the same state and every kernel call against its plain
version, and timed beside the full tallies.

    python3 scripts/check_torch_subset_diag.py

Run from the root of a checkout on a machine with a CUDA card and nvcc
(a few minutes, most of them the two full-size paths).  Prints the
card's name and power limit, the build, the paths' lines and the
`subset-diag` line; exits non-zero on the first difference.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _blocked in ("jax", "jaxlib", "flax", "kube_batch_tpu"):
    sys.modules[_blocked] = None


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false")
    device = torch.device("cuda")
    chip_smoke.phase_card_and_build()
    _counts, rec = chip_smoke.phase_main_path(device)
    _counts, arec = chip_smoke.phase_affinity_path(device)
    _cycles, _refused, prec = chip_smoke._run(chip_smoke.SUBSET_WORLD, "cuda", record=True)
    chip_smoke.phase_subset_diag({"main": rec.final, "affinity": arec.final,
                                  f"parity:{chip_smoke.SUBSET_WORLD}": prec.final})
    torch.cuda.synchronize()
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
