#!/usr/bin/env python3
"""Chip smoke test of kube_batch_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, `nvcc`
and `triton`.  Phases (any failure exits non-zero):

1. card and build — the card's name and power limit, torch/CUDA
   versions, and the build of every CUDA kernel from this checkout's
   sources (one nvcc per source, all at once: K1–K3 and K5–K12), timed;
   then K7 and K6 on their edge inputs (K7: one segment, mostly empty
   segments, every row masked out, one segment holding every row,
   non-integer values — two runs bitwise equal, the plain version equal,
   within K7_REL_TOL on the non-integer values; K6's preempt_open:
   nothing eligible, a fit only at the last cell, a fit at the first
   cell, no ready node, and T = 65,536 with N = 8,192, timed); K8's
   lex_push_many and sort_by_segment on keys of T = 1, 8,192, 16,384,
   16,385 and 65,536 rows with NaN, ±0.0 and ±inf, all-equal keys and 40
   keys, and segment keys of 1, 3, 512 and 70,000 segments; K10's
   affinity_words and K2's words form on seeded affinity terms (words =
   plain, K2 given the words = K2 given K10's mask = plain) and on a
   world with no terms (= K2 given no predicate);
2. slice parity — config 3, config 4 (oversubscribed), a mid-size
   config 5 (500 nodes, 5,000 pods) and a feature world that turns on
   every kernel option of the default conf (affinity terms, preferences,
   volumes, ports, taints), 2 cycles each on the card and on the CPU.
   Between the cycles the simulator ticks and a second wave of the
   world's own jobs arrives (config 4 keeps its unplaced pods), and the
   first bind of some pods is refused, so cycle 2 packs bound and
   running pods and re-places failed binds.  Binds, final task_state /
   task_node, job_ready and the failure tallies must be identical, and
   every kernel call of the card run is held against its plain version
   on its own inputs;
3. the main path — full-size config 5 (5,000 nodes, 47,524 pods, padded
   T=65536, N=8192) for 2 cycles on the card through `Scheduler.run_once`,
   with a second wave of 15,000 pods arriving after cycle 1, which
   oversubscribes the cluster.  Every kernel's launch counter is set to 0
   just before and read just after; asserts that every kernel launched,
   that no node is over-committed, that gangs bind all-or-nothing and
   that every bind lands on a node its cycle's predicate mask allows;
4. the host cycle — full-size config 5 again, 4 cycles through
   `Scheduler.run_once` in its default incremental pack mode, with churn
   between the cycles: the tick, about 1 % of the running pods completing
   or deleted (swap-compacted rows), one node's allocatable cpu raised,
   and 300 pods arriving into existing jobs after cycles 1 and 3 (20
   evictions instead after cycle 2).  After every pack every device field
   must equal the packer's host array and every decoded task, job and
   node row a fresh full pack's; a second scheduler on an identical world
   in pack_mode="full" must bind alike every cycle; cycles 2-4 must be
   row-patched (K9).  Per cycle: pack mode, host-patch and H2D ms, H2D
   bytes, solve, dispatch, wall, binds, K9 launches;
5. the preempt path — full-size config 4 (500 nodes, 5,000 pods, 4
   priority classes, 2 queues) under examples/scheduler.conf (allocate,
   backfill, preempt, reclaim) for 3 cycles through `Scheduler.run_once`.
   Cycle 1 fills the empty cluster and evicts nothing; after the tick a
   wave arrives (high-priority prod gangs, batch gangs, and the gangs of
   a new heavier queue that oversubscribe memory), so cycle 2's preempt
   and reclaim evict; cycle 3 places wave pods on the freed nodes.  Launch
   counters are set to 0 before cycle 1 and read after cycle 3; asserts
   evictions by both actions in cycle 2, wave binds in cycle 3, the
   capacity, gang and predicate invariants, and identical decisions
   (binds, evictions with their reasons, task_state, task_node,
   job_ready, failure tallies) against the same run on the CPU, which a
   worker process runs meanwhile;
6. the affinity path — config 5 with inter-pod affinity terms at full
   size (models/workloads.py · config5_affinity_world: 5,000 nodes in 125
   racks of 40 and 3 zones, 47,524 pods labelled by team and role;
   parameter servers with anti-affinity `role=ps`, MPI workers with the
   required `rack:team` term, TF workers with soft rack / zone
   preferences), 2 cycles through `Scheduler.run_once` with 15,000 pods
   arriving after cycle 1.  K10 and K11 counters are set to 0 before and
   read after, and both must have launched, the mask at most once a
   cycle (the auction rounds take K10's words); capacity, gang and predicate
   invariants, no node with two `role=ps` residents, and every resident
   MPI worker backed by a team-mate in its rack (resident when the cycle
   began, or placed in it with no required term) or by its team's one
   bootstrap rack, open only while the team had no resident (a sanity
   check: `_check_affinity` says what it cannot see).  Per cycle: pack,
   solve, dispatch and wall ms, rounds, the acceptances each round step
   cancelled, binds, K10 / K11 launches;
7. the joint path — the preempt path's world and wave with
   `joint_solve=True` on the card, JOINT_CYCLES cycles: every cycle must
   report `last_stats["cycle"] == "joint"`, cycle 2 must evict, K12 must
   launch, the usual invariants hold; binds and evictions are compared
   as sets with phase 5's sequential card run and each difference is
   printed beside the gated admission tier's placements, with per-tier
   steps and ms per step beside the sequential loops';
8. kernels — each kernel against its plain PyTorch version on the card:
   K1–K4 on the inputs the main path gave them in cycle 2 (the predicate
   mask and failure tallies of that cycle, and the auction round whose
   resolve rejected the most proposals), K7 on every call of the main
   path, K5–K7 on every input the preempt path gave them in cycles 2 and
   3 (segment sums and counts sampled), timed on cycle 2's; K8 on every 10th call
   of the main path and every 25th of the preempt path, timed at both
   paths' widths (T = 65,536 and 8,192), with K8's launches on both
   paths and per preemption step; K9 on every call of the host
   cycle, timed on the largest; K11 on every 8th call of the affinity
   path, K10's mask on each of its calls, K10's words with K2's two
   passes every 300th round (K2 given the words against K2 given K10's
   mask, both timed), and K10's row form on every call of the
   config5_affinity_mid card run under examples/scheduler.conf, K12 on
   every 10th call of the joint path, each timed on cycle 2's inputs.
   Outputs exactly equal; kernel / plain / library times (median of
   CUDA-event timed runs after a warm-up) and the least time the card
   could take.

The parity worlds (phase 2) also include config5_affinity_mid (500
nodes, 5,000 pods, a 1,500-pod wave) under both confs, and
features_preempt and config5_affinity_mid under examples/scheduler.conf
with the joint solve; every K10, K11 and K12 call of their card runs is
held against its plain version.

The line before the `kernels` line gives the script's seconds, and the
one before it the order a redesign should take the kernels in, those
already redesigned marked.
The last two lines are the `kernels` JSON object and
{"ok": true, "device": {...}}.  Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
if __name__ in ("__main__", "__mp_main__"):
    # Run as the smoke test (or its worker), the port must never reach the
    # reference package or JAX.  Imported as a module, by a script that
    # runs both packages, it leaves them alone.
    for _blocked in ("jax", "jaxlib", "flax", "kube_batch_tpu"):
        sys.modules[_blocked] = None

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
F64_OPS_PER_S = 34e12       # H100 SXM float64 outside the tensor cores

KERNELS = {
    # name: (route, source, replaces)
    "predicate_mask": ("cuda", "kube_batch_tpu_torch/kernels/csrc/predicate_mask.cu",
                       "kube_batch_tpu/plugins/predicates.py:84"),
    "propose_best": ("cuda", "kube_batch_tpu_torch/kernels/csrc/propose.cu",
                     "kube_batch_tpu/ops/assignment.py:339"),
    "propose_pick": ("cuda", "kube_batch_tpu_torch/kernels/csrc/propose.cu",
                     "kube_batch_tpu/ops/assignment.py:117"),
    "resolve": ("cuda", "kube_batch_tpu_torch/kernels/csrc/resolve.cu",
                "kube_batch_tpu/ops/assignment.py:216"),
    "apply": ("cuda", "kube_batch_tpu_torch/kernels/csrc/resolve.cu",
              "kube_batch_tpu/ops/assignment.py:421"),
    "failure_counts": ("triton", "kube_batch_tpu_torch/kernels/failure_counts.py",
                       "kube_batch_tpu/framework/fit_errors.py:32"),
    "victim_prefix": ("cuda", "kube_batch_tpu_torch/kernels/csrc/victim_prefix.cu",
                      "kube_batch_tpu/ops/preemption.py:80"),
    "preempt_open": ("cuda", "kube_batch_tpu_torch/kernels/csrc/preempt_scan.cu",
                     "kube_batch_tpu/ops/preemption.py:164"),
    "preempt_continue": ("cuda", "kube_batch_tpu_torch/kernels/csrc/preempt_scan.cu",
                         "kube_batch_tpu/ops/preemption.py:249"),
    "segment_sum": ("cuda", "kube_batch_tpu_torch/kernels/csrc/segment_sum.cu",
                    "kube_batch_tpu/api/snapshot.py:212"),
    "segment_count": ("cuda", "kube_batch_tpu_torch/kernels/csrc/segment_sum.cu",
                      "kube_batch_tpu/api/snapshot.py:203"),
    "waterfill": ("cuda", "kube_batch_tpu_torch/kernels/csrc/segment_sum.cu",
                  "kube_batch_tpu/ops/waterfill.py:24"),
    "lex_push_many": ("cuda", "kube_batch_tpu_torch/kernels/csrc/lex_rank.cu",
                      "kube_batch_tpu/framework/policy.py:359"),
    "sort_by_segment": ("cuda", "kube_batch_tpu_torch/kernels/csrc/lex_rank.cu",
                        "kube_batch_tpu/ops/assignment.py:196"),
    "vtime": ("cuda", "kube_batch_tpu_torch/kernels/csrc/lex_rank.cu",
              "kube_batch_tpu/framework/policy.py:37"),
    "row_patch": ("cuda", "kube_batch_tpu_torch/kernels/csrc/row_patch.cu",
                  "kube_batch_tpu/cache/incremental.py:144"),
    "resident_tables": ("cuda", "kube_batch_tpu_torch/kernels/csrc/resident_tables.cu",
                        "kube_batch_tpu/plugins/predicates.py:136"),
    "affinity_mask": ("cuda", "kube_batch_tpu_torch/kernels/csrc/affinity_mask.cu",
                      "kube_batch_tpu/plugins/predicates.py:299"),
    "affinity_row": ("cuda", "kube_batch_tpu_torch/kernels/csrc/affinity_mask.cu",
                     "kube_batch_tpu/plugins/predicates.py:330"),
    "affinity_words": ("cuda", "kube_batch_tpu_torch/kernels/csrc/affinity_mask.cu",
                       "kube_batch_tpu/plugins/predicates.py:263"),
    "tier_control": ("cuda", "kube_batch_tpu_torch/kernels/csrc/joint_tier.cu",
                     "kube_batch_tpu/ops/joint.py:200"),
}
PREEMPT_KERNELS = ("victim_prefix", "preempt_open", "preempt_continue",
                   "segment_sum", "segment_count", "waterfill")
EVICTING_ONLY = ("victim_prefix", "preempt_open", "preempt_continue")
RANK_KERNELS = ("lex_push_many", "sort_by_segment", "vtime")
# launched where a steady cycle row-patches; required on the host cycle
HOST_CYCLE_ONLY = ("row_patch",)
# launched only on worlds with inter-pod affinity terms (the affinity
# path; the row form where such a world preempts) and by the joint solve
AFFINITY_KERNELS = ("resident_tables", "affinity_mask", "affinity_words")
AFFINITY_ROW = ("affinity_row",)
JOINT_ONLY = ("tier_control",)
NOT_ON_MAIN_PATH = (EVICTING_ONLY + HOST_CYCLE_ONLY + AFFINITY_KERNELS
                    + AFFINITY_ROW + JOINT_ONLY)

MAIN_WAVE_PODS = 15000   # second wave of the main path (T stays 65536)
# The preempt path's wave after cycle 1 (rehearsed on the CPU, PERF.md;
# scripts/check_torch_preempt_config4.py submits the same wave):
# (name prefix, queue, priority, gangs of 4 pods, cpu milli, memory GiB).
PREEMPT_WAVE = (
    ("urgent", "prod", 10000, 40, 4000, 8),
    ("bwave", "batch", 100, 10, 2000, 4),
    # a new queue "research" (weight RESEARCH_WEIGHT): its memory demand
    # passes capacity, so the water-fill puts prod and batch above their
    # deserved share and reclaim evicts from both
    ("research", "research", 0, 125, 4000, 48),
)
RESEARCH_WEIGHT = 4.0
WAVE_PREFIXES = tuple(w[0] for w in PREEMPT_WAVE)
# the recorder keeps every 25th segment sum or count and K8 call of the
# preempt path, and every 10th K8 call of the main path
PREEMPT_EVERY = {name: 25 for name in ("segment_sum", "segment_count") + RANK_KERNELS}
MAIN_EVERY = {name: 10 for name in RANK_KERNELS}
# the host-cycle phase: config 5 full, 4 cycles, churn between them
HOST_CYCLES = 4
HOST_DONE_EVERY = 100        # every 100th running pod completes or is deleted
HOST_ARRIVAL_PODS = 300      # pods arriving into existing jobs' shapes
HOST_EVICTED = 20            # pods evicted after the cycle without arrivals
# the affinity path records every 8th K11 call, every K10 mask call (one a
# cycle, for the failure tallies), and K10's words with the K2 calls of
# the same round every 300th round; the joint path every 10th K12 call
AFFINITY_EVERY = {"resident_tables": 8, "affinity_mask": 1, "affinity_words": 300,
                  "propose_best": 300, "propose_pick": 300}
JOINT_EVERY = {"tier_control": 10}
JOINT_CYCLES = 3
# the parity world whose card run gives K10's row form its launches
ROW_WORLD = "config5_affinity_mid_preempt"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, warmup: int = 2, runs: int = 7) -> float:
    """Median wall time of one call on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def bound(nbytes: float, ops: float, op_rate: float = F32_OPS_PER_S):
    """(least time in ms, "bytes" | "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(pairs) -> float:
    err = 0.0
    for a, b in pairs:
        if a.shape != b.shape:
            fail(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
        if a.numel():
            err = max(err, float((a.double() - b.double()).abs().max()))
    return err


def require_equal(name: str, pairs) -> float:
    import torch

    for i, (a, b) in enumerate(pairs):
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"{name}: output {i} differs from the plain version "
                 f"(max abs err {max_abs_err([(a, b)])})")
    return max_abs_err(pairs)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_card_and_build():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({
        "phase": "card", "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }))
    from kube_batch_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    for name, text in sorted(build.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"ptxas[{name}]: {line.strip()}")
    log(json.dumps({"phase": "build", "nvcc_parallel_s": round(build_s, 3)}))


# ---------------------------------------------------------------------------
# edge inputs of K7 and K6
# ---------------------------------------------------------------------------

# K7 float sums of non-integer values may differ from the plain version
# (a float64 index_add_, whose order on the card is that of its atomics)
# by one float32 unit in the last place: both sums are float64 (relative
# error under T·2⁻⁵³ ≈ 2⁻³⁷ at T = 65,536) rounded once to float32, so
# they round to the same float32 or to one of its two neighbours.
K7_REL_TOL = 2.0 ** -23


def k7_edge_inputs(device, T: int = 8192, J: int = 512, R: int = 4, seed: int = 0):
    """name → (values f32[T, R], seg, S, SegmentIndex, integer-valued):
    S = 1; S = J with most segments empty; every row masked out; one
    segment holding every row; non-integer values."""
    import numpy as np
    import torch

    from kube_batch_tpu_torch.api.snapshot import build_segment_index

    rng = np.random.default_rng(seed)

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    ints = on((rng.integers(0, 1 << 12, (T, R)) * 256).astype(np.float32))
    frac = on((rng.random((T, R)) * 1e6).astype(np.float32))
    keep = on(rng.random(T) < 0.7)
    jobs = on(rng.integers(-1, J, T).astype(np.int32))          # -1: padding
    sparse = on((rng.integers(0, J // 16, T) * 16).astype(np.int32))
    cases = {
        "one_segment": (ints, on(np.zeros(T, np.int32)), 1, True),
        "empty_segments": (ints, sparse, J, True),
        "all_masked": (ints, jobs, J, True),
        "one_segment_holds_all": (ints, on(np.full(T, 7, np.int32)), J, True),
        "non_integer": (frac, jobs, J, False),
    }
    out = {}
    for name, (values, base, S, exact) in cases.items():
        idx = build_segment_index(base, S)
        mask = keep & (base >= 0) & (name != "all_masked")
        seg = torch.where(mask, idx.base, S)
        out[name] = (values, seg, S, idx, exact)
    return out


def k6_edge_inputs(device, seed: int = 0, full=(65536, 8192)):
    """name → preempt_open's ten arguments and the outputs each must give
    (None: whatever the plain version gives): nothing eligible; a fit only
    at the last eligible row and the last ready node; a fit at the first
    cell; no ready node; `full` = (T, N) = (65,536, 8,192) and no fit."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def world(T, N, R=4, p_elig=0.3):
        rank = rng.permutation(T).astype(np.int32)
        elig = rng.random(T) < p_elig
        snap_state = rng.integers(0, 8, T).astype(np.int32)
        live_state = rng.integers(0, 8, T).astype(np.int32)
        task_mask = rng.random(T) < 0.9
        prov = rng.random(T) < 0.2
        req = rng.integers(1000, 8000, (T, R)).astype(np.float32)
        future = rng.integers(-4, 1, (N, R)).astype(np.float32) * 1000   # no fit
        node_ok = rng.random(N) < 0.9
        eps = np.full(R, 1e-3, np.float32)
        return [rank, elig, snap_state, live_state, task_mask, prov, req, future,
                node_ok, eps]

    cases = {}
    a = world(8192, 512)
    a[1][:] = False
    cases["nothing_eligible"] = (a, [0, 0, None, 0])
    a = world(8192, 512)
    last_t, last_n = int(np.flatnonzero(a[1])[-1]), int(np.flatnonzero(a[8])[-1])
    a[6][last_t] = 1.0
    a[7][last_n] = 1.0
    cases["fit_last_cell"] = (a, [None, 1, None, 1])
    a = world(8192, 512)
    first_t, first_n = int(np.flatnonzero(a[1])[0]), int(np.flatnonzero(a[8])[0])
    a[7][first_n] = a[6][first_t]
    cases["fit_first_cell"] = (a, [None, 1, None, 1])
    a = world(8192, 512)
    a[8][:] = False
    a[7][:] = 1e9
    cases["no_ready_node"] = (a, [None, 1, None, 0])
    cases["full_width_no_fit"] = (world(*full, p_elig=0.25), [None, 1, None, 0])
    return {name: ([on(x) for x in args], want) for name, (args, want) in cases.items()}


def phase_edge_inputs(device) -> dict:
    """K7 and K6 on their edge inputs on the card: two runs bitwise
    equal, the plain version equal (K7 on non-integer values: within
    K7_REL_TOL), K6's outputs as each case requires.  Times the
    full-width K6 case.  Returns {name: max_abs_err} for the kernels
    line's K7 and K6 rows."""
    import torch

    from kube_batch_tpu_torch.kernels import preempt_scan as k6
    from kube_batch_tpu_torch.kernels import segment_sum as k7

    errs = {"segment_sum": 0.0, "segment_count": 0.0, "preempt_open": 0.0}
    for name, (values, seg, S, idx, exact) in k7_edge_inputs(device).items():
        args = (values, seg, S, idx.order, idx.offsets)
        a, b = k7.segment_sum(*args), k7.segment_sum(*args)
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            fail(f"segment_sum edge {name}: two runs differ")
        want = k7.segment_sum_plain(values, seg, S)
        if exact:
            errs["segment_sum"] = max(errs["segment_sum"],
                                      require_equal(f"segment_sum edge {name}", [(a, want)]))
            rel = 0.0
        else:
            gap = (a.double() - want.double()).abs()
            rel = float((gap / want.double().abs().clamp(min=1e-30)).max())
            if not bool((gap <= K7_REL_TOL * want.double().abs()).all()):
                fail(f"segment_sum edge {name}: relative error {rel} above {K7_REL_TOL}")
        kept = seg < S
        counts = [k7.segment_count(kept, seg, S), k7.segment_count(kept.int(), seg, S)]
        errs["segment_count"] = max(errs["segment_count"], require_equal(
            f"segment_count edge {name}",
            [(c, k7.segment_sum_plain(kept, seg, S)) for c in counts]))
        log(json.dumps({"phase": "k7-edge", "case": name, "rows": seg.numel(),
                        "segments": S, "rows_kept": int(kept.sum()),
                        "nonempty_segments": int(torch.unique(seg[kept]).numel()),
                        "bitwise_repeatable": True, "exact": exact,
                        "max_rel_err": rel}))
    for name, (args, want) in k6_edge_inputs(device).items():
        a, b = k6.preempt_open(*args), k6.preempt_open(*args)
        plain = k6.preempt_open_plain(*args)
        errs["preempt_open"] = max(errs["preempt_open"], require_equal(
            f"preempt_open edge {name}", [(a, plain), (b, plain)]))
        got = a.tolist()
        if any(w is not None and w != g for w, g in zip(want, got)):
            fail(f"preempt_open edge {name}: {got}, want {want}")
        line = {"phase": "k6-edge", "case": name, "tasks": args[0].numel(),
                "nodes": args[7].shape[0], "eligible": int(args[1].sum()),
                "ready_nodes": int(args[8].sum()), "out": got}
        if name == "full_width_no_fit":
            line.update(ms=time_ms(lambda: k6.preempt_open(*args)),
                        plain_ms=time_ms(lambda: k6.preempt_open_plain(*args),
                                         warmup=1, runs=3),
                        bound_ms=preempt_open_bound(args)[0])
        log(json.dumps(line))
    return errs


# ---------------------------------------------------------------------------
# edge inputs of K8, and of K2's words form with K10's words
# ---------------------------------------------------------------------------

SPECIAL_KEYS = (0.0, -0.0, float("nan"), -1.0, 1e30, -1e30, float("inf"),
                float("-inf"), 2.5, -2.5)


def k8_edge_inputs(device, seed: int = 0):
    """(lex cases: name → (perm i64[T] or None, keys), segment cases: name
    → (seg, rank, S)) at T = 1, 8,192, 16,384 (the one-block limit),
    16,385 and 65,536: keys of small integers with NaN, ±0.0 and ±inf
    mixed in, one of unique values, all-equal keys (every pass skipped),
    40 keys (more than one launch holds), and segment keys of 1, 3 and
    512 segments, and one too wide for 32 bits."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def keys(T, m):
        out = []
        for i in range(m):
            k = rng.integers(-3, 4, T).astype(np.float32)
            special = rng.random(T) < 0.3
            k[special] = rng.choice(np.array(SPECIAL_KEYS, np.float32), int(special.sum()))
            if i == m - 1:
                k = rng.permutation(T).astype(np.float32)
            out.append(on(k))
        return out

    lex = {}
    for T in (1, 8192, 16384, 16385, 65536):
        lex[f"mixed_{T}"] = (on(rng.permutation(T).astype(np.int64)), keys(T, 5))
        lex[f"identity_{T}"] = (None, keys(T, 3))
    lex["all_equal_8192"] = (None, [on(np.zeros(8192, np.float32))] * 2)
    lex["zeros_and_nans_16384"] = (None, [on(rng.choice(
        np.array([0.0, -0.0, np.nan], np.float32), 16384))])
    lex["forty_keys_8192"] = (on(rng.permutation(8192).astype(np.int64)), keys(8192, 40))
    seg = {}
    for T, S in ((1, 1), (8192, 1), (8192, 3), (8192, 512), (16384, 512), (16385, 3),
                 (65536, 3), (65536, 512), (65536, 70000)):
        rank = rng.permutation(T).astype(np.int32)
        rank[rng.random(T) < 0.2] = 0   # ties in both keys
        seg[f"S{S}_{T}"] = (on(rng.integers(0, S + 1, T).astype(np.int32)), on(rank), S)
    return lex, seg


def phase_k8_edge(device) -> dict:
    """K8's lex_push_many and sort_by_segment on their edge inputs: two
    runs equal and equal to the plain version.  Returns {name:
    max_abs_err}."""
    from kube_batch_tpu_torch.kernels import lex_rank as k8

    lex, seg = k8_edge_inputs(device)
    errs = {"lex_push_many": 0.0, "sort_by_segment": 0.0}
    for name, (perm, keys) in lex.items():
        a, b = k8.lex_push_many(perm, keys), k8.lex_push_many(perm, keys)
        want = k8.lex_push_many_plain(perm, keys)
        errs["lex_push_many"] = max(errs["lex_push_many"], require_equal(
            f"lex_push_many edge {name}", list(zip(a, want)) + list(zip(b, want))))
        log(json.dumps({"phase": "k8-edge", "name": "lex_push_many", "case": name,
                        "rows": keys[0].numel(), "keys": len(keys)}))
    for name, (s, r, S) in seg.items():
        a = k8.sort_by_segment(s, r, S)
        want = k8.sort_by_segment_plain(s, r, S)
        errs["sort_by_segment"] = max(errs["sort_by_segment"], require_equal(
            f"sort_by_segment edge {name}", list(zip(a, want))))
        log(json.dumps({"phase": "k8-edge", "name": "sort_by_segment", "case": name,
                        "rows": s.numel(), "segments": S,
                        "plan": list(k8.sort_plan(s.numel(), S))}))
    return errs


def k2_words_inputs(device, T: int = 4096, N: int = 1024, K: int = 40, K2: int = 36,
                    seed: int = 0):
    """(propose_best's arguments with dyn None, the affinity fields and the
    resident tables of both orientations): seeded requests against node
    capacity, a feasibility mask of about 70 %, both score terms and a
    quantum, and affinity terms as tests/test_torch_affinity.py makes
    them (padded columns, a dead domain)."""
    import numpy as np
    import torch

    from kube_batch_tpu_torch.kernels import resident as k11
    from kube_batch_tpu_torch.kernels.propose import ScoreSpec

    rng = np.random.default_rng(seed)

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    R, TK, D = 4, 3, 16
    cap = rng.integers(4, 9, (N, R)).astype(np.float32) * 1000
    future = (cap * rng.random((N, R))).round().astype(np.float32)
    req = rng.integers(0, 3, (T, R)).astype(np.float32) * 500
    pred = rng.random((T, N)) < 0.7
    args = [on(pred), None, on(req), on(future), on(np.full(R, 1e-3, np.float32)),
            on(rng.random(N) < 0.95), on(rng.random(T) < 0.8), on(future), on(cap),
            ScoreSpec(w_lr=1.0, w_bal=1.0), [], 0.5]

    def hot(shape, p):
        m = (rng.random(shape) < p).astype(np.float32)
        m[T - 8:] = 0.0
        return m

    labels, aff, anti = hot((T, K), 0.15), hot((T, K), 0.01), hot((T, K), 0.005)
    labels[:, K - 5:] = 0.0
    aff_topo, anti_topo = hot((T, K2), 0.01), hot((T, K2), 0.005)
    term_key = rng.integers(0, 2, K2).astype(np.int32)
    term_label = rng.integers(0, K - 5, K2).astype(np.int32)
    nkd = np.full((N, TK), D - 1, np.int32)
    nkd[:N - 4, 0] = rng.integers(0, 6, N - 4)
    nkd[:N - 4, 1] = rng.integers(6, 10, N - 4)
    state = rng.integers(0, 10, T).astype(np.int32)
    node = rng.integers(-1, N - 4, T).astype(np.int32)
    fields = [on(x) for x in (aff, anti, labels, aff_topo, anti_topo, term_key,
                              term_label, nkd)]
    task_mask = on(np.arange(T) < T - 8)
    tables = {rel: k11.resident_tables_plain(
        fields[2], fields[1], fields[4], on(node), on(state), task_mask, fields[7],
        fields[5], fields[6], N, D, rel) for rel in (False, True)}
    Hb, Ab, Hd, Ad = tables[False]
    Hbn, Abn, Hdn, Adn = tables[True]
    return args, fields, (Hb, Hbn, Abn, Hd, Hdn, Adn)


def phase_words_edge(device) -> dict:
    """K10's affinity_words and K2's words form on seeded inputs: the
    words equal the plain version's (built and kept task words); K2's
    two passes given the words equal their plain versions and K2 given
    the mask K10 makes from the same tables; and, on a world with no
    terms (every word 0), K2 given the words equals K2 given no
    predicate.  Returns {name: max_abs_err}."""
    import torch

    from kube_batch_tpu_torch.kernels import affinity as k10
    from kube_batch_tpu_torch.kernels import propose as k2

    args, fields, tables = k2_words_inputs(device)
    errs = {"affinity_words": 0.0, "propose_best": 0.0, "propose_pick": 0.0}

    def words_equal(name, got, want):
        return require_equal(name, [(got.node_words, want.node_words),
                                    (got.task_words, want.task_words),
                                    (got.thr, want.thr)])

    built = k10.affinity_words(*fields, *tables, None)
    want = k10.affinity_words_plain(*fields, *tables, None)
    kept = k10.affinity_words(*fields, *tables, built.task_words)
    errs["affinity_words"] = max(words_equal("affinity_words edge built", built, want),
                                 words_equal("affinity_words edge kept", kept, want))
    mask = k10.affinity_mask(*fields, *tables)
    require_equal("affinity words against mask", [(k10.affinity_cells_plain(want), mask)])
    no_terms = [torch.zeros_like(x) for x in fields[:5]] + fields[5:]
    empty = k10.affinity_words(*no_terms, *tables, None)
    if bool(empty.task_words.any()):
        fail("affinity_words edge: a world with no terms has task words")

    def pick_args(best_args, best):
        b, ties, active = best
        k = torch.remainder(torch.arange(ties.numel(), device=device, dtype=torch.int32),
                            torch.clamp(ties, min=1))
        return best_args + [b, active, k]

    cases = {"words": built, "no_terms": empty}
    for name, dyn in cases.items():
        a = list(args)
        a[1] = dyn
        best = k2.propose_best(*a)
        errs["propose_best"] = max(errs["propose_best"], require_equal(
            f"propose_best edge {name}", list(zip(best, k2.propose_best_plain(*a)))))
        ref = list(args)
        ref[1] = mask if name == "words" else None
        errs["propose_best"] = max(errs["propose_best"], require_equal(
            f"propose_best edge {name} against the mask form",
            list(zip(best, k2.propose_best(*ref)))))
        pa = pick_args(a, best)
        prop = k2.propose_pick(*pa)
        errs["propose_pick"] = max(errs["propose_pick"], require_equal(
            f"propose_pick edge {name}", [(prop, k2.propose_pick_plain(*pa)),
                                          (prop, k2.propose_pick(*pick_args(ref, best)))]))
        log(json.dumps({"phase": "k2-words-edge", "case": name,
                        "tasks": a[2].shape[0], "nodes": a[3].shape[0],
                        "active": int(best[2].sum()),
                        "vetoed_cells": int((~mask).sum()) if name == "words" else 0}))
    return errs


# ---------------------------------------------------------------------------
# worlds
# ---------------------------------------------------------------------------

_POD_SPEC = ("request", "priority", "namespace", "selector", "labels",
             "affinity", "anti_affinity", "pod_prefs", "preferences",
             "tolerations", "ports", "claims")


def arrivals(cache, sim, n_pods: int) -> int:
    """A second wave of the world's own jobs: its first jobs, in
    submission order, submitted again under new names (same requests,
    gangs, queues and constraints) until `n_pods` pods have arrived."""
    from kube_batch_tpu_torch.cache.cluster import Pod, PodGroup

    with cache.lock():
        jobs = [(j.pod_group, list(j.tasks.values()))
                for j in cache._jobs.values()]
    sent = 0
    for group, pods in jobs:
        if sent >= n_pods:
            break
        if not pods:
            continue
        sim.submit(
            PodGroup(name=f"late-{group.name}", queue=group.queue,
                     min_member=group.min_member, priority=group.priority),
            [Pod(name=f"late-{p.name}", **{f: getattr(p, f) for f in _POD_SPEC})
             for p in pods],
        )
        sent += len(pods)
    return sent


class RefuseFirstBinds:
    """Binder that refuses the first bind of every 23rd pod (by a hash of
    its name) and passes every other bind to the simulator.  The cache
    resets a refused pod to Pending and queues it for resync; the next
    cycle drains the queue and places the pod again."""

    def __init__(self, sim) -> None:
        self.sim = sim
        self.refused: set[str] = set()

    def bind(self, pod, node_name: str) -> None:
        if pod.name not in self.refused and zlib.crc32(pod.name.encode()) % 23 == 0:
            self.refused.add(pod.name)
            raise RuntimeError("bind refused once by the smoke test")
        self.sim.bind(pod, node_name)


def _feature_world():
    """Every kernel option of the default conf at once: selectors,
    taints, host ports, volume pins and volume groups (K1); required
    node- and zone-scoped affinity / anti-affinity, soft pod-affinity
    and preferred node labels (K2's dynamic mask and both additive
    score terms; K3's serialize set and the domain / bootstrap serialize
    glue)."""
    import random

    from kube_batch_tpu_torch.cache.cluster import Claim, PodGroup, StorageClass
    from kube_batch_tpu_torch.models.workloads import DEFAULT_SPEC, GI, _node, _pod
    from kube_batch_tpu_torch.sim.simulator import make_world

    rng = random.Random(0)
    cache, sim = make_world(DEFAULT_SPEC)
    for i in range(64):
        sim.add_node(_node(
            f"n{i}", cpu_milli=16000, mem=64 * GI,
            labels={"zone": f"z{i % 4}", "disk": "ssd" if i % 3 == 0 else "hdd"},
            taints=(frozenset({"gpu=only:NoSchedule"}) if i % 8 == 0
                    else frozenset()),
        ))
    sim.add_storage_class(StorageClass(
        name="ssd-local", allowed_node_labels=frozenset({"disk=ssd"})
    ))
    sim.add_claim(Claim(name="pinned", bound_node="n5"))
    sim.add_claim(Claim(name="fast", storage_class="ssd-local"))
    apps = ["web", "cache", "db", "api", "batch"]
    for j in range(60):
        app = apps[j % len(apps)]
        kw = {"labels": {"app": app}}
        if app == "web":
            kw["anti_affinity"] = frozenset({"app=web"})
            kw["ports"] = frozenset({8080})
        elif app == "cache":
            kw["affinity"] = frozenset({"app=cache"})
        elif app == "db":
            kw["anti_affinity"] = frozenset({"zone:app=db"})
            kw["pod_prefs"] = {"app=web": 2.0, "zone:app=cache": 1.0}
            kw["claims"] = frozenset({"fast"})
        elif app == "api":
            kw["affinity"] = frozenset({"zone:app=web"})
            kw["preferences"] = {"disk=ssd": 3.0, "zone=z1": 1.0}
            kw["selector"] = {"zone": rng.choice(["z0", "z1", "z2"])}
        else:
            kw["tolerations"] = frozenset({"gpu=only:NoSchedule"})
            if j == 4:
                kw["claims"] = frozenset({"pinned"})
        n = rng.choice([2, 4, 6])
        sim.submit(PodGroup(name=f"{app}{j}", queue="default",
                            min_member=n if app == "cache" else 1), [
            _pod(f"{app}{j}-{i}", cpu=rng.choice([500, 1000, 2000]),
                 mem=rng.choice([1, 2, 4]) * GI, **kw)
            for i in range(n)
        ])
    return cache, sim


def config5_affinity(n_nodes: int = 5000, target_pods: int = 50000, seed: int = 0):
    """The affinity path's world at full size (padded T = 65,536, N = 8,192):
    models/workloads.py · config5_affinity_world, with the uid counter
    restarted so a run in any process builds the identical cluster."""
    import itertools

    import kube_batch_tpu_torch.cache.cluster as cluster
    from kube_batch_tpu_torch.models.workloads import config5_affinity as build

    cluster._uid_counter = itertools.count()
    return build(n_nodes=n_nodes, target_pods=target_pods, seed=seed)


def config5_affinity_mid():
    """The same world at 500 nodes and 5,000 pods (13 racks)."""
    return config5_affinity(n_nodes=500, target_pods=5000)


# world: (world factory, pods of the second wave, examples/scheduler.conf or the
# default conf, the joint solve or the actions in sequence)
PARITY_WORLDS = {
    "config3": (lambda: _config(3), 300, False, False),
    "config4": (lambda: _config(4), 0, False, False),
    "config5_mid": (lambda: _config(5, n_nodes=500, target_pods=5000), 1500, False,
                    False),
    "features": (_feature_world, 60, False, False),
    "features_preempt": (_feature_world, 60, True, False),
    "config5_affinity_mid": (config5_affinity_mid, 1500, False, False),
    "config5_affinity_mid_preempt": (config5_affinity_mid, 1500, True, False),
    "features_preempt_joint": (_feature_world, 60, True, True),
    "config5_affinity_mid_preempt_joint": (config5_affinity_mid, 1500, True, True),
}


def _config(n: int, **kw):
    from kube_batch_tpu_torch.models.workloads import build_config

    return build_config(n, seed=0, **kw)


def scheduler_conf():
    """examples/scheduler.conf: allocate, backfill, preempt, reclaim."""
    from kube_batch_tpu_torch.framework.conf import parse_conf

    with open(os.path.join(ROOT, "examples", "scheduler.conf")) as f:
        return parse_conf(f.read())


def preempt_world():
    """Full-size config 4, with the uid counter restarted so a run in
    any process builds the identical cluster."""
    import itertools

    import kube_batch_tpu_torch.cache.cluster as cluster

    cluster._uid_counter = itertools.count()
    return _config(4)


def preempt_wave(sim, cluster=None, workloads=None) -> int:
    """Submit PREEMPT_WAVE, the wave after the preempt path's first
    cycle, built from `cluster` and `workloads` (a package's cache.cluster
    and models.workloads modules; the port's by default); returns its
    pods."""
    if cluster is None:
        import kube_batch_tpu_torch.cache.cluster as cluster
        import kube_batch_tpu_torch.models.workloads as workloads

    sim.add_queue(cluster.Queue(name="research", weight=RESEARCH_WEIGHT))
    sent = 0
    for prefix, queue, prio, gangs, cpu, mem in PREEMPT_WAVE:
        for j in range(gangs):
            sim.submit(
                cluster.PodGroup(name=f"{prefix}{j}", queue=queue, min_member=4,
                                 priority=prio),
                [workloads._pod(f"{prefix}{j}-{i}", cpu=cpu, mem=mem * workloads.GI,
                                priority=prio)
                 for i in range(4)],
            )
            sent += 4
    return sent


# ---------------------------------------------------------------------------
# recording the kernels' inputs on a run
# ---------------------------------------------------------------------------

# Argument positions each wrapper's caller writes in place after (or,
# for apply and row_patch, during) the call, and inputs a later pack may
# row-patch (the snapshot, its fields): these are cloned when recorded.
_MUTATED = {
    "predicate_mask": (0,),      # the snapshot
    "propose_best": (3, 7),      # avail, node_future
    "propose_pick": (3, 7),
    "resolve": (3,),             # avail
    "apply": (4, 5, 8, 9),       # node_future, node_idle, task_state, task_node
    "failure_counts": (2,),      # node_idle
    "victim_prefix": (),
    "preempt_open": (),
    "preempt_continue": (),
    "segment_sum": (),
    "segment_count": (),
    "waterfill": (),
    "lex_push_many": (0, 1),
    "sort_by_segment": (0, 1),
    "vtime": (0, 1, 2, 3),
    "row_patch": (0,),           # the device buffers, written in place
    "resident_tables": (3, 4),   # task_node, task_state
    "affinity_mask": (),
    "affinity_row": (),
    "affinity_words": (),
    "tier_control": (5, 11, 12, 13, 15, 16, 17),   # written in place
}
# Arguments that are snapshot fields, constant within a cycle but
# row-patched by the next pack: cloned once per cycle and shared by the
# calls of that cycle.
_SNAPSHOT_ARGS = {
    "resident_tables": (0, 1, 2, 5, 6, 7, 8),
    "affinity_mask": tuple(range(8)),
    "affinity_row": tuple(range(8)),
    "affinity_words": tuple(range(8)),
    "tier_control": (6, 7, 10, 14),
}


def _keep(a):
    """A copy of one recorded argument: tensors, lists of them, and
    snapshots (every field)."""
    import dataclasses

    import torch

    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, list):
        return [_keep(x) for x in a]
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: getattr(a, f.name).clone() for f in dataclasses.fields(a)})
    return a


class Recorder:
    """While active, every kernel wrapper call of the scheduler goes
    through unchanged (it launches and counts as before) and its inputs
    are kept: `calls[name]` lists (cycle, round, args) — of a kernel
    named in `every`, every `every[name]`-th call.  A cycle starts at its
    predicate-mask call and a round at its propose_best call.  Arguments
    a caller writes in place are cloned per call, snapshot fields once
    per cycle (the next pack row-patches them)."""

    def __init__(self, every: dict | None = None) -> None:
        import kube_batch_tpu_torch.plugins.predicates as plug
        from kube_batch_tpu_torch.kernels import (
            failure_counts,
            lex_rank,
            preempt_scan,
            propose,
            resolve,
            row_patch,
            segment_sum,
            victim_prefix,
        )

        self.sites = [
            (plug, "predicate_mask", "predicate_mask"),
            (propose, "propose_best", "propose_best"),
            (propose, "propose_pick", "propose_pick"),
            (resolve, "resolve", "resolve"),
            (resolve, "apply", "apply"),
            (failure_counts, "failure_counts", "failure_counts"),
            (victim_prefix, "victim_prefix", "victim_prefix"),
            (preempt_scan, "preempt_open", "preempt_open"),
            (preempt_scan, "preempt_continue", "preempt_continue"),
            (segment_sum, "segment_sum", "segment_sum"),
            (segment_sum, "segment_count", "segment_count"),
            (segment_sum, "waterfill", "waterfill"),
            (lex_rank, "lex_push_many", "lex_push_many"),
            (lex_rank, "sort_by_segment", "sort_by_segment"),
            (lex_rank, "vtime", "vtime"),
            (row_patch, "row_patch", "row_patch"),
        ]
        from kube_batch_tpu_torch.kernels import affinity, joint_tier, resident

        self.sites += [
            (resident, "resident_tables", "resident_tables"),
            (affinity, "affinity_mask", "affinity_mask"),
            (affinity, "affinity_row", "affinity_row"),
            (affinity, "affinity_words", "affinity_words"),
            (joint_tier, "tier_control", "tier_control"),
        ]
        self.calls = {name: [] for name in _MUTATED}
        self.seen = {name: 0 for name in _MUTATED}
        self.cycle = self.round = -1
        self.every = every or {}
        self._saved = []
        self._memo = {}

    def _cycle_clone(self, a):
        """One clone per cycle of a snapshot field (None stays None)."""
        if a is None:
            return None
        key = (self.cycle, a.data_ptr(), tuple(a.shape), a.dtype)
        if key not in self._memo:
            self._memo[key] = a.clone()
        return self._memo[key]

    def _wrap(self, name, fn):
        mutated = _MUTATED[name]
        shared = _SNAPSHOT_ARGS.get(name, ())
        every = self.every.get(name, 1)

        def wrapper(*args):
            if name == "predicate_mask":
                self.cycle += 1
            elif name == "propose_best":
                self.round += 1
            self.seen[name] += 1
            if self.seen[name] % every == 0:
                kept = tuple(_keep(a) if i in mutated
                             else self._cycle_clone(a) if i in shared else a
                             for i, a in enumerate(args))
                self.calls[name].append((self.cycle, self.round, kept))
            return fn(*args)

        return wrapper

    def __enter__(self):
        for mod, attr, name in self.sites:
            fn = getattr(mod, attr)
            w = self._wrap(name, fn)
            # A wrapper counts its launches on its module's global name,
            # which is `w` while patched: `w` counts on from `fn`'s count.
            w.launches = fn.launches
            self._saved.append((mod, attr, fn, w, fn.launches))
            setattr(mod, attr, w)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn, w, start in self._saved:
            setattr(mod, attr, fn)
            fn.launches += w.launches - start
        self._saved = []


# ---------------------------------------------------------------------------
# kernel against plain version, on recorded inputs
# ---------------------------------------------------------------------------

def _fresh_apply_args(args):
    return tuple(a.clone() if i in _MUTATED["apply"] else a
                 for i, a in enumerate(args))


def check_call(name: str, args):
    """Run kernel and plain version on `args`; require equal outputs.
    Returns (max_abs_err, {what: count of non-trivial outputs})."""
    import torch

    from kube_batch_tpu_torch.kernels import failure_counts as k4
    from kube_batch_tpu_torch.kernels import lex_rank as k8
    from kube_batch_tpu_torch.kernels import predicate_mask as k1
    from kube_batch_tpu_torch.kernels import preempt_scan as k6
    from kube_batch_tpu_torch.kernels import propose as k2
    from kube_batch_tpu_torch.kernels import resolve as k3
    from kube_batch_tpu_torch.kernels import row_patch as k9
    from kube_batch_tpu_torch.kernels import segment_sum as k7
    from kube_batch_tpu_torch.kernels import victim_prefix as k5

    if name == "victim_prefix":
        k, out = k5.victim_prefix(*args)
        err = require_equal(name, list(zip((k, out), k5.victim_prefix_plain(*args))))
        return err, {"nodes_some_victims": int(((k > 0) & (k < k5.BIG_K)).sum()),
                     "nodes_no_prefix": int((k == k5.BIG_K).sum()),
                     "node_found": int(out[1])}
    if name == "preempt_open":
        out = k6.preempt_open(*args)
        err = require_equal(name, [(out, k6.preempt_open_plain(*args))])
        return err, {"direct_fit_true": int(out[3]),
                     "direct_fit_false": 1 - int(out[3])}
    if name == "preempt_continue":
        out = k6.preempt_continue(*args)
        err = require_equal(name, [(out, k6.preempt_continue_plain(*args))])
        return err, {"victim_found": int(out[1]), "no_victim_left": 1 - int(out[1])}
    if name in ("segment_sum", "segment_count"):
        values, seg, num = args[:3]
        out = getattr(k7, name)(*args)
        err = require_equal(name, [(out, k7.segment_sum_plain(values, seg, num))])
        return err, {"nonempty_segments": int(torch.unique(seg[seg < num]).numel())}
    if name == "waterfill":
        out = k7.waterfill(*args)
        err = require_equal(name, [(out, k7.waterfill_plain(*args))])
        return err, {"queues": int(args[3].sum()),
                     "queues_below_request": int((out < args[1]).any(dim=1).sum())}
    if name == "predicate_mask":
        snap = args[0]
        out = k1.predicate_mask(*args)
        err = require_equal(name, [(out, k1.predicate_mask_plain(*args))])
        real = snap.task_mask[:, None] & snap.node_mask[None, :]
        return err, {"real_cells": int(real.sum()),
                     "vetoed_cells": int((real & ~out).sum())}
    if name == "propose_best":
        out = k2.propose_best(*args)
        err = require_equal(name, list(zip(out, k2.propose_best_plain(*args))))
        best, ties, active = out
        return err, {"active": int(active.sum()),
                     "multi_tie_rows": int((active & (ties > 1)).sum())}
    if name == "propose_pick":
        out = k2.propose_pick(*args)
        err = require_equal(name, [(out, k2.propose_pick_plain(*args))])
        active, k = args[13], args[14]
        return err, {"active": int(active.sum()),
                     "picked_past_first_tie": int((active & (k > 0)).sum())}
    if name == "resolve":
        perm, s_node, avail = args[0], args[1], args[3]
        out = k3.resolve(*args)
        err = require_equal(name, [(out, k3.resolve_plain(*args))])
        proposers = int((s_node < avail.shape[0]).sum())
        accepted = int(out[perm][s_node < avail.shape[0]].sum())
        return err, {"proposers": proposers, "accepted": accepted,
                     "rejected": proposers - accepted}
    if name == "apply":
        a_k, a_p = _fresh_apply_args(args), _fresh_apply_args(args)
        k3.apply(*a_k)
        k3.apply_plain(*a_p)
        err = require_equal(name, [(a_k[i], a_p[i]) for i in (4, 5, 8, 9)])
        return err, {"accepted": int(args[2].sum()),
                     "rows_changed": int((a_k[8] != args[8]).sum())}
    if name == "lex_push_many":
        perm, rank = k8.lex_push_many(*args)
        err = require_equal(name, list(zip((perm, rank), k8.lex_push_many_plain(*args))))
        ks = args[1][-1][perm]
        return err, {"rows": int(perm.numel()), "keys": len(args[1]),
                     "tied_rows": int((ks[1:] == ks[:-1]).sum())}
    if name == "sort_by_segment":
        out = k8.sort_by_segment(*args)
        err = require_equal(name, list(zip(out, k8.sort_by_segment_plain(*args))))
        return err, {"segments": int(torch.unique(out[1]).numel())}
    if name == "vtime":
        out = k8.vtime(*args)
        err = require_equal(name, [(out, k8.vtime_plain(*args))])
        return err, {"valid_rows": int(args[3].sum()),
                     "big_vtime_rows": int((out >= k8.BIG_VTIME).sum())}
    if name == "row_patch":
        bufs, rows, vals = args
        a_k, a_p = [b.clone() for b in bufs], [b.cpu() for b in bufs]
        k9.row_patch(a_k, rows, vals)
        k9.row_patch_plain(a_p, rows, vals)
        err = require_equal(name, [(k.cpu(), p) for k, p in zip(a_k, a_p)])
        return err, {"fields": len(bufs), "rows": sum(len(r) for r in rows)}
    if name == "resident_tables":
        from kube_batch_tpu_torch.kernels import resident as k11

        out = k11.resident_tables(*args)
        want = k11.resident_tables_plain(*args)
        err = require_equal(name, [(a, b) for a, b in zip(out, want) if a is not None])
        if (out[2] is None) != (want[2] is None):
            fail(f"{name}: domain tables differ in presence from the plain version")
        return err, {"present_cells": int(out[0].sum()),
                     "releasing_calls": int(bool(args[11])),
                     "domain_cells": 0 if out[2] is None else int(out[2].sum())}
    if name == "affinity_words":
        from kube_batch_tpu_torch.kernels import affinity as k10

        got, want = k10.affinity_words(*args), k10.affinity_words_plain(*args)
        err = require_equal(name, [(got.node_words, want.node_words),
                                   (got.task_words, want.task_words),
                                   (got.thr, want.thr)])
        return err, {"task_words_kept": int(args[14] is not None),
                     "rows_with_terms": int(got.task_words.any(dim=1).sum())}
    if name in ("affinity_mask", "affinity_row"):
        from kube_batch_tpu_torch.kernels import affinity as k10

        out = getattr(k10, name)(*args)
        err = require_equal(name, [(out, getattr(k10, f"{name}_plain")(*args))])
        return err, {"vetoed_cells": int((~out).sum())}
    if name == "tier_control":
        from kube_batch_tpu_torch.kernels import joint_tier as k12

        inplace = _MUTATED[name]
        a_k = [a.clone() if i in inplace else a for i, a in enumerate(args)]
        a_p = [a.clone() if i in inplace else a for i, a in enumerate(args)]
        fk = k12.tier_control(*a_k)
        fp = k12.tier_control_plain(*a_p)
        err = require_equal(name, [(fk.cpu(), fp)] + [(a_k[i], a_p[i]) for i in inplace])
        done, plan_open = int(fk[0]), int(args[4][1])
        return err, {"done": done, "not_done": 1 - done,
                     "discarded_plans": int(done and plan_open)}
    if name == "failure_counts":
        out = k4.failure_counts(*args)
        err = require_equal(name, list(zip(out, k4.failure_counts_plain(*args))))
        pf, ins, fe = out
        return err, {"rows_predicate_failed": int((pf > 0).sum()),
                     "rows_insufficient": int((ins > 0).any(dim=1).sum()),
                     "rows_feasible": int((fe > 0).sum())}
    raise KeyError(name)


def check_all(rec: Recorder, names=None) -> dict:
    """Hold every recorded call of `names` (default: every kernel) against
    the plain version; per kernel, the calls checked and made, the sums of
    the non-trivial-output counts and the largest error."""
    totals = {}
    for name in names or rec.calls:
        acc = {"calls": len(rec.calls[name]), "calls_made": rec.seen[name]}
        err = 0.0
        for _cycle, _round, args in rec.calls[name]:
            e, counts = check_call(name, args)
            err = max(err, e)
            for k, v in counts.items():
                acc[k] = acc.get(k, 0) + v
        acc["max_abs_err"] = err
        totals[name] = acc
    return totals


def segment_sum_timing(args):
    """(ms, plain_ms, library_ms, bound) of K7's segment_sum on `args`
    (values, seg, S, order, offsets); the library call is one float64
    `index_add_` of the same rows.  The bound counts what the function
    needs on this call's data: the ids of every row, the values of the
    rows kept (seg < S) and the sums; the segment index is this design's,
    not the function's."""
    import torch

    from kube_batch_tpu_torch.kernels import segment_sum as k7

    values, seg, num = args[:3]
    C = values[0].numel()
    kept = int((seg < num).sum())
    idx, vals64 = seg.long(), values.double()
    acc64 = torch.zeros((num + 1,) + tuple(values.shape[1:]), dtype=torch.float64,
                        device=values.device)
    return (time_ms(lambda: k7.segment_sum(*args)),
            time_ms(lambda: k7.segment_sum_plain(values, seg, num)),
            time_ms(lambda: acc64.index_add_(0, idx, vals64)),
            bound(seg.numel() * seg.element_size() + kept * C * 4 + num * C * 4,
                  kept * C, F64_OPS_PER_S))


def segment_count_timing(args):
    """(ms, plain_ms, library_ms, bound) of K7's segment_count on `args`;
    the library call is one int32 `index_add_` of the same rows."""
    import torch

    from kube_batch_tpu_torch.kernels import segment_sum as k7

    values, seg, num = args
    C = values[0].numel()
    idx, vals32 = seg.long(), values.int()
    acc32 = torch.zeros((num + 1,) + tuple(values.shape[1:]), dtype=torch.int32,
                        device=values.device)
    return (time_ms(lambda: k7.segment_count(*args)),
            time_ms(lambda: k7.segment_sum_plain(*args)),
            time_ms(lambda: acc32.index_add_(0, idx, vals32)),
            bound(seg.numel() * (seg.element_size() + values.element_size() * C)
                  + num * C * 4, values.numel()))


def widest_float_sum(calls):
    return max(calls, key=lambda a: a[0].numel())


def widest_count(calls):
    return max(calls, key=lambda a: a[1].numel())


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def _cycle_record(ssn, sched) -> dict:
    return {
        "binds": list(ssn.bound),
        "evicted": list(ssn.evicted),
        "task_state": ssn.host_task_state.copy(),
        "task_node": ssn.host_task_node.copy(),
        "job_ready": ssn.job_ready.copy(),
        "diag": {k: v.cpu().numpy() for k, v in ssn.diag.items()},
        "rounds": dict(sched.last_stats),
    }


def _brief(stats: dict) -> dict:
    """A cycle's stats with each preemption loop cut to its step count."""
    out = {}
    for k, v in stats.items():
        if k.endswith("_steps"):
            out[k] = [loop["steps"] for loop in v]
        else:
            out[k] = v
    return out


def _run(world: str, device: str, record: bool):
    from kube_batch_tpu_torch.scheduler import Scheduler

    build, wave, preempt, joint = PARITY_WORLDS[world]
    cache, sim = build()
    binder = RefuseFirstBinds(sim)
    cache.binder = binder
    sched = Scheduler(cache, conf=scheduler_conf() if preempt else None,
                      device=device, joint_solve=joint)
    if sched.cycle_kind != ("joint" if joint else "sequential"):
        fail(f"{world}: the scheduler runs the {sched.cycle_kind} cycle")
    rec = Recorder(PREEMPT_EVERY if preempt else None) if record else None
    cycles = []
    for cycle in range(2):
        if rec is not None:
            with rec:
                ssn = sched.run_once()
        else:
            ssn = sched.run_once()
        if ssn is None:
            fail(f"{world}: cycle {cycle} found nothing to solve")
        cycles.append(_cycle_record(ssn, sched))
        sim.tick()
        if cycle == 0 and wave:
            arrivals(cache, sim, wave)
    return cycles, len(binder.refused), rec


def _same(a, b) -> bool:
    import numpy as np

    if a["binds"] != b["binds"] or a["evicted"] != b["evicted"]:
        return False
    for key in ("task_state", "task_node", "job_ready"):
        if not np.array_equal(a[key], b[key]):
            return False
    return a["diag"].keys() == b["diag"].keys() and all(
        np.array_equal(a["diag"][k], b["diag"][k]) for k in a["diag"]
    )


def parity_cpu(root: str, world: str):
    """A parity world's CPU run, in a worker process (spawned: a fresh
    import that never touches the card); returns (cycles, seconds)."""
    import torch

    sys.path.insert(0, root)
    torch.set_num_threads(2)
    t0 = time.perf_counter()
    try:
        cycles = _run(world, "cpu", record=False)[0]
    except SystemExit:  # fail() exits; a pool worker must return instead
        raise RuntimeError(f"the CPU run of parity world {world} failed") from None
    return cycles, time.perf_counter() - t0


def phase_parity(cpu_runs):
    """Every parity world on the card, held against its CPU run
    (`cpu_runs[world]`, an async result of `parity_cpu`); returns the
    launch counts and the Recorder of ROW_WORLD's card run (the run that
    gives K10's row form its launches)."""
    from kube_batch_tpu_torch import kernels

    seen = {}
    row_counts = row_rec = None
    for world in PARITY_WORLDS:
        t0 = time.perf_counter()
        kernels.reset_counts()
        gpu, refused, rec = _run(world, "cuda", record=True)
        if world == ROW_WORLD:
            row_counts, row_rec = kernels.counts(), rec
        t1 = time.perf_counter()
        cpu, cpu_s = cpu_runs[world].get(timeout=1200)
        t2 = time.perf_counter()
        for c, (g, h) in enumerate(zip(gpu, cpu)):
            if not _same(g, h):
                fail(f"{world}: cycle {c} decisions or failure tallies differ "
                     "between cuda and cpu")
        checks = check_all(rec)
        for name, acc in checks.items():
            for k, v in acc.items():
                seen[(name, k)] = seen.get((name, k), 0) + v
        log(json.dumps({
            "phase": "parity", "world": world, "cycles": 2,
            "bound_per_cycle": [len(c["binds"]) for c in gpu],
            "evicted_per_cycle": [len(c["evicted"]) for c in gpu],
            "rounds_per_cycle": [_brief(c["rounds"]) for c in gpu],
            "binds_refused_once": refused,
            "cuda_s": round(t1 - t0, 3), "cpu_worker_s": round(cpu_s, 3),
            "waited_for_cpu_s": round(t2 - t1, 3),
            "cycle_kind": gpu[-1]["rounds"].get("cycle"), "identical": True,
        }))
        log(json.dumps({"phase": "parity-kernels", "world": world,
                        "equal_to_plain": True, **checks}))
    # every check must have met a non-trivial case somewhere
    for key in (("predicate_mask", "vetoed_cells"), ("propose_best", "multi_tie_rows"),
                ("propose_pick", "picked_past_first_tie"), ("resolve", "rejected"),
                ("apply", "rows_changed"), ("failure_counts", "rows_predicate_failed"),
                ("failure_counts", "rows_insufficient"), ("lex_push_many", "tied_rows"),
                ("sort_by_segment", "segments"), ("vtime", "valid_rows"),
                ("resident_tables", "present_cells"),
                ("resident_tables", "releasing_calls"),
                ("resident_tables", "domain_cells"),
                ("affinity_mask", "vetoed_cells"), ("affinity_row", "vetoed_cells"),
                ("affinity_words", "rows_with_terms"),
                ("tier_control", "done"), ("tier_control", "not_done")):
        if seen.get(key, 0) <= 0:
            fail(f"parity worlds never gave {key[0]} a case with {key[1]} > 0")
    log(json.dumps({"phase": "parity-row-world", "world": ROW_WORLD,
                    "affinity_row_launches": row_counts["affinity_row"]}))
    if row_counts["affinity_row"] <= 0:
        fail(f"{ROW_WORLD}: kernel affinity_row was not launched")
    return row_counts, row_rec


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def _check_invariants(cache, gangs: bool = True):
    """No node over-committed; with `gangs`, every gang with a placed
    member holds at least minMember placed members."""
    import numpy as np

    from kube_batch_tpu_torch.api.types import READY_STATUSES, TaskStatus

    with cache.lock():
        for name, info in cache._nodes.items():
            if np.any(info.used > info.allocatable):
                fail(f"node {name} over-committed: used {info.used} > "
                     f"allocatable {info.allocatable}")
        if not gangs:
            return
        placed = {TaskStatus.BINDING, TaskStatus.BOUND, TaskStatus.RUNNING}
        for jname, job in cache._jobs.items():
            pods = job.tasks.values()
            if any(p.status in placed for p in pods):
                held = sum(1 for p in pods if p.status in READY_STATUSES)
                if held < job.min_available:
                    fail(f"gang {jname}: {held} members placed, "
                         f"min_member {job.min_available}")


def _check_binds_allowed(ssn):
    """Every bind of the cycle lands on a node its own snapshot's
    predicate mask allows (plain version; launches nothing).  Called
    right after the cycle: the next pack row-patches the snapshot."""
    from kube_batch_tpu_torch.kernels.predicate_mask import (
        PredicateFlags,
        predicate_mask_plain,
    )

    pred = predicate_mask_plain(ssn.snap, PredicateFlags()).cpu().numpy()
    task_idx = {p.name: i for i, p in enumerate(ssn.meta.task_pods)}
    node_idx = {n: i for i, n in enumerate(ssn.meta.node_names)}
    for pod_name, node_name in ssn.bound:
        if not pred[task_idx[pod_name], node_idx[node_name]]:
            fail(f"bind {pod_name} -> {node_name} violates the predicate mask")


def phase_main_path(device, wave: int = MAIN_WAVE_PODS, **world_kw):
    import torch

    from kube_batch_tpu_torch import kernels
    from kube_batch_tpu_torch.models.workloads import config5_full
    from kube_batch_tpu_torch.scheduler import Scheduler

    cache, sim = config5_full(seed=0, **world_kw)
    sched = Scheduler(cache, device=device)
    cuda = device.type == "cuda"
    rec = Recorder(MAIN_EVERY)
    sessions = []
    kernels.reset_counts()
    with rec:
        for cycle in range(2):
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            ssn = sched.run_once()
            wall_ms = (time.perf_counter() - t0) * 1e3
            if ssn is None:
                fail(f"main path: cycle {cycle} found nothing to solve")
            rec_line = {"phase": "main-path", "cycle": cycle,
                        "tasks": ssn.meta.num_real_tasks,
                        "bound": len(ssn.bound), "wall_ms": round(wall_ms, 3)}
            rec_line.update({k: v for k, v in sched.last_stats.items() if k != "cycle"})
            rec_line.update({k: round(v, 3) for k, v in sched.last_timings.items()})
            if cuda:
                rec_line["peak_mem_bytes"] = torch.cuda.max_memory_allocated(device)
            log(json.dumps(rec_line))
            _check_binds_allowed(ssn)
            sessions.append((ssn.snap.num_tasks, len(ssn.bound)))
            sim.tick()
            if cycle == 0:
                t0 = time.perf_counter()
                n = arrivals(cache, sim, wave)
                log(json.dumps({"phase": "main-path-arrivals", "pods": n,
                                "submit_ms": round((time.perf_counter() - t0) * 1e3, 3)}))
    counts = kernels.counts()
    log(json.dumps({"phase": "main-path-launches", **counts}))
    for name, n in counts.items():
        if n <= 0 and name not in NOT_ON_MAIN_PATH:
            fail(f"kernel {name} was not launched on the main path")
    if sessions[1][0] != sessions[0][0]:
        fail("the second wave changed the padded task count")
    if not sessions[0][1] or not sessions[1][1]:
        fail("a main-path cycle bound nothing")
    _check_invariants(cache)
    log(json.dumps({"phase": "invariants", "capacity": True, "gang": True,
                    "predicate": True}))
    return counts, rec


# ---------------------------------------------------------------------------
# the host cycle: incremental packs on config 5 under churn
# ---------------------------------------------------------------------------

def host_churn(cache, sim, cycle: int, arrive: bool) -> dict:
    """The churn after host-cycle `cycle`: the tick runs the bound pods
    (and deletes and recreates the pods evicted before it); every
    HOST_DONE_EVERY-th running pod (by name) completes or, every other
    one, is deleted (a swap-compaction of its row); one node's cpu grows
    by 1,000 milli (a node-accounting row).  With `arrive`,
    HOST_ARRIVAL_PODS pods arrive into existing jobs (copies of each
    job's first pod: interned vocabularies, an append of rows); without,
    HOST_EVICTED running pods are evicted (Releasing), so the next cycle
    still has work.  The same calls on two identical worlds make
    identical worlds, uids included."""
    import dataclasses
    import itertools

    import kube_batch_tpu_torch.cache.cluster as cluster
    from kube_batch_tpu_torch.api.types import TaskStatus

    cluster._uid_counter = itertools.count(10**7 * (cycle + 1))
    sim.tick()
    with cache.lock():
        running = sorted((p.name, p.uid) for p in cache._pods.values()
                         if p.status == TaskStatus.RUNNING)
        shapes = [(name, next(iter(job.tasks.values())))
                  for name, job in sorted(cache._jobs.items()) if job.tasks]
        node = cache._nodes[sorted(cache._nodes)[cycle]].node
    done = running[cycle % HOST_DONE_EVERY::HOST_DONE_EVERY]
    for k, (_name, uid) in enumerate(done):
        if k % 2:
            sim.delete_pod(uid)
        else:
            cache.update_pod_status(uid, TaskStatus.SUCCEEDED)
    sent = evicted = 0
    if arrive:
        for group, pod in shapes[cycle::7]:
            if sent >= HOST_ARRIVAL_PODS:
                break
            sim.submit_to_group(group, [
                cluster.Pod(name=f"{pod.name}-h{cycle}-{i}",
                            **{f: getattr(pod, f) for f in _POD_SPEC})
                for i in range(4)])
            sent += 4
    else:
        for _name, uid in running[HOST_DONE_EVERY // 2::len(running) // HOST_EVICTED]:
            evicted += cache.evict(uid, "host-cycle churn")
    alloc = dict(node.allocatable)
    alloc["cpu"] += 1000
    cache.update_node(dataclasses.replace(node, allocatable=alloc))
    return {"completed": (len(done) + 1) // 2, "deleted": len(done) // 2,
            "arrived": sent, "evicted": evicted, "node": node.name}


def _name_of(idx, names):
    """Row indices → names (negative codes kept as '#code')."""
    import numpy as np

    table = np.array(list(names) + [None], dtype=object)
    out = table[np.where(idx >= 0, idx, len(names))]
    neg = idx < 0
    out[neg] = [f"#{v}" for v in idx[neg]]
    return out


_INDEX_FIELDS = {"task_job": "job_names", "task_node": "node_names",
                 "task_vol_node": "node_names"}


def check_pack(packer, cache) -> dict:
    """After an incremental pack: every device field equals the packer's
    host array, and every task's decoded row (by uid: row order differs
    after swap-compaction), every job's row (by name) and every node's row
    equal those of a fresh full pack of the same cache."""
    import numpy as np
    import torch

    from kube_batch_tpu_torch.api.snapshot import FIELDS
    from kube_batch_tpu_torch.cache.packer import pack_snapshot_full

    a, snap, meta, ints = (packer._ints.arrays, packer._snap, packer._meta,
                           packer._ints)
    for f in FIELDS:
        if not torch.equal(getattr(snap, f).cpu(), torch.from_numpy(a[f])):
            fail(f"host cycle: device field {f} differs from the packer's host array")
    with cache.lock():
        _, fmeta, fints = pack_snapshot_full(cache.snapshot(shared=True), device=None)
    b = fints.arrays
    for key in ("label_vocab", "taint_vocab", "port_vocab", "podlabel_vocab",
                "node_names", "queue_names"):
        if getattr(meta, key) != getattr(fmeta, key):
            fail(f"host cycle: {key} differs from a fresh full pack")
    if sorted(meta.task_uids) != sorted(fmeta.task_uids):
        fail("host cycle: packed task uids differ from a fresh full pack")
    frow = {u: i for i, u in enumerate(fmeta.task_uids)}
    idx = np.fromiter((frow[u] for u in meta.task_uids), np.int64,
                      count=len(meta.task_uids))
    n = len(idx)
    moved = int((idx != np.arange(n)).sum())   # swap-compaction, appends
    for f in FIELDS:
        if not f.startswith("task_"):
            continue
        got, want = a[f][:n], b[f][idx]
        if f in _INDEX_FIELDS:
            names = _INDEX_FIELDS[f]
            got, want = (_name_of(got, getattr(meta, names)),
                         _name_of(want, getattr(fmeta, names)))
        elif f == "task_ns":
            got, want = _name_of(got, ints.ns_names), _name_of(want, fints.ns_names)
        if got.shape != want.shape or not np.array_equal(got, want):
            fail(f"host cycle: decoded {f} rows differ from a fresh full pack")
    jrow = {j: i for i, j in enumerate(fmeta.job_names)}
    if sorted(meta.job_names) != sorted(fmeta.job_names):
        fail("host cycle: packed jobs differ from a fresh full pack")
    jidx = np.fromiter((jrow[j] for j in meta.job_names), np.int64,
                       count=len(meta.job_names))
    for f in ("job_queue", "job_min", "job_prio", "job_order", "job_mask"):
        if not np.array_equal(a[f][:len(jidx)], b[f][jidx]):
            fail(f"host cycle: decoded {f} rows differ from a fresh full pack")
    for f in FIELDS:
        if f.startswith("node_") or f == "cluster_total":
            if not np.array_equal(a[f], b[f]):
                fail(f"host cycle: {f} differs from a fresh full pack")
    return {"rows_out_of_full_order": moved}


def phase_host_cycle(device, **world_kw):
    """Config 5 full under the default conf, HOST_CYCLES cycles through
    `Scheduler.run_once` in the default incremental pack mode, with churn
    between the cycles (arrivals after cycles 1 and 3, evictions instead
    after cycle 2), each pack checked against its host arrays and a fresh full pack;
    a second scheduler on an identical world rebuilds every pack
    (pack_mode="full") and must bind alike.  Returns (launch counts of
    the incremental scheduler's cycles, the Recorder of its K9 calls)."""
    import itertools

    import kube_batch_tpu_torch.cache.cluster as cluster
    from kube_batch_tpu_torch import kernels
    from kube_batch_tpu_torch.models.workloads import config5_full
    from kube_batch_tpu_torch.scheduler import Scheduler

    worlds = []
    for mode in ("incremental", "full"):
        cluster._uid_counter = itertools.count()
        cache, sim = config5_full(seed=0, **world_kw)
        worlds.append((cache, sim, Scheduler(cache, device=device, pack_mode=mode)))
    (cache, sim, sched), (fcache, fsim, fsched) = worlds
    packer, orig_pack = sched.packer, sched.packer.pack
    checks = {"s": 0.0}

    def checked_pack():
        out = orig_pack()
        t0 = time.perf_counter()
        checks.update(check_pack(packer, cache))
        checks["s"] += time.perf_counter() - t0
        return out

    packer.pack = checked_pack
    rec = Recorder({name: 10**9 for name in _MUTATED if name != "row_patch"})
    totals = {}
    for cycle in range(HOST_CYCLES):
        checks["s"] = 0.0
        kernels.reset_counts()
        with rec:
            t0 = time.perf_counter()
            ssn = sched.run_once()
            wall_ms = (time.perf_counter() - t0 - checks["s"]) * 1e3
        counts = kernels.counts()
        for name, n in counts.items():
            totals[name] = totals.get(name, 0) + n
        if ssn is None:
            fail(f"host cycle: cycle {cycle + 1} found nothing to solve")
        _check_binds_allowed(ssn)
        t0 = time.perf_counter()
        fssn = fsched.run_once()
        full_wall_ms = (time.perf_counter() - t0) * 1e3
        if fssn is None or sorted(fssn.bound) != sorted(ssn.bound) \
                or sorted(fssn.evicted) != sorted(ssn.evicted):
            fail(f"host cycle: cycle {cycle + 1} binds differ between the "
                 "incremental and the full pack mode")
        t = sched.last_timings
        log(json.dumps({
            "phase": "host-cycle", "cycle": cycle + 1,
            "pack_mode": packer.last_mode, "tasks": ssn.meta.num_real_tasks,
            "pack_host_ms": round(t["pack_host_ms"], 3),
            "pack_h2d_ms": round(t["pack_h2d_ms"], 3),
            "pack_h2d_bytes": packer.last_h2d_bytes,
            "solve_ms": round(t["solve_ms"], 3),
            "dispatch_ms": round(t["dispatch_ms"], 3),
            "wall_ms": round(wall_ms, 3), "binds": len(ssn.bound),
            "row_patch_launches": counts["row_patch"],
            "check_s": round(checks["s"], 3),
            "rows_out_of_full_order": checks["rows_out_of_full_order"],
            "full_mode": {
                "pack_host_ms": round(fsched.last_timings["pack_host_ms"], 3),
                "pack_h2d_ms": round(fsched.last_timings["pack_h2d_ms"], 3),
                "pack_h2d_bytes": fsched.packer.last_h2d_bytes,
                "wall_ms": round(full_wall_ms, 3)},
            "same_binds_as_full": True,
        }))
        if cycle + 1 < HOST_CYCLES:
            arrive = cycle != 1
            churn = host_churn(cache, sim, cycle, arrive)
            if host_churn(fcache, fsim, cycle, arrive) != churn:
                fail("host cycle: the two worlds churned differently")
            log(json.dumps({"phase": "host-cycle-churn", "after_cycle": cycle + 1,
                            **churn}))
    packer.pack = orig_pack
    log(json.dumps({"phase": "host-cycle-launches", **totals}))
    for name in HOST_CYCLE_ONLY + RANK_KERNELS:
        if totals[name] <= 0:
            fail(f"kernel {name} was not launched on the host cycle")
    if packer.row_patched_packs < HOST_CYCLES - 1:
        fail(f"host cycle: {packer.row_patched_packs} row-patched packs after "
             "cycle 1")
    _check_invariants(cache, gangs=False)
    return totals, rec


# ---------------------------------------------------------------------------
# phase 4: the preempt path
# ---------------------------------------------------------------------------

def preempt_cycles(device: str, record: bool, check_binds: bool = False):
    """The preempt path: config 4 under examples/scheduler.conf for 3
    cycles, the wave arriving after cycle 1.  Returns (per-cycle records,
    the Recorder of cycles 2 and 3 or None, the cache, the sessions).
    With `check_binds`, each cycle's binds are held against its own
    snapshot's predicate mask before the next pack."""
    from kube_batch_tpu_torch.scheduler import Scheduler

    cache, sim = preempt_world()
    sched = Scheduler(cache, conf=scheduler_conf(), device=device)
    rec = Recorder(PREEMPT_EVERY) if record else None
    cycles, sessions = [], []
    for cycle in range(3):
        t0 = time.perf_counter()
        if rec is not None and cycle >= 1:
            with rec:
                ssn = sched.run_once()
        else:
            ssn = sched.run_once()
        wall_ms = (time.perf_counter() - t0) * 1e3
        if ssn is None:
            fail(f"preempt path: cycle {cycle} found nothing to solve")
        if check_binds:
            _check_binds_allowed(ssn)
        c = _cycle_record(ssn, sched)
        c["wall_ms"] = wall_ms
        c["timings"] = dict(sched.last_timings)
        cycles.append(c)
        sessions.append(ssn)
        sim.tick()
        if cycle == 0:
            c["wave_pods"] = preempt_wave(sim)
    return cycles, rec, cache, sessions


def preempt_cycles_cpu(root: str):
    """The preempt path on the CPU, in a worker process (spawned, so it
    starts from a fresh import and never touches the card)."""
    import torch

    sys.path.insert(0, root)
    torch.set_num_threads(3)
    t0 = time.perf_counter()
    try:
        cycles = preempt_cycles("cpu", record=False)[0]
    except SystemExit:  # fail() exits; a pool worker must return instead
        raise RuntimeError("the preempt path's CPU run failed") from None
    return cycles, time.perf_counter() - t0


def _loop_line(stats: dict) -> list:
    out = []
    for key in ("preempt_steps", "reclaim_steps"):
        for i, loop in enumerate(stats.get(key, [])):
            out.append({
                "loop": f"{key[:-6]}{'' if key == 'reclaim_steps' else i + 1}",
                "steps": loop["steps"], "ms": round(loop["ms"], 3),
                "ms_per_step": round(loop["ms"] / max(loop["steps"], 1), 4),
                **{k: loop[k] for k in ("opened", "evicted", "finalized",
                                        "rolled_back", "no_node")},
            })
    return out


def phase_preempt_path(cpu_result):
    from kube_batch_tpu_torch import kernels

    kernels.reset_counts()
    cycles, rec, cache, sessions = preempt_cycles("cuda", record=True,
                                                  check_binds=True)
    counts = kernels.counts()
    log(json.dumps({"phase": "preempt-path-launches", **counts}))
    for name, n in counts.items():
        if n <= 0 and name not in (HOST_CYCLE_ONLY + AFFINITY_KERNELS + AFFINITY_ROW
                                   + JOINT_ONLY):
            fail(f"kernel {name} was not launched on the preempt path")
    for c, cyc in enumerate(cycles):
        evicted = cyc["rounds"].get("evicted", {})
        log(json.dumps({
            "phase": "preempt-path", "cycle": c + 1,
            "tasks": sessions[c].meta.num_real_tasks, "bound": len(cyc["binds"]),
            "evicted": evicted, "wall_ms": round(cyc["wall_ms"], 3),
            **{k: round(v, 3) for k, v in cyc["timings"].items()},
            "allocate_rounds": cyc["rounds"].get("allocate_rounds"),
            "loops": _loop_line(cyc["rounds"]),
            **({"wave_pods": cyc["wave_pods"]} if "wave_pods" in cyc else {}),
        }))
    first = cycles[0]["rounds"].get("evicted", {})
    log(json.dumps({"phase": "preempt-path-cycle1", "evicted": first,
                    "nothing_evicted": not cycles[0]["evicted"]}))
    if cycles[0]["evicted"]:
        fail("preempt path: cycle 1 evicted pods from the empty cluster")
    second = cycles[1]["rounds"].get("evicted", {})
    if second.get("preempt", 0) <= 0 or second.get("reclaim", 0) <= 0:
        fail(f"preempt path: cycle 2 evictions {second}: preempt and reclaim "
             "must both evict")
    wave_binds = [b for b in cycles[2]["binds"]
                  if b[0].startswith(WAVE_PREFIXES)]
    if not wave_binds:
        fail("preempt path: cycle 3 bound no pod of the wave")
    _check_invariants(cache)
    cpu_cycles, cpu_s = cpu_result.get(timeout=900)
    for c, (g, h) in enumerate(zip(cycles, cpu_cycles)):
        if not _same(g, h):
            fail(f"preempt path: cycle {c + 1} decisions, evictions or failure "
                 "tallies differ between cuda and cpu")
    log(json.dumps({"phase": "preempt-path-invariants", "capacity": True,
                    "gang": True, "predicate": True, "wave_binds_cycle3": len(wave_binds),
                    "identical_to_cpu": True, "cpu_worker_s": round(cpu_s, 3)}))
    return counts, rec, cycles


def phase_preempt_kernels(rec: Recorder, cycles) -> dict:
    """K5, K6 and K7 against their plain versions on every recorded input
    of cycles 2 and 3 (cycle 2 of this world rolls no plan back, cycle 3
    does: a continuing step that finds no victim left); each timed on one
    of cycle 2's inputs."""
    import torch

    from kube_batch_tpu_torch.kernels import preempt_scan as k6
    from kube_batch_tpu_torch.kernels import segment_sum as k7
    from kube_batch_tpu_torch.kernels import victim_prefix as k5

    checks = check_all(rec, PREEMPT_KERNELS)
    rolled_back = sum(loop["rolled_back"] for c in cycles[1:]
                      for key in ("preempt_steps", "reclaim_steps")
                      for loop in c["rounds"][key])
    checks["preempt_continue"]["steps_rolled_back"] = rolled_back
    log(json.dumps({"phase": "preempt-kernels", "equal_to_plain": True, **checks}))
    for name, key in (("victim_prefix", "nodes_some_victims"),
                      ("victim_prefix", "nodes_no_prefix"),
                      ("preempt_open", "direct_fit_true"),
                      ("preempt_open", "direct_fit_false"),
                      ("preempt_continue", "victim_found"),
                      ("preempt_continue", "no_victim_left"),
                      ("preempt_continue", "steps_rolled_back"),
                      ("segment_sum", "nonempty_segments"),
                      ("segment_count", "nonempty_segments")):
        if checks[name].get(key, 0) <= 0:
            fail(f"preempt path: {name} never met a case with {key} > 0")

    out = {}

    def record(name, ms, plain_ms, b, library_ms=None):
        out[name] = dict(max_abs_err=checks[name]["max_abs_err"], ms=ms,
                         plain_ms=plain_ms, bound=b, library_ms=library_ms)
        log(json.dumps({"phase": "kernel", "name": name, "ms": round(ms, 4),
                        "plain_ms": round(plain_ms, 4),
                        "library_ms": None if library_ms is None else round(library_ms, 4),
                        "bound_ms": round(b[0], 5), "bound_by": b[1]}))

    first = min(c for c, _r, _a in rec.calls["predicate_mask"])   # cycle 2

    def cycle2(name):
        return [a for c, _r, a in rec.calls[name] if c == first]

    # K5: the opening step with the most candidate victims
    args = max(cycle2("victim_prefix"),
               key=lambda a: int((a[1] < a[3].shape[0]).sum()))
    perm, s_node, req, future, preq, eps, ok = args
    N, R = future.shape
    k, _out = k5.victim_prefix(*args)
    seg_len = torch.bincount(s_node[s_node < N], minlength=N)[:N]
    walked = int(torch.where(k == 0, 0, torch.minimum(k.long(), seg_len)).sum())
    record("victim_prefix", time_ms(lambda: k5.victim_prefix(*args)),
           time_ms(lambda: k5.victim_prefix_plain(*args)),
           bound(walked * (16 + 4 * R) + 2 * N * R * 4 + N + N * 4 + 20,
                 walked * R * 2, F64_OPS_PER_S))
    log(json.dumps({"phase": "kernel-note", "name": "victim_prefix",
                    "victims": int((s_node < N).sum()), "rows_walked": walked}))

    # K6: the opening step with the most eligible tasks and no direct fit
    args = timing_inputs(rec)["preempt_open"]
    record("preempt_open", time_ms(lambda: k6.preempt_open(*args)),
           time_ms(lambda: k6.preempt_open_plain(*args)), preempt_open_bound(args))
    log(json.dumps({"phase": "kernel-note", "name": "preempt_open",
                    "eligible": int(args[1].sum()), "ready_nodes": int(args[8].sum()),
                    "direct_fit": int(k6.preempt_open(*args)[3])}))
    # ... and cycle 2's continuing step whose node holds the most victims
    args = max(cycle2("preempt_continue"),
               key=lambda a: int((a[1] & (a[2] == a[3])).sum()))
    rank, victims, task_node, n = args
    record("preempt_continue", time_ms(lambda: k6.preempt_continue(*args)),
           time_ms(lambda: k6.preempt_continue_plain(*args)),
           bound(rank.shape[0] * 9 + 8, rank.shape[0] * 2))
    log(json.dumps({"phase": "kernel-note", "name": "preempt_continue",
                    "candidate_victims": int(victims.sum()),
                    "on_node": int((victims & (task_node == n)).sum())}))

    # K7: the widest recorded float sum and count
    args = timing_inputs(rec)["segment_sum"]
    ms, plain_ms, library_ms, b = segment_sum_timing(args)
    record("segment_sum", ms, plain_ms, b, library_ms)
    log(json.dumps({"phase": "kernel-note", "name": "segment_sum",
                    "rows": args[1].numel(), "columns": args[0][0].numel(),
                    "segments": args[2], "rows_kept": int((args[1] < args[2]).sum())}))
    args = widest_count(cycle2("segment_count"))
    ms, plain_ms, library_ms, b = segment_count_timing(args)
    record("segment_count", ms, plain_ms, b, library_ms)
    log(json.dumps({"phase": "kernel-note", "name": "segment_count",
                    "rows": args[1].numel(), "columns": args[0][0].numel(),
                    "segments": args[2]}))

    # K7's water-fill
    args = cycle2("waterfill")[-1]
    Q, R = args[1].shape
    record("waterfill", time_ms(lambda: k7.waterfill(*args)),
           time_ms(lambda: k7.waterfill_plain(*args)),
           bound(Q * 4 + 2 * Q * R * 4 + R * 4 + Q, (Q + 1) * Q * R * 8))
    return out


def timing_inputs(rec: Recorder) -> dict:
    """The preempt path's timed inputs, chosen from the recorded calls of
    its cycle 2 (the first recorded cycle): K6's opening step with the
    most eligible tasks and no direct fit, and K7's widest float sum."""
    from kube_batch_tpu_torch.kernels import preempt_scan as k6

    first = min(c for c, _r, _a in rec.calls["predicate_mask"])
    opens = [a for c, _r, a in rec.calls["preempt_open"] if c == first]
    no_fit = [a for a in opens if int(k6.preempt_open(*a)[3]) == 0] or opens
    return {
        "preempt_open": max(no_fit, key=lambda a: int(a[1].sum())),
        "segment_sum": widest_float_sum(
            [a for c, _r, a in rec.calls["segment_sum"] if c == first]),
    }


def preempt_open_bound(args):
    """K6 preempt_open's least time on these inputs: its [T] and [N]
    inputs and the eligible rows' requests read once; with no direct fit,
    2·R compares for every eligible row × ready node."""
    from kube_batch_tpu_torch.kernels import preempt_scan as k6

    rank, elig, _ss, _ls, _tm, _prov, req, future, node_ok, _eps = args
    T, (N, R) = rank.shape[0], future.shape
    E, M = int(elig.sum()), int(node_ok.sum())
    direct = int(k6.preempt_open_plain(*args)[3])
    return bound(T * 15 + E * R * 4 + N * R * 4 + N + R * 4 + 16,
                 0 if direct else E * M * 2 * R)


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

def _pick_round(rec: Recorder):
    """The last cycle's auction round whose resolve rejected the most
    proposals, among rounds that applied placements: its (propose_best,
    propose_pick, resolve, apply) inputs and that count."""
    from kube_batch_tpu_torch.kernels import resolve as k3

    last = max(c for c, _, _ in rec.calls["predicate_mask"])
    by_round = {}
    for name in ("propose_best", "propose_pick", "resolve", "apply"):
        for cycle, rnd, args in rec.calls[name]:
            if cycle == last:
                by_round.setdefault(rnd, {})[name] = args
    best, best_rej = None, -1
    for _rnd, calls in sorted(by_round.items()):
        if len(calls) < 4:
            continue
        perm, s_node, avail = (calls["resolve"][i] for i in (0, 1, 3))
        real = s_node < avail.shape[0]
        rej = int(real.sum()) - int(k3.resolve(*calls["resolve"])[perm][real].sum())
        if rej > best_rej:
            best, best_rej = calls, rej
    if best is None:
        fail("main path: no auction round of cycle 2 applied placements")
    if best_rej <= 0:
        fail("main path: no auction round of cycle 2 rejected a proposal")
    return best, best_rej


def _live_width(a, b) -> int:
    """Vocabulary columns some task or node actually uses."""
    return int((a.any(dim=0) | b.any(dim=0)).sum()) if a.shape[1] else 0


def _work_counts(args, prop, active):
    """Cells each propose pass must touch, from this round's data: fit
    checks (eligible rows on real, predicate-passing nodes), feasible
    cells (scored), and for the pick pass the cells up to each active
    row's chosen node."""
    import torch

    from kube_batch_tpu_torch.kernels.propose import (
        PLAIN_ROWS,
        masked_scores_plain,
        quantum_scale,
    )

    (pred, dyn, req, avail, eps, node_mask, eligible, future, cap, spec,
     extras, quantum) = args
    T, N = pred.shape
    cols = torch.arange(N, device=pred.device)
    fit_cells = feas_cells = scan_cells = scan_feas = 0
    for lo in range(0, T, PLAIN_ROWS):
        rows = slice(lo, min(T, lo + PLAIN_ROWS))
        e = eligible[rows]
        static = pred[rows] if dyn is None else pred[rows] & dyn[rows]
        feas, _ = masked_scores_plain(
            pred[rows], None if dyn is None else dyn[rows], req[rows], avail,
            eps, node_mask, e, future, cap, spec, [x[rows] for x in extras],
            quantum_scale(quantum),
        )
        fit_cells += int((static & node_mask[None, :] & e[:, None]).sum())
        feas_cells += int(feas.sum())
        scanned = active[rows, None] & (cols[None, :] <= prop[rows, None])
        scan_cells += int(scanned.sum())
        scan_feas += int((scanned & feas).sum())
    return fit_cells, feas_cells, scan_cells, scan_feas


def _score_ops(spec, R: int) -> int:
    ops = 2  # mask select, quantum floor
    if spec.w_lr is not None:
        ops += 7 * R + 4
    if spec.w_bal is not None:
        ops += 16
    return ops


def phase_kernels(rec: Recorder):
    import torch

    from kube_batch_tpu_torch.kernels import failure_counts as k4
    from kube_batch_tpu_torch.kernels import predicate_mask as k1
    from kube_batch_tpu_torch.kernels import propose as k2
    from kube_batch_tpu_torch.kernels import resolve as k3

    out = {}

    def record(name, args, ms, plain_ms, b, library_ms=None):
        err, counts = check_call(name, args)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b,
                         library_ms=library_ms)
        log(json.dumps({"phase": "kernel", "name": name, "inputs": counts,
                        "max_abs_err": err, "ms": round(ms, 4),
                        "plain_ms": round(plain_ms, 4),
                        "library_ms": None if library_ms is None else round(library_ms, 4),
                        "bound_ms": round(b[0], 4), "bound_by": b[1]}))

    # K1, cycle 2's call
    args = rec.calls["predicate_mask"][-1][2]
    snap = args[0]
    T, N, R = snap.num_tasks, snap.num_nodes, snap.num_resources
    W = (_live_width(snap.task_sel, snap.node_labels)
         + _live_width(snap.task_tol, snap.node_taints)
         + _live_width(snap.task_ports, snap.node_ports)
         + int(snap.task_vol_groups.any(dim=0).sum()))
    in_bytes = sum(x.numel() * x.element_size() for x in (
        snap.task_sel, snap.node_labels, snap.task_tol, snap.node_taints,
        snap.task_ports, snap.node_ports, snap.node_ready, snap.node_pressure,
        snap.task_vol_node, snap.task_vol_groups))
    record("predicate_mask", args,
           time_ms(lambda: k1.predicate_mask(*args)),
           time_ms(lambda: k1.predicate_mask_plain(*args)),
           bound(in_bytes + T * N, T * N * (2 * W + 6)),
           # The one-call PyTorch form of this function is the selector /
           # taint / port products by torch.matmul with their compares.
           time_ms(lambda: k1.predicate_mask_plain(*args)))
    log(json.dumps({"phase": "kernel-note", "name": "predicate_mask",
                    "live_vocabulary_columns": W}))

    # K2 and K3 on one auction round of cycle 2
    rnd, rejected = _pick_round(rec)
    bargs, pargs, rargs, aargs = (rnd[k] for k in (
        "propose_best", "propose_pick", "resolve", "apply"))
    spec = bargs[9]
    best, ties, active = k2.propose_best(*bargs)
    prop = k2.propose_pick(*pargs)
    fit_cells, feas_cells, scan_cells, scan_feas = _work_counts(bargs, prop, active)
    log(json.dumps({"phase": "round-inputs", "eligible": int(bargs[6].sum()),
                    "active": int(active.sum()), "rejected": rejected,
                    "fit_cells": fit_cells,
                    "feasible_cells": feas_cells, "pick_cells": scan_cells}))
    sops = _score_ops(spec, R)
    n_extra = len(bargs[10]) + (bargs[1] is not None)
    small = T * R * 4 + 3 * N * R * 4 + N + T
    record("propose_best", bargs,
           time_ms(lambda: k2.propose_best(*bargs)),
           time_ms(lambda: k2.propose_best_plain(*bargs), warmup=1, runs=3),
           bound(T * N + small + 9 * T + n_extra * 4 * T * N,
                 fit_cells * 2 * R + feas_cells * sops))
    record("propose_pick", pargs,
           time_ms(lambda: k2.propose_pick(*pargs)),
           time_ms(lambda: k2.propose_pick_plain(*pargs), warmup=1, runs=3),
           bound(scan_cells + small + 13 * T + n_extra * 4 * scan_cells,
                 scan_cells * 2 * R + scan_feas * sops))
    n_active = int((rargs[1] < N).sum())
    record("resolve", rargs,
           time_ms(lambda: k3.resolve(*rargs)),
           time_ms(lambda: k3.resolve_plain(*rargs)),
           bound(16 * T + n_active * R * 4 + N * R * 4 + 2 * T,
                 n_active * R * 3, F64_OPS_PER_S))
    accept, perm, s_node = aargs[2], aargs[0], aargs[1]
    n_acc = int(accept.sum())
    touched = int(torch.unique(s_node[accept[perm]]).numel())
    ka, pa = _fresh_apply_args(aargs), _fresh_apply_args(aargs)
    record("apply", aargs,
           time_ms(lambda: k3.apply(*ka)),
           time_ms(lambda: k3.apply_plain(*pa)),
           bound(17 * T + n_acc * (R * 4 + 8) + touched * R * 4 * 4,
                 n_acc * R, F64_OPS_PER_S))

    # K4, cycle 2's call (the cycle's final node_idle)
    fargs = rec.calls["failure_counts"][-1][2]
    record("failure_counts", fargs,
           time_ms(lambda: k4.failure_counts(*fargs)),
           time_ms(lambda: k4.failure_counts_plain(*fargs)),
           bound(T * N + T * R * 4 + N * R * 4 + N + (2 + R) * 4 * T,
                 T * N * (5 * R + 4)))
    pf, ins, fe = k4.failure_counts(*fargs)
    if not bool((ins > 0).any()):
        fail("main path: cycle 2's failure tallies found no insufficient node")

    # K7 on every call of both main-path cycles (the allocate path's job,
    # queue and namespace sums of drf, proportion, gang and predicates, and
    # the water-fill), and timed on cycle 2's widest float sum
    k7_checks = check_all(rec, ("segment_sum", "segment_count", "waterfill"))
    log(json.dumps({"phase": "main-path-k7", "equal_to_plain": True, **k7_checks}))
    for name in ("segment_sum", "segment_count"):
        if k7_checks[name].get("nonempty_segments", 0) <= 0:
            fail(f"main path: {name} never met a non-empty segment")
    if k7_checks["waterfill"]["calls"] <= 0:
        fail("main path: the water-fill was never called")
    args = main_timing_input(rec)
    ms, plain_ms, library_ms, b = segment_sum_timing(args)
    log(json.dumps({"phase": "kernel-main-path", "name": "segment_sum",
                    "rows": args[1].numel(), "columns": args[0][0].numel(),
                    "segments": args[2], "rows_kept": int((args[1] < args[2]).sum()),
                    "ms": round(ms, 4),
                    "plain_ms": round(plain_ms, 4), "library_ms": round(library_ms, 4),
                    "bound_ms": round(b[0], 6), "bound_by": b[1]}))
    return out


def main_timing_input(rec: Recorder):
    """The main path's widest float sum of its last cycle (65,536 rows)."""
    last = max(c for c, _r, _a in rec.calls["predicate_mask"])
    return widest_float_sum([a for c, _r, a in rec.calls["segment_sum"] if c == last])


# ---------------------------------------------------------------------------
# K8 and K9: every recorded call against the plain version, then timed
# ---------------------------------------------------------------------------

def _rank_timings(rec: Recorder, label: str) -> dict:
    """Time K8's three entry points on the widest recorded call of each
    (rows T; lex_push_many: the most keys among those), beside the plain
    version, the library form (for lex_push_many the same function in
    library calls: per key the gather, a stable torch.argsort and the
    permutation, then the dense-rank scatter; a stable torch.sort of the
    int64 segment key; none for vtime) and the bound."""
    import torch

    from kube_batch_tpu_torch.kernels import lex_rank as k8

    out = {}

    def widest(name):
        if name == "lex_push_many":
            return max((a for _c, _r, a in rec.calls[name]),
                       key=lambda a: (a[1][0].numel(), len(a[1])))
        return max((a for _c, _r, a in rec.calls[name]), key=lambda a: a[0].numel())

    perm, keys = widest("lex_push_many")
    T, m = keys[0].numel(), len(keys)
    positions = torch.arange(T, dtype=torch.int32, device=keys[0].device)
    dense = torch.empty(T, dtype=torch.int32, device=keys[0].device)

    def library():
        order = torch.arange(T, device=keys[0].device) if perm is None else perm
        for key in keys:
            order = order[torch.argsort(key[order], stable=True)]
        dense[order] = positions
        return order, dense

    out["lex_push_many"] = (
        time_ms(lambda: k8.lex_push_many(perm, keys)),
        time_ms(lambda: k8.lex_push_many_plain(perm, keys)),
        time_ms(library),
        # the keys and the order in, the order and rank out; 4 byte
        # digits of a few operations each per key
        bound(T * (4 * m + (0 if perm is None else 8) + 8 + 4), T * 4 * 4 * m),
    )
    seg, rank, S = widest("sort_by_segment")
    T = seg.numel()
    key64 = seg.long() * T + rank.long()
    passes = k8.sort_plan(T, S)[2]
    out["sort_by_segment"] = (
        time_ms(lambda: k8.sort_by_segment(seg, rank, S)),
        time_ms(lambda: k8.sort_by_segment_plain(seg, rank, S)),
        time_ms(lambda: torch.sort(key64, stable=True)),
        bound(T * (seg.element_size() + rank.element_size() + 16), T * 4 * passes),
    )
    args = widest("vtime")
    perm_v, s_seg, req, valid, alloc, denom, S = args
    T, R = req.shape
    out["vtime"] = (
        time_ms(lambda: k8.vtime(*args)),
        time_ms(lambda: k8.vtime_plain(*args)),
        None,
        bound(T * (8 + 8 + 1 + 4) + int(valid.sum()) * R * 4 + 2 * alloc.numel() * 4,
              T * R * 4, F64_OPS_PER_S),
    )
    notes = {"lex_push_many": {"rows": keys[0].numel(), "keys": m},
             "sort_by_segment": {"rows": seg.numel(), "segments": S,
                                 "plan": list(k8.sort_plan(seg.numel(), S))},
             "vtime": {"rows": req.shape[0]}}
    for name, (ms, plain_ms, library_ms, b) in out.items():
        log(json.dumps({"phase": f"kernel-{label}", "name": name, **notes[name],
                        "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
                        "library_ms": None if library_ms is None else round(library_ms, 4),
                        "bound_ms": round(b[0], 6), "bound_by": b[1]}))
    return out


def _path_steps(cycles) -> int:
    """Preemption-loop steps of a run of the preempt path, all cycles."""
    return sum(loop["steps"] for c in cycles for key in ("preempt_steps", "reclaim_steps")
               for loop in c["rounds"].get(key, []))


def phase_rank_kernels(main_rec: Recorder, preempt_rec: Recorder, main_counts,
                       preempt_counts, preempt_cycles) -> dict:
    """K8 on every recorded call of the main path (every 10th) and the
    preempt path (every 25th) against its plain version; timed at both
    paths' shapes (T = 65,536 and 8,192); the kernels line takes the main
    path's.  Logs K8's launches on both paths and per preemption step."""
    steps = _path_steps(preempt_cycles)
    log(json.dumps({"phase": "k8-launches",
                    "main_path": {k: main_counts[k] for k in RANK_KERNELS},
                    "preempt_path": {k: preempt_counts[k] for k in RANK_KERNELS},
                    "preempt_steps": steps,
                    "preempt_per_step": {k: round(preempt_counts[k] / max(steps, 1), 3)
                                         for k in RANK_KERNELS}}))
    seen = {}
    errs = {}
    for label, rec in (("main-path", main_rec), ("preempt-path", preempt_rec)):
        checks = check_all(rec, RANK_KERNELS)
        log(json.dumps({"phase": f"{label}-k8", "equal_to_plain": True, **checks}))
        for name, acc in checks.items():
            errs[name] = max(errs.get(name, 0.0), acc["max_abs_err"])
            for k, v in acc.items():
                seen[(name, k)] = seen.get((name, k), 0) + v
    for key in (("lex_push_many", "calls"), ("lex_push_many", "tied_rows"),
                ("sort_by_segment", "calls"), ("vtime", "valid_rows")):
        if seen.get(key, 0) <= 0:
            fail(f"K8: {key[0]} never met a case with {key[1]} > 0")
    timed = _rank_timings(main_rec, "main-path")
    _rank_timings(preempt_rec, "preempt-path")
    return {name: dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                       bound=b, library_ms=library_ms)
            for name, (ms, plain_ms, library_ms, b) in timed.items()}


def phase_row_patch(rec: Recorder) -> dict:
    """K9 on every call of the host cycle against its plain version;
    timed on the call with the most rows, beside its plain version on the
    card, the library form (per field, its indices and values copied from
    the same host numpy arrays to the card, then one index_copy_) and the
    bound."""
    import numpy as np
    import torch

    from kube_batch_tpu_torch.kernels import row_patch as k9

    checks = check_all(rec, ("row_patch",))["row_patch"]
    log(json.dumps({"phase": "host-cycle-k9", "equal_to_plain": True, **checks}))
    if checks["calls"] <= 0 or checks["calls"] != checks["calls_made"]:
        fail("K9: not every row_patch call of the host cycle was checked")
    bufs, rows, vals = max((a for _c, _r, a in rec.calls["row_patch"]),
                           key=lambda a: sum(len(r) for r in a[1]))
    bufs = [b.clone() for b in bufs]
    dev = bufs[0].device

    def library():
        for b, r, v in zip(bufs, rows, vals):
            b.index_copy_(0, torch.from_numpy(r.astype(np.int64)).to(dev),
                          torch.from_numpy(np.ascontiguousarray(v)).to(dev))

    payload = sum(r.nbytes + v.nbytes for r, v in zip(rows, vals))
    b = bound(payload + sum(v.nbytes for v in vals), 0)
    ms = time_ms(lambda: k9.row_patch(bufs, rows, vals))
    plain_ms = time_ms(lambda: k9.row_patch_plain(bufs, rows, vals))
    library_ms = time_ms(library)
    log(json.dumps({"phase": "kernel", "name": "row_patch", "fields": len(bufs),
                    "rows": sum(len(r) for r in rows), "payload_bytes": payload,
                    "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
                    "library_ms": round(library_ms, 4), "bound_ms": round(b[0], 6),
                    "bound_by": b[1]}))
    return {"row_patch": dict(max_abs_err=checks["max_abs_err"], ms=ms,
                              plain_ms=plain_ms, bound=b, library_ms=library_ms)}


# ---------------------------------------------------------------------------
# the affinity path: config 5 with inter-pod affinity terms at full size
# ---------------------------------------------------------------------------

def _check_affinity(ssn, cache) -> dict:
    """The affinity invariants of one cycle (residents: allocated,
    binding, bound, running or pipelined pods).  No node holds two
    `role=ps` residents at the cycle's end.  Every MPI worker resident
    at the end has its rack affinity backed by one of:

    * a team-mate (any pod of its team) resident in its rack when the
      cycle began;
    * a team-mate placed in its rack in this cycle that carries no
      required term (a parameter server, TF worker or launcher);
    * its team's bootstrap waiver: the team had no resident anywhere when
      the cycle began, and then at most one rack of the team holds only
      MPI workers placed in this cycle (the waiver admits one claimant;
      its gang-mates may join it in later rounds).

    The final state does not say in which round a pod was placed, so the
    second case cannot tell a team-mate of an earlier round from one of
    the same round: this is a sanity check, and the decisions themselves
    are held by the card-vs-CPU parity worlds and the CPU tests against
    the JAX package."""
    from collections import Counter, defaultdict

    from kube_batch_tpu_torch.api.types import ALLOCATED_STATUSES, TaskStatus

    resident = {int(s) for s in ALLOCATED_STATUSES} | {int(TaskStatus.PIPELINED)}
    with cache.lock():
        rack = {name: info.node.labels.get("rack") for name, info in cache._nodes.items()}
    names, pods = ssn.meta.node_names, ssn.meta.task_pods

    def residents(state, node):
        for t, pod in enumerate(pods):
            if int(state[t]) in resident and node[t] >= 0:
                yield pod, names[node[t]]

    start_racks, start_teams = set(), set()
    for pod, where in residents(ssn.initial_task_state, ssn.host_field("task_node")):
        team = pod.labels.get("team")
        if team is not None:
            start_racks.add((team, rack[where]))
            start_teams.add(team)
    ps, new_roles, mpi = Counter(), defaultdict(set), []
    for pod, where in residents(ssn.host_task_state, ssn.host_task_node):
        role, team = pod.labels.get("role"), pod.labels.get("team")
        if role == "ps":
            ps[where] += 1
        if team is not None and (team, rack[where]) not in start_racks:
            new_roles[(team, rack[where])].add(role)
        if role == "mpi":
            mpi.append((pod.name, team, rack[where]))
    crowded = [n for n, k in ps.items() if k > 1]
    if crowded:
        fail(f"affinity path: nodes {crowded[:5]} hold two role=ps residents")
    bootstrap = Counter(team for (team, _r), roles in new_roles.items()
                        if roles == {"mpi"})
    unbacked = sorted(team for team, k in bootstrap.items()
                      if team in start_teams or k > 1)
    if unbacked:
        fail("affinity path: MPI workers of teams " + ", ".join(unbacked)
             + " placed in racks without a team-mate and not under the bootstrap waiver")
    return {"ps_residents": sum(ps.values()), "mpi_residents": len(mpi),
            "mpi_bootstrap_racks": sum(bootstrap.values()),
            "racks_with_team_pods": len(start_racks) + len(new_roles)}


def phase_affinity_path(device, wave: int = MAIN_WAVE_PODS, **world_kw):
    """Config 5 with affinity terms (models/workloads.py ·
    config5_affinity_world) at full size under the default conf, 2 cycles
    through `Scheduler.run_once` with a second wave after cycle 1; K10 and
    K11 launch counters are set to 0 before and read after.  Returns (the
    counts, the Recorder of the K10 / K11 calls)."""
    from kube_batch_tpu_torch import kernels
    from kube_batch_tpu_torch.scheduler import Scheduler

    cache, sim = config5_affinity(**world_kw)
    sched = Scheduler(cache, device=device)
    rec = Recorder({**{name: 10**9 for name in _MUTATED}, **AFFINITY_EVERY})
    kernels.reset_counts()
    before = kernels.counts()
    sessions = []
    with rec:
        for cycle in range(2):
            t0 = time.perf_counter()
            ssn = sched.run_once()
            wall_ms = (time.perf_counter() - t0) * 1e3
            if ssn is None:
                fail(f"affinity path: cycle {cycle + 1} found nothing to solve")
            now = kernels.counts()
            t = sched.last_timings
            line = {"phase": "affinity-path", "cycle": cycle + 1,
                    "tasks": ssn.meta.num_real_tasks, "padded_tasks": ssn.snap.num_tasks,
                    "nodes": ssn.snap.num_nodes, "bound": len(ssn.bound),
                    "wall_ms": round(wall_ms, 3),
                    **{k: round(v, 3) for k, v in t.items()},
                    **{k: v for k, v in sched.last_stats.items() if k.endswith("rounds")},
                    **{k: v for k, v in sched.last_stats.items() if k.endswith("cancelled")},
                    **{f"{k}_launches": now[k] - before[k] for k in AFFINITY_KERNELS}}
            if now["affinity_mask"] - before["affinity_mask"] > 1:
                fail(f"affinity path: cycle {cycle + 1} launched affinity_mask "
                     f"{now['affinity_mask'] - before['affinity_mask']} times (at most once)")
            before = now
            _check_binds_allowed(ssn)
            line.update(_check_affinity(ssn, cache))
            log(json.dumps(line))
            sessions.append((ssn.snap.num_tasks, len(ssn.bound)))
            sim.tick()
            if cycle == 0:
                log(json.dumps({"phase": "affinity-path-arrivals",
                                "pods": arrivals(cache, sim, wave)}))
    counts = kernels.counts()
    log(json.dumps({"phase": "affinity-path-launches", **counts}))
    for name in AFFINITY_KERNELS:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the affinity path")
    # every auction round builds its words once, then proposes: the n-th
    # recorded words and K2 calls are one round's
    if rec.seen["affinity_words"] != rec.seen["propose_best"]:
        fail(f"affinity path: {rec.seen['affinity_words']} affinity_words calls for "
             f"{rec.seen['propose_best']} auction rounds")
    if not sessions[0][1] or not sessions[1][1]:
        fail("an affinity-path cycle bound nothing")
    _check_invariants(cache)
    log(json.dumps({"phase": "affinity-path-invariants", "capacity": True,
                    "gang": True, "predicate": True, "one_ps_per_node": True,
                    "mpi_team_mate_in_rack": True}))
    return counts, rec


# ---------------------------------------------------------------------------
# the joint path: config 4 + wave under examples/scheduler.conf, joint solve
# ---------------------------------------------------------------------------

def _tier_line(stats: dict) -> list:
    return [{**{k: v for k, v in t.items() if k != "ms"}, "ms": round(t["ms"], 3),
             "ms_per_step": round(t["ms"] / max(t["steps"], 1), 4)}
            for t in stats.get("joint_tiers", [])]


def phase_joint_path(device, seq_cycles, n_cycles: int = JOINT_CYCLES):
    """The preempt path's world and wave with `joint_solve=True` on the
    card: every cycle must run the joint solve, cycle 2 must evict, the
    capacity, gang and predicate invariants hold; binds and evictions
    are compared as sets with the sequential card run (`seq_cycles`, the
    preempt path's), and each difference is printed beside the gated
    admission tier's placements.  Returns (launch counts, the Recorder
    of the K12 calls, the cycles)."""
    from kube_batch_tpu_torch import kernels
    from kube_batch_tpu_torch.scheduler import Scheduler

    cache, sim = preempt_world()
    sched = Scheduler(cache, conf=scheduler_conf(), device=device, joint_solve=True)
    rec = Recorder({**{name: 10**9 for name in _MUTATED}, **JOINT_EVERY})
    kernels.reset_counts()
    cycles = []
    for cycle in range(n_cycles):
        t0 = time.perf_counter()
        with rec:
            ssn = sched.run_once()
        wall_ms = (time.perf_counter() - t0) * 1e3
        if ssn is None:
            fail(f"joint path: cycle {cycle + 1} found nothing to solve")
        if sched.last_stats.get("cycle") != "joint":
            fail(f"joint path: cycle {cycle + 1} ran {sched.last_stats.get('cycle')}")
        _check_binds_allowed(ssn)
        c = _cycle_record(ssn, sched)
        cycles.append(c)
        seq = seq_cycles[cycle]
        binds, seq_binds = set(c["binds"]), set(seq["binds"])
        ev, seq_ev = set(c["evicted"]), set(seq["evicted"])
        tiers = _tier_line(c["rounds"])
        admission = sum(t.get("placed", 0) for t in tiers if t["tier"] == "admission")
        diff = {"binds_only_joint": len(binds - seq_binds),
                "binds_only_sequential": len(seq_binds - binds),
                "evicted_only_joint": len(ev - seq_ev),
                "evicted_only_sequential": len(seq_ev - ev)}
        earlier = sum(t.get("placed", 0) for prev in cycles[:-1]
                      for t in _tier_line(prev["rounds"]) if t["tier"] == "admission")
        cause = ("identical" if not any(diff.values())
                 else "gated admission tier" if admission + earlier > 0
                 else "not the admission tier")
        t = sched.last_timings
        log(json.dumps({
            "phase": "joint-path", "cycle": cycle + 1, "cycle_kind": "joint",
            "tasks": ssn.meta.num_real_tasks, "bound": len(c["binds"]),
            "evicted": c["rounds"].get("evicted", {}), "wall_ms": round(wall_ms, 3),
            **{k: round(v, 3) for k, v in t.items()},
            "tiers": tiers, "sequential_loops": _loop_line(seq["rounds"]),
            "sequential_solve_ms": round(seq["timings"]["solve_ms"], 3),
            "vs_sequential": diff, "admission_placed": admission,
            "difference_cause": cause,
            "binds_only_joint_sample": sorted(binds - seq_binds)[:5],
            "binds_only_sequential_sample": sorted(seq_binds - binds)[:5],
        }))
        sim.tick()
        if cycle == 0:
            preempt_wave(sim)
    counts = kernels.counts()
    log(json.dumps({"phase": "joint-path-launches", **counts}))
    for name in ("tier_control", "preempt_open", "segment_sum", "segment_count"):
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the joint path")
    if cycles[0]["evicted"]:
        fail("joint path: cycle 1 evicted pods from the empty cluster")
    if not cycles[1]["evicted"]:
        fail("joint path: cycle 2 evicted nothing")
    _check_invariants(cache)
    log(json.dumps({"phase": "joint-path-invariants", "capacity": True, "gang": True,
                    "predicate": True}))
    return counts, rec, cycles


def phase_affinity_kernels(arec: Recorder, row_rec: Recorder, jrec: Recorder):
    """K11 on every 8th recorded call of the affinity path, K10's mask on
    each of its calls (one a cycle), K10's words and K2 on every 300th
    round, K10's row form on every call of ROW_WORLD's card run, K12 on
    every 10th call of the joint path, each against its plain version;
    timed on cycle 2's inputs of their paths, and K2 given the words
    against K2 given K10's mask of the same tables (outputs equal, both
    timed).  Returns (kernel records, {K2 pass: max abs err on the
    affinity path})."""
    import torch

    from kube_batch_tpu_torch.kernels import affinity as k10
    from kube_batch_tpu_torch.kernels import joint_tier as k12
    from kube_batch_tpu_torch.kernels import propose as k2
    from kube_batch_tpu_torch.kernels import resident as k11

    checks = {}
    for label, rec, names in (("affinity-path", arec, AFFINITY_KERNELS),
                              ("affinity-path-k2", arec, ("propose_best", "propose_pick")),
                              ("row-world", row_rec, AFFINITY_ROW),
                              ("joint-path", jrec, JOINT_ONLY)):
        got = check_all(rec, names)
        log(json.dumps({"phase": f"{label}-kernels", "equal_to_plain": True, **got}))
        checks.update(got)
        for name in names:
            if got[name]["calls"] <= 0:
                fail(f"{label}: no {name} call was recorded")
    out = {}

    def record(name, ms, plain_ms, b, library_ms=None, **note):
        out[name] = dict(max_abs_err=checks[name]["max_abs_err"], ms=ms,
                         plain_ms=plain_ms, bound=b, library_ms=library_ms)
        log(json.dumps({"phase": "kernel", "name": name, "ms": round(ms, 4),
                        "plain_ms": round(plain_ms, 4),
                        "library_ms": None if library_ms is None else round(library_ms, 4),
                        "bound_ms": round(b[0], 6), "bound_by": b[1], **note}))

    def second_cycle(rec, name):
        last = max(c for c, _r, _a in rec.calls[name])
        return [a for c, _r, a in rec.calls[name] if c == last]

    # K11: cycle 2's first future-oriented call
    args = next(a for a in second_cycle(arec, "resident_tables") if not a[11])
    podlabels, anti, anti_topo, task_node, task_state, task_mask, nkd = args[:7]
    (T, K), K2, N, D = podlabels.shape, anti_topo.shape[1], args[9], args[10]
    held = int(k11.resident_mask(task_state, task_node, task_mask, False).sum())
    record("resident_tables", time_ms(lambda: k11.resident_tables(*args)),
           time_ms(lambda: k11.resident_tables_plain(*args)),
           bound(T * 9 + held * (2 * K + K2) * 4 + nkd.numel() * 4 + 2 * K2 * 4
                 + 2 * N * K + 2 * D * K, 0),
           residents=held, tasks=T, nodes=N, domains=D)

    # K10's mask: cycle 2's call (the failure tallies, Idle orientation)
    args = second_cycle(arec, "affinity_mask")[0]
    fields, tables = args[:8], args[8:]
    T, N = fields[0].shape[0], tables[0].shape[0]
    KW, K2W = (K + 31) // 32, (K2 + 31) // 32
    table_bytes = sum(x.numel() for x in tables if x is not None)
    in_bytes = sum(x.numel() * x.element_size() for x in fields) + table_bytes
    record("affinity_mask", time_ms(lambda: k10.affinity_mask(*args)),
           time_ms(lambda: k10.affinity_mask_plain(*args), warmup=1, runs=3),
           bound(in_bytes + T * N, T * N * (5 * KW + 4 * K2W)),
           # the plain version's float matrix products are the one-call
           # PyTorch form of this function
           time_ms(lambda: k10.affinity_mask_plain(*args), warmup=1, runs=3),
           cells=T * N, live_words=[KW, K2W])

    # K10's words and K2's words form: the last recorded round (cycle 2)
    wargs = arec.calls["affinity_words"][-1][2]
    bargs = arec.calls["propose_best"][-1][2]
    pargs = arec.calls["propose_pick"][-1][2]
    words = bargs[1]
    fields, tables, kept = wargs[:8], wargs[8:14], wargs[14]
    nw = words.node_words.shape[1]
    nkd_bytes = fields[7].numel() * 4
    # kept task words and each distinct table in; node words and
    # thresholds out
    distinct = {x.data_ptr(): x for x in tables if x is not None}.values()
    words_bytes = (sum(x.numel() for x in distinct) + nkd_bytes
                   + fields[6].numel() * 4 + T * nw * 4 + N * nw * 4 + T * 8)
    record("affinity_words", time_ms(lambda: k10.affinity_words(*wargs)),
           time_ms(lambda: k10.affinity_words_plain(*wargs)),
           bound(words_bytes, N * nw * 32 + T * (KW + K2W) * 32),
           task_words_kept=kept is not None, tasks=T, nodes=N, words=nw)
    mask = k10.affinity_mask(*fields, *tables)
    margs = (bargs[0], mask) + tuple(bargs[2:])
    mpargs = (pargs[0], mask) + tuple(pargs[2:])
    best_w = require_equal("propose_best words against mask form", list(zip(
        k2.propose_best(*bargs), k2.propose_best(*margs))))
    pick_w = require_equal("propose_pick words against mask form", [
        (k2.propose_pick(*pargs), k2.propose_pick(*mpargs))])
    best_ms, best_mask_ms = (time_ms(lambda: k2.propose_best(*bargs)),
                             time_ms(lambda: k2.propose_best(*margs)))
    pick_ms, pick_mask_ms = (time_ms(lambda: k2.propose_pick(*pargs)),
                             time_ms(lambda: k2.propose_pick(*mpargs)))
    mask_ms = time_ms(lambda: k10.affinity_mask(*fields, *tables))
    words_ms = out["affinity_words"]["ms"]
    log(json.dumps({
        "phase": "k2-words-form", "tasks": T, "nodes": N, "words": nw,
        "eligible": int(bargs[6].sum()),
        "propose_best_ms": round(best_ms, 4),
        "propose_best_mask_form_ms": round(best_mask_ms, 4),
        "propose_pick_ms": round(pick_ms, 4),
        "propose_pick_mask_form_ms": round(pick_mask_ms, 4),
        "affinity_words_ms": round(words_ms, 4), "affinity_mask_ms": round(mask_ms, 4),
        "round_words_ms": round(words_ms + best_ms + pick_ms, 4),
        "round_mask_ms": round(mask_ms + best_mask_ms + pick_mask_ms, 4),
        "max_abs_err": max(best_w, pick_w),
        # pass 1 reads the predicate mask and the words instead of a mask
        "propose_best_bound_ms": round(bound(T * N + T * nw * 4 + T * 8 + N * nw * 4
                                             + len(bargs[10]) * 4 * T * N, 0)[0], 6),
        "propose_best_mask_form_bound_ms": round(bound(2 * T * N + len(bargs[10]) * 4
                                                       * T * N, 0)[0], 6)}))

    # K10's row form: a call of ROW_WORLD's cycle 2
    args = second_cycle(row_rec, "affinity_row")[0]
    nkd, tables = args[7], args[8:12]
    K, K2, N = args[0].shape[1], args[3].shape[1], tables[0].shape[0]
    KW, K2W = (K + 31) // 32, (K2 + 31) // 32
    row_bytes = ((3 * K + 2 * K2) * 4 + 2 * K2 * 4 + nkd.numel() * 4
                 + sum(x.numel() for x in tables if x is not None) + N)
    record("affinity_row", time_ms(lambda: k10.affinity_row(*args)),
           time_ms(lambda: k10.affinity_row_plain(*args)),
           bound(row_bytes, N * (5 * KW + 4 * K2W)), nodes=N)

    # K12: cycle 2's calls of the joint path, an evict-tier step that does
    # not end its tier (the common case; nothing is written in place)
    calls = second_cycle(jrec, "tier_control")

    def fresh(a):
        return [x.clone() if i in _MUTATED["tier_control"] else x for i, x in enumerate(a)]

    def ends(a):
        return bool(k12.tier_control_plain(*fresh(a))[0])

    args = next((a for a in sorted(calls, key=lambda a: a[0] != k12.EVICT)
                 if not ends(a)), calls[0])
    done, args = ends(args), fresh(args)
    record("tier_control", time_ms(lambda: k12.tier_control(*args)),
           time_ms(lambda: k12.tier_control_plain(*args)),
           bound(_tier_control_bytes(args, done), 0),
           kind="evict" if args[0] == k12.EVICT else "auction",
           tasks=args[5].shape[0], done=done)
    torch.cuda.synchronize()
    return out, {name: max(checks[name]["max_abs_err"], err) for name, err in
                 (("propose_best", best_w), ("propose_pick", pick_w))}


def _tier_control_bytes(args, done: bool) -> int:
    """The bytes one K12 launch on `args` must move, each read or write
    once: the masks its tier's work test reads (task_state, task_mask,
    elig; an evict tier's task_job, tried and starving; a gated auction
    tier's codes), the carry, the phase and the flags; and, only when the
    tier ends, the advance (prov read, tried / prov / excl cleared, and
    an open plan's victims restored with their request sum)."""
    from kube_batch_tpu_torch.kernels import joint_tier as k12

    kind, gated, carry, prov, node_future = args[0], args[1], args[4], args[12], args[15]
    T, (N, R) = args[5].shape[0], node_future.shape
    per_task = 4 + 1 + 1
    if kind == k12.EVICT:
        per_task += 4 + 1
    elif gated:
        per_task += 4
    n = T * per_task + (args[9].shape[0] if kind == k12.EVICT else 0) + 12 + 4 + 12
    if done:
        n += T + 2 * T + N + 4
        if int(carry[1]):
            victims = int(prov.sum())
            n += victims * (4 + 4 + 4 + 4 * R) + 2 * 4 * R
    return n


# kernels redesigned for this card, and by which change; a later redesign
# takes the next unmarked kernel of the order
REDESIGNED = {"segment_sum": "PR 5", "segment_count": "PR 5", "preempt_open": "PR 5",
              "lex_push_many": "PR 6", "sort_by_segment": "PR 6",
              "affinity_mask": "PR 6", "affinity_words": "PR 6"}


def redesign_order(kernels_line) -> tuple[list, str | None]:
    """The kernels in the order a redesign should take them: first those
    slower than their library form, largest factor first; then the rest
    by launches × (ms − bound_ms), the card time above the bound over
    the path's launches.  Kernels already redesigned are marked; the
    second value names the first that is not."""
    slower = sorted((k for k in kernels_line
                     if k["library_ms"] is not None and k["ms"] > k["library_ms"]),
                    key=lambda k: -k["ms"] / k["library_ms"])
    rest = sorted((k for k in kernels_line if k not in slower),
                  key=lambda k: -k["launches"] * (k["ms"] - k["bound_ms"]))
    order = ([{"name": k["name"], "library_factor": round(k["ms"] / k["library_ms"], 3)}
              for k in slower]
             + [{"name": k["name"],
                 "excess_ms": round(k["launches"] * (k["ms"] - k["bound_ms"]), 1)}
                for k in rest])
    for k in order:
        if k["name"] in REDESIGNED:
            k["redesigned"] = REDESIGNED[k["name"]]
    return order, next((k["name"] for k in order if "redesigned" not in k), None)


def main() -> int:
    import torch

    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not os.path.isdir(os.path.join(ROOT, "kube_batch_tpu_torch", "kernels")):
        fail("kube_batch_tpu_torch not found beside chip_smoke.py; run it "
             "from the root of a checkout")
    sys.path.insert(0, ROOT)
    from kube_batch_tpu_torch.device import resolve_device

    device = resolve_device("cuda")
    # The CPU runs take minutes: worker processes run them while this one
    # drives the card (one for the preempt path, two for the parity
    # worlds), and are stopped on every exit.
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    pool, ppool = ctx.Pool(1), ctx.Pool(2)
    try:
        cpu_preempt = pool.apply_async(preempt_cycles_cpu, (ROOT,))
        cpu_parity = {w: ppool.apply_async(parity_cpu, (ROOT, w))
                      for w in PARITY_WORLDS}
        phase_card_and_build()
        edge_errs = phase_edge_inputs(device)
        edge_errs.update(phase_k8_edge(device))
        edge_errs.update(phase_words_edge(device))
        row_counts, row_rec = phase_parity(cpu_parity)
        ppool.close()
        ppool.join()
        counts, rec = phase_main_path(device)
        records = phase_kernels(rec)
        host_counts, hrec = phase_host_cycle(device)
        records.update(phase_row_patch(hrec))
        del hrec
        affinity_counts, arec = phase_affinity_path(device)
        preempt_counts, prec, pcycles = phase_preempt_path(cpu_preempt)
        records.update(phase_preempt_kernels(prec, pcycles))
        records.update(phase_rank_kernels(rec, prec, counts, preempt_counts, pcycles))
        del rec, prec
        joint_counts, jrec, _ = phase_joint_path(device, pcycles)
        affinity_records, k2_errs = phase_affinity_kernels(arec, row_rec, jrec)
        records.update(affinity_records)
        del arec, row_rec, jrec
        pool.close()
        pool.join()
    finally:
        pool.terminate()
        ppool.terminate()

    for name, err in list(edge_errs.items()) + list(k2_errs.items()):
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
    kernels_line = []
    for name, (route, source, replaces) in KERNELS.items():
        r = records[name]
        launches = (preempt_counts[name] if name in PREEMPT_KERNELS
                    else host_counts[name] if name in HOST_CYCLE_ONLY
                    else affinity_counts[name] if name in AFFINITY_KERNELS
                    else row_counts[name] if name in AFFINITY_ROW
                    else joint_counts[name] if name in JOINT_ONLY
                    else counts[name])
        kernels_line.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        })
    order, pick = redesign_order(kernels_line)
    log(json.dumps({"phase": "redesign-order", "kernels": order, "next": pick}))
    log(json.dumps({"phase": "done", "seconds": round(time.perf_counter() - t_start, 1)}))
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
