#!/usr/bin/env python3
"""Chip smoke test of kube_batch_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and
`nvcc`.  Phases (any failure exits non-zero):

1. card and build — the card's name and power limit, torch/CUDA
   versions, and the build of every CUDA kernel from this checkout's
   sources (one nvcc per source, all at once: K1–K13), timed; the host
   link's rate (`host_link_rate`: a 64 MiB pinned copy, on a line with
   the card's name and power limit); K9 on `phase_k9_edge` (rows of 1, 3,
   12 and 16 bytes with padded duplicates, a payload past the slot so
   the ring grows, a slot reused by calls issued back to back, an index
   outside its buffer refused) and K7's
   water-fill on `fill_edge_inputs` (Q = 1,024 with R = 40, one queue,
   33 queues, every queue masked, no capacity, 5,000 queues on the
   global scratch, and the fused form with the queue sums at the main
   path's shape, at Q = 1,024 / R = 40, at Q = 880 / R = 4 where the
   sum's static shared memory narrows the fill's plan, at 5,000 queues
   and with long segments; two runs equal, exactly equal to the plain version, the
   iterations to the fixed point logged);
   then K7 and K6 on their edge inputs (K7: one segment, mostly empty
   segments, every row masked out, one segment holding every row,
   non-integer values — two runs bitwise equal, the plain version equal,
   within K7_REL_TOL on the non-integer values; K6's preempt_open:
   nothing eligible, a fit only at the last cell, a fit at the first
   cell, no ready node, and T = 65,536 with N = 8,192, timed); K8's
   lex_push_many and sort_by_segment on keys of T = 1, 8,192, 16,384,
   16,385 and 65,536 rows with NaN, ±0.0 and ±inf, all-equal keys and 40
   keys, and segment keys of 1, 3, 512 and 70,000 segments; K8's vtime
   (`vtime_edge_inputs`: T = 1, 1,023, 8,192, 16,384 and 16,385 with S = 1
   and S = T, every row invalid, empty segments, zero denominators,
   column totals past 2^24; two runs equal, equal to the plain version);
   K2's two passes on `k2_edge_cases` (no eligible row, one at T − 1,
   1 %, T and N off the row group and node tile, N not a multiple of 16,
   32 or 4, every node alike so ties span node tiles and chunks, quantum
   on and off, the mask, a dynamic mask with two extra terms, and the
   words with W = 1, 2 and 8, and at N = 8,192 1 %, 7.5 % and every row
   eligible in both forms; pass 2 reads pass 1's tie summaries, with k
   the row index mod ties and k = ties − 1; exactly equal to the plain
   versions); K5's one-launch node choice on `k5_edge_inputs` (equal
   ranks, nodes tied on k, no feasible node, a fit with no victim, a run
   past LONG_RUN, no victim; T = 8,192 with N = 512, N = 8,192, and T =
   20,000 on the sort-then-walk route; each also on the radix route;
   exactly equal to the plain version); K3's resolve on `k3_edge_inputs`
   (T = 1, 33, 16,384, 16,385, 65,536, 131,072 and 262,144 with one node
   taking every proposer, every proposer on a node of its own, tied
   ranks (the sort by rank), a serialize mask and one_per_node, on the
   blocks the kernel chooses (262,144 rows on the device-memory
   scratch); kept, perm, s_node and the cancelled count exactly equal to
   the plain version); K1 on `k1_edge_snap` (vocabularies 1, 31, 32, 33
   and 100 columns wide, N = 1,000, 8,191 and 8,192, pins at nodes 0 and
   N − 1, all predicates on and the default flags, and the 256 flag
   combinations at width 33) and on `k1_hostname_snap` (a label per node
   at N = 8,192, selectors naming hundreds of them: many tiles of words);
   exactly equal to the plain version, and the hostname world also to
   the reference's own products (`predicate_matmul`)); K10's row
   operand (`phase_k10_row_edge`: topology terms on and off, K = K2 =
   256, K5's walk route past 16,384 rows, a preemptor whose required
   terms only the bootstrap waiver meets; the row, K6's cell at a node
   that is not viable and at one that is, and K5 given the operand, with
   and without a dynamic mask, against K5's plain version fed the plain
   row); K3 apply (`phase_k3_apply_edge`: one node holding all 65,536
   rows, rows spread at 65,536 and 262,144, R = 1 to 8, an empty accept
   set, both use_future values, and resolve's own output at 1,048,577
   rows, resolve exact there too); both phases timed; K6's
   preempt_continue (`phase_k6_continue_edge`: ranks a permutation and
   tied, the plan's node holding no victim and every victim, T = 1,
   8,191, 8,192 and 65,536, no row, a bool row, and K10's row operand
   with and without a mask at nodes where it holds and fails; every call
   on one kept buffer; timed at 8,192 and 65,536 rows) and K4
   (`phase_k4_edge`: N = 500, 4,999 and 8,192, T off a multiple of 32,
   R = 1 and 8, one request class for all rows and one a row, an
   all-false row, requests below eps on every dim; no dynamic predicate,
   a mask, and K10's words at W = 1, 2 and 8 equal to K4 given K10's
   mask of the same tables), exactly equal to the plain versions;
   K13's class table (`phase_k13_edge`: C = 17 at the affinity path's
   shapes, C = T = 65,536 × 8,192, K2 = 0, node terms only, K = 40 and
   K2 = 72, the zero class, Hd past the shared-memory route (D = 65,536
   at K = 40, D = 8,192 at K = 32) and 96 topology keys, each on the
   launch route it must take; exactly equal to the plain version); K10's
   affinity_task_words and affinity_words, K11's resident_words (both
   resident sets and the future set alone) and K2's words form on
   seeded affinity terms (each = plain, K2 given the words = K2 given
   K10's mask = plain) and on a world with no terms (= K2 given no
   predicate);
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
   read after, and both must have launched, the mask never (the auction
   rounds and the failure tallies take K10's words: one words build a
   round and one a cycle) and K11 at most once an auction round plus
   once a cycle; capacity, gang and predicate
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
   steps and ms per step beside the sequential loops', and the device
   operations per joint step by tier kind (`JointWindows`: 40 auction
   steps of cycle 1 and 40 evict steps of cycle 2 of this run traced by
   torch.profiler);
8. kernels — each kernel against its plain PyTorch version on the card:
   K1–K4 on the inputs the main path gave them in cycle 2 (the predicate
   mask and failure tallies of that cycle, and the auction round whose
   resolve rejected the most proposals), K7 on every call of the main
   path, K5–K7 on every input the preempt path gave them in cycles 2 and
   3 (segment sums and counts sampled), timed on cycle 2's; K8 on every 10th call
   of the main path and every 25th of the preempt path, timed at both
   paths' widths (T = 65,536 and 8,192), with K8's launches on both
   paths and per preemption step; K9 on every call of the host
   cycle in both forms (a device copy of the pinned staging slot, and the
   slot read over the host link), timed on the largest, its bound
   counting the host link (`row_patch_bound`); K7's water-fill (with its
   queue sums: `RequestRows`) on every call of every path, timed on the
   main and preempt paths (`waterfill_bound`: this call's iterations to
   the fixed point); K11 on every call of the affinity
   path (timed on an immediate and a FutureIdle round), K10's mask and
   task words on each of their calls, K10's words with K2's two passes
   every 300th round (K2 given the words against K2 given K10's mask,
   both timed; K2 given K13's class term against K2 given the same term
   gathered to [T, N]), K13 on every call of the affinity path (timed on
   cycle 2's last round beside its library forms over the class rows and
   over every task's row), and K10's row form on the
   config5_affinity_mid card run under examples/scheduler.conf (K5
   given the row operand on every opening step, against K5's plain
   version fed the plain row, and K6 given it on every continuing step,
   if one occurs; the row form timed on a recorded operand, with K5 with
   and without it), K12 on
   every 10th call of the joint path (after auction and evict steps)
   and on a recorded evict step with a plan open replayed at its step
   bound (a Discard advance), each timed on cycle 2's inputs; K6's
   preempt_continue on every continuing step of the preempt and joint
   paths; K4 on every call of every path (one a cycle; the affinity
   path's and the affinity parity worlds' in K10's words form), timed on
   the affinity path's cycle 2 beside the parent's chain (K10's mask, the
   AND, K4 on the AND); K10's mask, which no path launches, on the
   tallies' operands.
   Outputs exactly equal; kernel / plain / library times (median of
   CUDA-event timed runs after a warm-up) and the least time the card
   could take (K2 pass 1's from its eligible rows only; the eligible
   share of each timed round is logged).  K2 and K3 are also timed on
   the affinity path's recorded round and on the preempt path's round
   with the most eligible rows, K8 at the preempt path's 8,192 rows:
   `redesign_order` charges each path's launches at its own shapes
   where one of these times exists (`PATH_TIMES`; the joint path runs
   the preempt path's world and no parity world is wider than 8,192
   rows), else at the line's.

The subset-diag phase runs after the affinity path on the final states
of the main path's cycle 2, the affinity path's cycle 2 and
config5_affinity_mid's card run (SUBSET_WORLD, default conf, topology
terms): the active-set diagnosis (`framework/fit_errors.py ·
failure_counts_subset`, a 2,048-row window of pending rows) in its words
form, its mask form and, under a policy with an extra dynamic predicate
that has no subset form, its fallback, with the launch counters set to 0
before and read after; each valid window row and `nodes` must equal the
full tallies of the same state (the cycle's own), every other row 0, the
two forms equal, the fallback equal to that policy's full tallies, and
every K1, K11, K10 and K4 call of the phase equal to its plain version;
the subset call, the full tallies and K1 / K4 at the window are timed
(`subset-diag` line).  The subset form stays off every cycle path: each
path launches K1 and K4 once a cycle.

The parity worlds (phase 2) also include config5_affinity_mid (500
nodes, 5,000 pods, a 1,500-pod wave) under both confs, and
features_preempt and config5_affinity_mid under examples/scheduler.conf
with the joint solve; every K10, K11 and K12 call of their card runs is
held against its plain version.  Kernels already redesigned for this
card (`REDESIGNED`) are marked in the `redesign-order` line.  Library
times: one PyTorch call or the same function in library calls where
one exists (K3 apply: a float64 index_add_ and two row scatters;
preempt_continue: the PyTorch chain of its four outputs, a masked
argmin, an any, the fit test and the row's cell; failure_counts: the
reference's reductions over [T, N, R] at once; K10's row: the
reference's products, its plain version's form).

The line before the `kernels` line gives the script's seconds, and the
one before it the order a redesign should take the kernels in, those
already redesigned marked, with each kernel's excess card time by path.
Each entry of the `kernels` line carries `launches_by_path` (main,
host_cycle, affinity, preempt, joint, parity: every parity world's card
run, and subset_diag) and `launches`, their sum.
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
    "failure_counts": ("cuda", "kube_batch_tpu_torch/kernels/csrc/failure_counts.cu",
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
    "resident_words": ("cuda", "kube_batch_tpu_torch/kernels/csrc/resident_tables.cu",
                       "kube_batch_tpu/plugins/predicates.py:136"),
    "affinity_mask": ("cuda", "kube_batch_tpu_torch/kernels/csrc/affinity_mask.cu",
                      "kube_batch_tpu/plugins/predicates.py:299"),
    "affinity_row": ("cuda", "kube_batch_tpu_torch/kernels/csrc/affinity_mask.cu",
                     "kube_batch_tpu/plugins/predicates.py:330"),
    "affinity_words": ("cuda", "kube_batch_tpu_torch/kernels/csrc/affinity_mask.cu",
                       "kube_batch_tpu/plugins/predicates.py:263"),
    "affinity_task_words": ("cuda", "kube_batch_tpu_torch/kernels/csrc/affinity_mask.cu",
                            "kube_batch_tpu/plugins/predicates.py:263"),
    "tier_control": ("cuda", "kube_batch_tpu_torch/kernels/csrc/joint_tier.cu",
                     "kube_batch_tpu/ops/joint.py:200"),
    "podaff_score": ("cuda", "kube_batch_tpu_torch/kernels/csrc/podaff_score.cu",
                     "kube_batch_tpu/plugins/nodeorder.py:90"),
}
PREEMPT_KERNELS = ("victim_prefix", "preempt_open", "preempt_continue",
                   "segment_sum", "segment_count", "waterfill")
EVICTING_ONLY = ("victim_prefix", "preempt_open", "preempt_continue")
RANK_KERNELS = ("lex_push_many", "sort_by_segment", "vtime")
# launched where a steady cycle row-patches; required on the host cycle
HOST_CYCLE_ONLY = ("row_patch",)
# launched only on worlds with inter-pod affinity terms (the affinity
# path, and where such a world preempts) and by the joint solve
AFFINITY_KERNELS = ("resident_words", "affinity_words", "affinity_task_words",
                    "podaff_score")
# entries of K10 that no path launches: the row form, which K5 and K6
# test inside their own launches, and the mask,
# whose words the failure tallies test inside K4's launch; checked and
# timed on recorded operands, their launches counted
ENTRY_ONLY = ("affinity_row", "affinity_mask")
JOINT_ONLY = ("tier_control",)
NOT_ON_MAIN_PATH = (EVICTING_ONLY + HOST_CYCLE_ONLY + AFFINITY_KERNELS
                    + ENTRY_ONLY + JOINT_ONLY)

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
# preempt path (every sort_by_segment call: since K5 sorts its own
# victims, the segment indexes' few sorts are the path's only ones), and
# every 10th K8 call of the main path
PREEMPT_EVERY = {name: 25 for name in ("segment_sum", "segment_count") + RANK_KERNELS}
PREEMPT_EVERY["sort_by_segment"] = 1
MAIN_EVERY = {name: 10 for name in RANK_KERNELS}
# the host-cycle phase: config 5 full, 4 cycles, churn between them
HOST_CYCLES = 4
HOST_DONE_EVERY = 100        # every 100th running pod completes or is deleted
HOST_ARRIVAL_PODS = 300      # pods arriving into existing jobs' shapes
HOST_EVICTED = 20            # pods evicted after the cycle without arrivals
# the affinity path records every K11 call (one a round, so the few
# FutureIdle rounds are met), every K10 task-words call (one a snapshot)
# and words call (one a round, and one a cycle for the failure tallies:
# a round's is paired with its K2 calls by (cycle, round)), every K4 call,
# and the K2 and K3 calls of every 300th round; the joint path every 10th
# K12 call, every K6 continuing step and every K4 call
AFFINITY_EVERY = {"resident_words": 1, "affinity_task_words": 1, "affinity_words": 1,
                  "podaff_score": 1,
                  "failure_counts": 1, "waterfill": 1, "propose_best": 300,
                  "propose_pick": 300, "resolve": 300, "apply": 300}
JOINT_EVERY = {"tier_control": 10, "preempt_continue": 1, "failure_counts": 1,
               "waterfill": 1}
JOINT_CYCLES = 3
# the parity world whose preemption steps hand K5 K10's row operand
ROW_WORLD = "config5_affinity_mid_preempt"
# the parity world (default conf, topology-scoped terms) whose final state
# the subset-diag phase reads beside the main and affinity paths'
SUBSET_WORLD = "config5_affinity_mid"
# the kernels the active-set diagnosis launches (K10's mask: its mask form)
SUBSET_KERNELS = ("predicate_mask", "resident_words", "affinity_words", "affinity_mask",
                  "failure_counts")


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

# the card's name and power limit as nvidia-smi gives them, and the host
# link's measured rate (host_link_rate), for the lines and bounds that
# need them
CARD: dict = {}
HOST_LINK: dict = {}


def host_link_rate(device, nbytes: int = 64 << 20) -> float:
    """Bytes a second of one pinned host-to-device copy of `nbytes`
    (64 MiB), by CUDA events; printed on a line of its own with the
    card's name and power limit."""
    import torch

    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=device)
    ms = time_ms(lambda: dst.copy_(src, non_blocking=True))
    rate = nbytes / (ms / 1e3)
    HOST_LINK["bytes_per_s"] = rate
    log(json.dumps({"phase": "host-link", "card": CARD.get("line"), "bytes": nbytes,
                    "ms": round(ms, 4), "gb_per_s": round(rate / 1e9, 3)}))
    return rate


def phase_card_and_build():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    CARD["line"] = smi.stdout.strip().splitlines()[0]
    log(CARD["line"])
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


def vtime_edge_inputs(device, seed: int = 0):
    """name → K8 vtime's arguments (seg, base_rank, req, valid, alloc_seg,
    denom_seg, S) at T = 1, 1,023, 8,192, 16,384 (the one-block limit)
    and 16,385, each with S = 1 and S = T: segment ids out of range on both
    sides, about 70 % of the rows valid, integer requests whose column
    totals pass 2^24, a denominator that is 0 in some segments and dims
    (the 1e30 and the 0 branch) and, for S = 1, broadcast as drf's is;
    and at 8,192 rows every row invalid, three non-empty segments of 64,
    and every denominator 0."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    R = 4

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def case(T, S, invalid=False, segs=None, zero_denoms=False):
        seg = (rng.choice(segs, T) if segs is not None
               else rng.integers(-1, S + 1, T)).astype(np.int32)
        rank = rng.permutation(T).astype(np.int32)
        req = rng.integers(0, 4_000_000, (T, R)).astype(np.float32)
        req[rng.random((T, R)) < 0.2] = 0.0
        valid = np.zeros(T, bool) if invalid else rng.random(T) < 0.7
        alloc = rng.integers(0, 50_000_000, (S, R)).astype(np.float32)
        alloc[rng.random((S, R)) < 0.3] = 0.0
        denom = rng.integers(1, 90_000_000, (S, R)).astype(np.float32)
        denom[rng.random((S, R)) < (1.0 if zero_denoms else 0.3)] = 0.0
        denom_t = on(denom)
        if S == 1:
            denom_t = on(denom[0])[None, :].expand(S, R)
        return (on(seg), on(rank), on(req), on(valid), on(alloc), denom_t, S)

    out = {}
    for T in (1, 1023, 8192, 16384, 16385):
        for S in sorted({1, T}):
            out[f"T{T}_S{S}"] = case(T, S)
    out["all_invalid_8192"] = case(8192, 64, invalid=True)
    out["empty_segments_8192"] = case(8192, 64, segs=[0, 5, 63])
    out["zero_denominators_8192"] = case(8192, 64, zero_denoms=True)
    return out


def phase_vtime_edge(device) -> float:
    """K8 vtime on its edge inputs: two runs equal each other and the
    plain version, exactly.  Returns the max abs err."""
    from kube_batch_tpu_torch.kernels import lex_rank as k8

    err = 0.0
    for name, args in vtime_edge_inputs(device).items():
        a, b, want = k8.vtime(*args), k8.vtime(*args), k8.vtime_plain(*args)
        err = max(err, require_equal(f"vtime edge {name}", [(a, want), (b, want)]))
        T, R = args[2].shape
        log(json.dumps({"phase": "vtime-edge", "case": name, "rows": T, "segments": args[6],
                        "one_launch": T <= k8.CTA_MAX_T,
                        "valid_rows": int(args[3].sum()),
                        "column_total_max": float(args[2].double().sum(0).max()),
                        "big_vtime_rows": int((a >= k8.BIG_VTIME).sum()),
                        "zero_rows": int((a == 0).sum())}))
    return err


def k2_words_inputs(device, T: int = 4096, N: int = 1024, K: int = 40, K2: int = 36,
                    seed: int = 0):
    """(propose_best's arguments with dyn None, the affinity fields and the
    resident tables of both resident sets, as the plain K11 builds them):
    seeded requests against node capacity, a feasibility mask of about
    70 %, both score terms and a quantum, and affinity terms as
    tests/test_torch_affinity.py makes them (padded columns, a dead
    domain)."""
    import numpy as np
    import torch

    from kube_batch_tpu_torch.kernels import affinity as k10
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
    tw = k10.task_words_plain(*fields[:5])
    resident = k11.resident_words_plain(tw, on(node), on(state), task_mask, fields[7],
                                        fields[5], fields[6], N, D, K, K2, True)
    return args, fields, resident


def phase_words_edge(device) -> dict:
    """K10's affinity_task_words and affinity_words, K11 and K2's words
    form on seeded inputs: the task words and the words equal the plain
    versions'; K11's tables (both resident sets, and the future set
    alone) equal its plain version's; K2's two passes given the words
    equal their plain versions and K2 given the mask K10 makes from the
    same tables; and, on a world with no terms (every word 0), K2 given
    the words equals K2 given no predicate.  Returns {name:
    max_abs_err}."""
    import torch

    from kube_batch_tpu_torch.kernels import affinity as k10
    from kube_batch_tpu_torch.kernels import propose as k2
    from kube_batch_tpu_torch.kernels import resident as k11

    args, fields, resident = k2_words_inputs(device)
    errs = {"affinity_words": 0.0, "affinity_task_words": 0.0, "resident_words": 0.0,
            "propose_best": 0.0, "propose_pick": 0.0}

    def words_equal(name, got, want):
        return require_equal(name, [(got.node_words, want.node_words),
                                    (got.task_words, want.task_words),
                                    (got.thr, want.thr)])

    tw = k10.affinity_task_words(*fields[:5])
    errs["affinity_task_words"] = require_equal(
        "affinity_task_words edge", [(tw, k10.task_words_plain(*fields[:5]))])
    words_args = (tw, fields[5], fields[6], fields[7], resident)
    built = k10.affinity_words(*words_args)
    want = k10.affinity_words_plain(*words_args)
    errs["affinity_words"] = words_equal("affinity_words edge", built, want)
    mask = k10.affinity_mask(*fields, resident)
    require_equal("affinity words against mask", [(k10.affinity_cells_plain(want), mask)])
    no_terms = [torch.zeros_like(x) for x in fields[:5]] + fields[5:]
    empty_tw = k10.affinity_task_words(*no_terms[:5])
    if bool(empty_tw.any()):
        fail("affinity_words edge: a world with no terms has task words")
    empty = k10.affinity_words(empty_tw, *words_args[1:])
    # K11 on the same rows with the card's kernel: both resident sets, and
    # the future set alone
    T, N = tw.shape[0], resident.Hb.shape[0]
    D, K, K2 = resident.Hd.shape[0], resident.K, resident.K2
    gen = torch.Generator().manual_seed(1)
    state = torch.randint(0, 10, (T,), generator=gen, dtype=torch.int32).to(device)
    node = torch.randint(-1, N - 4, (T,), generator=gen, dtype=torch.int32).to(device)
    mask_t = torch.arange(T, device=device) < T - 8
    for now in (True, False):
        k11_args = (tw, node, state, mask_t, fields[7], fields[5], fields[6], N, D, K, K2,
                    now)
        errs["resident_words"] = max(errs["resident_words"], require_equal(
            f"resident_words edge with_now={now}", resident_pairs(
                k11.resident_words(*k11_args), k11.resident_words_plain(*k11_args))))

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
        prop = k2.propose_pick(*with_scratch(pa))
        errs["propose_pick"] = max(errs["propose_pick"], require_equal(
            f"propose_pick edge {name}", [
                (prop, k2.propose_pick_plain(*pa)),
                (prop, k2.propose_pick(*with_scratch(pick_args(ref, best))))]))
        log(json.dumps({"phase": "k2-words-edge", "case": name,
                        "tasks": a[2].shape[0], "nodes": a[3].shape[0],
                        "active": int(best[2].sum()),
                        "vetoed_cells": int((~mask).sum()) if name == "words" else 0}))
    return errs


def k2_edge_cases(device):
    """name → K2 propose_best's arguments on edge inputs: no eligible row;
    one eligible row, at T − 1; about 1 % of the rows eligible (the node
    range split across blocks); T and N that are not multiples of the
    row group (32) or the node tile (256) and N not a multiple of 16 (no
    wide loads); every node alike (ties across every node tile); the
    quantum on and off; the mask, a dynamic mask with two extra score
    terms, and the affinity words with W = 1, 2 and 8 words a
    vocabulary."""
    import numpy as np
    import torch

    from kube_batch_tpu_torch.kernels import affinity as k10

    rng = np.random.default_rng(7)
    cases = {}
    for T, N, K, K2 in ((1000, 1000, 32, 20), (4096, 1024, 40, 36), (777, 301, 250, 200)):
        args, fields, resident = k2_words_inputs(device, T=T, N=N, K=K, K2=K2,
                                                 seed=T + N)
        tw = k10.affinity_task_words(*fields[:5])
        words = k10.affinity_words(tw, fields[5], fields[6], fields[7], resident)
        W = max(k10.words(K), k10.words(K2))
        elig = {"none": np.zeros(T, bool), "last_row": np.arange(T) == T - 1,
                "sparse": rng.random(T) < 0.01, "most": rng.random(T) < 0.8}
        for ename, e in elig.items():
            for quantum in (0.5, 0.0):
                a = list(args)
                a[6] = torch.from_numpy(e).to(device)
                a[11] = quantum
                cases[f"mask_T{T}_N{N}_{ename}_q{quantum}"] = a
                w = list(a)
                w[1] = words
                cases[f"words_W{W}_T{T}_N{N}_{ename}_q{quantum}"] = w
        d = list(args)
        d[1] = torch.from_numpy(rng.random((T, N)) < 0.6).to(device)
        d[10] = [torch.from_numpy(rng.integers(-3, 4, (T, N)).astype(np.float32)).to(device)
                 for _ in range(2)]
        d[6] = torch.from_numpy(rng.random(T) < 0.05).to(device)
        cases[f"dyn_extras_T{T}_N{N}"] = d
        # every node alike: each feasible row ties across every node tile
        same = list(args)
        cap = torch.full_like(args[8], 8000.0)
        same[3] = same[7] = torch.full_like(args[7], 4000.0)
        same[8] = cap
        same[0] = torch.ones_like(args[0])
        same[5] = torch.ones_like(args[5])
        same[6] = torch.from_numpy(rng.random(T) < 0.02).to(device)
        cases[f"all_alike_T{T}_N{N}"] = same
    # pass 2's chunk summaries at the main path's node count, 1 %, 7.5 %
    # and every row eligible, both forms
    T, N = 2048, 8192
    args, fields, resident = k2_words_inputs(device, T=T, N=N, K=40, K2=36, seed=T + N)
    tw = k10.affinity_task_words(*fields[:5])
    words = k10.affinity_words(tw, fields[5], fields[6], fields[7], resident)
    for ename, share in (("1pct", 0.01), ("7.5pct", 0.075), ("all", 1.0)):
        for quantum in (0.5, 0.0):
            a = list(args)
            a[6] = torch.from_numpy(rng.random(T) < share).to(device)
            a[11] = quantum
            cases[f"mask_T{T}_N{N}_{ename}_q{quantum}"] = a
            w = list(a)
            w[1] = words
            cases[f"words_T{T}_N{N}_{ename}_q{quantum}"] = w
    return cases


def phase_k2_edge(device) -> dict:
    """K2's two passes on `k2_edge_cases`: pass 1 equal to its plain
    version and run twice alike, pass 2 (from pass 1's chunk summaries)
    equal to its plain version given pass 1's answer, with k = row index
    mod ties and with k = ties - 1 (the last tie), exactly.  Returns
    {name: max_abs_err}."""
    import torch

    from kube_batch_tpu_torch.kernels import propose as k2

    errs = {"propose_best": 0.0, "propose_pick": 0.0}
    for name, a in k2_edge_cases(device).items():
        T, N = a[0].shape
        scratch = k2.best_scratch(T, N, device)
        again = k2.propose_best(*a)
        best = k2.propose_best(*a, scratch)
        want = k2.propose_best_plain(*a)
        errs["propose_best"] = max(errs["propose_best"], require_equal(
            f"propose_best edge {name}", list(zip(best, want)) + list(zip(again, want))))
        b, ties, active = best
        rows = torch.arange(ties.numel(), device=device, dtype=torch.int32)
        for kname, k in (("row_mod_ties", torch.remainder(rows, torch.clamp(ties, min=1))),
                         ("last_tie", torch.clamp(ties - 1, min=0))):
            pa = list(a) + [b, active, k]
            errs["propose_pick"] = max(errs["propose_pick"], require_equal(
                f"propose_pick edge {name} {kname}",
                [(k2.propose_pick(*pa, scratch), k2.propose_pick_plain(*pa))]))
        eligible = int(a[6].sum())
        log(json.dumps({"phase": "k2-edge", "case": name, "tasks": T, "nodes": N,
                        "eligible": eligible, "eligible_share": round(eligible / T, 6),
                        "active": int(active.sum()), "max_ties": int(ties.max()),
                        "multi_tie_rows": int((active & (ties > 1)).sum())}))
    return errs


def k5_edge_inputs(device, T: int, N: int, case: str, seed: int = 0, R: int = 4):
    """K5 victim_prefix's arguments on seeded inputs of one edge case:
    `random` (with a dynamic row), `equal_ranks` (ranks drawn from T / 50
    values: the sort breaks ties by row), `tied_k` (every node alike, so
    the lowest allowed index wins among equal k), `no_feasible` (a
    request no prefix covers: out = [0, 0, ...]), `fits_no_victim`
    (FutureIdle fits the preemptor on some nodes: k = 0), `long_run` (one
    node holds 1,000 victims: past LONG_RUN, the block takes the radix
    route) and `no_victims`."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + T + N)
    node = rng.integers(-1, N, T).astype(np.int32)
    req = rng.integers(0, 5, (T, R)).astype(np.float32) * 1000
    future = rng.integers(-6, 3, (N, R)).astype(np.float32) * 1000
    rank = rng.permutation(T).astype(np.int32)
    victims = (rng.random(T) < 0.6) & (node >= 0)
    pred = rng.random((T, N)) < 0.9
    p = int(rng.integers(0, T))
    req[p] = rng.integers(1, 6, R) * 1000
    dyn = rng.random(N) < 0.9 if case == "random" else None
    if case == "equal_ranks":
        rank = rng.integers(0, max(1, T // 50), T).astype(np.int32)
    elif case == "tied_k":
        node = (np.arange(T) % max(1, min(N, T // 8))).astype(np.int32)
        victims = node >= 0
        req[:] = 1000.0
        future[:] = -1000.0
    elif case == "no_feasible":
        req[p] = 1e9
    elif case == "fits_no_victim":
        future[rng.random(N) < 0.1] = 1e6
    elif case == "long_run":
        node[rng.choice(T, min(T, 1000), replace=False)] = N // 2
        victims = node >= 0
    elif case == "no_victims":
        victims[:] = False
    victims[p] = False   # the preemptor is pending, never its own victim

    def dev(x):
        return torch.from_numpy(x).to(device)

    return (dev(victims), dev(node), dev(rank), dev(req), dev(future),
            dev(np.full(R, 1e-3, np.float32)), torch.tensor(p, device=device),
            dev(req), dev(pred), dev(rng.random(N) < 0.95), dev(rng.random(N) < 0.05),
            None if dyn is None else dev(dyn))


K5_EDGE_CASES = ("random", "equal_ranks", "tied_k", "no_feasible", "fits_no_victim",
                 "long_run", "no_victims")


def phase_k5_edge(device) -> float:
    """K5 on `k5_edge_inputs` at the preempt path's width (T = 8,192, N =
    512), at the main path's node count (N = 8,192) and above the
    one-block limit (T = 20,000: K8's sort, then the walk): the kernel on
    its own route and on the radix route, exactly equal to the plain
    version.  Returns the largest error."""
    from kube_batch_tpu_torch.kernels import victim_prefix as k5

    err = 0.0
    for T, N in ((8192, 512), (4096, 8192), (20000, 512), (1, 3)):
        for case in K5_EDGE_CASES:
            args = k5_edge_inputs(device, T, N, case)
            want = k5.victim_prefix_plain(*args)
            got = k5.victim_prefix(*args)
            err = max(err, require_equal(f"victim_prefix edge {case} T{T} N{N}", [
                (got, want), (k5.victim_prefix(*args, route=k5.ROUTE_RADIX), want)]))
            out = got[N:].tolist()
            log(json.dumps({"phase": "k5-edge", "case": case, "tasks": T, "nodes": N,
                            "one_launch": T <= k5.CTA_MAX_T, **victim_prefix_work(args),
                            "n_best": out[0], "feasible": out[1], "k_best": int(got[out[0]]),
                            "fits_no_victim": out[4]}))
    return err


K3_EDGE_T = (1, 33, 16384, 16385, 65536, 131072, 262144)
K3_EDGE_CASES = ("one_node", "distinct", "tied", "serialize", "one_per_node")


def k3_edge_inputs(device, T: int, case: str, seed: int = 0, R: int = 4):
    """One resolve call's arguments (prop_node, active, rank, task_req,
    avail, eps, one_per_node, serialize_mask, cancelled): every proposer on
    one node, every proposer on a node of its own (N = T, up to 65,536
    nodes; the other rows inactive), or half the proposers on node 0 and
    the rest spread, with ranks tied in 64 values, a serialize mask or
    one_per_node.  Integer-valued requests (some below
    eps); node 0's capacity takes about a third of its run."""
    import torch

    g = torch.Generator().manual_seed(seed * 100003 + T)
    N = min(T, 65536) if case == "distinct" else (8192 if T >= 16384 else 64)
    active = torch.rand(T, generator=g) < 0.9
    if case == "one_node":
        prop = torch.zeros(T, dtype=torch.int32)
    elif case == "distinct":
        n_act = min(T, N)
        active = torch.zeros(T, dtype=torch.bool)
        rows = torch.randperm(T, generator=g)[:n_act]
        active[rows] = True
        prop = torch.zeros(T, dtype=torch.int32)
        prop[rows] = torch.randperm(N, generator=g)[:n_act].int()
    else:
        prop = torch.randint(0, N, (T,), generator=g, dtype=torch.int32)
        prop[torch.rand(T, generator=g) < 0.5] = 0
    prop[~active] = torch.randint(0, 4 * N, (int((~active).sum()),), generator=g,
                                  dtype=torch.int32)      # never read
    rank = (torch.randint(0, min(64, T), (T,), generator=g) if case == "tied"
            else torch.randperm(T, generator=g)).int()
    scale = torch.tensor([500.0, float(1 << 30), 1.0, 1.0])[:R]
    req = torch.randint(1, 9, (T, R), generator=g).float() * scale
    req[torch.rand(T, R, generator=g) < 0.1] = 0.0
    avail = torch.randint(4, 40, (N, R), generator=g).float() * scale
    on0 = int((active & (prop == 0)).sum())
    avail[0] = scale * max(4, int(on0 * 4.5 / 3))
    eps = torch.full((R,), 0.5)
    ser = torch.rand(T, generator=g) < 0.3 if case == "serialize" else None
    cancelled = torch.zeros(3, dtype=torch.int64)
    args = (prop, active, rank, req, avail, eps, case == "one_per_node", ser, cancelled)
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)


def phase_k3_edge(device) -> float:
    """K3 resolve on `k3_edge_inputs` at every T of K3_EDGE_T and case:
    kept, perm, s_node and the cancelled count exactly equal to the plain
    version, on the blocks and the storage the kernel chooses (ranks that
    are a permutation go by the rank-order scatter, tied ones by the sort
    by rank).  Returns the largest error."""
    from kube_batch_tpu_torch.kernels import resolve as k3

    err = 0.0
    for T in K3_EDGE_T:
        blocks, scratch = k3.plan(T) if device.type == "cuda" else (None, None)
        for case in K3_EDGE_CASES:
            args = k3_edge_inputs(device, T, case)
            got, want, counts = resolve_pair(args)
            err = max(err, require_equal(f"resolve edge {case} T{T}", list(zip(got, want))))
            log(json.dumps({"phase": "k3-edge", "case": case, "tasks": T,
                            "nodes": args[4].shape[0], "blocks": blocks,
                            "scratch_bytes": scratch, **counts}))
    return err


def k10_row_inputs(device, T: int, N: int, K: int, K2: int, seed: int = 0,
                   bootstrap: bool = False):
    """(fields, task words, K11's future tables built by the wrapper, p):
    the affinity terms of `k2_words_inputs` (K2 = 0: no topology terms)
    and a pending preemptor p whose terms are chosen from the tables so
    that its row keeps some nodes and vetoes others: a required label
    resident on some nodes, an anti term on another, one own label that
    some node's residents name as an anti term (none at domain scope),
    and a topology term present in most domains.  `bootstrap`: p's
    required terms (node and topology) name a label no resident carries
    and p carries itself, so the waiver alone meets them."""
    import torch

    from kube_batch_tpu_torch.kernels import affinity as k10
    from kube_batch_tpu_torch.kernels import resident as k11

    _args, fields, _both = k2_words_inputs(device, T, N, K, max(K2, 1), seed)
    fields = [f.clone() for f in fields]
    if not K2:
        fields[3], fields[4] = fields[3][:, :0].contiguous(), fields[4][:, :0].contiguous()
        fields[5], fields[6] = fields[5][:0].contiguous(), fields[6][:0].contiguous()
    aff, anti, labels, aff_topo, anti_topo, _term_key, term_label = fields[:7]
    g = torch.Generator().manual_seed(seed * 7 + T)
    state = torch.randint(0, 10, (T,), generator=g, dtype=torch.int32).to(device)
    node = torch.randint(-1, N - 4, (T,), generator=g, dtype=torch.int32).to(device)
    mask = torch.arange(T, device=device) < T - 8
    p = int(torch.randint(0, T - 8, (1,), generator=g))
    state[p], node[p] = 0, -1                   # pending: not a resident
    boot = K - 1                                # a padded label column: no resident
    if bootstrap and K2:
        term_label[0] = boot
    D = 16
    resident = k11.resident_words(k10.task_words_plain(*fields[:5]).contiguous(), node,
                                  state, mask, fields[7], fields[5], fields[6], N, D, K,
                                  K2, False)
    Hb, Ab, _Hd, Ad = resident.tables()
    for x in (aff, anti, labels, aff_topo, anti_topo):
        x[p] = 0.0
    held = Hb.sum(dim=0)
    anti[p, int((held * (held < held.max())).argmax())] = 1.0   # the second most held
    named = Ab.any(dim=0) & ~(Ad.any(dim=0) if Ad is not None else False)
    if bool(named.any()):
        labels[p, int(torch.nonzero(named)[0, 0])] = 1.0
    if bootstrap:
        labels[p, boot] = aff[p, boot] = 1.0
        if K2:
            aff_topo[p, 0] = 1.0
    else:
        aff[p, int(held.argmax())] = 1.0        # the most held label
        if K2:
            aff_topo[p, int(torch.randint(0, K2, (1,), generator=g))] = 1.0
    tw = k10.task_words_plain(*fields[:5]).contiguous()
    return fields, tw, resident, torch.tensor(p, dtype=torch.int64, device=device)


K10_ROW_EDGE = (
    # (case, T, N, K, K2, bootstrap)
    ("topology", 4096, 1024, 40, 36, False),
    ("no_topology", 4096, 1024, 40, 0, False),
    ("widest", 4096, 1024, 256, 256, False),
    ("walk_route", 20000, 512, 40, 36, False),
    ("bootstrap_only", 4096, 1024, 40, 36, True),
)


def phase_k10_row_edge(device) -> dict:
    """K10's row operand on `k10_row_inputs` for every case of
    K10_ROW_EDGE (topology terms on and off, K = K2 = 256, K5's walk route
    past 16,384 rows, a preemptor whose required terms only the bootstrap
    waiver meets): the row form, and the cell that K6's preempt_continue
    tests in its launch at a node that is not viable and at one that is,
    exactly equal to the plain version's row;
    and K5 given the operand (and with a dynamic mask ANDed in, in the
    first case) exactly equal to K5's plain version fed the plain row, on
    its own route and the radix route.  Timed (seconds logged).  Returns
    {name: max_abs_err}."""
    import torch

    from kube_batch_tpu_torch.kernels import affinity as k10
    from kube_batch_tpu_torch.kernels import preempt_scan as k6
    from kube_batch_tpu_torch.kernels import victim_prefix as k5

    t0 = time.perf_counter()
    errs = {"affinity_row": 0.0, "victim_prefix": 0.0}
    for case, T, N, K, K2, boot in K10_ROW_EDGE:
        fields, tw, resident, p = k10_row_inputs(device, T, N, K, K2, bootstrap=boot)
        want = k10.affinity_row_plain(*fields, resident, p)
        if not 0 < int(want.sum()) < N:
            fail(f"k10-row-edge {case}: the row keeps {int(want.sum())} of {N} nodes")
        got = k10.affinity_row(*fields, resident, p, tw)
        errs["affinity_row"] = max(errs["affinity_row"], require_equal(
            f"affinity_row edge {case}", [(got, want)]))
        row = k10.AffinityRow(tuple(fields), tw, resident, p)
        # the row's cell as K6 tests it in a continuing step's launch
        k6_args = k6_continue_inputs(device, T, N, "random")
        k6_args[6] = p
        for viable in (False, True):
            k6_args[7] = torch.nonzero(want == viable)[0, 0].clone()
            got = k6.preempt_continue(*k6_args, row)[3].clone()
            require_equal(f"preempt_continue row cell edge {case} viable={viable}",
                          [(got, want[k6_args[7]])])
        k5_args = list(k5_edge_inputs(device, T, N, "random"))
        dyn = k5_args[11]
        k5_args[6] = p
        for label, operand in (("row", row), ("row_and_mask", row.and_mask(dyn))):
            if label == "row_and_mask" and case != "topology":
                continue
            k5_args[11] = operand
            plain = k5.victim_prefix_plain(*k5_args)
            errs["victim_prefix"] = max(errs["victim_prefix"], require_equal(
                f"victim_prefix edge {case} {label}", [
                    (k5.victim_prefix(*k5_args), plain),
                    (k5.victim_prefix(*k5_args, route=k5.ROUTE_RADIX), plain)]))
            k5_args[11] = None
            alone = k5.victim_prefix_plain(*k5_args)
            log(json.dumps({"phase": "k10-row-edge", "case": case, "form": label,
                            "tasks": T, "nodes": N, "K": K, "K2": K2,
                            "one_launch": T <= k5.CTA_MAX_T,
                            "row_keeps": int(want.sum()),
                            "n_best": int(plain[N]), "feasible": int(plain[N + 1]),
                            "choice_moved_by_row": int(plain[N] != alone[N]
                                                       or plain[N + 1] != alone[N + 1])}))
    if device.type == "cuda":
        torch.cuda.synchronize()
    log(json.dumps({"phase": "k10-row-edge-done",
                    "seconds": round(time.perf_counter() - t0, 3)}))
    return errs


K3_APPLY_EDGE = (
    # (case, T, N, R): one node holding every row, rows spread over the
    # nodes, every R, an empty accept set
    ("one_node", 65536, 8192, 4), ("spread", 65536, 8192, 4),
    ("spread", 262144, 8192, 4), ("r1", 4096, 512, 1), ("r2", 4096, 512, 2),
    ("r3", 4096, 512, 3), ("r5", 4096, 512, 5), ("r6", 4096, 512, 6),
    ("r7", 4096, 512, 7), ("r8", 4096, 512, 8), ("empty", 65536, 8192, 4),
    ("one_row", 1, 4, 4),
)


def k3_apply_inputs(device, case: str, T: int, N: int, R: int, seed: int = 0):
    """kb_apply's arguments (perm, s_node, accept, task_req, node_future,
    node_idle, use_future, new_status, task_state, task_node) with
    use_future False: rows in (node, row) order with a tenth inactive
    (node N, last), integer-valued requests, about two thirds accepted
    (none for `empty`); every active row on node 0 for `one_node`."""
    import torch

    g = torch.Generator().manual_seed(seed * 1009 + T + R)
    perm = torch.randperm(T, generator=g)
    if case == "one_node":
        node = torch.zeros(T, dtype=torch.int64)
    else:
        node = torch.randint(0, N, (T,), generator=g)
    node[torch.rand(T, generator=g) < 0.1] = N
    s_node = torch.sort(node).values
    accept = (torch.rand(T, generator=g) < 0.67) | (T == 1)
    if case == "empty":
        accept[:] = False
    scale = torch.tensor([500.0, float(1 << 20), 1.0, 1.0, 8.0, 1.0, 2.0, 1.0])[:R]
    req = torch.randint(0, 9, (T, R), generator=g).float() * scale
    future = torch.randint(-50, 400, (N, R), generator=g).float() * scale
    idle = torch.randint(-50, 400, (N, R), generator=g).float() * scale
    state = torch.randint(0, 6, (T,), generator=g, dtype=torch.int32)
    tnode = torch.randint(-1, N, (T,), generator=g, dtype=torch.int32)
    args = (perm, s_node, accept, req, future, idle, False, 3, state, tnode)
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)


def apply_pair(args) -> float:
    """K3 apply and its plain version on fresh copies of what they write
    (both use_future values): exactly equal.  Returns the error."""
    from kube_batch_tpu_torch.kernels import resolve as k3

    err = 0.0
    for use_future in (False, True):
        a = list(args)
        a[6] = use_future
        a_k, a_p = _fresh_apply_args(a), _fresh_apply_args(a)
        k3.apply(*a_k)
        k3.apply_plain(*a_p)
        err = max(err, require_equal(f"apply use_future={use_future}",
                                     [(a_k[i], a_p[i]) for i in (4, 5, 8, 9)]))
    return err


def phase_k3_apply_edge(device) -> dict:
    """K3 apply on K3_APPLY_EDGE's inputs (one node holding all 65,536
    rows, rows spread at 65,536 and 262,144, R = 1 to 8, an empty accept
    set, one row), both use_future values, and on resolve's own output at
    1,048,577 rows (resolve exact there too): equal to the plain version.
    The one-node and spread cases at 65,536 rows are timed.  Timed
    (seconds logged).  Returns {name: max_abs_err}."""
    import torch

    from kube_batch_tpu_torch.kernels import resolve as k3

    t0 = time.perf_counter()
    errs = {"apply": 0.0, "resolve": 0.0}
    for case, T, N, R in K3_APPLY_EDGE:
        args = k3_apply_inputs(device, case, T, N, R)
        errs["apply"] = max(errs["apply"], apply_pair(args))
        line = {"phase": "k3-apply-edge", "case": case, "tasks": T, "nodes": N, "R": R,
                "accepted": int(args[2].sum()),
                "longest_run": int(torch.bincount(args[1][args[1] < N]).max())
                if bool((args[1] < N).any()) else 0}
        if device.type == "cuda" and T == 65536 and case != "empty":
            ka = _fresh_apply_args(args)
            line["ms"] = round(time_ms(lambda: k3.apply(*ka)), 4)
        log(json.dumps(line))
    T = 1048577
    for case in ("one_node", "serialize"):
        rargs = k3_edge_inputs(device, T, case)
        got, want, counts = resolve_pair(rargs)
        errs["resolve"] = max(errs["resolve"], require_equal(
            f"resolve edge {case} T{T}", list(zip(got, want))))
        kept, perm, s_node = want[:3]
        N, R = rargs[4].shape
        g = torch.Generator().manual_seed(T)
        aargs = (perm, s_node, kept, rargs[3], rargs[4].clone(), rargs[4].clone(), False, 3,
                 torch.zeros(T, dtype=torch.int32).to(device),
                 torch.randint(-1, N, (T,), generator=g, dtype=torch.int32).to(device))
        errs["apply"] = max(errs["apply"], apply_pair(aargs))
        log(json.dumps({"phase": "k3-apply-edge", "case": f"resolve_{case}", "tasks": T,
                        "nodes": N, "blocks": k3.plan(T)[0] if device.type == "cuda"
                        else None, **counts}))
    if device.type == "cuda":
        torch.cuda.synchronize()
    log(json.dumps({"phase": "k3-apply-edge-done",
                    "seconds": round(time.perf_counter() - t0, 3)}))
    return errs


K1_EDGE_WIDTHS = (1, 31, 32, 33, 100)
K1_EDGE_NODES = (1000, 8191, 8192)


K6_CONTINUE_EDGE = (
    # (case, T, N): ranks a permutation of [0, T) unless tied; the plan's
    # node holding no victim, or every victim; T off a multiple of 4 (the
    # victims read a byte at a time); one row; the main path's width
    ("random", 8192, 512), ("tied_ranks", 8192, 512), ("no_victim_on_n", 8192, 512),
    ("every_victim_on_n", 8192, 512), ("odd_rows", 8191, 500), ("one_row", 1, 4),
    ("wide", 65536, 8192),
)


def k6_continue_inputs(device, T: int, N: int, case: str, seed: int = 0, R: int = 4):
    """preempt_continue's operands (rank, victims, task_node, task_req,
    future, eps, p, n) for one case of K6_CONTINUE_EDGE: about a third of
    the rows candidate victims on random nodes (or none), integer
    requests and FutureIdle, p and n int64 device scalars."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed * 131 + T)

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    rank = (rng.integers(0, 6, T) if case == "tied_ranks" else rng.permutation(T))
    victims = rng.random(T) < 0.3
    task_node = rng.integers(-1, N, T)
    n, p = int(rng.integers(0, N)), int(rng.integers(0, T))
    if case == "no_victim_on_n":
        victims &= task_node != n
    elif case == "every_victim_on_n":
        task_node[victims] = n
    task_req = rng.integers(0, 4, (T, R)).astype(np.float32) * 500
    future = rng.integers(-1, 5, (N, R)).astype(np.float32) * 500
    return [on(rank.astype(np.int32)), on(victims), on(task_node.astype(np.int32)),
            on(task_req), on(future), on(np.full(R, 1e-3, np.float32)),
            torch.tensor(p, dtype=torch.int64, device=device),
            torch.tensor(n, dtype=torch.int64, device=device)]


def phase_k6_continue_edge(device) -> float:
    """K6's preempt_continue on `k6_continue_inputs` for every case of
    K6_CONTINUE_EDGE, without a row and with a bool[N] row; and with the
    inter-pod affinity row operand of `k10_row_inputs` (and with it ANDed
    with a mask) at a node where the row holds and at one where it fails
    (viable false).  Every call shares one ContinueBuffer, so each runs
    on the scratch words the previous call's last block cleared; each
    exactly equal to the plain version.  Times T = 8,192 and 65,536
    (seconds and times logged).  Returns the max abs err."""
    import torch

    from kube_batch_tpu_torch.kernels import affinity as k10
    from kube_batch_tpu_torch.kernels import preempt_scan as k6

    t0 = time.perf_counter()
    buf = k6.ContinueBuffer(device) if device.type == "cuda" else None
    err, seen = 0.0, {"victim_found": 0, "no_victim": 0, "not_viable": 0, "fits_now": 0}

    def check(label, args):
        nonlocal err
        got = [x.clone() for x in k6.preempt_continue(*args, buf)]
        err = max(err, require_equal(f"preempt_continue edge {label}",
                                     list(zip(got, k6.preempt_continue_plain(*args)))))
        _v, any_vic, fit_now, viable = (int(x) for x in got)
        seen["victim_found" if any_vic else "no_victim"] += 1
        seen["not_viable"] += 1 - viable
        seen["fits_now"] += fit_now
        return got

    times = {}
    for case, T, N in K6_CONTINUE_EDGE:
        args = k6_continue_inputs(device, T, N, case)
        row = torch.rand(N, generator=torch.Generator().manual_seed(T)).lt(0.5).to(device)
        got = check(case, args + [None])
        check(f"{case} bool row", args + [row])
        if case == "no_victim_on_n" and int(got[1]):
            fail("preempt_continue edge: a victim on the node that holds none")
        if case in ("random", "wide") and device.type == "cuda":
            times[T] = time_ms(lambda: k6.preempt_continue(*args, None, buf))
    fields, tw, resident, p = k10_row_inputs(device, 4096, 1024, 40, 36)
    want = k10.affinity_row_plain(*fields, resident, p)
    args = k6_continue_inputs(device, 4096, 1024, "random")
    args[6] = p
    op = k10.AffinityRow(tuple(fields), tw, resident, p)
    mask = torch.ones(1024, dtype=torch.bool, device=device)
    mask[::3] = False
    for viable in (False, True):
        for n in torch.nonzero(want == viable)[:3, 0]:
            args[7] = n.clone()
            check(f"row viable={viable}", args + [op])
            check(f"row and mask viable={viable}", args + [op.and_mask(mask)])
    for key, v in seen.items():
        if v <= 0:
            fail(f"preempt_continue edge: no case with {key}")
    if device.type == "cuda":
        torch.cuda.synchronize()
    log(json.dumps({"phase": "k6-continue-edge", **seen,
                    **{f"ms_{T}_rows": round(ms, 4) for T, ms in times.items()},
                    "seconds": round(time.perf_counter() - t0, 3)}))
    return err


K4_EDGE = (
    # (case, T, N, R, request classes, affinity words (K, K2) or None): N
    # off a multiple of 16 and of 32, T off a multiple of 32, R = 1 and 8,
    # one class for every row and one a row, the words at W = 1, 2 and 8
    ("n500", 1000, 500, 4, "few", None), ("n4999", 4099, 4999, 4, "few", None),
    ("r1", 4096, 1024, 1, "few", None), ("r8", 4096, 1024, 8, "few", None),
    ("one_class", 4096, 8192, 4, "one", None), ("class_a_row", 4096, 1000, 4, "each", None),
    ("words_w1", 4099, 4999, 4, "few", (20, 10)), ("words_w2", 1000, 500, 4, "few", (40, 36)),
    ("words_w8", 2000, 1024, 4, "each", (256, 256)),
)


def k4_edge_inputs(device, T: int, N: int, R: int, classes: str, seed: int = 0):
    """K4's operands (pred, task_req, node_idle, eps, node_ok) and a
    random dynamic mask: requests at, above and below eps (row 5 below
    it on every dim), row 3 all false, a tenth of the nodes not ready;
    `classes` "few" (4 distinct requests), "one" or "each"."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed * 7919 + T + N + R)

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    eps = np.linspace(0.5, 2.0, R).astype(np.float32) * 100
    levels = np.stack([eps * 0.5, eps, eps * 2.0, eps * 4.0], axis=1)

    def draw(n):
        return np.stack([levels[r, rng.integers(0, 4, n)] for r in range(R)],
                        axis=1).astype(np.float32)

    if classes == "one":
        req = np.repeat(draw(1), T, axis=0)
    elif classes == "few":
        req = draw(4)[rng.integers(0, 4, T)]
        req[5] = eps * 0.5
    else:
        req = draw(T) + np.arange(T, dtype=np.float32)[:, None]
    idle = (np.stack([levels[r, rng.integers(0, 4, N)] for r in range(R)], axis=1)
            * rng.choice([0.9, 1.0, 2.0], (N, R))).astype(np.float32)
    pred = rng.random((T, N)) < 0.7
    pred[3] = False
    return ([on(pred), on(req), on(idle), on(eps), on(rng.random(N) < 0.9)],
            on(rng.random((T, N)) < 0.8))


def phase_k4_edge(device) -> float:
    """K4 on `k4_edge_inputs` for every case of K4_EDGE: without a dynamic
    predicate, with a dynamic mask, and, where the case has words, with
    K10's words of seeded affinity terms (`k2_words_inputs`) — equal to
    K4 given K10's mask of the same tables; every form exactly equal to
    the plain version (seconds logged).  Returns the max abs err."""
    from kube_batch_tpu_torch.kernels import affinity as k10
    from kube_batch_tpu_torch.kernels import failure_counts as k4

    t0 = time.perf_counter()
    err = 0.0
    for case, T, N, R, classes, kk in K4_EDGE:
        (pred, *rest), dyn = k4_edge_inputs(device, T, N, R, classes)
        forms = {"none": None, "mask": dyn}
        if kk is not None:
            _args, fields, resident = k2_words_inputs(device, T, N, *kk)
            tw = k10.affinity_task_words(*fields[:5])
            forms["words"] = k10.affinity_words(tw, *fields[5:8], resident)
            forms["words_as_mask"] = k10.affinity_mask(*fields, resident)
        out = {}
        for form, d in forms.items():
            args = (pred, d, *rest)
            out[form] = k4.failure_counts(*args)
            err = max(err, require_equal(f"failure_counts edge {case} {form}",
                                         list(zip(out[form], k4.failure_counts_plain(*args)))))
        if kk is not None:
            require_equal(f"failure_counts edge {case}: words against mask form",
                          list(zip(out["words"], out["words_as_mask"])))
        pf, ins, fe, nodes = out["none"]
        if int(pf[3]) != int(nodes) or (classes != "one" and not (int(fe.sum())
                                                                 and int(ins.sum()))):
            fail(f"failure_counts edge {case}: a trivial case")
        log(json.dumps({"phase": "k4-edge", "case": case, "tasks": T, "nodes": N,
                        "R": R, "classes": classes, "forms": sorted(forms),
                        "rows_insufficient": int((ins > 0).any(dim=1).sum()),
                        "rows_feasible": int((fe > 0).sum())}))
    log(json.dumps({"phase": "k4-edge-done", "seconds": round(time.perf_counter() - t0, 3)}))
    return err


def k1_edge_snap(device, T: int, N: int, width: int, seed: int = 0):
    """The fields K1 reads, every vocabulary `width` columns wide (0/1
    multi-hots), volume pins at nodes 0 and N - 1 and a few others,
    unready and pressured nodes."""
    import types

    import torch

    g = torch.Generator().manual_seed(seed * 7919 + T * 31 + N + width)

    def hot(M, W, p):
        return (torch.rand(M, W, generator=g) < p).float().to(device)

    pins = torch.full((T,), -1, dtype=torch.int32)
    rows = torch.arange(T)
    pins[rows % 7 == 0] = 0
    pins[rows % 11 == 0] = N - 1
    pins[rows % 13 == 0] = torch.randint(0, N, (int((rows % 13 == 0).sum()),),
                                         generator=g, dtype=torch.int32)
    return types.SimpleNamespace(
        task_sel=hot(T, width, min(0.3, 2.0 / width)), node_labels=hot(N, width, 0.7),
        task_tol=hot(T, width, 0.6), node_taints=hot(N, width, min(0.2, 0.5 / width)),
        task_ports=hot(T, width, min(0.2, 1.0 / width)),
        node_ports=hot(N, width, min(0.2, 1.0 / width)),
        node_ready=(torch.rand(N, generator=g) < 0.95).to(device),
        node_pressure=hot(N, 3, 0.05), task_vol_node=pins.to(device),
        task_vol_groups=hot(T, width, min(0.2, 0.5 / width)),
        vol_group_sel=hot(width, width, 0.2),
        num_tasks=T, num_nodes=N, device=torch.device(device))


def k1_hostname_snap(device, T: int, N: int, seed: int = 0):
    """The fields K1 reads for a cluster whose nodes each carry a label of
    their own (kubernetes.io/hostname: label column n on node n, N + 8
    label columns with 8 shared ones): a third of the tasks select one
    node's hostname, a third a shared label, some both; volume groups
    that allow a few hundred hostnames each; 40 taint and 40 port
    columns.  So the selector's used words span the whole vocabulary."""
    import types

    import torch

    g = torch.Generator().manual_seed(seed * 7919 + T * 31 + N)
    L, V, P, G = N + 8, 40, 40, 3

    def hot(M, W, p):
        return (torch.rand(M, W, generator=g) < p).float()

    node_labels = torch.zeros(N, L)
    node_labels[torch.arange(N), torch.arange(N)] = 1.0
    node_labels[:, N:] = hot(N, 8, 0.5)
    rows = torch.arange(T)
    task_sel = torch.zeros(T, L)
    pick = rows % 3 == 0
    task_sel[rows[pick], torch.randint(0, N, (int(pick.sum()),), generator=g)] = 1.0
    shared = (rows % 3 == 1) | (rows % 5 == 0)
    task_sel[rows[shared], N + torch.randint(0, 8, (int(shared.sum()),), generator=g)] = 1.0
    group_sel = torch.zeros(G, L)
    for k in range(G):
        group_sel[k, torch.randint(0, N, (300,), generator=g)] = 1.0
        group_sel[k, N + k] = 1.0
    pins = torch.full((T,), -1, dtype=torch.int32)
    pins[rows % 7 == 0] = 0
    pins[rows % 11 == 0] = N - 1
    fields = dict(
        task_sel=task_sel, node_labels=node_labels, task_tol=hot(T, V, 0.6),
        node_taints=hot(N, V, 0.05), task_ports=hot(T, P, 0.05), node_ports=hot(N, P, 0.05),
        node_ready=torch.rand(N, generator=g) < 0.95, node_pressure=hot(N, 3, 0.05),
        task_vol_node=pins, task_vol_groups=hot(T, G, 0.2), vol_group_sel=group_sel)
    return types.SimpleNamespace(**{k: v.to(device) for k, v in fields.items()},
                                 num_tasks=T, num_nodes=N, device=torch.device(device))


def phase_k1_edge(device) -> float:
    """K1 on `k1_edge_snap` at every width of K1_EDGE_WIDTHS and node
    count of K1_EDGE_NODES (2,049 task rows) with every predicate on and
    with the default flags, on `k1_hostname_snap` at 8,192 and 8,191
    nodes (also against `predicate_matmul`), and every one of the 256
    flag combinations at width 33 and 1,000 nodes: exactly equal to the
    plain version.  Returns the largest error."""
    import itertools

    from kube_batch_tpu_torch.kernels import predicate_mask as k1

    def flags_of(on):
        return k1.PredicateFlags(selector=on[0], taints=on[1], ports=on[2], ready=on[3],
                                 pressure=tuple(on[4:7]), volume=on[7])

    err = 0.0
    for width in K1_EDGE_WIDTHS:
        for N in K1_EDGE_NODES:
            snap = k1_edge_snap(device, 2049, N, width)
            for flags in (flags_of((True,) * 8), k1.PredicateFlags()):
                got = k1.predicate_mask(snap, flags)
                err = max(err, require_equal(f"predicate_mask edge width {width} N{N}",
                                             [(got, k1.predicate_mask_plain(snap, flags))]))
            log(json.dumps({"phase": "k1-edge", "width": width, "nodes": N, "tasks": 2049,
                            "feasible_cells": int(got.sum()),
                            "vetoed_cells": int((~got).sum())}))
    for N in (8192, 8191):
        snap = k1_hostname_snap(device, 2049, N)
        for flags in (flags_of((True,) * 8), k1.PredicateFlags()):
            got = k1.predicate_mask(snap, flags)
            err = max(err, require_equal(
                f"predicate_mask edge hostname N{N}",
                [(got, k1.predicate_mask_plain(snap, flags)),
                 (got, predicate_matmul(snap, flags))]))
        sel_words = int((k1.pack_words(snap.task_sel) != 0).any(dim=0).sum())
        log(json.dumps({"phase": "k1-edge-hostname", "nodes": N, "tasks": 2049,
                        "label_columns": snap.node_labels.shape[1],
                        "used_selector_words": sel_words,
                        "feasible_cells": int(got.sum()), "vetoed_cells": int((~got).sum())}))
    snap = k1_edge_snap(device, 512, 1000, 33)
    vetoed = []
    for on in itertools.product((False, True), repeat=8):
        got = k1.predicate_mask(snap, flags_of(on))
        err = max(err, require_equal(f"predicate_mask edge flags {on}",
                                     [(got, k1.predicate_mask_plain(snap, flags_of(on)))]))
        vetoed.append(int((~got).sum()))
    log(json.dumps({"phase": "k1-edge-flags", "combinations": len(vetoed),
                    "distinct_vetoed_counts": len(set(vetoed))}))
    return err


def fill_world(Q: int, R: int, seed: int = 0):
    """numpy weights f32[Q] (1 to 5), integer requests f32[Q, R],
    capacity f32[R] between 0.4 and 1.2 of the total request, and a mask
    with about one queue in five out: some queues clamp, the rest share."""
    import numpy as np

    rng = np.random.default_rng(seed * 1000 + Q * 7 + R)
    weights = rng.integers(1, 6, Q).astype(np.float32)
    request = (rng.integers(0, 40, (Q, R)) * 1000).astype(np.float32)
    total = (request.sum(axis=0) * rng.uniform(0.4, 1.2, R)).astype(np.float32)
    return weights, request, total, rng.random(Q) < 0.8


def fill_edge_inputs(device, seed: int = 0):
    """name → the water-fill's four arguments: fill-only at Q = 1,024
    and R = 40 (seeded), one queue and one column, 33 queues, R = 40 at
    Q = 3, every queue masked out, no capacity, and 5,000 queues (the
    state past shared memory); fused (RequestRows over 65,536 rows with
    their queue index) at the main path's Q = 3 and R = 4, at Q = 1,024
    and R = 40, at Q = 880 and R = 4 (4 warps whose state, 48,496 bytes,
    fits 48 KB only without the sum's static shared memory, so the plan
    takes 3), at Q = 5,000 over 8,192 rows, and at Q = 2 with R = 8,
    whose long segments run in 64 blocks each."""
    import numpy as np
    import torch

    from kube_batch_tpu_torch.api.snapshot import build_segment_index
    from kube_batch_tpu_torch.kernels import segment_sum as k7

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def plain(Q, R, **change):
        w, req, tot, mask = fill_world(Q, R, seed)
        if "mask" in change:
            mask = np.full(Q, change["mask"])
        if "total" in change:
            tot = np.full(R, change["total"], np.float32)
        return [on(w), on(req), on(tot), on(mask)]

    def fused(T, Q, R):
        rng = np.random.default_rng(seed + T + Q + R)
        w, _, _, mask = fill_world(Q, R, seed)
        values = (rng.integers(0, 64, (T, R)) * 250).astype(np.float32)
        base = rng.integers(-1, Q, T).astype(np.int32)       # -1: padding
        keep = (rng.random(T) < 0.9) & (base >= 0)
        total = values[keep].sum(axis=0) * np.float32(0.7)
        idx = build_segment_index(on(base), Q)
        seg = torch.where(on(keep), idx.base, Q)
        return [on(w), k7.RequestRows(on(values), seg, idx.order, idx.offsets),
                on(total.astype(np.float32)), on(mask)]

    return {
        "q1024_r40": plain(1024, 40), "q1_r1": plain(1, 1), "q33_r4": plain(33, 4),
        "q3_r40": plain(3, 40), "all_masked": plain(64, 4, mask=False),
        "no_capacity": plain(64, 4, total=0.0), "q5000_scratch": plain(5000, 4),
        "fused_main_q3": fused(65536, 3, 4), "fused_q1024_r40": fused(65536, 1024, 40),
        "fused_q880_r4": fused(65536, 880, 4),
        "fused_q5000_scratch": fused(8192, 5000, 4), "fused_long_runs": fused(65536, 2, 8),
    }


def phase_fill_edge(device) -> float:
    """K7's water-fill on `fill_edge_inputs`: two runs bitwise equal,
    exactly equal to the plain version, the iterations the fill took to
    its fixed point logged, the Q = 1,024 / R = 40 case timed."""
    import torch

    from kube_batch_tpu_torch.kernels import segment_sum as k7

    err = 0.0
    for name, args in fill_edge_inputs(device).items():
        a, b = k7.waterfill(*args), k7.waterfill(*args)
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            fail(f"waterfill edge {name}: two runs differ")
        stats = {}
        err = max(err, require_equal(f"waterfill edge {name}",
                                     [(a, k7.waterfill_plain(*args, stats=stats))]))
        Q, R = a.shape
        fused = isinstance(args[1], k7.RequestRows)
        warps = k7.sum_shape(args[1].values.shape[0], Q)[0] // 32 if fused \
            else k7.FILL_WARPS
        static = k7.static_smem(fused)
        W, smem, floats = k7.fill_plan(Q, R, warps, static)
        line = {"phase": "fill-edge", "case": name, "queues": Q, "columns": R,
                "fused": fused, "iterations": stats["iterations"], "warps": W,
                "state": "shared" if smem else "scratch", "smem_bytes": smem,
                "static_smem_bytes": static,
                "queues_clamped": int((a >= fill_request(args)).all(dim=1).sum())}
        if name == "q1024_r40":
            line.update(ms=round(time_ms(lambda: k7.waterfill(*args)), 4),
                        plain_ms=round(time_ms(lambda: k7.waterfill_plain(*args),
                                               warmup=1, runs=3), 4),
                        bound_ms=waterfill_bound(args)[0])
        log(json.dumps(line))
    return err


# ---------------------------------------------------------------------------
# K13 · the pod-affinity score's class table
# ---------------------------------------------------------------------------

K13_CASES = ("affinity_shape", "c_eq_t", "k2_zero", "node_only", "wide", "global_route",
             "global_one_word", "many_keys")
# (K, K2, D, TK) of the cases off the affinity path's (32, 32, 256, 2)
K13_DIMS = {"k2_zero": (32, 0, 256, 2), "wide": (40, 72, 256, 2),
            "global_route": (40, 32, 65536, 2), "global_one_word": (32, 32, 8192, 2),
            "many_keys": (32, 32, 256, 96)}
# the launch each case must take (`kernels/podaff_score.py · plan`): a
# node's words in registers (one word a vocabulary), Hd in shared memory
# (D · words(K) words within 16 KB) or read from global memory, and past
# 48 KB of shared memory (many topology keys' domains)
K13_ROUTES = {"affinity_shape": (1, 1), "c_eq_t": (1, 1), "k2_zero": (1, 0),
              "node_only": (1, 1), "wide": (0, 1), "global_route": (0, 0),
              "global_one_word": (1, 0), "many_keys": (1, 0)}


def k13_edge_inputs(device, case: str, seed: int = 0, T: int = 65536, N: int = 8192,
                    D: int = 256, TK: int = 2):
    """Seeded K13 arguments (classes, Hb, Hd, node_key_domain, term_key,
    term_label, w) at the affinity path's widths: `affinity_shape` 16
    classes of two topology terms (a team's rack and zone preference,
    weights 1.0 and 0.5) and the zero class over T rows (C = 17, K = K2 =
    32); `c_eq_t` every one of the T rows its own class (distinct dyadic
    weights); `k2_zero` no topology-scoped term; `node_only` topology
    terms present but every topology weight 0; `wide` K = 40 and K2 = 72
    (two and three words); `global_route` D = 65,536 domains at K = 40
    (Hd 512 KB) and `global_one_word` D = 8,192 at K = 32 (32 KB), both
    past the shared-memory route; `many_keys` TK = 96 topology keys.
    Every case but `c_eq_t` holds the zero class."""
    import numpy as np
    import torch

    from kube_batch_tpu_torch.kernels import podaff_score as k13
    from kube_batch_tpu_torch.kernels import resident as k11

    rng = np.random.default_rng(seed)
    K, K2, D, TK = K13_DIMS.get(case, (32, 32, D, TK))

    def dyadic(shape, density=0.3):
        w = rng.integers(1, 8, shape).astype(np.float32) * np.float32(0.25)
        return np.where(rng.random(shape) < density, w, np.float32(0)).astype(np.float32)

    if case == "affinity_shape":
        pref = np.zeros((T, K), np.float32)
        topo = np.zeros((T, K2), np.float32)
        team = rng.integers(-1, 16, T)           # -1: no preference
        has = team >= 0
        topo[has, team[has]] = 1.0
        topo[has, 16 + team[has]] = 0.5
    else:
        pref, topo = dyadic((T, K)), dyadic((T, K2))
        if case == "node_only":
            topo[:] = 0
        if case == "c_eq_t":
            for d in range(6):
                pref[:, d] = ((np.arange(T) >> (3 * d)) & 7) * np.float32(0.25)
        else:
            pref[::5] = 0
            topo[::5] = 0
    t = lambda x: torch.from_numpy(x).to(device)   # noqa: E731
    classes = k13.pref_classes(t(pref), t(topo), N)
    Hb = k11.pack(t(rng.random((N, K)) < 0.3))
    Hd = k11.pack(t(rng.random((D, K)) < 0.3))
    nkd = t(rng.integers(0, D, (N, TK)).astype(np.int32))
    term_key = t(rng.integers(0, TK, K2).astype(np.int32))
    term_label = t(rng.integers(0, K, K2).astype(np.int32))
    return classes, Hb, Hd if K2 else None, nkd, term_key, term_label, 0.75


def podaff_pair(args):
    """K13 and its plain version on `args`, each into a table of its own."""
    import dataclasses

    import torch

    from kube_batch_tpu_torch.kernels import podaff_score as k13

    classes, rest = args[0], args[1:]
    ck = dataclasses.replace(classes, out=torch.empty_like(classes.out))
    cp = dataclasses.replace(classes, out=torch.empty_like(classes.out))
    return k13.podaff_score(ck, *rest), k13.podaff_score_plain(cp, *rest)


def podaff_bound(args):
    """K13's least time: the class rows and denominators, K11's node and
    domain words, node_key_domain and the term arrays read once, the
    table written once (bytes); a bit test and an add a nonzero weight
    and node, three operations a cell (operations)."""
    classes, Hb, Hd, nkd, term_key, term_label = args[:6]
    C, K = classes.rows.shape
    K2, N = classes.rows_topo.shape[1], Hb.shape[0]
    n = C * (K + K2) * 4 + C * 4 + Hb.numel() * 4 + C * N * 4
    if K2:
        n += Hd.numel() * 4 + nkd.numel() * 4 + K2 * 8
    nnz = int((classes.rows != 0).sum()) + int((classes.rows_topo != 0).sum())
    return bound(n, 2 * nnz * N + 3 * C * N)


def podaff_library(args, per_task: bool):
    """The function in PyTorch calls, the reference's form: K11's words
    unpacked, two float32 products, the weight totals, the division, × 10
    and × w; over the class rows ([C, N]) or, `per_task`, over every
    task's row ([T, N]: the chain each round ran before K13)."""
    import torch

    from kube_batch_tpu_torch.kernels import affinity as k10
    from kube_batch_tpu_torch.kernels import resident as k11

    classes, Hb, Hd, nkd, term_key, term_label, w = args
    pref, topo = classes.rows, classes.rows_topo
    if per_task:
        idx = classes.cls.long()
        pref, topo = pref[idx], topo[idx]
    K = pref.shape[1]

    def run():
        raw = pref @ k11.unpack(Hb, K).float().T
        total = pref.sum(dim=1)
        if topo.shape[1]:
            present = k10.present_table(nkd, term_key, term_label, k11.unpack(Hd, K))
            raw = raw + topo @ present.T
            total = total + topo.sum(dim=1)
        return raw / torch.clamp(total, min=1e-9)[:, None] * 10.0 * w

    return run


def phase_k13_edge(device) -> float:
    """K13 on `k13_edge_inputs`' cases, exactly equal to the plain version,
    each on its launch route (`K13_ROUTES`; the affinity shape on at
    least as many blocks as the card has SMs); the affinity shape and
    C = T timed."""
    import torch

    from kube_batch_tpu_torch.kernels import podaff_score as k13

    t0, err = time.perf_counter(), 0.0
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for case in K13_CASES:
        args = k13_edge_inputs(device, case)
        classes = args[0]
        T, C = classes.cls.shape[0], classes.C
        if case == "c_eq_t" and C != T:
            fail(f"podaff_score edge {case}: {C} classes for {T} distinct rows")
        if case != "c_eq_t" and bool((classes.rows != 0).any(1).all()):
            fail(f"podaff_score edge {case}: no zero class")
        plan = k13.plan(*args[:4])
        want_route = K13_ROUTES[case]
        if (plan["words_in_registers"], plan["hd_in_shared"]) != want_route:
            fail(f"podaff_score edge {case}: launch {plan}, not the route {want_route}")
        if case == "many_keys" and plan["smem_bytes"] <= 48 * 1024:
            fail(f"podaff_score edge {case}: {plan['smem_bytes']} bytes of shared memory")
        if case == "affinity_shape" and plan["grid_x"] * plan["grid_y"] < sms:
            fail(f"podaff_score edge {case}: {plan} fills fewer blocks than {sms} SMs")
        got, want = podaff_pair(args)
        err = max(err, require_equal(f"podaff_score edge {case}", [(got, want)]))
        line = {"phase": "k13-edge", "case": case, "tasks": T, "classes": C,
                "nodes": got.shape[1], "K": classes.rows.shape[1],
                "K2": classes.rows_topo.shape[1],
                "domains": args[2].shape[0] if args[2] is not None else 0,
                "topology_keys": args[3].shape[1], "plan": plan,
                "nonzero_cells": int((got != 0).sum()), "max_abs_err": err}
        if case in ("affinity_shape", "c_eq_t"):
            line["ms"] = round(time_ms(lambda: k13.podaff_score(*args)), 4)
            line["bound_ms"] = round(podaff_bound(args)[0], 6)
        log(json.dumps(line))
        del got, want, args, classes
    if device.type == "cuda":
        torch.cuda.synchronize()
    log(json.dumps({"phase": "k13-edge-done", "seconds": round(time.perf_counter() - t0, 2)}))
    return err


def k9_edge_inputs(device, T: int, rows_per_field: int, seed: int = 0):
    """(device buffers, host arrays, padded rows) of one K9 call over
    rows of 1, 3, 12, 16 and 4 bytes (bool[T], bool[T, 3], f32[T, 3],
    f32[T, 4], i32[T]): each field's host array differs from its buffer,
    its rows a sorted random subset padded to a power of two with the
    first row."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    hosts = [rng.random(T) < 0.5, rng.random((T, 3)) < 0.5,
             rng.random((T, 3)).astype(np.float32), rng.random((T, 4)).astype(np.float32),
             rng.integers(-9, 9, T).astype(np.int32)]
    bufs = [torch.from_numpy(np.ascontiguousarray(~h if h.dtype == bool else h + 1))
            .to(device) for h in hosts]
    rows = []
    for _ in hosts:
        r = np.sort(rng.choice(T, rows_per_field, replace=False)).astype(np.int32)
        kp = 1 << max(1, (len(r) - 1).bit_length())
        rows.append(np.concatenate([r, np.full(kp - len(r), r[0], np.int32)]))
    return bufs, hosts, rows


def phase_k9_edge(device) -> float:
    """K9 against its plain version: rows of 1, 3, 12 and 16 bytes with
    padded duplicates; a payload larger than the slot the ring hands it,
    so the slot grows; and RING_SLOTS + 1 calls issued back to back with
    no synchronisation, the first large, so the last lands in the first's
    slot while the first may still be reading it; an index outside its
    buffer is refused before anything launches."""
    import torch

    from kube_batch_tpu_torch.kernels import row_patch as k9

    def run(args):
        bufs, hosts, rows = args
        got = [b.clone() for b in bufs]
        k9.row_patch(got, hosts, rows)
        return got

    def want(args):
        bufs, hosts, rows = args
        out = [b.cpu() for b in bufs]
        k9.row_patch_plain(out, hosts, rows)
        return out

    err = 0.0
    key = k9.ring_key(device) if device.type == "cuda" else None
    saved = k9._rings.get(key)
    # a ring of its own, its slots at their first size
    ring = k9._rings[key] = k9._Ring(device)
    small = k9_edge_inputs(device, 4096, 37)
    err = max(err, require_equal("row_patch edge widths",
                                 [(g.cpu(), w) for g, w in zip(run(small), want(small))]))
    before = max((sl.nbytes for sl in ring.slots if sl is not None), default=0)
    big = k9_edge_inputs(device, 262144, 40000, seed=1)
    need = k9.layout(*big)[1]
    err = max(err, require_equal("row_patch edge growth",
                                 [(g.cpu(), w) for g, w in zip(run(big), want(big))]))
    after = max((sl.nbytes for sl in ring.slots if sl is not None), default=0)
    if device.type == "cuda" and (not need > before or after < need):
        fail(f"row_patch edge: the ring did not grow ({before} → {after} for {need})")
    # back to back: call 0 and call RING_SLOTS share a slot
    calls = [k9_edge_inputs(device, 262144, 40000, seed=2)] + [
        k9_edge_inputs(device, 4096, 100 + i, seed=3 + i) for i in range(k9.RING_SLOTS)]
    calls[-1] = k9_edge_inputs(device, 262144, 40000, seed=9)
    outs = [[b.clone() for b in c[0]] for c in calls]
    torch.cuda.synchronize()
    for out, (_, hosts, rows) in zip(outs, calls):
        k9.row_patch(out, hosts, rows)
    for i, (out, c) in enumerate(zip(outs, calls)):
        err = max(err, require_equal(f"row_patch edge back to back call {i}",
                                     [(g.cpu(), w) for g, w in zip(out, want(c))]))
    log(json.dumps({"phase": "k9-edge",
                    "row_bytes": [h.nbytes // h.shape[0] for h in small[1]],
                    "units": [e[6] for e in k9.layout(*small)[0]],
                    "slot_bytes_before": before, "payload_bytes": need,
                    "slot_bytes_after": after, "back_to_back_calls": len(calls)}))
    torch.cuda.synchronize()
    for sl in ring.slots:
        if sl is not None:
            sl.free()
    if saved is None:
        k9._rings.pop(key)
    else:
        k9._rings[key] = saved
    bufs, hosts, rows = k9_edge_inputs(device, 4096, 5)
    rows[2] = rows[2].copy()
    rows[2][-1] = 4096
    try:
        k9.row_patch(bufs, hosts, rows)
    except IndexError:
        pass
    else:
        fail("row_patch edge: an index outside its buffer was not refused")
    return err


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
    "resolve": (4, 8),           # avail, cancelled
    "apply": (4, 5, 8, 9),       # node_future, node_idle, task_state, task_node
    "failure_counts": (3,),      # node_idle
    "victim_prefix": (),
    "preempt_open": (),
    "preempt_continue": (),
    "segment_sum": (),
    "segment_count": (),
    "waterfill": (1,),           # the request rows (their values: task_req)
    "lex_push_many": (0, 1),
    "sort_by_segment": (0, 1),
    "vtime": (0, 1, 2, 3),
    "row_patch": (0, 1),         # the device buffers, written in place, and
                                 # the host arrays, which the next pack patches
    "resident_words": (1, 2),    # task_node, task_state
    "affinity_mask": (),
    "affinity_row": (),
    "affinity_words": (),
    "affinity_task_words": (),
    # task_state, tried, prov, code, node_future, excl, phase, work, read
    "tier_control": (5, 11, 12, 13, 15, 16, 17, 18, 19),
    "podaff_score": (),          # writes only the classes' table (check_call
                                 # gives each version a buffer of its own)
}
# Arguments that are a loop's static buffers (ops/graphs.py: the state,
# the carry and the step's outputs, written in place by every later step),
# cloned per recorded call like the mutated ones.
_STATIC_ARGS = {
    "preempt_open": (3, 5, 7),           # task_state, prov, node_future
    "preempt_continue": (2, 4, 6, 7),    # task_node, node_future, p, n
    "victim_prefix": (4,),               # node_future
    "tier_control": (4,),                # the last step's accept mask or flags
}
# Arguments that are snapshot fields, constant within a cycle but
# row-patched by the next pack: cloned once per cycle and shared by the
# calls of that cycle.
_SNAPSHOT_ARGS = {
    "resident_words": (0, 3, 4, 5, 6),
    "affinity_mask": tuple(range(8)),
    "affinity_row": tuple(range(8)) + (10,),     # the fields and the task words
    "affinity_words": tuple(range(4)),
    "affinity_task_words": tuple(range(5)),
    "tier_control": (6, 7, 10, 14),
    "victim_prefix": (1, 3, 7),  # task_node, task_req (and its preemptor rows)
    "failure_counts": (2,),      # task_req
    "waterfill": (0, 2, 3),      # queue_weight, cluster_total, queue_mask
    "podaff_score": (3, 4, 5),   # node_key_domain, term_key, term_label
}
# K2's score terms (argument 10): a class term's table is the buffer every
# K13 call of the cycle rewrites, so it is cloned per recorded call (a
# [T, N] term is made afresh each cycle and kept as it is).
_CLASS_TERM_ARG = {"propose_best": 10, "propose_pick": 10}
# K2's arguments recorded: pass 1's and pass 2's without their shared
# scratch (84 MB a round at the main path's shapes, reused by the caching
# allocator once freed); `with_scratch` fills a fresh one for a recorded
# pass 2.
_RECORDED = {"propose_best": 12, "propose_pick": 15,
             # preempt_continue without the buffer the loop's carry keeps
             "preempt_continue": 9}


def _keep(a):
    """A copy of one recorded argument: tensors, lists of them, and
    snapshots (every field)."""
    import dataclasses

    import numpy as np
    import torch

    if isinstance(a, (torch.Tensor, np.ndarray)):
        return a.copy() if isinstance(a, np.ndarray) else a.clone()
    if isinstance(a, list):
        return [_keep(x) for x in a]
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: _keep(getattr(a, f.name)) for f in dataclasses.fields(a)})
    return a


class Recorder:
    """While active, every kernel wrapper call of the scheduler goes
    through unchanged (it launches and counts as before) and its inputs
    are kept: `calls[name]` lists (cycle, round, args) — of a kernel
    named in `every`, every `every[name]`-th call.  A cycle starts at its
    predicate-mask call and a round at its propose_best call.  Arguments
    a caller writes in place are cloned per call, snapshot fields once
    per cycle (the next pack row-patches them).  `hooks[name]` (optional)
    sees the arguments of every call of `name` before it launches; a call
    for which it returns true is not recorded (its clones would land in
    a traced window).  While active, the loops' step graphs run eagerly
    (`ops/graphs.py · eager_graphs`), so every kernel call goes through
    its wrapper."""

    def __init__(self, every: dict | None = None, hooks: dict | None = None) -> None:
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
        from kube_batch_tpu_torch.kernels import (
            affinity,
            joint_tier,
            podaff_score,
            resident,
        )

        self.sites += [
            (podaff_score, "podaff_score", "podaff_score"),
            (resident, "resident_words", "resident_words"),
            (affinity, "affinity_mask", "affinity_mask"),
            (affinity, "affinity_row", "affinity_row"),
            (affinity, "affinity_words", "affinity_words"),
            (affinity, "affinity_task_words", "affinity_task_words"),
            (joint_tier, "tier_control", "tier_control"),
        ]
        self.calls = {name: [] for name in _MUTATED}
        self.seen = {name: 0 for name in _MUTATED}
        self.cycle = self.round = -1
        self.every = every or {}
        self.hooks = hooks or {}
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

    def _row_clone(self, row):
        """K5's row operand with its snapshot fields and task words cloned
        once per cycle and its preemptor per call (a continuing step's is
        the loop's static scalar; its K11 build is the step's own)."""
        import dataclasses

        return dataclasses.replace(row, fields=tuple(self._cycle_clone(f) for f in row.fields),
                                   task_words=self._cycle_clone(row.task_words),
                                   p=row.p.clone())

    def _wrap(self, name, fn):
        from kube_batch_tpu_torch.kernels.affinity import AffinityRow
        from kube_batch_tpu_torch.kernels.propose import ClassTerm

        mutated = _MUTATED[name] + _STATIC_ARGS.get(name, ())
        terms = _CLASS_TERM_ARG.get(name)
        shared = _SNAPSHOT_ARGS.get(name, ())
        every = self.every.get(name, 1)
        hook = self.hooks.get(name)
        arity = _RECORDED.get(name)

        def wrapper(*args):
            if name == "predicate_mask":
                self.cycle += 1
            elif name == "propose_best":
                self.round += 1
            self.seen[name] += 1
            traced = hook is not None and hook(args)
            if self.seen[name] % every == 0 and not traced:
                kept = tuple(_keep(a) if i in mutated
                             else [_keep(e) if isinstance(e, ClassTerm) else e for e in a]
                             if i == terms
                             else self._cycle_clone(a) if i in shared
                             else self._row_clone(a) if isinstance(a, AffinityRow) else a
                             for i, a in enumerate(args[:arity]))
                self.calls[name].append((self.cycle, self.round, kept))
            return fn(*args)

        return wrapper

    def __enter__(self):
        from kube_batch_tpu_torch.ops import graphs

        for mod, attr, name in self.sites:
            fn = getattr(mod, attr)
            w = self._wrap(name, fn)
            # A wrapper counts its launches on its module's global name,
            # which is `w` while patched: `w` counts on from `fn`'s count.
            w.launches = getattr(fn, "launches", 0)
            self._saved.append((mod, attr, fn, w, w.launches))
            setattr(mod, attr, w)
        # a graph replay calls no wrapper: the loops run their bodies
        # eagerly, one auction round a read, while the Recorder records
        self._loop_graphs = graphs.loop_graphs
        graphs.loop_graphs = graphs.eager_graphs
        return self

    def __exit__(self, *exc):
        from kube_batch_tpu_torch.ops import graphs

        for mod, attr, fn, w, start in self._saved:
            setattr(mod, attr, fn)
            if hasattr(fn, "launches"):
                fn.launches += w.launches - start
        self._saved = []
        graphs.loop_graphs = self._loop_graphs


# ---------------------------------------------------------------------------
# kernel against plain version, on recorded inputs
# ---------------------------------------------------------------------------

def _fresh_apply_args(args):
    return tuple(a.clone() if i in _MUTATED["apply"] else a
                 for i, a in enumerate(args))


def _fresh_tier_args(args):
    return [a.clone() if i in _MUTATED["tier_control"] else a
            for i, a in enumerate(args)]


def with_scratch(pargs):
    """A recorded K2 pass-2 call's arguments and a scratch its pass 1 has
    filled: pass 1 runs again on pass 2's first twelve arguments, which
    are its own (the recorder keeps no scratch)."""
    from kube_batch_tpu_torch.kernels import propose as k2

    scratch = k2.best_scratch(pargs[2].shape[0], pargs[3].shape[0], pargs[2].device)
    k2.propose_best(*pargs[:12], scratch)
    return tuple(pargs[:15]) + (scratch,)


def resident_pairs(got, want):
    """(kernel, plain) pairs of every table of two ResidentWords, which
    must agree in shape and in which tables exist."""
    pairs = []
    for f in ("Hb", "Ab", "Hb_now", "Ab_now", "Hd", "Ad", "Hd_now", "Ad_now",
              "term_exists"):
        a, b = getattr(got, f), getattr(want, f)
        if (a is None) != (b is None):
            fail(f"resident_words: table {f} differs in presence from the plain version")
        if a is not None:
            pairs.append((a, b))
    return pairs


def resolve_pair(args):
    """K3 resolve and its plain version on `args`, each adding to its own copy
    of the cancelled counter: ((kept, perm, s_node[, cancelled]) of the
    kernel, the same of the plain version, {what: count})."""
    from kube_batch_tpu_torch.kernels import resolve as k3

    head, cancelled = args[:8], args[8]
    ck = None if cancelled is None else cancelled.clone()
    cp = None if cancelled is None else cancelled.clone()
    got = k3.resolve(*head, ck)
    want = k3.resolve_plain(*head, cp)
    if cancelled is not None:
        got, want = got + (ck,), want + (cp,)
    active, N = args[1], args[4].shape[0]
    kept = got[0]
    return got, want, {"proposers": int(active.sum()), "kept": int(kept.sum()),
                       "rejected": int((active & ~kept).sum()),
                       "longest_run": longest_run(args),
                       "cancelled": 0 if cancelled is None else int((cp - cancelled)[0])}


def longest_run(args) -> int:
    """The most proposers of one resolve call on one node."""
    import torch

    prop, active, N = args[0], args[1], args[4].shape[0]
    if not bool(active.any()):
        return 0
    return int(torch.bincount(prop[active].long(), minlength=N).max())


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
        from kube_batch_tpu_torch.kernels.affinity import AffinityRow

        # the plain version is fed the plain row (affinity_row_plain) where
        # the step hands K5 the affinity row operand
        buf = k5.victim_prefix(*args)
        err = require_equal(name, [(buf, k5.victim_prefix_plain(*args)),
                                   (buf, k5.victim_prefix(*args, route=k5.ROUTE_RADIX))])
        N = args[4].shape[0]
        k, out = buf[:N], buf[N:]
        row = args[11]
        with_row = isinstance(row, AffinityRow)
        return err, {"nodes_some_victims": int(((k > 0) & (k < k5.BIG_K)).sum()),
                     "nodes_no_prefix": int((k == k5.BIG_K).sum()),
                     "node_found": int(out[1]), "with_affinity_row": int(with_row),
                     "row_vetoed_nodes": int((~row.row_plain()).sum()) if with_row else 0}
    if name == "preempt_open":
        out = k6.preempt_open(*args)
        err = require_equal(name, [(out, k6.preempt_open_plain(*args))])
        return err, {"direct_fit_true": int(out[3]),
                     "direct_fit_false": 1 - int(out[3])}
    if name == "preempt_continue":
        from kube_batch_tpu_torch.kernels.affinity import AffinityRow

        # (v, any_victim, fit_now, viable) in a buffer of its own; the plain
        # version is fed the plain row where the step hands K6 the operand
        out = [x.clone() for x in k6.preempt_continue(*args)]
        err = require_equal(name, list(zip(out, k6.preempt_continue_plain(*args))))
        v, any_vic, fit_now, viable = (int(x) for x in out)
        return err, {"victim_found": any_vic, "no_victim_left": 1 - any_vic,
                     "fits_now": fit_now, "not_viable": 1 - viable,
                     "with_affinity_row": int(isinstance(args[8], AffinityRow)),
                     "with_row": int(args[8] is not None)}
    if name in ("segment_sum", "segment_count"):
        values, seg, num = args[:3]
        out = getattr(k7, name)(*args)
        err = require_equal(name, [(out, k7.segment_sum_plain(values, seg, num))])
        return err, {"nonempty_segments": int(torch.unique(seg[seg < num]).numel())}
    if name == "waterfill":
        out = k7.waterfill(*args)
        stats = {}
        err = require_equal(name, [(out, k7.waterfill_plain(*args, stats=stats))])
        request = fill_request(args)
        return err, {"queues": int(args[3].sum()),
                     "fused_calls": int(isinstance(args[1], k7.RequestRows)),
                     "iterations": stats["iterations"],
                     "queues_below_request": int((out < request).any(dim=1).sum())}
    if name == "predicate_mask":
        snap = args[0]
        out = k1.predicate_mask(*args)
        # the plain version, and the reference's own products and compares
        err = require_equal(name, [(out, k1.predicate_mask_plain(*args)),
                                   (out, predicate_matmul(*args))])
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
        out = k2.propose_pick(*with_scratch(args))
        err = require_equal(name, [(out, k2.propose_pick_plain(*args))])
        active, k = args[13], args[14]
        return err, {"active": int(active.sum()),
                     "picked_past_first_tie": int((active & (k > 0)).sum())}
    if name == "resolve":
        got, want, counts = resolve_pair(args)
        return require_equal(name, list(zip(got, want))), counts
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
        bufs, hosts, rows = args
        a_k, a_p = [b.clone() for b in bufs], [b.cpu() for b in bufs]
        k9.row_patch(a_k, hosts, rows)
        k9.row_patch_plain(a_p, hosts, rows)
        err = require_equal(name, [(k.cpu(), p) for k, p in zip(a_k, a_p)])
        return err, {"fields": len(bufs), "rows": sum(len(r) for r in rows),
                     "staged_bytes": k9.layout(bufs, hosts, rows)[1]}
    if name == "resident_words":
        from kube_batch_tpu_torch.kernels import resident as k11

        got, want = k11.resident_words(*args), k11.resident_words_plain(*args)
        err = require_equal(name, resident_pairs(got, want))
        return err, {"present_bits": int(k11.unpack(got.Hb, got.K).sum()),
                     "releasing_calls": int(got.with_now),
                     "future_calls": int(not got.with_now),
                     "domain_bits": 0 if got.Hd is None
                     else int(k11.unpack(got.Hd, got.K).sum())}
    if name == "affinity_words":
        from kube_batch_tpu_torch.kernels import affinity as k10

        got, want = k10.affinity_words(*args), k10.affinity_words_plain(*args)
        err = require_equal(name, [(got.node_words, want.node_words),
                                   (got.task_words, want.task_words),
                                   (got.thr, want.thr)])
        return err, {"rows_with_terms": int(got.task_words.any(dim=1).sum())}
    if name == "affinity_task_words":
        from kube_batch_tpu_torch.kernels import affinity as k10

        got = k10.affinity_task_words(*args)
        err = require_equal(name, [(got, k10.task_words_plain(*args))])
        return err, {"rows_with_terms": int(got.any(dim=1).sum())}
    if name == "affinity_mask":
        from kube_batch_tpu_torch.kernels import affinity as k10

        out = k10.affinity_mask(*args)
        err = require_equal(name, [(out, k10.affinity_mask_plain(*args))])
        return err, {"vetoed_cells": int((~out).sum())}
    if name == "affinity_row":
        from kube_batch_tpu_torch.kernels import affinity as k10

        # (fields..., resident, p, task_words): the plain row reads the
        # fields
        out = k10.affinity_row(*args).clone()
        err = require_equal(name, [(out, k10.affinity_row_plain(*args[:10]))])
        return err, {"vetoed_cells": int((~out).sum())}
    if name == "tier_control":
        from kube_batch_tpu_torch.kernels import joint_tier as k12

        a_k, a_p = _fresh_tier_args(args), _fresh_tier_args(args)
        k12.tier_control(*a_k)
        k12.tier_control_plain(*a_p)
        err = require_equal(name, [(a_k[i], a_p[i]) for i in _MUTATED[name]])
        read = a_k[19].tolist()
        done, step_out = read[k12.STEP_FLAGS], args[4]
        evict = step_out is not None and step_out.dtype != torch.bool
        return err, {"done": done, "not_done": 1 - done,
                     "after_auction_step": int(step_out is not None and not evict),
                     "after_evict_step": int(evict),
                     "discarded_plans": int(bool(done and evict and read[1]))}
    if name == "podaff_score":
        got, want = podaff_pair(args)
        err = require_equal(name, [(got, want)])
        return err, {"classes": args[0].C, "nonzero_cells": int((got != 0).sum()),
                     "topology_calls": int(args[0].rows_topo.shape[1] > 0)}
    if name == "failure_counts":
        from kube_batch_tpu_torch.kernels.affinity import AffinityWords

        out = k4.failure_counts(*args)
        err = require_equal(name, list(zip(out, k4.failure_counts_plain(*args))))
        pf, ins, fe, _nodes = out
        return err, {"rows_predicate_failed": int((pf > 0).sum()),
                     "rows_insufficient": int((ins > 0).any(dim=1).sum()),
                     "rows_feasible": int((fe > 0).sum()),
                     "words_form_calls": int(isinstance(args[1], AffinityWords)),
                     "mask_form_calls": int(isinstance(args[1], torch.Tensor))}
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


def fill_request(args):
    """f32[Q, R]: the request a water-fill call fills (summed from its
    RequestRows by the plain version where it takes rows)."""
    from kube_batch_tpu_torch.kernels import segment_sum as k7

    request = args[1]
    if isinstance(request, k7.RequestRows):
        return k7.segment_sum_plain(request.values, request.seg, args[0].shape[0])
    return request


def waterfill_bound(args):
    """(least ms, what bounds it) of one water-fill call on this run's
    data: bytes — with RequestRows the ids of every row and the kept rows'
    values, else the request, and the weights, mask, capacity and output
    once — against operations: the kept rows' float64 adds, and 9
    float32 operations an element an iteration for the iterations this
    call's fill runs to its fixed point (waterfill_plain's count)."""
    from kube_batch_tpu_torch.kernels import segment_sum as k7

    weights, request = args[0], args[1]
    Q, R = weights.shape[0], args[2].shape[0]
    nbytes = 4 * Q + Q + 4 * R + 4 * Q * R
    ops64 = 0
    if isinstance(request, k7.RequestRows):
        kept = int((request.seg < Q).sum())
        nbytes += 4 * request.seg.numel() + 4 * kept * R
        ops64 = kept * R
    else:
        nbytes += 4 * Q * R
    stats = {}
    k7.waterfill_plain(*args, stats=stats)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops64 / F64_OPS_PER_S + 9 * stats["iterations"] * Q * R / F32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row_patch_bound(args, link_bytes_per_s: float):
    """(least ms, "bytes") of one K9 call: the larger of its device
    memory time (the staged indices and rows read once, the rows written
    once, at HBM_BYTES_PER_S) and its host link time (the staged indices
    and rows, which live in host memory, crossing once at the rate
    host_link_rate measured in this run); and the two times."""
    bufs, hosts, rows = args
    rowb = [h.nbytes // h.shape[0] for h in hosts]
    staged = sum(len(r) * (4 + b) for r, b in zip(rows, rowb))
    written = sum(len(r) * b for r, b in zip(rows, rowb))
    hbm = (staged + written) / HBM_BYTES_PER_S * 1e3
    link = staged / link_bytes_per_s * 1e3
    return (max(hbm, link), "bytes"), {"hbm_ms": hbm, "link_ms": link,
                                       "staged_bytes": staged}


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
        "timings": dict(sched.last_timings),
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
    if rec is not None:
        rec.final = final_state(ssn, sched)
    return cycles, len(binder.refused), rec


def final_state(ssn, sched) -> tuple:
    """(snapshot, final AllocState, failure tallies, policy) of a run's
    last cycle: valid while no later pack of its scheduler writes the
    snapshot's buffers."""
    return ssn.snap, ssn.state, ssn.diag, sched.policy


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


def decision_stats(stats: dict) -> dict:
    """A cycle's stats without its times (each preemption loop's and
    joint tier's "ms"): rounds, cancellations, steps by outcome, tier
    steps and placements, evictions, the pack's mode and bytes."""
    return {k: [{kk: vv for kk, vv in x.items() if kk != "ms"} if isinstance(x, dict)
                else x for x in v] if isinstance(v, list) else v
            for k, v in stats.items()}


def same_run(a: list, b: list) -> bool:
    """Two runs' cycles decide alike, their stats included."""
    return len(a) == len(b) and all(
        _same(x, y) and decision_stats(x["rounds"]) == decision_stats(y["rounds"])
        for x, y in zip(a, b))


def path_cycles(device, build, n: int, after, conf=None, joint=False, timed=None):
    """`n` cycles of a fresh Scheduler on `build()`'s world (uid counter
    restarted), `after(cache, sim, cycle)` after each (the tick and the
    path's arrivals); returns the cycle records.  Cycle `timed`
    (0-based) runs with every graph replay timed by CUDA events, and its
    record gets `idle`: the share of its wall (and of its solve) the card
    spent outside the replays."""
    import itertools

    import torch

    import kube_batch_tpu_torch.cache.cluster as cluster
    from kube_batch_tpu_torch.ops import graphs
    from kube_batch_tpu_torch.scheduler import Scheduler

    cluster._uid_counter = itertools.count()
    cache, sim = build()
    sched = Scheduler(cache, conf=conf, device=device, joint_solve=joint)
    cycles = []
    for cycle in range(n):
        timing = cycle == timed
        if timing:
            torch.cuda.synchronize()
            before = graphs.totals["replay_ms"]
            graphs.TIME_REPLAYS = True
        t0 = time.perf_counter()
        try:
            ssn = sched.run_once()
        finally:
            graphs.TIME_REPLAYS = False
        if timing:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        if ssn is None:
            fail(f"cycle {cycle + 1} found nothing to solve")
        c = _cycle_record(ssn, sched)
        c["wall_ms"] = wall_ms
        if timing:
            busy = graphs.totals["replay_ms"] - before
            c["idle"] = {"cycle": cycle + 1, "wall_ms": round(wall_ms, 3),
                         "solve_ms": round(c["timings"]["solve_ms"], 3),
                         "replay_device_ms": round(busy, 3),
                         "idle_share_of_wall": round(1 - busy / wall_ms, 4),
                         "idle_share_of_solve": round(1 - busy / c["timings"]["solve_ms"], 4)}
        cycles.append(c)
        after(cache, sim, cycle)
    return cycles


def _per_step(cycles) -> list:
    """Per cycle: ms per auction round (solve ms over the rounds, on a
    cycle without evictions loops), per preemption step and per joint
    step by tier kind (each loop's or tier's ms over its steps)."""
    out = []
    for c in cycles:
        st, line = c["rounds"], {}
        loops = st.get("preempt_steps", []) + st.get("reclaim_steps", [])
        tiers = st.get("joint_tiers", [])
        rounds = sum(st.get("allocate_rounds", [])) + sum(st.get("backfill_rounds", []))
        if rounds and not loops and not tiers:
            line["rounds"] = rounds
            line["ms_per_round"] = round(c["timings"]["solve_ms"] / rounds, 4)
        if loops:
            steps = sum(lp["steps"] for lp in loops)
            line["steps"] = steps
            line["ms_per_step"] = round(sum(lp["ms"] for lp in loops) / max(steps, 1), 4)
        for kind in ("auction", "evict"):
            ts = [t for t in tiers if t["kind"] == kind]
            steps = sum(t["steps"] for t in ts)
            if steps:
                line[f"{kind}_steps"] = steps
                line[f"ms_per_{kind}_step"] = round(sum(t["ms"] for t in ts) / steps, 4)
        line["solve_ms"] = round(c["timings"]["solve_ms"], 3)
        out.append(line)
    return out


def graph_totals() -> dict:
    """The step graphs of the loop calls since `graphs.reset_totals()`:
    graphs captured, replays, bodies run eagerly (a key's first), host
    reads (an auction chunk, a step, a joint iteration), the chunk cap,
    nodes per graph by body kind ([min, median, max]) and capture ms."""
    import statistics

    from kube_batch_tpu_torch.ops import graphs

    t = graphs.totals
    nodes = {k: None if None in v else [min(v), int(statistics.median(v)), max(v)]
             for k, v in t["nodes"].items()}
    return {"loops": t["loops"], "graphs_captured": t["captured"], "replays": t["replays"],
            "eager_bodies": t["eager"], "reads": t["reads"], "chunk_cap": t["chunk_cap"],
            "nodes_per_graph": nodes, "capture_ms": round(t["capture_ms"], 3)}


def phase_captured(path: str, run, recorded: list, recorded_s: float, cpu=None):
    """`path` again with its loops captured (no Recorder: each body a
    graph replay after its first): every cycle must decide as the
    recorded run (`recorded`, its cycle records) and the CPU twin
    (`cpu`, where the path has one), stats included; the graphs must have
    replayed.  Logs the path's `step-graphs` line and returns the
    captured run's cycles."""
    from kube_batch_tpu_torch.ops import graphs

    graphs.reset_totals()
    t0 = time.perf_counter()
    cycles = run()
    seconds = time.perf_counter() - t0
    if not same_run(cycles, recorded):
        fail(f"{path}: the captured run decides otherwise than the recorded run")
    if cpu is not None and not same_run(cycles, cpu):
        fail(f"{path}: the captured run decides otherwise than the CPU twin")
    totals = graph_totals()
    if totals["graphs_captured"] <= 0 or totals["replays"] <= 0:
        fail(f"{path}: the captured run replayed no graph")
    log(json.dumps({
        "phase": "step-graphs", "path": path, **totals,
        "captured_s": round(seconds, 3), "recorded_s": round(recorded_s, 3),
        "captured": _per_step(cycles), "recorded": _per_step(recorded),
        "idle": [c["idle"] for c in cycles if "idle" in c],
        "identical_to_recorded": True, "identical_to_cpu": None if cpu is None else True,
    }))
    return cycles


def _tick_then(first_after):
    """`path_cycles`' `after`: the tick, then `first_after(cache, sim)`
    after the first cycle (a path's second wave)."""
    def after(cache, sim, cycle):
        sim.tick()
        if cycle == 0:
            first_after(cache, sim)
    return after


def main_cycles(device, wave: int = MAIN_WAVE_PODS, timed=None, **world_kw):
    """The main path's cycles (phase_main_path's, unrecorded)."""
    from kube_batch_tpu_torch.models.workloads import config5_full

    return path_cycles(device, lambda: config5_full(seed=0, **world_kw), 2,
                       _tick_then(lambda cache, sim: arrivals(cache, sim, wave)),
                       timed=timed)


def host_cycles(device, **world_kw):
    """The host cycle's incremental cycles and churn (phase_host_cycle's,
    unrecorded, without its checks and its full-pack twin)."""
    from kube_batch_tpu_torch.models.workloads import config5_full

    def after(cache, sim, cycle):
        if cycle + 1 < HOST_CYCLES:
            host_churn(cache, sim, cycle, cycle != 1)

    return path_cycles(device, lambda: config5_full(seed=0, **world_kw), HOST_CYCLES,
                       after)


def affinity_cycles(device, wave: int = MAIN_WAVE_PODS, timed=None, **world_kw):
    """The affinity path's cycles (phase_affinity_path's, unrecorded)."""
    return path_cycles(device, lambda: config5_affinity(**world_kw), 2,
                       _tick_then(lambda cache, sim: arrivals(cache, sim, wave)),
                       timed=timed)


def evict_cycles(device, joint: bool, timed=None, n: int = 3):
    """The preempt path's (or, `joint`, the joint path's) cycles,
    unrecorded: config 4 under examples/scheduler.conf, the wave after
    cycle 1."""
    return path_cycles(device, lambda: _config(4), n,
                       _tick_then(lambda cache, sim: preempt_wave(sim)),
                       conf=scheduler_conf(), joint=joint, timed=timed)


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
    launch counts of all their card runs together and the Recorder of
    ROW_WORLD's card run (the run whose preemption steps hand K5 the
    inter-pod affinity row operand), and the final state of SUBSET_WORLD's
    card run (`final_state`)."""
    from kube_batch_tpu_torch import kernels

    from kube_batch_tpu_torch.ops import graphs

    seen = {}
    parity_counts = {}
    row_counts = row_rec = None
    captured_lines = []
    for world in PARITY_WORLDS:
        t0 = time.perf_counter()
        kernels.reset_counts()
        gpu, refused, rec = _run(world, "cuda", record=True)
        world_counts = kernels.counts()
        for name, n in world_counts.items():
            parity_counts[name] = parity_counts.get(name, 0) + n
        if world == ROW_WORLD:
            row_counts, row_rec = world_counts, rec
        if world == SUBSET_WORLD:
            subset_final = rec.final
        t1 = time.perf_counter()
        cuda_s = t1 - t0
        # the same world with its loops captured, while the CPU twin runs
        graphs.reset_totals()
        captured = _run(world, "cuda", record=False)[0]
        if not same_run(captured, gpu):
            fail(f"{world}: the captured run decides otherwise than the recorded run")
        captured_lines.append({"world": world, **graph_totals(),
                               "captured_s": round(time.perf_counter() - t1, 3),
                               "recorded_s": round(t1 - t0, 3),
                               "captured": _per_step(captured), "recorded": _per_step(gpu)})
        if captured_lines[-1]["replays"] <= 0:
            fail(f"{world}: the captured run replayed no graph")
        t1 = time.perf_counter()
        cpu, cpu_s = cpu_runs[world].get(timeout=1200)
        t2 = time.perf_counter()
        for c, (g, h) in enumerate(zip(gpu, cpu)):
            if not _same(g, h):
                fail(f"{world}: cycle {c} decisions or failure tallies differ "
                     "between cuda and cpu")
        if not same_run(captured, cpu):
            fail(f"{world}: the captured run decides otherwise than the CPU twin")
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
            "cuda_s": round(cuda_s, 3), "cpu_worker_s": round(cpu_s, 3),
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
                ("resident_words", "present_bits"),
                ("resident_words", "releasing_calls"),
                ("resident_words", "future_calls"),
                ("resident_words", "domain_bits"),
                ("failure_counts", "words_form_calls"),
                ("victim_prefix", "with_affinity_row"), ("victim_prefix", "row_vetoed_nodes"),
                ("affinity_words", "rows_with_terms"),
                ("tier_control", "done"), ("tier_control", "not_done"),
                ("podaff_score", "nonzero_cells"), ("podaff_score", "topology_calls")):
        if seen.get(key, 0) <= 0:
            fail(f"parity worlds never gave {key[0]} a case with {key[1]} > 0")
    # the row world's opening steps hand K5 the affinity row operand, its
    # continuing steps (if any) K6: no row kernel of its own launches
    from kube_batch_tpu_torch.kernels.affinity import AffinityRow

    k5_calls = [a for _c, _r, a in row_rec.calls["victim_prefix"]]
    with_row = sum(isinstance(a[11], AffinityRow) for a in k5_calls)
    k6_calls = [a for _c, _r, a in row_rec.calls["preempt_continue"]]
    k6_with_row = sum(isinstance(a[8], AffinityRow) for a in k6_calls)
    log(json.dumps({"phase": "parity-row-world", "world": ROW_WORLD,
                    "victim_prefix_launches": row_counts["victim_prefix"],
                    "victim_prefix_calls_with_row": with_row,
                    "preempt_continue_launches": row_counts["preempt_continue"],
                    "preempt_continue_calls_with_row": k6_with_row,
                    "affinity_row_launches": row_counts["affinity_row"],
                    "rows_launched_alone": row_rec.seen["affinity_row"]}))
    if not k5_calls or with_row != len(k5_calls) or len(k5_calls) != row_counts["victim_prefix"]:
        fail(f"{ROW_WORLD}: {len(k5_calls) - with_row} of {len(k5_calls)} K5 launches "
             "without the affinity row operand")
    if k6_with_row != len(k6_calls) or len(k6_calls) != row_counts["preempt_continue"]:
        fail(f"{ROW_WORLD}: {len(k6_calls) - k6_with_row} of {len(k6_calls)} K6 "
             "continuing steps without the affinity row operand")
    if row_counts["affinity_row"]:
        fail(f"{ROW_WORLD}: affinity_row launched {row_counts['affinity_row']} times")
    for line in captured_lines:
        log(json.dumps({"phase": "step-graphs", "path": "parity", **line,
                        "identical_to_recorded": True, "identical_to_cpu": True}))
    log(json.dumps({"phase": "parity-launches", **parity_counts}))
    # the failure tallies take K10's words: no parity world launches its mask
    if parity_counts["affinity_mask"]:
        fail(f"the parity worlds launched affinity_mask {parity_counts['affinity_mask']} "
             "times")
    return parity_counts, row_rec, subset_final


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
    rec.records, t_start = [], time.perf_counter()
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
            rec.records.append(_cycle_record(ssn, sched))
            _check_binds_allowed(ssn)
            sessions.append((ssn.snap.num_tasks, len(ssn.bound)))
            sim.tick()
            if cycle == 0:
                t0 = time.perf_counter()
                n = arrivals(cache, sim, wave)
                log(json.dumps({"phase": "main-path-arrivals", "pods": n,
                                "submit_ms": round((time.perf_counter() - t0) * 1e3, 3)}))
    rec.seconds = time.perf_counter() - t_start
    rec.final = final_state(ssn, sched)
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
    rec = Recorder({name: 10**9 for name in _MUTATED
                    if name not in ("row_patch", "failure_counts", "waterfill")})
    rec.records, rec.seconds = [], 0.0
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
        rec.records.append(_cycle_record(ssn, sched))
        rec.seconds += wall_ms / 1e3
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
    the Recorder of cycles 2 and 3 and of cycle 1's water-fill calls, or
    None; the cache, the sessions).
    With `check_binds`, each cycle's binds are held against its own
    snapshot's predicate mask before the next pack."""
    from kube_batch_tpu_torch.scheduler import Scheduler

    cache, sim = preempt_world()
    sched = Scheduler(cache, conf=scheduler_conf(), device=device)
    rec = Recorder(PREEMPT_EVERY) if record else None
    # cycle 1's water-fill calls are recorded too, at cycle -1
    first = Recorder({name: 10**9 for name in _MUTATED if name != "waterfill"}) \
        if record else None
    cycles, sessions = [], []
    for cycle in range(3):
        t0 = time.perf_counter()
        if rec is not None:
            with rec if cycle >= 1 else first:
                ssn = sched.run_once()
        else:
            ssn = sched.run_once()
        if cycle == 0 and rec is not None:
            rec.calls["waterfill"] += [(-1, r, a) for _c, r, a in first.calls["waterfill"]]
            rec.seen["waterfill"] += first.seen["waterfill"]
        wall_ms = (time.perf_counter() - t0) * 1e3
        if ssn is None:
            fail(f"preempt path: cycle {cycle} found nothing to solve")
        if check_binds:
            _check_binds_allowed(ssn)
        c = _cycle_record(ssn, sched)
        c["wall_ms"] = wall_ms
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
        if n <= 0 and name not in (HOST_CYCLE_ONLY + AFFINITY_KERNELS + ENTRY_ONLY
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
    rec.cpu_cycles = cpu_cycles
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

    checks = check_all(rec, PREEMPT_KERNELS + ("failure_counts",))
    for name in ("preempt_continue", "failure_counts", "waterfill"):
        if checks[name]["calls"] != checks[name]["calls_made"]:
            fail(f"preempt path: not every {name} call was recorded")
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
    args = max(cycle2("victim_prefix"), key=lambda a: int(a[0].sum()))
    record("victim_prefix", time_ms(lambda: k5.victim_prefix(*args)),
           time_ms(lambda: k5.victim_prefix_plain(*args)), victim_prefix_bound(args))
    log(json.dumps({"phase": "kernel-note", "name": "victim_prefix",
                    **victim_prefix_work(args),
                    "radix_route_ms": round(time_ms(lambda: k5.victim_prefix(
                        *args, route=k5.ROUTE_RADIX)), 4)}))

    # K6: the opening step with the most eligible tasks and no direct fit
    args = timing_inputs(rec)["preempt_open"]
    record("preempt_open", time_ms(lambda: k6.preempt_open(*args)),
           time_ms(lambda: k6.preempt_open_plain(*args)), preempt_open_bound(args))
    log(json.dumps({"phase": "kernel-note", "name": "preempt_open",
                    "eligible": int(args[1].sum()), "ready_nodes": int(args[8].sum()),
                    "direct_fit": int(k6.preempt_open(*args)[3])}))
    # ... and cycle 2's continuing step whose node holds the most victims
    args = max(cycle2("preempt_continue"),
               key=lambda a: int((a[1] & (a[2] == a[7])).sum()))
    rank, victims, task_node, task_req, future, eps, p, n, dyn_row = args
    T = task_req.shape[0]
    buf = k6.ContinueBuffer(rank.device)

    def library():
        # the PyTorch chain of the same four outputs: a masked argmin, an
        # any, the fit test and the row's cell (no row on this path; an
        # operand's row by the reference's products)
        on_n = victims & (task_node == n)
        preq = task_req[p]
        row = k6._row_plain(dyn_row)
        return (torch.argmin(torch.where(on_n, T - 1 - rank, k6.INT32_MAX)), on_n.any(),
                torch.all((preq <= future[n]) | (preq < eps)),
                torch.ones((), dtype=torch.bool, device=rank.device) if row is None
                else row[n])

    require_equal("preempt_continue against its library form",
                  list(zip(k6.preempt_continue(*args, buf), library())))
    record("preempt_continue", time_ms(lambda: k6.preempt_continue(*args, buf)),
           time_ms(lambda: k6.preempt_continue_plain(*args)),
           preempt_continue_bound(args), time_ms(library))
    log(json.dumps({"phase": "kernel-note", "name": "preempt_continue",
                    "candidate_victims": int(victims.sum()),
                    "on_node": int((victims & (task_node == n)).sum()),
                    "continuing_steps_checked": checks["preempt_continue"]["calls"]}))

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

    # K7's water-fill (the queue sum and the fill, one launch)
    args = cycle2("waterfill")[-1]
    record("waterfill", time_ms(lambda: k7.waterfill(*args)),
           time_ms(lambda: k7.waterfill_plain(*args)), waterfill_bound(args))
    preempt_round_timings(rec)
    return out


def victim_prefix_work(args) -> dict:
    """What K5 does on `args`: the candidate victims, the longest node
    run, and the rows its walk reads (a node that fits with no victim
    reads none; otherwise its run up to the first k that fits)."""
    import torch

    from kube_batch_tpu_torch.kernels import victim_prefix as k5

    victims, task_node, future = args[0], args[1], args[4]
    N = future.shape[0]
    runs = torch.bincount(task_node[victims].long(), minlength=N)[:N]
    k = k5.victim_prefix_plain(*args)[:N].long()
    walked = int(torch.where(k == 0, 0, torch.minimum(k, runs)).sum())
    return {"victims": int(victims.sum()), "longest_run": int(runs.max()),
            "rows_walked": walked}


def victim_prefix_bound(args):
    """K5's least time on `args`: the victims mask of every row, each
    victim's node and rank, the requests of the rows walked, FutureIdle,
    the preemptor's request and predicate row, the node_ok, excl and
    dyn_row masks read once; k and the choice written once; a float64
    add and a compare a resource dim for each row walked."""
    T = args[0].shape[0]
    N, R = args[4].shape
    work = victim_prefix_work(args)
    masks = 3 + (args[11] is not None)
    return bound(T + work["victims"] * 8 + work["rows_walked"] * R * 4 + N * R * 4
                 + 3 * R * 4 + 8 + masks * N + (N + 5) * 4,
                 work["rows_walked"] * R * 2, F64_OPS_PER_S)


def preempt_round_timings(rec: Recorder) -> None:
    """K2's two passes and K3 on the auction round of the preempt
    path's recorded cycles with the most eligible rows (8,192 rows, 512
    nodes), timed for the redesign order's preempt, joint and parity
    paths (the joint path runs the same world; no parity world is
    wider)."""
    from kube_batch_tpu_torch.kernels import propose as k2
    from kube_batch_tpu_torch.kernels import resolve as k3

    rounds = {}
    for name in ("propose_best", "propose_pick", "resolve", "apply"):
        for cycle, rnd, args in rec.calls[name]:
            rounds.setdefault((cycle, rnd), {})[name] = args
    full = [r for r in rounds.values() if len(r) == 4]
    if not full:
        log(json.dumps({"phase": "preempt-path-round", "rounds": 0}))
        return
    rnd = max(full, key=lambda r: int(r["propose_best"][6].sum()))
    bargs, pargs, rargs, aargs = (rnd[k] for k in ("propose_best", "propose_pick",
                                                   "resolve", "apply"))
    _best, _ties, active = k2.propose_best(*bargs)
    pa = with_scratch(pargs)
    feas, scan, scan_feas = _work_counts(bargs, k2.propose_pick(*pa), active)
    ka = _fresh_apply_args(aargs)
    line = {"phase": "preempt-path-round", "tasks": bargs[0].shape[0],
            "nodes": bargs[0].shape[1], "eligible": int(bargs[6].sum()),
            "request_classes": request_classes(bargs)}
    for name, fn, b in (
            ("propose_best", lambda: k2.propose_best(*bargs),
             propose_best_bound(bargs, feas)),
            ("propose_pick", lambda: k2.propose_pick(*pa),
             propose_pick_bound(pargs, scan, scan_feas)),
            ("resolve", lambda: k3.resolve(*rargs), resolve_bound(rargs)),
            ("apply", lambda: k3.apply(*ka), apply_bound(aargs))):
        ms = time_ms(fn)
        path_time(name, ("preempt", "joint", "parity"), ms, b[0])
        line[f"{name}_ms"], line[f"{name}_bound_ms"] = round(ms, 4), round(b[0], 6)
    log(json.dumps(line))


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
    proposals before its watermark, among rounds that applied
    placements: its (propose_best, propose_pick, resolve, apply) inputs
    and that count."""
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
        prop, active, rank, req, avail, eps, opn, ser = calls["resolve"][:8]
        perm, s_node = k3.sort_plain(prop, active, rank, avail.shape[0])
        rej = int(active.sum()) - int(
            k3.prefix_accept_plain(perm, s_node, req, avail, eps, opn, ser).sum())
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
    """Cells each propose pass must touch, from this round's data: the
    feasible cells (scored), and for the pick pass the cells of the chunk
    (CHUNK_N nodes) that holds each active row's chosen node and the
    feasible ones among them."""
    import torch

    from kube_batch_tpu_torch.kernels.propose import (
        CHUNK_N,
        PLAIN_ROWS,
        ClassTerm,
        masked_scores_plain,
        quantum_scale,
    )

    from kube_batch_tpu_torch.kernels.affinity import AffinityWords, affinity_cells_plain

    (pred, dyn, req, avail, eps, node_mask, eligible, future, cap, spec,
     extras, quantum) = args
    T, N = pred.shape
    cols = torch.arange(N, device=pred.device)
    feas_cells = scan_cells = scan_feas = 0
    for lo in range(0, T, PLAIN_ROWS):
        rows = slice(lo, min(T, lo + PLAIN_ROWS))
        d = (None if dyn is None else affinity_cells_plain(dyn.rows(rows))
             if isinstance(dyn, AffinityWords) else dyn[rows])
        feas, _ = masked_scores_plain(
            pred[rows], d, req[rows], avail,
            eps, node_mask, eligible[rows], future, cap, spec,
            [x.rows(rows) if isinstance(x, ClassTerm) else x[rows] for x in extras],
            quantum_scale(quantum),
        )
        feas_cells += int(feas.sum())
        scanned = active[rows, None] & (cols[None, :] // CHUNK_N
                                        == (prop[rows] // CHUNK_N)[:, None])
        scan_cells += int(scanned.sum())
        scan_feas += int((scanned & feas).sum())
    return feas_cells, scan_cells, scan_feas


def _node_score_ops(spec, R: int) -> int:
    """Operations of the node-order score of one request on one node."""
    ops = 0
    if spec.w_lr is not None:
        ops += 7 * R + 4
    if spec.w_bal is not None:
        ops += 16
    return ops


def _score_ops(spec, R: int) -> int:
    return 2 + _node_score_ops(spec, R)  # mask select, quantum floor


def request_classes(args) -> int:
    """Distinct requests (bitwise) among K2 pass 1's eligible rows: the
    fit test and the node-order score depend on the request and the node
    only."""
    import torch

    req, eligible = args[2], args[6]
    return int(torch.unique(req[eligible].contiguous().view(torch.int32), dim=0).shape[0])


def k4_request_classes(task_req) -> dict:
    """Distinct requests (bitwise) over every row, and the mean and the
    most per 32-row block of K4 (a block computes each of its classes'
    fit and shortfall words once per 32 nodes)."""
    import torch

    bits = task_req.contiguous().view(torch.int32)
    per = [int(torch.unique(bits[i:i + 32], dim=0).shape[0])
           for i in range(0, bits.shape[0], 32)]
    return {"request_classes": int(torch.unique(bits, dim=0).shape[0]),
            "classes_per_block_mean": round(sum(per) / max(len(per), 1), 3),
            "classes_per_block_max": max(per, default=0)}


def _masked_cells(pred, node_mask, rows) -> int:
    """Cells of the rows `rows` whose predicate and node mask pass."""
    from kube_batch_tpu_torch.kernels.propose import PLAIN_ROWS

    T = pred.shape[0]
    return sum(int((pred[lo:lo + PLAIN_ROWS] & node_mask[None, :]
                    & rows[lo:lo + PLAIN_ROWS, None]).sum())
               for lo in range(0, T, PLAIN_ROWS))


def propose_best_bound(args, feas_cells: int):
    """K2 pass 1's least time on `args` (with the eligible list and the
    chunk summaries it writes for pass 2): of the eligible rows only, the
    predicate mask, the dynamic mask or the task words with their
    thresholds, the extra score terms (a class term: the row's class, and
    each class row among the eligible rows' classes once) and the
    requests; each node's
    avail, future, cap and mask (and, in the words form, its words)
    once; the eligible mask, and the three outputs of every row (a row
    that is not eligible needs no read for its fixed answer).  The fit
    test (two compares a resource dim) and the node-order score once per
    request class of the eligible rows and real node; a select per
    eligible cell on a real node; the dynamic test (a byte, or the words:
    two operations a word and three compares) where the predicate and
    node mask pass on a row that has one; the extra terms, the quantum
    floor and the max per feasible cell."""
    from kube_batch_tpu_torch.kernels.affinity import AffinityWords
    import torch

    from kube_batch_tpu_torch.kernels.propose import (
        CHUNK_N,
        ClassTerm,
        chunk_ties_bytes,
        quantum_scale,
    )

    pred, dyn, req, _avail, _eps, node_mask, eligible = args[:7]
    spec, extras, quantum = args[9], args[10], args[11]
    T, N = pred.shape
    R = req.shape[1]
    E, M = int(eligible.sum()), int(node_mask.sum())
    terms = [e for e in extras if isinstance(e, ClassTerm)]
    row_bytes = N + (len(extras) - len(terms)) * 4 * N + len(terms) * 4 + R * 4
    node_bytes = 3 * N * R * 4 + N
    node_bytes += sum(int(torch.unique(e.cls[eligible]).numel()) * N * 4 for e in terms)
    test_ops = 0
    if isinstance(dyn, AffinityWords):
        nw = dyn.node_words.shape[1]
        row_bytes += nw * 4 + 8
        node_bytes += N * nw * 4
        has_test = eligible & (dyn.task_words != 0).any(dim=1)
        test_ops = _masked_cells(pred, node_mask, has_test) * (2 * nw + 3)
    elif dyn is not None:
        row_bytes += N
        test_ops = _masked_cells(pred, node_mask, eligible)
    finish_ops = len(extras) + (2 if quantum_scale(quantum) > 0 else 0) + 1
    ops = (request_classes(args) * M * (2 * R + _node_score_ops(spec, R)) + E * M
           + test_ops + feas_cells * finish_ops)
    # and, for pass 2, the eligible list and each listed row's chunk
    # summaries written
    summaries = E * (4 + -(-N // CHUNK_N) * (4 + chunk_ties_bytes()))
    return bound(E * row_bytes + node_bytes + T + 9 * T + R * 4 + summaries, ops)


def propose_pick_bound(args, scan_cells: int, scan_feas: int):
    """K2 pass 2's least time on the work it now needs: the eligible
    mask and the answer of every row; of each listed row its slot and
    active flag, of each active row its best, k, request and chunk
    summaries (max f32 and a tie count per CHUNK_N nodes); of each active
    row's one chunk (`scan_cells` cells) the masks, extras, words and
    node rows; a compare and an add a chunk summary, the fit a cell and
    the score a feasible cell."""
    from kube_batch_tpu_torch.kernels.affinity import AffinityWords
    from kube_batch_tpu_torch.kernels.propose import CHUNK_N, chunk_ties_bytes

    pred, dyn, req, spec, extras = args[0], args[1], args[2], args[9], args[10]
    eligible, active = args[6], args[13]
    T, N = pred.shape
    R = req.shape[1]
    E, A, C = int(eligible.sum()), int(active.sum()), -(-N // CHUNK_N)
    from kube_batch_tpu_torch.kernels.propose import ClassTerm

    cell = 1 + 1 + len(extras) * 4 + 3 * R * 4   # pred, node mask, extras, node rows
    # a row's class for each class term
    row = 8 + R * 4 + C * (4 + chunk_ties_bytes()) + 4 * sum(
        isinstance(e, ClassTerm) for e in extras)
    if isinstance(dyn, AffinityWords):
        nw = dyn.node_words.shape[1]
        cell += nw * 4
        row += nw * 4 + 8
    elif dyn is not None:
        cell += 1
    return bound(T + 4 * T + E * 5 + A * row + scan_cells * cell,
                 A * C * 2 + scan_cells * 2 * R + scan_feas * _score_ops(spec, R))


def resolve_bound(args):
    """K3 resolve's least time: the sort keys of every row read (node,
    active flag, rank: 9 bytes) and the serialize mask if any, the
    (node, rank) order written (perm and s_node, 16 bytes a row) with the
    kept mask, the proposers' requests and the nodes' capacity read;
    three float64 operations a proposer and dim."""
    active, task_req, avail, ser = args[1], args[3], args[4], args[7]
    T, (N, R) = active.shape[0], avail.shape
    n_active = int(active.sum())
    return bound(9 * T + (0 if ser is None else T) + 17 * T + n_active * R * 4
                 + N * R * 4 + R * 4, n_active * R * 3, F64_OPS_PER_S)


def apply_bound(args):
    """K3 apply's least time: the sorted order, node ids and accept mask,
    the accepted rows' requests and state, the touched nodes' rows read
    and written; a float64 add a dim per accepted row."""
    import torch

    perm, s_node, accept, task_req = args[:4]
    T, R = task_req.shape
    n_acc = int(accept.sum())
    touched = int(torch.unique(s_node[accept[perm]]).numel())
    return bound(17 * T + n_acc * (R * 4 + 8) + touched * R * 4 * 4, n_acc * R,
                 F64_OPS_PER_S)


def apply_library(perm, s_node, accept, task_req, node_future, node_idle, use_future,
                  new_status, task_state, task_node):
    """K3 apply in library calls (its library yardstick; the port never
    calls it): one float64 `index_add_` of the accepted rows' requests
    into per-node deltas, subtracted once rounded (a node no row landed
    on loses +0.0, which leaves it as it is), and the two row scatters."""
    import torch

    N, R = node_future.shape
    s_acc = accept[perm] & (s_node < N)
    rows = perm[s_acc]
    delta = torch.zeros((N, R), dtype=torch.float64, device=perm.device).index_add_(
        0, s_node[s_acc], task_req[rows].double()).float()
    node_future.sub_(delta)
    if not use_future:
        node_idle.sub_(delta)
    task_state[rows] = new_status
    task_node[rows] = s_node[s_acc].int()


def failure_counts_library(pred, dyn, task_req, node_idle, eps, node_ok):
    """K4's tallies as the reference reduces them, over [T, N, R] at once
    (its library yardstick; the plain version takes rows in chunks), the
    dynamic predicate a mask or None."""
    if dyn is not None:
        pred = pred & dyn
    q = task_req[:, None, :]
    ok = node_ok[None, :]
    fit = ((q <= node_idle[None, :, :]) | (q < eps)).all(dim=-1)
    pf = ((~pred) & ok).sum(dim=1).int()
    fe = (pred & fit & ok).sum(dim=1).int()
    short = ((pred & ~fit & ok)[:, :, None] & (q > node_idle[None, :, :])
             & (task_req >= eps)[:, None, :])
    return pf, short.sum(dim=1).int(), fe, node_ok.sum().int()


def preempt_continue_bound(args):
    """K6 preempt_continue's least time on `args`, from this run's data:
    the victims byte of every row, task_node of each candidate victim and
    rank of each victim on n (the function needs no other row's), p's
    request row, n's FutureIdle row, eps, p, n and the row's cell at n
    read once; the 11 output bytes written once. Operations: a node
    compare a victim, a key a victim on n, two compares a dimension."""
    import torch

    rank, victims, task_node, task_req, future, eps, p, n, dyn_row = args
    T, R = task_req.shape
    V = int(victims.sum())
    on_n = int((victims & (task_node == n)).sum())
    nbytes = T + 4 * V + 4 * on_n + 3 * R * 4 + 16 + 11
    if isinstance(dyn_row, torch.Tensor):
        nbytes += 1
    return bound(nbytes, V + on_n + 2 * R)


def failure_counts_bound(args):
    """K4's least time on `args`: bytes, each input read once (the
    predicate mask, the dynamic mask or K10's words and thresholds, the
    requests, idle rows, eps and node_ok) and the tallies written once.
    A cell's fit and shortfalls depend on (request class, node) only, so
    no per-cell operation is charged."""
    import torch

    pred, dyn, task_req, node_idle, eps, node_ok = args
    (T, N), R = pred.shape, task_req.shape[1]
    n = T * N + T * R * 4 + N * R * 4 + R * 4 + N + (T * (2 + R) + 1) * 4
    if isinstance(dyn, torch.Tensor):
        n += T * N
    elif dyn is not None:
        n += (dyn.task_words.numel() + dyn.node_words.numel() + dyn.thr.numel()) * 4
    return bound(n, 0)


def predicate_bound(snap):
    """(K1's least time, live vocabulary columns W): every table read once
    and the T·N mask written; on 0/1 tables a set test covers 32 columns
    with two operations, so two operations a cell per 32-column word of
    live columns in each table, and six more a cell."""
    T, N = snap.num_tasks, snap.num_nodes
    live = (_live_width(snap.task_sel, snap.node_labels),
            _live_width(snap.task_tol, snap.node_taints),
            _live_width(snap.task_ports, snap.node_ports),
            int(snap.task_vol_groups.any(dim=0).sum()))
    words = sum(-(-w // 32) for w in live)
    in_bytes = sum(x.numel() * x.element_size() for x in (
        snap.task_sel, snap.node_labels, snap.task_tol, snap.node_taints,
        snap.task_ports, snap.node_ports, snap.node_ready, snap.node_pressure,
        snap.task_vol_node, snap.task_vol_groups))
    return bound(in_bytes + T * N, T * N * (2 * words + 6)), sum(live)


def predicate_matmul(snap, flags):
    """bool[T, N]: the reference predicate's own arithmetic (multi-hot
    products by torch.matmul and their compares), K1's library yardstick;
    the port never calls it."""
    import torch

    T, N = snap.num_tasks, snap.num_nodes
    ok = torch.ones((T, N), dtype=torch.bool, device=snap.device)
    if flags.selector:
        ok &= (snap.task_sel @ snap.node_labels.T) >= snap.task_sel.sum(dim=1, keepdim=True)
    if flags.taints:
        ok &= (snap.node_taints.sum(dim=1)[None, :]
               - snap.task_tol @ snap.node_taints.T) <= 0.5
    if flags.ports:
        ok &= (snap.task_ports @ snap.node_ports.T) <= 0.5
    if flags.ready:
        ok &= snap.node_ready[None, :]
    for dim, on in enumerate(flags.pressure):
        if on:
            ok &= snap.node_pressure[None, :, dim] <= 0.5
    if flags.volume:
        ids = torch.arange(N, dtype=torch.int32, device=snap.device)
        pin = snap.task_vol_node
        ok &= (pin == -1)[:, None] | (pin[:, None] == ids[None, :])
        if snap.task_vol_groups.shape[1]:
            miss = 1.0 - ((snap.node_labels @ snap.vol_group_sel.T) > 0.5).float()
            ok &= (snap.task_vol_groups @ miss.T) <= 0.5
    return ok


def phase_kernels(rec: Recorder):
    import torch

    from kube_batch_tpu_torch.kernels import failure_counts as k4
    from kube_batch_tpu_torch.kernels import predicate_mask as k1
    from kube_batch_tpu_torch.kernels import propose as k2
    from kube_batch_tpu_torch.kernels import resolve as k3
    from kube_batch_tpu_torch.kernels import segment_sum as k7

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
    b, W = predicate_bound(snap)
    record("predicate_mask", args,
           time_ms(lambda: k1.predicate_mask(*args)),
           time_ms(lambda: k1.predicate_mask_plain(*args)), b,
           # The PyTorch form of this function: the reference's products
           # by torch.matmul with their compares.
           time_ms(lambda: predicate_matmul(*args)))
    log(json.dumps({"phase": "kernel-note", "name": "predicate_mask",
                    "live_vocabulary_columns": W}))

    # K2 and K3 on one auction round of cycle 2
    rnd, rejected = _pick_round(rec)
    bargs, pargs, rargs, aargs = (rnd[k] for k in (
        "propose_best", "propose_pick", "resolve", "apply"))
    spec = bargs[9]
    best, ties, active = k2.propose_best(*bargs)
    pick_a = with_scratch(pargs)
    prop = k2.propose_pick(*pick_a)
    feas_cells, scan_cells, scan_feas = _work_counts(bargs, prop, active)
    eligible = int(bargs[6].sum())
    log(json.dumps({"phase": "round-inputs", "eligible": eligible,
                    "eligible_share": round(eligible / T, 6),
                    "request_classes": request_classes(bargs),
                    "active": int(active.sum()), "rejected": rejected,
                    "longest_run": longest_run(rargs),
                    "feasible_cells": feas_cells, "pick_cells": scan_cells}))
    record("propose_best", bargs,
           time_ms(lambda: k2.propose_best(*bargs)),
           time_ms(lambda: k2.propose_best_plain(*bargs), warmup=1, runs=3),
           propose_best_bound(bargs, feas_cells))
    record("propose_pick", pargs,
           time_ms(lambda: k2.propose_pick(*pick_a)),
           time_ms(lambda: k2.propose_pick_plain(*pargs), warmup=1, runs=3),
           propose_pick_bound(pargs, scan_cells, scan_feas))
    record("resolve", rargs,
           time_ms(lambda: k3.resolve(*rargs)),
           time_ms(lambda: k3.resolve_plain(*rargs)),
           resolve_bound(rargs))
    ka, pa, la = (_fresh_apply_args(aargs) for _ in range(3))
    apply_library(*la)
    k3.apply(*ka)
    require_equal("apply against its library form",
                  [(ka[i], la[i]) for i in (4, 5, 8, 9)])
    ka, la = _fresh_apply_args(aargs), _fresh_apply_args(aargs)
    record("apply", aargs,
           time_ms(lambda: k3.apply(*ka)),
           time_ms(lambda: k3.apply_plain(*pa)),
           apply_bound(aargs), time_ms(lambda: apply_library(*la)))

    # K4, cycle 2's call (the cycle's final node_idle)
    fargs = rec.calls["failure_counts"][-1][2]
    require_equal("failure_counts against its library form", list(zip(
        k4.failure_counts(*fargs), failure_counts_library(*fargs))))
    record("failure_counts", fargs,
           time_ms(lambda: k4.failure_counts(*fargs)),
           time_ms(lambda: k4.failure_counts_plain(*fargs)),
           failure_counts_bound(fargs),
           time_ms(lambda: failure_counts_library(*fargs), warmup=1, runs=3))
    log(json.dumps({"phase": "kernel-note", "name": "failure_counts",
                    **k4_request_classes(fargs[2])}))
    # ... and every call of the path (one a cycle)
    k4_checks = check_all(rec, ("failure_counts",))["failure_counts"]
    log(json.dumps({"phase": "main-path-k4", "equal_to_plain": True, **k4_checks}))
    if k4_checks["calls"] != k4_checks["calls_made"]:
        fail("main path: not every failure_counts call was checked")
    pf, ins, fe, _nodes = k4.failure_counts(*fargs)
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
    if not 0 < k7_checks["waterfill"]["calls"] == k7_checks["waterfill"]["calls_made"]:
        fail("main path: not every water-fill call was checked")
    wargs = [a for c, _r, a in rec.calls["waterfill"]][-1]
    ms, plain_ms, b = (time_ms(lambda: k7.waterfill(*wargs)),
                       time_ms(lambda: k7.waterfill_plain(*wargs)), waterfill_bound(wargs))
    path_time("waterfill", ("main", "host_cycle"), ms, b[0])
    log(json.dumps({"phase": "kernel-main-path", "name": "waterfill",
                    "rows": wargs[1].values.shape[0], "queues": wargs[0].shape[0],
                    "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
                    "bound_ms": round(b[0], 6), "bound_by": b[1]}))
    args = main_timing_input(rec)
    ms, plain_ms, library_ms, b = segment_sum_timing(args)
    path_time("segment_sum", ("main", "host_cycle"), ms, b[0])
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
    notes = {}
    if rec.calls["sort_by_segment"]:   # a path may sort nothing but its segment indexes
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
        notes["sort_by_segment"] = {"rows": seg.numel(), "segments": S,
                                    "plan": list(k8.sort_plan(seg.numel(), S))}
    args = widest("vtime")
    out["vtime"] = (
        time_ms(lambda: k8.vtime(*args)),
        time_ms(lambda: k8.vtime_plain(*args)),
        None,
        vtime_bound(args),
    )
    notes.update({"lex_push_many": {"rows": keys[0].numel(), "keys": m},
                  "vtime": {"rows": args[2].shape[0], "segments": args[6],
                            "valid_rows": int(args[3].sum()),
                            "one_launch": args[2].shape[0] <= k8.CTA_MAX_T}})
    for name, (ms, plain_ms, library_ms, b) in out.items():
        log(json.dumps({"phase": f"kernel-{label}", "name": name, **notes[name],
                        "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
                        "library_ms": None if library_ms is None else round(library_ms, 4),
                        "bound_ms": round(b[0], 6), "bound_by": b[1]}))
    return out


def vtime_bound(args):
    """K8 vtime's least time on `args` (seg, base_rank, req, valid,
    alloc_seg, denom_seg, S): each row's segment, rank and valid flag
    read and its time written, the valid rows' requests and both [S, R]
    tables read once; per row and dim a float64 add, the rounding, the
    division and the max."""
    seg, _rank, req, valid, alloc, _denom, S = args
    T, R = req.shape
    return bound(T * (4 + 4 + 1 + 4) + int(valid.sum()) * R * 4 + 2 * S * R * 4,
                 T * R * 4, F64_OPS_PER_S)


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
    # the joint path runs the preempt path's world (8,192 rows), and no
    # parity world is wider
    for name, (ms, _plain, _lib, b) in _rank_timings(preempt_rec, "preempt-path").items():
        path_time(name, ("preempt", "joint", "parity"), ms, b[0])
    return {name: dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                       bound=b, library_ms=library_ms)
            for name, (ms, plain_ms, library_ms, b) in timed.items()}


def phase_row_patch(rec: Recorder) -> dict:
    """K4, K7's water-fill and K9 on every call of the host cycle against
    their plain versions; K9 timed on the call with the most rows, beside
    its plain version
    on the card, the library form (per field, its indices and rows
    copied from the same host arrays to the card, then one index_copy_)
    and the bound (row_patch_bound, at this run's host link rate)."""
    import numpy as np
    import torch

    from kube_batch_tpu_torch.kernels import row_patch as k9

    for name in ("failure_counts", "waterfill"):
        got = check_all(rec, (name,))[name]
        log(json.dumps({"phase": f"host-cycle-{name}", "equal_to_plain": True, **got}))
        if got["calls"] <= 0 or got["calls"] != got["calls_made"]:
            fail(f"host cycle: not every {name} call was checked")
    checks = check_all(rec, ("row_patch",))["row_patch"]
    log(json.dumps({"phase": "host-cycle-k9", "equal_to_plain": True, **checks}))
    if checks["calls"] <= 0 or checks["calls"] != checks["calls_made"]:
        fail("K9: not every row_patch call of the host cycle was checked")
    bufs, hosts, rows = max((a for _c, _r, a in rec.calls["row_patch"]),
                            key=lambda a: sum(len(r) for r in a[2]))
    bufs = [b.clone() for b in bufs]
    dev = bufs[0].device

    def library():
        for b, h, r in zip(bufs, hosts, rows):
            b.index_copy_(0, torch.from_numpy(r.astype(np.int64)).to(dev),
                          torch.from_numpy(h[r]).to(dev))

    b, parts = row_patch_bound((bufs, hosts, rows), HOST_LINK["bytes_per_s"])
    ms = time_ms(lambda: k9.row_patch(bufs, hosts, rows))
    plain_ms = time_ms(lambda: k9.row_patch_plain(bufs, hosts, rows))
    library_ms = time_ms(library)
    log(json.dumps({"phase": "kernel", "name": "row_patch", "fields": len(bufs),
                    "rows": sum(len(r) for r in rows), "ms": round(ms, 4),
                    "plain_ms": round(plain_ms, 4), "library_ms": round(library_ms, 4),
                    "bound_ms": round(b[0], 6), "bound_by": b[1],
                    "hbm_ms": round(parts["hbm_ms"], 6), "link_ms": round(parts["link_ms"], 6),
                    "staged_bytes": parts["staged_bytes"]}))
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
    K11 launch counters are set to 0 before and read after, and K11 may
    launch at most once an auction round plus once a cycle.  Returns
    (the counts, the Recorder of the K10 / K11 calls; its `final` is the
    last cycle's `final_state`)."""
    from kube_batch_tpu_torch import kernels
    from kube_batch_tpu_torch.scheduler import Scheduler

    cache, sim = config5_affinity(**world_kw)
    sched = Scheduler(cache, device=device)
    rec = Recorder({**{name: 10**9 for name in _MUTATED}, **AFFINITY_EVERY})
    rec.records, t_start = [], time.perf_counter()
    kernels.reset_counts()
    before = kernels.counts()
    sessions = []
    alloc_rounds = 0
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
            if now["affinity_mask"] - before["affinity_mask"]:
                fail(f"affinity path: cycle {cycle + 1} launched affinity_mask "
                     f"{now['affinity_mask'] - before['affinity_mask']} times (the "
                     "failure tallies take its words)")
            # one K11 build per auction round, plus the failure tallies'
            alloc_rounds += sum(sched.last_stats.get("allocate_rounds", []))
            rounds = (sum(sched.last_stats.get("allocate_rounds", []))
                      + sum(sched.last_stats.get("backfill_rounds", [])))
            k11_launches = now["resident_words"] - before["resident_words"]
            line["resident_words_per_round"] = round(k11_launches / max(rounds, 1), 4)
            if k11_launches > rounds + 1:
                fail(f"affinity path: cycle {cycle + 1} launched resident_words "
                     f"{k11_launches} times in {rounds} rounds (at most one a round "
                     "plus one a cycle)")
            before = now
            rec.records.append(_cycle_record(ssn, sched))
            _check_binds_allowed(ssn)
            line.update(_check_affinity(ssn, cache))
            log(json.dumps(line))
            sessions.append((ssn.snap.num_tasks, len(ssn.bound)))
            sim.tick()
            if cycle == 0:
                log(json.dumps({"phase": "affinity-path-arrivals",
                                "pods": arrivals(cache, sim, wave)}))
    rec.seconds = time.perf_counter() - t_start
    rec.final = final_state(ssn, sched)
    counts = kernels.counts()
    log(json.dumps({"phase": "affinity-path-launches", **counts}))
    for name in AFFINITY_KERNELS:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the affinity path")
    # every auction round builds its words once, then proposes; every
    # cycle's failure tallies build them once more and hand them to K4
    from kube_batch_tpu_torch.kernels.affinity import AffinityWords

    if rec.seen["affinity_words"] != rec.seen["propose_best"] + 2:
        fail(f"affinity path: {rec.seen['affinity_words']} affinity_words calls for "
             f"{rec.seen['propose_best']} auction rounds and 2 cycles")
    # the pod-affinity score: one K13 table an allocate round (backfill
    # scores nothing), read by K2 as a class term
    if rec.seen["podaff_score"] != alloc_rounds:
        fail(f"affinity path: {rec.seen['podaff_score']} podaff_score calls for "
             f"{alloc_rounds} allocate rounds")
    tallies = [a for _c, _r, a in rec.calls["failure_counts"]]
    if len(tallies) != 2 or not all(isinstance(a[1], AffinityWords) for a in tallies):
        fail("affinity path: the failure tallies did not take K10's words")
    if not sessions[0][1] or not sessions[1][1]:
        fail("an affinity-path cycle bound nothing")
    _check_invariants(cache)
    log(json.dumps({"phase": "affinity-path-invariants", "capacity": True,
                    "gang": True, "predicate": True, "one_ps_per_node": True,
                    "mpi_team_mate_in_rack": True}))
    return counts, rec


# ---------------------------------------------------------------------------
# the active-set diagnosis on final states of the paths
# ---------------------------------------------------------------------------

def _veto_node0(snap, state, immediate=False, resident=None):
    """A dynamic predicate with no subset form: node 0 vetoed for every
    task (the subset-diag phase's fallback check)."""
    import torch

    m = torch.ones((snap.num_tasks, snap.num_nodes), dtype=torch.bool, device=snap.device)
    m[:, 0] = False
    return m


def device_time(fn, calls: int = 5) -> dict:
    """Device ms and device operations a call of `fn` (torch.profiler's
    device time over `calls` calls, after one warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    return {"device_ms": round(sum(e.device_time_total for e in events) / calls / 1e3, 4),
            "device_operations": round(sum(e.count for e in events) / calls, 2)}


def subset_bound(snap, k4_args) -> float:
    """The subset tallies' least time in ms: K4's on the window
    (`failure_counts_bound` on its [P, N] arguments) plus the gathered
    bytes at the device-memory rate: the pending scan (task_state and
    task_mask read once), every task-axis field's P rows and the state's
    task_state and task_node rows read once and written once, and the
    [T] tallies written once."""
    from kube_batch_tpu_torch.cache.packer import snapshot_dim_axes

    P, T, R = k4_args[0].shape[0], snap.num_tasks, snap.num_resources
    row_bytes = 8 + sum(getattr(snap, f)[0].numel() * getattr(snap, f).element_size()
                        for f, axes in snapshot_dim_axes().items() if "T" in axes.values())
    nbytes = 5 * T + 2 * P * row_bytes + T * (2 + R) * 4
    return failure_counts_bound(k4_args)[0] + nbytes / HBM_BYTES_PER_S * 1e3


def _tallies_equal(name: str, got: dict, want: dict, rows=None) -> None:
    """Every tally of `got` equal to `want`'s (on `rows` of the per-task
    ones where given)."""
    import torch

    for k, v in got.items():
        w = want[k]
        if rows is not None and v.dim():
            v, w = v[rows], w[rows]
        if not torch.equal(v, w):
            fail(f"subset-diag: {name}: {k} differs")


def phase_subset_diag(finals: dict) -> dict:
    """The active-set diagnosis (`framework/fit_errors.py ·
    failure_counts_subset`, the default window of 2,048 rows) on the final
    states `finals` (label → `final_state`): each path's cycle 2 and a
    parity world's.  Driven under a Recorder with every counter set to 0
    before and read after: the words form (K1 on the gathered rows, K11
    on the full state, K10's words on the rows, K4), the mask form (K10's
    mask on the rows) and a policy whose extra dynamic predicate has no
    subset form.  Then, on the card: (a) each valid window row and
    `nodes` equal the full tallies of the same state (which equal the
    cycle's own), every other row 0; (b) every recorded K1, K11, K10 and
    K4 call equal to its plain version; (c) the mask form equal to the
    words form; (d) the policy without a subset form gives its full
    tallies on every row.  Times the subset call, the full tallies with
    their predicate mask and the cycle's part of them (the mask given),
    by CUDA events and device time, and K1, K4, K10's words and K11 at
    the window beside their plain versions; logs one
    `subset-diag` line.  Returns the phase's launch counts."""
    import copy

    import torch

    from kube_batch_tpu_torch import kernels
    from kube_batch_tpu_torch.api.types import TaskStatus
    from kube_batch_tpu_torch.framework import fit_errors as fe
    from kube_batch_tpu_torch.framework.conf import default_conf
    from kube_batch_tpu_torch.framework.session import build_policy
    from kube_batch_tpu_torch.kernels import affinity as k10
    from kube_batch_tpu_torch.kernels import failure_counts as k4
    from kube_batch_tpu_torch.kernels import predicate_mask as k1
    from kube_batch_tpu_torch.kernels import resident as k11
    from kube_batch_tpu_torch.kernels.affinity import AffinityWords

    t0 = time.perf_counter()
    veto, _ = build_policy(default_conf())
    veto.add_dynamic_predicate_fn(_veto_node0, row_fn=lambda snap, state, p: None)
    masked = {}
    for label, (_snap, _state, _diag, policy) in finals.items():
        # the same policy without the words form of its subset predicates:
        # K4 then takes K10's mask of the window
        masked[label] = copy.copy(policy)
        masked[label].dynamic_predicate_subset_words = [None] * len(
            policy.dynamic_predicate_subsets)
    rec = Recorder({**{name: 10**9 for name in _MUTATED},
                    **{name: 1 for name in SUBSET_KERNELS}})
    out, first = {}, {}
    kernels.reset_counts()
    with rec:
        for label, (snap, state, _diag, policy) in finals.items():
            # each world's calls start here, its words-form call's first
            first[label] = {name: len(rec.calls[name]) for name in SUBSET_KERNELS}
            out[label] = {
                "words": fe.failure_counts_subset(snap, state, policy),
                "mask": fe.failure_counts_subset(snap, state, masked[label]),
                "fallback": fe.failure_counts_subset(snap, state, veto)}
    counts = kernels.counts()
    for name in SUBSET_KERNELS:
        if counts[name] <= 0:
            fail(f"subset-diag: {name} was not launched")
    checks = check_all(rec, SUBSET_KERNELS)                              # (b)
    window = fe.diag_window_rows(fe.MAX_DIAG_EVENTS)
    worlds, window_args = {}, {}
    for label, (snap, state, diag, policy) in finals.items():
        T = snap.num_tasks
        got = out[label]
        full = fe.failure_counts(snap, state, policy.predicate_mask(snap),
                                 policy.auction_dyn_predicate(snap, state, immediate=True))
        _tallies_equal(f"{label}: the full tallies against the cycle's", full, diag)
        pending = torch.nonzero((state.task_state == int(TaskStatus.PENDING))
                                & snap.task_mask).squeeze(1)
        covered = pending[:min(window, T)]
        others = torch.ones(T, dtype=torch.bool, device=snap.device)
        others[covered] = False
        _tallies_equal(f"{label}: the window rows", got["words"], full, covered)  # (a)
        for k in ("predicate_failed", "insufficient", "feasible"):
            if got["words"][k][others].any():
                fail(f"subset-diag: {label}: {k} is not 0 outside the window")
        _tallies_equal(f"{label}: the mask form", got["mask"], got["words"])    # (c)
        vfull = fe.failure_counts(snap, state, veto.predicate_mask(snap),
                                  veto.auction_dyn_predicate(snap, state, immediate=True))
        _tallies_equal(f"{label}: the fallback", got["fallback"], vfull)         # (d)
        if not (vfull["predicate_failed"] > full["predicate_failed"]).any():
            fail(f"subset-diag: {label}: the fallback's veto counted nowhere")
        # the words-form call's K1 and K4 inputs, at the window
        k1_args = rec.calls["predicate_mask"][first[label]["predicate_mask"]][2]
        k4_args = rec.calls["failure_counts"][first[label]["failure_counts"]][2]
        if k4_args[0].shape[0] != min(window, T):
            fail(f"subset-diag: {label}: K4 tallied {k4_args[0].shape[0]} rows")
        pred = policy.predicate_mask(snap)

        def subset():
            return fe.failure_counts_subset(snap, state, policy)

        def full_tallies():
            return fe.failure_counts(snap, state, policy.predicate_mask(snap),
                                     policy.auction_dyn_predicate(snap, state, immediate=True))

        def cycle_tallies():
            return fe.failure_counts(snap, state, pred,
                                     policy.auction_dyn_predicate(snap, state, immediate=True))

        full_bound = failure_counts_bound((
            pred, policy.auction_dyn_predicate(snap, state, immediate=True), snap.task_req,
            state.node_idle, snap.eps, snap.node_mask & snap.node_ready))[0]
        line = {"tasks": T, "nodes": snap.num_nodes, "pending": int(pending.numel()),
                "window_rows": int(covered.numel()), "window": min(window, T),
                "dyn_form": type(k4_args[1]).__name__,
                "rows_predicate_failed": int((got["words"]["predicate_failed"] > 0).sum()),
                "subset_ms": round(time_ms(subset), 4), "subset": device_time(subset),
                "full_ms": round(time_ms(full_tallies), 4), "full": device_time(full_tallies),
                "cycle_tallies_ms": round(time_ms(cycle_tallies), 4),
                "cycle_tallies": device_time(cycle_tallies),
                "k4_window_ms": round(time_ms(lambda: k4.failure_counts(*k4_args)), 4),
                "k4_window": device_time(lambda: k4.failure_counts(*k4_args)),
                "k4_window_plain_ms": round(time_ms(
                    lambda: k4.failure_counts_plain(*k4_args)), 4),
                "k1_window_ms": round(time_ms(lambda: k1.predicate_mask(*k1_args)), 4),
                "k1_window": device_time(lambda: k1.predicate_mask(*k1_args)),
                "k1_window_plain_ms": round(time_ms(
                    lambda: k1.predicate_mask_plain(*k1_args)), 4),
                "subset_bound_ms": round(subset_bound(snap, k4_args), 6),
                "full_bound_ms": round(full_bound, 6)}
        if isinstance(k4_args[1], AffinityWords):
            # the subset predicate's words form: K11 on the full state, K10's
            # words for the window's rows
            wargs = rec.calls["affinity_words"][first[label]["affinity_words"]][2]
            rargs = rec.calls["resident_words"][first[label]["resident_words"]][2]
            line.update({
                "k10_words_window_ms": round(time_ms(lambda: k10.affinity_words(*wargs)), 4),
                "k10_words_window": device_time(lambda: k10.affinity_words(*wargs)),
                "k10_words_window_plain_ms": round(time_ms(
                    lambda: k10.affinity_words_plain(*wargs)), 4),
                "k10_words_window_bound_ms": round(affinity_words_bound(wargs)[0], 6),
                "k11_ms": round(time_ms(lambda: k11.resident_words(*rargs)), 4),
                "k11_plain_ms": round(time_ms(lambda: k11.resident_words_plain(*rargs)), 4),
                "k11_bound_ms": round(bound(_resident_words_bytes(rargs), 0)[0], 6)})
        line["subset_beats_full"] = line["subset_ms"] < line["full_ms"]
        worlds[label] = line
        window_args[label] = (k1_args, k4_args)
    # redesign_order charges the phase's launches at the affinity state's window
    k1_args, k4_args = window_args["affinity"]
    path_time("failure_counts", ("subset_diag",), worlds["affinity"]["k4_window_ms"],
              failure_counts_bound(k4_args)[0])
    path_time("predicate_mask", ("subset_diag",), worlds["affinity"]["k1_window_ms"],
              predicate_bound(k1_args[0])[0][0])
    aff = worlds["affinity"]
    path_time("affinity_words", ("subset_diag",), aff["k10_words_window_ms"],
              aff["k10_words_window_bound_ms"])
    path_time("resident_words", ("subset_diag",), aff["k11_ms"], aff["k11_bound_ms"])
    log(json.dumps({"phase": "subset-diag", "card": CARD.get("line"), "worlds": worlds,
                    "launches": {k: v for k, v in counts.items() if v},
                    "equal_to_plain": True, "checks": checks,
                    "window_equal_full": True, "mask_equal_words": True,
                    "fallback_equal_full": True,
                    "seconds": round(time.perf_counter() - t0, 3)}))
    return counts


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
    admission tier's placements; `JointWindows` counts the device
    operations per joint step by tier kind on 2 × 40 of this run's
    steps (a few tenths of a percent of them, traced).  Returns (launch
    counts, the Recorder of the K12 calls, the cycles)."""
    from kube_batch_tpu_torch import kernels
    from kube_batch_tpu_torch.scheduler import Scheduler

    cache, sim = preempt_world()
    sched = Scheduler(cache, conf=scheduler_conf(), device=device, joint_solve=True)
    windows = JointWindows()
    rec = Recorder({**{name: 10**9 for name in _MUTATED}, **JOINT_EVERY},
                   hooks={"tier_control": windows.hook})
    kernels.reset_counts()
    cycles = []
    for cycle in range(n_cycles):
        windows.cycle = cycle
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
        c["wall_ms"] = wall_ms
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
    log(json.dumps({"phase": "joint-launches", **windows.result()}))
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


# calls traced before a window's count starts, for events the tracer
# misses as it starts
LAUNCH_WARMUP = 4


def _step_kind(seg) -> str | None:
    """"opening" / "continuing" for an eviction step's device events (the
    one K6 kernel it launches says which), else None."""
    for e in seg:
        if "preempt_open" in e.name:
            return "opening"
        if "preempt_continue" in e.name:
            return "continuing"
    return None


def _by_step_kind(segs) -> dict:
    """Device operations per opening and per continuing eviction step,
    over the segments (one a step) that launched K6."""
    out = {}
    for kind in ("opening", "continuing"):
        lens = [len(seg) for seg in segs if _step_kind(seg) == kind]
        if lens:
            out[f"{kind}_steps"] = len(lens)
            out[f"launches_per_{kind}_step"] = round(sum(lens) / len(lens), 3)
    return out


def _ops_per_step(ops, calls, kind: int) -> dict:
    """Device operations per iteration of `kind` in one traced window:
    `ops` the window's device events in time order, `calls` the (kind,
    step) of the K12 calls it holds.  An iteration is everything from
    one K12 kernel to the next; iterations that end their tier (the next
    call starts a tier: step 0) run no step and are left out.  Evict
    iterations are also counted apart as opening and continuing steps.
    The tracer may miss the first events after it starts: the K12
    kernels are matched to the calls from the window's end, and the
    calls whose kernel is missing are not counted.  None when they do not
    match."""
    starts = [i for i, e in enumerate(ops) if "joint_tier" in e.name]
    lost = len(calls) - len(starts)
    if not 0 <= lost <= LAUNCH_WARMUP:
        return None
    calls = calls[lost:]
    steps = kernels = copies = 0
    segs = []
    for i, (k, _step) in enumerate(calls):
        if k != kind or (i + 1 < len(calls) and calls[i + 1][1] == 0):
            continue
        seg = ops[starts[i]:starts[i + 1] if i + 1 < len(starts) else len(ops)]
        segs.append(seg)
        n_copies = sum(1 for e in seg if e.name.startswith(("Memcpy", "Memset")))
        steps, kernels, copies = steps + 1, kernels + len(seg) - n_copies, copies + n_copies
    n = max(steps, 1)
    return {"steps": steps, "kernels_per_step": round(kernels / n, 3),
            "copies_and_memsets_per_step": round(copies / n, 3),
            "launches_per_step": round((kernels + copies) / n, 3), **_by_step_kind(segs)}


class JointWindows:
    """Device operations (kernel launches, and the copies and memsets the
    host issues) per iteration of the joint loop, by tier kind, from two
    windows of one joint run traced by torch.profiler: `steps`
    iterations from the first auction step of cycle `cycles[0]` (the
    cluster filling) and from the first evict step of cycle `cycles[1]`
    (preemption), plus LAUNCH_WARMUP calls for events the tracer misses
    as it starts.  An iteration is its K12 launch, the host read, its
    step and the next iteration's tier masks.  The caller sets `cycle`
    before each cycle and hands `hook` every K12 call's arguments before
    it launches (the Recorder's `hooks`, or a wrapper of
    `tier_control`); `hook` returns true for the calls it traces, and
    `result()` closes a window still open.  The tracer's first start in
    a process takes seconds: it is started once here, before the run it
    counts.  Works on any checkout whose joint loop calls
    `kernels/joint_tier.py · tier_control(kind, gated, step, ...)` once
    an iteration."""

    def __init__(self, steps: int = 40, cycles=(0, 1)) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.steps, self.cycles = steps, cycles
        self.cycle, self.prof, self.kind, self.calls, self.out = 0, None, None, [], {}
        self.traced_s = 0.0
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def hook(self, args) -> bool:
        import torch
        from torch.profiler import ProfilerActivity, profile

        from kube_batch_tpu_torch.kernels import joint_tier

        kind, step = int(args[0]), int(args[2])
        name = "auction" if kind == joint_tier.AUCTION else "evict"
        if (self.prof is None and name not in self.out and step >= 1
                and self.cycle == self.cycles[kind != joint_tier.AUCTION]):
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            self.kind, self.calls, self.t0 = kind, [], time.perf_counter()
        if self.prof is None:
            return False
        if sum(1 for k, _s in self.calls if k == self.kind) >= self.steps + LAUNCH_WARMUP:
            self._close()
            return False
        self.calls.append((kind, step))
        return True

    def _close(self) -> None:
        import torch
        from torch.autograd import DeviceType

        from kube_batch_tpu_torch.kernels import joint_tier

        torch.cuda.synchronize()
        self.prof.stop()
        ops = sorted((e for e in self.prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        name = "auction" if self.kind == joint_tier.AUCTION else "evict"
        self.out[name] = _ops_per_step(ops, self.calls, self.kind)
        self.traced_s += time.perf_counter() - self.t0
        self.prof = None

    def result(self) -> dict:
        """{"auction": ..., "evict": ...}: a window the tracer could not
        match to its calls, or that never opened, is None."""
        if self.prof is not None:
            self._close()
        return {"traced_s": round(self.traced_s, 3),
                **{k: self.out.get(k) for k in ("auction", "evict")}}


class PreemptWindows:
    """Device operations (kernel launches, and the copies and memsets the
    host issues) per step of the sequential preemption loop, from one
    window of a preempt-path run traced by torch.profiler: `steps` steps
    from the `skip`-th K6 call on (past cycle 1's few steps, inside
    cycle 2's preemption), plus LAUNCH_WARMUP calls for events the tracer
    misses as it starts.  Every step launches K6 once (`preempt_open` or
    `preempt_continue`): a step is everything from one K6 kernel to the
    next.  `hook` sees every K6 call before it launches (a wrapper of
    both K6 entries); `result()` closes a window still open.  Works on
    any checkout whose preemption step calls
    `kernels/preempt_scan.py · preempt_open` or `preempt_continue` once."""

    def __init__(self, steps: int = 40, skip: int = 100) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.steps, self.skip, self.seen, self.prof, self.out = steps, skip, 0, None, None
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def hook(self, *_args) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.seen += 1
        if self.seen == self.skip and self.out is None:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
        elif self.prof is not None and self.seen >= self.skip + self.steps + LAUNCH_WARMUP:
            self._close()

    def _close(self) -> None:
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.prof.stop()
        ops = sorted((e for e in self.prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        self.prof = None
        marks = [i for i, e in enumerate(ops) if "preempt_open" in e.name
                 or "preempt_continue" in e.name]
        if len(marks) < 2:
            self.out = {}
            return
        seg = ops[marks[0]:marks[-1]]
        copies = sum(1 for e in seg if e.name.startswith(("Memcpy", "Memset")))
        n = len(marks) - 1
        self.out = {"steps": n, "kernels_per_step": round((len(seg) - copies) / n, 3),
                    "copies_and_memsets_per_step": round(copies / n, 3),
                    "launches_per_step": round(len(seg) / n, 3),
                    **_by_step_kind([ops[a:b] for a, b in zip(marks, marks[1:])])}

    def result(self):
        """{"steps", "kernels_per_step", ...}; None when the window never
        opened, {} when the tracer caught fewer than two steps."""
        if self.prof is not None:
            self._close()
        return self.out


class AuctionWindows:
    """Device operations (kernel launches, and the copies and memsets the
    host issues) per auction round, from one window of a run traced by
    torch.profiler: `rounds` rounds from the `skip`-th K2 pass-1 call on,
    plus LAUNCH_WARMUP calls for events the tracer misses as it starts.
    Every round launches K2's pass-1 kernel (`propose_best_kernel`) once:
    a round is everything from one such kernel to the next (its rank
    sorts, both K2 passes, the resolve, the serialize steps, the apply
    and the progress read).  `hook` sees every `propose_best` call before
    it launches (a wrapper of it); `result()` closes a window still open.
    Works on any checkout whose auction round calls
    `kernels/propose.py · propose_best` once."""

    def __init__(self, rounds: int = 40, skip: int = 6) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.rounds, self.skip, self.seen, self.prof, self.out = rounds, skip, 0, None, None
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def hook(self, *_args) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.seen += 1
        if self.seen == self.skip and self.out is None:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
        elif self.prof is not None and self.seen >= self.skip + self.rounds + LAUNCH_WARMUP:
            self._close()

    def _close(self) -> None:
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.prof.stop()
        ops = sorted((e for e in self.prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        self.prof = None
        marks = [i for i, e in enumerate(ops) if "propose_best_kernel" in e.name]
        if len(marks) < 2:
            self.out = {}
            return
        seg = ops[marks[0]:marks[-1]]
        copies = sum(1 for e in seg if e.name.startswith(("Memcpy", "Memset")))
        n = len(marks) - 1
        by_name: dict = {}
        for e in seg:
            by_name[e.name[:48]] = by_name.get(e.name[:48], 0) + 1
        self.out = {"rounds": n, "kernels_per_round": round((len(seg) - copies) / n, 3),
                    "copies_and_memsets_per_round": round(copies / n, 3),
                    "launches_per_round": round(len(seg) / n, 3),
                    "by_name": {k: round(v / n, 3) for k, v in sorted(
                        by_name.items(), key=lambda kv: -kv[1])}}

    def result(self):
        """{"rounds", "kernels_per_round", ...}; None when the window never
        opened, {} when the tracer caught fewer than two rounds."""
        if self.prof is not None:
            self._close()
        return self.out


def k2_class_term_check(arec: Recorder, best_ms=None, pick_ms=None) -> float:
    """K2 given the class term (K13's table read at each task's class)
    against K2 given the same term gathered to [T, N], on the last
    recorded round of `arec` whose score holds a class term: best, ties,
    active and prop_node equal.  Logs both forms' times (`best_ms`,
    `pick_ms`: the class form's, when already timed) and returns the
    largest error."""
    from kube_batch_tpu_torch.kernels import propose as k2

    def dense_args(a):
        return tuple(a[:10]) + ([e.dense() if isinstance(e, k2.ClassTerm) else e
                                 for e in a[10]],) + tuple(a[11:])

    rounds = [(c, r, a) for c, r, a in arec.calls["propose_best"]
              if any(isinstance(e, k2.ClassTerm) for e in a[10])]
    if not rounds:
        fail("affinity path: no recorded round scored with a class term")
    cycle, rnd, bargs = rounds[-1]
    pargs = next(a for c, r, a in arec.calls["propose_pick"] if (c, r) == (cycle, rnd))
    dargs = dense_args(bargs)
    err = require_equal("propose_best class term against the gathered [T, N] term",
                        list(zip(k2.propose_best(*bargs), k2.propose_best(*dargs))))
    cpa, dpa = with_scratch(pargs), with_scratch(dense_args(pargs))
    err = max(err, require_equal("propose_pick class term against the gathered [T, N] term",
                                 [(k2.propose_pick(*cpa), k2.propose_pick(*dpa))]))
    term = next(e for e in bargs[10] if isinstance(e, k2.ClassTerm))
    log(json.dumps({
        "phase": "k2-class-term", "cycle": cycle, "round": rnd,
        "tasks": bargs[2].shape[0], "nodes": bargs[3].shape[0], "classes": term.table.shape[0],
        "active": int(k2.propose_best(*bargs)[2].sum()), "max_abs_err": err,
        "propose_best_ms": round(best_ms if best_ms is not None
                                 else time_ms(lambda: k2.propose_best(*bargs)), 4),
        "propose_best_dense_ms": round(time_ms(lambda: k2.propose_best(*dargs)), 4),
        "propose_pick_ms": round(pick_ms if pick_ms is not None
                                 else time_ms(lambda: k2.propose_pick(*cpa)), 4),
        "propose_pick_dense_ms": round(time_ms(lambda: k2.propose_pick(*dpa)), 4)}))
    return err


def phase_affinity_kernels(arec: Recorder, row_rec: Recorder, jrec: Recorder):
    """K11 on every call of the affinity path (immediate and FutureIdle
    rounds both met), K10's task words and words on each of their calls
    (a snapshot; a round and a cycle), K2 on every 300th round, K4 on
    both cycles' tallies (the words form), K5 given K10's row operand on
    every opening step of ROW_WORLD's card run (against K5's plain version
    fed the plain row); the row form timed on a recorded operand beside
    K5 with and without it; K10's mask (no path launches it) on the
    tallies' operands of cycle 2, and K4's words form there against the
    parent's chain (the mask, the AND, K4 on the AND); K12 on every
    10th call of the joint path (after auction and evict steps both
    met) and K6 on every continuing step of it, each against its plain
    version; K11 timed on an immediate and
    a FutureIdle round of cycle 2, the rest on cycle 2's inputs of their
    paths; K2 given the words against K2 given K10's mask of the same
    tables (outputs equal, both timed); and K12 on a recorded evict step
    with a plan open, replayed at its step bound (a Discard advance).
    Returns (kernel records, {K2 pass: max abs err on the affinity
    path})."""
    import torch

    from kube_batch_tpu_torch.kernels import affinity as k10
    from kube_batch_tpu_torch.kernels import failure_counts as k4
    from kube_batch_tpu_torch.kernels import joint_tier as k12
    from kube_batch_tpu_torch.kernels import podaff_score as k13
    from kube_batch_tpu_torch.kernels import propose as k2
    from kube_batch_tpu_torch.kernels import resident as k11
    from kube_batch_tpu_torch.kernels import resolve as k3
    from kube_batch_tpu_torch.kernels import victim_prefix as k5

    checks = {}
    for label, rec, names in (("affinity-path", arec, AFFINITY_KERNELS),
                              ("affinity-path-k2", arec, ("propose_best", "propose_pick",
                                                          "resolve", "apply")),
                              ("affinity-path-k4", arec, ("failure_counts",)),
                              ("affinity-path-k7", arec, ("waterfill",)),
                              ("row-world", row_rec, ("victim_prefix",)),
                              ("joint-path", jrec, JOINT_ONLY + ("preempt_continue",
                                                                 "failure_counts",
                                                                 "waterfill"))):
        got = check_all(rec, names)
        log(json.dumps({"phase": f"{label}-kernels", "equal_to_plain": True, **got}))
        checks.update(got)
        for name in names:
            if got[name]["calls"] <= 0:
                fail(f"{label}: no {name} call was recorded")
        if "waterfill" in names and got["waterfill"]["calls"] != got["waterfill"]["calls_made"]:
            fail(f"{label}: not every water-fill call was recorded")
    # every continuing step of the joint path (K6 with p and n on the card)
    # and every cycle's tallies
    for name in ("preempt_continue", "failure_counts"):
        if checks[name]["calls"] != checks[name]["calls_made"]:
            fail(f"joint path: not every {name} call was recorded")
    out = {}

    def record(name, ms, plain_ms, b, library_ms=None, **note):
        out[name] = dict(max_abs_err=checks[name]["max_abs_err"], ms=ms,
                         plain_ms=plain_ms, bound=b, library_ms=library_ms,
                         **{k: v for k, v in note.items() if k.endswith("_ms")})
        log(json.dumps({"phase": "kernel", "name": name, "ms": round(ms, 4),
                        "plain_ms": round(plain_ms, 4),
                        "library_ms": None if library_ms is None else round(library_ms, 4),
                        "bound_ms": round(b[0], 6), "bound_by": b[1], **note}))

    def second_cycle(rec, name):
        last = max(c for c, _r, _a in rec.calls[name])
        return [a for c, _r, a in rec.calls[name] if c == last]

    # the checked calls met both kinds of round (K11) and of step (K12)
    for name, keys in (("resident_words", ("releasing_calls", "future_calls")),
                       ("tier_control", ("after_auction_step", "after_evict_step"))):
        for key in keys:
            if checks[name].get(key, 0) <= 0:
                fail(f"no recorded {name} call with {key} was checked")

    # K11: cycle 2's calls, an immediate round (both resident sets, the
    # line's time) and a FutureIdle round (the future set alone)
    calls = second_cycle(arec, "resident_words")
    k11_rounds = {}
    for now in (True, False):
        args = next(a for a in calls if bool(a[11]) == now)
        require_equal(f"resident_words with_now={now}", resident_pairs(
            k11.resident_words(*args), k11.resident_words_plain(*args)))
        k11_rounds[now] = (args, time_ms(lambda: k11.resident_words(*args)),
                           time_ms(lambda: k11.resident_words_plain(*args)),
                           bound(_resident_words_bytes(args), 0))
    args, ms, plain_ms, b = k11_rounds[True]
    tw, T, N, D = args[0], args[0].shape[0], args[7], args[8]
    record("resident_words", ms, plain_ms, b, tasks=T, nodes=N, domains=D,
           residents=int(k11.resident_mask(args[2], args[1], args[3], True).sum()),
           future_round_ms=round(k11_rounds[False][1], 4),
           future_round_bound_ms=round(k11_rounds[False][3][0], 6))

    # K13: cycle 2's last round (every round's call was checked), timed
    # beside the function in library calls over the class rows ([C, N],
    # the yardstick) and over every task's row ([T, N], the chain each
    # round ran before K13)
    args = second_cycle(arec, "podaff_score")[-1]
    classes = args[0]
    table, _plain = podaff_pair(args)
    lib_cn, lib_tn = podaff_library(args, False), podaff_library(args, True)
    lib_equal = [bool(torch.equal(lib_cn(), table)),
                 bool(torch.equal(lib_tn(), k2.ClassTerm(table, classes.cls).dense()))]
    del _plain
    k13_ms = time_ms(lambda: k13.podaff_score(*args))
    k13_bound = podaff_bound(args)
    path_time("podaff_score", ("affinity",), k13_ms, k13_bound[0])
    record("podaff_score", k13_ms, time_ms(lambda: k13.podaff_score_plain(*args)),
           k13_bound, time_ms(lib_cn),
           library_tn_ms=time_ms(lib_tn, warmup=1, runs=3),
           tasks=classes.cls.shape[0], classes=classes.C, nodes=args[1].shape[0],
           K=classes.rows.shape[1], K2=classes.rows_topo.shape[1],
           nonzero_cells=int((table != 0).sum()), library_equal_cn_tn=lib_equal,
           calls_checked=checks["podaff_score"]["calls"])
    del table

    # K10's task words: cycle 2's snapshot (one call a snapshot)
    args = second_cycle(arec, "affinity_task_words")[0]
    T, K, K2 = args[0].shape[0], args[0].shape[1], args[3].shape[1]
    nw = 3 * k10.words(K) + 2 * k10.words(K2)
    record("affinity_task_words", time_ms(lambda: k10.affinity_task_words(*args)),
           time_ms(lambda: k10.task_words_plain(*args)),
           bound(T * (3 * K + 2 * K2) * 4 + T * nw * 4, T * (3 * K + 2 * K2)),
           tasks=T, words=nw)

    # K10's mask, which no path launches since the tallies take its words:
    # timed on cycle 2's task words call's fields and the tallies' K11
    # build (Idle orientation), the operands the parent's cycle gave it
    tally_words = [a for c, r, a in arec.calls["affinity_words"]
                   if c == max(c2 for c2, _r, _a in arec.calls["affinity_words"])][-1]
    term_key, term_label, nkd, resident = tally_words[1:]
    args = (*second_cycle(arec, "affinity_task_words")[0], term_key, term_label, nkd,
            resident)
    mask_err = require_equal("affinity_mask on the tallies' operands",
                             [(k10.affinity_mask(*args), k10.affinity_mask_plain(*args))])
    checks["affinity_mask"] = {"max_abs_err": mask_err}
    fields = args[:8]
    T, N = fields[0].shape[0], resident.Hb.shape[0]
    KW, K2W = k10.words(K), k10.words(K2)
    in_bytes = (sum(x.numel() * x.element_size() for x in fields)
                + _resident_read_bytes(resident, now=True))
    record("affinity_mask", time_ms(lambda: k10.affinity_mask(*args)),
           time_ms(lambda: k10.affinity_mask_plain(*args), warmup=1, runs=3),
           bound(in_bytes + T * N, T * N * (5 * KW + 4 * K2W)),
           # the plain version's float matrix products are the one-call
           # PyTorch form of this function
           time_ms(lambda: k10.affinity_mask_plain(*args), warmup=1, runs=3),
           cells=T * N, live_words=[KW, K2W])
    mask_fields = fields

    # K4's words form on cycle 2's tallies, against the parent's chain
    # (K10's mask, the AND, K4 on the AND) on the same operands
    fargs = second_cycle(arec, "failure_counts")[-1]
    pred, words_t, rest = fargs[0], fargs[1], fargs[2:]
    tally_mask = k10.affinity_mask(*args)
    chain = (pred & tally_mask, None, *rest)
    k4_err = require_equal("failure_counts words form against the parent's chain",
                           list(zip(k4.failure_counts(*fargs), k4.failure_counts(*chain))))
    k4_ms = time_ms(lambda: k4.failure_counts(*fargs))
    k4_bound = failure_counts_bound(fargs)
    path_time("failure_counts", ("affinity",), k4_ms, k4_bound[0])

    def parent_chain():
        m = k10.affinity_mask(*args)
        return k4.failure_counts(pred & m, None, *rest)

    words_build_ms = time_ms(lambda: k10.affinity_words(*tally_words))
    chain_ms = time_ms(parent_chain)
    log(json.dumps({
        "phase": "k4-words-form", "tasks": T, "nodes": N,
        "words": words_t.node_words.shape[1], "max_abs_err": k4_err,
        "failure_counts_words_ms": round(k4_ms, 4),
        "failure_counts_words_bound_ms": round(k4_bound[0], 6),
        "failure_counts_mask_form_ms": round(time_ms(
            lambda: k4.failure_counts(pred, tally_mask, *rest)), 4),
        "failure_counts_on_and_ms": round(time_ms(lambda: k4.failure_counts(*chain)), 4),
        "affinity_words_ms": round(words_build_ms, 4),
        "tallies_words_ms": round(words_build_ms + k4_ms, 4),
        "parent_chain_ms": round(chain_ms, 4),
        "parent_chain_note": "affinity_mask, the AND, then K4 on the AND"}))

    # K10's words and K2's words form: the last recorded round (cycle 2),
    # its words the first words call of that (cycle, round) (the tallies'
    # comes after the cycle's last round)
    b_cycle, b_round, bargs = arec.calls["propose_best"][-1]
    wargs = next(a for c, r, a in arec.calls["affinity_words"]
                 if (c, r) == (b_cycle, b_round))
    pargs = arec.calls["propose_pick"][-1][2]
    words = bargs[1]
    resident = wargs[4]
    nw = words.node_words.shape[1]
    record("affinity_words", time_ms(lambda: k10.affinity_words(*wargs)),
           time_ms(lambda: k10.affinity_words_plain(*wargs)), affinity_words_bound(wargs),
           tasks=T, nodes=N, words=nw, with_now=resident.with_now)
    mask = k10.affinity_mask(*mask_fields, resident)
    margs = (bargs[0], mask) + tuple(bargs[2:])
    mpargs = (pargs[0], mask) + tuple(pargs[2:])
    best_w = require_equal("propose_best words against mask form", list(zip(
        k2.propose_best(*bargs), k2.propose_best(*margs))))
    pa, mpa = with_scratch(pargs), with_scratch(mpargs)
    pick_w = require_equal("propose_pick words against mask form", [
        (k2.propose_pick(*pa), k2.propose_pick(*mpa))])
    best_ms, best_mask_ms = (time_ms(lambda: k2.propose_best(*bargs)),
                             time_ms(lambda: k2.propose_best(*margs)))
    pick_ms, pick_mask_ms = (time_ms(lambda: k2.propose_pick(*pa)),
                             time_ms(lambda: k2.propose_pick(*mpa)))
    mask_ms = time_ms(lambda: k10.affinity_mask(*mask_fields, resident))
    words_ms = out["affinity_words"]["ms"]
    # the work of this round (the mask form has the same cells)
    _best, _ties, active = k2.propose_best(*margs)
    feas_cells, scan_cells, scan_feas = _work_counts(
        margs, k2.propose_pick(*mpa), active)
    best_bound = propose_best_bound(bargs, feas_cells)
    best_mask_bound = propose_best_bound(margs, feas_cells)
    pick_bound = propose_pick_bound(pargs, scan_cells, scan_feas)
    path_time("propose_best", ("affinity",), best_ms, best_bound[0])
    path_time("propose_pick", ("affinity",), pick_ms, pick_bound[0])
    eligible = int(bargs[6].sum())
    log(json.dumps({
        "phase": "k2-words-form", "tasks": T, "nodes": N, "words": nw,
        "eligible": eligible, "eligible_share": round(eligible / T, 6),
        "request_classes": request_classes(bargs),
        "active": int(active.sum()), "feasible_cells": feas_cells,
        "pick_cells": scan_cells,
        "propose_best_ms": round(best_ms, 4),
        "propose_best_mask_form_ms": round(best_mask_ms, 4),
        "propose_pick_ms": round(pick_ms, 4),
        "propose_pick_mask_form_ms": round(pick_mask_ms, 4),
        "affinity_words_ms": round(words_ms, 4), "affinity_mask_ms": round(mask_ms, 4),
        "resident_words_ms": round(out["resident_words"]["ms"], 4),
        "round_words_ms": round(out["resident_words"]["ms"] + words_ms + best_ms
                                + pick_ms, 4),
        "round_mask_ms": round(out["resident_words"]["ms"] + mask_ms + best_mask_ms
                               + pick_mask_ms, 4),
        "max_abs_err": max(best_w, pick_w),
        # pass 1 reads the predicate mask and the words instead of a mask
        "propose_best_bound_ms": round(best_bound[0], 6),
        "propose_best_bound_by": best_bound[1],
        "propose_best_mask_form_bound_ms": round(best_mask_bound[0], 6),
        "propose_pick_bound_ms": round(pick_bound[0], 6)}))

    class_err = k2_class_term_check(arec)

    # K3 on the same round of the affinity path
    rargs = arec.calls["resolve"][-1][2]
    aargs = arec.calls["apply"][-1][2]
    ka = _fresh_apply_args(aargs)
    for name, fn, b in (("resolve", lambda: k3.resolve(*rargs), resolve_bound(rargs)),
                        ("apply", lambda: k3.apply(*ka), apply_bound(aargs))):
        ms = time_ms(fn)
        path_time(name, ("affinity",), ms, b[0])
        log(json.dumps({"phase": "kernel-affinity-path", "name": name,
                        "proposers": int(rargs[1].sum()),
                        "longest_run": longest_run(rargs),
                        "accepted": int(aargs[2].sum()), "ms": round(ms, 4),
                        "bound_ms": round(b[0], 6), "bound_by": b[1]}))

    # K10's row form, launched on its own, on the operand of the K5 call
    # of ROW_WORLD's cycle 2 whose row vetoes the most nodes (its opening
    # steps test the row inside K5): the row, and K5 with the operand
    # beside K5 alone and beside the parent's sequence (the row, then K5
    # given it)
    k5_args = max(second_cycle(row_rec, "victim_prefix"),
                  key=lambda a: int((~a[11].row()).sum()))   # the row that vetoes most
    op = k5_args[11]
    rargs = (*op.fields, op.resident, op.p, op.task_words)
    row_err = require_equal("affinity_row on a recorded operand",
                            [(k10.affinity_row(*rargs), op.row_plain())])
    nkd, resident = op.fields[7], op.resident
    K, K2, N = op.fields[0].shape[1], op.fields[3].shape[1], resident.N
    KW, K2W = k10.words(K), k10.words(K2)
    row_bytes = (op.task_words.shape[1] * 4 + 2 * K2 * 4 + nkd.numel() * 4
                 + _resident_read_bytes(resident, now=False) + N)
    checks["affinity_row"] = {"max_abs_err": row_err}
    record("affinity_row", time_ms(lambda: k10.affinity_row(*rargs)),
           time_ms(lambda: k10.affinity_row_plain(*rargs[:10])),
           bound(row_bytes, N * (5 * KW + 4 * K2W)),
           # the reference's products of the 0/1 tables for one row are
           # the plain version's form
           time_ms(lambda: k10.affinity_row_plain(*rargs[:10])), nodes=N)
    alone = list(k5_args)
    alone[11] = None
    with_mask = list(k5_args)
    line = {"phase": "k10-row-in-k5", "tasks": k5_args[0].shape[0], "nodes": N,
            "row_vetoed_nodes": int((~op.row_plain()).sum()),
            "k5_with_row_ms": round(time_ms(lambda: k5.victim_prefix(*k5_args)), 4),
            "k5_alone_ms": round(time_ms(lambda: k5.victim_prefix(*alone)), 4)}

    def parent_sequence():
        with_mask[11] = op.row()
        return k5.victim_prefix(*with_mask)

    require_equal("K5 given the row against K5 given the row operand",
                  [(parent_sequence(), k5.victim_prefix(*k5_args))])
    line["row_then_k5_ms"] = round(time_ms(parent_sequence), 4)
    log(json.dumps(line))

    # K12: cycle 2's calls of the joint path, an evict-tier step past a
    # tier's first two (the loop checks its tensors only there) that does
    # not end its tier (the common case; nothing is written in place but
    # the work mask and the read)
    calls = second_cycle(jrec, "tier_control")

    def ends(a):
        return k12.tier_control_plain(*_fresh_tier_args(a))[k12.STEP_FLAGS].item() == 1

    args = next((a for a in sorted(calls, key=lambda a: (a[0] != k12.EVICT, a[2] <= 1))
                 if not ends(a)), calls[0])
    done, args = ends(args), _fresh_tier_args(args)
    record("tier_control", time_ms(lambda: k12.tier_control(*args)),
           time_ms(lambda: k12.tier_control_plain(*args)),
           bound(_tier_control_bytes(args, done), 0),
           kind="evict" if args[0] == k12.EVICT else "auction",
           tasks=args[5].shape[0], done=done)
    # a Discard advance: a recorded evict step with a plan open, replayed
    # at its tier's step bound, so the tier ends and the plan is discarded
    open_plan = next((a for _c, _r, a in jrec.calls["tier_control"]
                      if a[0] == k12.EVICT and a[4] is not None
                      and a[4].dtype != torch.bool and int(a[4][1]) and int(a[12].sum())),
                     None)
    if open_plan is None:
        fail("joint path: no recorded evict step with a plan open")
    discard = list(open_plan)
    discard[3] = discard[2]                     # max_steps = step
    a_k, a_p = _fresh_tier_args(discard), _fresh_tier_args(discard)
    k12.tier_control(*a_k)
    k12.tier_control_plain(*a_p)
    err = require_equal("tier_control Discard advance",
                        [(a_k[i], a_p[i]) for i in _MUTATED["tier_control"]])
    read = a_k[19].tolist()
    if not (read[k12.STEP_FLAGS] and not bool(a_k[12].any())
            and not torch.equal(a_k[15], discard[15])):
        fail("tier_control: the replayed step at its bound did not discard its plan")
    out["tier_control"]["max_abs_err"] = max(out["tier_control"]["max_abs_err"], err)
    log(json.dumps({"phase": "k12-discard", "victims_restored": int(discard[12].sum()),
                    "plan_node": int(discard[4][2]), "read": read, "max_abs_err": err}))
    torch.cuda.synchronize()
    return out, {name: max(checks[name]["max_abs_err"], err) for name, err in
                 (("propose_best", max(best_w, class_err)),
                  ("propose_pick", max(pick_w, class_err)))}


def _resident_read_bytes(resident, now: bool) -> int:
    """Bytes of the K11 tables a K10 call reads: the future tables and,
    `now`, the `_now` ones (each distinct table once), and term_exists."""
    names = ("Hb", "Ab", "Hd", "Ad") + (("Hb_now", "Ab_now", "Hd_now", "Ad_now")
                                          if now else ())
    distinct = {getattr(resident, n).data_ptr(): getattr(resident, n) for n in names
                if getattr(resident, n) is not None}
    return (sum(x.numel() * 4 for x in distinct.values())
            + resident.term_exists.numel() * 4)


def affinity_words_bound(wargs):
    """K10 affinity_words' least time on `wargs`: the kept task words,
    K11's tables and the term arrays read once, the node words and the
    thresholds written once; a bit operation a node-word bit and a
    task-word bit of the aff groups."""
    from kube_batch_tpu_torch.kernels.resident import words

    tw, term_key, term_label, nkd, resident = wargs
    (T, nw), N = tw.shape, resident.Hb.shape[0]
    KW, K2W = words(resident.K), words(resident.K2)
    nbytes = (_resident_read_bytes(resident, now=resident.with_now)
              + nkd.numel() * 4 + (term_key.numel() + term_label.numel()) * 4
              + T * nw * 4 + N * nw * 4 + T * 8)
    return bound(nbytes, N * nw * 32 + T * (KW + K2W) * 32)


def _resident_words_bytes(args) -> int:
    """The bytes one K11 launch on `args` must move: every task's state,
    node and mask; the label, anti and anti-topology words of the
    residents (each row once); the node_key_domain rows of the nodes
    holding them and the term arrays (with topology terms); and every
    table written once."""
    import torch

    from kube_batch_tpu_torch.kernels import resident as k11

    tw, task_node, task_state, task_mask, nkd, term_key, term_label = args[:7]
    N, D, K, K2, now = args[7:12]
    T, KW, K2W = tw.shape[0], k11.words(K), k11.words(K2)
    held = k11.resident_mask(task_state, task_node, task_mask, bool(now))
    n = T * (4 + 4 + 1) + int(held.sum()) * (2 * KW + K2W) * 4
    if K2:
        nodes = int(torch.unique(task_node[held]).numel())
        n += nodes * nkd.shape[1] * 4 + (term_key.numel() + term_label.numel()) * 4
    return n + k11._layout(N, D, KW, bool(now), K2 > 0)[2] * 4


def _tier_control_bytes(args, done: bool) -> int:
    """The bytes one K12 launch on `args` must move, each read or write
    once: the masks its tier's work test reads (task_state, task_mask,
    elig; an evict tier's task_job, tried and starving; a gated auction
    tier's codes), the work mask written, the step it follows (an accept
    mask or seven flags), the phase and the read buffer; and, only when
    the tier ends, the advance (prov read, tried / prov / excl cleared,
    and an open plan's victims restored with their request sum)."""
    import torch

    from kube_batch_tpu_torch.kernels import joint_tier as k12

    kind, gated, step_out, prov, node_future = args[0], args[1], args[4], args[12], args[15]
    T, (N, R) = args[5].shape[0], node_future.shape
    per_task = 4 + 1 + 1 + 1
    if kind == k12.EVICT:
        per_task += 4 + 1
    elif gated:
        per_task += 4
    n = T * per_task + (args[9].shape[0] if kind == k12.EVICT else 0) + 4 + 8 * k12.READ
    plan_open = False
    if step_out is not None:
        n += step_out.numel() * step_out.element_size()
        plan_open = step_out.dtype != torch.bool and bool(int(step_out[1]))
    if done:
        n += T + 2 * T + N + 4
        if plan_open:
            victims = int(prov.sum())
            n += victims * (4 + 4 + 4 + 4 * R) + 2 * 4 * R
    return n


# (ms, bound ms) of a kernel timed at one path's own shapes, by kernel and
# path (filled as the phases time them); redesign_order takes them over
# the kernels line's ms and bound, which are the main path's or, for a
# kernel off it, its own path's
PATH_TIMES: dict = {}


def path_time(name: str, paths, ms: float, bound_ms: float) -> None:
    for p in paths:
        PATH_TIMES.setdefault(name, {})[p] = (ms, bound_ms)


# kernels redesigned for this card, and by which change; a later redesign
# takes the next unmarked kernel of the order
REDESIGNED = {"segment_sum": "PR 5", "segment_count": "PR 5", "preempt_open": "PR 5",
              "lex_push_many": "PR 6", "sort_by_segment": "PR 6",
              "affinity_mask": "PR 6", "affinity_words": "PR 6",
              "tier_control": "PR 7", "resident_words": "PR 7",
              "affinity_task_words": "PR 7", "propose_best": "PR 8", "vtime": "PR 8",
              "victim_prefix": "PR 9", "propose_pick": "PR 9",
              "resolve": "PR 10", "predicate_mask": "PR 10",
              "affinity_row": "PR 11", "apply": "PR 11",
              "preempt_continue": "PR 12", "failure_counts": "PR 12",
              "row_patch": "PR 13", "waterfill": "PR 13", "podaff_score": "PR 17"}


def excess_by_path(k, path_times) -> dict:
    """path → launches × (ms − bound ms) of one kernels-line entry, at
    the path's own shapes where `path_times` has them, else at the
    line's."""
    times = path_times.get(k["name"], {})
    out = {}
    for p, n in k["launches_by_path"].items():
        ms, b = times.get(p, (k["ms"], k["bound_ms"]))
        out[p] = n * (ms - b)
    return out


def redesign_order(kernels_line, path_times=None) -> tuple[list, str | None]:
    """The kernels in the order a redesign should take them: first those
    slower than their library form, largest factor first; then the rest
    by the sum over paths of launches × (ms − bound_ms), the card time
    above the bound over every path's launches, each at its path's own
    shapes where this script times it there (`path_times`, by default
    PATH_TIMES).  Kernels already redesigned are marked; the second
    value names the first that is not."""
    path_times = PATH_TIMES if path_times is None else path_times
    slower = sorted((k for k in kernels_line
                     if k["library_ms"] is not None and k["ms"] > k["library_ms"]),
                    key=lambda k: -k["ms"] / k["library_ms"])
    excess = {k["name"]: excess_by_path(k, path_times) for k in kernels_line}
    rest = sorted((k for k in kernels_line if k not in slower),
                  key=lambda k: -sum(excess[k["name"]].values()))
    order = ([{"name": k["name"], "library_factor": round(k["ms"] / k["library_ms"], 3)}
              for k in slower]
             + [{"name": k["name"],
                 "excess_ms": round(sum(excess[k["name"]].values()), 1),
                 "by_path": {p: round(v, 1) for p, v in excess[k["name"]].items() if v}}
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
    # drives the card (one for the preempt path, three for the parity
    # worlds, whose twins the parity phase waits for), and are stopped on
    # every exit.
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    pool, ppool = ctx.Pool(1), ctx.Pool(3)
    try:
        cpu_preempt = pool.apply_async(preempt_cycles_cpu, (ROOT,))
        cpu_parity = {w: ppool.apply_async(parity_cpu, (ROOT, w))
                      for w in PARITY_WORLDS}
        phase_card_and_build()
        host_link_rate(device)
        edge_errs = phase_edge_inputs(device)
        edge_errs["row_patch"] = phase_k9_edge(device)
        edge_errs["waterfill"] = phase_fill_edge(device)
        edge_errs.update(phase_k8_edge(device))
        edge_errs.update(phase_words_edge(device))
        edge_errs["vtime"] = phase_vtime_edge(device)
        edge_errs["victim_prefix"] = phase_k5_edge(device)
        edge_errs["resolve"] = phase_k3_edge(device)
        edge_errs["predicate_mask"] = phase_k1_edge(device)
        edge_errs["preempt_continue"] = phase_k6_continue_edge(device)
        edge_errs["failure_counts"] = phase_k4_edge(device)
        edge_errs["podaff_score"] = phase_k13_edge(device)
        edge_errs["affinity_row"] = 0.0
        for name, err in (list(phase_k10_row_edge(device).items())
                          + list(phase_k3_apply_edge(device).items())):
            edge_errs[name] = max(edge_errs.get(name, 0.0), err)
        for name, err in phase_k2_edge(device).items():
            edge_errs[name] = max(edge_errs[name], err)
        parity_counts, row_rec, subset_final = phase_parity(cpu_parity)
        # the full-size paths once the parity workers are done: their
        # host times are not shared with the CPU twins
        ppool.close()
        ppool.join()
        counts, rec = phase_main_path(device)
        phase_captured("main", lambda: main_cycles(device), rec.records, rec.seconds)
        records = phase_kernels(rec)
        host_counts, hrec = phase_host_cycle(device)
        phase_captured("host_cycle", lambda: host_cycles(device), hrec.records,
                       hrec.seconds)
        records.update(phase_row_patch(hrec))
        del hrec
        affinity_counts, arec = phase_affinity_path(device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        at_start = torch.cuda.memory_allocated(device)
        phase_captured("affinity", lambda: affinity_cycles(device, timed=1), arec.records,
                       arec.seconds)
        peak = torch.cuda.max_memory_allocated(device)
        log(json.dumps({"phase": "affinity-path-memory", "card": CARD["line"],
                        "max_memory_allocated": peak, "allocated_at_start": at_start,
                        "peak_above_start": peak - at_start,
                        "note": "the captured run's 2 cycles; at start: the recorded "
                                "run's kept inputs"}))
        subset_counts = phase_subset_diag({"main": rec.final, "affinity": arec.final,
                                           f"parity:{SUBSET_WORLD}": subset_final})
        del subset_final
        preempt_counts, prec, pcycles = phase_preempt_path(cpu_preempt)
        phase_captured("preempt", lambda: evict_cycles(device, False, timed=1), pcycles,
                       sum(c["wall_ms"] for c in pcycles) / 1e3, cpu=prec.cpu_cycles)
        records.update(phase_preempt_kernels(prec, pcycles))
        records.update(phase_rank_kernels(rec, prec, counts, preempt_counts, pcycles))
        del rec, prec
        joint_counts, jrec, jcycles = phase_joint_path(device, pcycles)
        phase_captured("joint", lambda: evict_cycles(device, True), jcycles,
                       sum(c["wall_ms"] for c in jcycles) / 1e3)
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
    paths = {"main": counts, "host_cycle": host_counts, "affinity": affinity_counts,
             "preempt": preempt_counts, "joint": joint_counts, "parity": parity_counts,
             "subset_diag": subset_counts}
    # the subset form stays off every cycle path, as in the reference: one
    # predicate mask and one set of tallies a cycle
    for path, n in (("main", 2), ("host_cycle", HOST_CYCLES), ("affinity", 2),
                    ("preempt", 3), ("joint", JOINT_CYCLES)):
        for name in ("predicate_mask", "failure_counts"):
            if paths[path][name] != n:
                fail(f"{path}: {paths[path][name]} {name} launches in {n} cycles")
    kernels_line = []
    for name, (route, source, replaces) in KERNELS.items():
        r = records[name]
        by_path = {p: c[name] for p, c in paths.items()}
        kernels_line.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            **({"library_tn_ms": r["library_tn_ms"]} if "library_tn_ms" in r else {}),
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
