#!/usr/bin/env python3
"""Build every CUDA kernel of the port and hold K6 `preempt_continue` (a
continuing preemption step's whole classification in one launch, p and n
read on the card) and K4 `failure_counts` (CUDA C++: per-request-class
fit words, K10's affinity words tested in its own tiles) against their
plain versions on the card, on chip_smoke.py's edge inputs
(`phase_k6_continue_edge`, `phase_k4_edge`); then time both on the calls
of the port's paths and, given a parent checkout, beside the parent's
kernels.

    python3 scripts/check_torch_k6_k4.py [--edge-only | --k4-only] [--parent PARENT]

Run from the root of a checkout on a machine with a CUDA card and nvcc
(about twenty minutes with PARENT; `--edge-only` stops after the edge
phases, about a minute; `--k4-only` runs only `k4-timing`, a few
minutes).  PARENT is the root of a checkout of the
parent commit (for example a `git archive` unpacked into a directory
that .gitignore lists); its preempt_scan.cu is built beside this
checkout's, and its Triton `kernels/failure_counts.py` is loaded from its
file.  Prints the card's name and power limit, the build, one JSON line
per edge case, then:

* `k4-timing`: K4 on the main path's cycle-2 tallies (no dynamic
  predicate) and on the affinity path's cycle-2 tallies (K10's words):
  this checkout's wrapper, the plain version, the library form
  (`chip_smoke.failure_counts_library`), the same source built with its
  R == 4 instantiation taken out (`this_any_r`: every R through the
  MAX_R instantiation, `k4_any_r_variant`), and with PARENT the parent's
  Triton kernel on the same predicate (on the affinity path: K10's mask
  ANDed in) — every output equal; on the affinity path also the tallies
  as the cycle now runs them (K10's words build, then K4) against the
  parent's chain (K10's mask, the AND, the parent's K4).  ms (CUDA
  events), device ms and operations a call (torch.profiler) and host µs
  a call, beside chip_smoke.failure_counts_bound.
* `k6-timing`: on the preempt path's cycle-2 continuing step whose node
  holds the most victims, and on chip_smoke.k6_continue_inputs' 65,536
  rows: this checkout's launch (its kept buffer), the plain version, and
  with PARENT the parent's part of the step that this launch replaces
  (its one-block kernel given the host's n, the two casts and the fit
  test) — the four outputs equal.
* `continuing-step-ab` (with PARENT): the preempt path (2 cycles) and
  the joint path (2 cycles) on the card in a fresh process run from each
  of PARENT, this checkout, this checkout, PARENT, with this checkout's
  `chip_smoke.PreemptWindows` counting the device operations of 60
  preemption steps from the first continuing step, and its
  `JointWindows` 40 joint auction iterations of cycle 1 and 40 evict
  iterations of cycle 2, the steps split into opening and continuing
  ones; a last line says whether every run made the same decisions.

Exits non-zero on the first difference.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _blocked in ("jax", "jaxlib", "flax", "kube_batch_tpu"):
    sys.modules[_blocked] = None

P, I = ctypes.c_void_p, ctypes.c_int


def _module(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _k1_k3():
    return _module("check_torch_k1_k3", os.path.join(ROOT, "scripts", "check_torch_k1_k3.py"))


def _line(phase: str, case: str, calls: dict, **extra) -> None:
    host_device = _k1_k3().host_device
    line = {"phase": phase, "case": case, **extra}
    for who, call in calls.items():
        line[who] = host_device(call)
    print(json.dumps(line), flush=True)


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

def k4_any_r_variant():
    """kb_failure_counts of failure_counts.cu built with its R == 4
    instantiation taken out, so that R = 4 runs the MAX_R one (loops
    guarded by the runtime R), bound with the wrapper's argument types."""
    from kube_batch_tpu_torch.kernels import build
    from kube_batch_tpu_torch.kernels import failure_counts as k4

    with open(os.path.join(build.CSRC, "failure_counts.cu")) as f:
        text = f.read()
    old = "if (a.R == 4)"
    if text.count(old) != 1:
        raise RuntimeError(f"{old!r} is not in failure_counts.cu once")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    src = os.path.join(build.BUILD_DIR, "variant_k4_any_r.cu")
    out = os.path.join(build.BUILD_DIR, "variant_k4_any_r.so")
    with open(src, "w") as f:
        f.write(text.replace(old, "if (false)"))
    done = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC, "-o", out,
                           src], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for the any-R variant:\n{done.stdout}{done.stderr}")
    fn = ctypes.CDLL(out).kb_failure_counts
    fn.argtypes, fn.restype = list(k4._SIGNATURE), ctypes.c_int
    return fn


def _with_kernel(fn, call):
    """`call` with the K4 wrapper's bound kernel swapped for `fn`."""
    from kube_batch_tpu_torch.kernels import failure_counts as k4

    def run():
        saved, k4._kernel = k4._kernel, fn
        try:
            return call()
        finally:
            k4._kernel = saved
    return run


def k4_timings(device, parent_k4) -> None:
    import chip_smoke

    from kube_batch_tpu_torch.kernels import affinity as k10
    from kube_batch_tpu_torch.kernels import failure_counts as k4

    _counts, rec = chip_smoke.phase_main_path(device)
    main_args = rec.calls["failure_counts"][-1][2]
    del rec
    _counts, arec = chip_smoke.phase_affinity_path(device)
    last = max(c for c, _r, _a in arec.calls["failure_counts"])
    words_args = [a for c, _r, a in arec.calls["failure_counts"] if c == last][-1]
    tally_words = [a for c, _r, a in arec.calls["affinity_words"] if c == last][-1]
    task_fields = [a for c, _r, a in arec.calls["affinity_task_words"] if c == last][0]
    del arec
    mask_args = (*task_fields, *tally_words[1:])
    any_r = k4_any_r_variant()
    for case, args in (("main", main_args), ("affinity_words", words_args)):
        pred, dyn, rest = args[0], args[1], args[2:]
        mask = None if dyn is None else k10.affinity_mask(*mask_args)
        anded = pred if mask is None else pred & mask
        want = k4.failure_counts_plain(*args)
        calls = {"this": lambda: k4.failure_counts(*args),
                 "plain": lambda: k4.failure_counts_plain(*args),
                 "library": lambda: chip_smoke.failure_counts_library(anded, None, *rest),
                 "this_any_r": _with_kernel(any_r, lambda: k4.failure_counts(*args))}
        for who, call in calls.items():
            chip_smoke.require_equal(f"failure_counts {case} {who}",
                                     list(zip(call(), want)))
        if dyn is not None:
            def tallies():
                return k4.failure_counts(pred, k10.affinity_words(*tally_words), *rest)

            def chain():
                return k4.failure_counts(pred & k10.affinity_mask(*mask_args), None, *rest)

            calls["this_mask_form"] = lambda: k4.failure_counts(pred, mask, *rest)
            calls["this_words_build_then_k4"] = tallies
            calls["chain_mask_and_this_k4"] = chain
            for who in ("this_mask_form", "this_words_build_then_k4",
                        "chain_mask_and_this_k4"):
                chip_smoke.require_equal(f"failure_counts {case} {who}",
                                         list(zip(calls[who](), want)))
        if parent_k4 is not None:
            calls["parent"] = lambda: parent_k4.failure_counts(anded, *rest)
            chip_smoke.require_equal(f"failure_counts {case} parent",
                                     list(zip(calls["parent"](), want[:3])))
            if dyn is not None:
                def parent_chain():
                    return parent_k4.failure_counts(pred & k10.affinity_mask(*mask_args),
                                                    *rest)

                calls["parent_chain"] = parent_chain
        b = chip_smoke.failure_counts_bound(args)
        _line("k4-timing", case, calls, tasks=pred.shape[0], nodes=pred.shape[1],
              R=rest[0].shape[1], form=type(dyn).__name__,
              **chip_smoke.k4_request_classes(rest[0]),
              bound_ms=round(b[0], 6), bound_by=b[1])


# ---------------------------------------------------------------------------
# K6 preempt_continue
# ---------------------------------------------------------------------------

def _parent_continue(lib, args):
    """The part of the parent's continuing step that this launch replaces:
    its one-block kb_preempt_continue given the host's n (an output
    allocated a call), the two casts and the fit test, through ctypes."""
    import torch

    from kube_batch_tpu_torch.kernels import build

    fn = lib.kb_preempt_continue
    fn.argtypes, fn.restype = [I, P, P, P, I, P, P], I
    rank, victims, task_node, task_req, future, eps, p, n = args[:8]
    n_host = int(n)
    stream = build.stream_handle(rank.device)

    def call():
        c = [x.contiguous() for x in (rank, victims, task_node)]
        out = torch.empty(2, dtype=torch.int32, device=rank.device)
        build.check(fn(rank.shape[0], *(x.data_ptr() for x in c), n_host, out.data_ptr(),
                       stream), "parent preempt_continue")
        preq = task_req[p]
        fit_now = torch.all((preq <= future[n_host]) | (preq < eps))
        return out[0].long(), out[1].bool(), fit_now

    return call


def k6_timings(device, libs: dict) -> None:
    import chip_smoke

    from kube_batch_tpu_torch.kernels import preempt_scan as k6

    _cycles, prec, _cache, _ssn = chip_smoke.preempt_cycles("cuda", record=True)
    first = min(c for c, _r, _a in prec.calls["preempt_continue"])
    step = max((a for c, _r, a in prec.calls["preempt_continue"] if c == first),
               key=lambda a: int((a[1] & (a[2] == a[7])).sum()))
    del prec
    wide = chip_smoke.k6_continue_inputs(device, 65536, 8192, "random") + [None]
    for case, args in (("preempt_step", step), ("wide_65536", wide)):
        buf = k6.ContinueBuffer(device)
        want = k6.preempt_continue_plain(*args)
        calls = {"this": lambda: k6.preempt_continue(*args, buf),
                 "plain": lambda: k6.preempt_continue_plain(*args)}
        chip_smoke.require_equal(f"preempt_continue {case}",
                                 list(zip(calls["this"](), want)))
        if "parent_preempt_scan" in libs:
            calls["parent"] = _parent_continue(libs["parent_preempt_scan"], args)
            chip_smoke.require_equal(f"preempt_continue {case} parent",
                                     list(zip(calls["parent"](), want[:3])))
        rank, victims, task_node = args[:3]
        T = rank.shape[0]
        b = chip_smoke.preempt_continue_bound(args)
        _line("k6-timing", case, calls, tasks=T, nodes=args[4].shape[0],
              victims=int(victims.sum()),
              on_node=int((victims & (task_node == args[7])).sum()),
              bound_ms=round(b[0], 6), bound_by=b[1])


# ---------------------------------------------------------------------------
# device operations a continuing step, parent against change
# ---------------------------------------------------------------------------

_STEPS = r"""
import importlib.util, json, os, sys
sys.path.insert(0, ".")
import chip_smoke
from kube_batch_tpu_torch import kernels
from kube_batch_tpu_torch.kernels import joint_tier
from kube_batch_tpu_torch.kernels import preempt_scan as k6
from kube_batch_tpu_torch.scheduler import Scheduler

spec = importlib.util.spec_from_file_location(
    "ab_launch_counter", os.path.join(sys.argv[1], "chip_smoke.py"))
counter = importlib.util.module_from_spec(spec)
spec.loader.exec_module(counter)


def decisions(ssn):
    return [sorted(map(list, ssn.bound)), sorted(map(list, ssn.evicted)),
            [int(x) for x in ssn.host_task_state]]


def run(joint, hook_k6=None, hook_k12=None):
    cache, sim = chip_smoke.preempt_world()
    sched = Scheduler(cache, conf=chip_smoke.scheduler_conf(), device="cuda",
                      joint_solve=joint)
    real = (k6.preempt_open, k6.preempt_continue, joint_tier.tier_control)
    if hook_k6 is not None:
        k6.preempt_open, k6.preempt_continue = (hook_k6(f) for f in real[:2])
    if hook_k12 is not None:
        def traced(*args):
            hook_k12.hook(args)
            return real[2](*args)

        traced.launches = real[2].launches
        joint_tier.tier_control = traced
    out = []
    kernels.reset_counts()
    try:
        for cycle in range(2):
            if hook_k12 is not None:
                hook_k12.cycle = cycle
            ssn = sched.run_once()
            out.append(decisions(ssn))
            sim.tick()
            if cycle == 0:
                chip_smoke.preempt_wave(sim)
        # read while the wrappers (which count on the module names) are in
        counts = kernels.counts()
    finally:
        k6.preempt_open, k6.preempt_continue, joint_tier.tier_control = real
    return out, counts


window = counter.PreemptWindows(steps=60, skip=1)
started = []


def hook_k6(real):
    # the window opens at the first K6 call after the first continuing step
    def wrapper(*args):
        if real.__name__ == "preempt_continue":
            started.append(1)
        if started:
            window.hook()
        return real(*args)

    wrapper.launches = real.launches
    return wrapper


seq, seq_counts = run(False, hook_k6=hook_k6)
seq_ops = window.result()
joint_windows = counter.JointWindows()
joint, joint_counts = run(True, hook_k12=joint_windows)
print("RESULT " + json.dumps({
    "preempt_step_ops": seq_ops, "joint_step_ops": joint_windows.result(),
    "launches": {p: {k: c[k] for k in ("preempt_open", "preempt_continue", "victim_prefix",
                                       "failure_counts")}
                 for p, c in (("preempt", seq_counts), ("joint", joint_counts))},
    "decisions": {"preempt": seq, "joint": joint}}))
"""


def continuing_step_ab(parent: str) -> None:
    outs = []
    for tree in (parent, ROOT, ROOT, parent):
        proc = subprocess.run([sys.executable, "-c", _STEPS, ROOT], cwd=tree,
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"{tree}: the preempt or joint run failed")
        line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")][-1]
        r = json.loads(line[len("RESULT "):])
        outs.append(r["decisions"])
        print(json.dumps({"phase": "continuing-step-ab",
                          "tree": "parent" if tree == parent else "change",
                          "preempt_step_ops": r["preempt_step_ops"],
                          "joint_step_ops": r["joint_step_ops"],
                          "launches": r["launches"]}), flush=True)
    same = all(o == outs[0] for o in outs)
    print(json.dumps({"phase": "continuing-step-ab", "same_decisions": same}), flush=True)
    if not same:
        raise SystemExit("continuing-step-ab: the runs decided differently")


# ---------------------------------------------------------------------------

def main(argv) -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke

    parent, edge_only, k4_only = None, False, False
    while argv:
        if argv[0] == "--parent" and len(argv) > 1:
            parent, argv = os.path.abspath(argv[1]), argv[2:]
        elif argv[0] == "--edge-only":
            edge_only, argv = True, argv[1:]
        elif argv[0] == "--k4-only":
            k4_only, argv = True, argv[1:]
        else:
            chip_smoke.fail(f"usage: {sys.argv[0]} [--edge-only | --k4-only] "
                            "[--parent PARENT]")
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false")
    device = torch.device("cuda")
    chip_smoke.phase_card_and_build()
    if k4_only:
        k4_timings(device, None)
    else:
        errs = {"preempt_continue": chip_smoke.phase_k6_continue_edge(device),
                "failure_counts": chip_smoke.phase_k4_edge(device)}
        print(json.dumps({"phase": "edge", "max_abs_err": errs}), flush=True)
    if not (edge_only or k4_only):
        libs, parent_k4 = {}, None
        if parent:
            pk = os.path.join(parent, "kube_batch_tpu_torch", "kernels")
            libs = _k1_k3()._build_libs(device, {
                "parent_preempt_scan": os.path.join(pk, "csrc", "preempt_scan.cu")})
            parent_k4 = _module("parent_failure_counts", os.path.join(pk, "failure_counts.py"))
        k6_timings(device, libs)
        k4_timings(device, parent_k4)
        if parent:
            continuing_step_ab(parent)
    torch.cuda.synchronize()
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
