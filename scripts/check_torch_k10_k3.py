#!/usr/bin/env python3
"""Build every CUDA kernel of the port and hold K10's row operand (the
preemptor's inter-pod affinity test inside K5's launch, and its row
form) and K3 `apply` (row-parallel float64 sums) against their plain
versions on the card, on chip_smoke.py's edge inputs (`phase_k10_row_edge`,
`phase_k3_apply_edge`); then time both on the calls of the port's paths
and, given a parent checkout, beside the parent's kernels.

    python3 scripts/check_torch_k10_k3.py [--edge-only] [--parent PARENT]

Run from the root of a checkout on a machine with a CUDA card and nvcc
(about ten minutes with PARENT; `--edge-only` stops after the edge phases,
about a minute).  PARENT is the root of a checkout of the parent commit
(for example a `git archive` unpacked into a directory that .gitignore
lists); its resolve.cu, affinity_mask.cu and victim_prefix.cu are built
beside this checkout's.  Prints the card's name and power limit, the
build, one JSON line per edge case, then:

* `k3-apply-timing`: K3 apply on the main path's round that chip_smoke
  times (`_pick_round`), the affinity path's last recorded round, the
  preempt path's round with the most eligible rows, and on
  chip_smoke.k3_apply_inputs' one node holding all 65,536 rows and rows
  spread over 8,192 nodes: this checkout's wrapper, its kernel called
  through ctypes with no wrapper (`this_ctypes`, as the parent's is), the
  plain version, the library form (`chip_smoke.apply_library`) and with
  PARENT the parent's kernel (one thread walking each node's run) —
  every output equal; ms (CUDA events), device ms and operations a call
  (torch.profiler) and host µs a call, beside chip_smoke.apply_bound.
* `k10-row-timing`: on the K5 calls of chip_smoke's ROW_WORLD card run
  (config 5 with affinity at 500 nodes under examples/scheduler.conf),
  the cycle-2 opening step with the most candidate victims: K5 given
  the row operand, K5 alone, the row form launched on its own, and with PARENT the parent's sequence (its row kernels, its
  scratch and output, then its K5 given the row) — the choice equal to
  K5's plain version fed the plain row.
* `opening-step-ab` (with PARENT): ROW_WORLD's 2 cycles on the card in a
  fresh process run from each of PARENT, this checkout, this checkout,
  PARENT, with this checkout's `chip_smoke.PreemptWindows` counting the
  device operations of 40 preemption steps of cycle 2 (opening steps:
  the world's plans find no node); each run's K5, K10 row and K11
  launches; a last line says whether every run made the same decisions.

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


# ---------------------------------------------------------------------------
# K3 apply
# ---------------------------------------------------------------------------

def _parent_apply(lib, args):
    """The parent's kb_apply on fresh copies of what it writes."""
    from kube_batch_tpu_torch.kernels import build

    import chip_smoke

    fn = lib.kb_apply
    fn.argtypes, fn.restype = [P] * 4 + [I] * 5 + [P] * 5, I
    a = chip_smoke._fresh_apply_args(args)
    perm, s_node, accept, req, future, idle, use_future, status, state, node = a
    T, (N, R) = perm.shape[0], future.shape
    stream = build.stream_handle(perm.device)

    def call():
        build.check(fn(build.ptr(perm), build.ptr(s_node), build.ptr(accept), build.ptr(req),
                       int(use_future), int(status), T, N, R, build.ptr(future),
                       build.ptr(idle), build.ptr(state), build.ptr(node), stream),
                    "parent apply")

    return call, a


def _this_apply_ctypes(args):
    """This checkout's kb_apply called as the parent's is, through ctypes
    with no wrapper, on fresh copies of what it writes (the host side of
    the two kernels compared alike)."""
    from kube_batch_tpu_torch.kernels import build
    from kube_batch_tpu_torch.kernels import resolve as k3

    import chip_smoke

    fn = build.function("resolve", "kb_apply", k3._SIGNATURES["kb_apply"])
    a = chip_smoke._fresh_apply_args(args)
    perm, s_node, accept, req, future, idle, use_future, status, state, node = a
    T, (N, R) = perm.shape[0], future.shape
    stream = build.stream_handle(perm.device)
    scratch = k3._apply_scratch_for(perm.device, stream, N)

    def call():
        build.check(fn(perm.data_ptr(), s_node.data_ptr(), accept.data_ptr(),
                       req.data_ptr(), int(use_future), int(status), T, N, R,
                       future.data_ptr(), idle.data_ptr(), state.data_ptr(),
                       node.data_ptr(), scratch.data_ptr(), stream), "apply")

    return call


def apply_timings(cases: dict, libs: dict) -> None:
    import torch

    import chip_smoke

    from kube_batch_tpu_torch.kernels import resolve as k3

    host_device = _k1_k3().host_device
    for name, args in cases.items():
        want = chip_smoke._fresh_apply_args(args)
        k3.apply_plain(*want)
        calls = {}
        for who, fn in (("this", k3.apply), ("plain", k3.apply_plain),
                        ("library", chip_smoke.apply_library)):
            a = chip_smoke._fresh_apply_args(args)
            fn(*a)
            chip_smoke.require_equal(f"apply {name} {who}",
                                     [(a[i], want[i]) for i in (4, 5, 8, 9)])
            a = chip_smoke._fresh_apply_args(args)
            calls[who] = (lambda fn=fn, a=a: fn(*a))
        calls["this_ctypes"] = _this_apply_ctypes(args)
        if "parent_resolve" in libs:
            call, a = _parent_apply(libs["parent_resolve"], args)
            call()
            chip_smoke.require_equal(f"apply {name} parent",
                                     [(a[i], want[i]) for i in (4, 5, 8, 9)])
            calls["parent"] = _parent_apply(libs["parent_resolve"], args)[0]
        perm, s_node, accept = args[:3]
        N = args[4].shape[0]
        real = s_node < N
        b = chip_smoke.apply_bound(args)
        line = {"phase": "k3-apply-timing", "case": name, "tasks": perm.shape[0],
                "nodes": N, "accepted": int(accept.sum()),
                "longest_run": int(torch.bincount(s_node[real]).max()) if bool(real.any())
                else 0, "blocks": -(-perm.shape[0] // 1024),
                "bound_ms": round(b[0], 6), "bound_by": b[1]}
        for who, call in calls.items():
            line[who] = host_device(call)
        print(json.dumps(line), flush=True)


# ---------------------------------------------------------------------------
# K10's row and K5
# ---------------------------------------------------------------------------

def _parent_row_then_k5(libs, k5_args):
    """The parent's opening step: its kb_affinity_row (node words, the
    preemptor's task words and the row: three launches, a scratch, the
    row and the preemptor's index allocated) then its kb_victim_choose
    given the row, through ctypes."""
    import torch

    from kube_batch_tpu_torch.kernels import build, lex_rank
    from kube_batch_tpu_torch.kernels.resident import words

    row_fn = libs["parent_affinity_mask"].kb_affinity_row
    row_fn.argtypes, row_fn.restype = [P] * 16 + [I] * 5 + [P] * 5, I
    k5_fn = libs["parent_victim_prefix"].kb_victim_choose
    k5_fn.argtypes, k5_fn.restype = [P] * 12 + [I] * 5 + [P, P], I
    (victims, task_node, rank, req, future, eps, p, preq_rows, pred, node_ok, excl,
     op) = k5_args
    fields, res = op.fields, op.resident
    T, R = req.shape
    N = future.shape[0]
    K, K2 = fields[0].shape[1], fields[3].shape[1]
    TK = fields[7].shape[1] if K2 else 0
    nw = 3 * words(K) + 2 * words(K2)
    tables = [res.address(n) for n in ("Hb", "Hb", "Ab", "Hd", "Hd", "Ad", "term_exists")]
    dev = req.device
    stream = build.stream_handle(dev)

    def call():
        buf = torch.empty(N * nw + nw + 2, dtype=torch.int32, device=dev)
        p_dev = torch.as_tensor(op.p, device=dev).to(torch.int64).reshape(1)
        row = torch.empty(N, dtype=torch.bool, device=dev)
        build.check(row_fn(*(x.data_ptr() for x in fields), *tables, p_dev.data_ptr(),
                           T, N, K, K2, TK, buf.data_ptr(), buf.data_ptr() + 4 * N * nw,
                           buf.data_ptr() + 4 * (N * nw + nw), row.data_ptr(), stream),
                    "parent affinity_row")
        out = torch.empty(N + 5, dtype=torch.int32, device=dev)
        build.check(k5_fn(victims.data_ptr(), task_node.data_ptr(), rank.data_ptr(),
                          req.data_ptr(), future.data_ptr(), eps.data_ptr(), p.data_ptr(),
                          preq_rows.data_ptr(), pred.data_ptr(), node_ok.data_ptr(),
                          excl.data_ptr(), row.data_ptr(), T, N, R,
                          lex_rank.sort_passes(T, N), 0, out.data_ptr(), stream),
                    "parent victim_prefix")
        return out

    return call


def row_timings(libs: dict) -> None:
    import torch

    import chip_smoke

    from kube_batch_tpu_torch.kernels import affinity as k10
    from kube_batch_tpu_torch.kernels import victim_prefix as k5

    host_device = _k1_k3().host_device
    _cycles, _refused, rec = chip_smoke._run(chip_smoke.ROW_WORLD, "cuda", record=True)
    last = max(c for c, _r, _a in rec.calls["victim_prefix"])
    k5_args = max((a for c, _r, a in rec.calls["victim_prefix"] if c == last),
                  key=lambda a: int(a[0].sum()))
    del rec
    op = k5_args[11]
    if not isinstance(op, k10.AffinityRow):
        chip_smoke.fail("the row world's K5 call carries no affinity row operand")
    want = k5.victim_prefix_plain(*k5_args)
    alone = list(k5_args)
    alone[11] = None
    rargs = (*op.fields, op.resident, op.p, op.task_words)
    row = op.row_plain()
    calls = {"k5_with_row": lambda: k5.victim_prefix(*k5_args),
             "k5_alone": lambda: k5.victim_prefix(*alone),
             "row": lambda: k10.affinity_row(*rargs)}
    chip_smoke.require_equal("K5 given the row operand", [(calls["k5_with_row"](), want)])
    chip_smoke.require_equal("affinity_row", [(calls["row"](), row)])
    if {"parent_affinity_mask", "parent_victim_prefix"} <= libs.keys():
        calls["parent_row_then_k5"] = _parent_row_then_k5(libs, k5_args)
        chip_smoke.require_equal("the parent's row then K5",
                                 [(calls["parent_row_then_k5"](), want)])
    line = {"phase": "k10-row-timing", "tasks": k5_args[0].shape[0],
            "nodes": op.resident.N, "victims": int(k5_args[0].sum()),
            "row_vetoed_nodes": int((~row).sum()), "K": op.resident.K, "K2": op.resident.K2}
    for who, call in calls.items():
        line[who] = host_device(call)
    print(json.dumps(line), flush=True)


# ---------------------------------------------------------------------------
# device operations an opening step, parent against change
# ---------------------------------------------------------------------------

_OPENING = r"""
import importlib.util, json, os, sys
sys.path.insert(0, ".")
import chip_smoke
from kube_batch_tpu_torch import kernels
from kube_batch_tpu_torch.kernels import preempt_scan as k6

spec = importlib.util.spec_from_file_location(
    "ab_launch_counter", os.path.join(sys.argv[1], "chip_smoke.py"))
counter = importlib.util.module_from_spec(spec)
spec.loader.exec_module(counter)
window = counter.PreemptWindows()


def traced(real):
    def wrapper(*args):
        window.hook()
        return real(*args)

    # the wrapper counts its launches on its module's global name
    wrapper.launches = real.launches
    return wrapper


real = (k6.preempt_open, k6.preempt_continue)
k6.preempt_open, k6.preempt_continue = (traced(f) for f in real)
kernels.reset_counts()
cycles, _refused, _rec = chip_smoke._run(chip_smoke.ROW_WORLD, "cuda", record=False)
counts = kernels.counts()
k6.preempt_open, k6.preempt_continue = real
print("RESULT " + json.dumps({
    "step_ops": window.result(),
    "launches": {k: counts[k] for k in ("victim_prefix", "preempt_open", "preempt_continue",
                                         "affinity_row", "resident_words")},
    "decisions": [[sorted(map(list, c["binds"])), sorted(map(list, c["evicted"])),
                   [int(x) for x in c["task_state"]]] for c in cycles]}))
"""


def opening_step_ab(parent: str) -> None:
    outs = []
    for tree in (parent, ROOT, ROOT, parent):
        proc = subprocess.run([sys.executable, "-c", _OPENING, ROOT], cwd=tree,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"{tree}: the row world's run failed")
        line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")][-1]
        r = json.loads(line[len("RESULT "):])
        outs.append(r["decisions"])
        print(json.dumps({"phase": "opening-step-ab",
                          "tree": "parent" if tree == parent else "change",
                          "step_ops": r["step_ops"], "launches": r["launches"]}), flush=True)
    print(json.dumps({"phase": "opening-step-ab",
                      "same_decisions": all(o == outs[0] for o in outs)}), flush=True)
    if any(o != outs[0] for o in outs):
        raise SystemExit("opening-step-ab: the runs decided differently")


# ---------------------------------------------------------------------------

def recorded_apply(device) -> dict:
    """K3 apply's arguments on the main path's timed round, the affinity
    path's last recorded round, the preempt path's round with the most
    eligible rows, and one node holding all 65,536 rows against rows
    spread over 8,192 nodes."""
    import chip_smoke

    _counts, rec = chip_smoke.phase_main_path(device)
    cases = {"main": chip_smoke._pick_round(rec)[0]["apply"]}
    del rec
    _counts, arec = chip_smoke.phase_affinity_path(device)
    cases["affinity"] = arec.calls["apply"][-1][2]
    del arec
    _cycles, prec, _cache, _ssn = chip_smoke.preempt_cycles("cuda", record=True)
    by_round = {}
    for name in ("propose_best", "apply"):
        for cycle, rnd, args in prec.calls[name]:
            by_round.setdefault((cycle, rnd), {})[name] = args
    full = [r for r in by_round.values() if len(r) == 2]
    cases["preempt"] = max(full, key=lambda r: int(r["propose_best"][6].sum()))["apply"]
    del prec
    for case in ("one_node", "spread"):
        cases[f"{case}_65536"] = chip_smoke.k3_apply_inputs(device, case, 65536, 8192, 4)
    return cases


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke

    parent, edge_only = None, False
    while argv:
        if argv[0] == "--parent" and len(argv) > 1:
            parent, argv = os.path.abspath(argv[1]), argv[2:]
        elif argv[0] == "--edge-only":
            edge_only, argv = True, argv[1:]
        else:
            chip_smoke.fail(f"usage: {sys.argv[0]} [--edge-only] [--parent PARENT]")
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false")
    device = torch.device("cuda")
    chip_smoke.phase_card_and_build()
    errs = {**chip_smoke.phase_k10_row_edge(device), **chip_smoke.phase_k3_apply_edge(device)}
    print(json.dumps({"phase": "edge", "max_abs_err": errs}), flush=True)
    if not edge_only:
        libs = {}
        if parent:
            csrc = os.path.join(parent, "kube_batch_tpu_torch", "kernels", "csrc")
            libs = _k1_k3()._build_libs(device, {
                name: os.path.join(csrc, f"{name[len('parent_'):]}.cu")
                for name in ("parent_resolve", "parent_affinity_mask",
                             "parent_victim_prefix")})
        row_timings(libs)
        apply_timings(recorded_apply(device), libs)
        if parent:
            opening_step_ab(parent)
    torch.cuda.synchronize()
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
