#!/usr/bin/env python3
"""Build every CUDA kernel of the port and hold K9 `row_patch` (the dirty
rows gathered straight into a pinned staging slot, one launch) and K7's
water-fill (`waterfill`, with the queue sums in the same launch) against
their plain versions on the card, on chip_smoke.py's edge inputs
(`phase_k9_edge`, `phase_fill_edge`); then time both on the port's paths
and, given a parent checkout, beside the parent's kernels.

    python3 scripts/check_torch_k9_waterfill.py [--edge-only] [--parent PARENT]

Run from the root of a checkout on a machine with a CUDA card and nvcc
(`--edge-only` stops after the edge phases).  PARENT is the root of a
checkout of the parent commit (for example a `git archive` unpacked into
a directory that .gitignore lists); its row_patch.cu and segment_sum.cu
are built beside this checkout's and its wrappers loaded from their
files, bound to those builds.  Prints the card's name and power limit,
the host link's rate (a 64 MiB pinned copy), one JSON line per edge case,
then:

* `k9-timing`: on the host cycle's largest row patch (chip_smoke's
  `phase_host_cycle`, config 5 full), `_upload`'s patch part — the rows
  padded to their bucket, gathered, staged, copied and launched — as
  this checkout runs it (`IncrementalPacker._row_patch`) and, with PARENT, as the parent ran it (the rows' values
  gathered by fancy indexing, then the parent's wrapper), every result
  equal to the plain version; ms by events, device ms and operations a
  call, host µs a call, beside chip_smoke.row_patch_bound.
* `fill-timing`: `queue_deserved`'s K7 work on the main path's last
  cycle (chip_smoke's `phase_main_path`): this checkout's one launch
  against the parent's `segment_sum` alone and the parent's
  `segment_sum` then `waterfill`; and the fill alone at Q = 1,024 with
  R = 32 (the parent's kernel takes at most 32 columns) and R = 40, and
  at Q = 3, R = 4, against the parent's kernel — every output equal to
  its own tree's plain version (the parent summed queues left to right,
  so past 32 queues the two differ in the last bits; the gap is logged).

Exits non-zero on the first difference.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _blocked in ("jax", "jaxlib", "flax", "kube_batch_tpu"):
    sys.modules[_blocked] = None


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


def parent_modules(device, parent: str) -> dict:
    """The parent's row_patch and segment_sum wrappers, loaded from its
    files and bound to its sources built here (its module `build` swapped
    for one that hands out those libraries)."""
    from kube_batch_tpu_torch.kernels import build

    pk = os.path.join(parent, "kube_batch_tpu_torch", "kernels")
    libs = _k1_k3()._build_libs(device, {
        name: os.path.join(pk, "csrc", f"{name}.cu") for name in ("row_patch", "segment_sum")})
    out = {}
    for name, lib in libs.items():
        mod = _module(f"parent_{name}", os.path.join(pk, f"{name}.py"))
        shim = types.SimpleNamespace(**{k: getattr(build, k) for k in (
            "ptr", "check", "stream_handle")})
        shim.library = lambda _name, lib=lib: lib
        bound = {}

        def function(_name, symbol, argtypes, lib=lib, bound=bound):
            if symbol not in bound:
                fn = getattr(lib, symbol)
                fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
                bound[symbol] = fn
            return bound[symbol]

        shim.function = function
        mod.build = shim
        out[name] = mod
    return out


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------

def k9_timings(device, parents: dict) -> None:
    import numpy as np
    import torch

    import chip_smoke
    from kube_batch_tpu_torch.api.snapshot import bucket
    from kube_batch_tpu_torch.cache.incremental import IncrementalPacker
    from kube_batch_tpu_torch.kernels import row_patch as k9

    _counts, rec = chip_smoke.phase_host_cycle(device)
    bufs, hosts, rows = max((a for _c, _r, a in rec.calls["row_patch"]),
                            key=lambda a: sum(len(r) for r in a[2]))
    del rec
    names = [f"f{i}" for i in range(len(bufs))]
    # the rows as _upload hands them over: sorted and unique, before padding
    patch = {n: np.unique(r) for n, r in zip(names, rows)}
    packer = types.SimpleNamespace(
        _ints=types.SimpleNamespace(arrays=dict(zip(names, hosts))),
        _snap=types.SimpleNamespace(**dict(zip(names, bufs))))
    # every form starts from zeroed buffers
    want = [torch.zeros_like(b, device="cpu") for b in bufs]
    k9.row_patch_plain(want, hosts, rows)

    calls = {"this": lambda: IncrementalPacker._row_patch(packer, patch)}
    if "row_patch" in parents:
        pk9 = parents["row_patch"]

        def parent():
            rows_l, vals_l, nbytes = [], [], 0
            for n, ridx in patch.items():
                kp = bucket(len(ridx), minimum=2)
                if kp != len(ridx):
                    ridx = np.concatenate([ridx, np.full(kp - len(ridx), ridx[0], np.int32)])
                vals = packer._ints.arrays[n][ridx]
                rows_l.append(ridx)
                vals_l.append(vals)
                nbytes += ridx.nbytes + vals.nbytes
            pk9.row_patch(bufs, rows_l, vals_l)
            return nbytes

        calls["parent"] = parent
    sizes = set()
    for who, call in calls.items():
        for b in bufs:
            b.fill_(0)
        sizes.add(call())
        torch.cuda.synchronize()
        chip_smoke.require_equal(f"row_patch {who}", [(b.cpu(), w) for b, w in zip(bufs, want)])
    if len(sizes) != 1:
        raise SystemExit(f"row_patch: the trees count different bytes {sizes}")
    b, parts = chip_smoke.row_patch_bound((bufs, hosts, rows),
                                          chip_smoke.HOST_LINK["bytes_per_s"])
    _line("k9-timing", "host_cycle_largest", calls, fields=len(bufs),
          rows=sum(len(r) for r in rows), h2d_bytes=sizes.pop(),
          bound_ms=round(b[0], 6), bound_by=b[1], **{k: round(v, 6) if isinstance(v, float)
                                                      else v for k, v in parts.items()})


# ---------------------------------------------------------------------------
# K7's water-fill
# ---------------------------------------------------------------------------

def fill_timings(device, parents: dict) -> None:
    import numpy as np
    import torch

    import chip_smoke
    from kube_batch_tpu_torch.kernels import segment_sum as k7

    _counts, rec = chip_smoke.phase_main_path(device)
    args = [a for _c, _r, a in rec.calls["waterfill"]][-1]
    del rec
    w, rows, t, m = args
    Q = w.shape[0]
    want = k7.waterfill_plain(*args)
    calls = {"this": lambda: k7.waterfill(*args)}
    pk7 = parents.get("segment_sum")
    if pk7 is not None:
        vals = torch.where((rows.seg < Q)[:, None], rows.values, 0.0)

        def parent_sum():
            return pk7.segment_sum(vals, rows.seg, Q, rows.order, rows.offsets)

        def parent_chain():
            return pk7.waterfill(w, parent_sum(), t, m)

        calls.update(parent_segment_sum=parent_sum, parent_chain=parent_chain)
        chip_smoke.require_equal("queue_deserved parent chain", [(parent_chain(), want)])
    chip_smoke.require_equal("queue_deserved this", [(calls["this"](), want)])
    b = chip_smoke.waterfill_bound(args)
    _line("fill-timing", "main_path_queue_deserved", calls, rows=rows.values.shape[0],
          queues=Q, bound_ms=round(b[0], 6), bound_by=b[1])
    for Q, R in ((1024, 32), (1024, 40), (3, 4)):
        a = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
             for x in chip_smoke.fill_world(Q, R)]
        stats = {}
        want = k7.waterfill_plain(*a, stats=stats)
        calls = {"this": lambda a=a: k7.waterfill(*a)}
        chip_smoke.require_equal(f"waterfill Q={Q} R={R}", [(calls["this"](), want)])
        extra = {}
        if pk7 is not None and R <= 32:
            # the parent summed the queues strictly left to right: past 32
            # queues its result may differ in the last bits, so it is held
            # against its own plain version
            calls["parent"] = lambda a=a: pk7.waterfill(*a)
            got = calls["parent"]()
            chip_smoke.require_equal(f"waterfill Q={Q} R={R} parent",
                                     [(got, pk7.waterfill_plain(*a))])
            extra["parent_max_abs_diff"] = chip_smoke.max_abs_err([(got, want)])
        b = chip_smoke.waterfill_bound(a)
        _line("fill-timing", f"fill_q{Q}_r{R}", calls, queues=Q, columns=R,
              iterations=stats["iterations"], bound_ms=round(b[0], 6), bound_by=b[1],
              **extra)


# ---------------------------------------------------------------------------

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
    chip_smoke.host_link_rate(device)
    errs = {"row_patch": chip_smoke.phase_k9_edge(device),
            "waterfill": chip_smoke.phase_fill_edge(device)}
    print(json.dumps({"phase": "edge", "max_abs_err": errs}), flush=True)
    if not edge_only:
        parents = parent_modules(device, parent) if parent else {}
        fill_timings(device, parents)
        k9_timings(device, parents)
    torch.cuda.synchronize()
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
