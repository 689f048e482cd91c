"""Kernel K13 (`kernels/podaff_score.py`, its plain version on the CPU):
nodeorder's pod-affinity score as a table of one row per class of
preference rows, against the reference package's, exactly.

* The plain table, gathered by each task's class, against
  kube_batch_tpu/plugins/nodeorder.py · pod_affinity_score (times the
  plugin weight) at each state of the affinity worlds of
  tests/test_torch_affinity.py, and on seeded worlds cut from the small
  config-5 affinity world: no topology-scoped term (K2 = 0), node-level
  terms only, every row its own class (C = T), and both vocabularies
  past one 32-bit word.  Seeded weights are dyadic, so the reference's
  float32 products are exact and the two agree to the last bit.
* The classes against `np.unique(rows, axis=0)`, their denominators
  against the rows summed in ascending order.
* The plain version's order: for arbitrary float32 weights it equals a
  numpy walk over k in ascending order (node terms, then topology terms
  as a sum of their own), which is the kernel's arithmetic.
* K2's plain passes given the class term, bit-identical to the same
  passes given the gathered [T, N] term.
"""

from __future__ import annotations

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from kube_batch_tpu_torch.api.snapshot import from_numpy
from kube_batch_tpu_torch.framework.conf import default_conf
from kube_batch_tpu_torch.framework.session import build_policy
from kube_batch_tpu_torch.kernels import podaff_score as k13
from kube_batch_tpu_torch.kernels import propose as k2
from kube_batch_tpu_torch.kernels import resident as k11
from kube_batch_tpu_torch.ops.assignment import init_state, tie_ordinal
from kube_batch_tpu_torch.plugins import nodeorder, predicates
from test_torch_affinity import WORLDS, _fields, _jax_score_term, _states

SEEDED = ("k2_zero", "node_only", "c_eq_t", "wide")
K_FIELDS = ("task_podlabels", "task_aff", "task_anti", "task_podpref")
K2_FIELDS = ("task_aff_topo", "task_anti_topo", "task_podpref_topo")


def _dyadic(rng, shape, density=0.3):
    """Weights in {0.25, 0.5, ..., 1.75} on `density` of the cells, else 0."""
    w = rng.integers(1, 8, shape).astype(np.float32) * np.float32(0.25)
    return np.where(rng.random(shape) < density, w, np.float32(0)).astype(np.float32)


def _seeded(case: str, seed: int = 0) -> dict:
    """The small config-5 affinity world's fields with seeded preference
    rows (see the module docstring)."""
    f = dict(_fields("config5_affinity_small"))
    rng = np.random.default_rng(seed)
    T, K = f["task_podpref"].shape
    K2 = f["task_podpref_topo"].shape[1]
    if case == "wide":   # K = K2 = 40: new labels carried by some tasks, new terms
        extra, extra2 = 8, 8
        for name in K_FIELDS:
            f[name] = np.concatenate([f[name], np.zeros((T, extra), np.float32)], axis=1)
        carriers = rng.random((T, extra)) < 0.2
        f["task_podlabels"][:, K:] = carriers.astype(np.float32)
        for name in K2_FIELDS:
            f[name] = np.concatenate([f[name], np.zeros((T, extra2), np.float32)], axis=1)
        TK = f["node_key_domain"].shape[1]
        f["topo_term_key"] = np.concatenate(
            [f["topo_term_key"], rng.integers(0, TK, extra2).astype(np.int32)])
        f["topo_term_label"] = np.concatenate(
            [f["topo_term_label"], rng.integers(0, K + extra, extra2).astype(np.int32)])
        K, K2 = K + extra, K2 + extra2
    if case == "k2_zero":
        for name in K2_FIELDS:
            f[name] = np.zeros((T, 0), np.float32)
        f["topo_term_key"] = np.zeros(0, np.int32)
        f["topo_term_label"] = np.zeros(0, np.int32)
        K2 = 0
    f["task_podpref"] = _dyadic(rng, (T, K))
    f["task_podpref_topo"] = (np.zeros((T, K2), np.float32) if case == "node_only"
                              else _dyadic(rng, (T, K2)))
    if case == "c_eq_t":   # every row its own class: row t's base-8 digits in front
        for d in range(4):
            f["task_podpref"][:, d] = ((np.arange(T) >> (3 * d)) & 7) * np.float32(0.25)
    else:   # and a class of all-zero weights
        f["task_podpref"][::7] = 0
        f["task_podpref_topo"][::7] = 0
    return f


def _fields_of(case: str) -> dict:
    return _fields(case) if case in WORLDS else _seeded(case)


def _table(snap, st, weight: float):
    """The plain K13 table of a state, gathered to [T, N]: the plain
    resident words of the state, the snapshot's classes."""
    classes = nodeorder.podpref_classes(snap)
    if classes is None:
        return None, None
    rw = predicates.resident_words(snap, st)
    table = k13.podaff_score(classes, rw.Hb, rw.Hd, snap.node_key_domain,
                             snap.topo_term_key, snap.topo_term_label, weight)
    return classes, k2.ClassTerm(table, classes.cls).dense()


def _check_against_reference(fields, weight: float) -> int:
    jsnap, snap, states = _states(fields)
    want_fn = _jax_score_term("pod_affinity_score")
    nonzero = 0
    for label, jst, st in states:
        before = k13.podaff_score.launches
        classes, got = _table(snap, st, weight)
        assert k13.podaff_score.launches == before        # the CPU runs the plain version
        want = np.float32(weight) * np.asarray(want_fn(jsnap, jst))
        if got is None:
            assert not want.any(), label
            continue
        assert classes.C <= snap.num_tasks
        np.testing.assert_array_equal(got.numpy(), want, err_msg=label)
        nonzero += int((want > 0).sum())
    return nonzero


@pytest.mark.parametrize("weight", [1.0, 0.75])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_table_matches_reference(world, weight):
    nonzero = _check_against_reference(_fields(world), weight)
    if world != "affinity":
        assert nonzero > 0


@pytest.mark.parametrize("case", SEEDED)
def test_seeded_table_matches_reference(case):
    fields = _seeded(case)
    assert _check_against_reference(fields, 1.0) > 0
    snap = from_numpy(fields, "cpu")
    classes = nodeorder.podpref_classes(snap)
    if case == "c_eq_t":
        assert classes.C == snap.num_tasks
    else:
        assert not bool((classes.rows != 0).any(1).all())   # the zero class
    if case == "wide":
        assert classes.rows.shape[1] > 32 and classes.rows_topo.shape[1] > 32


@pytest.mark.parametrize("case", sorted(WORLDS) + list(SEEDED))
def test_classes_match_numpy_unique(case):
    fields = _fields_of(case)
    snap = from_numpy(fields, "cpu")
    classes = nodeorder.podpref_classes(snap)
    rows = np.concatenate([fields["task_podpref"], fields["task_podpref_topo"]], axis=1)
    if not rows.any():
        assert classes is None
        return
    uniq, inverse = np.unique(rows, axis=0, return_inverse=True)
    K = fields["task_podpref"].shape[1]
    np.testing.assert_array_equal(classes.rows.numpy(), uniq[:, :K])
    np.testing.assert_array_equal(classes.rows_topo.numpy(), uniq[:, K:])
    np.testing.assert_array_equal(classes.cls.numpy(), inverse.reshape(-1))
    assert classes.cls.dtype == torch.int32
    def ascending(rows):
        acc = np.zeros(len(rows), np.float32)
        for k in range(rows.shape[1]):
            acc = acc + rows[:, k]
        return acc

    # the node terms' sum plus the topology terms' (when K2 > 0), as the
    # reference's two sums
    total = ascending(uniq[:, :K])
    if uniq.shape[1] > K:
        total = total + ascending(uniq[:, K:])
    np.testing.assert_array_equal(classes.denom.numpy(), np.maximum(total, np.float32(1e-9)))
    assert classes.out.shape == (len(uniq), snap.num_nodes)


@pytest.mark.parametrize("case", sorted(WORLDS) + list(SEEDED))
def test_class_lists_match_numpy_nonzero(case):
    """The kernel's lists (built once a cycle with the classes): each part
    of a class row holds its nonzero weights in ascending k, as
    `np.nonzero` finds them, then (k, +0) for every zero weight in
    ascending k; the counts are the nonzero weights of each part."""
    fields = _fields_of(case)
    classes = nodeorder.podpref_classes(from_numpy(fields, "cpu"))
    if classes is None:
        return
    K = classes.rows.shape[1]
    lists, counts = classes.lists.numpy(), classes.counts.numpy()
    assert lists.dtype == np.int32 and counts.dtype == np.int32
    assert lists.shape == (classes.C, K + classes.rows_topo.shape[1], 2)
    for c in range(classes.C):
        for part, (row, at) in enumerate([(classes.rows[c].numpy(), 0),
                                          (classes.rows_topo[c].numpy(), K)]):
            entries = lists[c, at:at + len(row)]
            (nz,) = np.nonzero(row)
            assert counts[c, part] == len(nz)
            np.testing.assert_array_equal(entries[:len(nz), 0], nz)
            np.testing.assert_array_equal(entries[:len(nz), 1].view(np.float32), row[nz])
            np.testing.assert_array_equal(entries[len(nz):, 0], np.flatnonzero(row == 0))
            assert not entries[len(nz):, 1].any()             # +0, not -0


@pytest.mark.parametrize("K2", [0, 5, 40])
def test_plain_is_k_ordered(K2):
    """Arbitrary float32 weights (sums not exact): the plain table equals
    the kernel's walk written out in numpy."""
    _check_k_ordered(K2, D=9, TK=3, seed=K2)


@pytest.mark.parametrize("case", ["hd_past_shared_memory", "many_topology_keys"])
def test_plain_is_k_ordered_off_the_shared_route(case):
    """The same at the operands the kernel takes off its shared-memory
    route (chip_smoke's `global_route` and `many_keys` cases, cut to a
    few nodes): Hd of 4,200 domains at K = 37 (33,600 bytes of words,
    past the 16 KB it stages), and 96 topology keys."""
    D, TK = (4200, 3) if case == "hd_past_shared_memory" else (9, 96)
    _check_k_ordered(33, D=D, TK=TK, seed=D + TK)


def _check_k_ordered(K2: int, D: int, TK: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    C, N, K = 6, 70, 37
    rows = rng.standard_normal((C, K)).astype(np.float32)
    rows[rng.random((C, K)) < 0.3] = 0
    rows_topo = rng.standard_normal((C, K2)).astype(np.float32)
    hb = rng.random((N, K)) < 0.4
    hd = rng.random((D, K)) < 0.4
    nkd = rng.integers(0, D, (N, TK)).astype(np.int32)
    term_key = rng.integers(0, TK, K2).astype(np.int32)
    term_label = rng.integers(0, K, K2).astype(np.int32)
    t = torch.from_numpy
    lists, counts = k13.class_lists(t(rows), t(rows_topo))
    classes = k13.PrefClasses(
        cls=torch.arange(C, dtype=torch.int32), rows=t(rows), rows_topo=t(rows_topo),
        denom=torch.clamp(k13.ordered_sum(t(np.concatenate([rows, rows_topo], 1))), min=1e-9),
        out=torch.empty((C, N), dtype=torch.float32), lists=lists, counts=counts)
    w = 1.3
    got = k13.podaff_score(classes, k11.pack(t(hb)), k11.pack(t(hd)) if K2 else None,
                           t(nkd), t(term_key), t(term_label), w).numpy()
    denom = classes.denom.numpy()
    present = hd[nkd[:, term_key], term_label[None, :]] if K2 else None
    want = np.empty((C, N), np.float32)
    f32 = np.float32
    for c in range(C):
        for n in range(N):
            raw = f32(0)
            for k in range(K):
                if hb[n, k]:
                    raw = f32(raw + rows[c, k])
            if K2:
                topo = f32(0)
                for k2 in range(K2):
                    if present[n, k2]:
                        topo = f32(topo + rows_topo[c, k2])
                raw = f32(raw + topo)
            want[c, n] = f32(f32(w) * f32(f32(raw / denom[c]) * f32(10)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["config5_affinity_small", "wide", "c_eq_t"])
def test_propose_class_term_matches_dense(case):
    """K2's plain passes given the class term equal the same passes given
    the gathered [T, N] term, in both passes (Idle and FutureIdle) and
    both forms of the dynamic predicate (K10's words and the mask)."""
    _jsnap, snap, states = _states(_fields_of(case))
    policy, _ = build_policy(default_conf())
    spec = policy.score_spec()
    pred = policy.predicate_mask(snap)
    checked = 0
    for label, _jst, st in states:
        st = policy.setup_state(snap, st)
        for use_future in (False, True):
            immediate = not use_future
            avail = st.node_future if use_future else st.node_idle
            eligible = (st.task_state == 0) & snap.task_mask & policy.eligible_fn(snap, st)
            extras = spec.extra_terms(snap, st)
            assert any(isinstance(e, k2.ClassTerm) for e in extras)
            dense = [e.dense() if isinstance(e, k2.ClassTerm) else e for e in extras]
            common = (snap.task_req, avail, snap.eps, snap.node_mask, eligible,
                      st.node_future, snap.node_cap, spec)
            for dyn in (policy.dyn_predicate_words(snap, st, immediate),
                        policy.dynamic_predicate_fn(snap, st, immediate)):
                what = f"{label}, immediate={immediate}, {type(dyn).__name__}"
                best_c = k2.propose_best(pred, dyn, *common, extras, policy.score_quantum)
                best_d = k2.propose_best(pred, dyn, *common, dense, policy.score_quantum)
                for a, b in zip(best_c, best_d):
                    np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=what)
                k = tie_ordinal(best_c[2], policy.rank_fn(snap, st), best_c[1])
                pick_c = k2.propose_pick(pred, dyn, *common, extras, policy.score_quantum,
                                         best_c[0], best_c[2], k)
                pick_d = k2.propose_pick(pred, dyn, *common, dense, policy.score_quantum,
                                         best_d[0], best_d[2], k)
                np.testing.assert_array_equal(pick_c.numpy(), pick_d.numpy(), err_msg=what)
                checked += int(best_c[2].sum())
    assert checked > 0


def test_no_soft_terms_no_term():
    """A snapshot without soft pod-affinity terms: no classes at the
    cycle's setup and no score term (the kernel is never reached)."""
    fields = _fields("config5_affinity_small")
    fields["task_podpref"] = np.zeros_like(fields["task_podpref"])
    fields["task_podpref_topo"] = np.zeros_like(fields["task_podpref_topo"])
    snap = from_numpy(fields, "cpu")
    policy, _ = build_policy(default_conf())
    st = policy.setup_state(snap, init_state(snap))
    assert st.aux[nodeorder.PODPREF_AUX] is None
    assert nodeorder.pod_affinity_score(snap, st) is None
    assert not any(isinstance(e, k2.ClassTerm) for e in policy.score_spec().extra_terms(snap, st))


def _c_parameters(source: str, entry: str) -> list[str]:
    """The parameter types of `extern "C" int entry(...)` in `source`."""
    match = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", source)
    assert match, entry
    return [re.sub(r"\s*\b\w+$", "", p.strip()) for p in match.group(1).split(",")]


def test_kernel_entries_match_their_bindings():
    """The wrapper's ctypes argument types follow the C entries of
    csrc/podaff_score.cu one for one: a pointer or stream as a pointer,
    an int as an int, a float as a float (a binding off by one argument
    would shift every size the kernel reads)."""
    with open(os.path.join(os.path.dirname(k13.__file__), "csrc", "podaff_score.cu")) as f:
        source = f.read()

    def kind(c_type: str):
        if c_type.endswith("*") or c_type == "cudaStream_t":
            return ctypes.c_void_p
        return {"int": ctypes.c_int, "float": ctypes.c_float}[c_type]

    for entry, signature in (("kb_podaff_score", k13._SIGNATURE),
                             ("kb_podaff_plan", k13._PLAN_SIGNATURE)):
        assert [kind(t) for t in _c_parameters(source, entry)] == list(signature), entry
    assert f"const int v[{len(k13.PLAN_FIELDS)}]" in source   # kb_podaff_plan's fields


def test_wrapper_refuses_other_devices():
    """The plain version runs only for CPU tensors: a tensor on any other
    device than the CPU or a CUDA card is refused, not computed."""
    meta = torch.device("meta")
    C, N, K = 3, 8, 32
    rows, rows_topo = torch.zeros((C, K), device=meta), torch.zeros((C, 0), device=meta)
    classes = k13.PrefClasses(
        torch.zeros(4, dtype=torch.int32, device=meta), rows, rows_topo,
        torch.ones(C, device=meta), torch.empty((C, N), device=meta),
        *k13.class_lists(rows, rows_topo))
    i32 = dict(dtype=torch.int32, device=meta)
    before = k13.podaff_score.launches
    with pytest.raises(RuntimeError, match="unsupported device"):
        k13.podaff_score(classes, torch.zeros((N, 1), **i32), None,
                         torch.zeros((N, 0), **i32), torch.zeros(0, **i32),
                         torch.zeros(0, **i32), 1.0)
    assert k13.podaff_score.launches == before
