"""Kernel K2's pass 1 on sparse eligibility and kernel K8's one-call
virtual start times, plain versions against the reference package.

On the CPU the wrappers run their plain versions; the CUDA kernels are
held against those versions on the card by chip_smoke.py (its `k2-edge`
and `vtime-edge` phases).  Exact equality throughout:

* `propose_best` / `propose_pick` against the reference's propose half
  (allocate_rounds lines 339-360 and `_round_robin_proposals`) when at
  most 1 % of the rows are eligible — the rows pass 1 walks on the card
  — in the mask form and the affinity-words form, with and without a
  score quantum; rows that are not eligible get the fixed answer;
* `virtual_start_times` against the reference's with up to one segment
  per row, empty and zero-denominator segments and every row invalid
  (sums below 2^24, where the reference's float32 prefix is exact), and
  against a float64 numpy reference where the column totals pass 2^24;
* `virtual_start_times` is one `vtime` call and no `sort_by_segment`
  call of its own, through `rank_fn` under examples/scheduler.conf.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_batch_tpu.api.snapshot import fits as jax_fits
from kube_batch_tpu.framework.policy import (
    virtual_start_times as jax_virtual_start_times,
)
from kube_batch_tpu.ops.assignment import _round_robin_proposals
from kube_batch_tpu_torch.actions.backfill import non_besteffort_eligible
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.framework.conf import parse_conf
from kube_batch_tpu_torch.framework.policy import virtual_start_times
from kube_batch_tpu_torch.framework.session import build_policy
from kube_batch_tpu_torch.kernels import affinity as k10
from kube_batch_tpu_torch.kernels import lex_rank
from kube_batch_tpu_torch.kernels import propose as k2
from kube_batch_tpu_torch.ops.assignment import tie_ordinal
from test_torch_kernels import NEG_INF, Pair, _eq

CONF_PATH = os.path.join(os.path.dirname(__file__), "..", "examples",
                         "scheduler.conf")


def _jax_propose_given(policy, snap, st, eligible):
    """The reference's propose half of an Idle-pass round with the
    eligible rows given."""
    avail = st.node_idle
    fit = jax_fits(snap.task_req[:, None, :], avail[None, :, :], snap.eps)
    feas = policy.predicate_mask(snap) & fit & snap.node_mask[None, :] \
        & eligible[:, None]
    dyn = policy.dynamic_predicate_fn(snap, st, True)
    if dyn is not None:
        feas = feas & dyn
    score = jnp.where(feas, policy.score_fn(snap, st), NEG_INF)
    if policy.score_quantum > 0.0:
        score = jnp.floor(score * (1.0 / policy.score_quantum))
    best = jnp.max(score, axis=1, keepdims=True)
    tied = feas & (score >= best)
    active = jnp.any(feas, axis=1)
    rank = policy.rank_fn(snap, st)
    return dict(best=best[:, 0], ties=tied.sum(axis=1).astype(jnp.int32),
                active=active, prop=_round_robin_proposals(tied, active, rank))


@functools.lru_cache(maxsize=None)
def _sparse_eligible(world: str, stage: str, quantum):
    """About 1 % of the rows (at least two), drawn from the rows the
    reference would find eligible, and the last of them."""
    pair = Pair(world, stage, quantum)
    snap, st, pol = pair.snap, pair.state, pair.policy
    pending = (st.task_state == int(TaskStatus.PENDING)) & snap.task_mask
    base = (pending & non_besteffort_eligible(pol)(snap, st)).numpy()
    rows = np.flatnonzero(base)
    T = base.shape[0]
    rng = np.random.default_rng(T)
    keep = rng.choice(rows, max(2, T // 100), replace=False)
    eligible = np.zeros(T, bool)
    eligible[keep] = True
    eligible[rows[-1]] = True
    assert 2 <= eligible.sum() <= max(2, T // 100) + 1 and eligible.sum() < T
    return eligible


SPARSE_CASES = [
    ("config3", "packed", None, "mask"),
    ("affinity", "packed", None, "mask"),
    ("affinity", "packed", None, "words"),
    ("affinity", "one_round", None, "words"),
    ("quantum", "packed", 0.3, "mask"),
]


@pytest.mark.parametrize("world,stage,quantum,form", SPARSE_CASES)
def test_propose_on_sparse_eligibility_matches_reference(world, stage, quantum, form):
    """Pass 1 and pass 2 with at most 1 % of the rows eligible equal the
    reference's propose half on the same rows; every row that is not
    eligible has the fixed answer (the floored NEG_INF, no tie,
    inactive, node 0)."""
    pair = Pair(world, stage, quantum)
    eligible = _sparse_eligible(world, stage, quantum)
    want = jax.device_get(jax.jit(functools.partial(_jax_propose_given, pair.jpolicy))(
        pair.jsnap, pair.jstate, jnp.asarray(eligible)))

    snap, st, pol = pair.snap, pair.state, pair.policy
    if form == "words":
        dyn = pol.dyn_predicate_words(snap, st, True)
        assert isinstance(dyn, k10.AffinityWords)
    else:
        dyn = pol.dynamic_predicate_fn(snap, st, True)
    spec = pol.score_spec()
    args = (pol.predicate_mask(snap), dyn, snap.task_req, st.node_idle, snap.eps,
            snap.node_mask, torch.from_numpy(eligible), st.node_future, snap.node_cap,
            spec, spec.extra_terms(snap, st), pol.score_quantum)
    best, ties, active = k2.propose_best(*args)
    _eq(best, want["best"], "best")
    _eq(ties, want["ties"], "ties")
    _eq(active, want["active"], "active")
    assert bool(active.any())
    rank = pol.rank_fn(snap, st)
    prop = k2.propose_pick(*args, best, active, tie_ordinal(active, rank, ties))
    act = active.numpy()
    np.testing.assert_array_equal(prop.numpy()[act], np.asarray(want["prop"])[act])
    off = ~eligible
    fixed = np.float32(NEG_INF)
    if pol.score_quantum > 0.0:
        fixed = np.floor(fixed * np.float32(k2.quantum_scale(pol.score_quantum)))
    assert (best.numpy()[off] == fixed).all()
    assert not ties.numpy()[off].any() and not act[off].any()
    assert not prop.numpy()[off].any()


def _vtime_inputs(T: int, S: int, case: str, high: int, seed: int):
    rng = np.random.default_rng(seed)
    R = 4
    seg = rng.integers(-1, S + 1, T).astype(np.int32)
    if case == "empty_segments":
        seg = rng.choice([0, S // 2, S - 1], T).astype(np.int32)
    base_rank = rng.permutation(T).astype(np.int32)
    req = rng.integers(0, high, (T, R)).astype(np.float32)
    valid = rng.random(T) < (0.0 if case == "all_invalid" else 0.7)
    alloc = rng.integers(0, 50000, (S, R)).astype(np.float32)
    denom = rng.integers(1, 90000, (S, R)).astype(np.float32)
    if case == "zero_denominators":
        denom[rng.random((S, R)) < 0.4] = 0.0
        alloc[rng.random((S, R)) < 0.4] = 0.0
    return seg, base_rank, req, valid, alloc, denom


def _port_vtime(seg, base_rank, req, valid, alloc, denom, S):
    return virtual_start_times(
        torch.from_numpy(seg), torch.from_numpy(base_rank), torch.from_numpy(req),
        torch.from_numpy(valid), torch.from_numpy(alloc), torch.from_numpy(denom), S)


@pytest.mark.parametrize("T,S", [(600, 600), (600, 300), (1, 1), (1023, 1023)])
@pytest.mark.parametrize("case", ["mixed", "empty_segments", "zero_denominators",
                                  "all_invalid"])
def test_virtual_start_times_many_segments_match_reference(T, S, case):
    """Up to one segment a row (S = T), empty and zero-denominator
    segments, every row invalid; requests whose column totals stay under
    2^24, so the reference's float32 prefix is exact."""
    inputs = _vtime_inputs(T, S, case, 4000, T + S + len(case))
    assert inputs[2].astype(np.float64).sum(axis=0).max() < 2 ** 24
    want = np.asarray(jax_virtual_start_times(*map(jnp.asarray, inputs), S))
    got = _port_vtime(*inputs, S)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _vtime_float64(seg, base_rank, req, valid, alloc, denom, S):
    """A float64 numpy reference: rows sorted by (clamped segment or S
    when invalid, base rank), the exact prefix of the valid requests of
    earlier rows of the segment, start rounded once to float32, the
    float32 ratio (1e30 or 0 where the denominator is not positive), max
    over dims."""
    key = np.where(valid, np.clip(seg, 0, S - 1), S)
    order = np.lexsort((base_rank, key))
    out = np.zeros(len(seg), np.float32)
    run, prev = np.zeros(req.shape[1]), None
    for i in order:
        if key[i] != prev:
            run, prev = np.zeros(req.shape[1]), key[i]
        s = min(key[i], S - 1)
        start = (alloc[s].astype(np.float64) + run).astype(np.float32)
        den = denom[s]
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(den > 0, start / np.maximum(den, np.float32(1e-9)),
                             np.where(start > 0, np.float32(1e30), np.float32(0.0)))
        out[i] = ratio.astype(np.float32).max()
        if valid[i]:
            run = run + req[i].astype(np.float64)
    return out


@pytest.mark.parametrize("T,S", [(8192, 64), (16385, 3), (2000, 2000)])
def test_virtual_start_times_large_totals_match_float64(T, S):
    """Column totals past 2^24 (where the reference's float32 prefix
    rounds and the port's float64 one does not): equal to the float64
    numpy reference."""
    inputs = _vtime_inputs(T, S, "zero_denominators", 4_000_000, T + S)
    assert inputs[2].astype(np.float64).sum(axis=0).max() > 2 ** 24
    np.testing.assert_array_equal(_port_vtime(*inputs, S).numpy(),
                                  _vtime_float64(*inputs, S))


def test_virtual_start_times_takes_broadcast_denominators():
    """drf hands its cluster-total denominator as an expanded view (row
    stride 0): the same times as from a contiguous copy."""
    seg, base_rank, req, valid, alloc, denom, = _vtime_inputs(500, 40, "mixed", 4000, 3)
    total = torch.from_numpy(denom[0])
    args = [torch.from_numpy(x) for x in (seg, base_rank, req, valid, alloc)]
    got = virtual_start_times(*args, total[None, :].expand(40, 4), 40)
    want = virtual_start_times(*args, total[None, :].expand(40, 4).contiguous(), 40)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_virtual_start_times_is_one_vtime_call(monkeypatch):
    """Under examples/scheduler.conf `rank_fn` makes one `vtime` call per
    vtime key and no `sort_by_segment` call: the sort is vtime's own."""
    pair = Pair("config3", "packed")
    with open(CONF_PATH) as f:
        policy, _ = build_policy(parse_conf(f.read()))
    state = policy.setup_state(pair.snap, pair.state)
    calls = {"vtime": 0, "sort_by_segment": 0}

    def spy(name):
        real = getattr(lex_rank, name)

        def wrapper(*a):
            calls[name] += 1
            return real(*a)

        return wrapper

    for name in calls:
        monkeypatch.setattr(lex_rank, name, spy(name))
    want = policy.rank_fn(pair.snap, state)
    n_vtime = sum(len(fns) for level in (policy.job_vtime, policy.ns_vtime,
                                         policy.queue_vtime) for fns in level)
    assert n_vtime >= 2
    assert calls == {"vtime": n_vtime, "sort_by_segment": 0}
    monkeypatch.undo()
    np.testing.assert_array_equal(policy.rank_fn(pair.snap, state).numpy(), want.numpy())
