"""The plain versions of K6 `preempt_open` and K7 `segment_sum` /
`segment_count` against the reference package, on the CPU.

* `preempt_open_plain` equals the opening step's values of
  kube_batch_tpu/ops/preemption.py · preemption_rounds (lines 149-187:
  any_victim_possible, the eligible set's any(), any_direct_fit and the
  argmin preemptor p_new), computed with the reference's own
  `allocated_mask` and `fits` on seeded numpy inputs, on random steps and
  on the edge inputs chip_smoke.py holds the kernel to on the card
  (nothing eligible, a fit only at the last eligible row and the last
  ready node, a fit at the first cell, no ready node, and a wide step
  with no fit, cut here to T = 2,048, N = 256).
* The plain segment sum equals jax.ops.segment_sum on chip_smoke.py's K7
  edge inputs with integer-valued data (one segment, mostly empty
  segments, every row masked out, one segment holding every row), and on
  non-integer values equals the float64 sum rounded once; the counts
  equal a bincount.  On the CPU the index a call passes changes nothing.

Exact equality throughout.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import chip_smoke  # noqa: E402
from kube_batch_tpu.api.snapshot import allocated_mask, fits  # noqa: E402
from kube_batch_tpu_torch.kernels import preempt_scan as k6  # noqa: E402
from kube_batch_tpu_torch.kernels import segment_sum as k7  # noqa: E402

CPU = torch.device("cpu")
INT32_MAX = np.iinfo(np.int32).max


def reference_open(rank, elig, snap_state, live_state, task_mask, prov, req,
                   future, node_ok, eps):
    """The reference step's opening values, line for line
    (kube_batch_tpu/ops/preemption.py:160-187)."""
    j = [jnp.asarray(x) for x in (rank, elig, snap_state, live_state, task_mask,
                                  prov, req, future, node_ok, eps)]
    rank, elig, snap_state, live_state, task_mask, prov, req, future, node_ok, eps = j
    any_victim_possible = jnp.any(allocated_mask(snap_state) & allocated_mask(live_state)
                                  & task_mask & ~prov)
    any_elig = jnp.any(elig)
    any_direct_fit = jnp.any(fits(req[:, None, :], future[None, :, :], eps)
                             & elig[:, None] & node_ok[None, :])
    p_new = jnp.argmin(jnp.where(elig, rank, INT32_MAX)).astype(jnp.int32)
    return [int(p_new), int(any_elig), int(any_victim_possible), int(any_direct_fit)]


def random_step(seed: int, T: int = 256, N: int = 24, R: int = 4):
    """Ranks with ties, states in every status, dims no task requests
    (their "below eps" test decides), futures around the requests."""
    rng = np.random.default_rng(seed)
    req = rng.integers(1, 6, (T, R)).astype(np.float32) * 1000
    req[:, 2 + seed % 2:] = 0.0
    return [rng.integers(0, 40, T).astype(np.int32), rng.random(T) < 0.3,
            rng.integers(0, 8, T).astype(np.int32), rng.integers(0, 8, T).astype(np.int32),
            rng.random(T) < 0.9, rng.random(T) < 0.2, req,
            rng.integers(-1, 5, (N, R)).astype(np.float32) * 1000, rng.random(N) < 0.7,
            np.full(R, 1e-3, np.float32)]


def _check_open(args, want=None):
    got = k6.preempt_open(*(torch.from_numpy(np.ascontiguousarray(x)) for x in args))
    assert got.dtype == torch.int32
    ref = reference_open(*args)
    assert got.tolist() == ref
    if want is not None:
        assert all(w is None or w == g for w, g in zip(want, ref)), (ref, want)
    return ref


@pytest.mark.parametrize("seed", range(8))
def test_preempt_open_plain_equals_reference_step(seed):
    _check_open(random_step(seed))


EDGE = chip_smoke.k6_edge_inputs(CPU, full=(2048, 256))


@pytest.mark.parametrize("case", sorted(EDGE))
def test_preempt_open_plain_equals_reference_on_edges(case):
    args, want = EDGE[case]
    _check_open([a.numpy() for a in args], want)


K7_EDGE = chip_smoke.k7_edge_inputs(CPU, T=2048, J=128)


@pytest.mark.parametrize("case", sorted(K7_EDGE))
def test_segment_sum_plain_on_edges(case):
    values, seg, S, idx, exact = K7_EDGE[case]
    got = k7.segment_sum(values, seg, S, idx.order, idx.offsets)
    assert torch.equal(got, k7.segment_sum_plain(values, seg, S))
    if exact:
        want = jax.ops.segment_sum(jnp.asarray(values.numpy()), jnp.asarray(seg.numpy()),
                                   num_segments=S + 1)[:S]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        acc = np.zeros((S + 1, values.shape[1]))
        np.add.at(acc, seg.numpy(), values.numpy().astype(np.float64))
        np.testing.assert_array_equal(got.numpy(), acc[:S].astype(np.float32))
    kept = seg < S
    for vals in (kept, kept.int()):
        counts = k7.segment_count(vals, seg, S)
        assert counts.dtype == torch.int32
        np.testing.assert_array_equal(
            counts.numpy(), np.bincount(seg.numpy(), minlength=S + 1)[:S])
