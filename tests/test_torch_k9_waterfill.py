"""Kernel K7's water-fill and kernel K9's staging, on the CPU.

* The fill's plain version stops at the first iteration that leaves the
  carry bitwise unchanged: equal, to the bit, to the same iteration run
  all Q + 1 times, on seeded worlds of Q ∈ {3, 64, 257} queues and R ∈
  {4, 40} resource columns (R = 40 is past the old kernel's limit of 32).
* Its queue sums go in blocks of 32 queues, XLA's order for the
  reference's float32 reductions at Q ≤ 32 and at multiples of 32: the
  port's `waterfill_deserved` equals `kube_batch_tpu/ops/waterfill.py`
  exactly at Q = 64 too, where a sum strictly left to right does not.
* The fused form (`RequestRows`: the queue-request rows summed, then
  filled) equals `queue_request` followed by `waterfill_deserved` on the
  config 2 and config 4 snapshots, and on seeded rows.
* `fill_plan` keeps a block's shared memory, its kernel's static part
  included, under SMEM_LIMIT and moves the fill's state to a global
  scratch past one column's worth.
* K9's layout and staging at the row widths of the snapshot's fields
  (1, 3, 12, 16 bytes) and at a destination that is not 16-byte aligned.
"""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_batch_tpu.ops.waterfill import waterfill_deserved as jax_waterfill
from kube_batch_tpu_torch.api.snapshot import from_numpy
from kube_batch_tpu_torch.cache.packer import pack_snapshot_loop
from kube_batch_tpu_torch.kernels import row_patch as k9
from kube_batch_tpu_torch.kernels import segment_sum as k7
from kube_batch_tpu_torch.ops.waterfill import waterfill_deserved
from kube_batch_tpu_torch.plugins.proportion import queue_deserved, queue_request
from test_torch_pack import PACKAGES, build_world


def _world(Q: int, R: int, seed: int):
    """weights, requests, capacity and mask of a seeded fill: some
    queues masked out, capacity near the total request, so some queues
    clamp and the rest share the surplus."""
    rng = np.random.default_rng(seed * 1000 + Q * 7 + R)
    weights = rng.integers(1, 6, Q).astype(np.float32)
    request = (rng.integers(0, 40, (Q, R)) * 1000).astype(np.float32)
    total = (request.sum(axis=0) * rng.uniform(0.4, 1.2, R)).astype(np.float32)
    mask = rng.random(Q) < 0.8
    return weights, request, total, mask


def _all_iterations(weights, request, total, queue_mask):
    """The fill run all Q + 1 iterations, in the plain version's order."""
    Q = weights.shape[0]
    request = torch.where(queue_mask[:, None], request, 0.0)
    deserved = torch.zeros_like(request)
    remaining = total.float()
    unsat = queue_mask[:, None] & torch.ones_like(request, dtype=torch.bool)
    for _ in range(Q + 1):
        w = torch.where(unsat, weights[:, None], 0.0)
        wsum = k7._sum_queues(w)
        inc = torch.where(
            wsum > 0.0, remaining[None, :] * w / torch.clamp(wsum, min=1e-9), 0.0)
        filled = deserved + inc
        hit = filled >= request
        filled = torch.minimum(filled, request)
        spent = k7._sum_queues(filled - deserved)
        deserved, remaining, unsat = (
            filled, torch.clamp(remaining - spent, min=0.0), unsat & ~hit)
    return deserved


@pytest.mark.parametrize("Q", [3, 64, 257])
@pytest.mark.parametrize("R", [4, 40])
def test_fill_fixed_point_exit_is_exact(Q, R):
    args = [torch.from_numpy(x) for x in _world(Q, R, 0)]
    stats = {}
    got = k7.waterfill_plain(*args, stats=stats)
    want = _all_iterations(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert 1 <= stats["iterations"] <= Q + 1
    if Q > 3:
        assert stats["iterations"] < Q + 1     # it did stop early


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("R", [4, 40])
def test_waterfill_matches_reference_at_64_queues(seed, R):
    """Exactly equal to the reference at Q = 64, no tolerance: the queue
    sums are taken in XLA's order there."""
    world = _world(64, R, seed)
    want = np.asarray(jax_waterfill(*(jnp.asarray(x) for x in world)))
    got = waterfill_deserved(*(torch.from_numpy(x) for x in world))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("Q", [5, 32, 64, 1024])
def test_queue_sums_take_xla_order(Q):
    rng = np.random.default_rng(Q)
    x = (rng.random((Q, 4)) * 1000).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: a.sum(axis=0))(x))
    np.testing.assert_array_equal(k7._sum_queues(torch.from_numpy(x)).numpy(), want)


def _snapshot(name: str):
    if name == "config4":
        cl, wl, _ = PACKAGES["torch"]
        cl._uid_counter = itertools.count()
        cache, _ = wl.build_config(4, seed=0)
    else:
        cache, _ = build_world(name, "torch")
    fields, _ = pack_snapshot_loop(cache.snapshot())
    return from_numpy(fields, "cpu")


@pytest.mark.parametrize("world", ["config2", "config4"])
def test_fused_queue_deserved_equals_request_then_fill(world):
    snap = _snapshot(world)
    want = waterfill_deserved(snap.queue_weight, queue_request(snap), snap.cluster_total,
                              snap.queue_mask)
    got = queue_deserved(snap)
    assert snap.num_queues >= 2 and bool((want > 0).any())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_request_rows_sum_then_fill():
    rng = np.random.default_rng(5)
    T, Q, R = 700, 37, 6
    weights, _, total, mask = _world(Q, R, 3)
    values = (rng.integers(0, 64, (T, R)) * 250).astype(np.float32)
    seg = rng.integers(0, Q + 1, T).astype(np.int32)      # Q: row dropped
    t = [torch.from_numpy(x) for x in (weights, values, seg, total, mask)]
    rows = k7.RequestRows(t[1], t[2])
    got = k7.waterfill(t[0], rows, t[3], t[4])
    request = k7.segment_sum_plain(t[1], t[2], Q)
    want = k7.waterfill_plain(t[0], request, t[3], t[4])
    assert torch.equal(got, want) and bool((got > 0).any())


# static: the fused kernel's static shared memory as an H100 build
# reports it (the sum's warp partials and two flags); Q = 880 with 4
# warps fits 48 KB only without it, as do the bands at Q = 1,121, 1,601
# and 2,817
@pytest.mark.parametrize("Q,R,warps,static", [
    (3, 4, 8, 0), (3, 40, 4, 0), (1024, 40, 4, 0), (1024, 4, 1, 0), (5000, 4, 4, 0),
    (100000, 2, 8, 0), (880, 4, 4, 2064), (1121, 4, 4, 2064), (1601, 4, 4, 2064),
    (2817, 4, 4, 2064), (1024, 40, 8, 2064)])
def test_fill_plan_fits_shared_memory(Q, R, warps, static):
    W, smem, floats = k7.fill_plan(Q, R, warps, static)
    NB = -(-Q // 32)
    assert 1 <= W <= max(1, min(warps, R))
    assert (smem == 0) != (floats == 0)
    if smem:
        assert smem == 4 * (33 * NB + 100 * NB * W)
        assert smem + static <= k7.SMEM_LIMIT
        if W < min(warps, R):      # one more warp would not fit
            assert 4 * (33 * NB + 100 * NB * (W + 1)) + static > k7.SMEM_LIMIT
    else:
        assert 4 * (33 * NB + 100 * NB) + static > k7.SMEM_LIMIT
        assert floats == 33 * NB + 100 * NB * W


def test_fill_plan_counts_static_shared_memory():
    """At Q = 880 four warps' state takes 48,496 bytes: it fits 48 KB
    alone, and not beside the fused kernel's 2,064 static bytes."""
    assert k7.fill_plan(880, 4, 4) == (4, 48496, 0)
    assert k7.fill_plan(880, 4, 4, 2064) == (3, 37296, 0)
    assert k7.fill_plan(2817, 4, 4, 2064) == (4, 0, 33 * 89 + 100 * 89 * 4)


def test_row_patch_units_by_row_width():
    """Rows of 1, 3, 12 and 16 bytes copy in units of 1, 1, 4 and 16
    bytes, and a destination off 16-byte alignment narrows the unit."""
    bufs = [torch.zeros(64, dtype=torch.bool), torch.zeros((64, 3), dtype=torch.bool),
            torch.zeros(64, 3), torch.zeros(64, 4), torch.zeros(64 * 4 + 1)[1:].view(64, 4)]
    hosts = [np.zeros(tuple(b.shape), b.numpy().dtype) for b in bufs]
    rows = [np.arange(4, dtype=np.int32)] * len(bufs)
    entries, nbytes, units = k9.layout(bufs, hosts, rows)
    assert [e[6] for e in entries] == [1, 1, 4, 16, 4]
    assert units == 4 * (1 + 3 + 3 + 1 + 4)
    assert [e[7] for e in entries] == [0, 4, 16, 28, 32]
    assert nbytes % 16 == 0 and all(e[4] % 16 == 0 and e[5] % 16 == 0 for e in entries)
    with pytest.raises(ValueError):
        k9.layout([torch.zeros(64, 3)], [np.zeros((64, 4), np.float32)], rows[:1])
