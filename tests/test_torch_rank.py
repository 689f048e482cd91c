"""Kernel K8's and K9's plain versions against the reference package.

Same inputs, made with numpy from a seed, through the JAX function and the
port's counterpart on the CPU (where each wrapper runs its plain
version); exact equality throughout:

* `lex_push` chains (`ops.assignment.rank_from_keys`) against
  `jnp.lexsort` and the reference's `rank_from_keys`, over keys with
  heavy ties, mixed ±0.0, negatives, 1e30 and NaN;
* `lex_push_many` (several keys in one call) against the reference's
  `rank_from_keys` at T = 1, 16,384 and 16,385 (the one-block sort's
  limit and one row past it), with ±0.0, NaN and all-equal keys, and
  `LexOrder`'s queue: `rank_fn` and `job_rank` make one K8 call per run
  of keys between vtime keys;
* `sort_by_segment` against `jnp.lexsort((rank, seg))`, also at 1, 3
  and 512 segments on both sides of the one-block limit, and the digit
  plan of each width;
* `virtual_start_times` against the reference's, with zero-denominator
  segments, empty segments and invalid rows;
* `rank_fn` and `job_rank` against the reference's under the default
  conf and examples/scheduler.conf, on packed and mid-cycle states;
* `row_patch`'s plain version against the reference's `_row_patch`, on
  buffers of every snapshot dtype.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_batch_tpu.actions.fused import make_cycle_solver as jax_cycle_solver
from kube_batch_tpu.api.snapshot import SnapshotTensors as JaxSnapshot
from kube_batch_tpu.cache.incremental import _row_patch as jax_row_patch
from kube_batch_tpu.framework.conf import default_conf as jax_default_conf
from kube_batch_tpu.framework.conf import parse_conf as jax_parse_conf
from kube_batch_tpu.framework.policy import (
    virtual_start_times as jax_virtual_start_times,
)
from kube_batch_tpu.framework.session import build_policy as jax_build_policy
from kube_batch_tpu.ops.assignment import init_state as jax_init_state
from kube_batch_tpu.ops.assignment import rank_from_keys as jax_rank_from_keys
from kube_batch_tpu_torch.api.snapshot import from_numpy
from kube_batch_tpu_torch.framework.conf import default_conf, parse_conf
from kube_batch_tpu_torch.framework.policy import virtual_start_times
from kube_batch_tpu_torch.framework.session import build_policy
from kube_batch_tpu_torch.kernels import lex_rank, row_patch
from kube_batch_tpu_torch.ops.assignment import (
    AllocState,
    LexOrder,
    rank_from_keys,
    sort_by_segment,
)
from test_torch_pack import jax_fields

CONF_PATH = os.path.join(os.path.dirname(__file__), "..", "examples",
                         "scheduler.conf")
SPECIAL = np.array([0.0, -0.0, np.nan, -1.0, 1e30, -1e30, np.inf, -np.inf,
                    2.5, -2.5], np.float32)


def _keys(rng, T: int, n: int) -> list[np.ndarray]:
    """n float32 keys of T rows: small integer ranges (heavy ties), the
    special values, and one column of unique values."""
    out = []
    for i in range(n):
        k = rng.integers(-3, 4, T).astype(np.float32)
        special = rng.random(T) < 0.3
        k[special] = rng.choice(SPECIAL, int(special.sum()))
        if i == 0:
            k = rng.permutation(T).astype(np.float32)
        out.append(k)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_lex_chain_matches_lexsort(seed):
    rng = np.random.default_rng(seed)
    T = int(rng.integers(1, 3000))
    keys = _keys(rng, T, int(rng.integers(1, 6)))
    want = np.asarray(jax_rank_from_keys([jnp.asarray(k) for k in keys], T))
    got = rank_from_keys([torch.from_numpy(k) for k in keys], T)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the chain's order itself, key by key
    order = LexOrder(T, "cpu")
    for i, k in enumerate(keys):
        order.push(torch.from_numpy(k))
        np.testing.assert_array_equal(
            order.perm.numpy(), np.asarray(jnp.lexsort(tuple(keys[: i + 1]))))


def test_lex_push_zeros_and_nans_keep_index_order():
    key = torch.tensor([0.0, -0.0, 0.0, -0.0, float("nan"), -1.0])
    perm, rank = lex_rank.lex_push(torch.arange(6), key)
    assert perm.tolist() == [5, 0, 1, 2, 3, 4]
    assert rank.tolist() == [1, 2, 3, 4, 5, 0]
    np.testing.assert_array_equal(
        perm.numpy(), np.asarray(jnp.lexsort((jnp.asarray(key.numpy()),))))


def _edge_keys(case: str, T: int, rng) -> list[np.ndarray]:
    if case == "zeros":
        return [rng.choice(np.array([0.0, -0.0], np.float32), T)]
    if case == "nans":
        k = rng.integers(-2, 3, T).astype(np.float32)
        k[rng.random(T) < 0.4] = np.nan
        return [k, rng.choice(np.array([0.0, -0.0, np.nan], np.float32), T)]
    if case == "all_equal":
        return [np.full(T, 3.0, np.float32)] * 3
    return _keys(rng, T, 5)


@pytest.mark.parametrize("case", ["zeros", "nans", "all_equal", "mixed"])
@pytest.mark.parametrize("T", [1, 16384, 16385])
def test_lex_push_many_matches_reference(T, case):
    rng = np.random.default_rng(T + len(case))
    keys = _edge_keys(case, T, rng)
    want = np.asarray(jax_rank_from_keys([jnp.asarray(k) for k in keys], T))
    perm, rank = lex_rank.lex_push_many(None, [torch.from_numpy(k) for k in keys])
    assert rank.dtype == torch.int32 and perm.dtype == torch.int64
    np.testing.assert_array_equal(rank.numpy(), want)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jnp.lexsort(tuple(keys))))
    # from a given order: the same as one push after another
    start = torch.from_numpy(rng.permutation(T))
    got = lex_rank.lex_push_many(start, [torch.from_numpy(k) for k in keys])
    one = start
    for k in keys:
        one, one_rank = lex_rank.lex_push(one, torch.from_numpy(k))
    np.testing.assert_array_equal(got[0].numpy(), one.numpy())
    np.testing.assert_array_equal(got[1].numpy(), one_rank.numpy())


@pytest.mark.parametrize("conf", ["default", "scheduler.conf"])
def test_rank_fn_flushes_once_per_run_of_keys(conf, monkeypatch):
    """rank_fn queues its static keys and sorts each run between vtime
    keys in one lex_push_many call; job_rank in one."""
    _jconf, tconf = _confs(conf)
    fields, _ = jax_fields("config3")
    snap = from_numpy(fields, "cpu")
    policy, _ = build_policy(tconf)
    state = policy.setup_state(snap, AllocState(
        task_state=snap.task_state.clone(), task_node=snap.task_node.clone(),
        node_idle=snap.node_idle.clone(), node_future=snap.node_idle.clone()))
    calls = []
    real = lex_rank.lex_push_many

    def counting(perm, keys):
        calls.append(len(keys))
        return real(perm, keys)

    monkeypatch.setattr(lex_rank, "lex_push_many", counting)
    policy.rank_fn(snap, state)
    n_vtime = sum(len(fns) for level in (policy.job_vtime, policy.ns_vtime,
                                         policy.queue_vtime) for fns in level)
    n_static = 1 + sum(len(fns) for level in (policy.task_order, policy.job_order,
                                              policy.namespace_order, policy.queue_order)
                       for fns in level)
    assert sum(calls) == n_static + n_vtime
    assert len(calls) <= n_vtime + 1 < sum(calls)
    calls.clear()
    policy.job_rank(snap, state)
    assert len(calls) == 1


@pytest.mark.parametrize("S", [1, 3, 512])
@pytest.mark.parametrize("T", [8192, 16384, 16385, 40000])
def test_sort_by_segment_widths_match_lexsort(T, S):
    rng = np.random.default_rng(T * 7 + S)
    seg = rng.integers(0, S + 1, T).astype(np.int32)
    rank = rng.permutation(T).astype(np.int32)
    rank[rng.random(T) < 0.2] = 0
    perm, s_seg = sort_by_segment(torch.from_numpy(seg), torch.from_numpy(rank), S)
    want = np.asarray(jnp.lexsort((jnp.asarray(rank), jnp.asarray(seg))))
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(s_seg.numpy(), seg[want])
    code_bytes, bits, passes = lex_rank.sort_plan(T, S)
    key_bits = int((S + 1) * T - 1).bit_length()
    assert bits * passes >= key_bits and bits <= 9 and code_bytes == 4
    if T <= lex_rank.CTA_MAX_T:
        assert bits == 8 and passes == lex_rank.sort_passes(T, S)
    else:
        assert passes == -(-key_bits // 9)


@pytest.mark.parametrize("seed", range(3))
def test_sort_by_segment_matches_lexsort(seed):
    rng = np.random.default_rng(seed)
    T, S = int(rng.integers(1, 4000)), int(rng.integers(1, 12))
    seg = rng.integers(0, S + 1, T).astype(np.int32)
    rank = rng.permutation(T).astype(np.int32)
    rank[rng.random(T) < 0.2] = 0   # ties in both keys
    perm, s_seg = sort_by_segment(torch.from_numpy(seg), torch.from_numpy(rank), S)
    want = np.asarray(jnp.lexsort((jnp.asarray(rank), jnp.asarray(seg))))
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(s_seg.numpy(), seg[want])
    assert lex_rank.sort_passes(T, S) * 8 >= int((S + 1) * T - 1).bit_length()


@pytest.mark.parametrize("case", ["mixed", "zero_denominators", "empty_segments",
                                  "all_invalid"])
def test_virtual_start_times_match_reference(case):
    rng = np.random.default_rng(len(case))
    T, S, R = 600, 7, 4
    seg = rng.integers(0, S, T).astype(np.int32)
    if case == "empty_segments":
        seg = rng.choice([0, 3, 6], T).astype(np.int32)
    base_rank = rng.permutation(T).astype(np.int32)
    req = rng.integers(0, 4000, (T, R)).astype(np.float32)
    valid = rng.random(T) < (0.0 if case == "all_invalid" else 0.7)
    alloc = rng.integers(0, 50000, (S, R)).astype(np.float32)
    denom = rng.integers(1, 90000, (S, R)).astype(np.float32)
    if case in ("zero_denominators", "mixed"):
        denom[1] = 0.0
        denom[2, 1:] = 0.0
        alloc[1, 0] = 0.0
    want = np.asarray(jax_virtual_start_times(
        jnp.asarray(seg), jnp.asarray(base_rank), jnp.asarray(req),
        jnp.asarray(valid), jnp.asarray(alloc), jnp.asarray(denom), S))
    got = virtual_start_times(
        torch.from_numpy(seg), torch.from_numpy(base_rank), torch.from_numpy(req),
        torch.from_numpy(valid), torch.from_numpy(alloc), torch.from_numpy(denom), S)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _confs(name):
    if name == "default":
        return jax_default_conf(), default_conf()
    with open(CONF_PATH) as f:
        text = f.read()
    return jax_parse_conf(text), parse_conf(text)


@pytest.mark.parametrize("stage", ["packed", "after_cycle"])
@pytest.mark.parametrize("conf", ["default", "scheduler.conf"])
@pytest.mark.parametrize("world", ["config3", "oracle"])
def test_rank_fn_and_job_rank_match_reference(world, conf, stage):
    jconf, tconf = _confs(conf)
    fields, _ = jax_fields(world)
    jsnap = JaxSnapshot(**fields)
    jpolicy, _ = jax_build_policy(jconf)
    jstate = jax_init_state(jsnap)
    if stage == "after_cycle":
        jstate = jax.jit(jax_cycle_solver(jpolicy, ("allocate", "backfill")))(
            jsnap, jstate)[0]
    jstate = jpolicy.setup_state(jsnap, jstate)
    want_rank, want_job = jax.device_get(jax.jit(lambda s, st: (
        jpolicy.rank_fn(s, st), jpolicy.job_rank(s, st)))(jsnap, jstate))

    snap = from_numpy(fields, "cpu")
    policy, _ = build_policy(tconf)
    state = policy.setup_state(snap, AllocState(
        task_state=torch.from_numpy(np.array(jstate.task_state)),
        task_node=torch.from_numpy(np.array(jstate.task_node)),
        node_idle=torch.from_numpy(np.array(jstate.node_idle)),
        node_future=torch.from_numpy(np.array(jstate.node_future)),
    ))
    np.testing.assert_array_equal(policy.rank_fn(snap, state).numpy(), want_rank)
    np.testing.assert_array_equal(policy.job_rank(snap, state).numpy(), want_job)


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.bool_, np.int64])
def test_row_patch_plain_matches_reference(dtype):
    rng = np.random.default_rng(np.dtype(dtype).itemsize)
    shapes = [(64,), (64, 3), (16, 5)]
    bufs, rows, vals = [], [], []
    for shape in shapes:
        bufs.append((rng.random(shape) * 100).astype(dtype))
        k = int(rng.integers(1, shape[0] // 2))
        r = np.sort(rng.choice(shape[0], k, replace=False)).astype(np.int32)
        pad = 8 - k % 8 if k % 8 else 0   # bucket padding: row 0 repeated
        v = (rng.random((k,) + shape[1:]) * 100).astype(dtype)
        rows.append(np.concatenate([r, np.full(pad, r[0], np.int32)]))
        vals.append(np.concatenate([v, np.repeat(v[:1], pad, axis=0)]))
    names = [f"f{i}" for i in range(len(shapes))]
    want = jax.device_get(jax_row_patch(
        {n: jnp.asarray(b) for n, b in zip(names, bufs)},
        {n: jnp.asarray(r) for n, r in zip(names, rows)},
        {n: jnp.asarray(v) for n, v in zip(names, vals)}))
    got = [torch.from_numpy(b.copy()) for b in bufs]
    row_patch.row_patch(got, rows, vals)
    for n, g in zip(names, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want[n]), err_msg=n)


def test_row_patch_staging_layout():
    """The staged bytes the kernel reads: one table entry per field,
    16-byte aligned indices and values that decode back to the input."""
    bufs = [torch.zeros(32, 3), torch.zeros(32, dtype=torch.bool)]
    rows = [np.array([4, 9], np.int32), np.array([1, 1], np.int32)]
    vals = [np.arange(6, dtype=np.float32).reshape(2, 3), np.array([True, True])]
    staged = row_patch.stage(bufs, rows, vals)
    table = staged[: 2 * 40].view(np.int64).reshape(2, 5)
    assert table[:, 1].tolist() == [12, 1] and table[:, 2].tolist() == [2, 2]
    for (dst, row_bytes, k, idx_off, val_off), b, r, v in zip(table, bufs, rows, vals):
        assert dst == b.data_ptr() and idx_off % 16 == 0 and val_off % 16 == 0
        np.testing.assert_array_equal(staged[idx_off: idx_off + 4 * k].view(np.int32), r)
        assert staged[val_off: val_off + k * row_bytes].tobytes() == v.tobytes()
