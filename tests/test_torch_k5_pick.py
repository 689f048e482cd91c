"""Kernel K5's one-launch node choice and kernel K2's pass 2 from chunk
summaries, plain versions against the reference package, on the CPU.

On the CPU the wrappers run their plain versions; the CUDA kernels are
held against those versions on the card by chip_smoke.py (its `k5-edge`
and `k2-edge` phases).  Exact equality throughout, on numpy-seeded
inputs:

* `victim_prefix` (the preemptor `p` a tensor, its request row and
  predicate row, node_ok, excl and a dynamic row) against the
  reference's `_min_victims_per_node` followed by choose_node's feasible
  mask and argmin, with the sacrifice-first victim of the chosen node:
  random victims, equal ranks (ties broken by row), nodes tied on k (the
  lowest allowed index wins), no feasible node, a fit with no victim,
  and T above the one-block limit (16,384 rows) at small N;
* `pick_by_chunks_plain`, pass 2's selection from per-chunk (max, ties)
  summaries, against the reference's `_round_robin_proposals` (the
  kernel's chunk, a warp's 32 nodes, and a 256-node tile): N not a
  multiple of the chunk, ties spanning chunks, k = ties - 1, chunks whose
  feasible cells score below the best, the quantum on and off, the mask
  and the affinity-words form; and `propose_pick` on the CPU ignores the
  scratch it is handed.
"""

from __future__ import annotations

import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import chip_smoke  # noqa: E402
from kube_batch_tpu.ops.assignment import _round_robin_proposals  # noqa: E402
from kube_batch_tpu.ops.preemption import (  # noqa: E402
    _min_victims_per_node as jax_min_victims,
)
from kube_batch_tpu_torch.kernels import affinity as k10  # noqa: E402
from kube_batch_tpu_torch.kernels import propose as k2  # noqa: E402
from kube_batch_tpu_torch.kernels import victim_prefix as k5  # noqa: E402
from kube_batch_tpu_torch.ops.assignment import tie_ordinal  # noqa: E402

R = 4
K5_CASES = ("random", "equal_ranks", "tied_k", "no_feasible", "fits_no_victim")


def _k5_inputs(T: int, N: int, case: str, seed: int):
    """numpy arrays of one K5 call: victims on their nodes, their ranks,
    requests, FutureIdle, and the preemptor's node-mask inputs."""
    rng = np.random.default_rng(seed)
    node = rng.integers(-1, N, T).astype(np.int32)
    req = rng.integers(0, 5, (T, R)).astype(np.float32) * 1000
    future = rng.integers(-6, 3, (N, R)).astype(np.float32) * 1000
    rank = rng.permutation(T).astype(np.int32)
    victims = (rng.random(T) < 0.6) & (node >= 0)
    p = int(rng.integers(0, T))
    req[p] = rng.integers(1, 6, R) * 1000
    if case == "equal_ranks":
        rank = rng.integers(0, max(1, T // 8), T).astype(np.int32)
    elif case == "tied_k":
        node = (np.arange(T) % max(1, min(N, T // 8))).astype(np.int32)
        victims = np.ones(T, bool)
        req[:] = 1000.0
        future[:] = -1000.0
    elif case == "no_feasible":
        req[p] = 1e9
    elif case == "fits_no_victim":
        future[rng.random(N) < 0.2] = 1e6
    victims[p] = False
    return dict(victims=victims, node=node, rank=rank, req=req, future=future, p=p,
                pred=rng.random((T, N)) < 0.85, node_ok=rng.random(N) < 0.9,
                excl=rng.random(N) < 0.1, dyn=rng.random(N) < 0.9)


def _reference_choice(x, eps):
    """The reference's node choice: `_min_victims_per_node`, then
    choose_node's feasible mask and argmin; the chosen node's
    sacrifice-first victim (highest rank, lowest row on ties)."""
    snap = types.SimpleNamespace(task_node=jnp.asarray(x["node"]),
                                 task_req=jnp.asarray(x["req"]))
    preq = x["req"][x["p"]]
    k = np.asarray(jax_min_victims(snap, jnp.asarray(x["future"]), jnp.asarray(x["victims"]),
                                   jnp.asarray(-x["rank"]), jnp.asarray(preq),
                                   jnp.asarray(eps)))
    # A node with no candidate victim and no fit gets INT32_MAX from the
    # reference's segment_min (its empty segment) where the port writes
    # BIG_K, as the reference's docstring says; both read only as k >=
    # BIG_K (ROADMAP §C).
    k = np.where(k >= k5.BIG_K, k5.BIG_K, k).astype(np.int32)
    feasible = (k < k5.BIG_K) & x["pred"][x["p"]] & x["node_ok"] & x["dyn"] & ~x["excl"]
    kk = np.where(feasible, k, k5.BIG_K)
    n_best = int(np.argmax(feasible & (kk == kk.min())))
    on_n = x["victims"] & (x["node"] == n_best)
    first = 0
    if on_n.any():
        rows = np.flatnonzero(on_n)
        first = int(rows[np.argmax(x["rank"][rows])])   # argmax: the lowest row of a tie
    fits0 = bool(np.all((preq <= x["future"][n_best]) | (preq < eps)))
    return k, [n_best, int(feasible.any()), first, int(on_n.any()), int(fits0)]


@pytest.mark.parametrize("T,N", [(96, 12), (20000, 16)])
@pytest.mark.parametrize("case", K5_CASES)
def test_victim_prefix_matches_reference_choice(case, T, N):
    x = _k5_inputs(T, N, case, seed=T + N + len(case))
    eps = np.full(R, 1e-3, np.float32)
    want_k, want_out = _reference_choice(x, eps)
    req = torch.from_numpy(x["req"])
    buf = k5.victim_prefix(
        torch.from_numpy(x["victims"]), torch.from_numpy(x["node"]),
        torch.from_numpy(x["rank"]), req, torch.from_numpy(x["future"]),
        torch.from_numpy(eps), torch.tensor(x["p"]), req, torch.from_numpy(x["pred"]),
        torch.from_numpy(x["node_ok"]), torch.from_numpy(x["excl"]),
        torch.from_numpy(x["dyn"]))
    assert buf.dtype == torch.int32 and buf.shape == (N + 5,)
    np.testing.assert_array_equal(buf[:N].numpy(), want_k)
    assert buf[N:].tolist() == want_out
    # each case meets what it is named for
    if case == "no_feasible":
        assert want_out[:2] == [0, 0]
    elif case == "fits_no_victim":
        assert want_out[1] == 1 and want_k[want_out[0]] == 0 and want_out[4] == 1
    elif case == "tied_k":
        allowed = (want_k == want_k[want_out[0]]) & x["pred"][x["p"]] & x["node_ok"] \
            & x["dyn"] & ~x["excl"]
        assert want_out[1] == 1 and allowed.sum() > 1
        assert want_out[0] == int(np.argmax(allowed))
    elif case == "equal_ranks":
        assert len(np.unique(x["rank"])) < T // 4
    else:
        assert want_out[1] == 1 and 0 < want_k[want_out[0]] < k5.BIG_K


def test_victim_prefix_without_dynamic_row_and_min_victims_form():
    """dyn_row None allows every node it would; `min_victims_per_node`
    (a given request and node mask) is the same call with one predicate
    row."""
    from kube_batch_tpu_torch.ops.preemption import min_victims_per_node

    x = _k5_inputs(300, 24, "random", seed=3)
    x["dyn"][:] = True
    eps = np.full(R, 1e-3, np.float32)
    want_k, want_out = _reference_choice(x, eps)
    req = torch.from_numpy(x["req"])
    args = (torch.from_numpy(x["victims"]), torch.from_numpy(x["node"]),
            torch.from_numpy(x["rank"]), req, torch.from_numpy(x["future"]),
            torch.from_numpy(eps), torch.tensor(x["p"]), req, torch.from_numpy(x["pred"]),
            torch.from_numpy(x["node_ok"]), torch.from_numpy(x["excl"]))
    buf = k5.victim_prefix(*args, None)
    np.testing.assert_array_equal(buf[:24].numpy(), want_k)
    assert buf[24:].tolist() == want_out
    ok = torch.from_numpy(x["pred"][x["p"]] & x["node_ok"] & ~x["excl"])
    snap = types.SimpleNamespace(task_node=args[1], task_req=req)
    k, out = min_victims_per_node(snap, args[4], args[0], args[2], req[x["p"]], args[5], ok)
    np.testing.assert_array_equal(k.numpy(), want_k)
    assert out.tolist() == want_out


# ---------------------------------------------------------------------------
# K2 pass 2 from chunk summaries
# ---------------------------------------------------------------------------

PICK_CASES = [
    # (T, N, form, quantum, cells alike, nodes a chunk) — N off a multiple
    # of the chunk in all but one; the kernel's chunk (a warp's 32 nodes)
    # and a node tile
    (300, 1000, "mask", 0.5, False, k2.CHUNK_N),
    (300, 1000, "mask", 0.0, False, k2.CHUNK_N),
    (257, 301, "words", 0.5, False, k2.CHUNK_N),
    (257, 301, "words", 0.0, False, k2.CHUNK_N),
    (200, 768, "mask", 0.0, True, k2.CHUNK_N),
    (200, 333, "mask", 0.5, True, k2.CHUNK_N),
    (300, 1000, "mask", 0.5, False, 256),
    (257, 301, "words", 0.5, False, 256),
]


def _scores(T: int, N: int, form: str, quantum: float, alike: bool):
    """(feas, masked floored scores, active, rank) of seeded propose
    inputs: the mask form or the affinity words; with `alike`, every node
    the same, so a row's ties span every chunk."""
    args, fields, resident = chip_smoke.k2_words_inputs(torch.device("cpu"), T=T, N=N,
                                                        seed=T + N)
    args[11] = quantum
    if form == "words":
        tw = k10.affinity_task_words(*fields[:5])
        args[1] = k10.affinity_words(tw, fields[5], fields[6], fields[7], resident)
        dyn = k10.affinity_cells_plain(args[1])
    else:
        dyn = None
    if alike:
        args[3] = args[7] = torch.full_like(args[7], 2000.0)
        args[8] = torch.full_like(args[8], 8000.0)
        args[5] = torch.ones_like(args[5])
    pred, _, req, avail, eps, node_mask, elig, future, cap, spec, extras, q = args
    feas, s = k2.masked_scores_plain(pred, dyn, req, avail, eps, node_mask, elig, future,
                                     cap, spec, extras, k2.quantum_scale(q))
    rank = torch.from_numpy(np.random.default_rng(T).permutation(T).astype(np.int32))
    return args, feas, s, feas.any(dim=1), rank


@pytest.mark.parametrize("T,N,form,quantum,alike,chunk", PICK_CASES)
def test_pick_by_chunks_matches_round_robin(T, N, form, quantum, alike, chunk):
    args, feas, s, active, rank = _scores(T, N, form, quantum, alike)
    best = s.max(dim=1).values
    tied = feas & (s >= best[:, None])
    want = np.asarray(_round_robin_proposals(jnp.asarray(tied.numpy()),
                                             jnp.asarray(active.numpy()),
                                             jnp.asarray(rank.numpy())))
    ties = tied.sum(dim=1).int()
    k = tie_ordinal(active, rank, ties)
    got = k2.pick_by_chunks_plain(feas, s, best, active, k, chunk)
    np.testing.assert_array_equal(got.numpy(), want)
    # what the cases are for: ties spanning chunks, the last tie taken,
    # chunks with feasible cells below the row's best
    cmax, cties = k2.chunk_summaries_plain(feas, s, chunk)
    spanning = ((cmax == best[:, None]) & (cties > 0)).sum(dim=1) > 1
    # (without the quantum, continuous scores rarely tie)
    assert bool((active & spanning).any()) or (quantum == 0.0 and not alike)
    below = (cmax < best[:, None]) & (cties > 0)
    assert bool(below.any()) or alike
    # k = ties - 1 on every row: the last tie in node order
    last = torch.clamp(ties - 1, min=0)
    want_last = torch.where(active, (tied.int().cumsum(1) == ties[:, None]).int()
                            .mul(tied.int()).argmax(dim=1), 0).int()
    np.testing.assert_array_equal(
        k2.pick_by_chunks_plain(feas, s, best, active, last, chunk).numpy(),
        want_last.numpy())
    # the wrapper's plain version, given a (CPU: ignored) scratch, agrees
    pick = k2.propose_pick(*args, best, active, last, None)
    np.testing.assert_array_equal(pick.numpy(), want_last.numpy())


def test_chunk_summaries_count_feasible_ties_only():
    """A chunk's summary is the max over its feasible cells and the count
    tied at it; a chunk with no feasible cell is (-inf, 0); the short
    last chunk of N % 32 nodes counts only real nodes; a node tile's
    summary is one chunk."""
    s = torch.tensor([[1.0] * 40, [0.0] * 40])
    s[0, 33] = 2.0
    feas = torch.ones(2, 40, dtype=torch.bool)
    feas[1, 32:] = False
    m, c = k2.chunk_summaries_plain(feas, s)
    assert k2.CHUNK_N == 32
    assert m.tolist() == [[1.0, 2.0], [0.0, float("-inf")]]
    assert c.tolist() == [[32, 1], [32, 0]]
    m, c = k2.chunk_summaries_plain(feas, s, 256)
    assert m.tolist() == [[2.0], [0.0]] and c.tolist() == [[1], [32]]
