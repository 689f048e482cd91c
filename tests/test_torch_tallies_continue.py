"""Kernel K4's failure tallies and kernel K6's continuing-step
classification (their plain versions on the CPU) against the reference.

* K4 `failure_counts` with a bool[T, N] dynamic mask and without,
  against the reference's `fit_errors.failure_counts` fed `mask & dyn`,
  on numpy-seeded inputs (R from 1 to 8, N not a multiple of 32,
  requests at eps, all-false rows, one request class for all rows and
  one a row); given K10's words (`kernels/affinity.py · AffinityWords`,
  what the cycle now hands it) equal to it given K10's plain mask of the
  same words.  Exactly equal.  Both forms on the worlds of the cycle are
  tests/test_torch_kernels.py · test_failure_counts_matches_reference.
* K6 `preempt_continue` (v, any_victim, fit_now, viable) against the
  reference's classification lines (kube_batch_tpu/ops/preemption.py ·
  preemption_rounds: fit_now, viable, victims_on_n, any_vic, v), written
  out in jax.numpy (tests/test_torch_preempt.py · _jax_classify), with
  the inter-pod affinity row operand (`AffinityRow`) of the affinity
  worlds, p and n given as device scalars; seeded cases without a row
  and with a bool[N] row are
  tests/test_torch_preempt.py · test_preempt_scan_continue_matches_brute_force.
"""

from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_batch_tpu.framework.fit_errors import failure_counts as jax_failure_counts
from kube_batch_tpu.plugins import predicates as jax_pred
from kube_batch_tpu_torch.kernels import affinity as k10
from kube_batch_tpu_torch.kernels import failure_counts as k4
from kube_batch_tpu_torch.kernels import preempt_scan as k6
from kube_batch_tpu_torch.kernels import resident as k11
from kube_batch_tpu_torch.plugins import predicates
from test_torch_affinity import _fields, _random_inputs, _states
from test_torch_preempt import _jax_classify

#: the order kernel K4's wrapper returns them in
K4_ORDER = ("predicate_failed", "insufficient", "feasible", "nodes")


def _eq(got: torch.Tensor, want, name: str) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, name
    np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def _same_tallies(got, want, what: str) -> None:
    for key, g, w in zip(K4_ORDER, got, want):
        _eq(g, w, f"{what}: {key}")


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

def _tally_inputs(seed: int, R: int, N: int, classes: str):
    """Seeded inputs: T = 70 rows (not a multiple of 32), requests drawn
    from a few values that sit at, above and below eps (some rows all
    below eps), an all-false row and a row of padding; `classes` "few"
    (a handful of request rows shared by every task), "one" (every task
    the same request) or "each" (a request of its own each)."""
    rng = np.random.default_rng(seed)
    T = 70
    eps = np.linspace(0.5, 2.0, R).astype(np.float32)
    levels = np.stack([eps * 0.5, eps, eps * 2.0, eps * 4.0], axis=1)  # [R, 4]

    def draw(n):
        return np.stack([levels[r, rng.integers(0, 4, n)] for r in range(R)],
                        axis=1).astype(np.float32)

    if classes == "one":
        req = np.repeat(draw(1), T, axis=0)
    elif classes == "few":
        req = draw(4)[rng.integers(0, 4, T)]
    else:
        req = draw(T) + np.arange(T, dtype=np.float32)[:, None] * 1e-3
    if classes != "one":
        req[5] = eps * 0.5                     # below eps on every dim
    idle = np.stack([levels[r, rng.integers(0, 4, N)] for r in range(R)], axis=1)
    idle = (idle * rng.choice([0.9, 1.0, 2.0], (N, R))).astype(np.float32)
    pred = rng.random((T, N)) < 0.7
    pred[3] = False                            # an all-false row
    node_ok = rng.random(N) < 0.85
    node_ok[-1] = N < 3                        # a node not ready, where there are several
    return pred, req, idle, eps, node_ok


def _jax_tallies(pred, req, idle, eps, node_ok):
    snap = types.SimpleNamespace(task_req=jnp.asarray(req), eps=jnp.asarray(eps),
                                 node_mask=jnp.asarray(node_ok),
                                 node_ready=jnp.ones(node_ok.shape, bool),
                                 num_resources=req.shape[1])
    state = types.SimpleNamespace(node_idle=jnp.asarray(idle))
    out = jax_failure_counts(snap, state, jnp.asarray(pred))
    return [out[k] for k in K4_ORDER]


@pytest.mark.parametrize("seed,R,N,classes", [
    (0, 1, 37, "few"), (1, 2, 45, "each"), (2, 3, 64, "one"), (3, 4, 100, "few"),
    (4, 5, 33, "each"), (5, 8, 47, "few"), (6, 8, 16, "one"), (7, 6, 1, "few"),
])
def test_failure_counts_plain_matches_reference_on_seeded_inputs(seed, R, N, classes):
    """K4's plain version with a dynamic mask and without, against the
    reference fed the AND."""
    pred, req, idle, eps, node_ok = _tally_inputs(seed, R, N, classes)
    dyn = np.random.default_rng(seed + 100).random(pred.shape) < 0.8
    t = [torch.from_numpy(x) for x in (pred, req, idle, eps, node_ok)]
    got = k4.failure_counts(t[0], torch.from_numpy(dyn), *t[1:])
    _same_tallies(got, _jax_tallies(pred & dyn, req, idle, eps, node_ok), "with a mask")
    got = k4.failure_counts(t[0], None, *t[1:])
    _same_tallies(got, _jax_tallies(pred, req, idle, eps, node_ok), "without")
    assert int(got[0][3]) == int(node_ok.sum())
    if N > 8 and classes != "one":   # cells that fit and cells short on a dim
        assert int(got[2].sum()) and int(got[1].sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_failure_counts_words_form_equals_mask_form(seed):
    """K4's plain version given K10's words equals it given K10's plain
    mask of the same tables (and the reference fed `pred & mask`), on
    numpy-seeded affinity terms over padded columns and a dead domain,
    for both resident sets."""
    (labels, aff, anti, aff_topo, anti_topo, term_key, term_label, nkd,
     state, node, mask), N, D = _random_inputs(seed)
    T, K = labels.shape
    K2 = aff_topo.shape[1]
    fields = (aff, anti, labels, aff_topo, anti_topo, term_key, term_label, nkd)
    tw = k10.affinity_task_words(aff, anti, labels, aff_topo, anti_topo)
    pred, req, idle, eps, node_ok = _tally_inputs(seed, 4, N, "few")
    pred = np.concatenate([pred, pred[: T - pred.shape[0]]])[:T]
    req = np.concatenate([req, req[: T - req.shape[0]]])[:T]
    t_pred = torch.from_numpy(pred)
    rest = [torch.from_numpy(x) for x in (req, idle, eps, node_ok)]
    vetoed = 0
    for with_now in (True, False):
        rw = k11.resident_words(tw, node, state, mask, nkd, term_key, term_label,
                                N, D, K, K2, with_now=with_now)
        words = k10.affinity_words(tw, term_key, term_label, nkd, rw)
        dyn = k10.affinity_mask_plain(*fields, rw)
        got = k4.failure_counts(t_pred, words, *rest)
        _same_tallies(got, k4.failure_counts(t_pred, dyn, *rest), f"with_now={with_now}")
        _same_tallies(got, _jax_tallies(pred & dyn.numpy(), req, idle, eps, node_ok),
                      f"reference, with_now={with_now}")
        vetoed += int((t_pred & ~dyn).sum())
    assert vetoed > 0


# ---------------------------------------------------------------------------
# K6 preempt_continue
# ---------------------------------------------------------------------------

def _classify(rank, victims, task_node, task_req, future, eps, p, n, dyn_row):
    """The port's: the arrays as CPU tensors, p and n as int64 scalars."""
    out = k6.preempt_continue(
        *(torch.from_numpy(np.asarray(x)) for x in (rank, victims, task_node, task_req,
                                                    future, eps)),
        torch.tensor(p, dtype=torch.int64), torch.tensor(n, dtype=torch.int64), dyn_row)
    assert [x.dtype for x in out] == [torch.int64] + [torch.bool] * 3
    assert all(x.dim() == 0 for x in out)
    return int(out[0]), bool(out[1]), bool(out[2]), bool(out[3])


@pytest.mark.parametrize("world", ["affinity", "config5_affinity_small"])
def test_preempt_continue_with_affinity_row_matches_reference(world):
    """With the preemptor's inter-pod affinity row operand (and with it
    ANDed with a bool[N] mask): viable is the reference's
    pod_affinity_row at n, on the packed state and after one round, for
    every task with a term at nodes where its row holds and where it
    does not."""
    jsnap, snap, states = _states(_fields(world))
    T, N = snap.num_tasks, snap.num_nodes
    rows = torch.nonzero(snap.task_mask & (
        snap.task_aff.any(1) | snap.task_anti.any(1) | snap.task_aff_topo.any(1)
        | snap.task_anti_topo.any(1)))[:, 0].tolist()
    assert rows
    rng = np.random.default_rng(0)
    rank = rng.permutation(T).astype(np.int32)
    extra = rng.random(N) < 0.7
    seen = set()
    for label, jst, st in states:
        victims = (rng.random(T) < 0.3) & snap.task_mask.numpy()
        task_node = st.task_node.numpy()
        req, future, eps = (snap.task_req.numpy(), st.node_future.numpy(),
                            snap.eps.numpy())
        for p in rows[:12]:
            op = predicates.pod_affinity_row(snap, st, torch.tensor(p))
            jrow = np.asarray(jax_pred.pod_affinity_row(jsnap, jst, p))
            for n in sorted({0, N - 1, *np.nonzero(~jrow)[0][:2], *np.nonzero(jrow)[0][:2]}):
                for dyn, jdyn in ((op, jrow), (op.and_mask(torch.from_numpy(extra)),
                                               jrow & extra)):
                    want = _jax_classify(
                        jnp.asarray(rank), jnp.asarray(victims), jnp.asarray(task_node),
                        jnp.asarray(req), jnp.asarray(future), jnp.asarray(eps), p, int(n),
                        jnp.asarray(jdyn))
                    got = _classify(rank, victims, task_node, req, future, eps, p, int(n),
                                    dyn)
                    assert got == want, (label, p, int(n))
                    seen.add(got[3])
    assert seen == {True, False}


def test_continue_buffer_views():
    """The kept buffer's outputs are views of one 32-byte allocation, in
    the dtypes the step reads."""
    buf = k6.ContinueBuffer("cpu")
    v, any_vic, fit_now, viable = buf.outputs
    assert buf.buf.numel() == k6.ContinueBuffer.BYTES
    assert (v.dtype, any_vic.dtype, fit_now.dtype, viable.dtype) == (
        torch.int64, torch.bool, torch.bool, torch.bool)
    buf.buf[:8].view(torch.int64)[0] = 12345
    buf.buf[8:11] = torch.tensor([1, 0, 1], dtype=torch.uint8)
    assert (int(v), bool(any_vic), bool(fit_now), bool(viable)) == (12345, True, False, True)
    assert all(x.untyped_storage().data_ptr() == buf.buf.untyped_storage().data_ptr()
               for x in buf.outputs)


def test_row_operand_refuses_another_device():
    """The row operand's C arguments are given only for the device of the
    kernel's other operands: an operand on the CPU beside operands on
    another device raises, before any pointer reaches a kernel."""
    _jsnap, snap, states = _states(_fields("affinity"))
    st = states[0][2]
    p = int(torch.nonzero(snap.task_mask & snap.task_aff.any(1))[0, 0])
    op = predicates.pod_affinity_row(snap, st, torch.tensor(p))
    with pytest.raises(ValueError, match="preempt_continue"):
        op.kernel_args("preempt_continue", torch.device("meta"))
    args = op.kernel_args("victim_prefix", torch.device("cpu"))
    assert len(args) == 13 and args[0] == op.task_words.data_ptr()
