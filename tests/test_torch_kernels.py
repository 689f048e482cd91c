"""Each kernel's plain version against the reference function it replaces.

On the CPU the wrappers run their plain PyTorch versions; the CUDA
kernels are held against those versions on the card by chip_smoke.py.
Every world is the reference's packed world fed to the port through
`from_numpy`; int/bool outputs must be exactly equal, floats within
rtol=1e-6, atol=0 (the best scores, whose ties decide placements, come
out bit-identical).

* K1 `predicate_mask` vs `TensorPolicy.predicate_mask`;
* K2 `propose_best` / `propose_pick` vs the propose half of
  `allocate_rounds` (fit, feasibility, masked score, quantum floor, row
  max, tie count, `_round_robin_proposals`);
* K3 `resolve` (sort, prefix fit and watermark) vs `_resolve_conflicts`, and `apply` vs
  the apply step, with `one_per_node` and the anti-affinity
  `serialize_mask`;
* K4 `failure_counts` vs `fit_errors.failure_counts`.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from kube_batch_tpu.actions.backfill import (
    non_besteffort_eligible as jax_non_besteffort_eligible,
)
from kube_batch_tpu.actions.allocate import make_allocate_solver
from kube_batch_tpu.api.snapshot import SnapshotTensors as JaxSnapshot
from kube_batch_tpu.api.snapshot import fits as jax_fits
from kube_batch_tpu.framework.conf import default_conf as jax_default_conf
from kube_batch_tpu.framework.fit_errors import failure_counts as jax_failure_counts
from kube_batch_tpu.framework.session import build_policy as jax_build_policy
from kube_batch_tpu.ops.assignment import (
    _resolve_conflicts,
    _round_robin_proposals,
)
from kube_batch_tpu.ops.assignment import init_state as jax_init_state
from kube_batch_tpu_torch.actions.backfill import non_besteffort_eligible
from kube_batch_tpu_torch.api.snapshot import from_numpy
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.framework.conf import default_conf
from kube_batch_tpu_torch.framework.fit_errors import failure_counts
from kube_batch_tpu_torch.framework.session import build_policy
from kube_batch_tpu_torch.kernels import affinity as k10
from kube_batch_tpu_torch.kernels import predicate_mask as k1
from kube_batch_tpu_torch.kernels import propose as k2
from kube_batch_tpu_torch.kernels import resolve as k3
from kube_batch_tpu_torch.kernels import failure_counts as k4
from kube_batch_tpu_torch.ops.assignment import (
    AllocState,
    resolve_conflicts,
    tie_ordinal,
)
from test_torch_pack import jax_fields

NEG_INF = -1e30


def _jax_propose(policy, use_future, snap, st):
    """The reference's propose half (allocate_rounds lines 339-360); the
    tests take the Idle pass (use_future=False)."""
    avail = st.node_future if use_future else st.node_idle
    pending = (st.task_state == int(TaskStatus.PENDING)) & snap.task_mask
    eligible = pending & jax_non_besteffort_eligible(policy)(snap, st)
    fit = jax_fits(snap.task_req[:, None, :], avail[None, :, :], snap.eps)
    feas = policy.predicate_mask(snap) & fit & snap.node_mask[None, :] \
        & eligible[:, None]
    dyn = policy.dynamic_predicate_fn(snap, st, not use_future)
    if dyn is not None:
        feas = feas & dyn
    score = jnp.where(feas, policy.score_fn(snap, st), NEG_INF)
    if policy.score_quantum > 0.0:
        score = jnp.floor(score * (1.0 / policy.score_quantum))
    best = jnp.max(score, axis=1, keepdims=True)
    tied = feas & (score >= best)
    active = jnp.any(feas, axis=1)
    rank = policy.rank_fn(snap, st)
    prop = _round_robin_proposals(tied, active, rank)
    return dict(best=best[:, 0], ties=tied.sum(axis=1).astype(jnp.int32),
                active=active, rank=rank, prop=prop, avail=avail)


@functools.lru_cache(maxsize=None)
def _jax_side(world: str, stage: str, quantum: float | None):
    """(fields, snap, policy, state) of the reference, computed once per
    case and shared by the tests of this module."""
    fields, _ = jax_fields(world)
    snap = JaxSnapshot(**fields)
    policy, _ = jax_build_policy(jax_default_conf())
    if quantum is not None:
        policy.score_quantum = quantum
    state = jax_init_state(snap)
    if stage == "one_round":
        state = jax.jit(make_allocate_solver(policy, max_rounds=1))(snap, state)
    return fields, snap, policy, policy.setup_state(snap, state)


@functools.lru_cache(maxsize=None)
def _jax_propose_cached(world: str, stage: str, quantum: float | None):
    _, snap, policy, state = _jax_side(world, stage, quantum)
    fn = jax.jit(functools.partial(_jax_propose, policy, False))
    return jax.device_get(fn(snap, state))


class Pair:
    """One world at one state, in both packages."""

    def __init__(self, world: str, stage: str, quantum: float | None = None):
        self.case = (world, stage, quantum)
        fields, self.jsnap, self.jpolicy, self.jstate = _jax_side(*self.case)
        self.snap = from_numpy(fields, "cpu")
        self.policy, _ = build_policy(default_conf())
        if quantum is not None:
            self.policy.score_quantum = quantum
        state = AllocState(*(
            torch.from_numpy(np.array(getattr(self.jstate, f)))
            for f in ("task_state", "task_node", "node_idle", "node_future")
        ))
        self.state = self.policy.setup_state(self.snap, state)

    def jax_propose(self):
        return _jax_propose_cached(*self.case)

    def port_propose(self):
        snap, st, pol = self.snap, self.state, self.policy
        avail = st.node_idle
        pending = (st.task_state == int(TaskStatus.PENDING)) & snap.task_mask
        eligible = pending & non_besteffort_eligible(pol)(snap, st)
        spec = pol.score_spec()
        args = (pol.predicate_mask(snap),
                pol.dynamic_predicate_fn(snap, st, True),
                snap.task_req, avail, snap.eps, snap.node_mask, eligible,
                st.node_future, snap.node_cap, spec,
                spec.extra_terms(snap, st), pol.score_quantum)
        best, ties, active = k2.propose_best(*args)
        rank = pol.rank_fn(snap, st)
        prop = k2.propose_pick(*args, best, active, tie_ordinal(active, rank, ties))
        return dict(best=best, ties=ties, active=active, rank=rank, prop=prop,
                    avail=avail)


def _eq(got: torch.Tensor, want, name: str) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, name
    np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


@pytest.mark.parametrize(
    "world", ["config3", "config5_small", "affinity", "volume"]
)
def test_predicate_mask_matches_reference(world):
    pair = Pair(world, "packed")
    want = jax.jit(pair.jpolicy.predicate_mask)(pair.jsnap)
    got = k1.predicate_mask(pair.snap, k1.PredicateFlags())
    _eq(got, want, "predicate_mask")
    assert bool(got.any())


PROPOSE_CASES = [
    ("config2", "packed", None),
    ("config3", "packed", None),
    ("config3", "one_round", None),
    ("config5_small", "packed", None),
    ("affinity", "packed", None),
    ("affinity", "one_round", None),
    ("quantum", "packed", None),
    ("quantum", "packed", 0.3),
    ("oracle", "packed", None),
]


@pytest.mark.parametrize("world,stage,quantum", PROPOSE_CASES)
def test_propose_matches_reference(world, stage, quantum):
    pair = Pair(world, stage, quantum)
    want, got = pair.jax_propose(), pair.port_propose()
    np.testing.assert_allclose(got["best"].numpy(), np.asarray(want["best"]),
                               rtol=1e-6, atol=0)
    _eq(got["best"], want["best"], "best (bit-identical)")
    _eq(got["ties"], want["ties"], "ties")
    _eq(got["active"], want["active"], "active")
    _eq(got["rank"], want["rank"], "rank")
    act = got["active"].numpy()
    assert act.any()
    np.testing.assert_array_equal(
        got["prop"].numpy()[act], np.asarray(want["prop"])[act]
    )
    # inactive rows propose node 0, as argmax of an all-false row does
    assert not got["prop"].numpy()[~act].any()


@pytest.mark.parametrize("world,stage,one_per_node,serialize", [
    ("config3", "packed", False, False),
    ("config3", "packed", True, False),
    ("oracle", "packed", False, False),
    ("quantum", "packed", False, False),
    ("affinity", "packed", False, True),
    ("affinity", "one_round", False, True),
    ("config3", "one_round", False, False),
])
def test_resolve_and_apply_match_reference(world, stage, one_per_node,
                                           serialize):
    pair = Pair(world, stage)
    j = pair.jax_propose()
    p = pair.port_propose()
    jsnap, snap = pair.jsnap, pair.snap
    jser = ser = None
    if serialize:
        anti_union = jnp.any(jsnap.task_anti > 0, axis=0)
        jser = jnp.any(jsnap.task_anti > 0, axis=1) | jnp.any(
            (jsnap.task_podlabels > 0) & anti_union[None, :], axis=1
        )
        ser = pair.policy.serialize_mask(snap, pair.state)
        _eq(ser, jser, "serialize_mask")
        assert bool(ser.any())
    want = _resolve_conflicts(
        j["prop"], j["active"], j["rank"], jsnap.task_req, j["avail"],
        jsnap.eps, one_per_node=one_per_node, serialize_mask=jser,
    )
    accept, perm, s_node = resolve_conflicts(
        p["prop"], p["active"], p["rank"], snap.task_req, p["avail"],
        snap.eps, one_per_node=one_per_node, serialize_mask=ser,
    )
    _eq(accept, want, "accept")
    assert bool(accept.any())

    # apply (allocate_rounds lines 421-431)
    new_status = int(TaskStatus.ALLOCATED)
    st = pair.jstate
    N = jsnap.num_nodes
    delta = jax.ops.segment_sum(
        jnp.where(want[:, None], jsnap.task_req, 0.0),
        jnp.where(want, j["prop"], N), num_segments=N + 1,
    )[:N]
    w_future = st.node_future - delta
    w_idle = st.node_idle - delta
    w_state = jnp.where(want, new_status, st.task_state)
    w_node = jnp.where(want, j["prop"], st.task_node)
    s = pair.state
    k3.apply(perm, s_node, accept, snap.task_req, s.node_future, s.node_idle,
             False, new_status, s.task_state, s.task_node)
    _eq(s.task_state, w_state, "task_state")
    _eq(s.task_node, w_node, "task_node")
    for name, got, ref in (("node_future", s.node_future, w_future),
                           ("node_idle", s.node_idle, w_idle)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=0, err_msg=name)


def _jax_diag(policy, snap, state):
    mask = policy.predicate_mask(snap)
    dyn = policy.dynamic_predicate_fn(snap, state, immediate=True)
    return jax_failure_counts(snap, state, mask if dyn is None else mask & dyn)


_TALLY_WORLDS = [("config3", "one_round"), ("affinity", "one_round"),
                 ("config5_small", "packed"), ("volume", "packed"), ("oracle", "packed")]


@pytest.mark.parametrize("world,stage,form", [
    pytest.param(w, s, form, id=f"{w}-{s}" + ("" if form == "mask" else "-words"))
    for form in ("mask", "words") for w, s in _TALLY_WORLDS
])
def test_failure_counts_matches_reference(world, stage, form):
    """The cycle's tallies against the reference fed `mask & dyn`, the
    dynamic predicate given as a bool mask (`dynamic_predicate_fn`) or
    as what the cycle hands kernel K4 (`auction_dyn_predicate`: K10's
    words on the affinity world)."""
    pair = Pair(world, stage)
    want = jax.jit(functools.partial(_jax_diag, pair.jpolicy))(
        pair.jsnap, pair.jstate
    )
    mask = pair.policy.predicate_mask(pair.snap)
    if form == "mask":
        dyn = pair.policy.dynamic_predicate_fn(pair.snap, pair.state, True)
    else:
        dyn = pair.policy.auction_dyn_predicate(pair.snap, pair.state, immediate=True)
        assert isinstance(dyn, k10.AffinityWords) == (world == "affinity")
    got = failure_counts(pair.snap, pair.state, mask, dyn)
    for key in ("nodes", "predicate_failed", "insufficient", "feasible"):
        _eq(got[key], want[key], key)
    if world == "affinity":   # the dynamic predicate vetoes some cells here
        plain = failure_counts(pair.snap, pair.state, mask)
        assert (got["predicate_failed"] > plain["predicate_failed"]).any()


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; a tensor on
    any device other than the CPU or a CUDA card is refused."""
    meta = torch.device("meta")
    req = torch.zeros((4, 4), device=meta)
    idle = torch.zeros((2, 4), device=meta)
    eps = torch.zeros(4, device=meta)
    idx = torch.zeros(4, dtype=torch.int64, device=meta)
    mask = torch.zeros((4, 2), dtype=torch.bool, device=meta)
    with pytest.raises(RuntimeError):
        k3.resolve(idx, idx, req, idle, eps, False, None)
    with pytest.raises(RuntimeError):
        k4.failure_counts(mask, None, req, idle, eps, mask[0])
    with pytest.raises(RuntimeError):
        k2.propose_best(mask, None, req, idle, eps, mask[0], mask[:, 0], idle,
                        idle, k2.ScoreSpec(), [], 0.0)
