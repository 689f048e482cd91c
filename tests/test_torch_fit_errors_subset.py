"""The port's active-set diagnosis against the reference package.

`framework/fit_errors.py · failure_counts_subset` gathers the pending
rows (`cache/packer.py · gather_tasks`), runs the predicate mask, the
dynamic predicates' subset forms and the failure tallies at [P, N] and
scatters the counts back to [T].  Each world here is built and packed by
the reference package, the same packed fields go to the port on the CPU
(the kernels' plain versions), and the port's tallies must equal the
reference's `failure_counts_subset` on every task row (tolerance 0: the
outputs are integer counts) and the port's full tallies on the rows the
window covers.  The worlds and windows are those of
tests/test_fit_errors_subset.py: the fuzz generator's affinity worlds
(seeds 0, 1, 3, 7, 11; window 2048), a window of 2 rows under a deeper
backlog (seed 2), zone-scoped terms (window 64), a dynamic predicate
without a subset form (the full tallies) and the window guard.  Also:
`gather_tasks` field by field and `snapshot_dim_axes` against the
reference's, the inter-pod affinity flag read from the full snapshot,
row 0's tally kept under the fill rows, and the words form of the subset
predicate equal to its mask form.
"""

from __future__ import annotations

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_batch_tpu.api.types import TaskStatus
from kube_batch_tpu.cache import packer as jax_packer
from kube_batch_tpu.cache.cluster import Pod, PodGroup
from kube_batch_tpu.cache.packer import pack_snapshot as jax_pack
from kube_batch_tpu.framework import fit_errors as jax_fit
from kube_batch_tpu.framework.conf import default_conf as jax_default_conf
from kube_batch_tpu.framework.session import build_policy as jax_build_policy
from kube_batch_tpu.ops.assignment import init_state as jax_init_state
from kube_batch_tpu_torch.api.snapshot import FIELDS, from_numpy
from kube_batch_tpu_torch.cache.packer import gather_tasks, snapshot_dim_axes
from kube_batch_tpu_torch.framework import fit_errors
from kube_batch_tpu_torch.framework.conf import default_conf
from kube_batch_tpu_torch.framework.session import build_policy
from kube_batch_tpu_torch.kernels.affinity import AffinityWords
from kube_batch_tpu_torch.ops.assignment import init_state
from kube_batch_tpu_torch.plugins.predicates import AFFINITY_AUX
from tests.test_preempt_fuzz import _random_world
from tests.test_topology_pressure import _zone_world

PENDING = int(TaskStatus.PENDING)
KEYS = ("nodes", "predicate_failed", "insufficient", "feasible")
REQ = {"cpu": 500, "memory": 1 << 30, "pods": 1}

_POLICIES: dict = {}


def _policies():
    """(reference policy, port policy) of the default conf, built once."""
    if not _POLICIES:
        _POLICIES["jax"] = jax_build_policy(jax_default_conf())[0]
        _POLICIES["torch"] = build_policy(default_conf())[0]
    return _POLICIES["jax"], _POLICIES["torch"]


def _pack(cache):
    """(reference snapshot, the port's snapshot of the same packed fields)."""
    jsnap, _meta = jax_pack(cache.snapshot())
    fields = {f: np.array(getattr(jsnap, f)) for f in FIELDS}
    return jsnap, from_numpy(fields, "cpu")


def _np(counts) -> dict:
    return {k: np.asarray(counts[k].cpu() if isinstance(counts[k], torch.Tensor)
                          else counts[k]) for k in KEYS}


def _mask_policy(policy):
    """`policy` with no words form of its subset predicates: the subset
    tallies then hand K4 the mask (`dynamic_predicate_subset_fn`)."""
    masked = copy.copy(policy)
    masked.dynamic_predicate_subset_words = [None] * len(policy.dynamic_predicate_subsets)
    return masked


def _port_full(snap, state, policy) -> dict:
    """The port's full [T, N] tallies, as the cycle computes them."""
    return _np(fit_errors.failure_counts(
        snap, state, policy.predicate_mask(snap),
        policy.auction_dyn_predicate(snap, state, immediate=True)))


def _assert_equal(got: dict, want: dict, what: str) -> None:
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}: {k}")


def _compare(cache, max_rows: int, jpolicy=None, policy=None) -> int:
    """The port's subset tallies = the reference's on every row, = the
    port's full tallies on the covered pending rows, 0 elsewhere; returns
    the covered rows."""
    if jpolicy is None:
        jpolicy, policy = _policies()
    jsnap, snap = _pack(cache)
    want = _np(jax_fit.failure_counts_subset(jsnap, jax_init_state(jsnap), jpolicy,
                                             max_rows=max_rows, max_events=None))
    state = init_state(snap)
    got = _np(fit_errors.failure_counts_subset(snap, state, policy, max_rows=max_rows,
                                               max_events=None))
    _assert_equal(got, want, "port against reference")
    full = _port_full(snap, state, policy)
    pending = np.nonzero((snap.task_state.numpy() == PENDING) & snap.task_mask.numpy())[0]
    covered = pending[: min(max_rows, snap.num_tasks)]
    assert covered.size > 0, "vacuous world: nothing pending"
    assert int(got["nodes"]) == int(full["nodes"])
    for k in KEYS[1:]:
        np.testing.assert_array_equal(got[k][covered], full[k][covered], err_msg=k)
        outside = np.setdiff1d(np.arange(snap.num_tasks), covered)
        assert (got[k][outside] == 0).all(), k
    return covered.size


@pytest.mark.parametrize("seed", [0, 1, 3, 7, 11])
def test_subset_matches_reference_on_affinity_worlds(seed):
    """The fuzz generator's runner + arrival worlds: node-level
    (anti-)affinity, taints, selectors, PDBs."""
    cache, _sim = _random_world(seed, "preempt")
    _compare(cache, max_rows=2048)


def test_subset_truncation_window_matches_reference():
    """A window of 2 rows under a deeper pending backlog: the covered
    prefix matches, the rest scatters back as 0, as in the reference."""
    cache, _sim = _random_world(2, "preempt")
    assert _compare(cache, max_rows=2) == 2


def _topology_world():
    cache, sim = _zone_world(n_zones=2, nodes_per_zone=2)
    sim.submit(PodGroup(name="db", queue="", min_member=1),
               [Pod(name="db-0", request=REQ, labels={"app": "db"})])
    sim.submit(PodGroup(name="web", queue="", min_member=2),
               [Pod(name=f"web-{i}", request=REQ, labels={"app": "web"},
                    anti_affinity=frozenset({"zone:app=web"})) for i in range(2)])
    return cache


def test_subset_matches_reference_with_topology_terms():
    """Zone-scoped terms: the domain tables and the thresholds' term
    existence come from the full state."""
    _compare(_topology_world(), max_rows=64)


def _veto_node0(snap, state, immediate=False, resident=None):
    m = torch.ones((snap.num_tasks, snap.num_nodes), dtype=torch.bool)
    m[:, 0] = False
    return m


def test_subset_falls_back_without_subset_variant():
    """A dynamic predicate registered without a subset form: the full
    [T, N] tallies on every row, equal to the reference's fallback."""
    cache, _sim = _random_world(0, "preempt")
    jpolicy, _ = jax_build_policy(jax_default_conf())
    jpolicy.add_dynamic_predicate_fn(
        lambda snap, state, immediate=False: jnp.ones(
            (snap.num_tasks, snap.num_nodes), bool).at[:, 0].set(False))
    policy, _ = build_policy(default_conf())
    policy.add_dynamic_predicate_fn(_veto_node0, row_fn=lambda snap, state, p: None)
    assert not policy.has_subset_dynamic_predicates
    jsnap, snap = _pack(cache)
    state = init_state(snap)
    want = _np(jax_fit.failure_counts_subset(jsnap, jax_init_state(jsnap), jpolicy))
    got = _np(fit_errors.failure_counts_subset(snap, state, policy))
    _assert_equal(got, want, "fallback against reference")
    _assert_equal(got, _port_full(snap, state, policy), "fallback against full")
    # node 0's veto is counted: the default policy's full tallies differ
    base = _port_full(snap, state, _policies()[1])
    assert (got["predicate_failed"] >= base["predicate_failed"]).all()
    assert (got["predicate_failed"] > base["predicate_failed"]).any()


def test_window_guard_enforces_consumer_cap():
    """The guard raises before any argument is read, as the reference's;
    the derived window and the cap are the reference's."""
    with pytest.raises(ValueError, match="must stay below max_rows"):
        fit_errors.failure_counts_subset(None, None, None, max_rows=512)
    with pytest.raises(ValueError, match="must stay below max_rows"):
        fit_errors.failure_counts_subset(None, None, None, max_rows=64, max_events=64)
    assert fit_errors.MAX_DIAG_EVENTS == jax_fit.MAX_DIAG_EVENTS
    for cap in (None, 0, 10, 1000, 1023, 1024, 1025, 5000):
        assert fit_errors.diag_window_rows(cap) == jax_fit.diag_window_rows(cap)
    assert fit_errors.MAX_DIAG_EVENTS < fit_errors.diag_window_rows(fit_errors.MAX_DIAG_EVENTS)


def test_snapshot_dim_axes_matches_reference():
    assert snapshot_dim_axes() == jax_packer.snapshot_dim_axes()


def test_gather_tasks_matches_reference():
    """Every field of the gathered snapshot equals the reference's, fill
    rows (index 0, not valid) included; nothing kept beside the full
    snapshot comes along but the gathered rows of its task words."""
    from kube_batch_tpu_torch.plugins.predicates import task_words

    cache, _sim = _random_world(3, "preempt")
    jsnap, snap = _pack(cache)
    T = snap.num_tasks
    rows = np.array([T - 1, 0, 5, 2, 0, 0], dtype=np.int64) % T
    valid = np.array([True, True, True, True, False, False])
    want = jax_packer.gather_tasks(jsnap, jnp.asarray(rows.astype(np.int32)),
                                   jnp.asarray(valid))
    full_words = task_words(snap)
    snap.segment_index("job")
    sub = gather_tasks(snap, torch.from_numpy(rows), torch.from_numpy(valid))
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(sub, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert sub.num_tasks == len(rows) and sub.num_nodes == snap.num_nodes
    assert "_segment_index" not in sub.__dict__
    assert torch.equal(sub.affinity_task_words(), full_words[torch.from_numpy(rows)])


def _resident_anti_world():
    """Pending rows with no affinity term of their own (labelled app=web),
    one running resident whose anti term names app=web: only the full
    snapshot shows that a term is active."""
    cache, sim = _zone_world(n_zones=2, nodes_per_zone=2)
    sim.submit(PodGroup(name="guard", queue="", min_member=1),
               [Pod(name="guard-0", request=REQ, labels={"app": "guard"},
                    anti_affinity=frozenset({"app=web"}))])
    guard = next(p for j in cache.snapshot().jobs.values() for p in j.tasks.values())
    assert cache.bind(guard.uid, "z0-n0")
    sim.tick()
    sim.submit(PodGroup(name="web", queue="", min_member=1),
               [Pod(name=f"web-{i}", request=REQ, labels={"app": "web"})
                for i in range(3)])
    return cache


def test_affinity_flag_comes_from_full_snapshot():
    """The activity flag of the subset forms is asked of the full
    snapshot: read on the gathered pending rows alone it would drop the
    resident's anti term (the symmetry check) and, on a fresh state,
    write False into the full state's `aux`, which the subset's state
    shares."""
    jpolicy, policy = _policies()
    cache = _resident_anti_world()
    jsnap, snap = _pack(cache)
    pending_rows = (snap.task_state == PENDING) & snap.task_mask
    assert not (snap.task_anti[pending_rows] != 0).any()
    state = init_state(snap)
    assert AFFINITY_AUX not in state.aux
    got = _np(fit_errors.failure_counts_subset(snap, state, policy, max_rows=64,
                                               max_events=None))
    assert state.aux[AFFINITY_AUX] is True
    full = _port_full(snap, state, policy)
    rows = pending_rows.numpy()
    np.testing.assert_array_equal(got["predicate_failed"][rows],
                                  full["predicate_failed"][rows])
    # the resident's node is vetoed for every web pod by symmetry
    assert (got["predicate_failed"][rows] >= 1).all()
    want = _np(jax_fit.failure_counts_subset(jsnap, jax_init_state(jsnap), jpolicy,
                                             max_rows=64, max_events=None))
    _assert_equal(got, want, "port against reference")
    # a second call on the same state reads the kept flag alike
    _assert_equal(_np(fit_errors.failure_counts_subset(snap, state, policy, max_rows=64,
                                                       max_events=None)), got, "again")


def test_fill_rows_keep_row_zero():
    """The fill rows of a window wider than the backlog repeat index 0;
    when row 0 is itself pending its tally survives the scatter (amax,
    not a plain assignment)."""
    _jpolicy, policy = _policies()
    _jsnap, snap = _pack(_topology_world())
    state = init_state(snap)
    assert int(state.task_state[0]) == PENDING and bool(snap.task_mask[0])
    got = _np(fit_errors.failure_counts_subset(snap, state, policy, max_rows=64,
                                               max_events=None))
    full = _port_full(snap, state, policy)
    for k in KEYS[1:]:
        np.testing.assert_array_equal(got[k][0], full[k][0], err_msg=k)
    assert got["feasible"][0] + got["predicate_failed"][0] > 0


@pytest.mark.parametrize("world", ["affinity", "topology", "resident_anti"])
def test_subset_words_form_equals_mask_form(world):
    """K4 given K10's words for the P rows = K4 given the subset mask; the
    policy hands K4 the words where inter-pod affinity is its only
    dynamic predicate."""
    _jpolicy, policy = _policies()
    cache = {"affinity": lambda: _random_world(3, "preempt")[0],
             "topology": _topology_world, "resident_anti": _resident_anti_world}[world]()
    _jsnap, snap = _pack(cache)
    state = init_state(snap)
    words = _np(fit_errors.failure_counts_subset(snap, state, policy, max_rows=64,
                                                 max_events=None))
    mask = _np(fit_errors.failure_counts_subset(snap, state, _mask_policy(policy),
                                                max_rows=64, max_events=None))
    _assert_equal(words, mask, "words form against mask form")
    P = min(64, snap.num_tasks)
    idx = torch.zeros(P, dtype=torch.int64)
    sub = gather_tasks(snap, idx, torch.ones(P, dtype=torch.bool))
    sub_state = dataclasses.replace(state, task_state=state.task_state[idx],
                                    task_node=state.task_node[idx])
    dyn = policy.subset_dyn_predicate(snap, state, sub, sub_state, immediate=True)
    assert isinstance(dyn, AffinityWords) and dyn.task_words.shape[0] == P
    m = policy.dynamic_predicate_subset_fn(snap, state, sub, sub_state, immediate=True)
    assert m.shape == (P, snap.num_nodes) and m.dtype == torch.bool


def _window(snap, P: int):
    """(idx int64[P], valid bool[P]) of the first P pending rows, filled
    with row 0, as failure_counts_subset gathers them."""
    pending = np.nonzero((snap.task_state.numpy() == PENDING) & snap.task_mask.numpy())[0][:P]
    idx = np.zeros(P, dtype=np.int64)
    idx[:pending.size] = pending
    return idx, np.arange(P) < pending.size


@pytest.mark.parametrize("world", ["seed1", "seed3", "seed11", "topology", "resident_anti"])
@pytest.mark.parametrize("immediate", [False, True])
def test_subset_predicate_matches_reference(world, immediate):
    """The subset predicate for the gathered rows — the port's mask form
    (`dynamic_predicate_subset_fn`: K10's mask) and its words form
    (`subset_dyn_predicate`: K10's words, the cells tested as K4 tests
    them) — equals the reference's `dynamic_predicate_subset_fn`, on every
    gathered row, fill rows included."""
    from kube_batch_tpu_torch.kernels.affinity import affinity_cells_plain

    jpolicy, policy = _policies()
    builders = {"topology": _topology_world, "resident_anti": _resident_anti_world}
    cache = (builders[world]() if world in builders
             else _random_world(int(world[4:]), "preempt")[0])
    jsnap, snap = _pack(cache)
    P = 16
    idx, valid = _window(snap, P)
    jstate = jax_init_state(jsnap)
    jsub = jax_packer.gather_tasks(jsnap, jnp.asarray(idx.astype(np.int32)),
                                   jnp.asarray(valid))
    jsub_state = jstate.replace(task_state=jstate.task_state[idx],
                                task_node=jstate.task_node[idx])
    want = np.asarray(jpolicy.dynamic_predicate_subset_fn(jsnap, jstate, jsub, jsub_state,
                                                          immediate=immediate))
    state = init_state(snap)
    t_idx = torch.from_numpy(idx)
    sub = gather_tasks(snap, t_idx, torch.from_numpy(valid))
    sub_state = dataclasses.replace(state, task_state=state.task_state[t_idx],
                                    task_node=state.task_node[t_idx])
    mask = policy.dynamic_predicate_subset_fn(snap, state, sub, sub_state, immediate)
    words = policy.subset_dyn_predicate(snap, state, sub, sub_state, immediate)
    assert isinstance(words, AffinityWords)
    np.testing.assert_array_equal(mask.numpy(), want)
    np.testing.assert_array_equal(affinity_cells_plain(words).numpy(), want)
