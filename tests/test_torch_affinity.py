"""The port's inter-pod affinity (kernels K10 and K11, their plain
versions on the CPU) against the reference package's, exactly.

* `resident_tables` against the reference's `resident_podlabels` and
  `resident_domain_labels` (both `include_releasing` values),
  `pod_affinity_predicate` (both
  `immediate` values), `pod_affinity_row` for every task with a term,
  `bootstrap_mask` and `pod_affinity_score` on the affinity worlds of
  tests/test_torch_pack.py (the hand-made one and the small config-5
  affinity world) and on a world with Releasing residents and
  topology-scoped anti-affinity: on the packed state and after one
  auction round.  Bool outputs bit for bit, the score to the last bit.
* The default-conf cycle on the small config-5 affinity world over 2
  cycles with a second wave: the same binds, task states and nodes and
  job readiness as the reference's Scheduler.
* The plain K10 / K11 against the arithmetic of the kernels themselves
  (popcounts of 0/1 words, presence as an OR), on numpy-seeded tables
  with padded vocabulary columns and a dead-domain row.
* K10's words form (`affinity_words`, the cells K2 tests itself) against
  the reference's `pod_affinity_predicate` on the same worlds and
  states, task words built or kept; K2's two passes given the words
  against the same passes given K10's mask; the policy's choice of the
  words form (only when inter-pod affinity is the one dynamic predicate
  and constrains the snapshot); and the acceptances each serialize step
  cancels, as counted on the device, against the acceptances the round
  lost.
"""

from __future__ import annotations

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_batch_tpu.api.snapshot import SnapshotTensors as JaxSnapshot
from kube_batch_tpu.cache.packer import pack_snapshot_host
from kube_batch_tpu.framework.conf import default_conf as jax_default_conf
from kube_batch_tpu.framework.session import build_policy as jax_build_policy
from kube_batch_tpu.ops.assignment import init_state as jax_init_state
from kube_batch_tpu.plugins import predicates as jax_pred
from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
from kube_batch_tpu_torch.api.snapshot import from_numpy
from kube_batch_tpu_torch.framework.conf import default_conf
from kube_batch_tpu_torch.framework.session import build_policy
from kube_batch_tpu_torch.kernels import affinity as k10
from kube_batch_tpu_torch.kernels import resident as k11
from kube_batch_tpu_torch.kernels import propose as k2
from kube_batch_tpu_torch.kernels import resolve as k3
from kube_batch_tpu_torch.ops.assignment import (
    CANCEL_STEPS,
    allocate_rounds,
    auction_round,
    init_state,
    tie_ordinal,
)
from kube_batch_tpu_torch.plugins import nodeorder, predicates
from kube_batch_tpu_torch.scheduler import Scheduler
from test_torch_pack import PACKAGES, build_world, jax_fields

GI = float(1 << 30)


def _releasing_world(cl, wl, sim_mod):
    """Zone-scoped anti-affinity with Releasing residents: db pods run in
    every zone (one of them evicted, Releasing), web pods run with
    node-level anti-affinity (one evicted), and pending db / web / api
    pods that the Idle pass must keep away from the terminating ones."""
    cache, sim = sim_mod.make_world(wl.DEFAULT_SPEC)
    for i in range(9):
        sim.add_node(wl._node(f"n{i}", cpu_milli=8000, mem=32 * GI,
                              labels={"zone": f"z{i % 3}"}))

    def pods(prefix, n, node=None, **kw):
        out = []
        for i in range(n):
            extra = {} if node is None else {"status": cl.TaskStatus.RUNNING,
                                             "node": node[i % len(node)]}
            out.append(cl.Pod(name=f"{prefix}-{i}",
                              request={"cpu": 1000, "memory": 2 * GI, "pods": 1},
                              **extra, **kw))
        return out

    db = dict(labels={"app": "db"}, anti_affinity=frozenset({"zone:app=db"}))
    web = dict(labels={"app": "web"}, anti_affinity=frozenset({"app=web"}))
    sim.submit(cl.PodGroup(name="db-run", queue="default", min_member=1),
               pods("db-run", 2, node=["n0", "n1"], **db))
    sim.submit(cl.PodGroup(name="web-run", queue="default", min_member=1),
               pods("web-run", 3, node=["n3", "n4", "n5"], **web))
    sim.submit(cl.PodGroup(name="db", queue="default", min_member=1), pods("db", 3, **db))
    sim.submit(cl.PodGroup(name="web", queue="default", min_member=1),
               pods("web", 6, **web))
    sim.submit(cl.PodGroup(name="api", queue="default", min_member=1), pods(
        "api", 4, labels={"app": "api"}, affinity=frozenset({"zone:app=db"}),
        pod_prefs={"zone:app=web": 1.0, "app=db": 2.0}))
    for name in ("db-run-1", "web-run-0"):
        (uid,) = [u for u, p in cache._pods.items() if p.name == name]
        assert cache.evict(uid, "test")
    return cache, sim


WORLDS = {
    "affinity": None,                 # tests/test_torch_pack.py's worlds
    "config5_affinity_small": None,
    "releasing": _releasing_world,
}


def _fields(world):
    if WORLDS[world] is None:
        cache, _ = build_world(world, "jax")
    else:
        cl, wl, sim_mod = PACKAGES["jax"]
        cl._uid_counter = itertools.count()
        cache, _ = WORLDS[world](cl, wl, sim_mod)
    snap, _ = pack_snapshot_host(cache.snapshot())
    return {f.name: np.asarray(getattr(snap, f.name)) for f in dataclasses.fields(snap)}


def _states(fields):
    """(jax snapshot, port snapshot, [(label, jax state, port state)]):
    the packed state, and the state after one auction round of the
    port's Idle pass (handed to the reference as arrays)."""
    jsnap = JaxSnapshot(**fields)
    snap = from_numpy(fields, "cpu")
    policy, _ = build_policy(default_conf())
    st = policy.setup_state(snap, init_state(snap))
    out = [("packed", jax_init_state(jsnap), init_state(snap))]
    allocate_rounds(snap, st, policy.predicate_mask(snap), policy.score_spec(),
                    policy.rank_fn, policy.eligible_fn, snap.eps, max_rounds=1,
                    dyn_predicate_fn=policy.dynamic_predicate_fn,
                    global_serialize_fn=policy.global_serialize_fn,
                    domain_serialize_fn=policy.domain_serialize_fn,
                    serialize_mask=policy.serialize_mask(snap, st))
    j_after = jax_init_state(jsnap).replace(
        task_state=jnp.asarray(st.task_state.numpy()),
        task_node=jnp.asarray(st.task_node.numpy()),
        node_idle=jnp.asarray(st.node_idle.numpy()),
        node_future=jnp.asarray(st.node_future.numpy()),
    )
    out.append(("one_round", j_after, st))
    return jsnap, snap, out


def _eq(got, want, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_resident_tables_match_reference(world):
    jsnap, snap, states = _states(_fields(world))
    checked = 0
    for label, jst, st in states:
        for rel in (False, True):
            what = f"{label}, include_releasing={rel}"
            Hb, Ab, Hd, Ad = predicates.resident_tables(snap, st, rel)
            jHb, jAb = jax_pred.resident_podlabels(jsnap, jst, rel)
            _eq(Hb, jHb, f"Hb {what}")
            _eq(Ab, jAb, f"Ab {what}")
            checked += int(Hb.sum())
            if rel and world == "releasing":   # the terminating residents count
                assert int(Hb.sum()) > int(predicates.resident_tables(snap, st)[0].sum())
            if snap.task_aff_topo.shape[1]:
                jHd, jAd = jax_pred.resident_domain_labels(jsnap, jst, rel)
                _eq(Hd, jHd, f"Hd {what}")
                _eq(Ad, jAd, f"Ad {what}")
            else:
                assert Hd is None and Ad is None
    assert checked > 0


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_affinity_predicate_and_row_match_reference(world):
    jsnap, snap, states = _states(_fields(world))
    rows = torch.nonzero(snap.task_mask & (
        snap.task_aff.any(1) | snap.task_anti.any(1) | snap.task_aff_topo.any(1)
        | snap.task_anti_topo.any(1) | snap.task_podlabels.any(1)))[:, 0].tolist()
    assert rows
    vetoed = 0
    for label, jst, st in states:
        for immediate in (False, True):
            got = predicates.pod_affinity_predicate(snap, st, immediate)
            want = jax_pred.pod_affinity_predicate(jsnap, jst, immediate)
            _eq(got, want, f"{label}, immediate={immediate}")
            vetoed += int((~got & snap.task_mask[:, None]
                           & snap.node_mask[None, :]).sum())
        for p in rows:
            _eq(predicates.pod_affinity_row(snap, st, torch.tensor(p)),
                jax_pred.pod_affinity_row(jsnap, jst, p), f"{label}, row {p}")
        _eq(predicates.bootstrap_mask(snap, st), jax_pred.bootstrap_mask(jsnap, jst),
            f"{label}, bootstrap_mask")
    assert vetoed > 0


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_affinity_words_match_reference(world):
    """The words' cells equal the reference's predicate in every state
    and orientation, with the task words built and with them kept."""
    jsnap, snap, states = _states(_fields(world))
    kept = None
    for label, jst, st in states:
        for immediate in (False, True):
            words = predicates.pod_affinity_words(snap, st, immediate)
            assert isinstance(words, k10.AffinityWords)
            if kept is None:
                kept = snap.affinity_task_words()
                assert kept is not None
            assert snap.affinity_task_words() is kept     # built once per snapshot
            np.testing.assert_array_equal(
                words.task_words.numpy(),
                k10.task_words_plain(*(getattr(snap, f) for f in (
                    "task_aff", "task_anti", "task_podlabels", "task_aff_topo",
                    "task_anti_topo"))).numpy())
            want = jax_pred.pod_affinity_predicate(jsnap, jst, immediate)
            _eq(k10.affinity_cells_plain(words), want,
                f"{label}, immediate={immediate}")
            _eq(k10.affinity_cells_plain(words),
                predicates.pod_affinity_predicate(snap, st, immediate).numpy(),
                f"{label}, immediate={immediate}, mask")


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_propose_words_form_matches_mask_form(world):
    """K2's plain passes given the words equal the same passes given
    the mask K10 makes from the same tables, on an auction round of the
    default conf in both passes (Idle and FutureIdle)."""
    _jsnap, snap, states = _states(_fields(world))
    policy, _ = build_policy(default_conf())
    spec = policy.score_spec()
    pred = policy.predicate_mask(snap)
    for label, _jst, st in states:
        st = policy.setup_state(snap, st)
        for use_future in (False, True):
            immediate = not use_future
            avail = st.node_future if use_future else st.node_idle
            pending = (st.task_state == 0) & snap.task_mask
            eligible = pending & policy.eligible_fn(snap, st)
            extras = spec.extra_terms(snap, st)
            words = policy.dyn_predicate_words(snap, st, immediate)
            mask = policy.dynamic_predicate_fn(snap, st, immediate)
            assert isinstance(words, k10.AffinityWords) and mask.dtype == torch.bool
            common = (snap.task_req, avail, snap.eps, snap.node_mask, eligible,
                      st.node_future, snap.node_cap, spec, extras, policy.score_quantum)
            best_w = k2.propose_best(pred, words, *common)
            best_m = k2.propose_best(pred, mask, *common)
            for a, b in zip(best_w, best_m):
                np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=label)
            k = tie_ordinal(best_w[2], policy.rank_fn(snap, st), best_w[1])
            pick_w = k2.propose_pick(pred, words, *common, best_w[0], best_w[2], k)
            pick_m = k2.propose_pick(pred, mask, *common, best_m[0], best_m[2], k)
            np.testing.assert_array_equal(pick_w.numpy(), pick_m.numpy(), err_msg=label)
            assert bool(best_w[2].any())


def test_policy_takes_words_only_for_affinity_alone():
    """`auction_dyn_predicate` gives K2 the words when inter-pod affinity
    is the only dynamic predicate and constrains the snapshot; the mask
    when another dynamic predicate is registered; None without terms."""
    _jsnap, snap, states = _states(_fields("affinity"))
    st = states[0][2]
    policy, _ = build_policy(default_conf())
    assert isinstance(policy.auction_dyn_predicate(snap, st, True), k10.AffinityWords)
    extra = torch.ones((snap.num_tasks, snap.num_nodes), dtype=torch.bool)
    policy.add_dynamic_predicate_fn(lambda s, state, imm: extra, row_fn=lambda *a: None)
    assert policy.dyn_predicate_words(snap, st, True) is None
    got = policy.auction_dyn_predicate(snap, st, True)
    _eq(got, predicates.pod_affinity_predicate(snap, st, True).numpy(), "mask form")

    plain_snap = from_numpy(jax_fields("config3")[0], "cpu")
    policy, _ = build_policy(default_conf())
    st = policy.setup_state(plain_snap, init_state(plain_snap))
    assert policy.auction_dyn_predicate(plain_snap, st, True) is None


@pytest.mark.parametrize("world", ["config5_affinity_small", "releasing"])
def test_cancelled_acceptances_add_up(world, monkeypatch):
    """Per round, the acceptances the watermark and the two serialize
    steps cancel (counted on the device) add up to what K3 accepted less
    what the round keeps; `allocate_rounds` reports them per solve."""
    _jsnap, snap, _states_ = _states(_fields(world))
    policy, _ = build_policy(default_conf())
    st = policy.setup_state(snap, init_state(snap))
    k3_accepts = []
    real = k3.resolve

    def spy(*args):
        out = real(*args)
        k3_accepts.append(int(out.sum()))
        return out

    monkeypatch.setattr(k3, "resolve", spy)
    stats: dict = {}
    kept = []
    real_round = auction_round

    import kube_batch_tpu_torch.ops.assignment as ops

    def round_spy(*args):
        accept, perm, s_node = real_round(*args)
        kept.append(int(accept.sum()))
        return accept, perm, s_node

    monkeypatch.setattr(ops, "auction_round", round_spy)
    allocate_rounds(snap, st, policy.predicate_mask(snap), policy.score_spec(),
                    policy.rank_fn, policy.eligible_fn, snap.eps,
                    dyn_predicate_fn=policy.auction_dyn_predicate,
                    global_serialize_fn=policy.global_serialize_fn,
                    domain_serialize_fn=policy.domain_serialize_fn,
                    serialize_mask=policy.serialize_mask(snap, st), stats=stats)
    assert set(stats["cancelled"]) == set(CANCEL_STEPS)
    assert all(v >= 0 for v in stats["cancelled"].values())
    assert sum(stats["cancelled"].values()) == sum(k3_accepts) - sum(kept)
    assert len(kept) == stats["rounds"]


def _jax_score_term(name):
    """The reference's registered pod-affinity score function."""
    policy, _ = jax_build_policy(jax_default_conf())
    fns = [fn for _w, fn in policy.node_scores if fn.__name__ == name]
    assert len(fns) == 1
    return fns[0]


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_pod_affinity_score_matches_reference(world):
    jsnap, snap, states = _states(_fields(world))
    want_fn = _jax_score_term("pod_affinity_score")
    nonzero = 0
    for label, jst, st in states:
        st.aux.clear()
        got = nodeorder.pod_affinity_score(snap, st)
        want = np.asarray(want_fn(jsnap, jst))
        if got is None:
            assert not want.any(), label
            continue
        np.testing.assert_array_equal(got.numpy(), want, err_msg=label)
        nonzero += int((want > 0).sum())
    if world != "affinity":
        assert nonzero > 0


_POD_SPEC = ("request", "priority", "namespace", "selector", "labels",
             "affinity", "anti_affinity", "pod_prefs", "preferences",
             "tolerations", "ports", "claims")


def _wave(cl, cache, sim, n_pods: int) -> None:
    """chip_smoke.arrivals with a package's own objects: the world's
    first jobs submitted again under new names until `n_pods` arrived."""
    jobs = [(j.pod_group, list(j.tasks.values())) for j in cache._jobs.values()]
    sent = 0
    for group, pods in jobs:
        if sent >= n_pods:
            break
        sim.submit(
            cl.PodGroup(name=f"late-{group.name}", queue=group.queue,
                        min_member=group.min_member, priority=group.priority),
            [cl.Pod(name=f"late-{p.name}", **{f: getattr(p, f) for f in _POD_SPEC})
             for p in pods])
        sent += len(pods)


def _run_cycles(pkg: str, cycles: int = 2):
    cache, sim = build_world("config5_affinity_small", pkg)
    sched = (JaxScheduler(cache, schedule_period=0.0) if pkg == "jax"
             else Scheduler(cache, device="cpu"))
    out = []
    for cycle in range(cycles):
        ssn = sched.run_once()
        if pkg == "jax":
            state, node, ready = (ssn.host_task_state(), ssn.host_task_node(),
                                  ssn.job_ready())
        else:
            state, node, ready = ssn.host_task_state, ssn.host_task_node, ssn.job_ready
        meta = ssn.meta
        out.append({
            "bound": sorted(ssn.bound),
            "tasks": {p.name: (int(state[t]),
                               meta.node_names[node[t]] if node[t] >= 0 else None)
                      for t, p in enumerate(meta.task_pods)},
            "job_ready": {n: bool(ready[j]) for j, n in enumerate(meta.job_names)},
        })
        sim.tick()
        if cycle == 0:
            _wave(PACKAGES[pkg][0], cache, sim, 120)
    return out


def test_default_cycle_on_affinity_world_matches_reference():
    want = _run_cycles("jax")
    got = _run_cycles("torch")
    for c, (g, w) in enumerate(zip(got, want)):
        assert g == w, c
    assert got[0]["bound"] and got[1]["bound"]


# ---------------------------------------------------------------------------
# the plain versions against the kernels' own arithmetic
# ---------------------------------------------------------------------------

def _random_inputs(seed):
    rng = np.random.default_rng(seed)
    T, N, K, K2, TK, D = 96, 24, 40, 36, 3, 16

    def hot(shape, p):
        m = (rng.random(shape) < p).astype(np.float32)
        m[T - 8:] = 0.0                          # padded tasks
        return m

    labels, aff, anti = hot((T, K), 0.15), hot((T, K), 0.05), hot((T, K), 0.04)
    labels[:, K - 5:] = 0.0                      # padded label columns
    aff_topo, anti_topo = hot((T, K2), 0.05), hot((T, K2), 0.04)
    term_key = rng.integers(0, 2, K2).astype(np.int32)
    term_label = rng.integers(0, K - 5, K2).astype(np.int32)
    aff_topo[:, K2 - 4:] = anti_topo[:, K2 - 4:] = 0.0
    term_key[K2 - 4:] = term_label[K2 - 4:] = 0     # padded term columns
    nkd = np.full((N, TK), D - 1, np.int32)          # dead domain
    nkd[:N - 4, 0] = rng.integers(0, 6, N - 4)
    nkd[:N - 4, 1] = rng.integers(6, 10, N - 4)
    state = rng.integers(0, 10, T).astype(np.int32)
    node = rng.integers(-1, N - 4, T).astype(np.int32)
    mask = np.arange(T) < T - 8
    t = [torch.from_numpy(x) for x in (labels, aff, anti, aff_topo, anti_topo,
                                       term_key, term_label, nkd, state, node, mask)]
    return t, N, D


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_tables_and_mask_match_bit_arithmetic(seed):
    """K11's plain version is presence as an OR over residents; K10's is,
    per cell, popcounts of 0/1 words against the thresholds need -
    bootstrap and no anti or symmetry hit — the kernels' arithmetic,
    written out in numpy over padded columns and the dead domain."""
    (labels, aff, anti, aff_topo, anti_topo, term_key, term_label, nkd,
     state, node, mask), N, D = _random_inputs(seed)
    T, K = labels.shape
    K2, TK = aff_topo.shape[1], nkd.shape[1]
    tables = {}
    for rel in (False, True):
        got = k11.resident_tables(labels, anti, anti_topo, node, state, mask, nkd,
                                  term_key, term_label, N, D, rel)
        held = mask.numpy() & (node.numpy() >= 0) & np.isin(
            state.numpy(), (1, 2, 3, 4, 5) + ((6,) if rel else ()))
        Hb = np.zeros((N, K), bool)
        Ab = np.zeros((N, K), bool)
        Hd = np.zeros((D, K), bool)
        Ad = np.zeros((D, K), bool)
        for t in np.nonzero(held)[0]:
            n = node[t].item()
            Hb[n] |= labels[t].numpy() > 0
            Ab[n] |= anti[t].numpy() > 0
            for tk in range(TK):
                Hd[nkd[n, tk]] |= labels[t].numpy() > 0
            for j in np.nonzero(anti_topo[t].numpy() > 0)[0]:
                Ad[nkd[n, term_key[j]], term_label[j]] = True
        for g, w in zip(got, (Hb, Ab, Hd, Ad)):
            np.testing.assert_array_equal(g.numpy(), w)
        tables[rel] = got
    assert tables[True][3][D - 1].sum() == 0 and tables[True][2][D - 1].any()

    Hb, Ab, Hd, Ad = (x.numpy() for x in tables[False])
    Hbn, Abn, Hdn, Adn = (x.numpy() for x in tables[True])
    fields = (aff, anti, labels, aff_topo, anti_topo, term_key, term_label, nkd)
    got = k10.affinity_mask(*fields, *(torch.from_numpy(x) for x in
                                       (Hb, Hbn, Abn, Hd, Hdn, Adn))).numpy()
    exists = Hb.any(0)
    L, A, An = labels.numpy() > 0, aff.numpy() > 0, anti.numpy() > 0
    At, Ant = aff_topo.numpy() > 0, anti_topo.numpy() > 0
    want = np.zeros((T, N), bool)
    for t in range(T):
        thr = A[t].sum() - (A[t] & L[t] & ~exists).sum()
        own2 = L[t][term_label]
        thr2 = At[t].sum() - (At[t] & own2 & ~exists[term_label]).sum()
        for n in range(N):
            pres = Hd[nkd[n, term_key], term_label]
            now = Hdn[nkd[n, term_key], term_label]
            sym = Abn[n] | np.any(Adn[nkd[n]], axis=0)
            want[t, n] = ((A[t] & Hb[n]).sum() >= thr and (At[t] & pres).sum() >= thr2
                          and not (An[t] & Hbn[n]).any() and not (L[t] & sym).any()
                          and not (Ant[t] & now).any())
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size
    future = k10.affinity_mask(*fields, *(torch.from_numpy(x) for x in
                                          (Hb, Hb, Ab, Hd, Hd, Ad))).numpy()
    for p in range(T):
        row = k10.affinity_row(*fields, *(torch.from_numpy(x) for x in (Hb, Ab, Hd, Ad)),
                               torch.tensor(p)).numpy()
        np.testing.assert_array_equal(row, future[p])


def test_affinity_wrappers_refuse_other_devices():
    """K10 and K11 run their plain versions only for CPU tensors; a
    tensor on any other device than the CPU or a CUDA card is refused."""
    meta = torch.device("meta")
    f = torch.zeros((4, 8), device=meta)
    i = torch.zeros(2, dtype=torch.int32, device=meta)
    nkd = torch.zeros((3, 1), dtype=torch.int32, device=meta)
    b = torch.zeros((3, 8), dtype=torch.bool, device=meta)
    m = torch.zeros(4, dtype=torch.bool, device=meta)
    t = torch.zeros(4, dtype=torch.int32, device=meta)
    with pytest.raises(RuntimeError):
        k11.resident_tables(f, f, f[:, :2], t, t, m, nkd, i, i, 3, 2)
    with pytest.raises(RuntimeError):
        k10.affinity_mask(f, f, f, f[:, :2], f[:, :2], i, i, nkd, b, b, b, b, b, b)
    with pytest.raises(RuntimeError):
        k10.affinity_row(f, f, f, f[:, :2], f[:, :2], i, i, nkd, b, b, b, b, 0)
