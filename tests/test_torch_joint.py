"""The port's joint single-solve cycle against the reference's, on CPU.

* `make_cycle_solver(policy, actions, joint=True)` on the worlds of
  tests/test_joint_solve.py — priority preemption, cross-queue reclaim,
  multi-preemptor, allocate + backfill, and the pinned admission world
  where the joint cycle admits what the sequential one refuses — against
  kube_batch_tpu/actions/fused.py · make_cycle_solver(joint=True) on the
  same packed fields: task_state, task_node, node_future, node_idle, the
  eviction masks, job_ready and the failure tallies exactly equal.
* The tier list's shape and the refusal of a custom action.
* `Scheduler.run_once` with `joint_solve=True` / KB_TPU_JOINT_SOLVE=1:
  `last_stats["cycle"]` says "joint", per-tier steps and ms are
  reported, and each cycle of the small config-5 affinity world under
  examples/scheduler.conf (with an oversubscribing wave, so the evict
  tiers open plans; its gangs run at minMember, so none may evict)
  equals the reference's joint cycle on the port's own packed arrays;
  an unfoldable conf runs the sequential cycle.
* Kernel K12's plain version (the tier work tests and the advance, fed
  by the step it follows) against a numpy transcription of the
  reference's `_haswork_fn`, `tier_done` and `advance`; the work mask it
  writes against the mask the reference's `_haswork_fn` reduces, for
  every tier of the joint worlds; and the loop computing each tier's
  masks once an iteration, with one K12 call and one host read.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from kube_batch_tpu.actions.fused import build_joint_phases as jax_joint_phases
from kube_batch_tpu.actions.fused import make_cycle_solver as jax_cycle_solver
from kube_batch_tpu.api.snapshot import SnapshotTensors as JaxSnapshot
from kube_batch_tpu.cache.cluster import Node, Pod, PodGroup, Queue
from kube_batch_tpu.cache.packer import pack_snapshot_host
from kube_batch_tpu.framework.conf import default_conf as jax_default_conf
from kube_batch_tpu.framework.conf import parse_conf as jax_parse_conf
from kube_batch_tpu.framework.session import build_policy as jax_build_policy
from kube_batch_tpu.models.workloads import GI
from kube_batch_tpu.ops.assignment import init_state as jax_init_state
from kube_batch_tpu.sim.simulator import make_world
from kube_batch_tpu_torch.actions.fused import build_joint_phases, make_cycle_solver
from kube_batch_tpu_torch.api.snapshot import FIELDS, from_numpy
from kube_batch_tpu_torch.framework.conf import default_conf, parse_conf
from kube_batch_tpu_torch.framework.plugin import ACTION_REGISTRY
from kube_batch_tpu_torch.framework.session import build_policy
from kube_batch_tpu_torch.kernels import joint_tier as k12
from kube_batch_tpu_torch.ops.assignment import init_state
from kube_batch_tpu_torch.ops import joint as joint_ops
from kube_batch_tpu_torch.ops.joint import AuctionPhase, EvictPhase
from kube_batch_tpu_torch.scheduler import Scheduler
from test_joint_solve import (
    SPEC,
    _pods,
    _run_cycle,
    _world_cross_queue_reclaim,
    _world_multi_preemptor,
    _world_priority_preempt,
)
from test_torch_affinity import _wave
from test_torch_pack import PACKAGES, build_world

FOUR = ("allocate", "backfill", "preempt", "reclaim")
CONF_PATH = os.path.join(os.path.dirname(__file__), "..", "examples", "scheduler.conf")


def _world_allocate_backfill():
    """tests/test_joint_solve.py · test_joint_parity_allocate_backfill."""
    cache, sim = make_world(SPEC)
    for i in range(2):
        sim.add_node(Node(name=f"n{i}",
                          allocatable={"cpu": 4000, "memory": 8 * GI, "pods": 110}))
    sim.submit(PodGroup(name="work", queue="default", min_member=2),
               _pods("work", 3, 1500, 2 * GI, 0))
    sim.submit(PodGroup(name="be", queue="default", min_member=1),
               [Pod(name=f"be-{i}", request={"pods": 1}) for i in range(2)])
    return cache


def _world_admission():
    """tests/test_joint_solve.py ·
    test_joint_admits_placement_sequential_refuses: n0 is full with gang
    G (W 3 cpu, W2 1 cpu); X (queue qa) and Y (a late member of G) are
    pending.  Y's intra-job preemption frees W's surplus after X was
    latched `tried`; only the joint admission tier places X."""
    cache, sim = make_world(SPEC)
    sim.add_queue(Queue(name="qa", weight=1.0))
    sim.add_queue(Queue(name="qb", weight=1.0))
    sim.add_node(Node(name="n0",
                      allocatable={"cpu": 4000, "memory": 16 * GI, "pods": 110}))
    sim.submit(PodGroup(name="G", queue="qb", min_member=1), [
        Pod(name="G-w", request={"cpu": 3000, "memory": 4 * GI, "pods": 1}, priority=0),
        Pod(name="G-w2", request={"cpu": 1000, "memory": 1 * GI, "pods": 1},
            priority=500),
    ])
    _run_cycle(cache, ["allocate"])
    sim.tick()
    sim.submit(PodGroup(name="JA", queue="qa", min_member=1, priority=1000), [
        Pod(name="X", request={"cpu": 1500, "memory": 2 * GI, "pods": 1}, priority=1000)])
    sim.submit_to_group("G", [
        Pod(name="Y", request={"cpu": 1000, "memory": 1 * GI, "pods": 1}, priority=1000)])
    return cache


WORLDS = {
    "priority_preempt": (_world_priority_preempt, FOUR, {"preempt": 2, "reclaim": 0}),
    "cross_queue_reclaim": (_world_cross_queue_reclaim, FOUR,
                            {"preempt": 0, "reclaim": 2}),
    "multi_preemptor": (_world_multi_preemptor, FOUR, {"preempt": 3}),
    "allocate_backfill": (_world_allocate_backfill, ("allocate", "backfill"), {}),
    "admission": (_world_admission, ("allocate", "preempt"), {"preempt": 1}),
}

_JAX = {}


def _jax_cycle(actions, joint: bool, conf_text: str | None = None):
    key = (actions, joint, conf_text)
    if key not in _JAX:
        conf = (jax_parse_conf(conf_text) if conf_text else
                dataclasses.replace(jax_default_conf(), actions=actions))
        policy, _ = jax_build_policy(conf)
        _JAX[key] = jax.jit(jax_cycle_solver(policy, conf.actions, joint=joint))
    return _JAX[key]


def _solve(fields, actions, joint: bool):
    """(jax result, port result, port stats) of one cycle on `fields`."""
    jsnap = JaxSnapshot(**fields)
    want = _jax_cycle(actions, joint)(jsnap, jax_init_state(jsnap))
    policy, _ = build_policy(dataclasses.replace(default_conf(), actions=actions))
    snap = from_numpy(fields, "cpu")
    stats: dict = {}
    got = make_cycle_solver(policy, actions, joint=joint)(snap, init_state(snap), stats)
    return want, got, stats


def _assert_equal(got, want):
    t_state, t_evict, t_ready, t_diag = got
    j_state, j_evict, j_ready, j_diag = want
    for name in ("task_state", "task_node", "node_future", "node_idle"):
        np.testing.assert_array_equal(getattr(t_state, name).numpy(),
                                      np.asarray(getattr(j_state, name)), err_msg=name)
    assert sorted(t_evict) == sorted(j_evict)
    for name in t_evict:
        np.testing.assert_array_equal(t_evict[name].numpy(), np.asarray(j_evict[name]),
                                      err_msg=name)
    np.testing.assert_array_equal(t_ready.numpy(), np.asarray(j_ready))
    for key in ("nodes", "predicate_failed", "insufficient", "feasible"):
        np.testing.assert_array_equal(t_diag[key].numpy(), np.asarray(j_diag[key]),
                                      err_msg=key)


def _fields(build):
    snap, meta = pack_snapshot_host(build().snapshot())
    return {f.name: np.asarray(getattr(snap, f.name))
            for f in dataclasses.fields(snap)}, meta


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_joint_cycle_matches_reference(world):
    build, actions, evictions = WORLDS[world]
    fields, _ = _fields(build)
    want, got, stats = _solve(fields, actions, joint=True)
    _assert_equal(got, want)
    for name, count in evictions.items():
        assert int(got[1][name].sum()) == count, (name, got[1])
    tiers = stats["joint_tiers"]
    assert [t["tier"] for t in tiers] == [ph.name for ph in build_joint_phases(
        build_policy(dataclasses.replace(default_conf(), actions=actions))[0],
        actions)]
    if evictions.get("preempt") or evictions.get("reclaim"):
        assert any(t["kind"] == "evict" and t["evicted"] for t in tiers)


def test_joint_admits_placement_sequential_refuses():
    fields, meta = _fields(_world_admission)
    actions = ("allocate", "preempt")
    j_want, j_got, _ = _solve(fields, actions, joint=True)
    s_want, s_got, _ = _solve(fields, actions, joint=False)
    _assert_equal(j_got, j_want)
    _assert_equal(s_got, s_want)
    names = [p.name for p in meta.task_pods]
    x, w = names.index("X"), names.index("G-w")
    for got in (j_got, s_got):
        assert got[1]["preempt"].nonzero().flatten().tolist() == [w]
    seq_state = s_got[0].task_state.numpy()
    joint_state = j_got[0].task_state.numpy()
    assert seq_state[x] == 0 and joint_state[x] != 0
    assert j_got[0].task_node[x].item() == 0
    placed_seq, placed_joint = seq_state != 0, joint_state != 0
    assert np.all(placed_joint[placed_seq])
    assert int(placed_joint.sum()) == int(placed_seq.sum()) + 1


def test_joint_phase_list_shape():
    policy, _ = build_policy(dataclasses.replace(default_conf(), actions=FOUR))
    phases = build_joint_phases(policy, FOUR)
    assert [type(p).__name__ for p in phases] == [
        "AuctionPhase", "AuctionPhase", "AuctionPhase",
        "EvictPhase", "EvictPhase", "EvictPhase", "AuctionPhase",
    ]
    assert phases[-1].gated_on_evictions and phases[-1].use_future
    assert [p.evict_code for p in phases if isinstance(p, EvictPhase)] == [3, 3, 4]
    phases = build_joint_phases(policy, ("allocate", "backfill"))
    assert all(isinstance(p, AuctionPhase) for p in phases)
    assert not any(p.gated_on_evictions for p in phases)


def test_joint_refuses_custom_actions():
    from kube_batch_tpu_torch.actions.allocate import AllocateAction

    policy, _ = build_policy(default_conf())
    with pytest.raises(ValueError, match="joint"):
        make_cycle_solver(policy, ("allocate", "bogus"), joint=True)

    class ShadowAllocate(AllocateAction):
        pass

    prev = ACTION_REGISTRY["allocate"]
    ACTION_REGISTRY["allocate"] = ShadowAllocate
    try:
        with pytest.raises(ValueError, match="not a built-in"):
            make_cycle_solver(policy, ("allocate",), joint=True)
    finally:
        ACTION_REGISTRY["allocate"] = prev


def test_scheduler_joint_flag_and_environment(monkeypatch):
    """KB_TPU_JOINT_SOLVE=1 selects the joint cycle, an explicit
    joint_solve wins over it, and a conf the joint solve cannot fold
    runs the sequential cycle (last_stats["cycle"] says which)."""
    from kube_batch_tpu_torch.actions.allocate import AllocateAction
    from kube_batch_tpu_torch.models.workloads import build_config

    monkeypatch.setenv("KB_TPU_JOINT_SOLVE", "1")
    cache, _ = build_config(1)
    sched = Scheduler(cache, device="cpu")
    assert sched.cycle_kind == "joint"
    sched.run_once()
    assert sched.last_stats["cycle"] == "joint"
    assert [t["tier"] for t in sched.last_stats["joint_tiers"]] == [
        "allocate:idle", "allocate:future", "backfill"]
    assert all(t["steps"] >= 0 and t["ms"] >= 0 for t in sched.last_stats["joint_tiers"])
    assert Scheduler(cache, device="cpu", joint_solve=False).cycle_kind == "sequential"

    class ShadowAllocate(AllocateAction):
        pass

    prev = ACTION_REGISTRY["allocate"]
    ACTION_REGISTRY["allocate"] = ShadowAllocate
    try:
        sched = Scheduler(build_config(1)[0], device="cpu")
        assert sched.cycle_kind == "sequential"
        sched.run_once()
        assert sched.last_stats["cycle"] == "sequential"
    finally:
        ACTION_REGISTRY["allocate"] = prev
    monkeypatch.setenv("KB_TPU_JOINT_SOLVE", "0")
    assert Scheduler(cache, device="cpu").cycle_kind == "sequential"


def test_scheduler_joint_cycle_on_affinity_world_matches_reference():
    """The small config-5 affinity world under examples/scheduler.conf,
    joint solve, 2 cycles with a wave that oversubscribes the cluster:
    every cycle's decisions equal the reference's joint cycle on the
    port's own packed arrays, and the evict tiers take steps."""
    with open(CONF_PATH) as f:
        conf_text = f.read()
    cl = PACKAGES["torch"][0]
    cache, sim = build_world("config5_affinity_small", "torch")
    sched = Scheduler(cache, conf=parse_conf(conf_text), device="cpu", joint_solve=True)
    jax_cycle = _jax_cycle(FOUR, True, conf_text)
    evict_steps = 0
    for cycle in range(2):
        ssn = sched.run_once()
        assert sched.last_stats["cycle"] == "joint"
        a = sched.packer._ints.arrays
        jsnap = JaxSnapshot(**{f: a[f] for f in FIELDS})
        j_state, j_evict, j_ready, _ = jax_cycle(jsnap, jax_init_state(jsnap))
        np.testing.assert_array_equal(ssn.host_task_state, np.asarray(j_state.task_state))
        np.testing.assert_array_equal(ssn.host_task_node, np.asarray(j_state.task_node))
        np.testing.assert_array_equal(ssn.job_ready, np.asarray(j_ready))
        names = [p.name for p in ssn.meta.task_pods]
        want = sorted((names[t], reason) for name, reason in
                      (("preempt", "preempted"), ("reclaim", "reclaimed"))
                      for t in np.nonzero(np.asarray(j_evict[name]))[0])
        assert sorted(ssn.evicted) == want
        evict_steps += sum(t["steps"] for t in sched.last_stats["joint_tiers"]
                           if t["kind"] == "evict")
        sim.tick()
        if cycle == 0:
            _wave(cl, cache, sim, 400)
    assert evict_steps > 0


# ---------------------------------------------------------------------------
# K12's plain version against the reference's tier control, in numpy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", [k12.AUCTION, k12.EVICT])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tier_control_matches_reference_arithmetic(kind, seed):
    """One K12 call fed by the step it follows (an auction round's accept
    mask, or an evict step's flag vector): the work mask, the packed read
    and the advance in place."""
    rng = np.random.default_rng(seed + 10 * kind)
    T, N, J, R = 64, 6, 9, 4
    gated = seed % 2
    progressed, step = (seed != 2), (100 if seed == 3 else 3)
    prov_active = int(seed in (1, 3)) if kind == k12.EVICT else 0
    x = {
        "task_state": rng.integers(0, 8, T).astype(np.int32),
        "snap_state": rng.integers(0, 8, T).astype(np.int32),
        "task_mask": rng.random(T) < 0.9,
        "elig": rng.random(T) < (0.0 if seed == 1 else 0.1),
        "starving": rng.random(J) < 0.5,
        "task_job": rng.integers(-1, J, T).astype(np.int32),
        "tried": rng.random(T) < 0.3,
        "prov": rng.random(T) < 0.1,
        "code": (rng.random(T) < 0.05).astype(np.int32) * 2,
        "task_req": rng.integers(0, 8, (T, R)).astype(np.float32) * 1000,
        "node_future": rng.integers(-4, 16, (N, R)).astype(np.float32) * 1000,
        "excl": rng.random(N) < 0.3,
        "phase": np.array([3], np.int32),
    }
    if kind == k12.EVICT:
        step_flags = np.array([progressed, prov_active, 4, 1, 0, 0, 1], np.int64)
        step_out = torch.from_numpy(step_flags.copy())
    else:
        accept = (rng.random(T) < 0.1) & progressed
        step_flags = np.array([accept.sum(), 0, 0, 0, 0, 0, 0], np.int64)
        step_out = torch.from_numpy(accept)
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    work, read = k12.tier_buffers(T, "cpu")
    out = k12.tier_control(kind, gated, step, 50, step_out, *t.values(), work, read)
    assert out is read

    pending = (x["task_state"] == 0) & x["task_mask"]
    want_work = pending & x["elig"]
    if kind == k12.EVICT:
        tj = np.clip(x["task_job"], 0, J - 1)
        want_work = want_work & x["starving"][tj] & (x["task_job"] >= 0) & ~x["tried"]
        has_work = bool(want_work.any()) or bool(prov_active)
    else:
        has_work = bool(want_work.any()) and (not gated or bool((x["code"] > 0).any()))
    progressed = bool(step_flags[0])
    done = (not progressed) or step >= 50 or not has_work
    want = {k: v.copy() for k, v in x.items()}
    if done:
        if prov_active:
            p = x["prov"]
            want["task_state"] = np.where(p, x["snap_state"], x["task_state"])
            want["code"] = np.where(p, 0, x["code"])
            want["node_future"][4] -= x["task_req"][p].sum(0)
        want["tried"][:] = want["prov"][:] = want["excl"][:] = False
        want["phase"] += 1
    np.testing.assert_array_equal(work.numpy(), want_work)
    assert read.tolist() == step_flags.tolist() + [int(done), int(has_work),
                                                   int(want["phase"][0])]
    for k in want:
        np.testing.assert_array_equal(t[k].numpy(), want[k], err_msg=k)


def test_tier_control_first_call_of_a_tier():
    """At a tier's first call (no step yet) the tier counts as progressed:
    it ends only on an empty work test or a zero step bound."""
    T, N = 16, 3
    z = torch.zeros(T, dtype=torch.int32)
    mask = torch.ones(T, dtype=torch.bool)
    req = torch.ones((T, 2))
    for elig, bound, want_done in ((mask, 5, 0), (~mask, 5, 1), (mask, 0, 1)):
        work, read = k12.tier_buffers(T, "cpu")
        k12.tier_control(k12.AUCTION, 0, 0, bound, None, z.clone(), z, mask, elig, None,
                         z, torch.zeros(T, dtype=torch.bool),
                         torch.zeros(T, dtype=torch.bool), z.clone(), req,
                         torch.zeros((N, 2)), torch.zeros(N, dtype=torch.bool),
                         torch.zeros(1, dtype=torch.int32), work, read)
        assert read.tolist()[:7] == [0] * 7
        assert read.tolist()[7:] == [want_done, int(bool(elig.any())), want_done]
        np.testing.assert_array_equal(work.numpy(), elig.numpy())


def _reference_work(jsnap, jst, ph, tried):
    """The mask the reference's `_haswork_fn` reduces for tier `ph`."""
    import jax.numpy as jnp

    work = (jst.task_state == 0) & jsnap.task_mask & ph.eligible_fn(jsnap, jst)
    if hasattr(ph, "starving_fn"):
        tj = jnp.clip(jsnap.task_job, 0, jsnap.num_jobs - 1)
        work = (work & ph.starving_fn(jsnap, jst)[tj] & (jsnap.task_job >= 0)
                & ~jnp.asarray(tried))
    return np.asarray(work)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_tier_work_matches_reference_haswork(world):
    """The work mask `tier_control_plain` writes for every tier equals
    the mask of the reference's `_haswork_fn` (its tier's masks on the
    same state), on the packed state and on the state the joint cycle
    ends in, with a `tried` latch set on the evict tiers."""
    build, actions, _ = WORLDS[world]
    fields, _ = _fields(build)
    want, _got, _ = _solve(fields, actions, joint=True)
    conf = dataclasses.replace(jax_default_conf(), actions=actions)
    jpolicy, _ = jax_build_policy(conf)
    policy, _ = build_policy(dataclasses.replace(default_conf(), actions=actions))
    jphases, phases = jax_joint_phases(jpolicy, actions), build_joint_phases(policy, actions)
    assert [type(p).__name__ for p in jphases] == [type(p).__name__ for p in phases]
    jsnap, snap = JaxSnapshot(**fields), from_numpy(fields, "cpu")
    T, N = snap.num_tasks, snap.num_nodes
    end = want[0]
    worked = 0
    for jst in (jax_init_state(jsnap), jax_init_state(jsnap).replace(
            task_state=end.task_state, task_node=end.task_node,
            node_idle=end.node_idle, node_future=end.node_future)):
        jst = jpolicy.setup_state(jsnap, jst)
        st = policy.setup_state(snap, init_state(snap))
        st.task_state = torch.from_numpy(np.asarray(jst.task_state).copy())
        st.task_node = torch.from_numpy(np.asarray(jst.task_node).copy())
        st.node_idle = torch.from_numpy(np.asarray(jst.node_idle).copy())
        st.node_future = torch.from_numpy(np.asarray(jst.node_future).copy())
        tried = np.zeros(T, bool)
        tried[::3] = True
        for ph, jph in zip(phases, jphases):
            evict = isinstance(ph, EvictPhase)
            work, read = k12.tier_buffers(T, "cpu")
            k12.tier_control_plain(
                k12.EVICT if evict else k12.AUCTION, False, 0, 10, None,
                st.task_state.clone(), snap.task_state, snap.task_mask,
                ph.eligible_fn(snap, st), ph.starving_fn(snap, st) if evict else None,
                snap.task_job, torch.from_numpy(tried.copy()),   # cleared when done
                torch.zeros(T, dtype=torch.bool), torch.zeros(T, dtype=torch.int32),
                snap.task_req, st.node_future.clone(), torch.zeros(N, dtype=torch.bool),
                torch.zeros(1, dtype=torch.int32), work, read)
            ref = _reference_work(jsnap, jst, jph, tried)
            np.testing.assert_array_equal(work.numpy(), ref, err_msg=ph.name)
            assert read[k12.STEP_FLAGS + 1].item() == int(ref.any())
            worked += int(ref.sum())
    assert worked > 0


def test_joint_step_computes_tier_masks_once(monkeypatch):
    """Each iteration of the joint loop calls its tier's eligible_fn (and
    an evict tier's starving_fn) once, launches K12 once and reads one
    vector; the steps take K12's work mask and call neither again."""
    fields, _ = _fields(_world_priority_preempt)
    policy, _ = build_policy(dataclasses.replace(default_conf(), actions=FOUR))
    calls = {"eligible": 0, "starving": 0, "k12": 0, "reads": 0}

    def counted(key, fn):
        def wrapper(snap, state):
            calls[key] += 1
            return fn(snap, state)
        return wrapper

    phases = [dataclasses.replace(
        ph, eligible_fn=counted("eligible", ph.eligible_fn),
        **({"starving_fn": counted("starving", ph.starving_fn)}
           if isinstance(ph, EvictPhase) else {}))
        for ph in build_joint_phases(policy, FOUR)]
    real = k12.tier_control

    def spy(*args):
        calls["k12"] += 1
        return real(*args)

    monkeypatch.setattr(k12, "tier_control", spy)
    snap = from_numpy(fields, "cpu")
    state = policy.setup_state(snap, init_state(snap))
    stats: dict = {}
    read_buffers = []
    real_buffers = k12.tier_buffers

    def buffers(T, dev):
        work, read = real_buffers(T, dev)
        real_tolist = read.tolist

        def tolist():          # counts the loop's host reads of K12's buffer
            calls["reads"] += 1
            return real_tolist()

        read.tolist = tolist
        read_buffers.append(read)
        return work, read

    monkeypatch.setattr(k12, "tier_buffers", buffers)
    joint_ops.joint_rounds(snap, state, phases, policy.predicate_mask(snap),
                           policy.rank_fn, snap.eps, stats=stats)
    iterations = sum(t["steps"] + 1 for t in stats["joint_tiers"])
    evict_iterations = sum(t["steps"] + 1 for t in stats["joint_tiers"]
                           if t["kind"] == "evict")
    assert len(read_buffers) == 1
    assert calls["k12"] == calls["eligible"] == calls["reads"] == iterations
    assert calls["starving"] == evict_iterations > 1
    assert any(t["evicted"] for t in stats["joint_tiers"] if t["kind"] == "evict")


def test_tier_control_refuses_other_devices():
    meta = torch.device("meta")
    v = torch.zeros(4, dtype=torch.int32, device=meta)
    b = torch.zeros(4, dtype=torch.bool, device=meta)
    f = torch.zeros((4, 4), device=meta)
    r = torch.zeros(k12.READ, dtype=torch.int64, device=meta)
    with pytest.raises(RuntimeError):
        k12.tier_control(k12.AUCTION, 0, 0, 1, None, v, v, b, b, None, v, b, b, v,
                         f, f, b, v[:1], b, r)
