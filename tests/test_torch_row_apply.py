"""K10's row operand (the preemptor's inter-pod affinity test that kernel
K5 makes inside its own launch) and K3 `apply`: their plain versions
against the reference package on the CPU.  chip_smoke.py holds the CUDA
kernels equal to these plain versions on the card (`phase_k10_row_edge`,
`phase_k3_apply_edge` and every recorded call), so these tests pin the
kernels' function.  Every comparison is exact.

* The preemption steps of three worlds under examples/scheduler.conf,
  sequentially (preempt and reclaim) and with the joint solve: the parity feature world, the small config-5 affinity world
  (48 nodes) with an oversubscribing wave after cycle 1, and a 4-node
  world whose preemptors need anchors for their required affinity and
  avoid an anti-affinity label, so their plans evict twice (continuing
  steps test one cell, inside K6's launch).  The cycle that preempts (the first, or for the
  affinity world the one after its wave) has task_state, task_node,
  evictions and job_ready equal to the reference's cycle on the port's
  own packed arrays; at each of its steps the operand's row, and its
  cell (p, n) at a node that moves with the step, equal the reference's
  pod_affinity_row(snap, state, p).
* An opening step makes no row call (K5 tests it), nor does a continuing
  step (K6 tests the cell at its node); the policy composes a plain bool row with the operand as
  K5's mask, and K5's plain version ANDs both.
* `apply_plain` (through the CPU wrapper) against the reference's apply
  (kube_batch_tpu/ops/assignment.py:421-431, its jnp expressions): one
  node taking every accepted row, accept sets with holes, use_future
  true and false, R = 1 and 8, an empty accept set.
* `resolve_plain` on T = 1,048,577 rows against
  kube_batch_tpu/ops/assignment.py · _resolve_conflicts (the kernel's
  scratch route takes this T since this change).
"""

from __future__ import annotations

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_batch_tpu.actions.fused import make_cycle_solver as jax_cycle_solver
from kube_batch_tpu.api.snapshot import SnapshotTensors as JaxSnapshot
from kube_batch_tpu.framework.conf import parse_conf as jax_parse_conf
from kube_batch_tpu.framework.session import build_policy as jax_build_policy
from kube_batch_tpu.ops.assignment import _resolve_conflicts
from kube_batch_tpu.ops.assignment import init_state as jax_init_state
from kube_batch_tpu.plugins import predicates as jax_pred
from kube_batch_tpu_torch.api.snapshot import FIELDS
from kube_batch_tpu_torch.framework.conf import parse_conf
from kube_batch_tpu_torch.kernels import affinity as k10
from kube_batch_tpu_torch.kernels import resolve as k3
from kube_batch_tpu_torch.kernels import victim_prefix as k5
from kube_batch_tpu_torch.plugins import predicates
from kube_batch_tpu_torch.scheduler import Scheduler
from test_torch_affinity import _wave
from test_torch_pack import PACKAGES, build_world

import chip_smoke

FOUR = ("allocate", "backfill", "preempt", "reclaim")
CONF_PATH = os.path.join(os.path.dirname(__file__), "..", "examples", "scheduler.conf")
GI = float(1 << 30)


def _conf_text() -> str:
    with open(CONF_PATH) as f:
        return f.read()


# ---------------------------------------------------------------------------
# worlds (the port's objects): (cache, sim, wave after cycle 1 or None)
# ---------------------------------------------------------------------------

def _affinity_evictions():
    """4 nodes of 4 cpu; a high-priority db anchor on n0-n2 and three
    low-priority fillers on every node, those of n1 labelled app=batch.
    Two high-priority pending pods (jobs of their own) need a db anchor (required affinity)
    and no app=batch resident (anti-affinity): only n0 and n2 qualify,
    and each needs two fillers evicted (open, evict, evict, finalize)."""
    cl = PACKAGES["torch"][0]
    cl._uid_counter = itertools.count()
    from kube_batch_tpu_torch.models.workloads import DEFAULT_SPEC
    from kube_batch_tpu_torch.sim.simulator import make_world

    cache, sim = make_world(DEFAULT_SPEC)
    for i in range(4):
        sim.add_node(cl.Node(name=f"n{i}", labels={"zone": f"z{i % 2}"},
                             allocatable={"cpu": 4000, "memory": 16 * GI, "pods": 110}))

    def pod(name, cpu, prio=0, node=None, **kw):
        extra = {} if node is None else {"status": cl.TaskStatus.RUNNING, "node": node}
        return cl.Pod(name=name, request={"cpu": cpu, "memory": GI, "pods": 1},
                      priority=prio, **extra, **kw)

    for i in range(3):
        sim.submit(cl.PodGroup(name=f"db{i}", queue="default", min_member=1,
                               priority=1000),
                   [pod(f"db{i}-0", 1000, 1000, f"n{i}", labels={"app": "db"})])
    sim.submit(cl.PodGroup(name="low", queue="default", min_member=1), [
        pod(f"low-{n}-{k}", 1000, 0, f"n{n}",
            labels={"app": "batch" if n == 1 else "filler"})
        for n in range(4) for k in range(3)])
    for k in range(2):
        sim.submit(cl.PodGroup(name=f"hi{k}", queue="default", min_member=1,
                               priority=1000),
                   [pod(f"hi-{k}", 2000, 1000, affinity=frozenset({"app=db"}),
                        anti_affinity=frozenset({"app=batch"}))])
    return cache, sim, None


def _features():
    PACKAGES["torch"][0]._uid_counter = itertools.count()
    cache, sim = chip_smoke._feature_world()
    return cache, sim, lambda: chip_smoke.arrivals(cache, sim, 60)


def _config5_affinity_small():
    cl = PACKAGES["torch"][0]
    cache, sim = build_world("config5_affinity_small", "torch")
    return cache, sim, lambda: _wave(cl, cache, sim, 400)


# world: (build, the cycles checked against the reference): the feature
# world's first cycle already takes hundreds of preemption steps; the
# affinity world preempts only after its wave (each cycle checked
# compiles the reference's cycle at its shapes, about 13 s)
WORLDS = {"affinity_evictions": (_affinity_evictions, (0,)),
          "features_preempt": (_features, (0,)),
          "config5_affinity_small": (_config5_affinity_small, (1,))}

_JAX = {}


def _jax_cycle(joint: bool):
    if joint not in _JAX:
        policy, _ = jax_build_policy(jax_parse_conf(_conf_text()))
        _JAX[joint] = jax.jit(jax_cycle_solver(policy, FOUR, joint=joint))
    return _JAX[joint]


_jax_row = jax.jit(jax_pred.pod_affinity_row)


def _k6_viable(row: k10.AffinityRow, n: int) -> bool:
    """The operand's cell at node n as a continuing step reads it: K6
    preempt_continue's `viable` (its plain version on the CPU), p and n
    as device scalars."""
    from kube_batch_tpu_torch.kernels import preempt_scan as k6

    T, N = int(row.p) + 1, row.resident.N
    out = k6.preempt_continue(torch.zeros(T, dtype=torch.int32),
                              torch.zeros(T, dtype=torch.bool),
                              torch.zeros(T, dtype=torch.int32), torch.zeros((T, 1)),
                              torch.zeros((N, 1)), torch.ones(1),
                              torch.as_tensor(row.p, dtype=torch.int64),
                              torch.tensor(n, dtype=torch.int64), row)
    return bool(out[3])


@pytest.mark.parametrize("joint", [False, True], ids=["sequential", "joint"])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_preemption_steps_with_row_operand_match_reference(world, joint, monkeypatch):
    steps = []
    row_fn = predicates.pod_affinity_row

    def recording(snap, state, p):
        row = row_fn(snap, state, p)
        if row is not None:
            steps.append((state.task_state.clone(), state.task_node.clone(), row))
        return row

    # the plugin registers the module's function when the policy is built
    monkeypatch.setattr(predicates, "pod_affinity_row", recording)
    build, checked = WORLDS[world]
    cache, sim, wave = build()
    sched = Scheduler(cache, conf=parse_conf(_conf_text()), device="cpu", joint_solve=joint)
    evicted = cells = 0
    for cycle in range(max(checked) + 1):
        steps.clear()
        ssn = sched.run_once()
        assert sched.last_stats["cycle"] == ("joint" if joint else "sequential")
        if cycle not in checked:
            sim.tick()
            wave()
            continue
        a = sched.packer._ints.arrays
        jsnap = JaxSnapshot(**{f: a[f] for f in FIELDS})
        j_state, j_evict, j_ready, _ = _jax_cycle(joint)(jsnap, jax_init_state(jsnap))
        np.testing.assert_array_equal(ssn.host_task_state, np.asarray(j_state.task_state))
        np.testing.assert_array_equal(ssn.host_task_node, np.asarray(j_state.task_node))
        np.testing.assert_array_equal(ssn.job_ready, np.asarray(j_ready))
        names = [p.name for p in ssn.meta.task_pods]
        want = sorted((names[t], reason) for name, reason in
                      (("preempt", "preempted"), ("reclaim", "reclaimed"))
                      for t in np.nonzero(np.asarray(j_evict[name]))[0])
        assert sorted(ssn.evicted) == want
        evicted += len(want)
        jst0 = jax_init_state(jsnap)
        for i, (task_state, task_node, row) in enumerate(steps):
            jst = jst0.replace(task_state=jnp.asarray(task_state.numpy()),
                               task_node=jnp.asarray(task_node.numpy()))
            ref = np.asarray(_jax_row(jsnap, jst, int(row.p)))
            np.testing.assert_array_equal(row.row().numpy(), ref, err_msg=f"step {i}")
            n = i % ref.shape[0]
            assert _k6_viable(row, n) == bool(ref[n]), (i, n)
            cells += 1
    assert cells > 0
    if world == "affinity_evictions":
        assert evicted == 4


def test_opening_step_makes_no_row_call_and_continuing_step_one_cell(monkeypatch):
    """On the 4-node eviction world: every step without an open plan
    hands K5 the operand and calls neither form of the row; every step
    with a plan open hands K6 the operand, which tests the one cell at the
    plan's node inside its own launch, and calls neither form either
    (each plan: an opening step that evicts, a continuing step that
    evicts, one that finalizes)."""
    from kube_batch_tpu_torch.kernels import preempt_scan as k6

    calls = {"row": 0, "k5_with_row": 0, "k5": 0, "k6_with_row": 0, "k6": 0}
    real_row, real_k5 = k10.affinity_row, k5.victim_prefix
    real_k6 = k6.preempt_continue

    def row(*a, **kw):
        calls["row"] += 1
        return real_row(*a, **kw)

    def k5_call(*a, **kw):
        calls["k5"] += 1
        calls["k5_with_row"] += isinstance(a[11], k10.AffinityRow)
        return real_k5(*a, **kw)

    def k6_call(*a, **kw):
        calls["k6"] += 1
        calls["k6_with_row"] += isinstance(a[8], k10.AffinityRow)
        return real_k6(*a, **kw)

    monkeypatch.setattr(k10, "affinity_row", row)
    monkeypatch.setattr(k5, "victim_prefix", k5_call)
    monkeypatch.setattr(k6, "preempt_continue", k6_call)
    cache, _sim, _ = _affinity_evictions()
    sched = Scheduler(cache, conf=parse_conf(_conf_text()), device="cpu")
    ssn = sched.run_once()
    loops = sched.last_stats["preempt_steps"] + sched.last_stats["reclaim_steps"]
    opened = sum(loop["opened"] for loop in loops)
    steps = sum(loop["steps"] for loop in loops)
    assert len(ssn.evicted) == 4 and opened == 2
    assert calls["k5_with_row"] == calls["k5"] == steps - calls["k6"]
    assert calls["row"] == 0
    assert calls["k6_with_row"] == calls["k6"] == 2 * opened


def _packed_eviction_world():
    """(snapshot, state, the row of pending pod hi-0) of the 4-node
    eviction world, packed for the CPU."""
    from kube_batch_tpu_torch.cache.packer import pack_snapshot_full
    from kube_batch_tpu_torch.ops.assignment import init_state

    cache, _sim, _ = _affinity_evictions()
    snap, meta, _internals = pack_snapshot_full(cache.snapshot(), torch.device("cpu"))
    names = [pod.name for pod in meta.task_pods]
    return snap, init_state(snap), torch.tensor(names.index("hi-0"), dtype=torch.int64)


def test_policy_composes_plain_rows_with_the_operand():
    """A row fn that gives a bool row joins the operand as its mask; the
    operand's row is then the AND, and K5's plain version given the
    operand chooses as it does given that AND as a bool row."""
    from kube_batch_tpu_torch.framework.policy import TensorPolicy

    snap, st, p = _packed_eviction_world()
    N = snap.num_nodes
    extra = torch.arange(N) != 0
    policy = TensorPolicy(1)
    policy.add_dynamic_predicate_fn(lambda *a: None, row_fn=lambda s, state, p: extra)
    policy.add_dynamic_predicate_fn(lambda *a: None, row_fn=predicates.pod_affinity_row)
    got = policy.dyn_predicate_row(snap, st, p)
    alone = predicates.pod_affinity_row(snap, st, p)
    assert isinstance(got, k10.AffinityRow) and got.mask is extra
    both = alone.row() & extra
    np.testing.assert_array_equal(got.row().numpy(), both.numpy())
    assert bool(alone.row()[0]) and not bool(both[0])      # the mask moves the row
    T, R = snap.task_req.shape
    args = [(snap.task_node >= 0) & (snap.task_prio < 1000), snap.task_node, torch.randperm(T).int(), snap.task_req,
            snap.node_idle + snap.node_releasing, torch.full((R,), 1e-3), p, snap.task_req,
            torch.ones((T, N), dtype=torch.bool), torch.ones(N, dtype=torch.bool),
            torch.zeros(N, dtype=torch.bool)]
    np.testing.assert_array_equal(k5.victim_prefix_plain(*args, got).numpy(),
                                  k5.victim_prefix_plain(*args, both).numpy())
    for n in range(N):
        assert _k6_viable(got, n) == bool(both[n])


# ---------------------------------------------------------------------------
# K3 apply against the reference's apply
# ---------------------------------------------------------------------------

def _reference_apply(accept, prop_node, task_req, future, idle, task_state, task_node,
                     use_future: bool, new_status: int):
    """kube_batch_tpu/ops/assignment.py:421-431, the loop body's apply."""
    N = future.shape[0]
    accept, prop_node = jnp.asarray(accept), jnp.asarray(prop_node)
    task_req = jnp.asarray(task_req)
    state = jnp.where(accept, new_status, jnp.asarray(task_state))
    node = jnp.where(accept, prop_node, jnp.asarray(task_node))
    delta_seg = jnp.where(accept, prop_node, N)
    delta = jax.ops.segment_sum(jnp.where(accept[:, None], task_req, 0.0), delta_seg,
                                num_segments=N + 1)[:N]
    new_future = jnp.asarray(future) - delta
    new_idle = jnp.asarray(idle) - jnp.where(use_future, 0.0, 1.0) * delta
    return [np.asarray(x) for x in (new_future, new_idle, state, node)]


APPLY_CASES = {
    # case: (T, N, R)
    "one_node": (300, 16, 4), "holes": (500, 24, 4), "r1": (200, 8, 1),
    "r8": (200, 8, 8), "empty": (100, 8, 4),
}


@pytest.mark.parametrize("use_future", [False, True])
@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_apply_plain_matches_reference_apply(case, use_future):
    T, N, R = APPLY_CASES[case]
    rng = np.random.default_rng(T + N + R)
    prop = rng.integers(0, N, T).astype(np.int32)
    if case == "one_node":
        prop[:] = 3
    active = rng.random(T) < 0.8
    rank = rng.permutation(T).astype(np.int32)
    req = rng.integers(0, 9, (T, R)).astype(np.float32) * 250
    future = rng.integers(-40, 400, (N, R)).astype(np.float32) * 250
    idle = rng.integers(-40, 400, (N, R)).astype(np.float32) * 250
    task_state = rng.integers(0, 6, T).astype(np.int32)
    task_node = rng.integers(-1, N, T).astype(np.int32)
    # accepted proposers with holes, as the serialize steps leave them
    accept = active & (rng.random(T) < (0.0 if case == "empty" else 0.6))
    if case == "holes":
        accept &= (np.arange(T) % 7) != 3
    perm, s_node = k3.sort_plain(torch.from_numpy(prop), torch.from_numpy(active),
                                 torch.from_numpy(rank), N)
    got = [torch.from_numpy(x.copy()) for x in (future, idle, task_state, task_node)]
    k3.apply(perm, s_node, torch.from_numpy(accept), torch.from_numpy(req), got[0], got[1],
             use_future, 2, got[2], got[3])
    want = _reference_apply(accept, prop, req, future, idle, task_state, task_node,
                            use_future, 2)
    for name, g, w in zip(("node_future", "node_idle", "task_state", "task_node"),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    touched = len(np.unique(prop[accept]))
    assert (touched == 0) == (case == "empty")
    assert touched == 1 or case != "one_node"


def test_resolve_plain_on_1048577_rows_matches_reference():
    """T = 1,048,577 (past the 1,048,576 rows the kernel once took):
    requests of 0-3 units, so the reference's float32 cumsum over all
    sorted rows stays exact (below 2^24)."""
    T, N, R = 1_048_577, 4096, 2
    rng = np.random.default_rng(7)
    prop = rng.integers(0, N, T).astype(np.int32)
    prop[rng.random(T) < 0.3] = 5                       # a run of 300,000 rows
    active = rng.random(T) < 0.9
    rank = rng.permutation(T).astype(np.int32)
    req = rng.integers(0, 4, (T, R)).astype(np.float32)
    avail = rng.integers(0, 400, (N, R)).astype(np.float32)
    avail[5] = 150_000
    eps = np.full(R, 0.5, np.float32)
    want = np.asarray(_resolve_conflicts(
        jnp.asarray(prop), jnp.asarray(active), jnp.asarray(rank), jnp.asarray(req),
        jnp.asarray(avail), jnp.asarray(eps)))
    kept, perm, s_node = k3.resolve_plain(*(torch.from_numpy(x) for x in (
        prop, active, rank, req, avail, eps)))
    np.testing.assert_array_equal(kept.numpy(), want)
    assert 0 < int(kept.sum()) < int(active.sum())
    node_key = np.where(active, prop, N).astype(np.int64)
    np.testing.assert_array_equal(
        perm.numpy(), np.argsort(node_key * T + rank, kind="stable"))
