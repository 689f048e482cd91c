"""The port's preempt / reclaim path against the reference package's, on CPU.

* The full `examples/scheduler.conf` cycle (allocate, backfill, preempt,
  reclaim) on the worlds of tests/test_preempt_reclaim.py and three
  seeds of tests/test_oracle_preempt.py's priority world: exactly equal
  task_state, task_node, node_future, each evicting action's RELEASING
  mask and job_ready, with the serial oracle (sim/oracle_preempt.py) as
  a second witness on the seeded worlds.  Each world is built by both
  packages from their own cluster objects, running pods placed directly.
* The plain versions of kernels K5 (`min_victims_per_node`) and K7
  (`segment_sum`, `waterfill`) against their reference functions on
  numpy-seeded inputs, exactly.
* `Scheduler.run_once` under examples/scheduler.conf for 3 cycles on a
  reduced config 4 (50 nodes, 500 pods, 2 queues, 4 priority classes)
  with a wave of high-priority gangs after cycle 1: the same binds,
  evictions (pod, reason) and per-cycle state as the reference's.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import random
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from kube_batch_tpu.actions.fused import make_cycle_solver as jax_cycle_solver
from kube_batch_tpu.api.snapshot import SnapshotTensors as JaxSnapshot
from kube_batch_tpu.cache.packer import pack_snapshot_host
from kube_batch_tpu.framework.conf import parse_conf as jax_parse_conf
from kube_batch_tpu.framework.session import build_policy as jax_build_policy
from kube_batch_tpu.ops.assignment import init_state as jax_init_state
from kube_batch_tpu.ops.preemption import _min_victims_per_node as jax_min_victims
from kube_batch_tpu.ops.waterfill import waterfill_deserved as jax_waterfill
from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
from kube_batch_tpu.sim.oracle import snapshot_to_numpy
from kube_batch_tpu.sim.oracle_preempt import serial_preempt
from kube_batch_tpu_torch.actions.fused import make_cycle_solver
from kube_batch_tpu_torch.api.snapshot import from_numpy, segment_sum
from kube_batch_tpu_torch.framework.conf import parse_conf
from kube_batch_tpu_torch.framework.session import build_policy
from kube_batch_tpu_torch.kernels.victim_prefix import BIG_K
from kube_batch_tpu_torch.ops.assignment import init_state
from kube_batch_tpu_torch.ops.preemption import min_victims_per_node
from kube_batch_tpu_torch.ops.waterfill import waterfill_deserved
from kube_batch_tpu_torch.scheduler import Scheduler
from test_torch_pack import PACKAGES

ACTIONS = ("allocate", "backfill", "preempt", "reclaim")
CONF_PATH = os.path.join(os.path.dirname(__file__), "..", "examples", "scheduler.conf")
GI = float(1 << 30)
RUNNING = 5
PENDING, PIPELINED, RELEASING = 0, 2, 6


def _conf_text() -> str:
    with open(CONF_PATH) as f:
        return f.read()


# ---------------------------------------------------------------------------
# worlds: (cl, sim_mod) -> (cache, sim), built from either package
# ---------------------------------------------------------------------------

def _node(cl, name, cpu, mem, **kw):
    return cl.Node(name=name, allocatable={"cpu": cpu, "memory": mem, "pods": 110},
                   **kw)


def _pods(cl, prefix, n, cpu, mem, prio=0, node=None, **kw):
    """n pods; with `node` (a name, or a list cycled over) they are
    already RUNNING there."""
    out = []
    for i in range(n):
        place = node[i % len(node)] if isinstance(node, list) else node
        extra = {} if place is None else {"status": cl.TaskStatus.RUNNING, "node": place}
        out.append(cl.Pod(name=f"{prefix}-{i}",
                          request={"cpu": cpu, "memory": mem, "pods": 1},
                          priority=prio, **extra, **kw))
    return out


def _cluster(cl, sim_mod, n_nodes, cpu, mem, **node_kw):
    from kube_batch_tpu_torch.models.workloads import DEFAULT_SPEC

    cache, sim = sim_mod.make_world(DEFAULT_SPEC)
    for i in range(n_nodes):
        sim.add_node(_node(cl, f"n{i}", cpu, mem,
                           **{k: v(i) for k, v in node_kw.items()}))
    return cache, sim


def _rollback_broken_gang(cl, sim_mod):
    """The preemptor needs 3 of low's 4 victims, each individually
    evictable (4-1 >= 2) but jointly breaking minMember 2: the plan rolls
    back with no eviction."""
    cache, sim = _cluster(cl, sim_mod, 1, 8000, 16 * GI)
    sim.submit(cl.PodGroup(name="low", queue="default", min_member=2),
               _pods(cl, "low", 4, 2000, 4 * GI, node="n0"))
    sim.submit(cl.PodGroup(name="high", queue="default", min_member=1, priority=1000),
               _pods(cl, "high", 1, 6000, 12 * GI, prio=1000))
    return cache, sim


def _gang_floor(cl, sim_mod):
    """A running gang at exactly minMember is never broken."""
    cache, sim = _cluster(cl, sim_mod, 2, 4000, 8 * GI)
    sim.submit(cl.PodGroup(name="low", queue="default", min_member=4),
               _pods(cl, "low", 4, 2000, 4 * GI, node=["n0", "n1"]))
    sim.submit(cl.PodGroup(name="high", queue="default", min_member=2, priority=1000),
               _pods(cl, "high", 2, 2000, 4 * GI, prio=1000))
    return cache, sim


def _critical(cl, sim_mod):
    """Cluster-critical pods (kube-system) are never evicted."""
    cache, sim = _cluster(cl, sim_mod, 2, 4000, 8 * GI)
    sim.submit(cl.PodGroup(name="sys", queue="default", min_member=1),
               _pods(cl, "sys", 4, 2000, 4 * GI, node=["n0", "n1"],
                     namespace="kube-system"))
    sim.submit(cl.PodGroup(name="high", queue="default", min_member=1, priority=1000),
               _pods(cl, "high", 1, 2000, 4 * GI, prio=1000))
    return cache, sim


def _phase2_intra(cl, sim_mod):
    """A job's high-priority pending member displaces its own
    low-priority running member (phase 2); the bystander is untouched."""
    cache, sim = _cluster(cl, sim_mod, 2, 4000, 8 * GI)
    sim.submit(cl.PodGroup(name="other", queue="default", min_member=1),
               _pods(cl, "other", 2, 2000, 4 * GI, node="n1"))
    sim.submit(cl.PodGroup(name="mixed", queue="default", min_member=1),
               _pods(cl, "mixed-lo", 2, 2000, 4 * GI, node="n0"))
    sim.submit_to_group("mixed", _pods(cl, "mixed-hi", 1, 2000, 4 * GI, prio=1000))
    return cache, sim


def _retry_next_node(cl, sim_mod):
    """n0's plan fails mid-statement (gang veto after two evictions) and
    is rolled back; the preemptor succeeds on n1."""
    cache, sim = _cluster(cl, sim_mod, 2, 8000, 16 * GI,
                          labels=lambda i: {"host": "ab"[i]})
    sim.submit(cl.PodGroup(name="low", queue="default", min_member=2),
               _pods(cl, "low", 4, 2000, 4 * GI, node="n0", selector={"host": "a"}))
    sim.submit(cl.PodGroup(name="other", queue="default", min_member=1),
               _pods(cl, "other", 4, 2000, 4 * GI, node="n1", selector={"host": "b"}))
    sim.submit(cl.PodGroup(name="high", queue="default", min_member=1, priority=1000),
               _pods(cl, "high", 1, 6000, 12 * GI, prio=1000))
    return cache, sim


def _reclaim_deserved(cl, sim_mod):
    """Reclaim takes only silver's surplus: two victims, not three."""
    cache, sim = _cluster(cl, sim_mod, 2, 4000, 8 * GI)
    sim.add_queue(cl.Queue(name="gold", weight=1.0))
    sim.add_queue(cl.Queue(name="silver", weight=1.0))
    sim.submit(cl.PodGroup(name="s", queue="silver", min_member=1),
               _pods(cl, "s", 4, 2000, 4 * GI, node=["n0", "n1"]))
    sim.submit(cl.PodGroup(name="g", queue="gold", min_member=1),
               _pods(cl, "g", 3, 2000, 4 * GI))
    return cache, sim


def _priorities(seed):
    """tests/test_oracle_preempt.py · _world_priorities: one queue, low
    jobs fill 8 nodes and run, then three higher-priority gangs arrive."""

    def build(cl, sim_mod):
        rng = random.Random(seed)
        cache, sim = _cluster(cl, sim_mod, 8, 8000, 16 * GI)
        for j in range(8):
            sim.submit(cl.PodGroup(name=f"low{j}", queue="default", min_member=1),
                       _pods(cl, f"low{j}", 4, 2000, 4 * GI, node=f"n{j}"))
        for j, prio in enumerate([100, 1000, 10000]):
            size = rng.choice([2, 3])
            sim.submit(cl.PodGroup(name=f"hi{j}", queue="default", min_member=size,
                                   priority=prio),
                       _pods(cl, f"hi{j}", size, 2000, 4 * GI, prio=prio))
        return cache, sim

    return build


WORLDS = {
    "rollback_broken_gang": (_rollback_broken_gang, {"preempt": 0}),
    "gang_floor": (_gang_floor, {"preempt": 0}),
    "critical": (_critical, {"preempt": 0}),
    "phase2_intra": (_phase2_intra, {"preempt": 1}),
    "retry_next_node": (_retry_next_node, {"preempt": 3}),
    "reclaim_deserved": (_reclaim_deserved, {"reclaim": 2}),
    "priorities_seed0": (_priorities(0), None),
    "priorities_seed2": (_priorities(2), None),
    "priorities_seed3": (_priorities(3), None),
}


def _build(make_world, pkg):
    cl, _wl, sim_mod = PACKAGES[pkg]
    cl._uid_counter = itertools.count()
    return make_world(cl, sim_mod)


# ---------------------------------------------------------------------------
# the cycle on packed fields
# ---------------------------------------------------------------------------

_JAX_CYCLE = {}


def _jax_cycle():
    if "cycle" not in _JAX_CYCLE:
        policy, _ = jax_build_policy(jax_parse_conf(_conf_text()))
        _JAX_CYCLE["cycle"] = jax.jit(jax_cycle_solver(policy, ACTIONS))
    return _JAX_CYCLE["cycle"]


def _packed(make_world):
    cache, _ = _build(make_world, "jax")
    snap, meta = pack_snapshot_host(cache.snapshot())
    return {f.name: np.asarray(getattr(snap, f.name))
            for f in dataclasses.fields(snap)}, meta


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_cycle_matches_reference(world):
    make_world, expect = WORLDS[world]
    fields, meta = _packed(make_world)
    jsnap = JaxSnapshot(**fields)
    j_state, j_evict, j_ready, _ = _jax_cycle()(jsnap, jax_init_state(jsnap))

    policy, _ = build_policy(parse_conf(_conf_text()))
    snap = from_numpy(fields, "cpu")
    stats: dict = {}
    t_state, t_evict, t_ready, _ = make_cycle_solver(policy, ACTIONS)(
        snap, init_state(snap), stats)

    for name in ("task_state", "task_node", "node_future", "node_idle"):
        np.testing.assert_array_equal(getattr(t_state, name).numpy(),
                                      np.asarray(getattr(j_state, name)), err_msg=name)
    assert sorted(t_evict) == sorted(j_evict) == ["preempt", "reclaim"]
    for name in t_evict:
        np.testing.assert_array_equal(t_evict[name].numpy(), np.asarray(j_evict[name]),
                                      err_msg=name)
    np.testing.assert_array_equal(t_ready.numpy(), np.asarray(j_ready))

    evicted = {name: int(m.sum()) for name, m in t_evict.items()}
    if expect is not None:
        for name, count in expect.items():
            assert evicted[name] == count, (world, evicted)
        return
    # seeded worlds: the serial Statement oracle is the second witness
    res = serial_preempt(snapshot_to_numpy(types.SimpleNamespace(**fields), meta),
                         mode="preempt")
    Tn = meta.num_real_tasks
    init, fin = fields["task_state"][:Tn], t_state.task_state.numpy()[:Tn]
    preemptors = set(np.nonzero((init == PENDING) & (fin == PIPELINED))[0])
    assert preemptors and preemptors == {p for p, _ in res["pipelined"]}
    per_job: dict[int, int] = {}
    for v in np.nonzero(t_evict["preempt"].numpy()[:Tn])[0]:
        j = int(fields["task_job"][v])
        per_job[j] = per_job.get(j, 0) + 1
    assert per_job == res["victims_per_job"]


def test_truncated_plan_is_discarded():
    """`max_iters` cutting a plan short: the open plan's provisional
    victims return to their snapshot status and the node's FutureIdle
    deflates back, as in the reference's post-loop cleanup."""
    from kube_batch_tpu.actions.preempt import make_preempt_solver as jax_preempt_solver
    from kube_batch_tpu_torch.actions.preempt import make_preempt_solver

    fields, _ = _packed(_retry_next_node)
    jsnap = JaxSnapshot(**fields)
    jax_policy, _ = jax_build_policy(jax_parse_conf(_conf_text()))
    want = jax.jit(jax_preempt_solver(jax_policy, max_iters=2))(
        jsnap, jax_init_state(jsnap))
    policy, _ = build_policy(parse_conf(_conf_text()))
    snap = from_numpy(fields, "cpu")
    stats: dict = {}
    got = make_preempt_solver(policy, max_iters=2)(snap, init_state(snap), stats=stats)
    assert stats["preempt_steps"][0] == {**stats["preempt_steps"][0], "steps": 2,
                                         "evicted": 2, "opened": 1}
    for name in ("task_state", "task_node", "node_future"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(got.task_state.numpy(), fields["task_state"])


# ---------------------------------------------------------------------------
# kernels' plain versions against the reference functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_min_victims_per_node_matches_reference(seed):
    rng = np.random.default_rng(seed)
    T, N, R = 96, 12, 4
    task_req = rng.integers(0, 5, (T, R)).astype(np.float32) * 1000
    task_node = rng.integers(-1, N, T).astype(np.int32)
    victims = (rng.random(T) < 0.6) & (task_node >= 0)
    future = rng.integers(-2, 4, (N, R)).astype(np.float32) * 1000
    rank = rng.permutation(T).astype(np.int32)
    preq = rng.integers(1, 6, R).astype(np.float32) * 1000
    eps = np.full(R, 1e-3, np.float32)
    snap = types.SimpleNamespace(task_node=jnp.asarray(task_node),
                                 task_req=jnp.asarray(task_req))
    want = np.asarray(jax_min_victims(snap, jnp.asarray(future), jnp.asarray(victims),
                                      jnp.asarray(-rank), jnp.asarray(preq),
                                      jnp.asarray(eps)))
    tsnap = types.SimpleNamespace(task_node=torch.from_numpy(task_node),
                                  task_req=torch.from_numpy(task_req))
    ok = torch.from_numpy(rng.random(N) < 0.8)
    k, out = min_victims_per_node(tsnap, torch.from_numpy(future),
                                  torch.from_numpy(victims), torch.from_numpy(rank),
                                  torch.from_numpy(preq), torch.from_numpy(eps), ok)
    np.testing.assert_array_equal(k.numpy(), want)
    assert 0 < ((want > 0) & (want < BIG_K)).sum() and (want == BIG_K).any()
    # the chosen node: lowest index among feasible nodes with the fewest victims
    feasible = (want < BIG_K) & ok.numpy()
    kk = np.where(feasible, want, BIG_K)
    n_best = int(np.argmax(feasible & (kk == kk.min())))
    assert out[:2].tolist() == [n_best, int(feasible.any())]
    on_n = victims & (task_node == n_best)
    first = int(np.argmax(np.where(on_n, rank, -1))) if on_n.any() else 0
    assert out[2:4].tolist() == [first, int(on_n.any())]


@pytest.mark.parametrize("width", [0, 3])
def test_segment_sum_matches_reference(width):
    rng = np.random.default_rng(width)
    T, S = 200, 17
    shape = (T,) if width == 0 else (T, width)
    vals = (rng.integers(0, 1 << 20, shape) * 1024).astype(np.float32)
    seg = rng.integers(0, S + 1, T).astype(np.int32)   # S = the dropped padding
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg),
                                          num_segments=S + 1))[:S]
    got = segment_sum(torch.from_numpy(vals), torch.from_numpy(seg), S)
    np.testing.assert_array_equal(got.numpy(), want)
    counts = segment_sum(torch.ones(T, dtype=torch.int32), torch.from_numpy(seg), S)
    np.testing.assert_array_equal(counts.numpy(), np.bincount(seg, minlength=S + 1)[:S])
    assert counts.dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_waterfill_matches_reference(seed):
    rng = np.random.default_rng(seed)
    Q, R = 5, 4
    weights = rng.integers(1, 6, Q).astype(np.float32)
    request = rng.integers(0, 40, (Q, R)).astype(np.float32) * 1000
    total = rng.integers(20, 80, R).astype(np.float32) * 1000
    mask = rng.random(Q) < 0.8
    want = np.asarray(jax_waterfill(*(jnp.asarray(x) for x in (weights, request,
                                                              total, mask))))
    got = waterfill_deserved(*(torch.from_numpy(x) for x in (weights, request,
                                                            total, mask)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_preempt_scan_open_matches_brute_force(seed):
    """K6's plain `preempt_open`: the rank-first eligible task (lowest index
    on ties, 0 when none is eligible), any evictable task, and the direct
    fit of some eligible task on some ready node — held against a numpy
    double loop, with resource dims no eligible task requests."""
    from kube_batch_tpu_torch.kernels import preempt_scan as k6

    rng = np.random.default_rng(seed)
    T, N, R = 64, 9, 4
    rank = rng.integers(0, 20, T).astype(np.int32)
    elig = rng.random(T) < (0.0 if seed == 3 else 0.3)
    snap_state = rng.integers(0, 8, T).astype(np.int32)
    live_state = rng.integers(0, 8, T).astype(np.int32)
    task_mask = rng.random(T) < 0.9
    prov = rng.random(T) < 0.2
    task_req = rng.integers(1, 6, (T, R)).astype(np.float32) * 1000
    task_req[:, 2 + seed % 2:] = 0.0                  # dims nobody requests
    future = rng.integers(-1, 4, (N, R)).astype(np.float32) * 1000
    node_ok = rng.random(N) < 0.7
    eps = np.full(R, 1e-3, np.float32)
    out = k6.preempt_open(*(torch.from_numpy(x) for x in (
        rank, elig, snap_state, live_state, task_mask, prov, task_req, future,
        node_ok, eps))).tolist()

    p = int(np.argmin(np.where(elig, rank, np.iinfo(np.int32).max)))
    held = np.isin(snap_state, k6._ALLOCATED) & np.isin(live_state, k6._ALLOCATED)
    direct = any(np.all((task_req[t] <= future[n]) | (task_req[t] < eps))
                 for t in range(T) if elig[t] for n in range(N) if node_ok[n])
    assert out == [p, int(elig.any()), int((held & task_mask & ~prov).any()),
                   int(direct)]


def _jax_classify(rank, victims, task_node, task_req, future, eps, p, n, dyn_row):
    """The reference's classification lines of a step with a plan open on
    node n (kube_batch_tpu/ops/preemption.py · preemption_rounds: fit_now,
    viable, victims_on_n, any_vic, v), written out in jax.numpy:
    (v, any_vic, fit_now, viable) as Python values."""
    from kube_batch_tpu.api.snapshot import fits as jax_fits

    rank, victims, task_node, task_req, future, eps, dyn_row = (
        jnp.asarray(x) for x in (rank, victims, task_node, task_req, future, eps, dyn_row))
    preq = task_req[p]
    fit_now = jax_fits(preq[None, :], future[n][None, :], eps)[0]
    victims_on_n = victims & (task_node == n)
    v = jnp.argmin(jnp.where(victims_on_n, -rank, np.iinfo(np.int32).max))
    return int(v), bool(jnp.any(victims_on_n)), bool(fit_now), bool(dyn_row[n])


def _continue_worlds(case):
    """Seeded operands of K6's continuing step: (rank, victims, task_node,
    task_req, future, eps, row, ps) a world, `ps` the preemptors to try at
    each node (None: one drawn a node).  Cases 0-2: 64 rows, 5 nodes,
    ranks with ties, no victim at all in case 2; the named cases each at
    97 x 6 x R = 4, 1 x 3 x 2 and 64 x 1 x 8: ranks a permutation, tied
    ranks, every victim on one node, no victim."""
    if isinstance(case, int):
        rng = np.random.default_rng(case)
        T, N, R = 64, 5, 3
        rank = rng.integers(0, 12, T).astype(np.int32)
        victims = rng.random(T) < (0.0 if case == 2 else 0.4)
        task_node = rng.integers(-1, N, T).astype(np.int32)
        task_req = rng.integers(0, 4, (T, R)).astype(np.float32)
        future = rng.integers(0, 4, (N, R)).astype(np.float32)
        yield (rank, victims, task_node, task_req, future, np.full(R, 0.5, np.float32),
               rng.random(N) < 0.5, None, rng)
        return
    rng = np.random.default_rng(("permutation", "tied_ranks", "one_node_holds_all",
                                 "no_victim").index(case))
    for T, N, R in ((97, 6, 4), (1, 3, 2), (64, 1, 8)):
        rank = (rng.integers(0, 5, T) if case == "tied_ranks"
                else rng.permutation(T)).astype(np.int32)
        victims = rng.random(T) < (0.0 if case == "no_victim" else 0.5)
        task_node = rng.integers(-1, N, T).astype(np.int32)
        if case == "one_node_holds_all":
            task_node[victims] = N - 1
        task_req = rng.integers(0, 4, (T, R)).astype(np.float32)
        future = rng.integers(-1, 5, (N, R)).astype(np.float32)
        yield (rank, victims, task_node, task_req, future, np.full(R, 1.0, np.float32),
               rng.random(N) < 0.5, sorted({0, T - 1, int(rng.integers(0, T))}), rng)


@pytest.mark.parametrize("seed", [0, 1, 2, "permutation", "tied_ranks",
                                  "one_node_holds_all", "no_victim"])
def test_preempt_scan_continue_matches_brute_force(seed):
    """K6's plain `preempt_continue`: among the candidate victims on node
    n, the one with the smallest sacrifice (-rank), lowest index on ties,
    and whether n holds one ((0, False) when it holds none); whether the
    preemptor p fits n's FutureIdle; and the dynamic row at n (True
    without one) — by brute force and by the reference's classification
    lines, without a row and with a bool[N] row.  p and n come as device
    scalars; the outputs are 0-dim int64 and bools."""
    from kube_batch_tpu_torch.kernels import preempt_scan as k6

    for rank, victims, task_node, task_req, future, eps, row, ps, rng in \
            _continue_worlds(seed):
        T, N = task_req.shape[0], future.shape[0]
        for n in range(N):
            for p in ps if ps is not None else [int(rng.integers(0, T))]:
                for dyn in (None, row):
                    out = k6.preempt_continue(
                        torch.from_numpy(rank), torch.from_numpy(victims),
                        torch.from_numpy(task_node), torch.from_numpy(task_req),
                        torch.from_numpy(future), torch.from_numpy(eps), torch.tensor(p),
                        torch.tensor(n), None if dyn is None else torch.from_numpy(dyn))
                    assert [x.dtype for x in out] == [torch.int64] + [torch.bool] * 3
                    assert all(x.dim() == 0 for x in out)
                    got = (int(out[0]), bool(out[1]), bool(out[2]), bool(out[3]))
                    on_n = [t for t in range(T) if victims[t] and task_node[t] == n]
                    want = min(on_n, key=lambda t: (-int(rank[t]), t)) if on_n else 0
                    assert got[:2] == (want, bool(on_n))
                    assert got[2] == bool(np.all((task_req[p] <= future[n])
                                                 | (task_req[p] < eps)))
                    assert got[3] == (True if dyn is None else bool(dyn[n]))
                    assert got == _jax_classify(
                        rank, victims, task_node, task_req, future, eps, p, n,
                        np.ones(N, bool) if dyn is None else dyn), (T, n, p, dyn is None)


# ---------------------------------------------------------------------------
# run_once, 3 cycles
# ---------------------------------------------------------------------------

def _config4_small(cl, sim_mod):
    """BASELINE config 4's shape at a tenth of its size: 50 nodes, 25
    jobs of 20 pods over 4 priority classes in 2 weighted queues."""
    rng = random.Random(0)
    cache, sim = _cluster(cl, sim_mod, 50, 16000, 64 * GI)
    sim.add_queue(cl.Queue(name="prod", weight=2.0))
    sim.add_queue(cl.Queue(name="batch", weight=1.0))
    prios = [0, 100, 1000, 10000]
    for j in range(25):
        prio = prios[j % 4]
        sim.submit(cl.PodGroup(name=f"job{j}", queue="prod" if prio >= 1000 else "batch",
                               min_member=4, priority=prio),
                   [cl.Pod(name=f"job{j}-{i}",
                           request={"cpu": rng.choice([1000, 2000, 4000]),
                                    "memory": rng.choice([2, 4, 8]) * GI, "pods": 1},
                           priority=prio)
                    for i in range(20)])
    return cache, sim


def _wave(cl, sim):
    """High-priority prod gangs that must preempt."""
    for j in range(2):
        sim.submit(cl.PodGroup(name=f"urgent{j}", queue="prod", min_member=4,
                               priority=10000),
                   [cl.Pod(name=f"urgent{j}-{i}",
                           request={"cpu": 8000, "memory": 16 * GI, "pods": 1},
                           priority=10000) for i in range(4)])


def _run_cycles(pkg):
    cl, _wl, sim_mod = PACKAGES[pkg]
    cl._uid_counter = itertools.count()
    cache, sim = _config4_small(cl, sim_mod)
    if pkg == "jax":
        sched = JaxScheduler(cache, conf_path=CONF_PATH, schedule_period=0.0)
    else:
        sched = Scheduler(cache, conf=parse_conf(_conf_text()), device="cpu")
    out = []
    for cycle in range(3):
        ssn = sched.run_once()
        if pkg == "jax":
            task_state, task_node, ready = (ssn.host_task_state(),
                                            ssn.host_task_node(), ssn.job_ready())
        else:
            task_state, task_node, ready = (ssn.host_task_state,
                                            ssn.host_task_node, ssn.job_ready)
        meta = ssn.meta
        # keyed by name: the reference's incremental pack may order rows
        # differently from the port's full pack once pods are recreated
        out.append({
            "bound": sorted(ssn.bound), "evicted": list(ssn.evicted),
            "tasks": {pod.name: (int(task_state[t]),
                                 meta.node_names[task_node[t]] if task_node[t] >= 0 else None)
                      for t, pod in enumerate(meta.task_pods)},
            "job_ready": {name: bool(ready[j]) for j, name in enumerate(meta.job_names)},
            "future": {name: np.asarray(ssn.state.node_future)[n].tolist()
                       for n, name in enumerate(meta.node_names)},
        })
        sim.tick()
        if cycle == 0:
            _wave(cl, sim)
    return out


def test_run_once_matches_reference():
    want = _run_cycles("jax")
    got = _run_cycles("torch")
    for c, (g, w) in enumerate(zip(got, want)):
        assert g["bound"] == w["bound"], c
        assert g["evicted"] == w["evicted"], c
        for key in ("tasks", "job_ready", "future"):
            assert g[key] == w[key], (c, key)
    reasons = {r for c in got for _, r in c["evicted"]}
    assert got[0]["bound"] and got[2]["bound"] and "preempted" in reasons


def test_new_wrappers_refuse_other_devices():
    """K5, K6 and K7 run their plain versions only for CPU tensors; a
    tensor on any other device than the CPU or a CUDA card is refused."""
    from kube_batch_tpu_torch.kernels import preempt_scan as k6
    from kube_batch_tpu_torch.kernels import segment_sum as k7
    from kube_batch_tpu_torch.kernels import victim_prefix as k5

    meta = torch.device("meta")
    idx = torch.zeros(4, dtype=torch.int64, device=meta)
    req = torch.zeros((4, 4), device=meta)
    vec = torch.zeros(4, device=meta)
    mask = torch.zeros(4, dtype=torch.bool, device=meta)
    with pytest.raises(RuntimeError):
        k5.victim_prefix(mask, idx.int(), idx.int(), req, req, vec, idx[0], req, mask[None],
                         mask, mask, None)
    with pytest.raises(RuntimeError):
        k6.preempt_continue(idx.int(), mask, idx.int(), req, req, vec, idx[0], idx[0])
    with pytest.raises(RuntimeError):
        k6.preempt_open(idx.int(), mask, idx.int(), idx.int(), mask, mask, req,
                        req, mask, vec)
    with pytest.raises(RuntimeError):
        k7.segment_sum(req, idx, 2)
    with pytest.raises(RuntimeError):
        k7.waterfill(vec, req, vec, mask)


def test_cache_requires_evictor():
    """A cache without an evictor is refused when it is built, as the
    reference's signature requires one, rather than failing every
    eviction later."""
    from kube_batch_tpu_torch.cache.cache import SchedulerCache
    from kube_batch_tpu_torch.models.workloads import DEFAULT_SPEC

    with pytest.raises(ValueError):
        SchedulerCache(DEFAULT_SPEC, binder=object(), evictor=None)


@pytest.mark.parametrize("refuse", [False, True])
def test_cache_evict_commits_or_rolls_back(refuse):
    """An eviction the backend accepts leaves the pod RELEASING until the
    next tick deletes it and recreates it Pending; one it refuses returns
    the pod to its status and records an EvictFailed event."""
    from kube_batch_tpu_torch.api.types import TaskStatus
    from kube_batch_tpu_torch.cache.cluster import PodGroup
    from kube_batch_tpu_torch.models.workloads import DEFAULT_SPEC, GI, _node, _pod
    from kube_batch_tpu_torch.sim.simulator import make_world

    cache, sim = make_world(DEFAULT_SPEC)
    sim.add_node(_node("n0", cpu_milli=4000, mem=8 * GI))
    sim.submit(PodGroup(name="g", queue="default", min_member=1),
               [_pod("g-0", cpu=1000, mem=GI)])
    (uid,) = list(cache._pods)
    assert cache.bind(uid, "n0")
    sim.tick()
    assert cache._pods[uid].status == TaskStatus.RUNNING
    if refuse:
        def no(pod, reason):
            raise RuntimeError("refused")
        sim.evict = no
    assert cache.evict(uid, "preempted") is not refuse
    if refuse:
        assert cache._pods[uid].status == TaskStatus.RUNNING
        assert [(e.name, e.reason) for e in cache.events][-1] == ("g-0", "EvictFailed")
        return
    assert cache._pods[uid].status == TaskStatus.RELEASING
    assert sim.evictions == [("g-0", "preempted")]
    sim.tick()
    (pod,) = cache._pods.values()
    assert pod.name == "g-0" and pod.status == TaskStatus.PENDING
