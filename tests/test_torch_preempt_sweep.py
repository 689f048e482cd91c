"""The port's eviction path on randomized worlds, against the reference package.

Kernel K8 orders every preemption step (the tiered rank of each step's
preemptors and victims), so the eviction path is swept on seeded worlds
denser than tests/test_preempt_fuzz.py's: fill gangs run at
min_member = max(1, size - 2), so the gang plugin's Preemptable veto
leaves room to evict; 2n-3n fill jobs of 2-4 pods are drawn for n nodes
and run where all their pods fit (the others are not submitted: a
waiting fill gang of the same priority would preempt by job order,
outside P3's premise), PodDisruptionBudgets,
best-effort noise, and 2-4 arrivals of 2-4 pods (higher priority for
preempt, an under-served heavier queue for reclaim) with selectors,
tolerations and node-level (anti-)affinity.  Each world is built and
packed by the reference package, and both packages solve the same
packed fields on the CPU:

* preempt alone and reclaim alone (the default conf's plugins);
* the examples/scheduler.conf cycle (allocate, backfill, preempt,
  reclaim), sequentially and as the joint solve;

held exactly equal on task_state, task_node, the eviction masks (the
tasks each evicting action newly marked Releasing) and job_ready.  The
order-independent properties P1-P6 of tests/test_preempt_properties.py
(`_check_properties`, imported unchanged) are asserted on the port's
preempt and reclaim solves of these worlds and of that suite's fuzz
worlds (tests/test_preempt_fuzz.py · _random_world).  A few seeds run in
tier 1, the rest behind `slow`.
"""

from __future__ import annotations

import dataclasses
import os
import random

import jax
import numpy as np
import pytest

from kube_batch_tpu.actions.fused import make_cycle_solver as jax_cycle_solver
from kube_batch_tpu.actions.preempt import make_preempt_solver as jax_preempt_solver
from kube_batch_tpu.actions.reclaim import make_reclaim_solver as jax_reclaim_solver
from kube_batch_tpu.api.snapshot import SnapshotTensors as JaxSnapshot
from kube_batch_tpu.api.types import TaskStatus
from kube_batch_tpu.cache.cluster import Node, Pod, PodDisruptionBudget, PodGroup, Queue
from kube_batch_tpu.cache.packer import pack_snapshot_host
from kube_batch_tpu.framework.conf import default_conf as jax_default_conf
from kube_batch_tpu.framework.conf import parse_conf as jax_parse_conf
from kube_batch_tpu.framework.session import build_policy as jax_build_policy
from kube_batch_tpu.models.workloads import GI
from kube_batch_tpu.ops.assignment import init_state as jax_init_state
from kube_batch_tpu.sim.simulator import make_world
from kube_batch_tpu_torch.actions.fused import make_cycle_solver
from kube_batch_tpu_torch.actions.preempt import make_preempt_solver
from kube_batch_tpu_torch.actions.reclaim import make_reclaim_solver
from kube_batch_tpu_torch.api.snapshot import from_numpy
from kube_batch_tpu_torch.framework.conf import default_conf, parse_conf
from kube_batch_tpu_torch.framework.session import build_policy
from kube_batch_tpu_torch.ops.assignment import init_state
from tests.test_oracle_preempt import SPEC
from tests.test_preempt_fuzz import _random_world
from tests.test_preempt_properties import _check_properties

ACTIONS = ("allocate", "backfill", "preempt", "reclaim")
CONF_PATH = os.path.join(os.path.dirname(__file__), "..", "examples", "scheduler.conf")
RELEASING = int(TaskStatus.RELEASING)
APPS = ("web", "db", "cache")
CPU, MEM = 2000, 4 * GI            # every pod's request; a node holds four
# seeds run in tier 1; the rest of each range runs behind `slow`
PREEMPT_SEEDS, PREEMPT_TIER1 = range(0, 12), (0, 1)
RECLAIM_SEEDS, RECLAIM_TIER1 = range(12, 24), (12, 13)
FUZZ_TIER1 = (0, 3, 30, 33)


def _mode(seed: int) -> str:
    return "preempt" if seed in PREEMPT_SEEDS else "reclaim"


def _seeds(seeds, tier1):
    return [s if s in tier1 else pytest.param(s, marks=pytest.mark.slow) for s in seeds]


def _dense_world(seed: int):
    """One seeded dense world (see the module docstring), built with the
    reference package's objects; the fill runs where it was placed."""
    mode = _mode(seed)
    rng = random.Random(seed)
    cache, sim = make_world(SPEC)
    if mode == "reclaim" or rng.random() < 0.4:
        sim.add_queue(Queue(name="prod", weight=rng.choice([2.0, 3.0])))
    n_nodes = rng.randint(3, 6)
    free, tainted = {}, set()
    for i in range(n_nodes):
        taints, labels = frozenset(), {}
        if rng.random() < 0.3:
            taints = frozenset({"dedicated=batch:NoSchedule"})
            tainted.add(f"n{i}")
        if rng.random() < 0.5:
            labels["zone"] = rng.choice(["a", "b"])
        sim.add_node(Node(name=f"n{i}",
                          allocatable={"cpu": 8000, "memory": 16 * GI, "pods": 110},
                          taints=taints, labels=labels))
        free[f"n{i}"] = 4

    for j in range(rng.randint(2 * n_nodes, 3 * n_nodes)):
        size = rng.randint(2, 4)
        labels = {"app": rng.choice(APPS)} if rng.random() < 0.6 else {}
        tol = (frozenset({"dedicated=batch:NoSchedule"})
               if tainted and rng.random() < 0.5 else frozenset())
        # a gang runs when all its pods fit, spread from a random node on
        start = rng.randrange(n_nodes)
        order = [f"n{(start + k) % n_nodes}" for k in range(n_nodes)]
        places = []
        for _ in range(size):
            node = next((n for n in order if free[n] > 0
                         and (tol or n not in tainted) and places.count(n) < free[n]),
                        None)
            if node is None:
                places = None
                break
            places.append(node)
        if places is None:
            continue
        for n in places:
            free[n] -= 1
        sim.submit(
            PodGroup(name=f"fill{j}", queue="default", min_member=max(1, size - 2)),
            [Pod(name=f"fill{j}-{i}", request={"cpu": CPU, "memory": MEM, "pods": 1},
                 priority=0, labels=labels, tolerations=tol,
                 status=TaskStatus.RUNNING, node=places[i])
             for i in range(size)],
        )

    for b in range(rng.randint(0, 2)):
        app = rng.choice(APPS)
        sim.add_pdb(PodDisruptionBudget(name=f"pdb-{b}-{app}",
                                        min_available=rng.randint(1, 3),
                                        selector={"app": app}))
    if rng.random() < 0.5:
        sim.submit(PodGroup(name="noise", queue="default", min_member=1),
                   [Pod(name=f"noise-{i}", request={"pods": 1})
                    for i in range(rng.randint(1, 2))])

    queue = "prod" if mode == "reclaim" else "default"
    for j in range(rng.randint(2, 4)):
        size = rng.randint(2, 4)
        prio = rng.choice([100, 1000]) if mode == "preempt" else 0
        sel = {"zone": rng.choice(["a", "b"])} if rng.random() < 0.3 else {}
        tol = (frozenset({"dedicated=batch:NoSchedule"})
               if tainted and rng.random() < 0.4 else frozenset())
        aff = anti = frozenset()
        r = rng.random()
        if r < 0.2:
            aff = frozenset({f"app={rng.choice(APPS)}"})
        elif r < 0.35:
            anti = frozenset({f"app={rng.choice(APPS)}"})
        sim.submit(
            PodGroup(name=f"hi{j}", queue=queue, min_member=size, priority=prio),
            [Pod(name=f"hi{j}-{i}", request={"cpu": CPU, "memory": MEM, "pods": 1},
                 priority=prio, selector=sel, tolerations=tol, affinity=aff,
                 anti_affinity=anti)
             for i in range(size)],
        )
    return cache


def _fields(cache):
    snap, meta = pack_snapshot_host(cache.snapshot())
    return {f.name: np.asarray(getattr(snap, f.name))
            for f in dataclasses.fields(snap)}, meta


def _conf_text() -> str:
    with open(CONF_PATH) as f:
        return f.read()


_JAX: dict = {}


def _jax_solver(kind: str):
    """One jitted reference solver per kind for the module, so worlds in
    one padding bucket share a compile."""
    if kind not in _JAX:
        if kind in ("preempt", "reclaim"):
            policy, _ = jax_build_policy(jax_default_conf())
            factory = jax_preempt_solver if kind == "preempt" else jax_reclaim_solver
            _JAX[kind] = (policy, jax.jit(factory(policy)))
        else:
            policy, _ = jax_build_policy(jax_parse_conf(_conf_text()))
            _JAX[kind] = (policy, jax.jit(jax_cycle_solver(policy, ACTIONS,
                                                           joint=kind == "joint")))
    return _JAX[kind]


def _evicted(init_state, state):
    return (np.asarray(state) == RELEASING) & (np.asarray(init_state) != RELEASING)


def _solve_alone(fields, mode: str):
    """(reference (state, job_ready), port (snap, state0, state,
    job_ready)) of preempt or reclaim alone on `fields`."""
    jpolicy, jsolve = _jax_solver(mode)
    jsnap = JaxSnapshot(**fields)
    jout = jsolve(jsnap, jax_init_state(jsnap))
    jready = jax.jit(jpolicy.job_ready_mask)(jsnap, jout)
    policy, _ = build_policy(default_conf())
    snap = from_numpy(fields, "cpu")
    factory = make_preempt_solver if mode == "preempt" else make_reclaim_solver
    state0 = init_state(snap)
    out = factory(policy)(snap, init_state(snap))
    return (jout, jready), (snap, state0, out, policy.job_ready_mask(snap, out))


def _assert_alone_equal(fields, jax_out, port_out):
    (jout, jready), (_snap, _state0, out, ready) = jax_out, port_out
    for name in ("task_state", "task_node"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(jout, name)), err_msg=name)
    np.testing.assert_array_equal(_evicted(fields["task_state"], out.task_state.numpy()),
                                  _evicted(fields["task_state"], jout.task_state))
    np.testing.assert_array_equal(ready.numpy(), np.asarray(jready))


@pytest.mark.parametrize("seed", _seeds(PREEMPT_SEEDS, PREEMPT_TIER1)
                         + _seeds(RECLAIM_SEEDS, RECLAIM_TIER1))
def test_dense_world_alone_matches_reference(seed):
    """Preempt (or reclaim) alone: the same decisions as the reference,
    and P1-P6 on the port's solve."""
    mode = _mode(seed)
    fields, meta = _fields(_dense_world(seed))
    jax_out, port_out = _solve_alone(fields, mode)
    _assert_alone_equal(fields, jax_out, port_out)
    snap, state0, out, _ready = port_out
    _check_properties(snap, meta, state0, out, mode, seed)


@pytest.mark.parametrize("joint", [False, True], ids=["sequential", "joint"])
@pytest.mark.parametrize("seed", _seeds(range(0, 24, 2), (0, 12)))
def test_dense_world_cycle_matches_reference(seed, joint):
    """The examples/scheduler.conf cycle, sequential and joint."""
    fields, _meta = _fields(_dense_world(seed))
    jsnap = JaxSnapshot(**fields)
    _jpolicy, jcycle = _jax_solver("joint" if joint else "cycle")
    j_state, j_evict, j_ready, _ = jcycle(jsnap, jax_init_state(jsnap))
    policy, _ = build_policy(parse_conf(_conf_text()))
    snap = from_numpy(fields, "cpu")
    t_state, t_evict, t_ready, _ = make_cycle_solver(policy, ACTIONS, joint=joint)(
        snap, init_state(snap), {})
    for name in ("task_state", "task_node"):
        np.testing.assert_array_equal(getattr(t_state, name).numpy(),
                                      np.asarray(getattr(j_state, name)), err_msg=name)
    assert sorted(t_evict) == sorted(j_evict)
    for name in t_evict:
        np.testing.assert_array_equal(t_evict[name].numpy(), np.asarray(j_evict[name]),
                                      err_msg=name)
    np.testing.assert_array_equal(t_ready.numpy(), np.asarray(j_ready))


def test_dense_worlds_evict():
    """The sweep is vacuous unless its tier-1 worlds evict: each of them
    evicts under its own action, on the port."""
    for seed in PREEMPT_TIER1 + RECLAIM_TIER1:
        fields, _ = _fields(_dense_world(seed))
        policy, _ = build_policy(default_conf())
        snap = from_numpy(fields, "cpu")
        factory = make_preempt_solver if _mode(seed) == "preempt" else make_reclaim_solver
        out = factory(policy)(snap, init_state(snap))
        assert _evicted(fields["task_state"], out.task_state.numpy()).any(), seed


@pytest.mark.parametrize("seed", _seeds(range(55), FUZZ_TIER1))
def test_fuzz_world_properties_on_the_port(seed):
    """P1-P6 on the port's preempt (seeds 0-29) or reclaim (30-54) solve
    of tests/test_preempt_fuzz.py's worlds."""
    mode = "preempt" if seed < 30 else "reclaim"
    cache, _sim = _random_world(seed, mode)
    fields, meta = _fields(cache)
    policy, _ = build_policy(default_conf())
    snap = from_numpy(fields, "cpu")
    factory = make_preempt_solver if mode == "preempt" else make_reclaim_solver
    state0 = init_state(snap)
    out = factory(policy)(snap, init_state(snap))
    _check_properties(snap, meta, state0, out, mode, seed)
