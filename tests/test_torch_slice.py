"""The port's scheduling cycle against the reference package's, on CPU.

* `make_cycle_solver(default policy, ("allocate", "backfill"))` returns
  the same (state, job_ready, diag) as the reference's on the same
  packed world (fed to the port through `from_numpy`): every int/bool
  output exactly equal, float tensors within rtol=1e-6, atol=0 — also
  with the `allocate.max_rounds` cap set.
* `Scheduler.run_once` binds the same pods to the same nodes as the
  reference's Scheduler over 2 cycles with `sim.tick()` between.
"""

from __future__ import annotations

import numpy as np
import pytest
import jax

from kube_batch_tpu.actions.fused import make_cycle_solver as jax_cycle_solver
from kube_batch_tpu.framework.conf import default_conf as jax_default_conf
from kube_batch_tpu.framework.conf import parse_conf as jax_parse_conf
from kube_batch_tpu.framework.session import build_policy as jax_build_policy
from kube_batch_tpu.ops.assignment import init_state as jax_init_state
from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
from kube_batch_tpu_torch.actions.fused import make_cycle_solver
from kube_batch_tpu_torch.api.snapshot import from_numpy
from kube_batch_tpu_torch.framework.conf import default_conf, parse_conf
from kube_batch_tpu_torch.framework.session import build_policy
from kube_batch_tpu_torch.ops.assignment import init_state
from kube_batch_tpu_torch.scheduler import Scheduler
from test_torch_pack import WORLDS, build_world, jax_fields

ACTIONS = ("allocate", "backfill")


def _jax_cycle(fields, conf=None):
    policy, _ = jax_build_policy(conf or jax_default_conf())
    cycle = jax.jit(jax_cycle_solver(policy, ACTIONS))
    from kube_batch_tpu.api.snapshot import SnapshotTensors

    snap = SnapshotTensors(**fields)
    state, _, job_ready, diag = cycle(snap, jax_init_state(snap))
    return state, job_ready, diag


def _torch_cycle(fields, conf=None):
    policy, _ = build_policy(conf or default_conf())
    snap = from_numpy(fields, "cpu")
    state, evict, job_ready, diag = make_cycle_solver(policy, ACTIONS)(
        snap, init_state(snap)
    )
    assert evict == {}
    return state, job_ready, diag


# the operator's round cap (`allocate.max_rounds`): a capped cycle leaves
# the rest Pending, identically in both packages
MAX_ROUNDS_CONF = "actions: allocate, backfill\narguments:\n  allocate.max_rounds: 2\n"


@pytest.mark.parametrize("world,capped", [
    *((w, False) for w in sorted(WORLDS)),
    ("config3", True), ("oracle", True),
])
def test_cycle_solver_matches_reference(world, capped):
    fields, _ = jax_fields(world)
    j_conf = jax_parse_conf(MAX_ROUNDS_CONF) if capped else None
    t_conf = parse_conf(MAX_ROUNDS_CONF) if capped else None
    j_state, j_ready, j_diag = _jax_cycle(fields, j_conf)
    t_state, t_ready, t_diag = _torch_cycle(fields, t_conf)
    for name in ("task_state", "task_node"):
        np.testing.assert_array_equal(
            getattr(t_state, name).numpy(), np.asarray(getattr(j_state, name)),
            err_msg=name,
        )
    for name in ("node_idle", "node_future"):
        np.testing.assert_allclose(
            getattr(t_state, name).numpy(), np.asarray(getattr(j_state, name)),
            rtol=1e-6, atol=0, err_msg=name,
        )
    np.testing.assert_array_equal(t_ready.numpy(), np.asarray(j_ready))
    for key in ("nodes", "predicate_failed", "insufficient", "feasible"):
        np.testing.assert_array_equal(
            t_diag[key].numpy(), np.asarray(j_diag[key]), err_msg=key
        )


def _run_cycles(pkg: str, world: str, cycles: int = 2):
    cache, sim = build_world(world, pkg)
    sched = (
        JaxScheduler(cache, schedule_period=0.0) if pkg == "jax"
        else Scheduler(cache, device="cpu")
    )
    out = []
    for _ in range(cycles):
        ssn = sched.run_once()
        out.append([] if ssn is None else list(ssn.bound))
        sim.tick()
    return out, sim


@pytest.mark.parametrize("world", ["config3", "config5_small", "affinity", "oracle"])
def test_run_once_binds_match_reference(world):
    want, jsim = _run_cycles("jax", world)
    got, tsim = _run_cycles("torch", world)
    assert got == want
    # the reference fans large bind batches out over a thread pool, so
    # only the set of binds the simulator saw is deterministic there
    assert sorted(tsim.binds) == sorted(jsim.binds)
    assert sum(map(len, got)) > 0
