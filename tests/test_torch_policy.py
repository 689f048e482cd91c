"""The port's policy evaluators against the reference package's, on CPU.

Same packed world (the reference's `pack_snapshot_host` fields, fed to
the port through `from_numpy`), same state: `rank_fn`, `eligible_fn`,
`job_ready_mask` and `overused_mask` must be exactly equal, and
proportion's water-filled `deserved` equal within rtol=1e-6, atol=0.
Checked at the packed state and at the state the reference's own cycle
ends in (placements made, shares moved).
"""

from __future__ import annotations

import numpy as np
import pytest
import jax

from kube_batch_tpu.actions.fused import make_cycle_solver as jax_cycle_solver
from kube_batch_tpu.api.snapshot import SnapshotTensors as JaxSnapshot
from kube_batch_tpu.framework.conf import default_conf as jax_default_conf
from kube_batch_tpu.framework.session import build_policy as jax_build_policy
from kube_batch_tpu.ops.assignment import init_state as jax_init_state
from kube_batch_tpu.plugins.proportion import queue_deserved as jax_deserved
from kube_batch_tpu_torch.api.snapshot import from_numpy
from kube_batch_tpu_torch.framework.conf import default_conf
from kube_batch_tpu_torch.framework.session import build_policy
from kube_batch_tpu_torch.ops.assignment import AllocState
from kube_batch_tpu_torch.plugins.proportion import queue_deserved
from test_torch_pack import jax_fields

import torch


def _jax_state(world, stage):
    fields, _ = jax_fields(world)
    snap = JaxSnapshot(**fields)
    policy, _ = jax_build_policy(jax_default_conf())
    state = jax_init_state(snap)
    if stage == "after_cycle":
        cycle = jax.jit(jax_cycle_solver(policy, ("allocate", "backfill")))
        state = cycle(snap, state)[0]
    state = policy.setup_state(snap, state)
    return fields, snap, policy, state


def _port_state(fields, jstate):
    snap = from_numpy(fields, "cpu")
    policy, _ = build_policy(default_conf())
    state = AllocState(
        task_state=torch.from_numpy(np.array(jstate.task_state)),
        task_node=torch.from_numpy(np.array(jstate.task_node)),
        node_idle=torch.from_numpy(np.array(jstate.node_idle)),
        node_future=torch.from_numpy(np.array(jstate.node_future)),
    )
    return snap, policy, policy.setup_state(snap, state)


@pytest.mark.parametrize("stage", ["packed", "after_cycle"])
@pytest.mark.parametrize("world", ["config1", "config2", "config3", "oracle"])
def test_policy_evaluators_match_reference(world, stage):
    fields, jsnap, jpolicy, jstate = _jax_state(world, stage)
    snap, policy, state = _port_state(fields, jstate)
    names = ("rank_fn", "eligible_fn", "job_ready_mask", "overused_mask")
    want = jax.device_get(jax.jit(lambda s, st: (
        [getattr(jpolicy, n)(s, st) for n in names], jax_deserved(s)
    ))(jsnap, jstate))
    for name, ref in zip(names, want[0]):
        got = getattr(policy, name)(snap, state).numpy()
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    np.testing.assert_allclose(
        queue_deserved(snap).numpy(), want[1], rtol=1e-6, atol=0
    )
