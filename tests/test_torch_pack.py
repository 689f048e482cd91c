"""The port's loop pack against the reference package's pack.

Also the shared world builders of the port's tests: each world is built
twice from the same seed and the same uid counter start, once from each
package's own cluster objects, so both packages see the identical
cluster.  Reference-side packing goes through
`kube_batch_tpu.cache.packer.pack_snapshot_host`; the port's packed
fields must equal it array for array (dtype, shape, values).
"""

from __future__ import annotations

import dataclasses
import itertools
import random

import numpy as np
import pytest

import kube_batch_tpu.cache.cluster as jax_cluster
import kube_batch_tpu_torch.cache.cluster as torch_cluster
from kube_batch_tpu.cache.packer import pack_snapshot_host
from kube_batch_tpu.models import workloads as jax_workloads
from kube_batch_tpu.sim import simulator as jax_sim
from kube_batch_tpu_torch.cache.packer import pack_snapshot_loop
from kube_batch_tpu_torch.models import workloads as torch_workloads
from kube_batch_tpu_torch.models.workloads import config5_affinity_world
from kube_batch_tpu_torch.sim import simulator as torch_sim

PACKAGES = {
    "jax": (jax_cluster, jax_workloads, jax_sim),
    "torch": (torch_cluster, torch_workloads, torch_sim),
}

GI = float(1 << 30)


def _affinity_world(cl, wl, sim_mod):
    """Node- and zone-scoped required affinity / anti-affinity, soft pod
    preferences and preferred node labels (the pod-affinity predicate,
    its serialize steps and both additive score terms)."""
    cache, sim = sim_mod.make_world(wl.DEFAULT_SPEC)
    for i in range(8):
        sim.add_node(wl._node(
            f"n{i}", cpu_milli=8000, mem=32 * GI,
            labels={"zone": f"z{i % 3}", "disk": "ssd" if i % 2 else "hdd"},
        ))
    sim.submit(cl.PodGroup(name="web", queue="default", min_member=1), [
        wl._pod(f"web-{i}", cpu=1000, mem=2 * GI, labels={"app": "web"},
                anti_affinity=frozenset({"app=web"}))
        for i in range(4)
    ])
    sim.submit(cl.PodGroup(name="cache", queue="default", min_member=3), [
        wl._pod(f"cache-{i}", cpu=500, mem=1 * GI, labels={"app": "cache"},
                affinity=frozenset({"app=cache"}))
        for i in range(3)
    ])
    sim.submit(cl.PodGroup(name="db", queue="default", min_member=1), [
        wl._pod(f"db-{i}", cpu=2000, mem=4 * GI, labels={"app": "db"},
                anti_affinity=frozenset({"zone:app=db"}),
                pod_prefs={"app=web": 2.0, "zone:app=cache": 1.0},
                preferences={"disk=ssd": 3.0})
        for i in range(4)
    ])
    sim.submit(cl.PodGroup(name="api", queue="default", min_member=1), [
        wl._pod(f"api-{i}", cpu=500, mem=1 * GI, labels={"app": "api"},
                affinity=frozenset({"zone:app=web"}),
                preferences={"disk=hdd": 1.0, "zone=z1": 2.0})
        for i in range(5)
    ])
    return cache, sim


def _volume_world(cl, wl, sim_mod):
    """Bound local volumes pin pods, unbound constrained claims restrict
    them to labeled nodes, unknown claims make them infeasible."""
    cache, sim = sim_mod.make_world(wl.DEFAULT_SPEC)
    for i in range(6):
        sim.add_node(wl._node(
            f"n{i}", cpu_milli=4000, mem=16 * GI,
            labels={"rack": f"r{i % 2}"},
        ))
    sim.add_storage_class(cl.StorageClass(
        name="rack0", allowed_node_labels=frozenset({"rack=r0"})
    ))
    sim.add_storage_class(cl.StorageClass(name="net"))
    sim.add_claim(cl.Claim(name="local-3", bound_node="n3"))
    sim.add_claim(cl.Claim(name="fast", storage_class="rack0"))
    sim.add_claim(cl.Claim(name="shared", storage_class="net"))
    pods = [
        wl._pod("pinned", cpu=500, mem=GI, claims=frozenset({"local-3"})),
        wl._pod("racked-0", cpu=500, mem=GI, claims=frozenset({"fast"})),
        wl._pod("racked-1", cpu=500, mem=GI, claims=frozenset({"fast", "shared"})),
        wl._pod("lost", cpu=500, mem=GI, claims=frozenset({"missing"})),
        wl._pod("free", cpu=500, mem=GI),
    ]
    sim.submit(cl.PodGroup(name="vol", queue="default", min_member=1), pods)
    return cache, sim


def _quantum_world(cl, wl, sim_mod):
    """One big nearly-empty node plus small nodes within a quantum of it
    (tests/test_score_quantum.py · _dominant_node_world)."""
    cache, sim = sim_mod.make_world(wl.DEFAULT_SPEC)
    sim.add_node(cl.Node(
        name="big", allocatable={"cpu": 64000, "memory": 256 * GI, "pods": 110},
    ))
    for i in range(7):
        sim.add_node(cl.Node(
            name=f"s{i}",
            allocatable={"cpu": 16000, "memory": 64 * GI, "pods": 110},
        ))
    sim.submit(
        cl.PodGroup(name="j", queue="default", min_member=1),
        [cl.Pod(name=f"p{i}", request={"cpu": 2000, "memory": 8 * GI, "pods": 1})
         for i in range(24)],
    )
    return cache, sim


def _oracle_world(cl, wl, sim_mod):
    """tests/test_oracle_differential.py ·
    test_oversubscribed_fairness_parity: two weighted queues on four
    nodes, far more demand than capacity."""
    rng = random.Random(7)
    cache, sim = sim_mod.make_world(wl.DEFAULT_SPEC)
    sim.add_queue(cl.Queue(name="gold", weight=3.0))
    sim.add_queue(cl.Queue(name="silver", weight=1.0))
    for i in range(4):
        sim.add_node(wl._node(f"n{i}", cpu_milli=16000, mem=64 * GI))
    for j in range(12):
        queue = "gold" if j % 2 == 0 else "silver"
        group = cl.PodGroup(name=f"job{j}", queue=queue, min_member=1)
        sim.submit(group, [
            wl._pod(f"job{j}-{i}", cpu=rng.choice([1000, 2000]), mem=2 * GI)
            for i in range(10)
        ])
    return cache, sim


WORLDS = {
    "config1": lambda cl, wl, s: wl.build_config(1),
    "config2": lambda cl, wl, s: wl.build_config(2, seed=0),
    "config3": lambda cl, wl, s: wl.build_config(3, seed=0),
    "config5_small": lambda cl, wl, s: wl.config5_full(
        seed=0, n_nodes=32, target_pods=300
    ),
    "affinity": _affinity_world,
    # the affinity path's world at 48 nodes in racks of 8, about 400 pods
    "config5_affinity_small": lambda cl, wl, s: config5_affinity_world(
        cl, wl, s, n_nodes=48, target_pods=400, rack_size=8
    ),
    "volume": _volume_world,
    "quantum": _quantum_world,
    "oracle": _oracle_world,
}


def build_world(name: str, pkg: str):
    """(cache, sim) of world `name` built from package `pkg`'s objects,
    with that package's uid/creation counter restarted at 0."""
    cl, wl, sim_mod = PACKAGES[pkg]
    cl._uid_counter = itertools.count()
    return WORLDS[name](cl, wl, sim_mod)


def jax_fields(name: str) -> tuple[dict, object]:
    """The reference package's packed fields of world `name` (numpy)."""
    cache, _ = build_world(name, "jax")
    snap, meta = pack_snapshot_host(cache.snapshot())
    fields = {
        f.name: np.asarray(getattr(snap, f.name))
        for f in dataclasses.fields(snap)
    }
    return fields, meta


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_pack_matches_reference(world):
    ref, ref_meta = jax_fields(world)
    cache, _ = build_world(world, "torch")
    got, meta = pack_snapshot_loop(cache.snapshot())
    assert set(got) == set(ref)
    for name, want in ref.items():
        have = got[name]
        assert have.dtype == want.dtype, name
        assert have.shape == want.shape, name
        np.testing.assert_array_equal(have, want, err_msg=name)
    assert meta.task_uids == ref_meta.task_uids
    assert meta.node_names == ref_meta.node_names
    assert meta.job_names == ref_meta.job_names
    assert meta.label_vocab == ref_meta.label_vocab
    assert meta.podlabel_vocab == ref_meta.podlabel_vocab
