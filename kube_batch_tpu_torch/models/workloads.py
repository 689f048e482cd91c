"""Workload model generators for the five BASELINE.md configs.

| # | config (BASELINE.json · configs)                                  |
|---|-------------------------------------------------------------------|
| 1 | gang: 1 PodGroup, 8 identical tasks, 4 nodes (allocate only)      |
| 2 | drf + proportion: 2 queues, 100 mixed tasks, 20 nodes             |
| 3 | predicates + nodeorder: 1k pods, 200 nodes, taints/affinity       |
| 4 | preempt + reclaim: 5k pods, 500 nodes, 4 priority classes         |
| 5 | full pipeline: 50k-pod MPI/TFJob mix, 5k nodes, backfill + gang   |

`config5_affinity` is config 5 with inter-pod affinity terms (the
affinity path of chip_smoke.py); its recipe `config5_affinity_world`
takes a package's cluster / workloads / simulator modules, so the tests
build the identical world in the reference package too.

All generators are deterministic under a seed so differential tests
(the port against the JAX package) see identical worlds.
"""

from __future__ import annotations

import dataclasses
import random

from kube_batch_tpu_torch.api.resource import ResourceSpec
from kube_batch_tpu_torch.cache.cluster import Node, Pod, PodGroup, Queue
from kube_batch_tpu_torch.sim.simulator import make_world

GI = float(1 << 30)

DEFAULT_SPEC = ResourceSpec(("cpu", "memory", "pods", "accelerator"))


def _node(name: str, cpu_milli: float, mem: float, pods: float = 110,
          accel: float = 0, **kw) -> Node:
    return Node(
        name=name,
        allocatable={"cpu": cpu_milli, "memory": mem, "pods": pods,
                     "accelerator": accel},
        **kw,
    )


def _pod(name: str, cpu: float = 0, mem: float = 0, accel: float = 0,
         **kw) -> Pod:
    req = {"cpu": cpu, "memory": mem, "pods": 1}
    if accel:
        req["accelerator"] = accel
    return Pod(name=name, request=req, **kw)


# ---------------------------------------------------------------------------
# gang workload models (config 5 building blocks)
# ---------------------------------------------------------------------------

def tf_job(name: str, queue: str, n_ps: int, n_workers: int,
           priority: int = 0) -> tuple[PodGroup, list[Pod]]:
    """TFJob-style gang: parameter servers (cpu/mem) + accelerator workers.

    minMember covers all replicas — parameter-server training is useless
    partially scheduled.
    """
    group = PodGroup(name=name, queue=queue, min_member=n_ps + n_workers,
                     priority=priority)
    pods = [
        _pod(f"{name}-ps-{i}", cpu=1000, mem=2 * GI, priority=priority)
        for i in range(n_ps)
    ] + [
        _pod(f"{name}-worker-{i}", cpu=2000, mem=4 * GI, accel=1,
             priority=priority)
        for i in range(n_workers)
    ]
    return group, pods


def mpi_job(name: str, queue: str, n_workers: int,
            priority: int = 0) -> tuple[PodGroup, list[Pod]]:
    """MPIJob-style gang: one light launcher + N uniform workers."""
    group = PodGroup(name=name, queue=queue, min_member=1 + n_workers,
                     priority=priority)
    pods = [_pod(f"{name}-launcher", cpu=250, mem=0.5 * GI, priority=priority)] + [
        _pod(f"{name}-worker-{i}", cpu=4000, mem=8 * GI, priority=priority)
        for i in range(n_workers)
    ]
    return group, pods


# ---------------------------------------------------------------------------
# the five configs
# ---------------------------------------------------------------------------

def config1_gang_small(spec: ResourceSpec = DEFAULT_SPEC):
    """1 PodGroup, 8 identical tasks, 4 nodes; each node fits 2 tasks."""
    cache, sim = make_world(spec)
    for i in range(4):
        sim.add_node(_node(f"n{i}", cpu_milli=4000, mem=8 * GI))
    group = PodGroup(name="pg1", queue="default", min_member=8)
    pods = [_pod(f"pg1-{i}", cpu=2000, mem=4 * GI) for i in range(8)]
    sim.submit(group, pods)
    return cache, sim


def config2_drf_proportion(spec: ResourceSpec = DEFAULT_SPEC, seed: int = 0):
    """2 weighted queues, 100 mixed cpu/mem tasks across 10 jobs, 20 nodes."""
    rng = random.Random(seed)
    cache, sim = make_world(spec)
    sim.add_queue(Queue(name="gold", weight=3.0))
    sim.add_queue(Queue(name="silver", weight=1.0))
    for i in range(20):
        sim.add_node(_node(f"n{i}", cpu_milli=16000, mem=64 * GI))
    for j in range(10):
        queue = "gold" if j % 2 == 0 else "silver"
        n = 10
        group = PodGroup(name=f"job{j}", queue=queue, min_member=1)
        pods = []
        for i in range(n):
            if rng.random() < 0.5:  # cpu-heavy
                pods.append(_pod(f"job{j}-{i}", cpu=rng.choice([2000, 4000]),
                                 mem=2 * GI))
            else:                   # mem-heavy
                pods.append(_pod(f"job{j}-{i}", cpu=500,
                                 mem=rng.choice([8, 16]) * GI))
        sim.submit(group, pods)
    return cache, sim


def config3_predicates(spec: ResourceSpec = DEFAULT_SPEC, seed: int = 0):
    """1k pods, 200 nodes with zones/taints; selectors + tolerations mix."""
    rng = random.Random(seed)
    cache, sim = make_world(spec)
    zones = [f"zone-{z}" for z in range(4)]
    for i in range(200):
        labels = {"zone": zones[i % 4], "disk": "ssd" if i % 3 == 0 else "hdd"}
        taints = frozenset({"dedicated=batch:NoSchedule"}) if i % 5 == 0 else frozenset()
        sim.add_node(_node(f"n{i}", cpu_milli=8000, mem=32 * GI,
                           labels=labels, taints=taints))
    for j in range(100):
        group = PodGroup(name=f"job{j}", queue="default", min_member=1)
        pods = []
        for i in range(10):
            sel = {}
            if rng.random() < 0.4:
                sel["zone"] = rng.choice(zones)
            if rng.random() < 0.2:
                sel["disk"] = "ssd"
            tol = (frozenset({"dedicated=batch:NoSchedule"})
                   if rng.random() < 0.3 else frozenset())
            pods.append(_pod(f"job{j}-{i}", cpu=rng.choice([500, 1000, 2000]),
                             mem=rng.choice([1, 2, 4]) * GI,
                             selector=sel, tolerations=tol))
        sim.submit(group, pods)
    return cache, sim


def config4_preempt(spec: ResourceSpec = DEFAULT_SPEC, seed: int = 0):
    """Oversubscribed: 5k pods over 4 priority classes, 500 nodes, 2 queues."""
    rng = random.Random(seed)
    cache, sim = make_world(spec)
    sim.add_queue(Queue(name="prod", weight=2.0))
    sim.add_queue(Queue(name="batch", weight=1.0))
    for i in range(500):
        sim.add_node(_node(f"n{i}", cpu_milli=16000, mem=64 * GI))
    prios = [0, 100, 1000, 10000]
    for j in range(250):
        prio = prios[j % 4]
        queue = "prod" if prio >= 1000 else "batch"
        group = PodGroup(name=f"job{j}", queue=queue, min_member=4,
                         priority=prio)
        pods = [_pod(f"job{j}-{i}", cpu=rng.choice([1000, 2000, 4000]),
                     mem=rng.choice([2, 4, 8]) * GI, priority=prio)
                for i in range(20)]
        sim.submit(group, pods)
    return cache, sim


def config5_full(spec: ResourceSpec = DEFAULT_SPEC, seed: int = 0,
                 n_nodes: int = 5000, target_pods: int = 50000):
    """50k-pod MPI/TFJob mix on 5k accelerator nodes + best-effort filler."""
    rng = random.Random(seed)
    cache, sim = make_world(spec)
    sim.add_queue(Queue(name="research", weight=3.0))
    sim.add_queue(Queue(name="prod", weight=5.0))
    sim.add_queue(Queue(name="besteffort", weight=1.0))
    for i in range(n_nodes):
        sim.add_node(_node(f"n{i}", cpu_milli=32000, mem=128 * GI, accel=8))
    total, j = 0, 0
    while total < target_pods * 0.95:
        kind = rng.random()
        queue = rng.choice(["research", "prod"])
        if kind < 0.45:
            group, pods = tf_job(f"tf{j}", queue, n_ps=rng.choice([1, 2]),
                                 n_workers=rng.choice([4, 8, 16]),
                                 priority=rng.choice([0, 100]))
        elif kind < 0.9:
            group, pods = mpi_job(f"mpi{j}", queue,
                                  n_workers=rng.choice([8, 16, 32]),
                                  priority=rng.choice([0, 100]))
        else:
            group = PodGroup(name=f"be{j}", queue="besteffort", min_member=1)
            pods = [Pod(name=f"be{j}-{i}", request={"pods": 1})
                    for i in range(rng.choice([10, 50]))]
        sim.submit(group, pods)
        total += len(pods)
        j += 1
    return cache, sim


AFFINITY_TEAMS = 16


def config5_affinity_world(cl, wl, sim_mod, n_nodes: int = 5000,
                           target_pods: int = 50000, seed: int = 0,
                           rack_size: int = 40):
    """Config 5 with inter-pod affinity: config 5's cluster, job mix,
    sizes and `rng` draws (workloads.py · config5_full), built from a
    package's `cluster`, `workloads` and `simulator` modules.  Nodes carry
    `zone=z{i % 3}` and `rack=r{i // rack_size}`; every pod of job j is
    labelled `team=t{j % 16}` and a role, and the gangs carry the terms
    batch users write (parameter servers spread one per node, MPI ranks
    kept in a rack of their team):

    * TF parameter servers (`role=ps`): anti-affinity `role=ps`;
    * TF workers (`role=worker`): soft `rack:team` (1.0) and `zone:team`
      (0.5) preferences;
    * MPI launcher (`role=launcher`): none;
    * MPI workers (`role=mpi`): required affinity `rack:team`;
    * best-effort filler: no label, no term."""
    rng = random.Random(seed)
    cache, sim = sim_mod.make_world(wl.DEFAULT_SPEC)
    sim.add_queue(cl.Queue(name="research", weight=3.0))
    sim.add_queue(cl.Queue(name="prod", weight=5.0))
    sim.add_queue(cl.Queue(name="besteffort", weight=1.0))
    for i in range(n_nodes):
        sim.add_node(wl._node(f"n{i}", cpu_milli=32000, mem=128 * wl.GI, accel=8,
                              labels={"zone": f"z{i % 3}",
                                      "rack": f"r{i // rack_size}"}))

    def tagged(pods, team, role, **terms):
        return [dataclasses.replace(p, labels={"team": team, "role": role}, **terms)
                for p in pods]

    total, j = 0, 0
    while total < target_pods * 0.95:
        kind = rng.random()
        queue = rng.choice(["research", "prod"])
        team = f"t{j % AFFINITY_TEAMS}"
        if kind < 0.45:
            n_ps = rng.choice([1, 2])
            group, pods = wl.tf_job(f"tf{j}", queue, n_ps=n_ps,
                                    n_workers=rng.choice([4, 8, 16]),
                                    priority=rng.choice([0, 100]))
            pods = (tagged(pods[:n_ps], team, "ps",
                           anti_affinity=frozenset({"role=ps"}))
                    + tagged(pods[n_ps:], team, "worker",
                             pod_prefs={f"rack:team={team}": 1.0,
                                        f"zone:team={team}": 0.5}))
        elif kind < 0.9:
            group, pods = wl.mpi_job(f"mpi{j}", queue,
                                     n_workers=rng.choice([8, 16, 32]),
                                     priority=rng.choice([0, 100]))
            pods = (tagged(pods[:1], team, "launcher")
                    + tagged(pods[1:], team, "mpi",
                             affinity=frozenset({f"rack:team={team}"})))
        else:
            group = cl.PodGroup(name=f"be{j}", queue="besteffort", min_member=1)
            pods = [cl.Pod(name=f"be{j}-{i}", request={"pods": 1})
                    for i in range(rng.choice([10, 50]))]
        sim.submit(group, pods)
        total += len(pods)
        j += 1
    return cache, sim


def config5_affinity(seed: int = 0, n_nodes: int = 5000,
                     target_pods: int = 50000, rack_size: int = 40):
    """`config5_affinity_world` from this package's own modules."""
    import sys

    import kube_batch_tpu_torch.cache.cluster as cluster
    import kube_batch_tpu_torch.sim.simulator as simulator

    return config5_affinity_world(cluster, sys.modules[__name__], simulator,
                                  n_nodes=n_nodes, target_pods=target_pods,
                                  seed=seed, rack_size=rack_size)


CONFIG_BUILDERS = {
    1: config1_gang_small,
    2: config2_drf_proportion,
    3: config3_predicates,
    4: config4_preempt,
    5: config5_full,
}


def build_config(n: int, **kw):
    return CONFIG_BUILDERS[n](**kw)
