"""The port's host cycle against the reference package's, on the CPU.

* `pack_snapshot_full` (the vectorized pack) equals the reference's
  field by field on configs 1–3, small config 5, the geo / topology-volume
  world of tests/test_incremental_pack.py, the affinity and volume worlds
  of tests/test_torch_pack.py, and the port's own loop pack;
* the journal differential: the same seeded mutation sequence (the
  reference's `_Churn` of tests/test_incremental_pack.py, on both
  packages' caches) through both `IncrementalPacker`s gives, after every
  pack, the same `last_mode`, `fallback_reasons`, `last_h2d_bytes` and
  host arrays, and the port's snapshot tensors equal its host arrays;
* the reference's pins on the row patch, the forced full mode and
  swap-compaction, mirrored on the port;
* `Scheduler.run_once` over 3 cycles with churn between them, on config
  3 and a 50-node config 4 under examples/scheduler.conf: the port in
  incremental and in full pack mode and the reference scheduler (in its
  default incremental mode) bind, evict and leave every pod alike.

Exact equality throughout.  The journal's own marks (cache.py) and the
idle skip are pinned at the end.
"""

from __future__ import annotations

import dataclasses
import itertools
import random

import numpy as np
import pytest
import torch

import kube_batch_tpu_torch.cache.cluster as torch_cluster
from kube_batch_tpu.cache.incremental import IncrementalPacker as JaxPacker
from kube_batch_tpu.cache.packer import pack_snapshot_full as jax_pack_full
from kube_batch_tpu.scheduler import Scheduler as JaxScheduler
from kube_batch_tpu_torch.api.snapshot import FIELDS
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.cache.cache import CacheResyncing
from kube_batch_tpu_torch.cache.incremental import IncrementalPacker
from kube_batch_tpu_torch.cache.packer import pack_snapshot_full, pack_snapshot_loop
from kube_batch_tpu_torch.framework.conf import parse_conf
from kube_batch_tpu_torch.ops.assignment import init_state
from kube_batch_tpu_torch.scheduler import Scheduler
from test_torch_pack import PACKAGES, WORLDS, build_world
from test_torch_preempt import CONF_PATH, _conf_text, _config4_small

GI = float(1 << 30)


# ---------------------------------------------------------------------------
# worlds and churn, built from either package (tests/test_incremental_pack.py)
# ---------------------------------------------------------------------------

def _small_world(cl, wl, sim_mod, n_nodes=6, n_gangs=4, gang=4):
    cache, sim = sim_mod.make_world(wl.DEFAULT_SPEC)
    for i in range(n_nodes):
        sim.add_node(wl._node(f"n{i}", cpu_milli=16000, mem=64 * GI))
    for j in range(n_gangs):
        group = cl.PodGroup(name=f"pg{j}", queue="default", min_member=gang)
        sim.submit(group, [wl._pod(f"pg{j}-{i}", cpu=1000, mem=2 * GI)
                           for i in range(gang)])
    return cache, sim


def _geo_world(cl, wl, sim_mod, n_nodes=6, n_gangs=3, gang=3):
    """Zone-labeled nodes, a constrained StorageClass, gangs carrying
    node-level and topology-scoped (anti-)affinity, soft topology
    preferences and claims (tests/test_incremental_pack.py ·
    _build_geo_world)."""
    cache, sim = sim_mod.make_world(wl.DEFAULT_SPEC)
    cache.add_storage_class(cl.StorageClass(
        name="local-ssd", allowed_node_labels=frozenset({"disk=ssd"})))
    cache.add_claim(cl.Claim(name="pvc-free", storage_class="local-ssd"))
    cache.add_claim(cl.Claim(name="pvc-bound", storage_class="local-ssd",
                             bound_node="n1"))
    for i in range(n_nodes):
        sim.add_node(wl._node(
            f"n{i}", cpu_milli=16000, mem=64 * GI,
            labels={"zone": f"z{i % 3}", "disk": "ssd" if i % 2 else "hdd"},
        ))
    for j in range(n_gangs):
        pods = []
        for i in range(gang):
            kw = {}
            if i == 0:
                kw["labels"] = {"app": f"a{j}"}
                kw["affinity"] = frozenset({f"zone:app=a{j}"})
                kw["pod_prefs"] = {f"zone:app=a{j}": 2.0}
            elif i == 1:
                kw["labels"] = {"app": f"a{j}"}
                kw["anti_affinity"] = frozenset({"zone:app=noisy", "app=noisy"})
                kw["claims"] = frozenset({"pvc-free"})
            pods.append(wl._pod(f"geo{j}-{i}", cpu=500, mem=GI, **kw))
        sim.submit(cl.PodGroup(name=f"geo{j}", queue="default", min_member=gang),
                   pods)
    sim.submit(cl.PodGroup(name="noisy", queue="default", min_member=1), [
        wl._pod("noisy-0", cpu=250, mem=GI, labels={"app": "noisy"},
                claims=frozenset({"pvc-bound"})),
    ])
    return cache, sim


def _feature_world(cl, wl, sim_mod):
    """Every pack feature at once: the affinity world's terms plus the
    volume world's claims, ports, taints and a labeled PDB."""
    cache, sim = WORLDS["affinity"](cl, wl, sim_mod)
    sim.add_storage_class(cl.StorageClass(
        name="ssd", allowed_node_labels=frozenset({"disk=ssd"})))
    sim.add_claim(cl.Claim(name="fast", storage_class="ssd"))
    sim.add_claim(cl.Claim(name="pinned", bound_node="n2"))
    sim.add_pdb(cl.PodDisruptionBudget(name="web-pdb", min_available=2,
                                       selector={"app": "web"}))
    sim.add_node(wl._node("tainted", cpu_milli=8000, mem=32 * GI,
                          taints=frozenset({"gpu=true:NoSchedule"})))
    sim.submit(cl.PodGroup(name="feat", queue="default", min_member=1), [
        wl._pod("feat-0", cpu=500, mem=GI, claims=frozenset({"fast"}),
                ports=frozenset({8080}), selector={"disk": "ssd"}),
        wl._pod("feat-1", cpu=500, mem=GI, claims=frozenset({"pinned"}),
                tolerations=frozenset({"gpu=true:NoSchedule"})),
    ])
    return cache, sim


PACK_WORLDS = {
    "config1": WORLDS["config1"], "config2": WORLDS["config2"],
    "config3": WORLDS["config3"], "config5_small": WORLDS["config5_small"],
    "geo": _geo_world, "feature": _feature_world, "volume": WORLDS["volume"],
}


def _make(builder, pkg: str, **kw):
    cl, wl, sim_mod = PACKAGES[pkg]
    cl._uid_counter = itertools.count()
    return builder(cl, wl, sim_mod, **kw)


class Churn:
    """tests/test_incremental_pack.py · _Churn for either package: the
    same ops, weights and random draws, so one seed drives both caches
    through the same mutation sequence."""

    def __init__(self, pkg, cache, sim, rng: random.Random):
        self.cl, self.wl, _ = PACKAGES[pkg]
        self.cache, self.sim, self.rng = cache, sim, rng
        self.next_id = 0

    def _pods(self, status=None):
        with self.cache.lock():
            return [uid for uid, p in self.cache._pods.items()
                    if status is None or p.status == status]

    def _nodes(self):
        with self.cache.lock():
            return list(self.cache._nodes)

    def _groups(self):
        with self.cache.lock():
            return list(self.cache._jobs)

    def op_bind(self):
        pods, nodes = self._pods(TaskStatus.PENDING), self._nodes()
        if pods and nodes:
            self.cache.update_pod_status(self.rng.choice(pods),
                                         TaskStatus.BOUND,
                                         node=self.rng.choice(nodes))

    def op_run(self):
        pods = self._pods(TaskStatus.BOUND)
        if pods:
            self.cache.update_pod_status(self.rng.choice(pods), TaskStatus.RUNNING)

    def op_evict(self):
        pods = self._pods(TaskStatus.RUNNING) or self._pods(TaskStatus.BOUND)
        if pods:
            self.cache.update_pod_status(self.rng.choice(pods), TaskStatus.PENDING)

    def op_delete_pod(self):
        pods = self._pods()
        if pods:
            self.cache.delete_pod(self.rng.choice(pods))

    def op_add_pod(self):
        groups = self._groups()
        if groups:
            self.next_id += 1
            pod = self.wl._pod(f"late-{self.next_id}", cpu=500, mem=1 * GI)
            pod.group = self.rng.choice(groups)
            self.cache.add_pod(pod)

    def op_add_gang(self):
        self.next_id += 1
        name = f"lg{self.next_id}"
        self.sim.submit(
            self.cl.PodGroup(name=name, queue="default", min_member=2),
            [self.wl._pod(f"{name}-{i}", cpu=500, mem=1 * GI) for i in range(2)])

    def op_update_min_member(self):
        groups = self._groups()
        if groups:
            name = self.rng.choice(groups)
            with self.cache.lock():
                old = self.cache._jobs[name].pod_group
            self.cache.add_pod_group(
                dataclasses.replace(old, min_member=self.rng.randint(1, 5)))

    def op_pressure_flip(self):
        nodes = self._nodes()
        if nodes:
            name = self.rng.choice(nodes)
            with self.cache.lock():
                node = self.cache._nodes[name].node
            self.cache.update_node(dataclasses.replace(
                node, memory_pressure=not node.memory_pressure))

    def op_add_node(self):
        self.next_id += 1
        self.sim.add_node(self.wl._node(f"ln{self.next_id}", cpu_milli=8000,
                                        mem=32 * GI))

    def op_delete_gang(self):
        groups = self._groups()
        if groups:
            name = self.rng.choice(groups)
            with self.cache.lock():
                uids = [u for u, p in self.cache._pods.items() if p.group == name]
            self.cache.delete_pod_group(name)
            for uid in uids:
                self.cache.delete_pod(uid)

    def op_add_pdb(self):
        self.next_id += 1
        self.cache.add_pdb(self.cl.PodDisruptionBudget(
            name=f"pdb{self.next_id}", min_available=1, selector={"app": "x"}))

    def op_add_queue(self):
        self.next_id += 1
        self.cache.add_queue(self.cl.Queue(name=f"q{self.next_id}", weight=2.0))

    def op_add_namespace(self):
        self.next_id += 1
        self.cache.add_namespace(self.cl.Namespace(name=f"ns{self.next_id}",
                                                   weight=2.0))

    OPS = (
        ("op_bind", 6), ("op_run", 5), ("op_evict", 3), ("op_delete_pod", 2),
        ("op_add_pod", 3), ("op_add_gang", 2), ("op_update_min_member", 2),
        ("op_pressure_flip", 1), ("op_add_node", 1), ("op_delete_gang", 1),
        ("op_add_pdb", 1), ("op_add_queue", 1), ("op_add_namespace", 1),
    )

    def step(self):
        ops = [op for op, w in self.OPS for _ in range(w)]
        getattr(self, self.rng.choice(ops))()


def assert_device_is_host(packer: IncrementalPacker) -> None:
    """The (CPU) snapshot tensors equal the packer's patched host arrays."""
    for f in FIELDS:
        host = packer._ints.arrays[f]
        dev = getattr(packer._snap, f)
        assert torch.equal(dev, torch.from_numpy(host)), f
        assert dev.data_ptr() != host.ctypes.data or host.nbytes == 0, (
            f"{f}: the snapshot shares memory with the host array")


def assert_same_packs(jp: JaxPacker, tp: IncrementalPacker) -> None:
    assert tp.last_mode == jp.last_mode
    assert tp.fallback_reasons == jp.fallback_reasons
    assert tp.last_h2d_bytes == jp.last_h2d_bytes
    assert (tp.full_packs, tp.incremental_packs, tp.row_patched_packs) == (
        jp.full_packs, jp.incremental_packs, jp.row_patched_packs)
    assert tp.last_groups == jp.last_groups
    assert tp._meta.task_uids == jp._meta.task_uids
    assert set(tp._ints.arrays) == set(jp._ints.arrays)
    for f, want in jp._ints.arrays.items():
        got = tp._ints.arrays[f]
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert_device_is_host(tp)


def _twin(builder, **kw):
    """(jax cache, sim, packer), (torch cache, sim, packer) of one world."""
    jc, js = _make(builder, "jax", **kw)
    tc, ts = _make(builder, "torch", **kw)
    jp, tp = JaxPacker(jc), IncrementalPacker(tc, device="cpu")
    jp.check = tp.check = True
    return (jc, js, jp), (tc, ts, tp)


# ---------------------------------------------------------------------------
# full pack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", sorted(PACK_WORLDS))
def test_full_pack_matches_reference_and_loop(world):
    jc, _ = _make(PACK_WORLDS[world], "jax")
    tc, _ = _make(PACK_WORLDS[world], "torch")
    _, jmeta, jints = jax_pack_full(jc.snapshot(), device=False)
    with tc.lock():
        snap, meta, ints = pack_snapshot_full(tc.snapshot(shared=True), device="cpu")
        loop, loop_meta = pack_snapshot_loop(tc.snapshot())
    assert set(ints.arrays) == set(jints.arrays) == set(loop)
    for f, want in jints.arrays.items():
        for got in (ints.arrays[f], loop[f]):
            assert got.dtype == want.dtype and got.shape == want.shape, f
            np.testing.assert_array_equal(got, want, err_msg=f)
        assert torch.equal(getattr(snap, f), torch.from_numpy(want)), f
    assert meta.task_uids == jmeta.task_uids == loop_meta.task_uids
    for key in ("job_names", "node_names", "queue_names", "label_vocab",
                "taint_vocab", "port_vocab", "podlabel_vocab"):
        assert getattr(meta, key) == getattr(jmeta, key), key
    assert ints.ns_names == jints.ns_names and ints.pdb_names == jints.pdb_names
    assert ints.tt_idx == jints.tt_idx and ints.g_idx == jints.g_idx


def test_full_pack_reuses_job_blocks():
    """A rebuild with `prev` reuses every unchanged job's column block and
    re-derives the invalidated ones, with the same arrays as a cold pack."""
    cache, _ = _make(WORLDS["config3"], "torch")
    with cache.lock():
        _, _, first = pack_snapshot_full(cache.snapshot(shared=True), device=None)
        invalid = frozenset(sorted(first.job_blocks)[:2])
        _, _, again = pack_snapshot_full(cache.snapshot(shared=True), device=None,
                                         prev=first, invalid_jobs=invalid)
        _, _, cold = pack_snapshot_full(cache.snapshot(shared=True), device=None)
    for name, block in again.job_blocks.items():
        assert (block is first.job_blocks[name]) == (name not in invalid), name
    for f, want in cold.arrays.items():
        np.testing.assert_array_equal(again.arrays[f], want, err_msg=f)


def test_from_numpy_copies_on_the_cpu():
    cache, _ = _make(WORLDS["config1"], "torch")
    with cache.lock():
        snap, _, ints = pack_snapshot_full(cache.snapshot(shared=True), device="cpu")
    ints.arrays["task_state"][0] += 1
    assert int(snap.task_state[0]) == int(ints.arrays["task_state"][0]) - 1


# ---------------------------------------------------------------------------
# the journal differential
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(50))
def test_churn_differential(seed):
    """The seeds of tests/test_incremental_pack.py · test_churn_differential:
    6 packs of 1-12 mutations each, identical to the reference packer's."""
    rng = random.Random(seed)
    kw = dict(n_nodes=rng.randint(3, 8), n_gangs=rng.randint(2, 5),
              gang=rng.randint(2, 5))
    (jc, js, jp), (tc, ts, tp) = _twin(_small_world, **kw)
    jp.pack()
    tp.pack()
    assert_same_packs(jp, tp)
    jrng, trng = random.Random(seed), random.Random(seed)
    for r in (jrng, trng):   # the reference test's draws for the world
        r.randint(3, 8), r.randint(2, 5), r.randint(2, 5)
    jch, tch = Churn("jax", jc, js, jrng), Churn("torch", tc, ts, trng)
    for _cycle in range(6):
        n = jrng.randint(1, 12)
        assert trng.randint(1, 12) == n
        for _ in range(n):
            jch.step()
            tch.step()
        jp.pack()
        tp.pack()
        assert_same_packs(jp, tp)


def test_geo_world_journal_differential():
    """Status, node and append churn on the topology / volume world takes
    the patch path with the reference's modes, bytes and arrays."""
    (jc, js, jp), (tc, ts, tp) = _twin(_geo_world)
    jp.pack()
    tp.pack()
    rng_j, rng_t = random.Random(3), random.Random(3)
    jch, tch = Churn("jax", jc, js, rng_j), Churn("torch", tc, ts, rng_t)
    for _ in range(12):
        for ch in (jch, tch):
            for op in (ch.op_bind, ch.op_run, ch.op_evict, ch.op_delete_pod,
                       ch.op_add_pod, ch.op_pressure_flip):
                op()
        jp.pack()
        tp.pack()
        assert_same_packs(jp, tp)
    assert tp.row_patched_packs >= 6


# ---------------------------------------------------------------------------
# the reference's pins, mirrored
# ---------------------------------------------------------------------------

def test_row_patch_h2d_bytes_under_5pct():
    """A single-pod status change ships its dirty rows only: under 5 % of
    the bytes of the whole-array upload at config-3 scale."""
    def one(frac):
        cache, _ = _make(WORLDS["config3"], "torch")
        packer = IncrementalPacker(cache, device="cpu")
        packer.ROW_PATCH_MAX_FRAC = frac
        packer.pack()
        with cache.lock():
            uid, node = next(iter(cache._pods)), next(iter(cache._nodes))
        cache.update_pod_status(uid, TaskStatus.BOUND, node=node)
        packer.pack()
        assert packer.last_mode.startswith("incremental:"), packer.last_mode
        return packer

    row, whole = one(IncrementalPacker.ROW_PATCH_MAX_FRAC), one(0.0)
    assert row.row_patched_packs == 1 and whole.row_patched_packs == 0
    assert_device_is_host(row)
    assert_device_is_host(whole)
    assert row.last_h2d_bytes < 0.05 * whole.last_h2d_bytes


def test_row_patch_falls_back_to_whole_array_past_threshold():
    cache, _ = _make(_small_world, "torch", n_nodes=2, n_gangs=4, gang=4)
    packer = IncrementalPacker(cache, device="cpu")
    packer.check = True
    packer.pack()
    with cache.lock():
        uids = list(cache._pods)
    for uid in uids:
        cache.update_pod_status(uid, TaskStatus.SUCCEEDED)
    packer.pack()
    assert packer.last_mode.startswith("incremental:")
    assert packer.row_patched_packs == 0
    a = packer._ints.arrays
    assert packer.last_h2d_bytes >= a["task_state"].nbytes + a["task_node"].nbytes
    assert_device_is_host(packer)
    cache.update_pod_status(uids[0], TaskStatus.PENDING)
    packer.pack()
    assert packer.row_patched_packs == 1
    assert_device_is_host(packer)


def test_forced_full_mode_matches_incremental_state():
    cache, _ = _make(_geo_world, "torch")
    inc = IncrementalPacker(cache, device="cpu")
    full = IncrementalPacker(cache, device="cpu")
    full.force_full = True
    inc.pack()
    full.pack()
    with cache.lock():
        uid, node = next(iter(cache._pods)), next(iter(cache._nodes))
    cache.update_pod_status(uid, TaskStatus.BOUND, node=node)
    si, mi = inc.pack()
    sf, mf = full.pack()
    assert inc.last_mode.startswith("incremental:")
    assert full.last_mode == "full:forced" and full.incremental_packs == 0
    assert mi.task_uids == mf.task_uids   # no swap-compaction happened
    for f in FIELDS:
        assert torch.equal(getattr(si, f), getattr(sf, f)), f


def test_swap_compact_delete_and_append():
    cache, _ = _make(_small_world, "torch", n_nodes=2, n_gangs=2, gang=4)
    packer = IncrementalPacker(cache, device="cpu")
    packer.check = True
    packer.pack()
    uids = list(packer._meta.task_uids)
    cache.delete_pod(uids[1])
    packer.pack()
    assert packer.last_mode.startswith("incremental:")
    assert packer._meta.task_uids[1] == uids[-1]     # the tail moved up
    assert_device_is_host(packer)
    _, wl, _ = PACKAGES["torch"]
    pod = wl._pod("tail-1", cpu=500, mem=1 * GI)
    pod.group = "pg0"
    cache.add_pod(pod)
    packer.pack()
    assert packer.last_mode.startswith("incremental:")
    assert packer._meta.task_uids[-1] == pod.uid
    assert_device_is_host(packer)
    cache.delete_pod(packer._meta.task_uids[-1])
    packer.pack()
    assert_device_is_host(packer)
    with cache.lock():
        _, meta, ints = pack_snapshot_full(cache.snapshot(shared=True), device=None)
    assert sorted(meta.task_uids) == sorted(packer._meta.task_uids)


def test_host_alloc_state_equals_init_state():
    cache, _ = _make(WORLDS["config2"], "torch")
    packer = IncrementalPacker(cache, device="cpu")
    snap, _ = packer.pack()
    a, b = packer.host_alloc_state(), init_state(snap)
    for f in ("task_state", "task_node", "node_idle", "node_future"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    view = packer.host_field("task_job")
    with pytest.raises(ValueError):
        view[0] = 3


def test_quiesced_cache_skips_packs_and_keeps_the_journal():
    cache, _ = _make(WORLDS["config1"], "torch")
    sched = Scheduler(cache, device="cpu")
    cache.begin_resync()
    with pytest.raises(CacheResyncing):
        sched.packer.pack()
    assert sched.run_once() is None and sched.packer._dirty.full
    cache.end_resync()
    assert sched.run_once() is not None
    assert sched.packer.last_mode == "full:initial"


# ---------------------------------------------------------------------------
# the scheduler over churned cycles
# ---------------------------------------------------------------------------

def _churn_between_cycles(pkg, cache, sim, cycle: int) -> None:
    """After a tick: every 7th running pod deleted, one node's cpu raised,
    and three pods arrive in each of the first three jobs."""
    cl, _wl, _ = PACKAGES[pkg]
    with cache.lock():
        running = sorted(p.name for p in cache._pods.values()
                         if p.status == TaskStatus.RUNNING)
        by_name = {p.name: p.uid for p in cache._pods.values()}
        groups = sorted(cache._jobs)[:3]
        shapes = {g: next(iter(cache._jobs[g].tasks.values())) for g in groups
                  if cache._jobs[g].tasks}
        node = cache._nodes[sorted(cache._nodes)[0]].node
    for name in running[::7]:
        sim.delete_pod(by_name[name])
    alloc = dict(node.allocatable)
    alloc["cpu"] = alloc["cpu"] + 1000
    cache.update_node(dataclasses.replace(node, allocatable=alloc))
    for g, shape in shapes.items():
        sim.submit_to_group(g, [
            cl.Pod(name=f"arr{cycle}-{g}-{i}", request=dict(shape.request),
                   priority=shape.priority) for i in range(3)])


def _scheduler_run(pkg: str, world: str, mode: str):
    cl, _wl, _ = PACKAGES[pkg]
    if world == "config4_small":
        cl._uid_counter = itertools.count()
        cache, sim = _config4_small(cl, PACKAGES[pkg][2])
    else:
        cache, sim = build_world(world, pkg)
    conf = world == "config4_small"
    if pkg == "jax":
        sched = (JaxScheduler(cache, conf_path=CONF_PATH, schedule_period=0.0)
                 if conf else JaxScheduler(cache, schedule_period=0.0))
    else:
        sched = Scheduler(cache, conf=parse_conf(_conf_text()) if conf else None,
                          device="cpu", pack_mode=mode)
    out = []
    for cycle in range(3):
        ssn = sched.run_once()
        if ssn is None:
            out.append(None)   # idle: skipped
        else:
            out.append(_cycle_facts(pkg, ssn, sched))
        sim.tick()
        if world == "config4_small" and cycle == 0:
            from test_torch_preempt import _wave

            _wave(cl, sim)
        _churn_between_cycles(pkg, cache, sim, cycle)
    return out


def _cycle_facts(pkg, ssn, sched) -> dict:
    if pkg == "jax":
        ts, tn = ssn.host_task_state(), ssn.host_task_node()
    else:
        ts, tn = ssn.host_task_state, ssn.host_task_node
    meta = ssn.meta
    return {
        "bound": sorted(ssn.bound), "evicted": sorted(ssn.evicted),
        "pods": {pod.name: (int(ts[t]),
                            meta.node_names[tn[t]] if tn[t] >= 0 else None)
                 for t, pod in enumerate(meta.task_pods)},
        "mode": sched.packer.last_mode,
    }


@pytest.mark.parametrize("world", ["config3", "config4_small"])
def test_scheduler_pack_modes_match_reference(world):
    want = _scheduler_run("jax", world, "incremental")
    inc = _scheduler_run("torch", world, "incremental")
    full = _scheduler_run("torch", world, "full")
    for c in range(3):
        for got in (inc[c], full[c]):
            for key in ("bound", "evicted", "pods"):
                assert got[key] == want[c][key], (c, key)
        assert inc[c]["mode"] == want[c]["mode"], c
        assert full[c]["mode"] == "full:forced" or c == 0
    assert any(m["mode"].startswith("incremental:") for m in inc[1:])
    assert sum(len(c["bound"]) for c in inc) > 0
    if world == "config4_small":
        assert any(c["evicted"] for c in inc)


# ---------------------------------------------------------------------------
# the journal's marks and the idle skip
# ---------------------------------------------------------------------------

def test_journal_marks_each_mutator():
    cache, sim = _make(_small_world, "torch", n_nodes=2, n_gangs=1, gang=2)
    d = cache.register_dirty_listener()
    d.clear()
    with cache.lock():
        uid = next(iter(cache._pods))
    cache.update_pod_status(uid, TaskStatus.BOUND, node="n0")
    assert d.status_pods == {uid} and d.nodes == {"n0"} and d.groups == {"pg0"}
    assert d.version == 1 and not d.full
    cache.delete_pod(uid)
    assert d.deleted_pods == [uid] and d.reset_groups == {"pg0"}
    with cache.lock():
        node = cache._nodes["n1"].node
    cache.update_node(dataclasses.replace(node, disk_pressure=True))
    assert "n1" in d.nodes and not d.full
    for mutate, reason in (
        (lambda: cache.update_node(dataclasses.replace(node, labels={"a": "b"})),
         "node-object-changed"),
        (lambda: cache.add_queue(torch_cluster.Queue(name="q", weight=2.0)),
         "queue-changed"),
        (lambda: cache.delete_pod_group("pg0"), "job-deleted"),
    ):
        d.clear()
        mutate()
        assert d.full and d.full_reason == reason
    assert cache.has_pending_work()


def test_idle_cycle_is_skipped_and_refreshes_statuses():
    cache, sim = build_world("config1", "torch")
    sched = Scheduler(cache, device="cpu")
    assert sched.run_once() is not None
    sim.tick()                               # bound pods start running
    assert not cache.has_pending_work()
    version = sched.packer._dirty.version
    assert version > 0
    assert sched.run_once() is None          # idle: skipped
    assert sched._idle_refreshed_version == version
    assert sched.packer._dirty.version == version   # journal left intact


def test_releasing_pods_keep_the_cycle_running():
    """A cycle with Releasing pods but none Pending is not idle, as in
    the reference (`has_pending_work`): the freed resources may serve
    pipelined placements.  The port's first idle test counted Pending
    pods only and skipped this cycle."""
    out = {}
    for pkg in ("jax", "torch"):
        cache, sim = build_world("config1", pkg)
        sched = (JaxScheduler(cache, schedule_period=0.0) if pkg == "jax"
                 else Scheduler(cache, device="cpu"))
        assert sched.run_once() is not None
        sim.tick()
        with cache.lock():
            uid = sorted(cache._pods)[0]
        assert cache.evict(uid, "test")
        out[pkg] = sched.run_once() is not None
    assert out == {"jax": True, "torch": True}
