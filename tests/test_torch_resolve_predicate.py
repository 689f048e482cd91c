"""K3 `resolve` (the whole of `_resolve_conflicts`) and K1 `predicate_mask`
(set tests on bit words): their plain versions against the reference
package on the CPU.  chip_smoke.py holds the CUDA kernels equal to these
plain versions on the card, so these tests pin the kernels' function.

* `resolve_conflicts` against kube_batch_tpu/ops/assignment.py ·
  _resolve_conflicts on seeded pile-up rounds (runs of 1 / 31 / 32 / 33 /
  257 / more than half of T on one node), every row rejected, rows whose
  request is below eps, one_per_node, tied ranks and a serialize mask set
  at run starts and mid-run: `kept` exactly, `perm` and `s_node` equal to
  the stable sort of node_key·T + rank, and the cancelled count equal to
  what a float64 walk of each node's run accepted less `kept`.
* `predicate_mask` against the reference predicate on a simulator world
  whose label, taint and port vocabularies each pass 32 keys (every table
  spans two words or more), with volume pins and groups, under every
  combination of the eight flags the conf sets.
* `predicate_mask` against the reference predicate on
  chip_smoke.k1_hostname_snap: a label per node at N = 8,192 (8,200
  label columns, 257 words), selectors naming single nodes, volume
  groups allowing hundreds of hostnames (the kernel tiles such words).
* The word packing against numpy's packbits, and the packers' multi-hot
  fields against {0, 1} (the set tests' precondition).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import random
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kube_batch_tpu.cache.cluster as jax_cluster
from kube_batch_tpu.api.snapshot import SnapshotTensors as JaxSnapshot
from kube_batch_tpu.cache.packer import pack_snapshot_host
from kube_batch_tpu.framework.conf import parse_conf as jax_parse_conf
from kube_batch_tpu.framework.session import build_policy as jax_build_policy
from kube_batch_tpu.models import workloads as jax_workloads
from kube_batch_tpu.ops.assignment import _resolve_conflicts
from kube_batch_tpu.sim import simulator as jax_sim
from kube_batch_tpu_torch.api.snapshot import from_numpy
from kube_batch_tpu_torch.cache.packer import pack_snapshot_full, pack_snapshot_loop
from kube_batch_tpu_torch.kernels import predicate_mask as k1
from kube_batch_tpu_torch.ops.assignment import resolve_conflicts
from test_torch_pack import WORLDS, build_world

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import chip_smoke  # noqa: E402

# ---------------------------------------------------------------------------
# K3 resolve
# ---------------------------------------------------------------------------

T_RES, N_RES, R_RES = 1024, 64, 3
RUNS = (1, 31, 32, 33, 257, 600)   # one node each; 600 > T / 2


def _round(case: str, seed: int = 0) -> dict:
    """One auction round's resolve inputs (numpy), integer-valued
    requests whose totals stay below 2^24 (the reference sums in
    float32)."""
    rng = np.random.default_rng(seed)
    T, N, R = T_RES, N_RES, R_RES
    active = rng.random(T) < 0.9
    prop = rng.integers(0, N, T).astype(np.int32)
    if case in ("pileup", "serialize", "one_per_node", "eps", "tied"):
        rows = rng.permutation(T)
        at = 0
        for node, run in enumerate(RUNS[:-1] if case != "pileup" else RUNS):
            prop[rows[at:at + run]] = node
            active[rows[at:at + run]] = True
            at += run
    prop[~active] = rng.integers(0, 10 * N, int((~active).sum()))  # never read
    rank = rng.permutation(T).astype(np.int32)
    if case == "tied":
        rank = rng.integers(0, 40, T).astype(np.int32)
    req = rng.integers(1, 9, (T, R)).astype(np.float32) * np.array(
        [500.0, 1024.0, 1.0], np.float32)
    avail = rng.integers(4, 60, (N, R)).astype(np.float32) * np.array(
        [500.0, 1024.0, 1.0], np.float32)
    eps = np.full(R, 0.5, np.float32)
    if case == "eps":
        small = rng.random((T, R)) < 0.3
        req[small] = 0.0
    if case == "all_rejected":
        avail[:] = 0.0
    ser = None
    if case == "serialize":
        ser = rng.random(T) < 0.3
        # the first row of every run, and a row in the middle of each
        order = np.lexsort((np.arange(T), rank, np.where(active, prop, N)))
        key = np.where(active, prop, N)[order]
        starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        ser[order[starts]] = True
        ser[order[np.minimum(starts + 5, T - 1)]] = True
    return dict(prop=prop, active=active, rank=rank, req=req, avail=avail, eps=eps,
                one_per_node=case == "one_per_node", ser=ser)


def _walk_accept(r: dict) -> np.ndarray:
    """The per-node acceptance before the watermark, by a float64 walk of
    each node's run in (rank, row) order."""
    T, N = r["prop"].shape[0], r["avail"].shape[0]
    key = np.where(r["active"], r["prop"], N).astype(np.int64)
    order = np.lexsort((np.arange(T), r["rank"], key))
    accept = np.zeros(T, bool)
    for node in np.unique(key[key < N]):
        used = np.zeros(r["req"].shape[1])
        part_seen = False
        for j, t in enumerate(order[key[order] == node]):
            q = r["req"][t].astype(np.float64)
            fit = bool(np.all((used + q <= r["avail"][node]) | (r["req"][t] < r["eps"])))
            used += q
            if r["one_per_node"]:
                fit = fit and j == 0
            elif r["ser"] is not None and fit and r["ser"][t]:
                fit, part_seen = not part_seen, True
            accept[t] = fit
    return accept


CASES = ("random", "pileup", "all_rejected", "eps", "one_per_node", "serialize", "tied")


@pytest.mark.parametrize("case", CASES)
def test_resolve_conflicts_matches_reference(case):
    r = _round(case)
    T, N = r["prop"].shape[0], r["avail"].shape[0]
    want = np.asarray(_resolve_conflicts(
        jnp.asarray(r["prop"]), jnp.asarray(r["active"]), jnp.asarray(r["rank"]),
        jnp.asarray(r["req"]), jnp.asarray(r["avail"]), jnp.asarray(r["eps"]),
        one_per_node=r["one_per_node"],
        serialize_mask=None if r["ser"] is None else jnp.asarray(r["ser"])))
    cancelled = torch.zeros(3, dtype=torch.int64)
    kept, perm, s_node = resolve_conflicts(
        torch.from_numpy(r["prop"]), torch.from_numpy(r["active"]),
        torch.from_numpy(r["rank"]), torch.from_numpy(r["req"]),
        torch.from_numpy(r["avail"]), torch.from_numpy(r["eps"]),
        one_per_node=r["one_per_node"],
        serialize_mask=None if r["ser"] is None else torch.from_numpy(r["ser"]),
        cancelled=cancelled)
    np.testing.assert_array_equal(kept.numpy(), want)
    key = np.where(r["active"], r["prop"], N).astype(np.int64)
    order = np.argsort(key * T + r["rank"], kind="stable")
    np.testing.assert_array_equal(perm.numpy(), order)
    np.testing.assert_array_equal(s_node.numpy(), key[order])
    assert perm.dtype == s_node.dtype == torch.int64 and kept.dtype == torch.bool
    before = _walk_accept(r)
    assert not (want & ~before).any()
    assert int(cancelled[0]) == int((before & ~want).sum())
    assert int(cancelled[1:].sum()) == 0
    if case == "all_rejected":
        assert not before.any() and not kept.any()
    elif case == "pileup":
        longest = np.bincount(key[key < N]).max()
        assert longest > T // 2 and want.any() and int(cancelled[0]) > 0


def test_resolve_pileup_runs_are_the_listed_lengths():
    """The pile-up round holds runs of every listed length on one node."""
    r = _round("pileup")
    counts = np.bincount(r["prop"][r["active"]], minlength=N_RES)
    for node, run in enumerate(RUNS):
        assert counts[node] >= run


# ---------------------------------------------------------------------------
# K1 predicate_mask
# ---------------------------------------------------------------------------

GI = float(1 << 30)
LABEL_KEYS, TAINT_KEYS, PORTS = 40, 36, 40


def _wide_world():
    """40 label keys (80 label values), 36 taints and 40 host ports, so
    every vocabulary spans at least two words; unready and pressured
    nodes, pods pinned by bound local volumes (to nodes n0 and n47) and
    restricted by storage-class label groups, running pods
    that hold host ports on their nodes."""
    cl, wl, sim_mod = jax_cluster, jax_workloads, jax_sim
    cl._uid_counter = itertools.count()
    rng = random.Random(3)
    cache, sim = sim_mod.make_world(wl.DEFAULT_SPEC)
    n_nodes = 48
    for i in range(n_nodes):
        labels = {f"k{j}": f"v{rng.randrange(2)}" for j in range(LABEL_KEYS)
                  if rng.random() < 0.6}
        taints = frozenset(f"t{j}=x:NoSchedule" for j in range(TAINT_KEYS)
                           if rng.random() < 0.08)
        sim.add_node(wl._node(
            f"n{i}", cpu_milli=64000, mem=256 * GI, pods=500, labels=labels,
            taints=taints, ready=i % 11 != 5, memory_pressure=i % 7 == 3,
            disk_pressure=i % 9 == 4, pid_pressure=i % 13 == 6))
    for g in range(3):
        sim.add_storage_class(cl.StorageClass(
            name=f"sc{g}",
            allowed_node_labels=frozenset({f"k{g}=v0", f"k{g + 10}=v1"})))
        sim.add_claim(cl.Claim(name=f"claim{g}", storage_class=f"sc{g}"))
    sim.add_claim(cl.Claim(name="first", bound_node="n0"))
    sim.add_claim(cl.Claim(name="last", bound_node=f"n{n_nodes - 1}"))
    pods = []
    for i in range(160):
        kw = {}
        if rng.random() < 0.5:
            kw["selector"] = {f"k{j}": f"v{rng.randrange(2)}"
                              for j in rng.sample(range(LABEL_KEYS), rng.randrange(1, 3))}
        if rng.random() < 0.7:
            kw["tolerations"] = frozenset(f"t{j}=x:NoSchedule" for j in range(TAINT_KEYS)
                                          if rng.random() < 0.5)
        if rng.random() < 0.5:
            kw["ports"] = frozenset(8000 + p for p in rng.sample(range(PORTS), 2))
        claims = set()
        if i % 17 == 0:
            claims.add("first" if i % 34 == 0 else "last")
        if rng.random() < 0.2:
            claims.add(f"claim{rng.randrange(3)}")
        if claims:
            kw["claims"] = frozenset(claims)
        if i % 4 == 0:
            kw["status"] = cl.TaskStatus.RUNNING
            kw["node"] = f"n{rng.randrange(n_nodes)}"
            kw["ports"] = frozenset(8000 + p for p in rng.sample(range(PORTS), 3))
            kw.pop("claims", None)
        pods.append(wl._pod(f"p{i}", cpu=100, mem=GI, **kw))
    sim.submit(cl.PodGroup(name="wide", queue="default", min_member=1), pods)
    return cache


def _wide_fields():
    snap, _ = pack_snapshot_host(_wide_world().snapshot())
    return {f.name: np.asarray(getattr(snap, f.name)) for f in dataclasses.fields(snap)}


_WIDE = {}


def _wide():
    if not _WIDE:
        fields = _wide_fields()
        _WIDE["fields"] = fields
        _WIDE["jsnap"] = JaxSnapshot(**fields)
        _WIDE["snap"] = from_numpy(fields, "cpu")
    return _WIDE["fields"], _WIDE["jsnap"], _WIDE["snap"]


FLAG_NAMES = ("NodeSelectorEnable", "TaintsEnable", "HostPortsEnable", "NodeReadyEnable",
              "MemoryPressureEnable", "DiskPressureEnable", "PidPressureEnable",
              "VolumeBindingEnable")
COMBOS = list(itertools.product((False, True), repeat=8))


def _jax_predicate(jsnap, on):
    args = "\n".join(f"      predicate.{n}: {str(v).lower()}" for n, v in zip(FLAG_NAMES, on))
    conf = jax_parse_conf(
        "actions: allocate\ntiers:\n- plugins:\n  - name: predicates\n"
        f"    arguments:\n{args}\n      predicate.PodAffinityEnable: false\n")
    policy, _ = jax_build_policy(conf)
    return np.asarray(policy.predicate_mask(jsnap))


def test_wide_world_spans_words():
    """Every vocabulary of the wide world uses more than 32 columns, and
    it has pins, volume groups, held host ports, unready nodes and every
    pressure condition."""
    fields, _, _ = _wide()
    for name in ("task_sel", "task_tol", "task_ports", "node_labels", "node_taints",
                 "node_ports"):
        assert fields[name].any(axis=0).sum() > 32, name
    assert fields["task_vol_groups"].any() and fields["vol_group_sel"].any()
    pins = fields["task_vol_node"]
    assert 0 in pins and len(set(pins[pins >= 0].tolist())) >= 2
    assert fields["node_ports"].any() and (~fields["node_ready"]).any()
    assert fields["node_pressure"].any(axis=0).all()


@pytest.mark.parametrize("part", range(8))
def test_predicate_mask_matches_reference_every_flag(part):
    """Eight parts of 32 flag combinations each."""
    _, jsnap, snap = _wide()
    for on in COMBOS[part * 32:(part + 1) * 32]:
        flags = k1.PredicateFlags(selector=on[0], taints=on[1], ports=on[2], ready=on[3],
                                  pressure=on[4:7], volume=on[7])
        got = k1.predicate_mask(snap, flags).numpy()
        want = _jax_predicate(jsnap, on)
        np.testing.assert_array_equal(got, want, err_msg=str(on))


def test_predicate_terms_each_veto_cells():
    """Each set test vetoes some cell of the wide world that the others
    pass, so the flag combinations above are not vacuous."""
    _, _, snap = _wide()
    off = k1.PredicateFlags(selector=False, taints=False, ports=False, ready=False,
                            pressure=(False, False, False), volume=False)
    base = k1.predicate_mask(snap, off)
    assert base.all()
    for field, value in (("selector", True), ("taints", True), ("ports", True),
                         ("ready", True), ("pressure", (True, True, True)),
                         ("volume", True)):
        flags = dataclasses.replace(off, **{field: value})
        assert not k1.predicate_mask(snap, flags).all(), field


K1_FIELDS = ("task_sel", "node_labels", "task_tol", "node_taints", "task_ports",
             "node_ports", "node_ready", "node_pressure", "task_vol_node",
             "task_vol_groups", "vol_group_sel")


@pytest.mark.parametrize("on", [(True,) * 8, (True,) * 4 + (False,) * 3 + (True,)],
                         ids=["all_on", "default"])
def test_predicate_mask_label_per_node_matches_reference(on):
    """A label of its own on every one of 8,192 nodes (the hostname
    label), with selectors that name single nodes: the plain version
    equals the reference predicate, and the world vetoes cells by its
    hostname selectors."""
    T, N = 64, 8192
    snap = chip_smoke.k1_hostname_snap("cpu", T, N)
    assert snap.node_labels.shape[1] == N + 8
    jsnap = types.SimpleNamespace(
        **{name: jnp.asarray(getattr(snap, name).numpy()) for name in K1_FIELDS},
        num_tasks=T, num_nodes=N)
    flags = k1.PredicateFlags(selector=on[0], taints=on[1], ports=on[2], ready=on[3],
                              pressure=on[4:7], volume=on[7])
    got = k1.predicate_mask(snap, flags).numpy()
    np.testing.assert_array_equal(got, _jax_predicate(jsnap, on))
    picked = snap.task_sel[:, :N].sum(dim=1) > 0
    assert picked.sum() >= T // 3
    assert (got[picked.numpy()].sum(axis=1) <= 1).all()   # one node at most
    assert got[~picked.numpy()].any()


@pytest.mark.parametrize("width", [1, 31, 32, 33, 100])
def test_pack_words_matches_numpy(width):
    rng = np.random.default_rng(width)
    x = (rng.random((37, width)) < 0.4).astype(np.float32)
    x[3] = 1.0   # every bit of a row, the sign bit of a full word included
    got = k1.pack_words(torch.from_numpy(x)).numpy()
    nw = -(-width // 32)
    padded = np.zeros((37, nw * 32), bool)
    padded[:, :width] = x != 0
    want = np.packbits(padded, axis=1, bitorder="little").view("<u4")
    assert got.dtype == np.int32 and got.shape == (37, nw)
    np.testing.assert_array_equal(got.view(np.uint32), want)


def test_node_miss_words_match_reference_groups():
    """Bit g of a node's miss word is 1 − (labels @ vol_group_selᵀ > 0.5)."""
    fields, _, snap = _wide()
    ok_g = (fields["node_labels"] @ fields["vol_group_sel"].T) > 0.5
    got = k1.node_miss_words(snap).numpy().view(np.uint32)
    G = ok_g.shape[1]
    bits = (got[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    np.testing.assert_array_equal(bits.reshape(got.shape[0], -1)[:, :G].astype(bool),
                                  ~ok_g)


MULTI_HOT = ("task_sel", "task_tol", "task_ports", "task_vol_groups", "vol_group_sel",
             "node_labels", "node_taints", "node_ports")


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_packer_multi_hots_are_zero_one(world):
    """The port's packers write only 0 and 1 into the tables K1 tests as
    sets (the precondition csrc/predicate_mask.cu states)."""
    cache, _ = build_world(world, "torch")
    loop, _ = pack_snapshot_loop(cache.snapshot())
    full, _, _ = pack_snapshot_full(cache.snapshot(), "cpu")
    for name in MULTI_HOT:
        for how, a in (("loop", loop[name]), ("full", getattr(full, name).numpy())):
            assert np.isin(a, (0.0, 1.0)).all(), (how, name)
