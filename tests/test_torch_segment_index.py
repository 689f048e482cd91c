"""The segment index of kernel K7 (api/snapshot.py · SegmentIndex), on the CPU.

* The index of each base ("job": task_job, "queue": the task's queue via
  its job, "ns": its namespace) equals a fresh stable sort and a bincount
  of the same ids, on the seven packed worlds of
  tests/test_torch_incremental.py.
* The stale-index test: through incremental packs that patch statuses,
  append pods, upsert jobs and swap-compact deleted rows (the seeded
  journal churn of tests/test_torch_incremental.py), the index a
  snapshot serves equals a fresh build after every pack, and an index is
  carried to the next pack's snapshot only when that pack wrote none of
  its base's fields.
* The call contract, on scheduler.conf cycles (a 50-node config 4 with a
  wave, sequentially and with the joint solve, and the small config-5
  affinity world): every float segment sum passes the index of its base
  and seg equals, row by row, that base (as the snapshot's fields give it
  at the call) or the segment count; the kernel's walk of the index
  (order, offsets, rows whose seg is not the segment skipped) equals the
  plain sum exactly; no float sum comes without an index; and no
  snapshot field an index reads changes between the pack and the end of
  the cycle.

Exact equality throughout.
"""

from __future__ import annotations

import itertools
import random

import numpy as np
import pytest
import torch

import kube_batch_tpu_torch.api.snapshot as snapshot
from kube_batch_tpu_torch.api.snapshot import (
    SEGMENT_BASES,
    build_segment_index,
    segment_base,
)
from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.cache.incremental import IncrementalPacker
from kube_batch_tpu_torch.framework.conf import parse_conf
from kube_batch_tpu_torch.kernels import segment_sum as k7
from kube_batch_tpu_torch.scheduler import Scheduler
from test_torch_incremental import PACK_WORLDS, Churn, _churn_between_cycles, _make
from test_torch_pack import build_world
from test_torch_preempt import _conf_text, _config4_small, _wave

KINDS = sorted(SEGMENT_BASES)
BASE_FIELDS = sorted({f for fields in SEGMENT_BASES.values() for f in fields})


def fresh_index(snap, kind):
    """(order, offsets) by numpy: a stable argsort of the base ids (ids
    outside [0, S) last) and the cumulative bincount."""
    base, S = segment_base(snap, kind)
    b = base.numpy().astype(np.int64)
    key = np.where((b >= 0) & (b < S), b, S)
    order = np.argsort(key, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(np.bincount(key, minlength=S + 1)[:S])])
    return order, offsets


def assert_index_fresh(snap, kind):
    idx = snap.segment_index(kind)
    order, offsets = fresh_index(snap, kind)
    base, S = segment_base(snap, kind)
    assert idx.num_segments == S
    assert idx.order.dtype == idx.offsets.dtype == torch.int32
    np.testing.assert_array_equal(idx.order.numpy(), order)
    np.testing.assert_array_equal(idx.offsets.numpy(), offsets)
    np.testing.assert_array_equal(idx.base.numpy(), base.numpy())


def walk_sum(values, seg, S, order, offsets):
    """Kernel K7's walk, in float64 rounded once: segment s adds the rows
    order[offsets[s]:offsets[s+1]] whose seg is s, in that order."""
    v = values.double().reshape(values.shape[0], -1).numpy()
    seg, order, offsets = seg.numpy(), order.numpy(), offsets.numpy()
    owner = np.repeat(np.arange(S), np.diff(offsets))     # segment of each position
    rows = order[:offsets[-1]]
    keep = seg[rows] == owner
    out = np.zeros((S, v.shape[1]))
    np.add.at(out, owner[keep], v[rows[keep]])             # in position order
    return torch.from_numpy(out.astype(np.float32)).reshape((S,) + tuple(values.shape[1:]))


@pytest.mark.parametrize("world", sorted(PACK_WORLDS))
def test_index_equals_fresh_sort(world):
    cache, _ = _make(PACK_WORLDS[world], "torch")
    snap, _meta = IncrementalPacker(cache, device="cpu").pack()
    for kind in KINDS:
        assert_index_fresh(snap, kind)
        assert snap.segment_index(kind) is snap.segment_index(kind)   # built once


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_index_is_rebuilt_after_packs_that_write_its_base(seed):
    """The stale-index test (see the module docstring)."""
    cache, sim = _make(PACK_WORLDS["config3"], "torch")
    packer = IncrementalPacker(cache, device="cpu")
    packer.check = True
    churn = Churn("torch", cache, sim, random.Random(seed))
    snap, _ = packer.pack()
    modes, carried, rebuilt = set(), 0, 0
    for _ in range(40):
        before = {k: snap.segment_index(k) for k in KINDS}
        written = set()
        orig = packer._upload

        def upload(changed, _orig=orig):
            written.update(changed.fields)
            return _orig(changed)

        packer._upload = upload
        for _ in range(churn.rng.randint(1, 3)):
            churn.step()
        snap, _ = packer.pack()
        packer._upload = orig
        modes.add(packer.last_mode.split(":")[0])
        kept = snap.__dict__.get("_segment_index", {})
        for kind in KINDS:
            if packer.last_mode.startswith("incremental:"):
                if written & set(SEGMENT_BASES[kind]):
                    assert kind not in kept
                    rebuilt += 1
                else:
                    assert kept.get(kind) is before[kind]
                    carried += 1
            else:
                assert kind not in kept          # a full pack starts afresh
            assert_index_fresh(snap, kind)
    assert modes == {"full", "incremental"}
    assert carried and rebuilt


def test_swap_compaction_rebuilds_the_index():
    cache, _ = _make(PACK_WORLDS["config1"], "torch")
    packer = IncrementalPacker(cache, device="cpu")
    snap, meta = packer.pack()
    old = {k: snap.segment_index(k) for k in KINDS}
    cache.delete_pod(meta.task_uids[1])          # the last row moves up
    snap, meta = packer.pack()
    assert packer.last_mode.startswith("incremental:")
    for kind in KINDS:
        assert snap.segment_index(kind) is not old[kind]
        assert_index_fresh(snap, kind)
    node = sorted(cache._nodes)[0]
    cache.update_pod_status(meta.task_uids[0], TaskStatus.BOUND, node=node)
    kept = {k: snap.segment_index(k) for k in KINDS}
    snap, _ = packer.pack()
    for kind in KINDS:
        assert snap.segment_index(kind) is kept[kind]
        assert_index_fresh(snap, kind)


class _ContractProbe:
    """Wraps K7's wrappers and SnapshotTensors.segment_index for one run:
    checks every call against the contract at the moment it is made."""

    def __init__(self, monkeypatch):
        self.by_order = {}
        self.float_calls = 0
        self.count_calls = 0
        self.kinds = set()
        self.masked_rows = 0
        self.checked = set()
        seg_index = snapshot.SnapshotTensors.segment_index
        probe = self

        def segment_index(snap, kind):
            idx = seg_index(snap, kind)
            probe.by_order[id(idx.order)] = (snap, kind, idx)
            return idx

        def segment_sum(values, seg, S, order=None, offsets=None):
            assert order is not None and offsets is not None, "float sum without index"
            snap, kind, idx = probe.by_order[id(order)]
            assert idx.offsets is offsets and idx.num_segments == S
            base, S2 = segment_base(snap, kind)          # fresh from the fields
            assert S2 == S
            assert bool(((seg == base) | (seg == S)).all()), kind
            if (id(snap), kind) not in probe.checked:
                assert_index_fresh(snap, kind)
                probe.checked.add((id(snap), kind))
            want = k7.segment_sum_plain(values, seg, S)
            assert torch.equal(walk_sum(values, seg, S, order, offsets), want)
            probe.float_calls += 1
            probe.kinds.add(kind)
            probe.masked_rows += int((seg == S).sum())
            return want

        def segment_count(values, seg, S):
            assert bool(((seg >= 0) & (seg <= S)).all())
            probe.count_calls += 1
            return k7.segment_sum_plain(values, seg, S)

        monkeypatch.setattr(snapshot.SnapshotTensors, "segment_index", segment_index)
        monkeypatch.setattr(k7, "segment_sum", segment_sum)
        monkeypatch.setattr(k7, "segment_count", segment_count)


def _fields(snap):
    return {f: getattr(snap, f).clone() for f in BASE_FIELDS}


@pytest.mark.parametrize("world,joint", [("config4_small", False),
                                         ("config4_small", True),
                                         ("config5_affinity_small", False)])
def test_segment_sums_keep_the_contract(world, joint, monkeypatch):
    probe = _ContractProbe(monkeypatch)
    import kube_batch_tpu_torch.cache.cluster as cl
    from kube_batch_tpu_torch.sim import simulator

    if world == "config4_small":
        cl._uid_counter = itertools.count()
        cache, sim = _config4_small(cl, simulator)
    else:
        cache, sim = build_world(world, "torch")
    sched = Scheduler(cache, conf=parse_conf(_conf_text()), device="cpu",
                      joint_solve=joint)
    packed = []
    pack = sched.packer.pack

    def checked_pack():
        snap, meta = pack()
        packed.append((snap, _fields(snap)))
        return snap, meta

    sched.packer.pack = checked_pack
    evicted = 0
    cycles = 3 if world == "config4_small" else 2
    for cycle in range(cycles):
        ssn = sched.run_once()
        assert ssn is not None
        assert sched.last_stats["cycle"] == ("joint" if joint else "sequential")
        evicted += len(ssn.evicted)
        snap, fields = packed[-1]
        for f in BASE_FIELDS:                  # nothing wrote them in the cycle
            assert torch.equal(getattr(snap, f), fields[f]), f
        sim.tick()
        if world == "config4_small" and cycle == 0:
            _wave(cl, sim)
        _churn_between_cycles("torch", cache, sim, cycle)
    assert probe.float_calls > 0 and probe.count_calls > 0 and probe.masked_rows > 0
    assert probe.kinds == {"job", "queue", "ns"}
    if world == "config4_small":
        assert evicted > 0


def test_build_segment_index_matches_numpy_on_edge_ids():
    """Ids out of range (padding −1, ids ≥ S) sort after every segment;
    empty segments get empty ranges; S = 1 and S = 0 work."""
    rng = np.random.default_rng(0)
    for S in (0, 1, 5, 64):
        base = rng.integers(-2, S + 3, 300).astype(np.int32)
        idx = build_segment_index(torch.from_numpy(base), S)
        key = np.where((base >= 0) & (base < S), base, S)
        np.testing.assert_array_equal(idx.order.numpy(), np.argsort(key, kind="stable"))
        counts = np.bincount(key, minlength=S + 1)[:S]
        np.testing.assert_array_equal(idx.offsets.numpy(),
                                      np.concatenate([[0], np.cumsum(counts)]))
