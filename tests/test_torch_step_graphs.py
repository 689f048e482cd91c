"""The loops' step graphs (kube_batch_tpu_torch/ops/graphs.py) in their
eager form — the CPU's, which shares every gate, static buffer and
write-back with the card's captured form — against the reference package
and against the loops as they ran before (`_ungated_*` below: a host read
after every round or step, a fresh carry every step).

* `allocate_rounds` in chunks with caps of 1, 3 and 8 on the config-1 gang
  world, on the small config-5 affinity world (whose rounds cancel
  acceptances by the watermark and the global serialize step, and whose
  last round accepts nothing) and cut at `max_rounds` (tests/test_torch_pack.py's
  oracle world, 4 rounds, cut at 2): task_state,
  task_node, node_idle and node_future against the reference's
  `allocate_rounds`, both passes; `rounds` and `cancelled` against the
  ungated loop, and `rounds` against the reference's own count (its
  state at max_rounds = rounds − 1 is its fixed point, at rounds − 2 it
  is not); the bodies run and the reads made are the chunk rule's.
* The gate alone: a round made to cancel one acceptance every time it
  runs, so that the rounds run past the fixed point would add to
  `cancelled` if the gate let them.
* `preemption_rounds` on static buffers (preempt alone on config 4 at test
  size, preempt and reclaim alone on tests/test_torch_preempt_sweep.py's
  tier-1 seeds 0 and 12): the decisions against the reference's solver,
  the decisions and the steps by outcome against the ungated loop.
* `joint_rounds` on static buffers on tests/test_torch_joint.py's worlds:
  the decisions against the reference's joint cycle, the decisions and
  `joint_tiers` (steps, placements, steps by outcome) against the
  ungated loop.
* The step graphs on the CPU: every body eager, one round a read.
"""

from __future__ import annotations

import dataclasses
import random
import time

import jax
import numpy as np
import pytest
import torch

from kube_batch_tpu.actions.backfill import non_besteffort_eligible as jax_eligible
from kube_batch_tpu.api.snapshot import SnapshotTensors as JaxSnapshot
from kube_batch_tpu.api.types import TaskStatus
from kube_batch_tpu.cache.cluster import Node, Pod, PodGroup, Queue
from kube_batch_tpu.cache.packer import pack_snapshot_host
from kube_batch_tpu.framework.conf import default_conf as jax_default_conf
from kube_batch_tpu.framework.session import build_policy as jax_build_policy
from kube_batch_tpu.models.workloads import GI
from kube_batch_tpu.ops.assignment import allocate_rounds as jax_allocate_rounds
from kube_batch_tpu.ops.assignment import init_state as jax_init_state
from kube_batch_tpu.sim.simulator import make_world
from kube_batch_tpu_torch.actions import preempt as preempt_action
from kube_batch_tpu_torch.actions import reclaim as reclaim_action
from kube_batch_tpu_torch.actions.backfill import non_besteffort_eligible
from kube_batch_tpu_torch.api.snapshot import from_numpy
from kube_batch_tpu_torch.framework.conf import default_conf
from kube_batch_tpu_torch.framework.session import build_policy
from kube_batch_tpu_torch.kernels import joint_tier as k12
from kube_batch_tpu_torch.ops import assignment, graphs
from kube_batch_tpu_torch.ops import joint as joint_ops
from kube_batch_tpu_torch.ops.assignment import CANCEL_STEPS, AllocState, init_state
from kube_batch_tpu_torch.ops.joint import AuctionPhase, _max_steps
from kube_batch_tpu_torch.ops.preemption import (
    EvictCarry,
    _request_sum,
    evict_step,
    new_tally,
    tally_step,
)
from test_oracle_preempt import SPEC
from test_torch_joint import FOUR, WORLDS as JOINT_WORLDS
from test_torch_joint import _assert_equal as joint_assert_equal
from test_torch_joint import _fields as joint_fields
from test_torch_joint import _solve as joint_solve
from test_torch_pack import jax_fields
from test_torch_preempt_sweep import _assert_alone_equal, _dense_world, _jax_solver
from test_torch_preempt_sweep import _fields as sweep_fields

STATE_FIELDS = ("task_state", "task_node", "node_idle", "node_future")


def _eager_graphs(monkeypatch, cap: int) -> None:
    """Loops on the CPU take the eager form with chunks up to `cap`."""
    monkeypatch.setattr(graphs, "loop_graphs",
                        lambda dev: graphs.StepGraphs(dev, eager=True, chunk_cap=cap))


def _chunk_rule(rounds: int, max_rounds: int, cap: int) -> tuple[int, int]:
    """(bodies run, reads made) by the chunk rule for a loop whose
    `rounds`-th round is its last (it accepts nothing, or it is the
    `max_rounds`-th)."""
    ran, chunk, reads = 0, 1, 0
    while ran < max_rounds:
        ran += min(chunk, max_rounds - ran)
        reads += 1
        if ran >= rounds:
            break
        chunk = min(2 * chunk, cap)
    return ran, reads


# ---------------------------------------------------------------------------
# allocate_rounds
# ---------------------------------------------------------------------------

def _ungated_rounds(snap, state, pred, spec, rank_fn, eligible_fn, eps, use_future,
                    max_rounds, score_quantum, dyn_fn, gser_fn, dser_fn, ser, stats):
    """The rounds one a read, each applied only when it accepted
    something (the loop before step graphs)."""
    if max_rounds is None:
        max_rounds = snap.num_tasks
    cancelled = torch.zeros(len(CANCEL_STEPS), dtype=torch.int64)
    rounds = 0
    for _ in range(max_rounds):
        rounds += 1
        accept, perm, s_node = assignment.auction_round(
            snap, state, pred, spec, rank_fn, eligible_fn, eps, use_future, False,
            score_quantum, dyn_fn, gser_fn, dser_fn, ser, cancelled)
        if not bool(accept.any()):
            break
        assignment.apply_round(snap, state, accept, perm, s_node, use_future)
    stats["rounds"] = rounds
    stats["cancelled"] = dict(zip(CANCEL_STEPS, cancelled.tolist()))
    return state


def _port_pass(loop, snap, policy, state, use_future, max_rounds, stats):
    return loop(snap, state, policy.predicate_mask(snap), policy.score_spec(),
                policy.rank_fn, non_besteffort_eligible(policy), snap.eps, use_future,
                max_rounds, policy.score_quantum, policy.auction_dyn_predicate,
                policy.global_serialize_fn, policy.domain_serialize_fn,
                policy.serialize_mask(snap, state), stats)


def _chunked(snap, state, pred, spec, rank_fn, eligible_fn, eps, use_future, max_rounds,
             score_quantum, dyn_fn, gser_fn, dser_fn, ser, stats):
    return assignment.allocate_rounds(
        snap, state, pred, spec, rank_fn, eligible_fn, eps, use_future=use_future,
        max_rounds=max_rounds, score_quantum=score_quantum, dyn_predicate_fn=dyn_fn,
        global_serialize_fn=gser_fn, domain_serialize_fn=dser_fn, serialize_mask=ser,
        stats=stats)


_REF: dict = {}


def _jax_pass(fields, use_future: bool, max_rounds, state=None):
    """One pass of the reference's allocate_rounds, jitted as its
    allocate action jits it (from the packed state when `state` is
    None)."""
    jsnap = JaxSnapshot(**fields)
    policy, _ = jax_build_policy(jax_default_conf())

    def solve(snap, st):
        if st is None:
            st = policy.setup_state(snap, jax_init_state(snap))
        return jax_allocate_rounds(
            snap, st, policy.predicate_mask(snap), policy.score_fn, policy.rank_fn,
            jax_eligible(policy), snap.eps, use_future=use_future,
            max_rounds=max_rounds, score_quantum=policy.score_quantum,
            dyn_predicate_fn=policy.dyn_predicate,
            global_serialize_fn=policy.global_serialize_fn,
            domain_serialize_fn=policy.domain_serialize_fn)

    return jax.jit(solve)(jsnap, state)


# world → (packed world, max_rounds of the Idle pass, run the FutureIdle pass)
ALLOCATE_WORLDS = {
    "config1_gangs": ("config1", None, True),
    "affinity_cancelling": ("config5_affinity_small", None, True),
    "oracle_cut": ("oracle", 2, False),
}


def _reference(world):
    """(fields, reference states after each pass, ungated port states and
    stats after each pass), once a module."""
    if world not in _REF:
        name, max_rounds, future = ALLOCATE_WORLDS[world]
        fields, _ = jax_fields(name)
        passes = [(False, max_rounds)] + ([(True, None)] if future else [])
        want, jst = [], None
        for use_future, cap in passes:
            jst = _jax_pass(fields, use_future, cap, jst)
            want.append({f: np.asarray(getattr(jst, f)) for f in STATE_FIELDS})
        snap = from_numpy(fields, "cpu")
        policy, _ = build_policy(default_conf())
        st = policy.setup_state(snap, init_state(snap))
        ungated = []
        for use_future, cap in passes:
            stats: dict = {}
            _port_pass(_ungated_rounds, snap, policy, st, use_future, cap, stats)
            ungated.append(({f: getattr(st, f).clone() for f in STATE_FIELDS}, stats))
        _REF[world] = (fields, passes, want, ungated)
    return _REF[world]


@pytest.mark.parametrize("cap", [1, 3, 8])
@pytest.mark.parametrize("world", sorted(ALLOCATE_WORLDS))
def test_allocate_chunks_match_reference(world, cap, monkeypatch):
    fields, passes, want, ungated = _reference(world)
    _eager_graphs(monkeypatch, cap)
    snap = from_numpy(fields, "cpu")
    policy, _ = build_policy(default_conf())
    st = policy.setup_state(snap, init_state(snap))
    for (use_future, max_rounds), ref, (ug_state, ug_stats) in zip(passes, want, ungated):
        graphs.reset_totals()
        stats: dict = {}
        _port_pass(_chunked, snap, policy, st, use_future, max_rounds, stats)
        for f in STATE_FIELDS:
            np.testing.assert_array_equal(getattr(st, f).numpy(), ref[f], err_msg=f)
            assert torch.equal(getattr(st, f), ug_state[f]), f
        assert stats == ug_stats
        limit = snap.num_tasks if max_rounds is None else max_rounds
        bodies, reads = _chunk_rule(stats["rounds"], limit, cap)
        assert (graphs.totals["eager"], graphs.totals["reads"]) == (bodies, reads)
        assert graphs.totals["captured"] == graphs.totals["replays"] == 0
    idle = ungated[0][1]
    if world == "oracle_cut":
        assert idle["rounds"] == 2
        assert not np.array_equal(want[0]["task_state"],
                                  np.asarray(_jax_pass(fields, False, None).task_state))
    if world == "affinity_cancelling":
        assert sum(idle["cancelled"].values()) > 0
    assert idle["rounds"] >= 2


@pytest.mark.parametrize("world", ["config1_gangs", "affinity_cancelling"])
def test_allocate_rounds_equal_the_reference_count(world):
    """The reference's Idle pass reaches its fixed point in rounds − 1
    rounds (the rounds-th accepts nothing) and not in rounds − 2."""
    fields, _passes, want, ungated = _reference(world)
    rounds = ungated[0][1]["rounds"]
    at = np.asarray(_jax_pass(fields, False, rounds - 1).task_state)
    np.testing.assert_array_equal(at, want[0]["task_state"])
    before = np.asarray(_jax_pass(fields, False, rounds - 2).task_state)
    assert not np.array_equal(before, want[0]["task_state"])


@pytest.mark.parametrize("cap", [1, 3, 8])
def test_gate_keeps_rounds_and_cancelled_exact(cap, monkeypatch):
    """Every round adds 1 to the watermark's count: the chunked loop runs
    rounds past the fixed point (cap > 1), and the gate keeps them out of
    `rounds` and `cancelled`."""
    fields, _passes, _want, _ = _reference("oracle_cut")     # 4 rounds uncut
    real = assignment.auction_round

    def cancelling_round(*args):
        out = real(*args)
        if args[14] is not None:
            args[14][0] += 1
        return out

    monkeypatch.setattr(assignment, "auction_round", cancelling_round)
    got = []
    for loop in (_ungated_rounds, _chunked):
        _eager_graphs(monkeypatch, cap)
        graphs.reset_totals()
        snap = from_numpy(fields, "cpu")
        policy, _ = build_policy(default_conf())
        st = policy.setup_state(snap, init_state(snap))
        stats: dict = {}
        _port_pass(loop, snap, policy, st, False, None, stats)
        got.append((st, stats, graphs.totals["eager"]))
    (ug, ug_stats, _), (ch, ch_stats, bodies) = got
    assert ug_stats == ch_stats
    assert ch_stats["cancelled"]["resolve_watermark"] >= ch_stats["rounds"] >= 3
    assert bodies == _chunk_rule(ch_stats["rounds"], fields["task_state"].shape[0], cap)[0]
    if cap > 1:
        assert bodies > ch_stats["rounds"]
    for f in STATE_FIELDS:
        assert torch.equal(getattr(ug, f), getattr(ch, f)), f


# ---------------------------------------------------------------------------
# preemption_rounds
# ---------------------------------------------------------------------------

def _ungated_preemption(snap, state, predicate_mask, victim_mask_fn, starving_fn,
                        rank_fn, eligible_fn, eps, max_iters=None,
                        dyn_predicate_row_fn=None, stats=None):
    """The steps with a fresh state and carry each (the loop before step
    graphs)."""
    T, N = snap.num_tasks, snap.num_nodes
    if max_iters is None:
        max_iters = 2 * T + 4 * N + 16
    st, c = state, EvictCarry.fresh(T, N, snap.device)
    tally = new_tally()
    t0 = time.perf_counter()
    progressed = True
    while progressed and tally["steps"] < max_iters:
        out = evict_step(snap, st, c, predicate_mask, victim_mask_fn, starving_fn,
                         rank_fn, eligible_fn, eps, dyn_predicate_row_fn)
        flags = out.flags.tolist()
        tally_step(tally, flags)
        st = out.state
        c = dataclasses.replace(c, tried=out.tried, prov=out.prov, excl=out.excl,
                                excl_p=out.excl_p, p=out.p, n_t=out.n_t,
                                active=bool(flags[1]))
        progressed = bool(flags[0])
    if c.active:
        st = AllocState(
            task_state=torch.where(c.prov, snap.task_state, st.task_state),
            task_node=st.task_node, node_idle=st.node_idle,
            node_future=st.node_future.index_add(
                0, c.n_t.view(1), -_request_sum(c.prov, snap.task_req)[None, :]),
            aux=st.aux)
    if stats is not None:
        tally["ms"] = (time.perf_counter() - t0) * 1e3
        stats.update(tally)
    return st


def _config4_running():
    """Config 4's shape at a tenth of its size (tests/test_torch_preempt.py
    · _config4_small), its pods placed Running first-fit until the nodes
    are full, and two priority-10000 gangs arriving in the prod queue."""
    rng = random.Random(0)
    cache, sim = make_world(SPEC)
    free = []
    for i in range(50):
        sim.add_node(Node(name=f"n{i}",
                          allocatable={"cpu": 16000, "memory": 64 * GI, "pods": 110}))
        free.append([16000, 64 * GI])
    sim.add_queue(Queue(name="prod", weight=2.0))
    sim.add_queue(Queue(name="batch", weight=1.0))
    prios = [0, 100, 1000, 10000]
    for j in range(25):
        prio = prios[j % 4]
        pods = []
        for i in range(20):
            cpu, mem = rng.choice([1000, 2000, 4000]), rng.choice([2, 4, 8]) * GI
            node = next((n for n, (c, m) in enumerate(free) if c >= cpu and m >= mem), None)
            kw = {}
            if node is not None:
                free[node][0] -= cpu
                free[node][1] -= mem
                kw = {"status": TaskStatus.RUNNING, "node": f"n{node}"}
            pods.append(Pod(name=f"job{j}-{i}", priority=prio,
                            request={"cpu": cpu, "memory": mem, "pods": 1}, **kw))
        sim.submit(PodGroup(name=f"job{j}", queue="prod" if prio >= 1000 else "batch",
                            min_member=4, priority=prio), pods)
    for j in range(2):
        sim.submit(PodGroup(name=f"urgent{j}", queue="prod", min_member=4,
                            priority=10000),
                   [Pod(name=f"urgent{j}-{i}", priority=10000,
                        request={"cpu": 8000, "memory": 16 * GI, "pods": 1})
                    for i in range(4)])
    return cache


PREEMPT_WORLDS = {
    "config4_small": (_config4_running, "preempt"),
    "sweep_seed0": (lambda: _dense_world(0), "preempt"),
    "sweep_seed12": (lambda: _dense_world(12), "reclaim"),
}


@pytest.mark.parametrize("world", sorted(PREEMPT_WORLDS))
def test_preemption_static_buffers_match_reference(world, monkeypatch):
    build, mode = PREEMPT_WORLDS[world]
    fields, _meta = sweep_fields(build())
    jpolicy, jsolve = _jax_solver(mode)
    jsnap = JaxSnapshot(**fields)
    jout = jsolve(jsnap, jax_init_state(jsnap))
    jready = jax.jit(jpolicy.job_ready_mask)(jsnap, jout)
    action = preempt_action if mode == "preempt" else reclaim_action
    factory = (action.make_preempt_solver if mode == "preempt"
               else action.make_reclaim_solver)
    key = f"{mode}_steps"
    runs = []
    for loop in (None, _ungated_preemption):
        if loop is not None:
            monkeypatch.setattr(action, "preemption_rounds", loop)
        policy, _ = build_policy(default_conf())
        snap = from_numpy(fields, "cpu")
        stats: dict = {}
        out = factory(policy)(snap, init_state(snap), None, stats)
        runs.append((out, policy.job_ready_mask(snap, out), stats[key]))
    (out, ready, steps), (ug_out, ug_ready, ug_steps) = runs
    _assert_alone_equal(fields, (jout, jready), (snap, None, out, ready))
    for f in STATE_FIELDS:
        assert torch.equal(getattr(out, f), getattr(ug_out, f)), f
    assert torch.equal(ready, ug_ready)
    strip = [{k: v for k, v in loop.items() if k != "ms"} for loop in steps]
    assert strip == [{k: v for k, v in loop.items() if k != "ms"} for loop in ug_steps]
    assert sum(loop["evicted"] for loop in steps) > 0
    assert sum(loop["opened"] for loop in steps) > 0


# ---------------------------------------------------------------------------
# joint_rounds
# ---------------------------------------------------------------------------

def _ungated_joint(snap, state, phases, predicate_mask, rank_fn, eps,
                   dyn_predicate_fn=None, dyn_predicate_row_fn=None,
                   global_serialize_fn=None, domain_serialize_fn=None,
                   serialize_mask=None, stats=None):
    """The tier loop with a fresh state and carry each step (the loop
    before step graphs)."""
    T, N = snap.num_tasks, snap.num_nodes
    dev = snap.device
    evict_code = torch.zeros(T, dtype=torch.int32, device=dev)
    st, c = state, EvictCarry.fresh(T, N, dev)
    phase_reg = torch.zeros(1, dtype=torch.int32, device=dev)
    work, read = k12.tier_buffers(T, dev)
    step_out, last, phase, step = None, None, 0, 0
    tiers, tally, placed = [], new_tally(), 0
    while phase < len(phases):
        ph = phases[phase]
        auction = isinstance(ph, AuctionPhase)
        cur = c if last is None else last
        k12.tier_control(
            k12.AUCTION if auction else k12.EVICT, auction and ph.gated_on_evictions,
            step, _max_steps(ph, T, N), step_out, st.task_state, snap.task_state,
            snap.task_mask, ph.eligible_fn(snap, st),
            None if auction else ph.starving_fn(snap, st), snap.task_job, cur.tried,
            cur.prov, evict_code, snap.task_req, st.node_future, cur.excl, phase_reg,
            work, read, step <= 1)
        flags = read.tolist()
        if step_out is not None:
            if last is not None:
                tally_step(tally, flags[:k12.STEP_FLAGS])
                c = dataclasses.replace(c, tried=last.tried, prov=last.prov,
                                        excl=last.excl, excl_p=last.excl_p, p=last.p,
                                        n_t=last.n_t, active=bool(flags[1]))
            else:
                placed += flags[0]
        if flags[k12.STEP_FLAGS]:
            line = {"tier": ph.name, "kind": "auction" if auction else "evict",
                    "steps": step}
            if auction:
                line["placed"] = placed
            else:
                line.update({k: v for k, v in tally.items() if k != "steps"})
            tiers.append(line)
            c = dataclasses.replace(c, active=False,
                                    excl_p=torch.full((), -1, dtype=torch.long))
            step_out, last, tally, placed = None, None, new_tally(), 0
            phase, step = phase + 1, 0
            continue
        if auction:
            accept, perm, s_node = assignment.auction_round(
                snap, st, predicate_mask, ph.score_spec, rank_fn, ph.eligible_fn, eps,
                ph.use_future, False, ph.score_quantum, dyn_predicate_fn,
                global_serialize_fn, domain_serialize_fn, serialize_mask, None, work)
            assignment.apply_round(snap, st, accept, perm, s_node, ph.use_future)
            step_out = accept
        else:
            last = evict_step(snap, st, c, predicate_mask, ph.victim_fn, ph.starving_fn,
                              rank_fn, ph.eligible_fn, eps, dyn_predicate_row_fn, work)
            st = last.state
            evict_code = torch.where(last.is_v, ph.evict_code, evict_code)
            evict_code = torch.where(last.fail & c.prov, 0, evict_code)
            step_out = last.flags
        step += 1
    if stats is not None:
        stats["joint_tiers"] = tiers
    return st, evict_code


@pytest.mark.parametrize("world", ["priority_preempt", "cross_queue_reclaim"])
def test_joint_static_buffers_match_reference(world, monkeypatch):
    build, actions, evictions = JOINT_WORLDS[world]
    assert actions == FOUR
    fields, _ = joint_fields(build)
    want, got, stats = joint_solve(fields, actions, joint=True)
    joint_assert_equal(got, want)
    monkeypatch.setattr(joint_ops, "joint_rounds", _ungated_joint)
    _, ug_got, ug_stats = joint_solve(fields, actions, joint=True)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(got[0], f), getattr(ug_got[0], f)), f
    for name in got[1]:
        assert torch.equal(got[1][name], ug_got[1][name]), name
    tiers = [{k: v for k, v in t.items() if k != "ms"} for t in stats["joint_tiers"]]
    assert tiers == ug_stats["joint_tiers"]
    assert any(t["kind"] == "evict" and t["evicted"] for t in tiers)
    assert sum(int(got[1][name].sum()) for name in got[1]) == sum(evictions.values())


# ---------------------------------------------------------------------------
# the step graphs on the CPU
# ---------------------------------------------------------------------------

def test_cpu_step_graphs_run_every_body_eagerly():
    assert graphs.eager_graphs(torch.device("cpu")).chunk_cap == 1
    graphs.reset_totals()
    drv = graphs.loop_graphs(torch.device("cpu"))
    assert drv.eager and drv.chunk_cap == 1
    seen = []
    for key in ("a", "a", "b", "a"):
        drv.run(key, lambda key=key: seen.append(key))
    t = torch.tensor([1, 2])
    assert drv.read(t) == [1, 2]
    drv.close()
    assert seen == ["a", "a", "b", "a"]
    assert graphs.totals["eager"] == 4 and graphs.totals["reads"] == 1
    assert graphs.totals["captured"] == graphs.totals["replays"] == 0
    assert graphs.totals["loops"] == 1 and not drv.graphs
    assert graphs.CHUNK_CAP >= 2
