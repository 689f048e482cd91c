"""Why-is-my-pod-not-scheduled diagnosis.

Reference counterpart: pkg/scheduler/api/unschedule_info.go — the
`FitErrors` aggregation rendering "0/4 nodes are available: 3
Insufficient cpu, 1 node(s) had taints"; the port of
kube_batch_tpu/framework/fit_errors.py.  The per-(task, node) failure
classes reduce to per-task counts in one pass (kernel K4), pulled to the
host once per cycle for tasks that stayed Pending.  `failure_counts_subset`
computes them on the pending rows alone (not called by the cycle, as in
the reference).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.cache.packer import gather_tasks
from kube_batch_tpu_torch.kernels import failure_counts as _k4

#: Per-cycle cap on rendered unschedulable events.
MAX_DIAG_EVENTS = 1000


def failure_counts(snap, state, predicate_mask: torch.Tensor, dyn=None) -> dict:
    """Per-task failure tallies over real, ready nodes: "nodes" (i32
    scalar), "predicate_failed" i32[T], "insufficient" i32[T, R] (nodes
    short on each dim), "feasible" i32[T] (nodes fully fitting).  The
    predicate is `predicate_mask` ANDed with `dyn`: the dynamic predicates
    as a bool[T, N] mask, as kernel K10's words (`kernels/affinity.py ·
    AffinityWords`, tested inside kernel K4's launch), or None."""
    node_ok = snap.node_mask & snap.node_ready
    pf, ins, fe, nodes = _k4.failure_counts(
        predicate_mask, dyn, snap.task_req, state.node_idle, snap.eps, node_ok
    )
    return {
        "nodes": nodes,
        "predicate_failed": pf,
        "insufficient": ins,
        "feasible": fe,
    }


def diag_window_rows(max_events: int | None) -> int:
    """The gathered window a caller should pass for a consumer's event
    cap (≙ kube_batch_tpu framework/fit_errors.py · diag_window_rows):
    derived, so a larger cap never outgrows the window; 2x headroom."""
    if max_events is None:
        return 2048
    return max(2048, 2 * int(max_events))


def failure_counts_subset(snap, state, policy, max_rows: int | None = None,
                          max_events: int | None = MAX_DIAG_EVENTS) -> dict:
    """failure_counts on the pending rows only, scattered back to [T] —
    the active-set diagnosis (≙ kube_batch_tpu framework/fit_errors.py ·
    failure_counts_subset).

    The first P = min(max_rows, T) pending rows in ascending order (the
    order diagnose_pending walks; fill rows repeat row 0, masked out)
    are gathered (cache/packer.py · gather_tasks), and kernels K1, K10
    and K4 run at [P, N]; the dynamic predicates go through their subset
    forms, which read the residents from the full (snap, state) (kernel
    K11).  Rows outside the window scatter back as 0: exact on every row
    diagnose_pending reads while its event cap `max_events` stays below
    `max_rows` (which defaults to `diag_window_rows(max_events)`; a
    window at or below the cap raises, before any argument is read;
    `max_events=None` opts out).  With a dynamic predicate that has no
    subset form, the full [T, N] tallies, as the cycle computes them.

    K4 takes the dynamic predicates as the policy's
    `subset_dyn_predicate` gives them: K10's words where it has them,
    else the mask.  The window's pending count is read on the host once
    (this is no step-graph body).
    """
    if max_rows is None:
        max_rows = diag_window_rows(max_events)
    if max_events is not None and max_events >= max_rows:
        raise ValueError(
            f"failure_counts_subset: max_events={max_events} must stay below "
            f"max_rows={max_rows} — pending rows beyond the gathered window "
            "scatter back as all-zero tallies and would render as '0/N nodes "
            "available:' events with no reasons")
    if not policy.has_subset_dynamic_predicates:
        return failure_counts(snap, state, policy.predicate_mask(snap),
                              policy.auction_dyn_predicate(snap, state, immediate=True))

    T, R, dev = snap.num_tasks, snap.num_resources, snap.device
    P = min(max_rows, T)
    pending = (state.task_state == int(TaskStatus.PENDING)) & snap.task_mask
    rows = torch.nonzero(pending).squeeze(1)[:P]           # ascending
    idx = torch.zeros(P, dtype=torch.int64, device=dev)
    idx[:rows.numel()] = rows
    valid = torch.arange(P, device=dev) < rows.numel()
    sub = gather_tasks(snap, idx, valid)
    sub_state = dataclasses.replace(state, task_state=state.task_state[idx],
                                    task_node=state.task_node[idx])
    counts = failure_counts(sub, sub_state, policy.predicate_mask(sub),
                            policy.subset_dyn_predicate(snap, state, sub, sub_state,
                                                        immediate=True))
    # amax, as the reference's .at[idx].max: the fill rows repeat row 0 and
    # must not overwrite its tally (nor may the order duplicates land in)
    v = valid.to(torch.int32)
    zeros = torch.zeros(T, dtype=torch.int32, device=dev)
    return {
        "nodes": counts["nodes"],
        "predicate_failed": zeros.clone().scatter_reduce_(
            0, idx, counts["predicate_failed"] * v, "amax"),
        "insufficient": torch.zeros((T, R), dtype=torch.int32, device=dev).scatter_reduce_(
            0, idx[:, None].expand(P, R), counts["insufficient"] * v[:, None], "amax"),
        "feasible": zeros.scatter_reduce_(0, idx, counts["feasible"] * v, "amax"),
    }


def render_fit_error(
    task_name: str,
    counts: dict[str, np.ndarray],
    t: int,
    resource_names: tuple[str, ...],
) -> str:
    """One event line per unschedulable task (≙ FitErrors.Error())."""
    total = int(counts["nodes"])
    reasons: list[str] = []
    pf = int(counts["predicate_failed"][t])
    if pf:
        reasons.append(f"{pf} node(s) failed predicates")
    insuff = counts["insufficient"][t]
    for r, name in enumerate(resource_names):
        c = int(insuff[r])
        if c:
            reasons.append(f"{c} Insufficient {name}")
    feas = int(counts["feasible"][t])
    if feas:
        reasons.append(
            f"{feas} node(s) feasible but outranked (fair share / gang order)"
        )
    if not reasons:
        reasons.append("no nodes in cluster")
    return f"0/{total} nodes are available for {task_name}: " + ", ".join(reasons)


def diagnose_pending(ssn, max_events: int = MAX_DIAG_EVENTS):
    """(pod name, namespace, message) triples for real tasks still
    Pending at session end, from the tallies the cycle computed."""
    task_state = ssn.host_task_state
    pending = np.nonzero(
        task_state[: ssn.meta.num_real_tasks] == int(TaskStatus.PENDING)
    )[0]
    if pending.size == 0 or ssn.diag is None:
        return []
    counts = {k: v.cpu().numpy() for k, v in ssn.diag.items()}
    out = []
    for t in pending[:max_events]:
        pod = ssn.meta.task_pods[t]
        out.append((
            pod.name, pod.namespace,
            render_fit_error(pod.name, counts, t, ssn.meta.spec.names),
        ))
    if pending.size > max_events:
        out.append((
            "", "default",
            f"... and {pending.size - max_events} more unschedulable tasks",
        ))
    return out
