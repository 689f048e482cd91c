"""Why-is-my-pod-not-scheduled diagnosis.

Reference counterpart: pkg/scheduler/api/unschedule_info.go — the
`FitErrors` aggregation rendering "0/4 nodes are available: 3
Insufficient cpu, 1 node(s) had taints"; the port of
kube_batch_tpu/framework/fit_errors.py.  The per-(task, node) failure
classes reduce to per-task counts in one pass (kernel K4), pulled to the
host once per cycle for tasks that stayed Pending.
"""

from __future__ import annotations

import numpy as np
import torch

from kube_batch_tpu_torch.api.types import TaskStatus
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
