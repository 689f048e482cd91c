"""K12 · tier control of the joint single-solve cycle (CUDA C++,
`csrc/joint_tier.cu`).

Replaces kube_batch_tpu/ops/joint.py · _haswork_fn and advance, with the
loop body's tier_done test.  What bounds it on the card and its design
are noted in the source.

`tier_control(kind, gated, step, max_steps, carry, ...)` evaluates the
current tier's work test and `tier_done = ~progressed | step >= max_steps
| ~has_work`; when the tier is done it applies the advance IN PLACE —
an open plan's provisional victims return to their snapshot status and
lose their eviction codes, node_future[prov_n] gets the plan's request
sum back (float64, rounded once), `tried`, `prov` and `excl` are
cleared and the phase register moves on — and returns i32[3] [done,
has_work, phase] on the device, for the host's one read of the step.

    kind       AUCTION (pending & eligible; with `gated`, only once some
               eviction code is set) or EVICT (pending & starving[job] &
               job >= 0 & eligible & ~tried, or an open plan)
    carry      i32[3] [progressed, plan open, plan node] of the last step

The wrapper runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from kube_batch_tpu_torch.kernels import build

AUCTION, EVICT = 0, 1
MAX_R = 8
_P, _I = ctypes.c_void_p, ctypes.c_int


def tier_control_plain(kind, gated, step, max_steps, carry, task_state,
                       snap_state, task_mask, elig, starving, task_job, tried,
                       prov, code, task_req, node_future, excl, phase):
    progressed, prov_active, prov_n = (int(x) for x in carry.tolist())
    work = (task_state == 0) & task_mask & elig
    if kind == EVICT:
        J = starving.shape[0]
        jc = torch.clamp(task_job, 0, J - 1).long()
        work = work & starving[jc] & (task_job >= 0) & ~tried
    has_work = bool(work.any())
    if kind == AUCTION:
        has_work = has_work and (not gated or bool((code > 0).any()))
    else:
        has_work = has_work or bool(prov_active)
    done = not progressed or step >= max_steps or not has_work
    if done:
        if prov_active:
            task_state[prov] = snap_state[prov]
            code[prov] = 0
            s = torch.where(prov[:, None], task_req, 0.0).double().sum(0).float()
            node_future[prov_n] -= s
        tried.zero_()
        prov.zero_()
        excl.zero_()
        phase += 1
    return torch.tensor([int(done), int(has_work), int(phase)], dtype=torch.int32)


_DTYPES = {
    "carry": torch.int32, "task_state": torch.int32, "snap_state": torch.int32,
    "task_mask": torch.bool, "elig": torch.bool, "starving": torch.bool,
    "task_job": torch.int32, "tried": torch.bool, "prov": torch.bool,
    "code": torch.int32, "task_req": torch.float32, "node_future": torch.float32,
    "excl": torch.bool, "phase": torch.int32,
}
# written in place: must be the caller's own contiguous tensors
_IN_PLACE = ("task_state", "tried", "prov", "code", "node_future", "excl", "phase")


def tier_control(kind, gated, step, max_steps, carry, task_state, snap_state,
                 task_mask, elig, starving, task_job, tried, prov, code,
                 task_req, node_future, excl, phase):
    """i32[3] [done, has_work, phase] — see the module docstring."""
    args = dict(carry=carry, task_state=task_state, snap_state=snap_state,
                task_mask=task_mask, elig=elig, starving=starving,
                task_job=task_job, tried=tried, prov=prov, code=code,
                task_req=task_req, node_future=node_future, excl=excl,
                phase=phase)
    dev = task_state.device
    if dev.type == "cpu":
        return tier_control_plain(kind, gated, step, max_steps, *args.values())
    if dev.type != "cuda":
        raise RuntimeError(f"tier_control: unsupported device {dev}")
    if kind not in (AUCTION, EVICT):
        raise ValueError(f"tier_control: unknown tier kind {kind}")
    if kind == EVICT and starving is None:
        raise ValueError("tier_control: an evict tier needs the starving mask")
    for name, x in args.items():
        if x is None:
            continue
        if x.dtype != _DTYPES[name] or x.device != dev:
            raise TypeError(f"tier_control: {name} must be {_DTYPES[name]} on "
                            f"{dev}, got {x.dtype} on {x.device}")
        if name in _IN_PLACE and not x.is_contiguous():
            raise ValueError(f"tier_control: {name} is written in place and "
                             "must be contiguous")
    T = task_state.shape[0]
    N, R = node_future.shape
    if R > MAX_R:
        raise ValueError(f"tier_control: at most {MAX_R} resource dims, got {R}")
    J = 0 if starving is None else starving.shape[0]
    c = {k: (None if v is None else v.contiguous()) for k, v in args.items()}
    flags = torch.empty(3, dtype=torch.int32, device=dev)
    fn = build.library("joint_tier").kb_joint_tier
    fn.argtypes = [_I] * 8 + [_P] * 16
    fn.restype = ctypes.c_int
    err = fn(kind, int(gated), int(step), int(max_steps), T, N, R, J,
             *(build.ptr(v) for v in c.values()), build.ptr(flags),
             build.stream_handle(dev))
    build.check(err, "tier_control")
    tier_control.launches += 1
    return flags


tier_control.launches = 0
