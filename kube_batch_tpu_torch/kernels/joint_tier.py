"""K12 · tier control of the joint single-solve cycle (CUDA C++,
`csrc/joint_tier.cu`).

Replaces kube_batch_tpu/ops/joint.py · _haswork_fn and advance, with the
loop body's tier_done test.  What bounds it on the card and its design
are noted in the source.

`tier_control(kind, gated, step, max_steps, step_out, ..., work, read)`
is called once per iteration of the joint loop, fed by the step it
follows: `step_out` is None at a tier's first call, the accept mask
(bool[T]) after an auction round, or the flag vector (i64[7],
ops/preemption.py · FLAG_KEYS) after an evict step.  It

* writes `work` (bool[T]): the tier's pending & eligible set on the
  current state (an evict tier's also starving[job] & job >= 0 &
  ~tried), which the next step takes in place of computing the tier's
  masks again — void once the tier is done;
* evaluates `tier_done = ~progressed | step >= max_steps | ~has_work`,
  progressed being the auction round's accepted count > 0 or the evict
  step's first flag (true at a tier's first call), and when the tier is
  done applies the advance IN PLACE: an open plan's provisional victims
  return to their snapshot status and lose their eviction codes,
  node_future[plan node] gets the plan's request sum back (float64,
  rounded once), `tried`, `prov` and `excl` are cleared and the phase
  register moves on;
* writes `read` (i64[READ]): the step's flags (the auction round's
  accepted count, or the evict step's seven flags), then [done,
  has_work, phase] — the iteration's one host read.

    kind       AUCTION (with `gated`, has work only once some eviction
               code is set) or EVICT (has work too while a plan is open)

`work` and `read` belong to the caller's loop and are reused every
iteration.  `check` validates every tensor (type, device, contiguity of
what is written in place); the joint loop asks for it at a tier's first
two calls — the tensors it starts with and those of its first step,
which every later step makes alike — and not on every step.

The wrapper runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from kube_batch_tpu_torch.kernels import build

AUCTION, EVICT = 0, 1
MAX_R = 8
STEP_FLAGS = 7                   # the evict step's flag vector
READ = STEP_FLAGS + 3            # [step flags | done, has_work, phase]
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_I] * 9 + [_P] * 17


def tier_buffers(num_tasks: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(work bool[T], read i64[READ]): the buffers a loop keeps."""
    return (torch.zeros(num_tasks, dtype=torch.bool, device=device),
            torch.zeros(READ, dtype=torch.int64, device=device))


def tier_control_plain(kind, gated, step, max_steps, step_out, task_state,
                       snap_state, task_mask, elig, starving, task_job, tried,
                       prov, code, task_req, node_future, excl, phase, work, read,
                       check=True):  # noqa: ARG001
    flags = torch.zeros(STEP_FLAGS, dtype=torch.int64, device=read.device)
    if step_out is None:
        progressed, prov_active, prov_n = True, False, 0
    elif step_out.dtype == torch.bool:
        flags[0] = step_out.sum()
        progressed, prov_active, prov_n = bool(flags[0] > 0), False, 0
    else:
        flags.copy_(step_out)
        progressed, prov_active, prov_n = bool(flags[0]), bool(flags[1]), int(flags[2])
    w = (task_state == 0) & task_mask & elig
    if kind == EVICT:
        J = starving.shape[0]
        jc = torch.clamp(task_job, 0, J - 1).long()
        w = w & starving[jc] & (task_job >= 0) & ~tried
    work.copy_(w)
    has_work = bool(w.any())
    if kind == AUCTION:
        has_work = has_work and (not gated or bool((code > 0).any()))
    else:
        has_work = has_work or prov_active
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
    read[:STEP_FLAGS] = flags
    read[STEP_FLAGS:] = torch.tensor([int(done), int(has_work), int(phase)],
                                     dtype=torch.int64)
    return read


_DTYPES = {
    "task_state": torch.int32, "snap_state": torch.int32, "task_mask": torch.bool,
    "elig": torch.bool, "starving": torch.bool, "task_job": torch.int32,
    "tried": torch.bool, "prov": torch.bool, "code": torch.int32,
    "task_req": torch.float32, "node_future": torch.float32, "excl": torch.bool,
    "phase": torch.int32, "work": torch.bool, "read": torch.int64,
}


def _check(kind, step_out, tensors: dict, dev) -> None:
    if kind not in (AUCTION, EVICT):
        raise ValueError(f"tier_control: unknown tier kind {kind}")
    if kind == EVICT and tensors["starving"] is None:
        raise ValueError("tier_control: an evict tier needs the starving mask")
    T = tensors["task_state"].shape[0]
    for name, x in tensors.items():
        if x is None:
            continue
        if x.dtype != _DTYPES[name] or x.device != dev or not x.is_contiguous():
            raise TypeError(f"tier_control: {name} must be contiguous {_DTYPES[name]} "
                            f"on {dev}, got {x.dtype} on {x.device}")
    if tensors["work"].shape != (T,) or tensors["read"].shape != (READ,):
        raise ValueError(f"tier_control: work must be [{T}] and read [{READ}]")
    if tensors["node_future"].shape[1] > MAX_R:
        raise ValueError(f"tier_control: at most {MAX_R} resource dims")
    if step_out is not None:
        ok = ((step_out.dtype == torch.bool and step_out.shape == (T,))
              or (step_out.dtype == torch.int64 and step_out.shape == (STEP_FLAGS,)))
        if not ok or step_out.device != dev or not step_out.is_contiguous():
            raise TypeError("tier_control: step_out must be a bool[T] accept mask or "
                            f"the i64[{STEP_FLAGS}] flags of an evict step on {dev}")


def tier_control(kind, gated, step, max_steps, step_out, task_state, snap_state,
                 task_mask, elig, starving, task_job, tried, prov, code, task_req,
                 node_future, excl, phase, work, read, check=True):
    """`read` (i64[READ]) — see the module docstring."""
    dev = task_state.device
    if dev.type == "cpu":
        return tier_control_plain(kind, gated, step, max_steps, step_out, task_state,
                                  snap_state, task_mask, elig, starving, task_job,
                                  tried, prov, code, task_req, node_future, excl,
                                  phase, work, read)
    if dev.type != "cuda":
        raise RuntimeError(f"tier_control: unsupported device {dev}")
    if check:
        _check(kind, step_out, dict(
            task_state=task_state, snap_state=snap_state, task_mask=task_mask,
            elig=elig, starving=starving, task_job=task_job, tried=tried, prov=prov,
            code=code, task_req=task_req, node_future=node_future, excl=excl,
            phase=phase, work=work, read=read), dev)
    step_kind = 0 if step_out is None else (1 if step_out.dtype == torch.bool else 2)
    N, R = node_future.shape
    J = 0 if starving is None else starving.shape[0]
    err = build.function("joint_tier", "kb_joint_tier", _SIGNATURE)(
        kind, int(gated), step_kind, step, max_steps, task_state.shape[0], N, R, J,
        None if step_out is None else step_out.data_ptr(), task_state.data_ptr(),
        snap_state.data_ptr(), task_mask.data_ptr(), elig.data_ptr(),
        None if starving is None else starving.data_ptr(), task_job.data_ptr(),
        tried.data_ptr(), prov.data_ptr(), code.data_ptr(), task_req.data_ptr(),
        node_future.data_ptr(), excl.data_ptr(), phase.data_ptr(), work.data_ptr(),
        read.data_ptr(), build.stream_handle(dev))
    build.check(err, "tier_control")
    tier_control.launches += 1
    return read


tier_control.launches = 0
