"""Status enums for tasks and pod groups.

Reference counterpart: pkg/scheduler/api/types.go · TaskStatus and
pkg/apis/scheduling/v1alpha1/types.go · PodGroupPhase.  Values are integer
IntEnums because they are carried in device tensors (`task_state: i32[T]`).
"""

from __future__ import annotations

import enum


class TaskStatus(enum.IntEnum):
    """Lifecycle of a schedulable task (≙ one pod).

    Semantics follow pkg/scheduler/api/types.go · TaskStatus:

    * PENDING     — waiting for placement.
    * ALLOCATED   — placed in this session; bind not yet dispatched.
    * PIPELINED   — placed against resources that are still being released
                    (fits FutureIdle but not Idle); no bind until release.
    * BINDING     — bind dispatched to the backend, not yet confirmed.
    * BOUND       — backend confirmed the bind.
    * RUNNING     — the workload is executing on its node.
    * RELEASING   — eviction/termination in flight; resources will free.
    * SUCCEEDED / FAILED — terminal.
    * UNKNOWN     — inconsistent backend state.
    """

    PENDING = 0
    ALLOCATED = 1
    PIPELINED = 2
    BINDING = 3
    BOUND = 4
    RUNNING = 5
    RELEASING = 6
    SUCCEEDED = 7
    FAILED = 8
    UNKNOWN = 9


#: Statuses whose resource request is debited from the node's Idle
#: (reference: pkg/scheduler/api/job_info.go · AllocatedStatus).
ALLOCATED_STATUSES = frozenset(
    {TaskStatus.ALLOCATED, TaskStatus.BINDING, TaskStatus.BOUND, TaskStatus.RUNNING}
)

#: Statuses counting toward the gang-readiness threshold
#: (job_info.go · ReadyTaskNum).  Single source of truth for host
#: accounting (cache.info) and device kernels (api.snapshot).
READY_STATUSES = ALLOCATED_STATUSES | {TaskStatus.SUCCEEDED}

#: Statuses that could still become ready (job_info.go · ValidTaskNum).
VALID_STATUSES = READY_STATUSES | {TaskStatus.PENDING, TaskStatus.PIPELINED}


if hasattr(enum, "StrEnum"):
    _StrEnum = enum.StrEnum
else:  # Python 3.10 (the floor pyproject declares): same semantics
    class _StrEnum(str, enum.Enum):
        def __str__(self) -> str:
            return str(self.value)


class PodGroupPhase(_StrEnum):
    """Phase of a job/pod-group (reference: v1alpha1 · PodGroupPhase)."""

    PENDING = "Pending"
    RUNNING = "Running"
    UNKNOWN = "Unknown"
    INQUEUE = "Inqueue"


import dataclasses as _dataclasses  # noqa: E402 — local to avoid re-export


@_dataclasses.dataclass
class PodGroupCondition:
    """Typed status condition (≙ v1alpha1 · PodGroupCondition:
    Type/Status/Reason/Message).  Supports `"text" in condition` so
    message greps read naturally in tests and logs."""

    type: str                 # e.g. "Unschedulable"
    message: str = ""
    status: bool = True
    reason: str = ""

    def __str__(self) -> str:
        return f"{self.type}: {self.message}"

    def __contains__(self, item: str) -> bool:
        return item in str(self)


@_dataclasses.dataclass
class Event:
    """A structured per-object event record (≙ the Kubernetes Events
    the reference emits through its Recorder): object kind/name, a
    CamelCase reason, a human message, and an aggregation count.
    Supports `"text" in event` for message greps."""

    kind: str                 # "Pod" | "PodGroup" | "Node" | "Scheduler"
    name: str                 # object name ("" for scheduler-level)
    reason: str               # "Bound" | "Evicted" | "BindFailed" | ...
    message: str = ""
    count: int = 1

    def __str__(self) -> str:
        suffix = f" (x{self.count})" if self.count > 1 else ""
        return f"{self.kind}/{self.name} {self.reason}: {self.message}{suffix}"

    def __contains__(self, item: str) -> bool:
        return item in str(self)

