"""Accounting wrappers: JobInfo / NodeInfo / QueueInfo.

Reference counterparts: pkg/scheduler/api/job_info.go, node_info.go,
queue_info.go.  These keep the reference's status-dependent accounting
rules (which task statuses debit a node's Idle, what counts as Ready for
the gang gate) but store resource amounts as ResourceSpec-ordered NumPy
vectors, so the snapshot packer can bulk-copy them into device tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kube_batch_tpu_torch.api.resource import ResourceSpec
from kube_batch_tpu_torch.api.types import (
    ALLOCATED_STATUSES,
    READY_STATUSES,
    VALID_STATUSES,
    TaskStatus,
)
from kube_batch_tpu_torch.cache.cluster import Node, Pod, PodGroup, Queue


@dataclasses.dataclass
class NodeInfo:
    """Per-node resource accounting (≙ node_info.go · NodeInfo).

    Invariants (for tasks currently on this node):
      used      = Σ req of tasks in allocated statuses + releasing tasks
      idle      = allocatable − used
      releasing = Σ req of tasks in RELEASING
      future_idle = idle + releasing   (what frees once evictions land)
    """

    spec: ResourceSpec
    node: Node
    allocatable: np.ndarray = None  # type: ignore[assignment]
    idle: np.ndarray = None         # type: ignore[assignment]
    used: np.ndarray = None         # type: ignore[assignment]
    releasing: np.ndarray = None    # type: ignore[assignment]
    tasks: dict[str, Pod] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.allocatable is None:
            self.allocatable = self.spec.vec(self.node.allocatable)
        if self.idle is None:
            self.idle = self.allocatable.copy()
        if self.used is None:
            self.used = np.zeros(self.spec.num)
        if self.releasing is None:
            self.releasing = np.zeros(self.spec.num)

    @property
    def name(self) -> str:
        return self.node.name

    def _occupies(self, status: TaskStatus) -> bool:
        return status in ALLOCATED_STATUSES or status == TaskStatus.RELEASING

    def add_task(self, pod: Pod) -> None:
        """Account a task landing on this node (node_info.go · AddTask)."""
        if pod.uid in self.tasks:
            raise ValueError(f"task {pod.uid} already on node {self.name}")
        req = self.spec.pod_vec(pod)
        if self._occupies(pod.status):
            self.idle = self.idle - req
            self.used = self.used + req
        if pod.status == TaskStatus.RELEASING:
            self.releasing = self.releasing + req
        self.tasks[pod.uid] = pod

    def remove_task(self, pod: Pod) -> None:
        """Reverse add_task (node_info.go · RemoveTask)."""
        if pod.uid not in self.tasks:
            raise ValueError(f"task {pod.uid} not on node {self.name}")
        req = self.spec.pod_vec(pod)
        if self._occupies(pod.status):
            self.idle = self.idle + req
            self.used = self.used - req
        if pod.status == TaskStatus.RELEASING:
            self.releasing = self.releasing - req
        del self.tasks[pod.uid]

    def clone(self, pod_map: dict[str, Pod] | None = None) -> "NodeInfo":
        """Deep copy; `pod_map` shares one set of Pod copies across all
        cloned infos so a snapshot stays internally consistent."""
        tasks = (
            {uid: pod_map[uid] for uid in self.tasks}
            if pod_map is not None
            else dict(self.tasks)
        )
        return NodeInfo(
            spec=self.spec,
            node=self.node,
            allocatable=self.allocatable.copy(),
            idle=self.idle.copy(),
            used=self.used.copy(),
            releasing=self.releasing.copy(),
            tasks=tasks,
        )




@dataclasses.dataclass
class JobInfo:
    """A gang job: one PodGroup plus its member tasks
    (≙ job_info.go · JobInfo)."""

    spec: ResourceSpec
    pod_group: PodGroup
    queue: str = ""
    tasks: dict[str, Pod] = dataclasses.field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.pod_group.name

    @property
    def min_available(self) -> int:
        return self.pod_group.min_member

    @property
    def priority(self) -> int:
        return self.pod_group.priority

    def add_task(self, pod: Pod) -> None:
        self.tasks[pod.uid] = pod

    def remove_task(self, pod: Pod) -> None:
        self.tasks.pop(pod.uid, None)

    def _count(self, statuses: frozenset | set) -> int:
        return sum(1 for t in self.tasks.values() if t.status in statuses)

    @property
    def ready_task_num(self) -> int:
        return self._count(READY_STATUSES)

    @property
    def valid_task_num(self) -> int:
        return self._count(VALID_STATUSES)

    def ready(self) -> bool:
        """Gang gate: enough members hold resources (job_info.go · Ready)."""
        return self.ready_task_num >= self.min_available

    def valid(self) -> bool:
        """Could the gang gate still be met this cycle
        (gang plugin's JobValidFn input)."""
        return self.valid_task_num >= self.min_available

    def refresh_status(self, queue_known: bool = True) -> tuple[PodGroup, bool]:
        """Recompute the PodGroup status subresource from member tasks
        (≙ framework/job_updater.go batching PodGroup status updates at
        session close): running/succeeded/failed counts, and phase —
        Running once the gang holds minMember running-or-done members,
        Unknown for a broken gang (some members running but below the
        threshold), Inqueue for a gang that passed admission (a real
        queue and enough valid members to satisfy minMember) and is
        awaiting resources, Pending otherwise.

        Inqueue lowering note (≙ v1alpha1 · PodGroupPhase, the enqueue
        action of later kube-batch/Volcano): upstream the phase gates
        POD CREATION — the workload controller holds pods back until
        the scheduler admits the group.  This framework schedules pods
        that already exist, so the creation gate has nothing to gate;
        what remains observable is the admission statement itself —
        "this gang is complete and queued, only waiting for capacity" —
        versus Pending's "not yet admissible" (incomplete gang or
        unknown queue).  That distinction is exactly what the phase
        reports here, and it leaves the process through the same
        status-update writes the reference sends.

        Returns (group, changed): `changed` is False when every status
        field is identical to the last refresh, so callers skip the
        write-back — a steady-state daemon must not re-send thousands
        of identical status updates (one wire round trip each on the
        stream backend) every second."""
        from kube_batch_tpu_torch.api.types import PodGroupPhase

        pg = self.pod_group
        before = (pg.running, pg.succeeded, pg.failed, pg.phase)
        pg.running = self._count({TaskStatus.RUNNING, TaskStatus.BOUND,
                                  TaskStatus.BINDING})
        pg.succeeded = self._count({TaskStatus.SUCCEEDED})
        pg.failed = self._count({TaskStatus.FAILED})
        if pg.running + pg.succeeded >= self.min_available and self.tasks:
            pg.phase = PodGroupPhase.RUNNING
        elif pg.running > 0:
            pg.phase = PodGroupPhase.UNKNOWN   # gang degraded below minMember
        elif self.queue and queue_known and self.valid():
            # Admitted, awaiting capacity.  `queue_known` comes from the
            # caller holding the queue map (JobInfo cannot see it): a
            # gang naming an unknown/deleted queue is NOT admitted —
            # the snapshot excludes it entirely — and must read Pending,
            # not "queued, waiting for capacity".
            pg.phase = PodGroupPhase.INQUEUE
        else:
            pg.phase = PodGroupPhase.PENDING
        return pg, (pg.running, pg.succeeded, pg.failed, pg.phase) != before

    def clone(self, pod_map: dict[str, Pod] | None = None) -> "JobInfo":
        """Deep copy (see NodeInfo.clone for `pod_map`)."""
        tasks = (
            {uid: pod_map[uid] for uid in self.tasks}
            if pod_map is not None
            else dict(self.tasks)
        )
        return JobInfo(
            spec=self.spec,
            pod_group=self.pod_group,
            queue=self.queue,
            tasks=tasks,
        )


@dataclasses.dataclass
class QueueInfo:
    """≙ queue_info.go · QueueInfo."""

    queue: Queue

    @property
    def name(self) -> str:
        return self.queue.name

    @property
    def weight(self) -> float:
        return self.queue.weight
