"""SchedulerCache: the event-sourced host mirror of the cluster.

Reference counterpart: pkg/scheduler/cache/cache.go (SchedulerCache) and
cache/event_handlers.go.  The cache ingests add/update/delete events for
pods, nodes, pod groups and queues (here from the simulator), maintains
Job/Node/Queue accounting under one lock, and exposes:

* `snapshot()` — a consistent copy (≙ cache.go · Snapshot), which the
  packer turns into `SnapshotTensors`;
* `bind()` — a placement reaches the world through the `Binder` seam,
  failed binds re-queued (≙ cache.go · Bind / processResyncTask);
* `evict()` — a preemption or reclaim victim reaches the world through
  the `Evictor` seam (≙ cache.go · Evict).

This is the simulator-path subset of `kube_batch_tpu.cache.cache`: the
incremental-pack journal, health ledger, commit pipeline and relist
quiescence are not part of the port yet.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import threading

from kube_batch_tpu_torch.api.resource import ResourceSpec
from kube_batch_tpu_torch.api.types import Event, TaskStatus
from kube_batch_tpu_torch.cache.cluster import (
    Claim,
    Namespace,
    Node,
    Pod,
    PodDisruptionBudget,
    PodGroup,
    Queue,
    StorageClass,
)
from kube_batch_tpu_torch.cache.info import JobInfo, NodeInfo, QueueInfo

DEFAULT_QUEUE = "default"


@dataclasses.dataclass
class HostSnapshot:
    """Consistent host-side copy of the cache (≙ api.ClusterInfo)."""

    spec: ResourceSpec
    jobs: dict[str, JobInfo]          # by group name
    nodes: dict[str, NodeInfo]        # by node name
    queues: dict[str, QueueInfo]      # by queue name
    claims: dict[str, Claim] = dataclasses.field(default_factory=dict)
    storage_classes: dict[str, StorageClass] = dataclasses.field(
        default_factory=dict
    )
    namespaces: dict[str, Namespace] = dataclasses.field(default_factory=dict)
    pdbs: dict[str, PodDisruptionBudget] = dataclasses.field(
        default_factory=dict
    )
    # Quarantined node names and probation canary caps; always empty in
    # this slice (no health ledger), kept so the packer reads the same
    # fields as the reference packer.
    cordoned: frozenset = frozenset()
    canary_pods: dict = dataclasses.field(default_factory=dict)


class SchedulerCache:
    def __init__(
        self,
        spec: ResourceSpec,
        binder,
        evictor,
        status_updater=None,
        default_queue: str = DEFAULT_QUEUE,
    ) -> None:
        if evictor is None:
            raise ValueError("SchedulerCache needs an evictor")
        self.spec = spec
        self.binder = binder
        self.evictor = evictor
        self.status_updater = status_updater
        self.default_queue = default_queue

        self._lock = threading.RLock()
        self._pods: dict[str, Pod] = {}          # by uid
        self._jobs: dict[str, JobInfo] = {}      # by group name
        self._nodes: dict[str, NodeInfo] = {}    # by node name
        self._queues: dict[str, QueueInfo] = {}  # by queue name
        self._claims: dict[str, Claim] = {}
        self._storage_classes: dict[str, StorageClass] = {}
        self._namespaces: dict[str, Namespace] = {}
        self._pdbs: dict[str, PodDisruptionBudget] = {}
        self._resync: list[str] = []             # pod uids of failed binds
        # Structured per-object events (≙ the reference's Recorder),
        # bounded; repeats aggregate into one record's count.
        self.events: collections.deque = collections.deque(maxlen=10000)
        self._event_index: dict[tuple, Event] = {}

        self.add_queue(Queue(name=default_queue, weight=1.0))

    # -- events (≙ cache.go · Recorder) ---------------------------------
    def record_event(self, kind: str, name: str, reason: str, message: str,
                     namespace: str = "default") -> Event:
        del namespace  # events stay in-process in this slice
        with self._lock:
            key = (kind, name, reason, message)
            ev = self._event_index.get(key)
            if ev is not None:
                ev.count += 1
                return ev
            ev = Event(kind=kind, name=name, reason=reason, message=message)
            if len(self.events) == self.events.maxlen:
                old = self.events[0]
                self._event_index.pop(
                    (old.kind, old.name, old.reason, old.message), None
                )
            self.events.append(ev)
            self._event_index[key] = ev
            return ev

    def add_job_condition(self, job_name: str, condition) -> None:
        """Append a typed PodGroup condition through the cache funnel,
        deduplicated by (type, message)."""
        with self._lock:
            job = self._jobs.get(job_name)
            if job is None:
                return
            for existing in job.pod_group.conditions:
                if (
                    getattr(existing, "type", None) == condition.type
                    and getattr(existing, "message", None) == condition.message
                ):
                    return
            job.pod_group.conditions.append(condition)

    # -- event handlers (≙ cache/event_handlers.go) ---------------------
    def add_pod(self, pod: Pod) -> None:
        with self._lock:
            if pod.uid in self._pods:
                raise ValueError(f"pod {pod.uid} already cached")
            self.spec.pod_vec(pod)  # memoize request vector once, at ingest
            self._pods[pod.uid] = pod
            if pod.group is not None:
                job = self._jobs.get(pod.group)
                if job is None:
                    # Pod arrived before its PodGroup: a shell job that
                    # stays unschedulable until the group object lands.
                    job = JobInfo(
                        spec=self.spec,
                        pod_group=PodGroup(name=pod.group, queue=""),
                        queue="",
                    )
                    self._jobs[pod.group] = job
                job.add_task(pod)
            if pod.node is not None:
                self._node(pod.node).add_task(pod)

    def delete_pod(self, pod_uid: str) -> None:
        with self._lock:
            pod = self._pods.pop(pod_uid, None)
            if pod is None:
                return
            if pod.group is not None and pod.group in self._jobs:
                self._jobs[pod.group].remove_task(pod)
            if pod.node is not None and pod.node in self._nodes:
                self._nodes[pod.node].remove_task(pod)

    def update_pod_status(
        self, pod_uid: str, status: TaskStatus, node: str | None = None
    ) -> None:
        """Transition a pod's status (and optionally its node), keeping
        node accounting consistent (≙ UpdatePod re-accounting)."""
        with self._lock:
            pod = self._pods.get(pod_uid)
            if pod is None:
                return
            if pod.node is not None and pod.node in self._nodes:
                self._nodes[pod.node].remove_task(pod)
            pod.status = status
            if node is not None:
                pod.node = node
            if status == TaskStatus.PENDING:
                pod.node = None
            if pod.node is not None:
                if pod.node in self._nodes:
                    self._nodes[pod.node].add_task(pod)
                else:  # node vanished under the pod
                    pod.node = None

    def add_node(self, node: Node) -> None:
        with self._lock:
            if node.name in self._nodes:
                raise ValueError(f"node {node.name} already cached")
            self._nodes[node.name] = NodeInfo(spec=self.spec, node=node)

    def update_node(self, node: Node) -> None:
        """Replace a node's API object; idle = allocatable − used is
        re-derived.  Unknown node → add."""
        with self._lock:
            info = self._nodes.get(node.name)
            if info is None:
                self._nodes[node.name] = NodeInfo(spec=self.spec, node=node)
                return
            info.node = node
            info.allocatable = self.spec.vec(node.allocatable)
            info.idle = info.allocatable - info.used

    def delete_node(self, name: str) -> None:
        with self._lock:
            info = self._nodes.pop(name, None)
            if info is not None:
                # Residents lose their placement; they'll be rescheduled.
                for pod in info.tasks.values():
                    pod.node = None
                    pod.status = TaskStatus.PENDING

    def add_pod_group(self, group: PodGroup) -> None:
        with self._lock:
            queue = group.queue or self.default_queue
            existing = self._jobs.get(group.name)
            if existing is not None:
                existing.pod_group = group
                existing.queue = queue
            else:
                self._jobs[group.name] = JobInfo(
                    spec=self.spec, pod_group=group, queue=queue
                )

    def delete_pod_group(self, name: str) -> None:
        with self._lock:
            self._jobs.pop(name, None)

    def add_queue(self, queue: Queue) -> None:
        with self._lock:
            self._queues[queue.name] = QueueInfo(queue=queue)

    def add_claim(self, claim: Claim) -> None:
        with self._lock:
            self._claims[claim.name] = claim

    def add_storage_class(self, sc: StorageClass) -> None:
        with self._lock:
            self._storage_classes[sc.name] = sc

    def add_namespace(self, ns: Namespace) -> None:
        with self._lock:
            self._namespaces[ns.name] = ns

    def add_pdb(self, pdb: PodDisruptionBudget) -> None:
        with self._lock:
            self._pdbs[pdb.name] = pdb

    def _node(self, name: str) -> NodeInfo:
        info = self._nodes.get(name)
        if info is None:
            raise KeyError(f"unknown node {name}")
        return info

    # -- snapshot (≙ cache.go · Snapshot) --------------------------------
    def lock(self):
        """The cache mutex (reentrant), for multi-step consistent reads —
        the shared snapshot plus tensor pack in Session.__init__."""
        return self._lock

    def snapshot(self, shared: bool = False) -> HostSnapshot:
        """Consistent view.  Jobs without a real PodGroup or with an
        unknown queue are skipped (≙ Snapshot's same filter) — their
        pods still occupy nodes via NodeInfo accounting.

        shared=False: Pod objects are copied (one shared copy per pod
        across the whole snapshot), so later cache mutations cannot bleed
        into tensors packed from this view.  shared=True: Pod objects are
        the live ones — only safe while the caller holds `lock()` for as
        long as it reads mutable pod fields (the session's pack does)."""
        with self._lock:
            pod_map = (
                None if shared
                else {uid: copy.copy(pod) for uid, pod in self._pods.items()}
            )
            jobs = {
                name: job.clone(pod_map)
                for name, job in self._jobs.items()
                if job.queue and job.queue in self._queues
            }
            nodes = {
                name: info.clone(pod_map)
                for name, info in self._nodes.items()
                if info.node.is_ready
            }
            queues = {
                name: QueueInfo(queue=q.queue) for name, q in self._queues.items()
            }
            return HostSnapshot(
                spec=self.spec,
                jobs=jobs,
                nodes=nodes,
                queues=queues,
                claims=dict(self._claims),
                storage_classes=dict(self._storage_classes),
                namespaces=dict(self._namespaces),
                pdbs=dict(self._pdbs),
            )

    # -- commit funnel (≙ cache.go · Bind) -------------------------------
    def bind(self, pod_uid: str, node_name: str) -> bool:
        """Dispatch a bind through the Binder, synchronously.  The pod is
        marked BINDING on its node first; on failure it is reset to
        PENDING and queued for resync (≙ errTasks workqueue)."""
        with self._lock:
            pod = self._pods.get(pod_uid)
            if pod is None:
                return False  # deleted between decision and commit
            if node_name not in self._nodes:
                self._resync.append(pod_uid)
                self.record_event(
                    "Pod", pod.name, "BindFailed",
                    f"bind-failed: unknown node {node_name}",
                )
                return False
            self.update_pod_status(pod_uid, TaskStatus.BINDING, node=node_name)
        try:
            self.binder.bind(pod, node_name)
        except Exception as exc:  # noqa: BLE001 — any bind failure is retryable
            with self._lock:
                self.update_pod_status(pod_uid, TaskStatus.PENDING)
                self._resync.append(pod_uid)
            self.record_event(
                "Pod", pod.name, "BindFailed", f"bind-failed: {exc}"
            )
            return False
        with self._lock:
            self.update_pod_status(pod_uid, TaskStatus.BOUND)
        self.record_event("Pod", pod.name, "Bound", f"bound -> {node_name}")
        return True

    def evict(self, pod_uid: str, reason: str) -> bool:
        """Dispatch an eviction through the Evictor, synchronously.  The
        pod is marked RELEASING first (its resources count as releasing
        on its node until the backend deletes it); if the backend refuses,
        the pod returns to its previous status and an EvictFailed event is
        recorded, so a later cycle may choose it again."""
        with self._lock:
            pod = self._pods.get(pod_uid)
            if pod is None:
                return False  # deleted between decision and commit
            prev_status = pod.status
            self.update_pod_status(pod_uid, TaskStatus.RELEASING)
        try:
            self.evictor.evict(pod, reason)
        except Exception as exc:  # noqa: BLE001 — roll back, retry next cycle
            with self._lock:
                self.update_pod_status(pod_uid, prev_status)
            self.record_event("Pod", pod.name, "EvictFailed",
                              f"evict-failed: {exc}")
            return False
        self.record_event("Pod", pod.name, "Evicted", f"evicted: {reason}")
        return True

    def update_job_status(self, group: PodGroup) -> None:
        if self.status_updater is not None:
            self.status_updater.update_pod_group(group)

    def refresh_job_statuses(self, names=None) -> int:
        """Recompute PodGroup statuses for `names` (None = every live
        job) under the cache lock, then write back only the ones that
        changed (≙ job_updater.go).  Returns the number written."""
        with self._lock:
            targets = list(self._jobs) if names is None else [
                n for n in names if n in self._jobs
            ]
            groups = [
                self._jobs[n].refresh_status(self._jobs[n].queue in self._queues)
                for n in targets
            ]
        written = 0
        for group, changed in groups:
            if changed:
                self.update_job_status(group)
                written += 1
        return written

    def drain_resync(self) -> list[str]:
        """Pod uids whose binds failed since the last drain."""
        with self._lock:
            out, self._resync = self._resync, []
            return out
