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

Every mutator records what it changed in each registered `PackDirty`
journal, which the incremental packer (cache/incremental.py) drains to
patch the previous pack instead of rebuilding it.

This is the simulator-path subset of `kube_batch_tpu.cache.cache`: the
health ledger, commit pipeline and relist are not part of the port yet.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import threading
import weakref

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


class CacheResyncing(RuntimeError):
    """Raised by snapshot() and the incremental pack while the mirror is
    quiesced (between begin_resync and end_resync): scheduling against a
    half-replayed mirror would see phantom idle capacity, so the cycle
    is skipped instead."""


class PackDirty:
    """Per-consumer change journal between two tensor packs.

    The incremental packer (cache/incremental.py) registers one of these
    via `SchedulerCache.register_dirty_listener`; every cache mutation
    records the minimal fact the packer needs to patch the previous
    pack's arrays instead of rebuilding them.  `full` is the safety
    hatch: any mutation whose tensor effect is not row-local (object-set
    or vocabulary changes) forces the next pack to rebuild from scratch.
    All mutations happen under the cache lock; the packer drains the
    journal under the same lock.
    """

    __slots__ = ("full", "full_reason", "status_pods", "nodes",
                 "added_pods", "deleted_pods", "added_jobs",
                 "version", "groups", "reset_groups", "__weakref__")

    def __init__(self) -> None:
        self.clear()
        self.full = True               # nothing packed yet
        self.full_reason = "initial"

    def clear(self) -> None:
        self.full = False
        self.full_reason = ""
        self.status_pods: set[str] = set()     # pod uids
        self.nodes: set[str] = set()           # node names
        self.added_pods: list[str] = []        # pod uids, arrival order
        self.deleted_pods: list[str] = []      # pod uids
        self.added_jobs: list[str] = []        # group names (new or updated)
        # `version` bumps on EVERY pod/job mark (the sets above absorb a
        # repeated mutation of one uid, the counter does not) and
        # `groups` collects the affected PodGroup names: together they let
        # the idle-skipping scheduler refresh statuses exactly when
        # something changed, without draining the journal.
        self.version: int = 0
        self.groups: set[str] = set()
        # Groups whose task MEMBERSHIP changed (pod add/delete): the full
        # rebuild re-derives exactly these jobs' cached column blocks.
        self.reset_groups: set[str] = set()

    def mark_full(self, reason: str) -> None:
        if not self.full:
            self.full = True
            self.full_reason = reason


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
    # Monotone counter of node OBJECT changes (set membership, labels,
    # taints, readiness); the vectorized packer reuses its cached node
    # geometry while it is unchanged.  -1 disables the reuse.
    node_version: int = -1


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
        # Change journals of incremental packers, weakly held so a dead
        # packer's journal unregisters itself.
        self._dirty_listeners: weakref.WeakSet[PackDirty] = weakref.WeakSet()
        # Pods per TaskStatus, for the O(1) idle test (has_pending_work).
        self._status_counts: collections.Counter = collections.Counter()
        # > 0 between begin_resync() and end_resync(): quiesced.
        self._resync_depth = 0
        # Node-geometry version (HostSnapshot.node_version).
        self._node_version = 0

        self.add_queue(Queue(name=default_queue, weight=1.0))

    # -- incremental-pack change journal --------------------------------
    def register_dirty_listener(self) -> PackDirty:
        """Create and register a change journal; its owner (an
        IncrementalPacker) drains it under the cache lock at pack time."""
        with self._lock:
            d = PackDirty()
            self._dirty_listeners.add(d)
            return d

    def _mark_full(self, reason: str) -> None:
        for d in self._dirty_listeners:
            d.mark_full(reason)

    def _mark_status(self, uid: str, group: str | None = None) -> None:
        for d in self._dirty_listeners:
            d.status_pods.add(uid)
            d.version += 1
            if group:
                d.groups.add(group)

    def _mark_node(self, name: str | None) -> None:
        if name is None:
            return
        for d in self._dirty_listeners:
            d.nodes.add(name)

    def _mark_pod_added(self, uid: str, group: str | None = None) -> None:
        for d in self._dirty_listeners:
            d.added_pods.append(uid)
            d.version += 1
            if group:
                d.groups.add(group)
                d.reset_groups.add(group)

    def _mark_pod_deleted(self, uid: str, group: str | None = None) -> None:
        for d in self._dirty_listeners:
            d.deleted_pods.append(uid)
            d.version += 1
            if group:
                d.groups.add(group)
                d.reset_groups.add(group)

    def _mark_job_added(self, name: str) -> None:
        for d in self._dirty_listeners:
            d.added_jobs.append(name)
            d.version += 1
            d.groups.add(name)

    def _mark_dynamic_pdbs(self, pod: Pod) -> None:
        """Pod churn that changes a DYNAMIC budget's membership moves its
        effective floor (resolved against the matched count at pack
        time): force a repack.  Empty-selector budgets are never packed,
        so they never force one."""
        if pod.labels and any(
            p.dynamic and p.selector and p.matches(pod)
            for p in self._pdbs.values()
        ):
            self._mark_full("pdb-membership-changed")

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
            self._mark_dynamic_pdbs(pod)
            self._status_counts[pod.status] += 1
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
            self._mark_pod_added(pod.uid, pod.group)
            self._mark_node(pod.node)

    def delete_pod(self, pod_uid: str) -> None:
        with self._lock:
            pod = self._pods.pop(pod_uid, None)
            if pod is None:
                return
            self._mark_dynamic_pdbs(pod)
            self._status_counts[pod.status] -= 1
            if pod.group is not None and pod.group in self._jobs:
                self._jobs[pod.group].remove_task(pod)
            if pod.node is not None and pod.node in self._nodes:
                self._nodes[pod.node].remove_task(pod)
            self._mark_pod_deleted(pod.uid, pod.group)
            self._mark_node(pod.node)

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
            self._mark_node(pod.node)
            self._status_counts[pod.status] -= 1
            self._status_counts[status] += 1
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
            self._mark_status(pod_uid, pod.group)
            self._mark_node(pod.node)

    def add_node(self, node: Node) -> None:
        with self._lock:
            if node.name in self._nodes:
                raise ValueError(f"node {node.name} already cached")
            self._nodes[node.name] = NodeInfo(spec=self.spec, node=node)
            self._node_version += 1
            self._mark_full("node-added")

    def update_node(self, node: Node) -> None:
        """Replace a node's API object; idle = allocatable − used is
        re-derived.  Unknown node → add.  Label, taint or readiness
        changes shift vocabularies or the packed node set and force a
        rebuild; a cordon, pressure or allocatable change is row-local."""
        with self._lock:
            info = self._nodes.get(node.name)
            if info is None:
                self._nodes[node.name] = NodeInfo(spec=self.spec, node=node)
                self._node_version += 1
                self._mark_full("node-added")
                return
            old = info.node
            info.node = node
            info.allocatable = self.spec.vec(node.allocatable)
            info.idle = info.allocatable - info.used
            if (
                dict(old.labels) != dict(node.labels)
                or set(old.taints) != set(node.taints)
                or old.is_ready != node.is_ready
            ):
                self._node_version += 1
                self._mark_full("node-object-changed")
            else:
                self._mark_node(node.name)

    def delete_node(self, name: str) -> None:
        with self._lock:
            info = self._nodes.pop(name, None)
            if info is not None:
                self._node_version += 1
                # Residents lose their placement; they'll be rescheduled.
                for pod in info.tasks.values():
                    pod.node = None
                    self._status_counts[pod.status] -= 1
                    self._status_counts[TaskStatus.PENDING] += 1
                    pod.status = TaskStatus.PENDING
                self._mark_full("node-deleted")

    def add_pod_group(self, group: PodGroup) -> None:
        with self._lock:
            queue = group.queue or self.default_queue
            existing = self._jobs.get(group.name)
            if existing is not None:
                if existing.queue != queue:
                    self._mark_full("job-queue-changed")
                else:
                    self._mark_job_added(group.name)
                existing.pod_group = group
                existing.queue = queue
            else:
                self._jobs[group.name] = JobInfo(
                    spec=self.spec, pod_group=group, queue=queue
                )
                self._mark_job_added(group.name)

    def delete_pod_group(self, name: str) -> None:
        with self._lock:
            if self._jobs.pop(name, None) is not None:
                self._mark_full("job-deleted")

    def add_queue(self, queue: Queue) -> None:
        with self._lock:
            old = self._queues.get(queue.name)
            self._queues[queue.name] = QueueInfo(queue=queue)
            if old is None or old.weight != queue.weight:
                self._mark_full("queue-changed")

    def add_claim(self, claim: Claim) -> None:
        with self._lock:
            self._claims[claim.name] = claim
            self._mark_full("claim-changed")

    def add_storage_class(self, sc: StorageClass) -> None:
        with self._lock:
            self._storage_classes[sc.name] = sc
            self._mark_full("storage-class-changed")

    def add_namespace(self, ns: Namespace) -> None:
        with self._lock:
            self._namespaces[ns.name] = ns
            self._mark_full("namespace-changed")

    def add_pdb(self, pdb: PodDisruptionBudget) -> None:
        with self._lock:
            self._pdbs[pdb.name] = pdb
            self._mark_full("pdb-changed")

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

    # -- quiescence -------------------------------------------------------
    def begin_resync(self) -> None:
        """Take one quiesce hold: snapshot() and the incremental pack
        raise CacheResyncing until the matching end_resync()."""
        with self._lock:
            self._resync_depth += 1

    def end_resync(self) -> None:
        with self._lock:
            self._resync_depth = max(0, self._resync_depth - 1)

    def is_resyncing(self) -> bool:
        with self._lock:
            return self._resync_depth > 0

    def has_pending_work(self) -> bool:
        """True when a cycle could act: a pod is Pending or Releasing, or
        a failed bind awaits resync.  O(1) via the status census."""
        with self._lock:
            return bool(
                self._status_counts[TaskStatus.PENDING]
                or self._status_counts[TaskStatus.RELEASING]
                or self._resync
            )

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
            if self._resync_depth > 0:
                raise CacheResyncing(
                    "cache mirror is quiesced; skip this cycle"
                )
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
                node_version=self._node_version,
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
