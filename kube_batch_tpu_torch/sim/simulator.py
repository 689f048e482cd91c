"""In-process cluster simulator implementing the backend seam.

The simulator plays the roles that sit across the API boundary from the
reference scheduler: kubelet (starting bound pods), the API server
(deleting evicted pods) and workload controllers (recreating deleted
pods).  Time is discrete: effects of binds and evictions land at the next
`tick()`, which creates the same in-flight windows (BINDING, RELEASING)
the reference sees from asynchronous cluster round-trips — exercising
FutureIdle accounting and pipelined placements.
"""

from __future__ import annotations

from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.cache.cache import SchedulerCache
from kube_batch_tpu_torch.cache.cluster import Node, Pod, PodGroup, Queue


class SimulatedCluster:
    """Implements the Binder, Evictor and StatusUpdater seams against a
    SchedulerCache."""

    def __init__(self) -> None:
        self.cache: SchedulerCache | None = None
        self.binds: list[tuple[str, str]] = []
        self.evictions: list[tuple[str, str]] = []
        self.status_updates: list[PodGroup] = []
        self._starting: list[str] = []   # pod uids bound, not yet running
        self._deleting: list[str] = []   # pod uids evicted, not yet recreated

    # -- backend seam ---------------------------------------------------
    def bind(self, pod: Pod, node_name: str) -> None:
        self.binds.append((pod.name, node_name))
        self._starting.append(pod.uid)

    def evict(self, pod: Pod, reason: str) -> None:
        self.evictions.append((pod.name, reason))
        self._deleting.append(pod.uid)

    def update_pod_group(self, group: PodGroup) -> None:
        self.status_updates.append(group)

    # -- world-building -------------------------------------------------
    def attach(self, cache: SchedulerCache) -> None:
        self.cache = cache

    def add_node(self, node: Node) -> None:
        self.cache.add_node(node)

    def delete_node(self, name: str) -> None:
        """Node vanishes (power loss / cordoned away): the cache
        unplaces its residents, which re-enter Pending for rescheduling
        — same semantics as ExternalCluster.delete_node, so a chaos
        trace replays identically against either backend."""
        self.cache.delete_node(name)

    def delete_pod(self, uid: str) -> None:
        """Remove a pod for good (controller reaping a finished
        workload) — unlike evict, nothing recreates it."""
        self.cache.delete_pod(uid)

    def delete_pod_group(self, name: str) -> None:
        self.cache.delete_pod_group(name)

    def submit(self, group: PodGroup, pods: list[Pod]) -> None:
        """One job arriving: PodGroup object plus its member pods."""
        self.cache.add_pod_group(group)
        for pod in pods:
            pod.group = group.name
            self.cache.add_pod(pod)

    def submit_to_group(self, group_name: str, pods: list[Pod]) -> None:
        """Additional member pods for an existing PodGroup (scale-up)."""
        for pod in pods:
            pod.group = group_name
            self.cache.add_pod(pod)

    def add_queue(self, queue: Queue) -> None:
        self.cache.add_queue(queue)

    def add_claim(self, claim) -> None:
        self.cache.add_claim(claim)

    def add_storage_class(self, sc) -> None:
        self.cache.add_storage_class(sc)

    def add_namespace(self, ns) -> None:
        self.cache.add_namespace(ns)

    def add_pdb(self, pdb) -> None:
        self.cache.add_pdb(pdb)

    # -- time -----------------------------------------------------------
    def tick(self) -> None:
        """Land in-flight effects: bound pods start running; evicted pods
        are deleted and recreated as fresh Pending pods (controller
        behavior), freeing their nodes."""
        starting, self._starting = self._starting, []
        for uid in starting:
            if uid in self.cache._pods:
                self.cache.update_pod_status(uid, TaskStatus.RUNNING)
        deleting, self._deleting = self._deleting, []
        for uid in deleting:
            pod = self.cache._pods.get(uid)
            if pod is None:
                continue
            template = pod.respawn()
            self.cache.delete_pod(uid)
            self.cache.add_pod(template)


def make_world(
    spec, default_queue: str = "default"
) -> tuple[SchedulerCache, SimulatedCluster]:
    """Wire a fresh cache to a fresh simulator."""
    sim = SimulatedCluster()
    cache = SchedulerCache(
        spec=spec,
        binder=sim,
        evictor=sim,
        status_updater=sim,
        default_queue=default_queue,
    )
    sim.attach(cache)
    return cache, sim
