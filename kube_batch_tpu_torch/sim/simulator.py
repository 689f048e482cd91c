"""In-process cluster simulator implementing the backend seam.

The simulator plays the roles that sit across the API boundary from the
reference scheduler: the API server taking binds and kubelet starting
bound pods.  Time is discrete: a bind lands at the next `tick()`, which
creates the same in-flight BINDING window the reference sees from
asynchronous cluster round-trips.  (Evictions and the controllers that
recreate evicted pods come with the preempt/reclaim slice.)
"""

from __future__ import annotations

from kube_batch_tpu_torch.api.types import TaskStatus
from kube_batch_tpu_torch.cache.cache import SchedulerCache
from kube_batch_tpu_torch.cache.cluster import Node, Pod, PodGroup, Queue


class SimulatedCluster:
    """Implements the Binder and StatusUpdater seams against a
    SchedulerCache (evictions come with the preempt/reclaim slice)."""

    def __init__(self) -> None:
        self.cache: SchedulerCache | None = None
        self.binds: list[tuple[str, str]] = []
        self.status_updates: list[PodGroup] = []
        self._starting: list[str] = []   # pod uids bound, not yet running

    # -- backend seam ---------------------------------------------------
    def bind(self, pod: Pod, node_name: str) -> None:
        self.binds.append((pod.name, node_name))
        self._starting.append(pod.uid)

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
        """Land in-flight effects: bound pods start running."""
        starting, self._starting = self._starting, []
        for uid in starting:
            if uid in self.cache._pods:
                self.cache.update_pod_status(uid, TaskStatus.RUNNING)


def make_world(
    spec, default_queue: str = "default"
) -> tuple[SchedulerCache, SimulatedCluster]:
    """Wire a fresh cache to a fresh simulator."""
    sim = SimulatedCluster()
    cache = SchedulerCache(
        spec=spec,
        binder=sim,
        status_updater=sim,
        default_queue=default_queue,
    )
    sim.attach(cache)
    return cache, sim
