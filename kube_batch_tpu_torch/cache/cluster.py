"""Framework-native cluster API objects.

Reference counterparts: core/v1 Pod + Node as consumed by kube-batch,
and the CRDs in pkg/apis/scheduling/v1alpha1/types.go (PodGroup, Queue).
These are deliberately *framework-native* — the minimal fields the
scheduler actually consumes — not a Kubernetes API port.  A real-cluster
adapter translates its API objects into these.

Simplifications (documented contract):
* labels are matched as exact ``key=value`` strings (the reference's
  MatchNodeSelector equality case; set-based operators can be lowered to
  multiple label terms by the adapter);
* a taint is a single string ``key=value:effect`` and a toleration
  matches a taint iff the strings are equal (the reference's
  tolerates-with-equal-matching case).
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
from typing import Mapping

from kube_batch_tpu_torch.api.types import PodGroupPhase, TaskStatus

_uid_counter = itertools.count()

# Resolved value of the system-cluster-critical / system-node-critical
# priority classes (the k8s constant the conformance plugin keys on).
SYSTEM_CRITICAL_PRIORITY = 2_000_000_000


def _new_uid(prefix: str) -> str:
    return f"{prefix}-{next(_uid_counter):08d}"


@dataclasses.dataclass
class Pod:
    """A unit of work to place (≙ one core/v1 Pod).

    `request` maps resource-dimension names (see api.ResourceSpec) to
    quantities: cpu in millicores, memory in bytes, others in counts.
    """

    name: str
    group: str | None = None           # PodGroup name; None → unmanaged ("Others")
    request: Mapping[str, float] = dataclasses.field(default_factory=dict)
    priority: int = 0
    namespace: str = "default"
    selector: Mapping[str, str] = dataclasses.field(default_factory=dict)
    # -- inter-pod affinity ---------------------------------------------
    # `labels` are this pod's own matchable labels; `affinity` terms
    # require ≥1 resident pod carrying the label in the target topology
    # domain; `anti_affinity` terms forbid any such resident (and
    # symmetrically, a resident's anti term blocks newcomers matching
    # it); `pod_prefs` are soft co-location terms with weights (the
    # InterPodAffinityPriority analog; node-level AND topology-scoped
    # terms — "zone:app=web" scores the whole zone's residents).  Term
    # syntax for affinity/anti_affinity/pod_prefs:
    #   "key=value"            topologyKey = the node itself (hostname)
    #   "zone:key=value"       topologyKey = node label "zone" — the
    #                          domain is all nodes sharing that label's
    #                          value (≙ the vendored predicate's
    #                          arbitrary topologyKey support,
    #                          plugins/predicates/predicates.go)
    labels: Mapping[str, str] = dataclasses.field(default_factory=dict)
    affinity: frozenset[str] = frozenset()
    anti_affinity: frozenset[str] = frozenset()
    pod_prefs: Mapping[str, float] = dataclasses.field(default_factory=dict)
    # Preferred (soft) node labels with weights — the analog of
    # preferredDuringScheduling node-affinity terms consumed by the
    # nodeorder plugin's NodeAffinityPriority score.  Keys are full
    # "key=value" label strings (validated in __post_init__), matching
    # how node labels are interned.
    preferences: Mapping[str, float] = dataclasses.field(default_factory=dict)
    tolerations: frozenset[str] = frozenset()
    ports: frozenset[int] = frozenset()
    claims: frozenset[str] = frozenset()  # PVC names this pod mounts
    status: TaskStatus = TaskStatus.PENDING
    node: str | None = None            # assigned node name, if any
    uid: str = dataclasses.field(default_factory=lambda: _new_uid("pod"))
    creation: int = dataclasses.field(default_factory=lambda: next(_uid_counter))
    # Memoized (spec.names, vector) for the request (filled on first
    # use; requests are immutable once submitted).  Shared by reference
    # through the snapshot's __copy__ fast path, so the per-cycle
    # packer never re-walks every pod's request dict.
    req_vec: object = dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self) -> None:
        bad = [k for k in self.preferences if "=" not in k]
        if bad:
            raise ValueError(
                f"pod {self.name}: preference keys must be 'key=value' label "
                f"strings (got {bad!r}); selector-style bare keys never match"
            )

    def respawn(self) -> "Pod":
        """A fresh Pending pod from this pod's template — what a workload
        controller creates after its pod is deleted.  Copies every spec
        field; only identity and runtime state are reset."""
        new = copy.copy(self)
        new.uid = _new_uid("pod")
        new.creation = next(_uid_counter)
        new.status = TaskStatus.PENDING
        new.node = None
        return new

    def __copy__(self) -> "Pod":
        """Fast shallow copy: the snapshot path copies every pod every
        cycle (50k/cycle at config-5 scale), and the default dataclass
        copy machinery measurably dominates that path."""
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        return new

    @property
    def critical(self) -> bool:
        """Cluster-critical pod the conformance plugin refuses to evict
        (≙ plugins/conformance/conformance.go: kube-system namespace or
        system-cluster-critical / system-node-critical priority class)."""
        return (
            self.namespace == "kube-system"
            or self.priority >= SYSTEM_CRITICAL_PRIORITY
        )


@dataclasses.dataclass
class Node:
    """A schedulable machine (≙ core/v1 Node as seen by the scheduler).

    The pressure booleans mirror the node conditions the reference's
    optional predicates check (plugins/predicates/predicates.go ·
    CheckNodeMemoryPressure / DiskPressure / PIDPressure, toggled via
    `predicate.*PressureEnable` Arguments) — separate bits, NOT folded
    into `ready`, so a conf written for the reference means the same
    thing here.
    """

    name: str
    allocatable: Mapping[str, float] = dataclasses.field(default_factory=dict)
    labels: Mapping[str, str] = dataclasses.field(default_factory=dict)
    taints: frozenset[str] = frozenset()   # "key=value:effect" strings
    ready: bool = True
    memory_pressure: bool = False
    disk_pressure: bool = False
    pid_pressure: bool = False
    # ≙ core/v1 Node spec.unschedulable (kubectl cordon): the node
    # keeps its residents but admits no new placements.  Folded into
    # the packed node_ready bit alongside the health ledger's
    # quarantine mask (cache/packer.py), NOT into `ready` — a
    # cordoned node is healthy and must stay in the snapshot so its
    # accounting holds.
    unschedulable: bool = False
    # ≙ node.status.conditions as a type → status map ({"Ready":
    # False, "MemoryPressure": True, ...}).  The pressure booleans
    # above remain the fast-path mirror the packer consumes; this map
    # carries the full condition set so dialects that speak
    # conditions round-trip them (and `is_ready` folds an explicit
    # Ready=False in even when the bare `ready` bool was left True).
    conditions: Mapping[str, bool] = dataclasses.field(default_factory=dict)
    uid: str = dataclasses.field(default_factory=lambda: _new_uid("node"))

    @property
    def is_ready(self) -> bool:
        """Effective readiness: the bare `ready` bool AND any explicit
        Ready condition.  The snapshot's node filter consumes this, so
        a NotReady condition makes the node unschedulable even before
        the health ledger quarantines it."""
        return self.ready and bool(self.conditions.get("Ready", True))

    def schedulable(self, cordoned: frozenset = frozenset()) -> bool:
        """May NEW placements target this node — ready, not cordoned
        (neither by spec.unschedulable nor by the health ledger's
        `cordoned` set)?  The ONE definition of the packed node_ready
        bit: the full pack, the incremental row patch, its verify
        check, and the drain's target filter all call this — a fourth
        mask term added here reaches every consumer at once."""
        return (
            self.is_ready
            and not self.unschedulable
            and self.name not in cordoned
        )


@dataclasses.dataclass
class PodGroup:
    """Gang unit (≙ v1alpha1 PodGroup CRD).

    `min_member` is the all-or-nothing threshold: no member is bound
    until at least `min_member` members hold feasible placements.
    """

    name: str
    queue: str = ""                    # empty → scheduler default queue
    min_member: int = 1
    priority: int = 0                  # ≙ PriorityClassName resolved value
    # -- status subresource (≙ v1alpha1 PodGroupStatus) -----------------
    phase: PodGroupPhase = PodGroupPhase.PENDING
    running: int = 0
    succeeded: int = 0
    failed: int = 0
    conditions: list[str] = dataclasses.field(default_factory=list)
    uid: str = dataclasses.field(default_factory=lambda: _new_uid("pg"))
    creation: int = dataclasses.field(default_factory=lambda: next(_uid_counter))


@dataclasses.dataclass
class Queue:
    """Weighted fair-share queue (≙ v1alpha1 Queue CRD).

    `cell` partitions the fleet for multi-cell scale-out
    (doc/design/multi-cell.md): a queue's PodGroups — and their pods
    — belong to its cell, are watched only by that cell's scheduler,
    and are writable only under that cell's epoch lease.  "" = shared
    (the classic single-fleet deploy)."""

    name: str
    weight: float = 1.0
    cell: str = ""
    uid: str = dataclasses.field(default_factory=lambda: _new_uid("queue"))


@dataclasses.dataclass
class Namespace:
    """A namespace with a fair-share weight (≙ api/namespace_info.go:
    the reference collects a per-namespace weight and serves namespaces
    within a queue by weighted fairness via NamespaceOrderFn).
    Namespaces never declared default to weight 1."""

    name: str
    weight: float = 1.0
    uid: str = dataclasses.field(default_factory=lambda: _new_uid("ns"))


@dataclasses.dataclass
class PodDisruptionBudget:
    """Eviction floor for plain pods (≙ JobInfo.PDB in api/job_info.go:
    the reference carries the PDB alongside the job and victim filtering
    honors it).  Pods whose labels match `selector` are members;
    eviction is vetoed when healthy members would drop below the floor.

    Floor forms (exactly one is meaningful, k8s's intstr fields):
    * `min_available` — absolute floor (the static form);
    * `min_available_pct` — percentage of the CURRENT matched count,
      rounded UP (k8s rounds minAvailable percentages up);
    * `max_unavailable` / `max_unavailable_pct` — allowed disruptions,
      absolute or percentage of matched (percentage rounded DOWN —
      both roundings chosen protectively: never allow more disruption
      than the other rounding would).
    The dynamic forms resolve to an absolute floor at PACK time from
    the live matched count (`effective_floor`); any pod churn touching
    a dynamic budget's membership forces a repack (cache.add_pod /
    delete_pod mark full), so the floor can never go stale between
    packs."""

    name: str
    min_available: int = 0
    min_available_pct: float | None = None   # 0-100
    max_unavailable: int | None = None
    max_unavailable_pct: float | None = None  # 0-100
    selector: Mapping[str, str] = dataclasses.field(default_factory=dict)
    uid: str = dataclasses.field(default_factory=lambda: _new_uid("pdb"))

    def matches(self, pod: "Pod") -> bool:
        return all(pod.labels.get(k) == v for k, v in self.selector.items())

    @property
    def dynamic(self) -> bool:
        """Floor depends on the live matched count."""
        return (
            self.min_available_pct is not None
            or self.max_unavailable is not None
            or self.max_unavailable_pct is not None
        )

    def effective_floor(self, matched: int) -> int:
        """Absolute minAvailable given the current matched-pod count."""
        import math

        if self.max_unavailable is not None:
            return max(matched - self.max_unavailable, 0)
        if self.max_unavailable_pct is not None:
            allowed = math.floor(self.max_unavailable_pct / 100.0 * matched)
            return max(matched - allowed, 0)
        if self.min_available_pct is not None:
            return math.ceil(self.min_available_pct / 100.0 * matched)
        return self.min_available


@dataclasses.dataclass
class StorageClass:
    """Provisioner constraints for unbound claims (≙ storage.k8s.io/v1
    StorageClass + the PV node-affinity its volumes will carry).

    `allowed_node_labels`: "key=value" strings; an unbound claim of this
    class can only follow its pod to a node carrying AT LEAST ONE of
    them (the OR-of-terms shape of PV nodeAffinity).  Empty = any node
    (network storage).
    """

    name: str
    allowed_node_labels: frozenset[str] = frozenset()
    uid: str = dataclasses.field(default_factory=lambda: _new_uid("sc"))


@dataclasses.dataclass
class Claim:
    """A persistent volume claim pods may mount (≙ core/v1 PVC as the
    scheduler sees it: either bound to a node-affine PV already, or
    unbound with a StorageClass whose provisioner constrains placement).
    """

    name: str
    storage_class: str = ""
    bound_node: str | None = None  # bound local PV pins pods to this node
    uid: str = dataclasses.field(default_factory=lambda: _new_uid("pvc"))
