"""Resource vector math.

Reference counterpart: pkg/scheduler/api/resource_info.go · Resource
(MilliCPU / Memory / ScalarResources with Add/Sub/Multi/Less/LessEqual/
FitDelta/Diff/SetMaxResource/MinDimensionResource/Clone and min-resource
epsilons).

Instead of a struct with named fields plus a scalar map, a resource is a
**fixed-order float vector** over a `ResourceSpec`.  The resource algebra
is then identical on host (NumPy, float64) and device (torch, float32,
shape `[R]` / `[T, R]` / `[N, R]`), so every plugin/action computes on
resources with ordinary batched tensor ops instead of per-field branches.

Units: ``cpu`` is in millicores, ``memory`` in bytes, everything else in
plain counts — matching the reference's MilliCPU/Memory convention.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

#: Per-dimension slack under which a quantity is treated as negligible
#: (reference: resource_info.go · minMilliCPU=10, minMemory=10Mi,
#: minMilliScalarResources=10).
_DEFAULT_EPS = {
    "cpu": 10.0,            # 10 millicores
    "memory": float(10 << 20),  # 10 MiB
}
_FALLBACK_EPS = 0.1

#: Bookkeeping dimensions that every pod consumes by definition (a pod
#: always takes one pod slot).  Excluded from best-effort/emptiness
#: classification: the reference's notion of a best-effort pod is "empty
#: Resreq", and pod-count is not part of Resreq there.
COUNTING_RESOURCES = ("pods",)


@dataclasses.dataclass(frozen=True)
class ResourceSpec:
    """Ordered universe of resource dimensions for one cluster.

    The first two dimensions are conventionally ``cpu`` and ``memory``;
    further dimensions are scalar/extended resources (accelerators,
    ``pods`` slots, ...).  All tensors in a snapshot share one spec, so a
    dimension index means the same thing everywhere.
    """

    names: tuple[str, ...] = ("cpu", "memory", "pods", "accelerator")

    def __post_init__(self) -> None:
        if len(set(self.names)) != len(self.names):
            raise ValueError(f"duplicate resource names: {self.names}")

    @property
    def num(self) -> int:
        return len(self.names)

    def index(self, name: str) -> int:
        return self.names.index(name)

    def pod_vec(self, pod) -> np.ndarray:
        """Memoizing `vec` over a Pod's request (see cluster.Pod.req_vec):
        computed once per pod lifetime, shared by host accounting and the
        per-cycle snapshot packer.  The memo is keyed on this spec's
        dimension order, so a pod crossing into a differently-ordered
        spec recomputes instead of silently returning swapped dims."""
        memo = pod.req_vec
        if memo is not None and memo[0] is self.names:
            return memo[1]
        v = self.vec(pod.request)
        pod.req_vec = (self.names, v)
        return v

    @property
    def eps(self) -> np.ndarray:
        """Per-dimension negligibility thresholds, shape [R]."""
        return np.array(
            [_DEFAULT_EPS.get(n, _FALLBACK_EPS) for n in self.names], dtype=np.float64
        )

    @property
    def besteffort_eps(self) -> np.ndarray:
        """Like `eps`, but counting dimensions (pod slots) never disqualify
        a request from being best-effort.  Used by the backfill action's
        device-side candidate mask: best-effort ⇔ all(req < besteffort_eps).
        """
        return np.array(
            [
                np.inf if n in COUNTING_RESOURCES else _DEFAULT_EPS.get(n, _FALLBACK_EPS)
                for n in self.names
            ],
            dtype=np.float64,
        )

    def vec(self, quantities: Mapping[str, float] | None = None, **kw: float) -> np.ndarray:
        """Build a dense [R] vector from a name→quantity mapping.

        Unknown names raise — a spec mismatch is a config error, not a
        silent drop.
        """
        out = np.zeros(self.num, dtype=np.float64)
        merged = dict(quantities or {})
        merged.update(kw)
        for name, q in merged.items():
            out[self.index(name)] = float(q)
        return out
