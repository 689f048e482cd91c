"""Plugin/Action interfaces and registries.

Reference counterpart: pkg/scheduler/framework/interface.go (Plugin,
Action), plugins.go (RegisterPluginBuilder/GetPluginBuilder) and
actions/factory.go (action registration — BASELINE.json names it
framework.RegisterAction, which is where it lives here).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, Mapping

if TYPE_CHECKING:  # pragma: no cover
    from kube_batch_tpu_torch.framework.policy import TensorPolicy
    from kube_batch_tpu_torch.framework.session import Session


class Arguments(dict):
    """Per-plugin config map with typed getters
    (≙ framework/arguments.go · Arguments)."""

    def get_int(self, key: str, default: int) -> int:
        return int(self.get(key, default))

    def get_float(self, key: str, default: float) -> float:
        return float(self.get(key, default))

    def get_bool(self, key: str, default: bool) -> bool:
        v = self.get(key, default)
        if isinstance(v, str):
            return v.lower() in ("1", "true", "yes", "on")
        return bool(v)


class Plugin:
    """Base plugin.

    * `register(policy, tier)` — contribute pure tensor fns (order keys,
      predicate masks, score terms, veto masks) to the TensorPolicy.
      Called once per configuration load, NOT per cycle.
    * `on_session_open` / `on_session_close` — per-cycle host hooks
      (≙ OnSessionOpen/OnSessionClose); close is where user-facing
      reporting happens (gang's unschedulable events).
    """

    name: str = "plugin"

    def __init__(self, arguments: Mapping[str, Any] | None = None) -> None:
        self.args = Arguments(arguments or {})
        self._enabled: dict[str, bool] = {}

    def set_enabled(self, enabled: Mapping[str, bool]) -> None:
        """Install the conf's per-extension-point enable flags
        (≙ conf.PluginOption's enableJobOrder/... booleans)."""
        self._enabled = dict(enabled)

    def enabled_for(self, point: str) -> bool:
        """Should this plugin register at `point` (e.g. "jobOrder",
        "preemptable")?  Defaults to enabled, like the reference."""
        return self._enabled.get(point, True)

    def register(self, policy: "TensorPolicy", tier: int) -> None:  # noqa: ARG002
        return

    def on_session_open(self, ssn: "Session") -> None:  # noqa: ARG002
        return

    def on_session_close(self, ssn: "Session") -> None:  # noqa: ARG002
        return


class Action:
    """Base action (≙ framework/interface.go · Action).  An action
    contributes its solve through `solver_factory(policy) -> solve`, and
    the cycle (actions/fused.py) runs the solves in conf order."""

    name: str = "action"
    solver_factory = None


PluginBuilder = Callable[[Mapping[str, Any] | None], Plugin]
PLUGIN_REGISTRY: dict[str, PluginBuilder] = {}
ACTION_REGISTRY: dict[str, Callable[[], Action]] = {}


def register_plugin(cls: type[Plugin]) -> type[Plugin]:
    """≙ framework/plugins.go · RegisterPluginBuilder (decorator form)."""
    PLUGIN_REGISTRY[cls.name] = cls
    return cls


def register_action(cls: type[Action]) -> type[Action]:
    """≙ framework.RegisterAction."""
    ACTION_REGISTRY[cls.name] = cls
    return cls


def ensure_registered() -> None:
    """Import the built-in plugin/action packages for their registration
    side effect.

    Callers that consult the registries (default_conf, build_policy)
    call this first so registration cannot depend on the caller's
    import graph — a consumer arriving via framework-only imports would
    otherwise silently get an EMPTY plugin set and a ~4x smaller
    compiled program (the bug that made bench.py measure a plugin-free
    policy through round 4 while the daemon ran the full one)."""
    import kube_batch_tpu_torch.actions  # noqa: F401  registration side effect
    import kube_batch_tpu_torch.plugins  # noqa: F401  registration side effect


def get_plugin_builder(name: str) -> PluginBuilder:
    if name not in PLUGIN_REGISTRY:
        raise KeyError(f"unknown plugin {name!r}; known: {sorted(PLUGIN_REGISTRY)}")
    return PLUGIN_REGISTRY[name]


def get_action(name: str) -> Action:
    if name not in ACTION_REGISTRY:
        raise KeyError(f"unknown action {name!r}; known: {sorted(ACTION_REGISTRY)}")
    return ACTION_REGISTRY[name]()
