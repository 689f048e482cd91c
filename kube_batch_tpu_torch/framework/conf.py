"""Scheduler policy configuration (`scheduler.conf`).

Reference counterpart: the YAML the reference re-reads every cycle
(pkg/scheduler/scheduler.go · loadSchedulerConf) with `actions:` (a
comma-separated string) and `tiers:` of plugins, plus per-plugin
Arguments and enable flags; default in pkg/scheduler/util.go ·
defaultSchedulerConf.

Same file format here:

    actions: "allocate, backfill"
    tiers:
    - plugins:
      - name: priority
      - name: gang
      - name: conformance
    - plugins:
      - name: drf
      - name: predicates
      - name: proportion
      - name: nodeorder
        arguments:
          nodeorder.leastrequested.weight: 1
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class PluginConf:
    """≙ conf.PluginOption: name + Arguments + per-extension enables."""

    name: str
    arguments: tuple[tuple[str, Any], ...] = ()
    enabled: tuple[tuple[str, bool], ...] = ()  # e.g. ("jobOrder", False)

    @property
    def args_dict(self) -> dict[str, Any]:
        return dict(self.arguments)

@dataclasses.dataclass(frozen=True)
class TierConf:
    plugins: tuple[PluginConf, ...]


@dataclasses.dataclass(frozen=True)
class SchedulerConf:
    actions: tuple[str, ...]
    tiers: tuple[TierConf, ...]
    #: Top-level arguments (action-scoped knobs, e.g.
    #: `allocate.max_rounds`) — the action analog of per-plugin
    #: Arguments.  The reference has no per-action config; this exists
    #: for the one knob the tensor design adds: the auction round cap,
    #: an operator latency valve (see actions/allocate.py).
    arguments: tuple[tuple[str, Any], ...] = ()

    @property
    def args_dict(self) -> dict[str, Any]:
        return dict(self.arguments)


def default_conf() -> SchedulerConf:
    """≙ pkg/scheduler/util.go · defaultSchedulerConf: actions
    "allocate, backfill"; tiers [priority, gang, conformance] /
    [drf, predicates, proportion, nodeorder].

    Only plugins/actions actually registered are included, so the default
    path always runs (the full reference set fills in as plugins land).
    """
    from kube_batch_tpu_torch.framework.plugin import (
        ACTION_REGISTRY,
        PLUGIN_REGISTRY,
        ensure_registered,
    )

    ensure_registered()

    tier1 = ("priority", "gang", "conformance", "pdb")
    tier2 = ("drf", "predicates", "proportion", "nodeorder")
    actions = tuple(
        a for a in ("allocate", "backfill") if a in ACTION_REGISTRY
    ) or ("allocate",)
    return SchedulerConf(
        actions=actions,
        tiers=(
            TierConf(
                plugins=tuple(PluginConf(n) for n in tier1 if n in PLUGIN_REGISTRY)
            ),
            TierConf(
                plugins=tuple(PluginConf(n) for n in tier2 if n in PLUGIN_REGISTRY)
            ),
        ),
    )


def parse_conf(text: str) -> SchedulerConf:
    """Parse the scheduler.conf YAML (hot-reload friendly: pure text in,
    immutable conf out)."""
    import yaml

    raw = yaml.safe_load(text)
    if not raw:
        return default_conf()
    raw_actions = raw.get("actions", "allocate, backfill")
    if isinstance(raw_actions, str):
        actions = tuple(a.strip() for a in raw_actions.split(",") if a.strip())
    else:  # YAML list form: actions: [allocate, backfill]
        actions = tuple(str(a).strip() for a in raw_actions)
    tiers: list[TierConf] = []
    for tier_raw in raw.get("tiers", []) or []:
        plugins: list[PluginConf] = []
        for p in tier_raw.get("plugins", []) or []:
            enables = tuple(
                (k[len("enable"):][0].lower() + k[len("enable") + 1:], bool(v))
                for k, v in p.items()
                if k.startswith("enable") and len(k) > len("enable")
            )
            plugins.append(
                PluginConf(
                    name=p["name"],
                    arguments=tuple(sorted((p.get("arguments") or {}).items())),
                    enabled=enables,
                )
            )
        tiers.append(TierConf(plugins=tuple(plugins)))
    arguments = tuple(sorted((raw.get("arguments") or {}).items()))
    if not tiers:
        return dataclasses.replace(
            default_conf(), actions=actions, arguments=arguments
        )
    return SchedulerConf(
        actions=actions, tiers=tuple(tiers), arguments=arguments
    )

