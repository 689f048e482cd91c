"""Session framework: plugin/action registries, conf, policy, session."""

from kube_batch_tpu_torch.framework.conf import (  # noqa: F401
    PluginConf,
    SchedulerConf,
    TierConf,
    default_conf,
    parse_conf,
)
from kube_batch_tpu_torch.framework.plugin import (  # noqa: F401
    Action,
    Plugin,
    register_action,
    register_plugin,
)
