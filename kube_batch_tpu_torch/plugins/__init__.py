"""Built-in plugins (registration side effect on import)."""

from kube_batch_tpu_torch.plugins import (  # noqa: F401
    conformance,
    drf,
    gang,
    nodeorder,
    pdb,
    predicates,
    priority,
    proportion,
)

BUILTIN_PLUGINS = (
    "priority", "gang", "conformance", "pdb",
    "drf", "predicates", "proportion", "nodeorder",
)
