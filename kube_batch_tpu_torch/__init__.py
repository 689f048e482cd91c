"""kube_batch_tpu_torch: the batch/gang scheduler on PyTorch and CUDA.

The port of `kube_batch_tpu` (JAX) to one NVIDIA H100: same module names
and layout, plain functions over tensors on one explicit device, and the
hot [T, N] functions of the scheduling cycle as hand-written Hopper
kernels (`kernels/`).  It imports torch and numpy, never jax and nothing
of `kube_batch_tpu`.

    from kube_batch_tpu_torch.models.workloads import build_config
    from kube_batch_tpu_torch.scheduler import Scheduler

    cache, sim = build_config(3)
    ssn = Scheduler(cache).run_once()      # device="cuda" by default
"""

VERSION = "0.1.0"
