"""Device selection for the package's entry points.

The entry points run on the card unless the caller asks for the CPU:
`device` defaults to "cuda", and with no usable CUDA device they raise
instead of moving to the CPU.  TF32 is switched off for matrix products
and convolutions and asserted off — decision-bearing math is float32.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    return dev
