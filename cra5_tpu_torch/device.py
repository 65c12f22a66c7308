"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``cuda``, and a CUDA device without a card raises instead of falling
back. On CUDA the float32 matmul and cuDNN TF32 modes are switched off, so
a float32 model computes in full float32 as the JAX package's reference
path does (the 1x1 convs and patch embeds are matmuls, so no cuDNN
algorithm choice enters the path either).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
