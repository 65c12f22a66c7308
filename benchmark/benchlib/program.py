"""The program under test, built from the benchmark's configuration and
weights: the one place that turns them into the port's objects."""

from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(c: dict, **extra):
    from cra5_tpu_torch.models.vaeformer import VAEformerConfig

    kw = {k: (tuple(tuple(w) for w in v) if k == "window_sizes" else
              tuple(v) if isinstance(v, list) else v) for k, v in c.items()}
    return VAEformerConfig(**kw, **extra)


@torch.no_grad()
def build(c: dict, P: Dict[str, torch.Tensor], dtype: str, device, flash: str = "auto", **extra):
    """The port's VAEformer holding ``P``; raises if its parameters are not
    exactly the benchmark's names and shapes."""
    from cra5_tpu_torch.models.vaeformer import VAEformer
    from cra5_tpu_torch.nn.blocks import set_flash_attention

    set_flash_attention(flash)
    model = VAEformer(model_config(c, **extra), dtype=DTYPES[dtype], device=device)
    own = dict(model.named_parameters())
    if {k: tuple(v.shape) for k, v in own.items()} != {k: tuple(v.shape) for k, v in P.items()}:
        raise RuntimeError("the program's parameters differ from the configuration's")
    for k, p in own.items():
        p.copy_(P[k])
    return model
