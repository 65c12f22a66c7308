"""Model zoo: quality-indexed builders for every architecture.

Counterpart of ``cra5_tpu/models/zoo.py``: the same architecture names and
quality -> (N, M) tables. ``create_model`` builds a model on its device
(the card unless the caller asks for the CPU), ``init_model`` gives it the
seeded flax init, and ``load_model`` returns (model, codec); with
``pretrained=True`` the weights come from a checkpoint file (the JAX
package's ``.msgpack`` variables, read by ``train/checkpoints.py`` through
``convert.flax_layout``, or the port's own ``.pt``). Nothing is
downloaded. Every architecture of the JAX zoo builds; ``ssf2020``
(ScaleSpaceFlow, the video zoo) returns (model, state_dict, codec), as the
JAX package's returns (model, variables, codec).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .codec import make_codec
from .elic2022 import ELIC2022
from .google import (
    FactorizedPrior,
    FactorizedPriorReLU,
    JointAutoregressiveHierarchicalPriors,
    MeanScaleHyperprior,
    SampledYInBmshj2018,
    ScaleHyperprior,
)
from .inv2021 import InvCompress
from .stf2022 import SymmetricalTransFormer2022
from .tcm2023 import TCM2023
from .vaeformer import VAEformer, vaeformer_268
from .waseda import Cheng2020Anchor, Cheng2020Attention


model_architectures: Dict[str, Any] = {
    "bmshj2018-factorized": FactorizedPrior,
    "bmshj2018-factorized-relu": FactorizedPriorReLU,
    "bmshj2018-hyperprior": ScaleHyperprior,
    "mbt2018-mean": MeanScaleHyperprior,
    "mbt2018": JointAutoregressiveHierarchicalPriors,
    "cheng2020-anchor": Cheng2020Anchor,
    "cheng2020-attn": Cheng2020Attention,
    "elic2022": ELIC2022,
    "stf": SymmetricalTransFormer2022,
    "tcm2023": TCM2023,
    "invcompress": InvCompress,
    "sampled-y-bmshj2018": SampledYInBmshj2018,
}

# quality -> constructor args
_NM8_SPLIT6 = {q: (128, 192) if q <= 5 else (192, 320) for q in range(1, 9)}
_NM8_SPLIT5 = {q: (128, 192) if q <= 4 else (192, 320) for q in range(1, 9)}
_NM8_MBT = {q: (192, 192) if q <= 4 else (192, 320) for q in range(1, 9)}
_N6_CHENG = {q: (128,) if q <= 3 else (192,) for q in range(1, 7)}

cfgs: Dict[str, Dict[int, Tuple[int, ...]]] = {
    "bmshj2018-factorized": _NM8_SPLIT6,
    "bmshj2018-factorized-relu": _NM8_SPLIT6,
    "bmshj2018-hyperprior": _NM8_SPLIT6,
    "mbt2018-mean": _NM8_SPLIT5,
    "mbt2018": _NM8_MBT,
    "cheng2020-anchor": _N6_CHENG,
    "cheng2020-attn": _N6_CHENG,
    "elic2022": {q: (192, 320) for q in range(1, 7)},
    "stf": {q: (48,) for q in range(1, 7)},  # embed_dim
    "tcm2023": {q: (128, 320) for q in range(1, 7)},
    "invcompress": {q: (128,) if q <= 3 else (192,) for q in range(1, 7)},
    "sampled-y-bmshj2018": {q: (192, 320) for q in range(1, 7)},
    "vaeformer-pretrained": {268: (268,)},
}


def create_model(architecture: str, quality: int, in_channel: int = 3, device=None, **kwargs):
    """An (uninitialised) zoo model for a quality level, on ``device``."""
    if architecture == "vaeformer-pretrained":
        return VAEformer(vaeformer_268(), device=device)
    if architecture not in model_architectures:
        raise ValueError(f'Invalid architecture name "{architecture}"')
    if quality not in cfgs[architecture]:
        raise ValueError(f'Invalid quality value "{quality}"')
    args = cfgs[architecture][quality]
    cls = model_architectures[architecture]
    if architecture.startswith("cheng2020") or architecture == "invcompress":
        return cls(N=args[0], M=args[0], in_channel=in_channel, device=device, **kwargs)
    if architecture == "stf":
        return cls(embed_dim=args[0], in_channel=in_channel, device=device, **kwargs)
    return cls(N=args[0], M=args[1], in_channel=in_channel, device=device, **kwargs)


def init_model(model, seed: int = 0):
    """The model with the seeded flax init (a VAEformer's or a zoo
    model's ``reset_parameters``); a PyTorch module needs no dummy batch."""
    return model.reset_parameters(seed)


def _load_checkpoint(model, path: str) -> None:
    """Copy a checkpoint file's params (``train/checkpoints.load_variables``)
    into ``model``."""
    from ..train.checkpoints import load_variables

    params = load_variables(path, model=model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])


def load_model(
    architecture: str,
    quality: int,
    *,
    in_channel: int = 3,
    pretrained: bool = False,
    checkpoint_path: Optional[str] = None,
    coder: str = "v2",
    seed: int = 0,
    device=None,
):
    """(model, codec). With ``pretrained=True`` the weights come from
    ``checkpoint_path`` or ``$CRA5_TPU_CKPT_DIR/<architecture>-<quality>.msgpack``
    (a ``.msgpack`` file is the JAX package's variables); else from the
    seeded init."""
    model = create_model(architecture, quality, in_channel=in_channel, device=device)
    if pretrained:
        _load_checkpoint(model, checkpoint_path or os.path.join(
            os.environ.get("CRA5_TPU_CKPT_DIR", "checkpoints"), f"{architecture}-{quality}.msgpack"))
    else:
        init_model(model, seed)
    return model, make_codec(model, coder=coder)


# thin named builders mirroring the reference's functions
def _named(arch: str) -> Callable:
    def build(quality: int, **kwargs):
        return load_model(arch, quality, **kwargs)

    build.__name__ = arch.replace("-", "_")
    return build


bmshj2018_factorized = _named("bmshj2018-factorized")
bmshj2018_factorized_relu = _named("bmshj2018-factorized-relu")
bmshj2018_hyperprior = _named("bmshj2018-hyperprior")
mbt2018_mean = _named("mbt2018-mean")
mbt2018 = _named("mbt2018")
cheng2020_anchor = _named("cheng2020-anchor")
cheng2020_attn = _named("cheng2020-attn")


def ssf2020(
    quality: int,
    metric: str = "mse",
    *,
    pretrained: bool = False,
    checkpoint_path: Optional[str] = None,
    seed: int = 0,
    device=None,
    **kwargs,
):
    """The ScaleSpaceFlow video-zoo builder: (model, its state_dict, codec),
    as the JAX package's returns (model, variables, codec).

    Quality 1-9 and metric mse / ms-ssim name a checkpoint; the
    architecture is the same at every quality (``kwargs`` reach
    ``ScaleSpaceFlow``). ``pretrained=True`` loads ``checkpoint_path`` or
    ``$CRA5_TPU_CKPT_DIR/ssf2020-<metric>-<quality>.msgpack`` (the JAX
    package's variables, or the port's ``.pt``); else the seeded flax init,
    which needs no dummy clip (JAX's ``input_shape``)."""
    if metric not in ("mse", "ms-ssim"):
        raise ValueError(f'Invalid metric "{metric}"')
    if quality < 1 or quality > 9:
        raise ValueError(f'Invalid quality "{quality}", should be between (1, 9)')
    from .video import ScaleSpaceFlow, ScaleSpaceFlowCodec

    model = ScaleSpaceFlow(device=device, **kwargs)
    if pretrained:
        _load_checkpoint(model, checkpoint_path or os.path.join(
            os.environ.get("CRA5_TPU_CKPT_DIR", "checkpoints"), f"ssf2020-{metric}-{quality}.msgpack"))
    else:
        init_model(model, seed)
    return model, model.state_dict(), ScaleSpaceFlowCodec(model)
