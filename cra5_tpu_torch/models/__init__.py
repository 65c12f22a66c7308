from .baseline import VariationCNNPrior, vaeformer_former_baseline, vaeformer_former_baseline_tiny
from .codec import AutoregressiveCodec, ImageCodec, make_codec
from .elic2022 import ELIC2022, ElicCodec
from .google import (
    FactorizedPrior,
    FactorizedPriorReLU,
    JointAutoregressiveHierarchicalPriors,
    MeanScaleHyperprior,
    SampledYInBmshj2018,
    ScaleHyperprior,
)
from .inv2021 import InvCompress
from .stf2022 import CharmCodec, SymmetricalTransFormer2022
from .tcm2023 import TCM2023
from .vaeformer import (
    VAEformer,
    VAEformerCodec,
    VAEformerConfig,
    vaeformer_159,
    vaeformer_268,
    vaeformer_tiny,
)
from .video import ScaleSpaceFlow, ScaleSpaceFlowCodec
from .vit_vae import VITAutoencoderKL
from .waseda import Cheng2020Anchor, Cheng2020Attention
from .zoo import cfgs, create_model, init_model, load_model, model_architectures, ssf2020

__all__ = [
    "VAEformer",
    "VAEformerConfig",
    "vaeformer_268",
    "vaeformer_159",
    "vaeformer_tiny",
    "VAEformerCodec",
    "VariationCNNPrior",
    "vaeformer_former_baseline",
    "vaeformer_former_baseline_tiny",
    "VITAutoencoderKL",
    "FactorizedPrior",
    "FactorizedPriorReLU",
    "ScaleHyperprior",
    "MeanScaleHyperprior",
    "JointAutoregressiveHierarchicalPriors",
    "SampledYInBmshj2018",
    "Cheng2020Anchor",
    "Cheng2020Attention",
    "ELIC2022",
    "SymmetricalTransFormer2022",
    "TCM2023",
    "InvCompress",
    "ScaleSpaceFlow",
    "ScaleSpaceFlowCodec",
    "ImageCodec",
    "AutoregressiveCodec",
    "ElicCodec",
    "CharmCodec",
    "make_codec",
    "create_model",
    "init_model",
    "load_model",
    "model_architectures",
    "cfgs",
    "ssf2020",
]
