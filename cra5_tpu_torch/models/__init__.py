from .baseline import VariationCNNPrior, vaeformer_former_baseline, vaeformer_former_baseline_tiny
from .codec import AutoregressiveCodec, ImageCodec, make_codec
from .google import (
    FactorizedPrior,
    FactorizedPriorReLU,
    JointAutoregressiveHierarchicalPriors,
    MeanScaleHyperprior,
    SampledYInBmshj2018,
    ScaleHyperprior,
)
from .vaeformer import (
    VAEformer,
    VAEformerCodec,
    VAEformerConfig,
    vaeformer_159,
    vaeformer_268,
    vaeformer_tiny,
)
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
    "ImageCodec",
    "AutoregressiveCodec",
    "make_codec",
    "create_model",
    "init_model",
    "load_model",
    "model_architectures",
    "cfgs",
    "ssf2020",
]
