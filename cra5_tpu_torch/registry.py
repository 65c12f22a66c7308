"""The port's registries, filled with what the port has.

Counterpart of ``cra5_tpu/registry.py``: one import wires every built-in
of the port into the registries of ``utils/registry.py`` so config-driven
builds (``tools/train.py``) work. Every name of the JAX package's
registries is registered: ``NOT_PORTED``, the names the port would lack,
is empty.
"""

from __future__ import annotations

from .utils.registry import CRITERIONS, DATASETS, MODELS, OPTIMIZERS, SCHEDULERS

# registered in the JAX package, not in the port: none
NOT_PORTED = {"models": (), "datasets": ()}


def _register_all() -> None:
    from . import data, models
    from .train import schedulers  # noqa: F401  (registers the schedules itself)
    from .train.loss import RateDistortionLoss
    from .train.optim import make_net_aux_optimizers

    for registry, entries in (
        (MODELS, {name: getattr(models, name) for name in (
            "VAEformer", "FactorizedPrior", "FactorizedPriorReLU", "ScaleHyperprior",
            "MeanScaleHyperprior", "JointAutoregressiveHierarchicalPriors",
            "SampledYInBmshj2018", "Cheng2020Anchor", "Cheng2020Attention", "ELIC2022",
            "SymmetricalTransFormer2022", "TCM2023", "InvCompress", "VITAutoencoderKL",
            "VariationCNNPrior", "ScaleSpaceFlow")}),
        (DATASETS, {name: getattr(data, name) for name in (
            "ERA5NpyDataset", "ERA5NcDataset", "ImageFolder", "PreGeneratedMemmapDataset",
            "VideoFolder", "Vimeo90kDataset")}),
        (CRITERIONS, {"RateDistortionLoss": RateDistortionLoss}),
        (OPTIMIZERS, {"net_aux": make_net_aux_optimizers}),
    ):
        for name, obj in entries.items():
            if name not in registry:
                registry.register(name)(obj)


_register_all()

__all__ = ["MODELS", "DATASETS", "CRITERIONS", "OPTIMIZERS", "SCHEDULERS", "NOT_PORTED"]
