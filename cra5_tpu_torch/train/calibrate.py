"""Entropy-side calibration: fit h_a, h_s and the EntropyBottleneck to the
latent statistics of a frozen tower.

Counterpart of ``cra5_tpu/train/calibrate.py``. The coded stream's size is
set by how well the hyper path models the tower's latents: with an entropy
side that was never fit (a random init, or towers that moved after the
hyper path was trained), the predicted scales sit at the table's floor,
most y symbols escape, and the streams grow tens of times. This re-fits
only the entropy-side parameters (``TRAINABLE``) on latents the model made
itself, with the towers frozen, so reconstruction stays bit-identical.

The loss is the noise-quantized bits per latent element of (y, z) under
``VAEformer.entropy_rate`` plus the EntropyBottleneck's quantile loss; it
steps with ``make_net_aux_optimizers`` (the quantiles on their own Adam,
the net gradients clipped by their global norm over the entropy side
only). Differences from the JAX package, each forced by the framework:

  - the model's parameters are fit in place (the JAX function returns new
    variables); gradients are taken with ``torch.autograd.grad`` of the
    entropy-side parameters only, so no tower parameter gets a gradient;
  - the noise comes from one ``torch.Generator`` on the model's device
    (``seed``), not from ``jax.random``: the draws differ between the
    packages;
  - the cache is a ``torch.save`` file of the fitted parameters, keyed as
    in JAX plus the model's dtype (the JAX key omits it).

A ``VAEformerCodec`` built on the model must rebuild its CDF tables
(``codec.update(force=True)``) after a fit, before it codes.
"""

from __future__ import annotations

import hashlib
import math
import os
from typing import Dict, Optional, Sequence

import torch

from .optim import make_net_aux_optimizers

TRAINABLE = ("h_a", "h_s", "entropy_bottleneck")


def _split_params(model: torch.nn.Module):
    sub, rest = {}, {}
    for name, p in model.named_parameters():
        (sub if name.split(".")[0] in TRAINABLE else rest)[name] = p
    return sub, rest


def calibrate_entropy(
    model,
    latents: Sequence,
    steps: int = 600,
    learning_rate: float = 1e-3,
    aux_learning_rate: float = 1e-3,
    seed: int = 17,
    log_every: int = 0,
) -> Dict[str, float]:
    """Re-fit the model's h_a, h_s and EntropyBottleneck parameters in place
    to ``latents`` (a list of (B, C, h, w) y tensors or arrays from
    ``model.encode_latent``). Returns the bits per latent element of the
    first and the last step (each before its update) and the step count."""
    dev = model.device
    yb = torch.cat([torch.as_tensor(y, device=dev) for y in latents], dim=0)
    sub, _ = _split_params(model)
    if not sub:
        raise ValueError("no entropy-side params (h_a/h_s/entropy_bottleneck)")
    names, params = list(sub), list(sub.values())
    tx = make_net_aux_optimizers(learning_rate, aux_learning_rate)
    opt_state = tx.init(sub)
    n_el = float(yb.numel())
    generator = torch.Generator(device=dev).manual_seed(seed)

    first = last = None
    with torch.enable_grad():
        for i in range(steps):
            out = model.entropy_rate(yb, generator)
            bits = sum(-torch.sum(torch.log2(l.float())) for l in out["likelihoods"].values())
            bpe = bits / n_el  # bits per latent element
            grads = torch.autograd.grad(bpe + out["aux"], params)
            tx.update_(sub, dict(zip(names, grads)), opt_state)
            last = bpe.detach()
            if first is None:
                first = last
            if log_every and (i + 1) % log_every == 0:
                print(f"[calibrate] step {i + 1}: {float(last):.3f} bits/el")
    res = {"steps": steps, "bpe_first": float("nan"), "bpe_last": float("nan")}
    if steps:
        res.update(bpe_first=float(first), bpe_last=float(last))
        if not (math.isfinite(res["bpe_first"]) and math.isfinite(res["bpe_last"])):
            raise FloatingPointError(f"calibration diverged: {res}")
    return res


def _cache_key(model, steps: int, n_latents: int) -> str:
    cfg = getattr(model, "cfg", None)
    dtype = getattr(model, "dtype", None)
    desc = f"{type(model).__name__}|{cfg!r}|{dtype}|{steps}|{n_latents}|torch-v1"
    return hashlib.sha1(desc.encode()).hexdigest()[:16]


def calibrate_entropy_cached(model, latents: Sequence, cache_dir: Optional[str],
                             **kw) -> Dict[str, object]:
    """``calibrate_entropy`` with an on-disk cache of the fitted entropy-side
    parameters, keyed on the model config, its dtype and the fit settings,
    NOT on the tower weights: reuse a cache dir only across runs that build
    the model with the same init seed. Returns ``calibrate_entropy``'s
    result, or ``{"cached": True}`` when the fit was read, with the
    cache file's ``path`` in both."""
    path = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        key = _cache_key(model, kw.get("steps", 600), len(latents))
        path = os.path.join(cache_dir, f"calib_{key}.pt")
        if os.path.exists(path):
            saved = torch.load(path, map_location="cpu", weights_only=True)
            sub, _ = _split_params(model)
            if set(saved) != set(sub):
                raise ValueError(f"{path}: entropy-side names differ from the model's")
            with torch.no_grad():
                for name, p in sub.items():
                    p.copy_(saved[name])
            return {"cached": True, "path": path}
    res = calibrate_entropy(model, latents, **kw)
    if path:
        sub, _ = _split_params(model)
        torch.save({k: v.detach().cpu() for k, v in sub.items()}, path)
    return {**res, "cached": False, "path": path}
