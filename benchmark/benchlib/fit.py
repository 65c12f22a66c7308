"""The entropy fit of set-up: the hyperprior and the factorized prior fit
to the latents of the seeded towers, so that the coder codes what a
trained model would give it rather than escapes.

The benchmark's own fit, run on the plain float32 reference
(``reference/model.py``) before the program is built, so that nothing the
program computes moves the weights: the float32 latents of two seeded
fields from the reference's g_a, then ``steps`` steps on the
noise-quantized bits per latent element of (y, z) plus the quantile loss,
the entropy side's gradients clipped to global norm 1 under Adam at
``lr``, the quantiles under their own Adam at ``lr`` (the recipe of the
published calibration). The fitted parameters count as weights: the
benchmark hands them to the program and to the reference alike.
"""

from __future__ import annotations

from typing import Dict

import torch

from reference import model as ref
from reference.train import adam_, clip_, is_aux

from .fields import field
from .seeds import sub_seed

TRAINABLE = ("h_a", "h_s", "entropy_bottleneck")


def fit_entropy(P: Dict[str, torch.Tensor], c: dict, seed: int, steps: int = 600,
                lr: float = 1e-3, latents: int = 2) -> Dict[str, torch.Tensor]:
    """The fitted entropy side, float32, from the float32 parameters ``P``
    (left as they are)."""
    dev = P["g_a.pos_embed"].device
    with torch.no_grad():
        R = ref.VAEformer(c, P)
        y = torch.cat([R.g_a(field(c, seed, 1000 + i, dev)) for i in range(latents)])
    sub = {k: p.detach().clone().requires_grad_(True) for k, p in P.items()
           if k.split(".")[0] in TRAINABLE}
    R = ref.VAEformer(c, {**P, **sub})
    names = list(sub)
    net = [k for k in names if not is_aux(k)]
    aux = [k for k in names if is_aux(k)]
    mu = {k: torch.zeros_like(p) for k, p in sub.items()}
    nu = {k: torch.zeros_like(p) for k, p in sub.items()}
    g = torch.Generator(device=dev).manual_seed(sub_seed(seed, "fit"))
    n_el = float(y.numel())
    for i in range(steps):
        z = R.h_a(y)
        eb_noise = torch.rand((z.shape[1], 1, z.numel() // z.shape[1]), generator=g, device=dev) - 0.5
        gc_noise = torch.rand(y.shape, generator=g, device=dev) - 0.5
        lik_y, lik_z, _ = ref.noisy_likelihoods(R, y, z, eb_noise, gc_noise)
        bits = -(torch.log2(lik_y).sum() + torch.log2(lik_z).sum())
        loss = bits / n_el + ref.aux_loss(R)
        grads = dict(zip(names, torch.autograd.grad(loss, [sub[k] for k in names])))
        clip_([grads[k] for k in net], 1.0)
        for group in (net, aux):
            adam_([sub[k].data for k in group], [grads[k] for k in group],
                  [mu[k] for k in group], [nu[k] for k in group], i, lr)
    return {k: p.detach() for k, p in sub.items()}
