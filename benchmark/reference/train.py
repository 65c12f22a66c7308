"""The training step in plain PyTorch: the rate-distortion loss, its
gradients, the clip by the global norm, Adam, the schedule and the EMA.

The published trainer (CRA5 ``train_era5_*``; arXiv:2405.03376) steps two
Adams: the net's at the scheduled rate after a clip of the net gradients to
global norm 1 (scaled only when the norm reaches it), and the factorized
prior's quantiles' at a constant rate on the quantile loss. Adam is
b1 0.9, b2 0.999, eps 1e-8 outside the root, bias-corrected; update i
(from 0) takes rate(i). The EMA's decay is min(decay, (1 + n) / (10 + n))
at its n-th update (from 1). A step's noise is drawn from a generator
seeded from (rng, step); the batch's rows are laid out along the noise
tensors' outer dimension.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from . import model as ref

B1, B2, EPS = 0.9, 0.999, 1e-8


def is_aux(name: str) -> bool:
    return name.endswith("quantiles")


def warmup_cosine(base: float, total: int, warmup: int, min_ratio: float) -> Callable[[int], float]:
    def rate(i: int) -> float:
        if i < warmup:
            return base * i / warmup
        decay = max(total, warmup + 1) - warmup
        c = min(float(i - warmup), float(decay))
        return base * ((1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * c / decay)) + min_ratio)
    return rate


def schedule(trainer: dict) -> Callable[[int], float]:
    s = trainer.get("scheduler")
    if s is None:
        return lambda i: trainer["learning_rate"]
    if s["type"] != "WarmupCosineLR":
        raise ValueError(f"the reference has no schedule {s['type']!r}")
    return warmup_cosine(trainer["learning_rate"], trainer["total_steps"], s["warmup_steps"],
                         s.get("min_lr_ratio", 0.0))


@torch.no_grad()
def adam_(params: List[torch.Tensor], grads: List[torch.Tensor], mu: List[torch.Tensor],
          nu: List[torch.Tensor], count: int, lr: float) -> None:
    if not params:
        return
    t = count + 1
    torch._foreach_mul_(mu, B1)
    torch._foreach_add_(mu, grads, alpha=1 - B1)
    torch._foreach_mul_(nu, B2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - B2)
    den = torch._foreach_div(nu, 1 - B2 ** t)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, EPS)
    upd = torch._foreach_div(mu, 1 - B1 ** t)
    torch._foreach_div_(upd, den)
    torch._foreach_add_(params, upd, alpha=-lr)


@torch.no_grad()
def clip_(grads: List[torch.Tensor], max_norm: float) -> None:
    """Scale to ``max_norm`` when the global norm reaches it."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm))


def step_seed(rng: int, step: int) -> int:
    return int(np.random.SeedSequence([int(rng), int(step)]).generate_state(1, np.uint64)[0] >> np.uint64(1))


def step_noise(rng: int, step: int, z_shape: Sequence[int], y_shape: Sequence[int], device):
    """The step's uniform(-0.5, 0.5) noise: the factorized prior's, laid
    out (C, 1, B*h*w), then the Gaussian's, shaped like y."""
    g = torch.Generator(device=device).manual_seed(step_seed(rng, step))
    B, C, h, w = z_shape
    eb = torch.empty((C, 1, B * h * w), device=device).uniform_(-0.5, 0.5, generator=g)
    gc = torch.empty(tuple(y_shape), device=device).uniform_(-0.5, 0.5, generator=g)
    return eb, gc


def latent_shapes(c: dict, batch: int):
    h, w = c["img_size"][0] // c["patch_stride"][0], c["img_size"][1] // c["patch_stride"][1]
    p1, p2 = c["hyper_patch"]
    return (batch, c["z_channels"], h // p1, w // p2), (batch, c["embed_dim"], h, w)


class Trainer:
    """The reference's training state on a parameter dict (cloned into
    leaves), stepping a batch at a time, a sample at a time."""

    def __init__(self, c: dict, P: Dict[str, torch.Tensor], trainer: dict, prec: str = "fp32"):
        self.c, self.t, self.prec = c, trainer, prec
        self.P = {k: v.detach().clone().requires_grad_(True) for k, v in P.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.P.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.P.items()}
        self.ema = {k: v.detach().clone() for k, v in self.P.items()} if trainer["use_ema"] else None
        self.rate = schedule(trainer)
        self.count = 0

    def step(self, batch: torch.Tensor, rng: int) -> Dict[str, object]:
        """One update on ``batch`` (B, C, H, W); returns the total loss and
        each leaf's gradient norm as the optimizer took it (the net's
        clipped)."""
        m = ref.VAEformer(self.c, self.P, self.prec)
        B, C, H, W = batch.shape
        z_shape, y_shape = latent_shapes(self.c, B)
        eb, gc = step_noise(rng, self.count, z_shape, y_shape, batch.device)
        hw = z_shape[2] * z_shape[3]
        total = 0.0
        for b in range(B):
            bpp, mse = ref.train_terms(m, batch[b:b + 1], eb[:, :, b * hw:(b + 1) * hw],
                                       gc[b:b + 1], B * H * W, B * C * H * W,
                                       self.t["lmbda"], self.t["bpp_weight"])
            loss = bpp + mse
            loss.backward()
            total += float(loss.detach())
        aux = ref.aux_loss(m)
        aux.backward()
        total += float(aux.detach())
        names = list(self.P)
        grads = {k: (self.P[k].grad if self.P[k].grad is not None else torch.zeros_like(self.P[k]))
                 for k in names}
        net = [k for k in names if not is_aux(k)]
        clip_([grads[k] for k in net], self.t["max_grad_norm"])
        aux_names = [k for k in names if is_aux(k)]
        for group, lr in ((net, self.rate(self.count)), (aux_names, self.t["aux_learning_rate"])):
            adam_([self.P[k].data for k in group], [grads[k] for k in group],
                  [self.mu[k] for k in group], [self.nu[k] for k in group], self.count, lr)
        norms = torch.stack([torch.linalg.vector_norm(grads[k]) for k in names]).cpu().numpy()
        out = {"loss": total, "grad_norms": dict(zip(names, norms.astype(np.float64)))}
        for p in self.P.values():
            p.grad = None
        if self.ema is not None:
            n = self.count + 1
            d = min(self.t["ema_decay"], (1.0 + n) / (10.0 + n))
            with torch.no_grad():
                for k, e in self.ema.items():
                    e.sub_((e - self.P[k]) * (1.0 - d))
        self.count += 1
        return out
