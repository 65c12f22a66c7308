"""VIVT-69 operating-point experiment: train a 69-variable VAEformer toward
the published RD band and write an RD point (and a plot) against the
published anchors.

Counterpart of ``cra5_tpu/tools/vivt69_experiment.py``. The published
VIVT-69 anchors (``tools/plot_data/VIVT-69.json``) sit at bpsp 0.139-0.157
and normalized MSE ~0.0114 on real normalized ERA5. Without ERA5 this
experiment trains on spectrally shaped synthetic fields: per-channel
Gaussian random fields with a power-law spectrum ~ (k + k0)^-alpha,
standardized to unit variance, mixed from ``rank`` shared drivers so the
channels carry ERA5's cross-level redundancy (``correlated_fields``). The
generators are numpy and give the JAX package's fields for the same seed;
``--ntrain 0`` draws fresh fields every step on the device from a
``torch.Generator`` instead (``make_device_sampler``: the statistics of
``correlated_fields``, other numbers than JAX's sampler by design). The
(bpsp, MSE) point shares axes and normalization with the anchors; the
data's provenance is written into the output JSON.

Usage:
    python -m cra5_tpu_torch.tools.vivt69_experiment -o RD_VIVT69.json \
        [--steps 4000] [--lmbdas 2.0 4.0] [--geometry 181 360] [--pilot] \
        [--device cuda|cpu]

Outputs: <out>.json (plot-data format: {name, results: {bpsp, MSE}}),
and with --plot a PNG of the points over the anchor band.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def spectral_fields(rng: np.random.Generator, n: int, c: int, h: int, w: int,
                    alpha: float = 3.0, k0: float = 3.0) -> np.ndarray:
    """(n, c, h, w) unit-variance Gaussian random fields with isotropic
    power spectrum ~ (|k| + k0)^-alpha (large scales dominate, like
    standardized reanalysis fields)."""
    ky = np.fft.fftfreq(h)[:, None] * h
    kx = np.fft.rfftfreq(w)[None, :] * w
    kk = np.sqrt(ky * ky + kx * kx)
    amp = (kk + k0) ** (-alpha / 2.0)
    amp[0, 0] = 0.0  # zero-mean
    out = np.empty((n, c, h, w), np.float32)
    for i in range(n):
        for j in range(c):
            phase = rng.normal(size=kk.shape) + 1j * rng.normal(size=kk.shape)
            f = np.fft.irfft2(amp * phase, s=(h, w))
            out[i, j] = f / (f.std() + 1e-12)
    return out


def correlated_fields(rng: np.random.Generator, n: int, c: int, h: int, w: int,
                      rank: int = 12, eps: float = 0.07,
                      alpha: float = 3.0, mix: np.ndarray | None = None
                      ) -> np.ndarray:
    """(n, c, h, w) unit-variance fields with ERA5-like CROSS-CHANNEL
    redundancy: each sample's c channels are fixed linear mixtures of
    ``rank`` independent spectral driver fields plus an independent
    spectrally-shaped residual of relative amplitude ``eps``.

    Real ERA5's 69 variables are 4 surface + 5 variables x 13 pressure
    levels; adjacent levels of one variable are near-duplicates, which is
    the redundancy the published VIVT-69 band (bpsp ~0.14 at normalized
    MSE ~0.011) exploits. Independent per-channel fields lack it entirely
    (69x more information per pixel), so an RD point on them is not
    comparable to the anchors. The mixing matrix is FIXED across samples
    (stationary "physics"); the achievable-MSE floor from uncoded
    residuals is eps^2/(1+eps^2) (~0.005 at the default), safely below
    the anchor band but not trivially zero.
    """
    if mix is None:
        mix = rng.normal(size=(c, rank)).astype(np.float32)
        mix /= np.linalg.norm(mix, axis=1, keepdims=True) + 1e-12
    out = np.empty((n, c, h, w), np.float32)
    for i in range(n):
        drivers = spectral_fields(rng, 1, rank, h, w, alpha=alpha)[0]
        resid = spectral_fields(rng, 1, c, h, w, alpha=alpha)[0]
        x = np.tensordot(mix, drivers, axes=(1, 0)) + eps * resid
        out[i] = x / (x.std(axis=(1, 2), keepdims=True) + 1e-12)
    return out


def make_device_sampler(mix: np.ndarray, h: int, w: int, eps: float,
                        alpha: float, batch: int, k0: float = 3.0, device=None):
    """``sample(generator) -> (batch, c, h, w)`` float32 fields made on
    ``device`` with correlated_fields' statistics: fresh spectral driver and
    residual fields at every call (no host-to-device copy), drawn from the
    caller's ``torch.Generator`` on that device."""
    from ..device import resolve_device

    dev = resolve_device(device)
    ky = np.fft.fftfreq(h)[:, None] * h
    kx = np.fft.rfftfreq(w)[None, :] * w
    kk = np.sqrt(ky * ky + kx * kx)
    amp = ((kk + k0) ** (-alpha / 2.0)).astype(np.float32)
    amp[0, 0] = 0.0
    amp_d = torch.from_numpy(amp).to(dev)
    mix_d = torch.from_numpy(np.asarray(mix, np.float32)).to(dev)  # (c, rank)
    c, rank = mix.shape

    def unit(x: torch.Tensor) -> torch.Tensor:
        return x / (x.std(dim=(-2, -1), keepdim=True, correction=0) + 1e-12)

    def spectral(generator: torch.Generator, n: int) -> torch.Tensor:
        shape = (batch, n) + amp.shape
        re = torch.randn(shape, generator=generator, device=dev)
        im = torch.randn(shape, generator=generator, device=dev)
        return unit(torch.fft.irfft2(amp_d * torch.complex(re, im), s=(h, w)))

    @torch.no_grad()
    def sample(generator: torch.Generator) -> torch.Tensor:
        drivers = spectral(generator, rank)  # (b, rank, h, w)
        resid = spectral(generator, c)  # (b, c, h, w)
        return unit(torch.einsum("cr,brhw->bchw", mix_d, drivers) + eps * resid)

    return sample


def vivt69_config(h: int, w: int, pilot: bool = False,
                  width: int | None = None, depth: int | None = None,
                  embed: int | None = None, heads: int | None = None):
    """69-channel VAEformer at a reduced geometry obeying the ERA5
    patch relation H = (Hp-1)*10 + 11 (vit_nlc.py:628-633)."""
    from ..models.vaeformer import VAEformerConfig

    hp = (h - 11) // 10 + 1
    wp = w // 10
    assert (hp - 1) * 10 + 11 == h and wp * 10 == w, (h, w)
    if pilot:
        lat, width, depth, heads = 32, 64, 4, 4
        hyw, hyd, hyh = 48, 2, 4
    else:
        lat = embed or 128
        width = width or 384
        depth = depth or 10
        heads = heads or max(4, width // 48)
        hyw, hyd, hyh = 160, 4, 8
    # rectangular window cycle scaled to the reduced token grid (the
    # 268v pattern (24,24)/(12,48)/(48,12) scaled by the grid ratio)
    ws = max(2, hp // 3)
    return VAEformerConfig(
        in_chans=69,
        img_size=(h, w),
        patch_size=(11, 10),
        patch_stride=(10, 10),
        embed_dim=lat,          # y latent channels
        y_channels=width,       # ViT tower width
        z_channels=lat,
        depth=depth,
        num_heads=heads,
        window_sizes=((ws, ws), (ws // 2 or 1, 2 * ws), (2 * ws, ws // 2 or 1)),
        interval=4,
        hyper_embed_dim=hyw,
        hyper_depth=hyd,
        hyper_num_heads=hyh,
        hyper_patch=(2, 2),
        name=f"vaeformer_vivt69_{h}x{w}",
    )


def evaluate(codec, val: np.ndarray):
    """Real-coded (bpsp, normalized MSE) of held-out fields, one at a time."""
    n, c, h, w = val.shape
    bits = 0
    mse = 0.0
    for i in range(n):
        x = val[i : i + 1]
        out = codec.compress(x)
        nbytes = sum(len(s[0]) for s in (out["strings"][0], out["strings"][1]))
        bits += 8 * nbytes
        dec = codec.decompress(out["strings"], out["z_shape"])
        x_hat = dec["x_hat"].float().cpu().numpy()
        mse += float(np.mean((x_hat - x) ** 2))
    return bits / (n * c * h * w), mse / n


def run_lambda(lmbda, steps, h, w, batch, pilot, seed, log,
               n_train=64, n_val=4, rank=12, eps=0.07, alpha=3.75,
               lr=2e-4, width=None, depth=None, embed=None, ema=False,
               ckpt_dir=None, ckpt_every=0, device=None):
    from ..device import resolve_device
    from ..models import VAEformer
    from ..models.vaeformer import VAEformerCodec
    from ..train import Trainer, TrainerConfig
    from ..train.checkpoints import resolve_last_checkpoint
    from ..train.loop import step_generator

    dev = resolve_device(device)
    cfg = vivt69_config(h, w, pilot, width=width, depth=depth, embed=embed)
    model = VAEformer(cfg, device=dev)
    rng = np.random.default_rng(seed)
    infinite = n_train == 0 and rank > 0
    if infinite:
        # fresh fields on the device every step; the host makes only the
        # held-out set (and a few more for the train-side diagnostic) from
        # the SAME fixed mixing matrix
        mix = rng.normal(size=(69, rank)).astype(np.float32)
        mix /= np.linalg.norm(mix, axis=1, keepdims=True) + 1e-12
        log(f"lmbda={lmbda}: on-device sampler (rank={rank}, eps={eps}); "
            f"generating {n_val + 4} held-out fields {h}x{w}x69")
        fields = correlated_fields(rng, n_val + 4, 69, h, w,
                                   rank=rank, eps=eps, alpha=alpha, mix=mix)
        train, val = fields[n_val:], fields[:n_val]
    else:
        log(f"lmbda={lmbda}: generating {n_train + n_val} fields {h}x{w}x69 "
            f"(rank={rank}, eps={eps})")
        if rank > 0:
            fields = correlated_fields(rng, n_train + n_val, 69, h, w,
                                       rank=rank, eps=eps, alpha=alpha)
        else:
            fields = spectral_fields(rng, n_train + n_val, 69, h, w,
                                     alpha=alpha)
        train, val = fields[:n_train], fields[n_train:]

    # --steps is the TOTAL horizon (it also fixes the cosine schedule);
    # with --ckpt-dir a run resumes from the lambda's last full train-state
    # checkpoint and trains only the remaining steps
    lam_dir = os.path.join(ckpt_dir, f"lmbda{lmbda:g}") if ckpt_dir else None
    tc = TrainerConfig(
        learning_rate=lr, lmbda=lmbda, bpp_weight=1.0, use_ema=ema,
        log_every=max(1, steps // 10),
        ckpt_every=ckpt_every if (lam_dir and ckpt_every) else 10**9,
        ckpt_dir=lam_dir or "checkpoints",
        ckpt_keep=3,
        scheduler=dict(type="WarmupCosineLR", warmup_steps=max(1, steps // 20)),
        total_steps=steps,
    )
    trainer = Trainer(model, tc, seed=seed)
    resume_path = None
    if lam_dir:
        os.makedirs(lam_dir, exist_ok=True)
        # resume is keyed on lambda only, so everything else that defines
        # the experiment must match the checkpoints in the directory
        fp = dict(lmbda=lmbda, h=h, w=w, batch=batch, seed=seed,
                  n_train=n_train, n_val=n_val, rank=rank, eps=eps,
                  alpha=alpha, lr=lr, width=width, depth=depth,
                  embed=embed, ema=ema, pilot=pilot)
        fp_path = os.path.join(lam_dir, "experiment.json")
        if os.path.exists(fp_path):
            with open(fp_path) as f:
                on_disk = json.load(f)
            if on_disk != fp:
                diff = {k: (on_disk.get(k), fp[k]) for k in fp
                        if on_disk.get(k) != fp[k]}
                raise ValueError(
                    f"{lam_dir} holds a different experiment "
                    f"(checkpoint vs requested: {diff}); use a fresh "
                    "--ckpt-dir or delete the stale one")
        else:
            with open(fp_path, "w") as f:
                json.dump(fp, f, indent=1)
        try:
            resume_path = resolve_last_checkpoint(lam_dir, "last_state")
        except ValueError:
            resume_path = None

    if infinite:
        sampler = make_device_sampler(mix, h, w, eps, alpha, batch, device=dev)

        def batches(offset=0):
            # a resumed run continues with a stream of its own step, so it
            # does not replay the fields it trained on
            gen = step_generator(seed + 1, offset, dev)
            while True:
                yield sampler(gen)
    else:
        # the training set staged on the device once (bf16 past 96
        # fields); a batch is a gather there
        stage_dtype = torch.bfloat16 if n_train > 96 else torch.float32
        train_dev = torch.from_numpy(train).to(dev, stage_dtype)

        def batches(offset=0):
            ep_rng = np.random.default_rng(seed + 1 + offset)
            while True:
                idx = ep_rng.integers(0, n_train, size=batch)
                yield train_dev[torch.from_numpy(idx).to(dev)].float()

    t0 = time.time()
    it = batches()
    first = next(it)
    if resume_path is not None:
        state = trainer.restore(first, resume_path)
        done = int(state.step)
        log(f"  resumed {resume_path} (step {done}/{steps})")
    else:
        state = trainer.init_state(first)
        done = 0
    remaining = max(0, steps - done)
    last = {}

    def log_fn(step, m):
        nonlocal last
        last = m
        log(f"  step {step}: " + " ".join(f"{k}={v:.4g}" for k, v in m.items()))

    metrics_path = os.path.join(lam_dir, "metrics.json") if lam_dir else None
    if remaining:
        state = trainer.fit(batches(offset=done), state=state,
                            num_steps=remaining, log_fn=log_fn)
        log(f"  trained {remaining} steps in {time.time() - t0:.0f}s")
        if metrics_path:
            with open(metrics_path, "w") as f:
                json.dump(last, f, indent=1)
        # fit already checkpointed the final step when it divides ckpt_every
        if lam_dir and steps % tc.ckpt_every != 0:
            log(f"  saved {trainer.save(state)}")
    elif metrics_path and os.path.exists(metrics_path):
        # a finished run re-invoked (e.g. to regenerate the RD point):
        # the training diagnostics saved at completion
        with open(metrics_path) as f:
            last = json.load(f)

    if ema and state.ema is not None:
        # evaluate the EMA shadow (the reference's LitEma store/copy step)
        with torch.no_grad():
            for name, p in state.params.items():
                p.copy_(state.ema.params[name])
    codec = VAEformerCodec(model)
    codec.update(force=True)
    bpsp, mse = evaluate(codec, val)
    # diagnostic: the coded MSE on TRAIN fields separates the underfit
    # floor from the train -> val generalization gap
    _, mse_tr = evaluate(codec, train[: len(val)])
    log(f"  lmbda={lmbda}: coded bpsp={bpsp:.4f} norm-MSE={mse:.5f} "
        f"(train-MSE {mse_tr:.5f})")
    return {"lmbda": lmbda, "bpsp": round(bpsp, 5), "MSE": round(mse, 6),
            "train_MSE": round(mse_tr, 6),
            "train_metrics": {k: round(float(v), 5) for k, v in last.items()}}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-o", "--out", default="RD_VIVT69.json")
    parser.add_argument("--steps", type=int, default=8000)
    parser.add_argument("--lmbdas", type=float, nargs="+", default=[128.0, 512.0])
    parser.add_argument("--geometry", type=int, nargs=2, default=[181, 360])
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--ntrain", type=int, default=64,
                        help="staged training fields; 0 = infinite fresh "
                        "on-device sampling (requires --rank > 0)")
    parser.add_argument("--nval", type=int, default=4)
    parser.add_argument("--rank", type=int, default=12,
                        help="cross-channel driver rank (0 = independent channels)")
    parser.add_argument("--eps", type=float, default=0.07,
                        help="relative residual amplitude on top of the drivers")
    parser.add_argument("--alpha", type=float, default=3.75,
                        help="per-channel spectral slope. Default 3.75 is "
                        "CALIBRATED: JPEG2000 on these fields matches the "
                        "published J2K-on-real-ERA5 anchor (plot_data/"
                        "JPEG-2000.json) within ~±30%% over bpsp 0.2-0.4 "
                        "(measured: alpha=3 is 2.2-8.9x harder, alpha=4 is "
                        "0.5-1.2x, alpha=5 ~10x easier), so classical-codec "
                        "difficulty is anchored to the real data the "
                        "published VIVT-69 band was measured on")
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--ema", action="store_true",
                        help="train with EMA (decay 0.9999, warmup like "
                        "the reference LitEma) and evaluate the shadow "
                        "params")
    parser.add_argument("--width", type=int, default=None,
                        help="ViT tower width override (default 384)")
    parser.add_argument("--depth", type=int, default=None,
                        help="ViT tower depth override (default 10)")
    parser.add_argument("--embed", type=int, default=None,
                        help="y latent channels override (default 128)")
    parser.add_argument("--pilot", action="store_true",
                        help="small dims for a CPU smoke run")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ckpt-dir", type=str, default=None,
                        help="checkpoint/resume root: each lambda trains "
                        "under <dir>/lmbda<L> and resumes from its "
                        "last_state pointer; --steps stays the TOTAL "
                        "horizon (re-invoke with a larger --steps to "
                        "extend a finished run)")
    parser.add_argument("--ckpt-every", type=int, default=2000,
                        help="full train-state checkpoint interval "
                        "(steps), only active with --ckpt-dir")
    parser.add_argument("--plot", type=str, default=None,
                        help="write a PNG vs the shipped VIVT-69 anchors")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu; the card unless asked")
    args = parser.parse_args(argv)
    if args.ntrain == 0 and args.rank <= 0:
        parser.error("--ntrain 0 (infinite on-device sampling) requires "
                     "--rank > 0: the device sampler draws through the "
                     "fixed cross-channel mixing matrix")

    def log(msg):
        print(f"[vivt69] {msg}", file=sys.stderr, flush=True)

    h, w = args.geometry
    points = [
        run_lambda(l, args.steps, h, w, args.batch, args.pilot, args.seed, log,
                   n_train=args.ntrain, n_val=args.nval,
                   rank=args.rank, eps=args.eps, alpha=args.alpha, lr=args.lr,
                   width=args.width, depth=args.depth, embed=args.embed,
                   ema=args.ema, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every, device=args.device)
        for l in args.lmbdas
    ]
    points.sort(key=lambda p: p["bpsp"])
    result = {
        "name": "cra5_tpu_torch VAEformer-69 (synthetic ERA5-like fields)",
        "description": (
            f"trained + real-coded on alpha={args.alpha} spectral Gaussian "
            f"fields with rank-{args.rank} cross-channel drivers + "
            f"eps={args.eps} residuals at {h}x{w} (synthetic fields, not "
            "ERA5; the low-rank mixing mirrors ERA5's "
            "5-vars-x-13-levels redundancy that the published band "
            "exploits, and alpha is calibrated so JPEG2000 difficulty on "
            "these fields matches the published J2K-on-ERA5 anchor); axes "
            "match the published VIVT-69 anchors (normalized MSE, bpsp)"
        ),
        "geometry": [69, h, w],
        "rank": args.rank,
        "eps": args.eps,
        "alpha": args.alpha,
        "steps": args.steps,
        "results": {
            "bpsp": [p["bpsp"] for p in points],
            "MSE": [p["MSE"] for p in points],
        },
        "points": points,
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"out": args.out, "points": [
        {"lmbda": p["lmbda"], "bpsp": p["bpsp"], "MSE": p["MSE"]} for p in points
    ]}))

    if args.plot:
        from . import plot as plot_tool

        anchors = os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "plot_data", "VIVT-69.json"
        )
        plot_tool.main([
            "-f", args.out, anchors, "--metric", "MSE", "--rate-key", "bpsp",
            "--title", "VIVT-69 band: cra5_tpu_torch vs published anchors",
            "-o", args.plot,
        ])
    return 0


if __name__ == "__main__":
    sys.exit(main())
