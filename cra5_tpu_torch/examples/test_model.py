"""Zoo smoke test: a named zoo model and the VAEformer, each through a
compress -> decompress roundtrip on random data, offline.

Counterpart of ``examples/test_model.py``: ``bmshj2018_factorized`` at
``--quality`` on a 64 x 64 image, then the tiny VAEformer (the 268v one
with ``--full``), float32, seeded weights.

    python -m cra5_tpu_torch.examples.test_model --device cpu
"""

from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..models.vaeformer import VAEformer, VAEformerCodec, vaeformer_268, vaeformer_tiny
from ..models.zoo import bmshj2018_factorized
from . import add_device_arg


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--quality", type=int, default=2)
    parser.add_argument("--full", action="store_true",
                        help="the full 268v VAEformer instead of the tiny variant")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    # named builder, as the reference zoo call (pretrained=True needs a
    # converted checkpoint: tools/convert_torch.py)
    _, codec = bmshj2018_factorized(quality=args.quality, device=device)
    codec.update()
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((1, 3, 64, 64), generator=gen, device=device)
    out = codec.compress(x)
    dec = codec.decompress(out["strings"], out["shape"])
    nbytes = sum(len(s) for grp in out["strings"] for s in grp)
    print(f"bmshj2018-factorized q={args.quality}: {nbytes} bytes, "
          f"x_hat {tuple(dec['x_hat'].shape)}")

    # the flagship weather model (reference: vaeformer_pretrained(268))
    cfg = vaeformer_268() if args.full else vaeformer_tiny()
    net = VAEformer(cfg, device=device).reset_parameters(0)
    gen = torch.Generator(device=device).manual_seed(1)
    xw = torch.randn((1, cfg.in_chans, *cfg.img_size), generator=gen, device=device)
    wcodec = VAEformerCodec(net)
    wcodec.update()
    ow = wcodec.compress(xw)
    dw = wcodec.decompress(ow["strings"], ow["z_shape"])
    nb = sum(len(s[0]) for s in ow["strings"])
    print(f"VAEformer({cfg.in_chans}v): {nb} bytes, x_hat {tuple(dw['x_hat'].shape)}")
    return {"zoo_bytes": nbytes, "zoo_x_hat_shape": tuple(dec["x_hat"].shape),
            "vaeformer_bytes": nb, "vaeformer_x_hat_shape": tuple(dw["x_hat"].shape),
            "finite": bool(torch.isfinite(dec["x_hat"]).all() and torch.isfinite(dw["x_hat"]).all())}


if __name__ == "__main__":
    main()
