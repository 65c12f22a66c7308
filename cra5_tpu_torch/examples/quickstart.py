"""The ``cra5_api`` walkthrough, offline: encode_to_latent, latent_to_bin,
encode_era5_as_bin, bin_to_latent, latent_to_reconstruction,
decode_from_bin, show_latent and show_image.

Counterpart of ``examples/quickstart.py``. Without downloaded ERA5 NetCDF
files the API synthesizes a timestamp-keyed field shaped by the shipped
per-channel mean and std, so no network is needed. ``--tiny`` takes the
tiny test model instead of the 268-variable one; ``--no-plots`` skips the
two figures (matplotlib is needed for them otherwise).

    python -m cra5_tpu_torch.examples.quickstart --device cpu --tiny
    python -m cra5_tpu_torch.examples.quickstart --no-plots      # 268v on the card
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from ..api.cra5_api import cra5_api
from ..device import resolve_device
from . import add_device_arg

TIME_STAMP = "2024-06-01T00:00:00"


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--tiny", action="store_true",
                        help="tiny test model instead of the 268v flagship")
    parser.add_argument("--out", default=None, help="output dir (default: a temp dir)")
    parser.add_argument("--no-plots", action="store_true",
                        help="skip show_latent and show_image")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    out = args.out or tempfile.mkdtemp(prefix="cra5_demo_")
    ts = TIME_STAMP
    api = cra5_api(model_version=-1 if args.tiny else 268, local_root=out, device=device)
    api.codec.update()  # build the entropy tables once

    # ---- compression ----
    y = api.encode_to_latent(time_stamp=ts)  # continuous latent
    print(f"latent y: shape={tuple(y.shape)} dtype={y.dtype}")

    out_bin = api.latent_to_bin(y=y)  # entropy-coded streams
    nbytes = sum(len(s[0]) for s in out_bin["strings"])
    print(f"bin stream: {nbytes} bytes")

    info = api.encode_era5_as_bin(time_stamp=ts, save_root=out)
    print(f"archive written: {info['save_path']} (encode {info['encoding_time']:.3f}s)")

    # ---- decompression ----
    y_hat = api.bin_to_latent(bin_path=info["save_path"])
    x_hat_norm = api.latent_to_reconstruction(y_hat=y_hat)
    print(f"reconstruction (normalized): {tuple(x_hat_norm.shape)}")

    dec = api.decode_from_bin(time_stamp=ts, return_format="de_normalized")
    x_hat = dec["x_hat"]
    print(f"reconstruction (physical units): {tuple(x_hat.shape)} "
          f"(decode {dec['decoding_time']:.3f}s)")
    result = {"latent_shape": tuple(y.shape), "bin_bytes": nbytes, "save_path": info["save_path"],
              "encoding_time": info["encoding_time"], "decoding_time": dec["decoding_time"],
              "x_hat_shape": x_hat.shape, "x_hat_finite": bool(np.isfinite(x_hat).all()),
              "plots": []}

    # ---- visualization ----
    if not args.no_plots:
        vis = os.path.join(out, "vis")
        nlat = min(8, y_hat.shape[1])
        result["plots"].append(api.show_latent(latent=y_hat[0], time_stamp=ts,
                                               show_channels=list(range(nlat)), save_path=vis))
        # the first three variables the model's channels carry (the tiny
        # model keeps only the leading channels)
        nch = x_hat.shape[0]
        variables = [v for v, c in sorted(api.vname_to_channels.items(),
                                          key=lambda kv: kv[1]) if c < nch][:3]
        result["plots"].append(api.show_image(reconstruct_data=x_hat, time_stamp=ts,
                                              show_variables=variables, save_path=vis))
        print(f"visualizations under {vis}")
    return result


if __name__ == "__main__":
    main()
