"""Roundtrip timing through ``cra5_api``: N iterations of encode_to_latent
-> latent_to_bin -> encode_era5_as_bin, then bin_to_latent ->
latent_to_reconstruction -> decode_from_bin, printing the mean and the
population standard deviation of the encode and decode seconds.

Counterpart of ``examples/roundtrip_timing.py``; the device is
synchronised before every clock read. Offline, on the API's synthesized
field; the ``.bin`` goes under ``--out`` (default: a temp dir).

    python -m cra5_tpu_torch.examples.roundtrip_timing 5        # 268v on the card
    python -m cra5_tpu_torch.examples.roundtrip_timing 2 --tiny --device cpu
"""

from __future__ import annotations

import argparse
import statistics
import tempfile
import time

from ..api.cra5_api import cra5_api
from ..device import resolve_device
from . import add_device_arg, sync

TIME_STAMP = "2024-06-01T00:00:00"


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("iters", type=int, nargs="?", default=5)
    parser.add_argument("--tiny", action="store_true",
                        help="tiny test model instead of the 268v flagship")
    parser.add_argument("--out", default=None, help="the .bin's root (default: a temp dir)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    out = args.out or tempfile.mkdtemp(prefix="cra5_timing_")
    ts = TIME_STAMP
    api = cra5_api(model_version=-1 if args.tiny else 268, local_root=out, device=device)
    enc_times, dec_times = [], []
    for _ in range(args.iters):
        sync(device)
        t0 = time.perf_counter()
        y = api.encode_to_latent(ts)
        api.latent_to_bin(y)
        info = api.encode_era5_as_bin(ts)
        sync(device)
        enc_times.append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        y_hat = api.bin_to_latent(time_stamp=ts)
        api.latent_to_reconstruction(y_hat)
        api.decode_from_bin(time_stamp=ts)
        sync(device)
        dec_times.append(time.perf_counter() - t0)

    enc = (statistics.mean(enc_times), statistics.pstdev(enc_times))
    dec = (statistics.mean(dec_times), statistics.pstdev(dec_times))
    print(f"encode: {enc[0]:.3f}s ± {enc[1]:.3f}")
    print(f"decode: {dec[0]:.3f}s ± {dec[1]:.3f}")
    return {"encode_s": enc_times, "decode_s": dec_times, "encode_mean_s": enc[0],
            "encode_pstdev_s": enc[1], "decode_mean_s": dec[0], "decode_pstdev_s": dec[1],
            "save_path": info["save_path"]}


if __name__ == "__main__":
    main()
