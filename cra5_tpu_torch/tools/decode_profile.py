"""Decode-only serving profile: where a decode's time goes on the card.

Counterpart of ``cra5_tpu/tools/decode_profile.py``. On the 268v bf16
model (entropy side calibrated, as ``bench.py`` does; the fit cached under
the checkout's ``build/``) or the tiny one, it measures:

  * the sequential decode latency (median of ``--iters``), per batch size;
  * the pipelined decode rate against the depth (decodes in flight, each
    thread on its own CUDA stream: ``bench.pipelined_rate``, the median
    of 3 windows);
  * batched decode (``--batches``, e.g. B = 2);
  * a cumulative phase chain of one decode: the z stream (K2) -> + h_s and
    the GC indexes -> + the y stream (K3 or K2) -> + post_quant_conv and
    g_s, each prefix run from the host bytes and ended by
    ``torch.cuda.synchronize``, and consecutive prefixes differenced.

Two faults of the JAX tool are not carried over: ``bin_bytes_b{B}`` sums
the streams of every sample of a batch (the JAX tool counts sample 0's
only), and in the phase chain the y stream's upload is issued before the
z decode, as ``decompress`` issues it (the JAX tool issues it after the z
scan), so the first phase, under its JAX name, holds that issue too.

Usage:
  python -m cra5_tpu_torch.tools.decode_profile [--depths 2,4,6,8,10]
         [--batches 1,2] [--iters 7] [--per-window 18] [--model 268|tiny]
         [--device cuda|cpu] [-o out.json]

Progress goes to stderr, the result JSON to stdout (and ``-o``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

PHASES = ["z_upload+scan", "+hyper/scales", "+y_scan", "+g_s/reconstruct"]


def _ints(s: str):
    return [int(x) for x in s.split(",")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--depths", default="2,4,6,8,10", type=_ints)
    p.add_argument("--batches", default="1,2", type=_ints)
    p.add_argument("--iters", type=int, default=7)
    p.add_argument("--per-window", type=int, default=18)
    p.add_argument("--phase-iters", type=int, default=5)
    p.add_argument("--model", choices=["268", "tiny"], default="268")
    p.add_argument("--amp", type=float, default=1.0,
                   help="input amplitude (production point ~2.4MB bins)")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu; the card unless asked")
    p.add_argument("-o", "--out", default=None)
    args = p.parse_args(argv)

    from .. import bench
    from ..device import resolve_device

    dev = resolve_device(args.device)

    def log(msg: str) -> None:
        print(f"[prof] {msg}", file=sys.stderr, flush=True)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.time()
    s = bench.setup(dev, args.model, torch.bfloat16, calibrate=args.model == "268")
    codec, cfg = s.codec, s.model.cfg
    xs = {b: bench.field(cfg, dev, seed=0, batch=b) * args.amp for b in args.batches}
    log(f"init {time.time() - t0:.1f}s")

    result = {"model": args.model, "amp": args.amp}
    outs = {}
    for b in args.batches:
        outs[b] = codec.compress(xs[b])
        nbytes = sum(len(st) for grp in outs[b]["strings"] for st in grp)  # every sample's
        result[f"bin_bytes_b{b}"] = nbytes // b
    log(f"encoded {time.time() - t0:.1f}s")

    def write() -> None:
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)

    for b in args.batches:
        out = outs[b]

        def dec_one(out=out):
            codec.decompress(out["strings"], out["z_shape"])
            sync()

        dec_one()
        seq = []
        for _ in range(args.iters):
            t1 = time.time()
            dec_one()
            seq.append(time.time() - t1)
        med = float(np.median(seq))
        result[f"seq_b{b}"] = {"median_s": round(med, 4), "per_sample_s": round(med / b, 4),
                               "decodes_per_sec": round(b / med, 3)}
        log(f"b{b} seq {med:.3f}s")

        depth_rates = {}
        for depth in args.depths:
            try:
                rate, windows = bench.pipelined_rate(dec_one, depth,
                                                     max(args.per_window // b, 8), 3, dev)
            except torch.cuda.OutOfMemoryError as e:
                # a deeper pipeline holds more decodes in flight: record, stop
                depth_rates[str(depth)] = {"error": repr(e)[:200]}
                log(f"b{b} depth {depth}: {e!r}")
                torch.cuda.empty_cache()
                break
            depth_rates[str(depth)] = {"decodes_per_sec": round(rate * b, 3),
                                       "windows": [round(w, 3) for w in windows]}
            log(f"b{b} depth {depth}: {rate * b:.3f} dec/s {depth_rates[str(depth)]['windows']}")
        result[f"pipelined_b{b}"] = depth_rates
        write()

    # The cumulative phase chain (the first batch size), stage by stage as
    # VAEformerCodec.decompress runs them; each prefix starts from the host
    # bytes and ends in one synchronize, so differences are phase times.
    out = outs[args.batches[0]]
    y_strings, z_strings = out["strings"][0], out["strings"][1]
    B, g = len(z_strings), cfg.latent_grid
    full_z = (B, cfg.z_channels, int(out["z_shape"][0]), int(out["z_shape"][1]))

    @torch.inference_mode()
    def prefix(k: int) -> None:
        y_up = codec._gc_coder.upload_batch(list(y_strings), cfg.embed_dim * g[0] * g[1])
        z_sym = codec._eb_coder.decode_batch_to_device(list(z_strings),
                                                       codec._channel_indexes(full_z))
        if k > 0:
            scales, means = codec.model.scales_from_z_symbols(z_sym)
            idx = codec._gc_indexes(scales)
        if k > 1:
            y_sym = codec._gc_coder.decode_uploaded_batch(y_up, idx)
        if k > 2:
            codec.model.reconstruct_from_y_symbols(y_sym, means)
        sync()

    cum = []
    for k, name in enumerate(PHASES):
        prefix(k)
        ts = []
        for _ in range(args.phase_iters):
            t1 = time.time()
            prefix(k)
            ts.append(time.time() - t1)
        cum.append(float(np.median(ts)))
        log(f"prefix {name}: {cum[-1]:.4f}s")
    result["phase_chain_cumulative_s"] = [round(c, 4) for c in cum]
    result["phase_budget_s"] = {PHASES[0]: round(cum[0], 4),
                                **{PHASES[k]: round(cum[k] - cum[k - 1], 4) for k in range(1, 4)}}

    print(json.dumps(result))
    write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
