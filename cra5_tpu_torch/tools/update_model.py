"""Rebuild a trained checkpoint's CDF tables and export it under a
SHA-256-stamped name.

Counterpart of ``cra5_tpu/tools/update_model.py``: load a checkpoint into
a zoo model, rebuild the integer CDF tables from its EntropyBottleneck and
the scale table (``codec.update(force=True)``; ``--no-update`` keeps the
first build), and write ``{"variables": {"params": <flax tree>}, "cdf":
{...}}`` in flax's msgpack bytes (``utils/msgpack.py``, keys sorted as
flax writes them) to ``<name>-<first 8 hex of its SHA-256>.msgpack``. The
JAX package's ``unpack_with_tables`` reads the file, and the same inputs
give the same bytes, hence the same name, in both packages. The model
runs on ``--device`` (the card unless the CPU is asked for).

Usage:
  python -m cra5_tpu_torch.tools.update_model ckpt.msgpack -a mbt2018-mean -q 1 [-d outdir]
"""

from __future__ import annotations

import argparse
import hashlib
import sys
from pathlib import Path

import torch

from ..convert import _sorted
from ..entropy.cdf import CdfTable
from ..utils import msgpack
from .convert_torch import cdf_payload


def pack_with_tables(variables, codec) -> bytes:
    """Variables and the codec's CDF tables in one msgpack blob."""
    tables = {"eb": codec._eb_table}
    if codec._gc_table is not None:
        tables["gc"] = codec._gc_table
        tables["scale_table"] = codec.scale_table
    return msgpack.dumps(_sorted({"variables": variables, "cdf": cdf_payload(tables)}))


def unpack_with_tables(data: bytes):
    """Inverse of pack_with_tables: (variables, {eb, gc?, scale_table?});
    a plain variables blob gives (variables, None)."""
    payload = msgpack.loads(data)
    if "variables" not in payload:
        return payload, None
    tables = {}
    cdf = payload.get("cdf", {})
    for key in ("eb", "gc"):
        if key in cdf:
            t = cdf[key]
            tables[key] = CdfTable(quantized_cdf=t["quantized_cdf"], cdf_length=t["cdf_length"],
                                   offset=t["offset"])
    if "scale_table" in cdf:
        tables["scale_table"] = cdf["scale_table"]
    return payload["variables"], tables


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("checkpoint", type=str)
    parser.add_argument("-a", "--architecture", required=True)
    parser.add_argument("-q", "--quality", type=int, default=1)
    parser.add_argument("--in-channel", type=int, default=3)
    parser.add_argument("-d", "--dir", type=str, default=None)
    parser.add_argument("-n", "--name", type=str, default=None)
    parser.add_argument("--no-update", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu; the card unless asked")
    args = parser.parse_args(argv)

    from ..convert import to_flax_params
    from ..models import create_model, make_codec
    from ..train.checkpoints import load_variables

    model = create_model(args.architecture, args.quality, in_channel=args.in_channel,
                         device=args.device)
    params = load_variables(args.checkpoint, model=model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
    codec = make_codec(model)
    codec.update(force=not args.no_update)

    variables = {"params": to_flax_params(model, dict(model.named_parameters()))}
    blob = pack_with_tables(variables, codec)
    digest = hashlib.sha256(blob).hexdigest()[:8]
    name = args.name or f"{args.architecture}-{args.quality}"
    outdir = Path(args.dir or Path(args.checkpoint).parent)
    outdir.mkdir(parents=True, exist_ok=True)
    out = outdir / f"{name}-{digest}.msgpack"
    out.write_bytes(blob)
    print(str(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
