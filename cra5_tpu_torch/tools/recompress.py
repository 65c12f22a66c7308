"""Data-parallel archive recompression over ranks.

Counterpart of ``cra5_tpu/tools/recompress.py``: re-encode a directory of
ERA5 timesteps, ``(C, H, W)`` float32 ``.npy`` files, into ``.bin`` files
(the v1 container of ``api/bitstream.py``, one a timestep). The files are
split over the ranks (``local_work_slice``), one device a rank (torch's
idiom; the JAX package runs one process a host over its local chips), and
each rank compresses its own: no collective runs but the final barrier.
``recompress_batch`` / ``decompress_batch`` are the library form over a
mesh's dp axis: each rank codes its rows of a global batch and the results
are gathered in rank order.

Usage:
  python -m cra5_tpu_torch.tools.recompress INPUT_DIR -o OUT_DIR
      [--config tiny|268|159] [--checkpoint PATH.pt|PATH.msgpack]
      [--batch N] [--device cuda|cpu] [--backend nccl|gloo]
  torchrun --nproc-per-node N -m cra5_tpu_torch.tools.recompress ...

A world is joined as ``parallel.init_distributed`` resolves it (torchrun's
variables, or ``CRA5_TPU_COORDINATOR`` / ``CRA5_TPU_NUM_PROCESSES`` /
``CRA5_TPU_PROCESS_ID``); ``--backend`` names the backend (default: nccl
on the card, gloo on the CPU). The model is float32, its weights from
``--checkpoint`` or a seeded init (seed 0). ``--batch`` timesteps go
through one ``compress`` call (0: all of this rank's), and the last batch
is padded with repeats of its last timestep so every call has the same
batch (the padding is dropped before writing).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from ..parallel.mesh import axis_group


def recompress_batch(codec, mesh, x: np.ndarray) -> Dict:
    """x: (B, C, H, W) with B divisible by the mesh's dp axis; each rank
    compresses its contiguous rows, and the strings are gathered in rank
    order: every rank returns the whole batch's {"strings", "z_shape"}."""
    import torch.distributed as dist

    group, n, r = axis_group(mesh, "dp")
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not split over {n} dp ranks")
    b = x.shape[0] // n
    out = codec.compress(x[r * b:(r + 1) * b])
    if n == 1:
        return out
    parts = [None] * n
    dist.all_gather_object(parts, (out["strings"], out["z_shape"]), group=group)
    return {"strings": [sum((p[0][0] for p in parts), []), sum((p[0][1] for p in parts), [])],
            "z_shape": parts[0][1]}


def decompress_batch(codec, mesh, strings, z_shape) -> np.ndarray:
    """The dp counterpart of ``recompress_batch``: each rank decodes its
    rows of the batch's strings, and the reconstructions are all-gathered
    (on the card under NCCL, through the host under gloo); returns the
    whole (B, C, H, W) reconstruction on every rank."""
    import torch.distributed as dist

    group, n, r = axis_group(mesh, "dp")
    B = len(strings[1])
    if B % n:
        raise ValueError(f"batch {B} does not split over {n} dp ranks")
    b = B // n
    mine = [list(strings[0][r * b:(r + 1) * b]), list(strings[1][r * b:(r + 1) * b])]
    x_hat = codec.decompress(mine, z_shape)["x_hat"]
    if n == 1:
        return x_hat.float().cpu().numpy()
    if dist.get_backend(group) == "gloo":
        x_hat = x_hat.cpu()
    parts = [torch.empty_like(x_hat) for _ in range(n)]
    dist.all_gather(parts, x_hat.contiguous(), group=group)
    return torch.cat(parts).float().cpu().numpy()


def write_bins(out_dir: str, names: List[str], result: Dict) -> List[str]:
    from ..api.bitstream import save_bin

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    y_strings, z_strings = result["strings"]
    for i, name in enumerate(names):
        path = os.path.join(out_dir, Path(name).stem + ".bin")
        save_bin(path, [[y_strings[i]], [z_strings[i]]], result["z_shape"])
        paths.append(path)
    return paths


def _finish_barrier() -> None:
    """Hold every rank until all have finished coding their files: rank 0
    hosts the world's store, and if it returned first (an empty work slice,
    or just the first to finish) its peers would lose the store mid-archive.
    A week's timeout: shards can be hours of work."""
    from ..parallel import kv_barrier

    kv_barrier("recompress-done", timeout_s=7 * 24 * 3600.0)


def build_codec(config: str, checkpoint=None, device=None):
    """The float32 VAEformer codec of ``config``, its weights from
    ``checkpoint`` (.pt or the JAX package's .msgpack) or seed 0, its CDF
    tables built."""
    from ..models.vaeformer import (VAEformer, VAEformerCodec, vaeformer_159, vaeformer_268,
                                    vaeformer_tiny)
    from ..train.checkpoints import load_variables

    cfg = {"tiny": vaeformer_tiny, "268": vaeformer_268, "159": vaeformer_159}[config]()
    model = VAEformer(cfg, device=device)
    if checkpoint:
        params = load_variables(checkpoint, model=model)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(params[name])
    else:
        model.reset_parameters(0)
    codec = VAEformerCodec(model)
    codec.update()
    return codec


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input_dir", type=str)
    parser.add_argument("-o", "--out-dir", required=True)
    parser.add_argument("--config", default="tiny", choices=["tiny", "268", "159"])
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--batch", type=int, default=0, help="0 = one batch of all inputs")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu; the card unless asked")
    parser.add_argument("--backend", type=str, default=None, help="nccl or gloo")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from ..device import resolve_device
    from ..parallel import init_distributed, local_work_slice, process_count, process_index

    device = resolve_device(args.device)
    joined_here = not dist.is_initialized()
    init_distributed(backend=args.backend, device=device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    try:
        files = sorted(Path(args.input_dir).glob("*.npy"))
        if not files:
            print(f"no .npy in {args.input_dir}", file=sys.stderr)
            return 1
        files = files[local_work_slice(len(files))]
        if not files:  # fewer inputs than ranks: still hold the barrier below
            _finish_barrier()
            return 0
        codec = build_codec(args.config, args.checkpoint, device)
        batch = args.batch or len(files)
        t0 = time.time()
        written: List[str] = []
        for i in range(0, len(files), batch):
            chunk = files[i:i + batch]
            arrs = [np.load(f).astype(np.float32) for f in chunk]
            names = [f.name for f in chunk]
            arrs += [arrs[-1]] * (batch - len(arrs))
            result = recompress_batch(codec, None, np.stack(arrs))
            result = {"strings": [s[:len(names)] for s in result["strings"]],
                      "z_shape": result["z_shape"]}
            written += write_bins(args.out_dir, names, result)
        dt = time.time() - t0
        print(json.dumps({"recompressed": len(written), "process": process_index(),
                          "processes": process_count(), "devices": 1, "seconds": round(dt, 2),
                          "timesteps_per_sec": round(len(written) / dt, 3)}), flush=True)
        _finish_barrier()
        return 0
    finally:
        if joined_here and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
