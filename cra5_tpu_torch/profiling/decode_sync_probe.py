"""Probe what a step of the lane decode (K2/K3) costs on the card: the
synchronisation a step needs, and the symbol lookup.

``csrc/rans_decode.cu`` decodes a stream as a serial chain of M steps, each
ending in a scan of every lane's refill flag. This probe times, at the y
stream's M = 324 steps of one lane a thread on 1024-thread blocks:

  - a block barrier and every warp's scan of the warp totals (one block);
  - the same plus a cluster barrier and a DSMEM read of every rank's block
    total, for clusters of 1, 2, 4 and 8 blocks;
  - the same plus every rank's total pushed by ``st.async`` into DSMEM, each
    rank waiting on its own mbarrier (1, 2, 4 and 8 blocks);

and the single-block K3 that ``csrc/rans_decode.cu`` replaced (1024
threads, 8 lanes each, a three-barrier scan, words from global memory)
with its binary search over the whole 3133-entry row swapped for the slot
lookup, on a 268v-geometry y stream (256 x 72 x 144 symbols, 1% escapes)
against its plain version.
The kernels are in ``profiling/csrc/decode_sync_probe.cu``, built here
with ``nvcc`` into ``build/cra5_tpu_torch/``; no path of the port runs them.

    python -m cra5_tpu_torch.profiling.decode_sync_probe

prints each time (CUDA events over back-to-back launches) and returns them.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device

_SRC = Path(__file__).resolve().parent / "csrc" / "decode_sync_probe.cu"
M_STEPS = 324  # the 268v y stream's steps on 8192 lanes


def build() -> ctypes.CDLL:
    """Compile the probe's kernels (once per source content) and load them."""
    headers = sorted((_SRC.parents[2] / "csrc").glob("*.cuh"))
    lib = ctypes.CDLL(str(kernels.build_single(_SRC, headers)))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.probe_sync.argtypes = [I, I, I, I, P, ctypes.POINTER(ctypes.c_float)]
    lib.probe_k3_slot.argtypes = [P, I, P, I, I, P, P, P, P, P, P, P, LL, I, I, P, P, P]
    for fn in (lib.probe_sync, lib.probe_k3_slot):
        fn.restype = ctypes.c_int
    return lib


def _y_stream(dev: torch.device):
    """The 268v y geometry on the GC table, index-sorted on 8192 lanes."""
    from ..coder.lane_coder import LaneCoder, _sort_by_index, merge_tiny_buckets
    from ..coder.lane_coder import parse_v2_header, sorted_rows
    from ..entropy import gc_update, get_scale_table

    rng = np.random.default_rng(0)
    table = gc_update(get_scale_table())
    idx = rng.integers(0, 64, 256 * 72 * 144).astype(np.int32)
    L = table.cdf_length[idx]
    bins = np.empty(idx.size, np.int64)
    for r in np.unique(idx):  # each index's own pmf
        m = idx == r
        u = rng.integers(0, 1 << 16, int(m.sum()))
        bins[m] = np.searchsorted(table.quantized_cdf[r, :L[m][0]], u, side="right") - 1
    sym = np.minimum(bins, L - 3) + table.offset[idx]
    esc = rng.random(idx.size) < 0.01
    sym[esc] += 1000
    coder = LaneCoder(table, device=dev)
    data = coder.encode(sym.astype(np.int32), idx)
    (n, K, *_), states, words, _ = coder._upload(data, parse_v2_header(data))
    M = -(-n // K)
    sidx = merge_tiny_buckets(_sort_by_index(torch.as_tensor(idx, device=dev))[0],
                              coder.num_indexes, K)
    idx2 = torch.cat([sidx, sidx[-1:].expand(M * K - n)]).reshape(M, K)
    return coder, (*sorted_rows(idx2), states, words), M, K


def main(device=None) -> Dict[str, float]:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the decode sync probe times CUDA kernels: it needs a card")
    from ..coder import rans_kernels as rk

    lib = build()
    res: Dict[str, float] = {}
    out = torch.zeros(1 + 8 * 1024, dtype=torch.int32, device=dev)
    for mode, name in ((0, "block barrier"), (1, "cluster barrier + DSMEM read"),
                       (2, "st.async push + own mbarrier")):
        for blocks in ((1,) if mode == 0 else (1, 2, 4, 8)):
            ms = ctypes.c_float()
            kernels.check(lib.probe_sync(M_STEPS, blocks, mode, 50, out.data_ptr(),
                                         ctypes.byref(ms)), "probe_sync")
            key = f"{name}, {blocks} x 1024 threads"
            res[key] = ms.value / M_STEPS * 1e3
            print(f"[sync] {key}: {ms.value:.4f} ms for {M_STEPS} steps, "
                  f"{res[key]:.3f} us a step", flush=True)

    coder, (r0, r1, split, states, words), M, K = _y_stream(dev)
    cdf, slots = coder._cdf, coder._slots
    S = slots.shape[1]
    shift = 16 - (S - 1).bit_length() + 1

    def k3_slot():
        v = torch.empty((M, K), dtype=torch.int32, device=dev)
        s = torch.empty((M, K), dtype=torch.bool, device=dev)
        kernels.check(lib.probe_k3_slot(
            cdf.data_ptr(), cdf.shape[1], slots.data_ptr(), S, shift, r0.data_ptr(),
            r1.data_ptr(), split.data_ptr(), coder._max_values.data_ptr(),
            coder._offsets.data_ptr(), states.data_ptr(), words.data_ptr(), words.numel(), M, K,
            v.data_ptr(), s.data_ptr(), kernels.raw_stream(v.get_device())),
            "probe_k3_slot")
        return v, s

    got = k3_slot()
    want = rk.rans_decode_sorted_plain(cdf, r0, r1, split, states, words,
                                       coder._max_values, coder._offsets)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError("the single-block K3 with the slot lookup differs from the plain decode")
    k3_slot()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        k3_slot()
    end.record()
    torch.cuda.synchronize(dev)
    ms = start.elapsed_time(end) / 20
    res["single-block K3 with the slot lookup, ms"] = ms
    print(f"[K3 slot] single-block K3 with the slot lookup on y ({M}, {K}): equal to the plain "
          f"decode; {ms:.4f} ms, {ms / M * 1e3:.3f} us a step", flush=True)
    return res


if __name__ == "__main__":
    main()
