"""Probe the primitive costs the index-sorted y decode depends on: sort,
take and scatter at 2.65 M elements, and two kernels of the design's
building blocks, K7 ``expand`` (the log-shift word expansion) and K8
``dynroll`` (a roll by a shift read on the device).

Counterpart of ``profiling/_perm_probe.py``. Its five XLA probes are
PyTorch calls here (``torch.sort``, ``torch.argsort``, indexing and
``scatter_``); its two Pallas kernels are hand-written CUDA
(``csrc/perm_probe.cu``), each wrapper beside its plain PyTorch version:
given CUDA tensors a wrapper launches its kernel and counts the launch,
given CPU tensors it runs the plain version.

    python -m cra5_tpu_torch.profiling.perm_probe [--device cpu] [--n N]

prints each probe's milliseconds (host clock around calls that end in a
synchronize, as the JAX probe's ``block_until_ready``).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device

N = 2_654_208
NCDFS = 64
R, KD = 8, 1024  # the Pallas kernels' (rows, lanes)
MAX_EXPAND = 16384  # K7 holds R * Kd int32 words in one block's shared memory


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, *args, iters: int = 10, name: str = "", results: Dict[str, float] = None):
    """Mean milliseconds of ``iters`` calls after one warm-up call."""
    device = args[0].device
    out = fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(device)
    ms = (time.perf_counter() - t0) / iters * 1e3
    print(f"{name:40s} {ms:8.2f} ms", flush=True)
    if results is not None:
        results[name] = ms
    return out


# ---------------------------------------------------------------- XLA probes
def packed_sort(idx: torch.Tensor):
    """Sort (idx << 22 | position): the sorted indexes and the permutation."""
    iota = torch.arange(idx.shape[0], dtype=torch.int32, device=idx.device)
    skey = torch.sort((idx << 22) | iota).values
    return skey >> 22, skey & ((1 << 22) - 1)


def _normalize(p: torch.Tensor, n: int):
    """numpy-style indexes: [-n, 0) counts from the end; outside [-n, n)
    is out of range."""
    p = torch.where(p < 0, p + n, p)
    return p, (p >= 0) & (p < n)


def take_fill(v: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``jnp.take(v, p, mode="fill", fill_value=0)``."""
    p, ok = _normalize(p, v.shape[0])
    return torch.where(ok, v[p.clamp(0, v.shape[0] - 1).long()], 0)


def scatter_drop(v: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``zeros_like(v).at[p].set(v, mode="drop")``: out-of-range updates go
    to a spare slot past the end, which is cut off."""
    n = v.shape[0]
    p, ok = _normalize(p, n)
    out = torch.zeros(n + 1, dtype=v.dtype, device=v.device)
    return out.scatter_(0, torch.where(ok, p, n).long(), v)[:n]


def sort_roundtrip(idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Sort by index, gather, scatter back: what a sorted decode pays."""
    _, perm = packed_sort(idx)
    return scatter_drop(take_fill(vals, perm), perm)


# ---------------------------------------------------------------- K7
def _check_expand(mask: torch.Tensor, words: torch.Tensor) -> None:
    if words.dim() != 2 or mask.shape != words.shape:
        raise ValueError(f"mask and words must share one (R, Kd) shape, got "
                         f"{tuple(mask.shape)} and {tuple(words.shape)}")
    R_, Kd = words.shape
    # the TPU kernel's row roll by b // Kd is a flat roll only for a
    # power-of-two Kd
    if Kd & (Kd - 1) or R_ * Kd == 0 or R_ * Kd > MAX_EXPAND:
        raise ValueError(f"expand takes (R, Kd) with Kd a power of two and 0 < R * Kd <= "
                         f"{MAX_EXPAND}, got ({R_}, {Kd})")
    if mask.device != words.device:
        raise ValueError("mask and words must lie on one device")


def expand_plain(mask: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Word j of the flattened ``words`` ends where the j-th set lane of
    ``mask`` is, by log-shift flat rolls: pass b moves the word at p - b
    to p where p's pending displacement has bit b. The displacement
    belongs to the position and does not travel with the word, as in the
    TPU kernel."""
    K = words.numel()
    mf = (mask.reshape(-1) != 0).to(torch.int32)
    rank = torch.cumsum(mf, 0, dtype=torch.int32) - mf
    pos = torch.arange(K, dtype=torch.int32, device=words.device)
    rem = torch.where(mf != 0, pos - rank, 0)
    buf = words.reshape(-1).to(torch.int32)
    b = 1
    while b < K:
        mv = (rem & b) != 0
        buf = torch.where(mv, torch.roll(buf, b), buf)
        rem = torch.where(mv, rem - b, rem)
        b *= 2
    return buf.reshape(words.shape)


@kernels.counted
def expand(mask: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """K7 on CUDA tensors (int32, contiguous), the plain version on CPU ones."""
    _check_expand(mask, words)
    if words.device.type == "cpu":
        return expand_plain(mask, words)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    for t in (mask, words):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError("K7 takes contiguous int32 mask and words")
    out = torch.empty_like(words)
    status = kernels.lib().cra5_perm_expand(
        mask.data_ptr(), words.data_ptr(), out.data_ptr(), words.numel(),
        torch.cuda.current_stream(words.device).cuda_stream)
    kernels.check(status, "expand")
    expand.launches += 1
    return out


# ---------------------------------------------------------------- K8
def dynroll_plain(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``roll(x, shift[0], axis=1)``; any shift, taken modulo Kd."""
    return torch.roll(x, int(shift.reshape(-1)[0]), 1)


@kernels.counted
def dynroll(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """K8: roll the rows of a (R, Kd) int32 tensor by a shift that stays on
    the device (a one-element int32 tensor)."""
    if x.dim() != 2 or shift.numel() != 1 or shift.device != x.device:
        raise ValueError("dynroll takes a (R, Kd) tensor and a one-element shift on its device")
    if x.device.type == "cpu":
        return dynroll_plain(x, shift)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.int32 or shift.dtype != torch.int32 or not x.is_contiguous():
        raise TypeError("K8 takes a contiguous int32 x and an int32 shift")
    out = torch.empty_like(x)
    status = kernels.lib().cra5_perm_dynroll(
        x.data_ptr(), shift.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(status, "dynroll")
    dynroll.launches += 1
    return out


# ---------------------------------------------------------------- main
def main(device=None, n: int = N, iters: int = 10) -> Dict[str, object]:
    """Run the probes on ``device`` (default: the card); returns each
    probe's ms and whether K8 rolled as ``torch.roll``."""
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})", flush=True)
    ms: Dict[str, float] = {}
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, NCDFS, n).astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.integers(0, 1 << 15, n).astype(np.int32)).to(dev)
    tag = f"{n / 1e6:.2f}M"

    _, perm = timeit(packed_sort, idx, iters=iters, name=f"packed-key sort {tag}", results=ms)
    timeit(lambda a: torch.argsort(a, stable=True), idx, iters=iters,
           name=f"argsort(stable) {tag}", results=ms)
    timeit(take_fill, vals, perm, iters=iters, name=f"take {tag} (fill)", results=ms)
    timeit(scatter_drop, vals, perm, iters=iters, name=f"scatter {tag} (drop)", results=ms)
    out = timeit(sort_roundtrip, idx, vals, iters=iters, name="sort+take+scatter", results=ms)
    if not torch.equal(out, vals):
        raise AssertionError("the sort roundtrip does not give the values back")

    mask = torch.from_numpy((rng.random((R, KD)) < 0.6).astype(np.int32)).to(dev)
    words = torch.from_numpy(rng.integers(0, 1 << 16, (R, KD)).astype(np.int32)).to(dev)
    timeit(expand, mask, words, iters=iters, name="expansion kernel (K7)", results=ms)
    rolled = dynroll(words, torch.tensor([3], dtype=torch.int32, device=dev))
    matches = torch.equal(rolled, torch.roll(words, 3, 1))
    print(f"dynamic roll (K8), semantics-roll-matches: {matches}", flush=True)
    if not matches:
        raise AssertionError("dynroll does not roll as torch.roll")
    return {"ms": ms, "dynroll_matches": matches}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--iters", type=int, default=10)
    a = ap.parse_args()
    main(a.device, a.n, a.iters)
