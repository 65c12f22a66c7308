"""The lane-rANS kernels K1-K3, each beside its plain PyTorch version.

Counterpart of ``cra5_tpu/coder/rans_pallas.py``. A wrapper given CUDA
tensors launches its hand-written kernel (``csrc/rans_encode.cu``,
``csrc/rans_decode.cu``) and counts the launch; given CPU tensors it runs
the plain version, which repeats the kernel's arithmetic step by step.
There is no other route: a kernel that fails to build or launch raises.

Conventions: lane states are u32 values carried in int32 tensors (bit
patterns), stream words are u16 values in int16 tensors, and flags are
bool. Every (M, K) grid is step-major: symbol g sits at step g // K, lane
g % K.
"""

from __future__ import annotations

import torch

from .. import kernels

PRECISION = 16
LANE_L = 1 << PRECISION
_MAX_LANES_PER_THREAD = 16  # decode kernels: one block of <= 1024 threads


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def i32_to_u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & 0xFFFFFFFF


def _u16_to_i16(w: torch.Tensor) -> torch.Tensor:
    return torch.where(w >= 1 << 15, w - (1 << 16), w).to(torch.int16)


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{name}: expected {ndim}-D {dtype}, got {t.dim()}-D {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("all operands must lie on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_rows(rows: torch.Tensor, ncdfs: int, name: str) -> None:
    """Raise unless every cdf row index lies in [0, ncdfs): the kernels
    read rows unchecked, and the plain versions would wrap a negative one."""
    lo, hi = torch.aminmax(rows)
    if int(lo) < 0 or int(hi) >= ncdfs:
        raise IndexError(f"{name}: cdf row indexes span [{int(lo)}, {int(hi)}], "
                         f"the table has {ncdfs} rows")


def _lanes_per_thread(K: int) -> int:
    lpt = 1
    while K > 1024 * lpt:
        lpt *= 2
    if lpt > _MAX_LANES_PER_THREAD:
        raise ValueError(f"K={K} lanes exceed the decode kernels' 16384-lane block")
    return lpt


def _stream_args(dev: torch.device):
    return torch.cuda.current_stream(dev).cuda_stream


# ------------------------------------------------------------------ K1
def rans_encode_plain(starts: torch.Tensor, freqs: torch.Tensor):
    M, K = starts.shape
    x = torch.full((K,), LANE_L, dtype=torch.int64, device=starts.device)
    emit = torch.empty((M, K), dtype=torch.bool, device=starts.device)
    words = torch.empty((M, K), dtype=torch.int16, device=starts.device)
    for t in range(M - 1, -1, -1):  # LIFO: the decoder reads forward
        f = freqs[t].to(torch.int64)
        e = (x >> PRECISION) >= f
        words[t] = _u16_to_i16(x & 0xFFFF)
        emit[t] = e
        x = torch.where(e, x >> PRECISION, x)
        q = torch.div(x, f, rounding_mode="floor")
        x = (q << PRECISION) + (x - q * f) + starts[t].to(torch.int64)
    return u32_to_i32(x), emit, words


@kernels.counted
def rans_encode(starts: torch.Tensor, freqs: torch.Tensor):
    """Interleaved-lane rANS encode of an (M, K) grid of int32 cdf starts
    and frequencies, steps taken last to first. Returns (final states (K,)
    int32 [u32 bits], emit (M, K) bool, words (M, K) int16 [u16 bits]);
    a word is meaningful only where emit is set."""
    _require(starts, "starts", torch.int32, 2)
    _require(freqs, "freqs", torch.int32, 2)
    if starts.shape != freqs.shape or 0 in starts.shape:
        raise ValueError("starts and freqs must share a non-empty (M, K) shape")
    dev = _same_device(starts, freqs)
    if dev.type == "cpu":
        return rans_encode_plain(starts, freqs)
    M, K = starts.shape
    states = torch.empty(K, dtype=torch.int32, device=dev)
    emit = torch.empty((M, K), dtype=torch.bool, device=dev)
    words = torch.empty((M, K), dtype=torch.int16, device=dev)
    status = kernels.lib().cra5_rans_encode(
        starts.data_ptr(), freqs.data_ptr(), M, K,
        states.data_ptr(), emit.data_ptr(), words.data_ptr(), _stream_args(dev),
    )
    kernels.check(status, "rans_encode")
    rans_encode.launches += 1
    return states, emit, words


# ------------------------------------------------------------------ K2
def lane_decode_plain(cdf, idx, states, words, max_values, offsets):
    """Decode with each lane's own cdf row from an (M, K) index grid: the
    plain version of K2, and the CPU decode of any v2 stream. ``cdf`` is
    the padded search table (rows padded with 2**16 past their length)."""
    M, K = idx.shape
    dev = idx.device
    x = i32_to_u32(states)
    w_all = words.to(torch.int64) & 0xFFFF
    W = w_all.numel()
    if W == 0:
        w_all = torch.zeros(1, dtype=torch.int64, device=dev)
    cdf64 = cdf.to(torch.int64)
    values = torch.empty((M, K), dtype=torch.int32, device=dev)
    sentinel = torch.empty((M, K), dtype=torch.bool, device=dev)
    ptr = torch.zeros((), dtype=torch.int64, device=dev)
    for t in range(M):
        r = idx[t].to(torch.int64)
        rows = cdf64[r]  # (K, L)
        cum = x & 0xFFFF
        s = (rows <= cum[:, None]).sum(1) - 1
        start = rows.gather(1, s[:, None])[:, 0]
        freq = rows.gather(1, (s + 1)[:, None])[:, 0] - start
        x = freq * (x >> PRECISION) + cum - start
        values[t] = (s + offsets[r]).to(torch.int32)
        sentinel[t] = s == max_values[r]
        x, ptr = _refill(x, w_all, W, ptr)
    return values, sentinel


def _refill(x, w_all, W, ptr):
    """Lanes whose state fell below 2**16 read the next words, in lane
    order, from the shared stream at ``ptr``; a read past its end gives 0."""
    refill = x < LANE_L
    ri = refill.to(torch.int64)
    pos = ptr + torch.cumsum(ri, 0) - ri
    w = torch.where(pos < W, w_all[pos.clamp(0, max(W - 1, 0))], 0)
    x = torch.where(refill, (x << PRECISION) | w, x)
    return x, ptr + ri.sum()


@kernels.counted
def rans_decode_generic(cdf, idx, states, words, max_values, offsets):
    """The lane decode K2 (counterpart of ``decode_scan_pallas`` and of
    ``decode_rowplan_pallas``): any (M, K) index grid, each lane searching
    its own cdf row. ``cdf`` (ncdfs, L) int32 padded search table, ``idx``
    (M, K) int32, ``states`` (K,) int32 [u32], ``words`` (W,) int16 [u16],
    ``max_values``/``offsets`` (ncdfs,) int32. Returns (values (M, K)
    int32, sentinel (M, K) bool)."""
    for t, name, nd in ((cdf, "cdf", 2), (idx, "idx", 2), (states, "states", 1),
                        (max_values, "max_values", 1), (offsets, "offsets", 1)):
        _require(t, name, torch.int32, nd)
    _require(words, "words", torch.int16, 1)
    M, K = idx.shape
    if M == 0 or K != states.numel():
        raise ValueError("idx must be (M >= 1, K) with K = len(states)")
    dev = _same_device(cdf, idx, states, words, max_values, offsets)
    _check_rows(idx, cdf.shape[0], "idx")
    if dev.type == "cpu":
        return lane_decode_plain(cdf, idx, states, words, max_values, offsets)
    values = torch.empty((M, K), dtype=torch.int32, device=dev)
    sentinel = torch.empty((M, K), dtype=torch.bool, device=dev)
    status = kernels.lib().cra5_rans_decode_lanes(
        cdf.data_ptr(), cdf.shape[1], idx.data_ptr(),
        max_values.data_ptr(), offsets.data_ptr(), states.data_ptr(),
        words.data_ptr(), words.numel(), M, K, _lanes_per_thread(K),
        values.data_ptr(), sentinel.data_ptr(), _stream_args(dev),
    )
    kernels.check(status, "rans_decode_generic")
    rans_decode_generic.launches += 1
    return values, sentinel


# ------------------------------------------------------------------ K3
def rans_decode_sorted_plain(cdf, r0, r1, split, states, words, max_values, offsets):
    M = r0.numel()
    K = states.numel()
    dev = states.device
    x = i32_to_u32(states)
    w_all = words.to(torch.int64) & 0xFFFF
    W = w_all.numel()
    if W == 0:
        w_all = torch.zeros(1, dtype=torch.int64, device=dev)
    cdf64 = cdf.to(torch.int64)
    lanes = torch.arange(K, device=dev)
    r0, r1 = r0.to(torch.int64), r1.to(torch.int64)
    values = torch.empty((M, K), dtype=torch.int32, device=dev)
    sentinel = torch.empty((M, K), dtype=torch.bool, device=dev)
    ptr = torch.zeros((), dtype=torch.int64, device=dev)
    for t in range(M):
        first = lanes < split[t]
        row0, row1 = cdf64[r0[t]], cdf64[r1[t]]
        cum = x & 0xFFFF
        s0 = torch.searchsorted(row0, cum, right=True) - 1
        s1 = torch.searchsorted(row1, cum, right=True) - 1
        s = torch.where(first, s0, s1)
        start = torch.where(first, row0[s0], row1[s1])
        freq = torch.where(first, row0[s0 + 1], row1[s1 + 1]) - start
        x = freq * (x >> PRECISION) + cum - start
        values[t] = (s + torch.where(first, offsets[r0[t]], offsets[r1[t]])).to(torch.int32)
        sentinel[t] = s == torch.where(first, max_values[r0[t]], max_values[r1[t]])
        x, ptr = _refill(x, w_all, W, ptr)
    return values, sentinel


@kernels.counted
def rans_decode_sorted(cdf, r0, r1, split, states, words, max_values, offsets):
    """Decode an index-sorted stream: at step t the lanes below
    ``split[t]`` use cdf row ``r0[t]`` and the others ``r1[t]`` (every step
    of a kernel-safe sorted stream spans at most two rows). ``cdf`` (ncdfs,
    L) int32 padded search table; ``r0``/``r1``/``split`` (M,) int32;
    ``states`` (K,) int32 [u32]; ``words`` (W,) int16 [u16];
    ``max_values``/``offsets`` (ncdfs,) int32. Returns (values (M, K)
    int32, sentinel (M, K) bool): values are bin + offset, and sentinel
    marks bin == max_value."""
    for t, name, nd in ((cdf, "cdf", 2), (r0, "r0", 1), (r1, "r1", 1),
                        (split, "split", 1), (states, "states", 1),
                        (max_values, "max_values", 1), (offsets, "offsets", 1)):
        _require(t, name, torch.int32, nd)
    _require(words, "words", torch.int16, 1)
    M, K = r0.numel(), states.numel()
    if M == 0 or r1.numel() != M or split.numel() != M or K == 0:
        raise ValueError("r0, r1 and split must share a length M >= 1")
    dev = _same_device(cdf, r0, r1, split, states, words, max_values, offsets)
    _check_rows(torch.cat([r0, r1]), cdf.shape[0], "r0/r1")
    if dev.type == "cpu":
        return rans_decode_sorted_plain(cdf, r0, r1, split, states, words, max_values, offsets)
    L = cdf.shape[1]
    if 2 * L * 4 > 227 * 1024:
        raise ValueError(f"cdf rows of {L} entries exceed the kernel's shared memory")
    values = torch.empty((M, K), dtype=torch.int32, device=dev)
    sentinel = torch.empty((M, K), dtype=torch.bool, device=dev)
    status = kernels.lib().cra5_rans_decode_sorted(
        cdf.data_ptr(), L, r0.data_ptr(), r1.data_ptr(),
        split.data_ptr(), max_values.data_ptr(), offsets.data_ptr(),
        states.data_ptr(), words.data_ptr(), words.numel(), M, K,
        _lanes_per_thread(K), values.data_ptr(), sentinel.data_ptr(),
        _stream_args(dev),
    )
    kernels.check(status, "rans_decode_sorted")
    rans_decode_sorted.launches += 1
    return values, sentinel
