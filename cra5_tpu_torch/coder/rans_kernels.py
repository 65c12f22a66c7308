"""The lane-rANS kernels K1-K3, each beside its plain PyTorch version, and
the container kernels K9/K10.

Counterpart of ``cra5_tpu/coder/rans_pallas.py``. A wrapper given CUDA
tensors launches its hand-written kernel (``csrc/rans_encode.cu``,
``csrc/rans_decode.cu``, ``csrc/crx2_container.cu``) and counts the
launch; given CPU tensors it runs the plain version, which repeats the
kernel's arithmetic step by step (for K9/K10, the host's own packer and
parser, ``lane_coder.assemble_container`` and ``container_arrays``).
There is no other route: a kernel that fails to build or launch raises.

The decode kernels K2/K3 share one skeleton (``cra5_rans_decode``): the
launch shape for any lane count the format allows comes from
``decode_geometry``, and each cdf row's ``slot_table`` makes the symbol
lookup O(1). ``slot_search_plain``, ``geometry_lanes`` and
``refill_ranks_plain`` state that arithmetic in plain PyTorch for the
tests; the plain decodes themselves search the rows directly.

Conventions: lane states are u32 values carried in int32 tensors (bit
patterns), stream words are u16 values in int16 tensors, and flags are
bool. Every (M, K) grid is step-major: symbol g sits at step g // K, lane
g % K.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels

PRECISION = 16
LANE_L = 1 << PRECISION
MAX_LANES = 1 << 20  # the CRX2 header's bound on K
MAGIC = 0x32585243  # "CRX2" little-endian
SORTED_FLAG = 1 << 31  # K bit 31: index-sorted lane assignment
KERNEL_SAFE_FLAG = 1 << 30  # K bit 30: every step spans <= 2 cdf rows
MERGED_FLAG = 1 << 29  # K bit 29: tiny cdf buckets merged
HEADER_BYTES = 20
SORTED_MIN_LANES = 2048  # "auto" sorts streams of at least this many lanes


def _check_sorted_mode(mode: str) -> str:
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"invalid sorted lanes mode {mode!r}")
    return mode


_SORTED_MODE = _check_sorted_mode(os.environ.get("CRA5_TPU_SORTED_LANES", "auto"))


def set_sorted_lanes(mode: str) -> None:
    """mode: "auto" | "on" | "off": whether new streams take the
    index-sorted lane assignment (decoded by K3) or stay unsorted (K2)."""
    global _SORTED_MODE
    _SORTED_MODE = _check_sorted_mode(mode)


def sorted_lanes_mode() -> str:
    """The mode ``set_sorted_lanes`` (or ``CRA5_TPU_SORTED_LANES``) set."""
    return _SORTED_MODE


def use_sorted_lanes(K: int) -> bool:
    """Encode a new stream of K lanes index-sorted? Never under "off" or
    when K % 128; always else under "on"; under "auto" from 2048 lanes.
    The port's "auto" is the format's default on every device, where the
    JAX package's "auto" also asks for its accelerator (its CPU writes
    unsorted streams)."""
    if _SORTED_MODE == "off" or K % 128:
        return False
    return _SORTED_MODE == "on" or K >= SORTED_MIN_LANES


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


def slot_bits(L: int) -> int:
    """Resolution of the slot table of rows of L entries: 2**bits + 1 slots
    a row, fine enough that a slot's range spans few bins (at most 16 on the
    GC table's 3133-entry rows at 12 bits, at most 2 on a 23-entry EB row at
    6), small enough that a narrow table stays small."""
    return min(12, max(4, (L - 1).bit_length() + 1))


def slot_table(cdf: torch.Tensor, bits: Optional[int] = None) -> torch.Tensor:
    """(ncdfs, 2**bits + 8) int16 slot table of a padded search table:
    ``slot[r, c]`` is the largest s with ``cdf[r, s] <= min(c << (16 -
    bits), 2**16 - 1)``, so the bin of any cum < 2**16 in row r lies in
    ``[slot[r, cum >> (16 - bits)], slot[r, (cum >> (16 - bits)) + 1]]``.
    The last 7 columns repeat ``slot[r, 2**bits]``: they pad a row to 16
    bytes, which the decode kernels copy in bulk."""
    ncdfs, L = cdf.shape
    if L > 1 << 15:
        raise ValueError(f"cdf rows of {L} entries do not fit int16 slots")
    bits = slot_bits(L) if bits is None else bits
    c = torch.arange((1 << bits) + 8, device=cdf.device).clamp(max=1 << bits)
    edges = (c << (PRECISION - bits)).clamp(max=LANE_L - 1).to(cdf.dtype)
    s = torch.searchsorted(cdf.contiguous(), edges.expand(ncdfs, -1).contiguous(), right=True)
    return (s - 1).clamp(min=0).to(torch.int16)


def slot_search_plain(cdf: torch.Tensor, slots: torch.Tensor, rows: torch.Tensor,
                      cum: torch.Tensor) -> torch.Tensor:
    """The kernels' symbol lookup, vectorised: for each (row, cum) the bin
    found by a binary search of ``cdf[row]`` bounded by the two slots around
    cum. Equals ``searchsorted(cdf[row], cum, right=True) - 1``."""
    L, S = cdf.shape[1], slots.shape[1]
    shift = PRECISION - (S - 8).bit_length() + 1  # S = 2**bits + 8
    rows, cum = rows.to(torch.int64), cum.to(torch.int64)
    flat, sflat = cdf.reshape(-1).to(torch.int64), slots.reshape(-1).to(torch.int64)
    c = rows * S + (cum >> shift)
    lo, hi = sflat[c], sflat[c + 1]
    while bool((lo < hi).any()):
        mid = (lo + hi + 1) >> 1
        ok = flat[rows * L + mid] <= cum
        lo, hi = torch.where((lo < hi) & ok, mid, lo), torch.where((lo < hi) & ~ok, mid - 1, hi)
    return lo


class DecodeGeometry(NamedTuple):
    """How K2/K3 spread K lanes: ``blocks`` blocks of ``threads`` threads,
    thread g (of blocks x threads) owning lanes g + j x blocks x threads for
    j < ``lanes_per_thread``; the blocks form one cluster of ``cluster``
    (1, 2, 4 or 8) or, when ``cooperative``, a cooperative grid of blocks
    that all reside on the card at once."""

    blocks: int
    cluster: int
    threads: int
    lanes_per_thread: int
    cooperative: bool


def decode_geometry(K: int, sms: int = 132) -> DecodeGeometry:
    """The decode kernels' launch shape for K lanes: one lane a thread on
    a cluster of up to 8 blocks of 1024 while K allows (K3's 8192 lanes:
    8 x 1024), then 2 and 4 lanes a thread; beyond 32768 lanes a
    cooperative grid of at most ``sms`` blocks of 1024 threads with 8 or 16
    lanes each. A shape rule: every K in [1, 2**20] has a kernel route."""
    if not 1 <= K <= MAX_LANES:
        raise ValueError(f"K={K} lanes: the CRX2 format allows 1 to {MAX_LANES}")
    up32 = lambda n: -(-n // 32) * 32
    if K <= 1024:
        return DecodeGeometry(1, 1, up32(K), 1, False)
    for lpt in (1, 2, 4):
        blocks = -(-K // (1024 * lpt))
        if blocks <= 8:
            blocks = 1 << (blocks - 1).bit_length()  # cluster sizes 2, 4, 8
            return DecodeGeometry(blocks, blocks, up32(-(-K // (blocks * lpt))), lpt, False)
    for lpt in (8, 16):
        blocks = -(-K // (1024 * lpt))
        if blocks <= sms:
            return DecodeGeometry(blocks, 1, up32(-(-K // (blocks * lpt))), lpt, True)
    raise ValueError(f"K={K} lanes do not fit a cooperative grid of {sms} blocks")


def geometry_lanes(geo: DecodeGeometry, K: int) -> torch.Tensor:
    """(blocks, threads, lanes_per_thread) int64: the lane each thread of
    the geometry decodes in slot j, -1 past K (the kernels' lane map)."""
    nt = geo.blocks * geo.threads
    g = torch.arange(nt).reshape(geo.blocks, geo.threads, 1)
    lanes = g + torch.arange(geo.lanes_per_thread) * nt
    return torch.where(lanes < K, lanes, -1)


def refill_ranks_plain(refill: torch.Tensor, geo: DecodeGeometry) -> torch.Tensor:
    """The kernels' rank of each refilling lane among a step's refills, in
    lane order, built as they build it: within the warp (ballot and popc),
    the warp's offset in its block (a scan of the warp totals), the block's
    offset in the cluster or grid (a scan of the block totals), and the
    totals of the lane slots j before it. ``refill`` (K,) bool; returns
    (K,) int64, meaningful where refill is set."""
    K = refill.numel()
    lanes = geometry_lanes(geo, K)  # (blocks, threads, lpt)
    f = torch.where(lanes >= 0, refill.to(torch.int64)[lanes.clamp(min=0)], 0)
    nb, T, lpt = f.shape
    w = f.reshape(nb, T // 32, 32, lpt)
    in_warp = torch.cumsum(w, 2) - w                       # popc of the lower lanes' ballot bits
    warp_tot = w.sum(2)                                    # (blocks, warps, lpt)
    warp_off = torch.cumsum(warp_tot, 1) - warp_tot        # one warp's scan after one barrier
    block_tot = warp_tot.sum(1)                            # (blocks, lpt)
    block_off = torch.cumsum(block_tot, 0) - block_tot     # DSMEM or global exchange
    slot_tot = block_tot.sum(0)                            # (lpt,)
    slot_base = torch.cumsum(slot_tot, 0) - slot_tot
    rank = in_warp + warp_off[:, :, None] + block_off[:, None, None] + slot_base
    rank = rank.reshape(nb, T, lpt)
    out = torch.zeros(K, dtype=torch.int64)
    valid = lanes >= 0
    out[lanes[valid]] = rank[valid]
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _decode_on_card(sorted_, cdf, slots, rows, states, words, max_values, offsets, M, K):
    """Launch K3 (sorted_) or K2 in the geometry ``decode_geometry`` gives
    K on this card; ``rows`` is (idx, r0, r1, split), the unused ones None."""
    dev = states.device
    if cdf.shape[1] % 4:  # the kernels copy 16-byte rows (LaneCoder's tables have them)
        cdf = torch.nn.functional.pad(cdf, (0, -cdf.shape[1] % 4), value=LANE_L)
    slots = slot_table(cdf) if slots is None else slots
    _require(slots, "slots", torch.int16, 2)
    if slots.shape[0] != cdf.shape[0] or slots.device != dev:
        raise ValueError("slots must be the slot_table of cdf, on its device")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    geo = decode_geometry(K, _sm_count(index))
    W = words.numel()
    if W >= 1 << 31 or M * K >= 1 << 31:  # the kernels count positions in 32 bits
        raise ValueError(f"{W} words or {M} x {K} symbols exceed the decode kernels' 2**31")
    if W % 8 or words.data_ptr() % 16:  # the bulk copies move 16-byte chunks
        words = torch.cat([words, words.new_zeros(-W % 8)])
    sync = (torch.zeros(32 + 2 * geo.blocks * geo.lanes_per_thread, dtype=torch.int32, device=dev)
            if geo.cooperative else None)
    values = torch.empty((M, K), dtype=torch.int32, device=dev)
    sentinel = torch.empty((M, K), dtype=torch.bool, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    status = kernels.lib().cra5_rans_decode(
        int(sorted_), cdf.data_ptr(), slots.data_ptr(), cdf.shape[0], cdf.shape[1],
        slots.shape[1], *(ptr(t) for t in rows), max_values.data_ptr(), offsets.data_ptr(),
        states.data_ptr(), ptr(words), W, M, K, geo.blocks, geo.threads, geo.lanes_per_thread,
        int(geo.cooperative), ptr(sync), values.data_ptr(), sentinel.data_ptr(),
        kernels.raw_stream(dev.index),
    )
    kernels.check(status, "rans_decode_sorted" if sorted_ else "rans_decode_generic")
    return values, sentinel


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
        states.data_ptr(), emit.data_ptr(), words.data_ptr(), kernels.raw_stream(dev.index),
    )
    kernels.check(status, "rans_encode")
    kernels.count(rans_encode)
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
def rans_decode_generic(cdf, idx, states, words, max_values, offsets, slots=None):
    """The lane decode K2 (counterpart of ``decode_scan_pallas`` and of
    ``decode_rowplan_pallas``): any (M, K) index grid, each lane searching
    its own cdf row. ``cdf`` (ncdfs, L) int32 padded search table, ``idx``
    (M, K) int32, ``states`` (K,) int32 [u32], ``words`` (W,) int16 [u16],
    ``max_values``/``offsets`` (ncdfs,) int32; ``slots`` the table's
    ``slot_table`` (made here when not given). Returns (values (M, K) int32,
    sentinel (M, K) bool)."""
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
    values, sentinel = _decode_on_card(False, cdf, slots, (idx, None, None, None), states,
                                       words, max_values, offsets, M, K)
    kernels.count(rans_decode_generic)
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
def rans_decode_sorted(cdf, r0, r1, split, states, words, max_values, offsets, slots=None):
    """Decode an index-sorted stream: at step t the lanes below
    ``split[t]`` use cdf row ``r0[t]`` and the others ``r1[t]`` (every step
    of a kernel-safe sorted stream spans at most two rows). ``cdf`` (ncdfs,
    L) int32 padded search table; ``r0``/``r1``/``split`` (M,) int32;
    ``states`` (K,) int32 [u32]; ``words`` (W,) int16 [u16];
    ``max_values``/``offsets`` (ncdfs,) int32; ``slots`` the table's
    ``slot_table`` (made here when not given). Returns (values (M, K) int32,
    sentinel (M, K) bool): values are bin + offset, and sentinel marks bin
    == max_value."""
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
    values, sentinel = _decode_on_card(True, cdf, slots, (None, r0, r1, split), states,
                                       words, max_values, offsets, M, K)
    kernels.count(rans_decode_sorted)
    return values, sentinel


# ------------------------------------------------------------------ K9, K10
class ContainerLayout(NamedTuple):
    """Byte offsets in a v2 container of K lanes, ``nw`` words and ``ne``
    escapes (``docs/FORMATS.md`` section 3): the states after the 20-byte
    header, the words after the states, the escape varints after the
    words; ``capacity`` is the most bytes the container can take, every
    varint at its longest (5 bytes)."""

    states: int
    words: int
    escapes: int
    capacity: int


def container_layout(K: int, nw: int, ne: int) -> ContainerLayout:
    words = HEADER_BYTES + 4 * K
    escapes = words + 2 * nw
    return ContainerLayout(HEADER_BYTES, words, escapes, escapes + 5 * ne)


@kernels.counted
def container_write(n: int, sorted_mode: bool, states: torch.Tensor, words: torch.Tensor,
                    escs: torch.Tensor, safe: torch.Tensor) -> torch.Tensor:
    """K9: the byte image of the v2 container of ``n`` symbols with the
    final lane states (K,) int32 [u32], the stream words (nw,) int16 [u16]
    and the escape values (ne,) int32, sorted or not (``safe``, a 0-d bool,
    the encoder's kernel-safe verdict, read only for a sorted stream).
    Returns (8 + ``container_layout(K, nw, ne).capacity``,) uint8: bytes
    0-7 hold the container's size (int64, little-endian), the container
    starts at byte 8, and what lies past its end is unspecified."""
    _require(states, "states", torch.int32, 1)
    _require(words, "words", torch.int16, 1)
    _require(escs, "escs", torch.int32, 1)
    _require(safe, "safe", torch.bool, 0)
    dev = _same_device(states, words, escs, safe)
    K, nw, ne = states.numel(), words.numel(), escs.numel()
    if not 1 <= K <= MAX_LANES or not 0 <= n <= 1 << 30:
        raise ValueError(f"K={K} lanes and n={n} symbols: the CRX2 header allows 1 to "
                         f"{MAX_LANES} lanes and at most 2**30 symbols")
    size = 8 + container_layout(K, nw, ne).capacity
    if dev.type == "cpu":  # the plain version is the host's packer
        from .lane_coder import assemble_container

        data = assemble_container(n, K, nw, ne, sorted_mode, bool(safe),
                                  states.numpy().view(np.uint32), words.numpy().view(np.uint16),
                                  escs.numpy())
        out = torch.zeros(size, dtype=torch.uint8)
        out[:8] = torch.tensor([len(data)], dtype=torch.int64).view(torch.uint8)
        out[8:8 + len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        return out
    if size >= 1 << 31:  # the kernel counts bytes in 32 bits
        raise ValueError(f"a container of up to {size} bytes exceeds the kernel's 2**31")
    lib = kernels.lib()
    out = torch.empty(size, dtype=torch.uint8, device=dev)
    tiles = lib.cra5_container_write_tiles(ne)
    scratch = torch.empty(1 + tiles, dtype=torch.int64, device=dev)  # the tiles' look-back
    kflags = K | (SORTED_FLAG | MERGED_FLAG if sorted_mode else 0)
    status = lib.cra5_container_write(
        states.data_ptr(), words.data_ptr(), escs.data_ptr(), safe.data_ptr(), n, kflags, K, nw,
        ne, scratch.data_ptr(), scratch.numel(), out.data_ptr(), kernels.raw_stream(dev.index))
    kernels.check(status, "container_write")
    kernels.count(container_write)
    return out


@kernels.counted
def container_read(image: torch.Tensor, K: int, nw: int, ne: int) -> Tuple[torch.Tensor, ...]:
    """K10: the arrays of a v2 container's byte image (``image`` (L,)
    uint8) whose header gave K lanes, ``nw`` words and ``ne`` escapes:
    (states (K,) int32 [u32], words (nw,) int16 [u16], escapes (ne,)
    int32), each in its own allocation. Escape r is read from the bytes
    after the r-th byte of the escape region with bit 7 clear, at most 5
    of them, as ``lane_coder.zigzag_varint_decode`` reads it. The caller
    checks that the region holds ``ne`` such bytes: past those K10 reads 0,
    and the CPU route raises as ``container_arrays`` does."""
    _require(image, "image", torch.uint8, 1)
    dev = _same_device(image)
    lay = container_layout(K, nw, ne)
    if not 1 <= K <= MAX_LANES or nw < 0 or ne < 0 or image.numel() < lay.escapes:
        raise ValueError(f"an image of {image.numel()} bytes holds no container of {K} lanes "
                         f"and {nw} words")
    if dev.type == "cpu":  # the plain version is the host's parser
        from .lane_coder import container_arrays

        arrays = container_arrays(image.numpy().tobytes(), (None, K, ne, nw))
        return tuple(torch.from_numpy(a) for a in arrays)
    if image.numel() >= 1 << 31:  # the kernel counts bytes in 32 bits
        raise ValueError(f"an image of {image.numel()} bytes exceeds the kernel's 2**31")
    if image.data_ptr() % 16:  # the escape region is read in 16-byte loads
        raise ValueError("image must start at a 16-byte aligned address")
    lib = kernels.lib()
    states = torch.empty(K, dtype=torch.int32, device=dev)
    words = torch.empty(nw, dtype=torch.int16, device=dev)
    escs = torch.empty(ne, dtype=torch.int32, device=dev)
    tiles = lib.cra5_container_read_tiles(image.numel(), lay.escapes, ne)
    scratch = torch.empty(1 + tiles, dtype=torch.int64, device=dev)  # the tiles' look-back
    status = lib.cra5_container_read(
        image.data_ptr(), image.numel(), K, nw, ne, scratch.data_ptr(), scratch.numel(),
        states.data_ptr(), words.data_ptr(), escs.data_ptr(), kernels.raw_stream(dev.index))
    kernels.check(status, "container_read")
    kernels.count(container_read)
    return states, words, escs
