"""Interleaved-lane rANS coder, container format v2 (CRX2).

Counterpart of ``cra5_tpu/coder/rans_tpu.py``. Given the same symbols,
indexes, lane count and flags it writes the same bytes as the JAX
``LaneCoder``, and it reads every stream that coder writes
(``docs/FORMATS.md`` section 3 is normative):

  - K lanes; symbol g goes to lane g % K at step g // K. Out-of-range
    symbols are coded as the top bin and their values ride a zigzag-varint
    side channel.
  - Sorted mode (header bits 31/29): symbols are coded in index order
    (stable by position) after tiny cdf buckets are merged into their
    nearest bucket of >= K symbols; bit 30 records the encoder's verdict
    that every step spans at most two cdf rows. Whether a new stream is
    sorted is the sorted-lanes mode's (``rans_kernels.set_sorted_lanes``,
    ``CRA5_TPU_SORTED_LANES``): under "auto", the default, the port sorts
    when K >= 2048 and K % 128 == 0, which is what the JAX package writes
    on its accelerator, on the CPU and on the card alike; "on" sorts
    whenever K % 128 == 0, "off" never.

Routing follows the format, not a chip: a sorted stream with bit 30 goes
to K3 (``rans_decode_sorted``); every other stream, the channel-broadcast
z stream included, goes to the lane decode K2 (``rans_decode_generic``,
the counterpart of the TPU's ``decode_scan_pallas`` and
``decode_rowplan_pallas``); encode always goes to K1 (``rans_encode``). On
the CPU those wrappers run their plain versions.

The container's bytes follow the coder's device too. On the card K9
(``container_write``) writes a stream's whole byte image, header, words
and escape varints, and K10 (``container_read``) splits an image back
into states, words and escapes, so each stream crosses between host and
card as one copy of its bytes; the host keeps the header checks
(``parse_v2_header``, the escape terminator count) and the copies into
and out of pinned memory. On the CPU the container is packed and parsed
by ``assemble_container`` and ``container_arrays``, the reference the
kernels are held to.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..entropy.cdf import CdfTable
from ..utils.profiling import span
from .rans_kernels import (
    KERNEL_SAFE_FLAG,
    MAGIC,
    MERGED_FLAG,
    SORTED_FLAG,
    container_layout,
    container_read,
    container_write,
    lane_decode_plain,
    rans_decode_generic,
    rans_decode_sorted,
    rans_decode_sorted_plain,
    rans_encode,
    slot_table,
    use_sorted_lanes,
)

PRECISION = 16
EMPTY_CONTAINER = struct.pack("<IIIII", MAGIC, 0, 1, 0, 0) + struct.pack("<I", 1 << 16)


def default_num_lanes(n_symbols: int) -> int:
    """Power of two targeting >= 512 symbols per lane up to 4096 lanes,
    then >= 320 symbols per lane up to 16384 (part of the format's
    defaults: the same n gives the same K in both packages)."""
    k = 1
    while k * 2 <= max(1, n_symbols // 512) and k < 4096:
        k *= 2
    if k == 4096:
        while k * 2 <= max(1, n_symbols // 320) and k < 16384:
            k *= 2
    return k


def padded_search_table(table: CdfTable) -> np.ndarray:
    """Rows padded with 2**16 beyond cdf_length, so that a search for
    cum < 2**16 never selects a padding bin, and widened to a multiple of 4
    entries (16-byte rows, which the decode kernels copy in bulk)."""
    cdf = table.quantized_cdf.astype(np.int32)
    cdf = np.pad(cdf, ((0, 0), (0, -cdf.shape[1] % 4)))
    cols = np.arange(cdf.shape[1])[None, :]
    return np.where(cols < table.cdf_length[:, None], cdf, 1 << PRECISION).astype(np.int32)


def zigzag_varint_encode(values: np.ndarray) -> bytes:
    """LEB128 varints of zigzag-mapped int32s (the escape side channel)."""
    if values.size == 0:
        return b""
    v = values.astype(np.int64)
    u = np.where(v >= 0, v << 1, ((-v - 1) << 1) | 1).astype(np.uint64)
    nbytes = np.ones(u.shape, np.int64)
    for k in range(1, 5):
        nbytes += (u >= (np.uint64(1) << np.uint64(7 * k))).astype(np.int64)
    out = np.zeros(int(nbytes.sum()), np.uint8)
    pos = np.concatenate([[0], np.cumsum(nbytes)[:-1]])
    for k in range(5):
        mask = nbytes > k
        if not mask.any():
            break
        byte = ((u[mask] >> np.uint64(7 * k)) & np.uint64(0x7F)).astype(np.uint8)
        cont = (nbytes[mask] > k + 1).astype(np.uint8)
        out[pos[mask] + k] = byte | (cont << 7)
    return out.tobytes()


def zigzag_varint_decode(data: bytes, count: int) -> np.ndarray:
    if count == 0:
        return np.zeros(0, np.int32)
    b = np.frombuffer(data, np.uint8)
    ends = np.flatnonzero((b & 0x80) == 0)
    if ends.size < count:
        raise ValueError("truncated escape side channel")
    ends = ends[:count]
    starts = np.concatenate([[0], ends[:-1] + 1])
    u = np.zeros(count, np.uint64)
    for k in range(5):
        idx = starts + k
        valid = idx <= ends
        if not valid.any():
            break
        u[valid] |= (b[idx[valid]].astype(np.uint64) & np.uint64(0x7F)) << np.uint64(7 * k)
    return np.where(
        u & np.uint64(1),
        -((u >> np.uint64(1)).astype(np.int64)) - 1,
        (u >> np.uint64(1)).astype(np.int64),
    ).astype(np.int32)


def assemble_container(n, K, nw, ne, sorted_mode, safe, states, stream, escs) -> bytes:
    """Pack a v2 container from host arrays: states (K,) u32, the first
    ``nw`` stream words (u16) and the first ``ne`` escape values."""
    kf = K
    if sorted_mode:
        kf |= SORTED_FLAG | MERGED_FLAG | (KERNEL_SAFE_FLAG if safe else 0)
    return b"".join([
        struct.pack("<IIIII", MAGIC, n, kf, ne, nw),
        np.asarray(states, np.uint32).astype("<u4").tobytes(),
        np.asarray(stream[:nw], np.uint16).astype("<u2").tobytes(),
        zigzag_varint_encode(np.asarray(escs[:ne], np.int32)),
    ])


def parse_v2_header(data: bytes):
    """Validate a v2 header. Returns (n, K, n_esc, n_words, sorted_mode,
    kernel_safe, merged); raises ValueError on any malformed field."""
    if len(data) < 20:
        raise ValueError("truncated CRX2 stream: missing header")
    magic, n, K, n_esc, n_words = struct.unpack_from("<IIIII", data, 0)
    if magic != MAGIC:
        raise ValueError("not a CRX2 (format v2) stream")
    sorted_mode = bool(K & SORTED_FLAG)
    kernel_safe = bool(K & KERNEL_SAFE_FLAG)
    merged = bool(K & MERGED_FLAG)
    K &= ~(SORTED_FLAG | KERNEL_SAFE_FLAG | MERGED_FLAG)
    if not 1 <= K <= (1 << 20):
        raise ValueError(f"implausible lane count K={K}")
    if n > (1 << 30) or n_esc > n + K:
        raise ValueError("implausible symbol/escape counts")
    need = 20 + 4 * K + 2 * n_words
    if len(data) < need:
        raise ValueError(f"truncated CRX2 stream: header promises {need} bytes, got {len(data)}")
    return n, K, n_esc, n_words, sorted_mode, kernel_safe, merged


def escape_terminators(data: bytes, offset: int) -> int:
    """How many bytes of ``data`` from ``offset`` on have bit 7 clear: the
    varints the escape region can end (a decoder needs n_esc of them)."""
    return int(np.count_nonzero(np.frombuffer(memoryview(data)[offset:], np.uint8) < 0x80))


def container_arrays(data: bytes, hdr):
    """The host arrays of a v2 container whose header ``parse_v2_header``
    read: the states (K,) int32, the stream words (n_words,) int16 and the
    escape values (n_esc,) int32, each a writable copy."""
    _, K, n_esc, n_words = hdr[:4]
    off = 20
    states = np.frombuffer(data, "<u4", K, off).view(np.int32).copy()
    off += 4 * K
    stream = np.frombuffer(data, "<u2", n_words, off).view(np.int16).copy()
    off += 2 * n_words
    return states, stream, zigzag_varint_decode(data[off:], n_esc)


def merge_tiny_buckets(idx_sorted: torch.Tensor, ncdfs: int, K: int) -> torch.Tensor:
    """Remap every cdf index holding fewer than K symbols to the nearest
    index holding >= K (ties toward the smaller index); the identity when
    no index reaches K. ``idx_sorted`` must be nondecreasing; the remap is
    monotone, so the result is too."""
    ids = torch.arange(ncdfs, dtype=torch.int64, device=idx_sorted.device)
    bounds = torch.searchsorted(idx_sorted.contiguous(), torch.arange(
        ncdfs + 1, dtype=idx_sorted.dtype, device=idx_sorted.device))
    valid = torch.diff(bounds) >= K
    dist = (ids[:, None] - ids[None, :]).abs()
    dist = torch.where(valid[None, :], dist, ncdfs + 1)
    nearest = torch.argmin(dist, dim=1)  # first minimum: ties go low
    remap = torch.where(valid | ~valid.any(), ids, nearest).to(idx_sorted.dtype)
    return remap[idx_sorted.long()]


def _sort_by_index(idx_flat: torch.Tensor):
    """The stable index sort both coder sides derive: unique int64 keys
    (index << pos_bits) | position."""
    n = idx_flat.numel()
    pos_bits = max((n - 1).bit_length(), 1)
    key = (idx_flat.to(torch.int64) << pos_bits) | torch.arange(n, device=idx_flat.device)
    skey, order = torch.sort(key)
    return (skey >> pos_bits).to(torch.int32), order


def sorted_rows(idx2: torch.Tensor):
    """(r0, r1, split) of a sorted (M, K) index grid: each step's first and
    last cdf row, and the first lane that uses the last row."""
    r1 = idx2[:, -1].contiguous()
    split = (idx2.shape[1] - (idx2 == r1[:, None]).sum(1)).to(torch.int32)
    return idx2[:, 0].contiguous(), r1, split


def _apply_escapes(values, sentinel, escs, n):
    """Replace the sentinel-coded positions of the first n values with the
    side-channel values, in order. Returns (values, sentinel count)."""
    values = values.reshape(-1)[:n]
    sentinel = sentinel.reshape(-1)[:n]
    rank = torch.cumsum(sentinel.to(torch.int64), 0) - 1
    if escs.numel():
        values = torch.where(sentinel, escs[rank.clamp(0, escs.numel() - 1)], values)
    return values, rank[-1] + 1


class LaneCoder:
    """Encode/decode int32 symbol tensors against a CdfTable with the
    interleaved-lane rANS (format v2), on ``device`` (default: the card).

    New streams are index-sorted as the sorted-lanes mode says (under
    "auto", when K >= 2048 and K % 128 == 0: the format default);
    ``sorted_lanes=True`` is "on" for this coder, sorting whenever K % 128
    == 0, which small streams such as the sorted golden need. Decoding
    does not depend on the mode: it routes by the header's bits."""

    def __init__(self, table: CdfTable, num_lanes: Optional[int] = None,
                 device=None, sorted_lanes: bool = False):
        self.device = resolve_device(device)
        self.table = table
        self.num_lanes = num_lanes
        self.sorted_lanes = sorted_lanes
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32), device=self.device)
        self._cdf = as_t(padded_search_table(table))
        self._slots = slot_table(self._cdf)  # the decode kernels' O(1) symbol lookup
        self._max_values = as_t(table.cdf_length - 2)
        self._offsets = as_t(table.offset)

    @property
    def num_indexes(self) -> int:
        return self.table.num_indexes

    def _sorted_ok(self, n: int, K: int) -> bool:
        pos_bits = max((n - 1).bit_length(), 1)
        idx_bits = max(int(self.num_indexes - 1).bit_length(), 1)
        if pos_bits + idx_bits > 31:
            return False
        return (self.sorted_lanes and K % 128 == 0) or use_sorted_lanes(K)

    # -- encode -----------------------------------------------------------
    def encode(self, symbols: np.ndarray, indexes: np.ndarray) -> bytes:
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32), device=self.device)
        return self.encode_finalize_many([self.encode_dispatch(as_t(symbols), as_t(indexes))])[0]

    def encode_from_device(self, symbols: torch.Tensor, indexes: torch.Tensor) -> bytes:
        """Encode int32 symbols and indexes that already lie on the coder's
        device: prep, K1 and compaction stay there, and only the compacted
        buffers cross to the host."""
        return self.encode_finalize_many([self.encode_dispatch(symbols, indexes)])[0]

    def encode_dispatch_batch(self, symbols: torch.Tensor, indexes: torch.Tensor) -> list:
        """One encode per sample of a (B, ...) batch."""
        return [self.encode_dispatch(symbols[b], indexes[b]) for b in range(symbols.shape[0])]

    def encode_dispatch(self, symbols: torch.Tensor, indexes: torch.Tensor):
        """Prep, K1 scan and compaction on the coder's device; returns a
        handle for ``encode_finalize_many`` (None for an empty tensor)."""
        grids = self.encode_grids(symbols, indexes)
        if grids is None:
            return None
        n, K, sort, starts, freqs, sym, escape, safe = grids
        states, emit, words = rans_encode(starts, freqs)
        # boolean selection keeps (step, lane) order: the stream layout
        return (n, K, sort, states, words[emit], sym[escape], safe)

    def encode_grids(self, symbols: torch.Tensor, indexes: torch.Tensor):
        """The encode prep: lane count, optional index sort and bucket
        merge, padding, escape mapping and the (M, K) start/frequency grids
        that K1 consumes. Returns (n, K, sorted, starts, freqs, padded
        symbols, escape mask, kernel-safe verdict), or None when empty."""
        sym = symbols.reshape(-1).to(self.device, torch.int32)
        idx = indexes.reshape(-1).to(self.device, torch.int32)
        n = sym.numel()
        if idx.numel() != n:
            raise ValueError(f"symbol count {n} != index count {idx.numel()}")
        if n == 0:
            return None
        K = self.num_lanes or default_num_lanes(n)
        M = -(-n // K)
        pad = M * K - n
        sort = self._sorted_ok(n, K)
        if sort:
            idx, order = _sort_by_index(idx)
            sym = sym[order]
            idx = merge_tiny_buckets(idx, self.num_indexes, K)
        if pad:
            # sorted streams pad with the last index so the grid stays
            # nondecreasing, unsorted ones with index 0; both at the
            # index's offset (bin 0)
            pidx = idx[n - 1:] if sort else torch.zeros(1, dtype=torch.int32, device=self.device)
            idx = torch.cat([idx, pidx.expand(pad)])
            sym = torch.cat([sym, self._offsets[pidx.long()].expand(pad)])
        il = idx.long()
        mv = self._max_values[il]
        v = sym - self._offsets[il]
        escape = (v < 0) | (v >= mv)
        bins = torch.where(escape, mv, v)
        cdf_flat = self._cdf.reshape(-1)
        pos = il * self._cdf.shape[1] + bins
        starts = cdf_flat[pos]
        freqs = cdf_flat[pos + 1] - starts
        idx2 = idx.reshape(M, K)
        safe = (
            (idx2[:, 1:] != idx2[:, :-1]).sum(1).max() <= 1 if sort
            else torch.zeros((), dtype=torch.bool, device=self.device)
        )
        return n, K, sort, starts.reshape(M, K), freqs.reshape(M, K), sym, escape, safe

    @staticmethod
    def encode_finalize_many(handles) -> List[bytes]:
        """Each dispatched encode's container as bytes. On the card, K9
        writes every image, each is copied into pinned memory, and one wait
        on the current stream of each device ends them all; on the CPU the
        compacted buffers are packed on the host."""
        out: List[Optional[bytes]] = [None] * len(handles)
        staged, streams = [], {}
        for i, h in enumerate(handles):
            if h is None:
                out[i] = EMPTY_CONTAINER
                continue
            n, K, sort, states, stream, escs, safe = h
            if states.device.type == "cuda":
                image = container_write(n, sort, states, stream, escs, safe)
                host = torch.empty(image.shape, dtype=torch.uint8, pin_memory=True)
                host.copy_(image, non_blocking=True)
                staged.append((i, stream.numel(), escs.numel(), host))
                streams.setdefault(states.device, torch.cuda.current_stream(states.device))
                continue
            states = states.numpy().view(np.uint32)
            stream = stream.numpy().view(np.uint16)
            escs = escs.numpy()
            safe = bool(safe)
            with span("coder/pack", words=stream.size, escapes=escs.size):  # host work alone
                out[i] = assemble_container(n, K, stream.size, escs.size, sort, safe,
                                            states, stream, escs)
        for s in streams.values():
            s.synchronize()
        for i, nw, ne, host in staged:
            image = host.numpy()
            with span("coder/pack", words=nw, escapes=ne):  # host work alone
                size = int(image[:8].view("<i8")[0])
                out[i] = image[8:8 + size].tobytes()
        return out

    # -- decode -----------------------------------------------------------
    def upload_batch(self, datas, n: Optional[int] = None):
        """Parse B containers and copy their buffers to the device now,
        before the caller's indexes exist."""
        return [self._upload(d, n=n) for d in datas]

    def _upload(self, data, hdr=None, n: Optional[int] = None):
        """A container's header (parsed unless given) and its arrays on
        the coder's device; raises unless the stream holds ``n`` symbols,
        where ``n`` is given. On the card the bytes cross once, through
        pinned memory, and K10 splits them; on the CPU the host parses."""
        data = _unwrap_bytes(data)
        if self.device.type != "cuda":
            with span("coder/parse", bytes=len(data)):  # host work alone
                hdr = self._check_header(data, hdr, n)
                arrays = container_arrays(data, hdr)
            return (hdr, *(torch.from_numpy(a) for a in arrays))
        host = torch.empty(len(data), dtype=torch.uint8, pin_memory=True)
        staging = host.numpy()
        with span("coder/parse", bytes=len(data)):  # host work alone
            hdr = self._check_header(data, hdr, n)
            _, K, n_esc, n_words = hdr[:4]
            at = container_layout(K, n_words, n_esc).escapes
            if n_esc and escape_terminators(data, at) < n_esc:
                raise ValueError("truncated escape side channel")
            staging[:] = np.frombuffer(data, np.uint8)
        image = torch.empty(len(data), dtype=torch.uint8, device=self.device)
        image.copy_(host, non_blocking=True)
        return (hdr, *container_read(image, K, n_words, n_esc))

    @staticmethod
    def _check_header(data, hdr, n: Optional[int]):
        hdr = parse_v2_header(data) if hdr is None else hdr
        if n is not None and hdr[0] != n:
            raise ValueError(f"symbol count mismatch: stream {hdr[0]}, indexes {n}")
        return hdr

    def decode_uploaded_batch(self, handle, indexes: torch.Tensor) -> torch.Tensor:
        """Decode the streams of ``upload_batch`` against (B, ...) indexes."""
        return torch.stack([self._decode(up, indexes[b])[0] for b, up in enumerate(handle)])

    def decode_batch_to_device(self, datas, indexes: torch.Tensor) -> torch.Tensor:
        """Decode B streams against (B, ...) indexes."""
        n = int(np.prod(indexes.shape[1:]))
        return self.decode_uploaded_batch(self.upload_batch(datas, n), indexes)

    def decode_to_device(self, data: bytes, indexes: torch.Tensor) -> torch.Tensor:
        return self._decode(self._upload(data), indexes)[0]

    def decode(self, data: bytes, indexes: np.ndarray) -> np.ndarray:
        """numpy-facing decode; also checks the escape count."""
        idx = torch.as_tensor(np.ascontiguousarray(indexes, np.int32), device=self.device)
        up = self._upload(data)
        out, n_sent = self._decode(up, idx)
        if int(n_sent) != up[0][2]:
            raise ValueError(
                f"escape count mismatch: decoded {int(n_sent)} sentinels, stream has {up[0][2]}"
            )
        return out.cpu().numpy()

    def _decode(self, up, indexes: torch.Tensor):
        n = up[0][0]
        indexes = indexes.to(self.device)
        if n != indexes.numel():
            raise ValueError(f"symbol count mismatch: stream {n}, indexes {tuple(indexes.shape)}")
        if n == 0:
            return torch.zeros(indexes.shape, dtype=torch.int32, device=self.device), 0
        kernel, _, args, perm = self.decode_call(up, indexes)
        values, sentinel = kernel(*args, self._slots)
        values, n_sent = _apply_escapes(values, sentinel, up[3], n)
        if perm is not None:
            values = torch.empty_like(values).index_copy_(0, perm, values)
        return values.reshape(indexes.shape), n_sent

    def decode_call(self, up, indexes: torch.Tensor):
        """The decode kernel an uploaded non-empty stream takes (K3
        ``rans_decode_sorted`` when it is sorted and kernel-safe, else K2
        ``rans_decode_generic``), that kernel's plain version, their
        common arguments (the table's slots apart) and the sort
        permutation (None for an unsorted stream)."""
        (n, K, _, _, sorted_mode, kernel_safe, merged), states, stream, _ = up
        M = -(-n // K)
        pad = M * K - n
        idx = indexes.reshape(-1).to(torch.int32)
        perm = None
        if sorted_mode:
            idx, perm = _sort_by_index(idx)
            if merged:
                idx = merge_tiny_buckets(idx, self.num_indexes, K)
            pidx = idx[n - 1:]
        else:
            pidx = torch.zeros(1, dtype=torch.int32, device=self.device)
        idx2 = torch.cat([idx, pidx.expand(pad)]).reshape(M, K) if pad else idx.reshape(M, K)
        tabs = (self._max_values, self._offsets)
        if sorted_mode and kernel_safe:
            return (rans_decode_sorted, rans_decode_sorted_plain,
                    (self._cdf, *sorted_rows(idx2), states, stream, *tabs), perm)
        return rans_decode_generic, lane_decode_plain, (self._cdf, idx2, states, stream, *tabs), perm


def _unwrap_bytes(s):
    """Accept both ``bytes`` and the ``[bytes]`` nesting."""
    if isinstance(s, (list, tuple)):
        return s[0]
    return s


def lane_encode(symbols, indexes, table: CdfTable, num_lanes: Optional[int] = None,
                device=None) -> bytes:
    """One v2 container of numpy ``symbols`` against ``table``'s rows
    ``indexes``."""
    return LaneCoder(table, num_lanes, device=device).encode(symbols, indexes)


def lane_decode(data: bytes, indexes, table: CdfTable, num_lanes: Optional[int] = None,
                device=None) -> np.ndarray:
    """The symbols of a v2 container, shaped like ``indexes``."""
    return LaneCoder(table, num_lanes, device=device).decode(data, indexes)
