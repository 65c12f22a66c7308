"""The arithmetic of the decode kernels K2/K3, on the CPU.

The kernels run only on the card; what they compute beyond the plain
decode is held here in plain PyTorch: the slot lookup (a slot table and a
binary search bounded by two slots) against ``searchsorted``, the launch
geometry for every lane count the CRX2 format allows, and the split of a
refilling lane's rank into its warp, block and cluster (or grid) parts
against the lane-order exclusive cumsum. All comparisons are exact."""

import numpy as np
import pytest
import torch

from cra5_tpu_torch.coder import rans_kernels as rk
from cra5_tpu_torch.coder.lane_coder import LaneCoder, padded_search_table, parse_v2_header
from cra5_tpu_torch.entropy import EntropyBottleneck, eb_update, gc_update, get_scale_table

LANE_COUNTS = [1, 96, 256, 1024, 2176, 8192, 16384, 32768, 2**20]


def _table(name):
    if name == "gc":
        return gc_update(get_scale_table())
    eb = EntropyBottleneck(256, device="cpu")
    eb.reset_parameters(torch.Generator().manual_seed(0))
    return eb_update(eb.params_numpy())


@pytest.mark.parametrize("name,max_span", [("gc", 16), ("eb", 2)])
def test_slot_lookup_equals_searchsorted_for_every_cum(name, max_span):
    """Every cum in [0, 2**16) on every row of the GC table (64 x 3133) and
    of a 256-channel EB table (256 x 23): the bounded search finds the
    searchsorted bin, and a slot's range spans at most ``max_span`` bins."""
    cdf = torch.from_numpy(padded_search_table(_table(name)))
    slots = rk.slot_table(cdf)
    bits = rk.slot_bits(cdf.shape[1])
    assert slots.dtype == torch.int16 and slots.shape == (cdf.shape[0], (1 << bits) + 8)
    assert cdf.shape[1] % 4 == 0  # 16-byte rows for the kernels' bulk copies
    assert bool((slots[:, (1 << bits):] == slots[:, (1 << bits), None]).all())  # the pad
    assert int((slots[:, 1:] - slots[:, :-1]).max()) <= max_span
    cum = torch.arange(1 << 16, dtype=torch.int32)
    for r0 in range(0, cdf.shape[0], 16):
        rows = torch.arange(r0, min(r0 + 16, cdf.shape[0]))
        got = rk.slot_search_plain(cdf, slots, rows.repeat_interleave(cum.numel()),
                                   cum.repeat(rows.numel()))
        queries = cum.expand(rows.numel(), -1).contiguous()
        want = torch.searchsorted(cdf[rows], queries, right=True) - 1
        assert torch.equal(got.reshape(rows.numel(), -1), want)


@pytest.mark.parametrize("K", LANE_COUNTS)
def test_decode_geometry_covers_every_lane_once(K):
    """Every lane in [0, K) belongs to exactly one (thread, slot), and the
    lanes of one slot are consecutive across the threads of a block (the
    stores coalesce); one lane a thread up to 8192 lanes, a cluster of at
    most 8 blocks up to 32768, a cooperative grid beyond."""
    geo = rk.decode_geometry(K)
    assert geo.threads % 32 == 0 and geo.threads <= 1024
    lanes = rk.geometry_lanes(geo, K)
    assert lanes.shape == (geo.blocks, geo.threads, geo.lanes_per_thread)
    valid = lanes[lanes >= 0]
    assert torch.equal(valid.sort().values, torch.arange(K))
    step = lanes[:, 1:] - lanes[:, :-1]
    both = (lanes[:, 1:] >= 0) & (lanes[:, :-1] >= 0)
    assert bool((step[both] == 1).all())
    assert geo.lanes_per_thread == 1 or K > 8192
    if K <= 32768:
        assert not geo.cooperative and geo.cluster == geo.blocks and geo.blocks in (1, 2, 4, 8)
    else:
        assert geo.cooperative and geo.cluster == 1 and geo.blocks <= 132


@pytest.mark.parametrize("K", [K for K in LANE_COUNTS if K <= 32768] + [2**20 - 1])
def test_refill_ranks_equal_the_lane_order_cumsum(K):
    """The rank a refilling lane gets from the warp ballot, the warp
    totals' scan and the block totals' exchange is its place among the
    step's refills in lane order, at refill densities 0, 0.3 and 1."""
    gen = torch.Generator().manual_seed(K)
    geo = rk.decode_geometry(K)
    for density in (0.0, 0.3, 1.0):
        refill = torch.rand(K, generator=gen) < density
        want = torch.cumsum(refill.long(), 0) - refill.long()
        assert torch.equal(rk.refill_ranks_plain(refill, geo)[refill], want[refill])


@pytest.mark.parametrize("K", [0, 2**20 + 1])
def test_decode_geometry_refuses_lane_counts_outside_the_format(K):
    with pytest.raises(ValueError, match="lanes"):
        rk.decode_geometry(K)


def test_sorted_stream_of_32768_lanes_roundtrips_on_the_cpu():
    """A sorted kernel-safe stream of 32768 lanes (above the 16384 the
    kernels once took), three steps on the GC table, decodes to its
    symbols, with the coder's slot table handed to the decode."""
    rng = np.random.default_rng(0)
    table = _table("gc")
    K = 32768
    idx = rng.integers(20, 23, 3 * K - 100).astype(np.int32)
    L = table.cdf_length[idx]
    sym = (rng.integers(0, 1 << 30, idx.size) % (L - 2) + table.offset[idx]).astype(np.int32)
    coder = LaneCoder(table, num_lanes=K, device="cpu")
    data = coder.encode(sym, idx)
    hdr = parse_v2_header(data)
    assert hdr[1] == K and hdr[4:6] == (True, True)
    assert torch.equal(coder._slots, rk.slot_table(coder._cdf))
    np.testing.assert_array_equal(coder.decode(data, idx), sym)


def test_decode_sync_probe_refuses_the_cpu():
    """The probe of the decode's per-step costs times CUDA kernels: on the
    CPU it raises before building anything."""
    from cra5_tpu_torch.profiling import decode_sync_probe

    with pytest.raises(RuntimeError, match="needs a card"):
        decode_sync_probe.main("cpu")
