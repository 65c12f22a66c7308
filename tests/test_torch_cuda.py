"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and takes the ``card`` fixture, which
skips when no NVIDIA card is present: the decision is made inside the
fixture, never at import time, so every pytest worker collects the same
tests. This file imports no JAX, and it uses no fixture of
``tests/conftest.py`` (which does), so on a machine with a card it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes are small and ragged (lane counts and sequence lengths off the
kernels' tile and block sizes). K1-K3, the generic lane decode, K7 and K8
must equal their plain versions exactly, K9 and K10 the host's container
code (``assemble_container``, ``container_arrays``) byte for byte; K4-K6
must agree within the bf16 and float32 tolerances stated below.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import _crx2_cases as crx2
from cra5_tpu_torch import kernels
from cra5_tpu_torch.coder import rans_kernels as rk
from cra5_tpu_torch.coder.lane_coder import (
    LaneCoder,
    _sort_by_index,
    assemble_container,
    merge_tiny_buckets,
    parse_v2_header,
    sorted_rows,
)
from cra5_tpu_torch.entropy import EntropyBottleneck, eb_update, gc_update, get_scale_table
from cra5_tpu_torch.entropy.cdf import CdfTable
from cra5_tpu_torch.utils.profiling import reset_span_totals, span_totals
from cra5_tpu_torch.profiling import perm_probe as pp
from cra5_tpu_torch.ops.attention import (
    anydim_supports,
    flash_attention,
    flash_attention_backward_dkv,
    flash_attention_backward_dkv_plain,
    flash_attention_backward_dq,
    flash_attention_backward_dq_plain,
    flash_attention_forward,
    flash_attention_plain,
)

pytestmark = pytest.mark.cuda

# K4: the kernel accumulates P V over 128-key tiles with a running maximum,
# the plain version over the whole row, and both round P to bf16 before
# the product. The size of out depends on the shape (an average of N rows
# of v: about sqrt(e / N) for unit logits), so its bound scales with the
# reference: max |out - ref| <= 2e-2 * max |ref|, a few bf16 ulps of the
# largest output. lse (f32) within the f32 summation-order noise of
# the row sums.
FLASH_OUT_RTOL = 2e-2
FLASH_LSE_ATOL = 2e-3
# K5/K6: dq, dk and dv are sums over N rows of bf16-rounded dS or P
# products; the kernels sum 64-query tiles in another order than the plain
# versions, and round dq/dk/dv to bf16 once. Each is bounded as out is:
# max |got - ref| <= 2e-2 * max |ref|.
FLASH_GRAD_RTOL = 2e-2
# K4-K6 with float32 operands against the float32 plain versions: no
# rounding point differs, only the order of float32 sums and the 3xTF32
# split products (hi hi + hi lo + lo hi, the lo lo term of ~2^-22 relative
# dropped; tests/test_torch_flash.py holds that arithmetic on the CPU). The
# plain versions sum in blocks (within 1.3e-6 x max |ref| of float64 for
# out, dq, dk and dv at N = 1000 and 10368 on the CPU); the kernels sum in
# another order, within 0.16-0.28 of the bound from them at N = 10368 on an
# H100. The bound is 1e-5 x max |ref|, and lse (|lse| < 10) within 1e-5.
FLASH_F32_RTOL = 1e-5
FLASH_F32_LSE_ATOL = 1e-5
# bf16 K4-K6 shapes: off and on the tile edges of the kernels (K4 takes 128
# queries a block and 128 keys a ring stage; K5 128 queries a block and 64
# keys a stage; K6 128 keys a block and 64 queries a stage), and several
# heads whose last tile is ragged, where a tile that read past its head's
# last row would take the next head's rows.
FLASH_BF16_SHAPES = [(1, 1, 1), (2, 3, 63), (1, 2, 65), (1, 2, 300), (2, 1, 1000),
                     (1, 2, 127), (1, 2, 128), (1, 2, 129), (1, 2, 255), (1, 2, 257),
                     (2, 3, 200)]

# float32 K4-K6 shapes: on and off the tile edges (K4: 128 queries a
# block, 64 keys a stage; K5: 64 queries a block, 32 keys a stage; K6: 64
# keys a block, 32 queries a stage; the two consumers of K5 and K6 take
# the stages in turn, so one, two and three stages each), ragged heads.
FLASH_F32_SHAPES = [(1, 1, 2), (1, 2, 31), (1, 2, 32), (1, 2, 33), (2, 3, 63), (1, 2, 64),
                    (1, 2, 65), (1, 2, 95), (1, 2, 96), (1, 2, 97), (1, 2, 300), (2, 1, 1000),
                    (1, 2, 127), (1, 2, 128), (1, 2, 129), (1, 2, 255), (1, 2, 257), (2, 3, 200)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    kernels.lib()  # build once; a build failure fails the test that asked
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="module")
def gc_table():
    return gc_update(get_scale_table())


@pytest.fixture(scope="module")
def eb_table():
    eb = EntropyBottleneck(16, device="cpu")
    eb.reset_parameters(torch.Generator().manual_seed(0))
    return eb_update(eb.params_numpy())


def _sample(rng, table, idx, escape_frac):
    """Symbols from each row's own pmf, plus far out-of-range escapes."""
    sym = np.empty(idx.size, np.int64)
    for r in np.unique(idx):
        m = idx == r
        L = int(table.cdf_length[r])
        u = rng.integers(0, 1 << 16, int(m.sum()))
        bins = np.searchsorted(table.quantized_cdf[r, :L], u, side="right") - 1
        sym[m] = np.minimum(bins, L - 3) + int(table.offset[r])
    esc = rng.random(idx.size) < escape_frac
    sym[esc] += rng.integers(50, 3000, int(esc.sum())) * rng.choice([-1, 1], int(esc.sum()))
    return sym.astype(np.int32)


def _equal(a, b):
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


# K1 runs blocks of 64 lanes (two consumer warps, a lane a thread) fed by a
# producer warp through a ring of 2 slots of 16 steps, the first chunk
# padded at its top with identity steps. Lane counts: 1, 96, 255 and 300
# end in a partial block, 256 fills 4 blocks, 257 and 4097 run one lane
# into a new block, 8192 and 32768 fill 128 and 512 blocks. Step counts: 1
# and 9 one padded chunk, 37 three chunks (the ring wraps), 64 four whole
# chunks (no pad), 65 five (15 pad steps), 130, 324 and 648 many turns of
# the ring with pads of 14, 12 and 8. And the freqs that bound its
# one-sided quotient: runs of 1 (every step emits, q = x), 2^16 - 1, and
# the padding step (start 0, freq 2^16, an identity).
@pytest.mark.parametrize("M,K,kind", [(1, 1, "random"), (37, 300, "random"), (9, 4097, "random"),
                                      (130, 96, "random"), (1, 255, "random"),
                                      (648, 257, "random"), (64, 8192, "random"),
                                      (9, 32768, "random"), (648, 256, "ones"),
                                      (65, 255, "edges"), (324, 8192, "padding")])
def test_rans_encode_equals_plain(card, rng, M, K, kind):
    freqs = rng.integers(1, 60000, (M, K))
    starts = rng.integers(0, 5000, (M, K))
    if kind == "ones":  # runs of freq 1 (the start < 2^16 - 1 as a real cdf's would be)
        freqs[rng.random((M, K)) < 0.5] = 1
    elif kind == "edges":
        freqs = rng.choice([1, 2, 3, 65494, 65535, 65536, 32768, 40503], (M, K))
        starts = rng.integers(0, 1 << 16, (M, K)) % (65537 - freqs)
    elif kind == "padding":  # identity steps, as the encoder pads the last rows
        pad = rng.random((M, K)) < 0.3
        freqs[pad], starts[pad] = 1 << 16, 0
    freqs = torch.from_numpy(freqs.astype(np.int32)).to(card)
    starts = torch.from_numpy(starts.astype(np.int32)).to(card)
    before = rk.rans_encode.launches
    got = rk.rans_encode(starts, freqs)
    want = rk.rans_encode_plain(starts, freqs)
    torch.cuda.synchronize()
    assert rk.rans_encode.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2][got[1]], want[2][want[1]])  # words where emitted


def test_rans_encode_counts_positions_past_2_31(card):
    # 2049 steps on the CRX2 header's 2^20 lanes: positions past 2^31 - 1
    M, K = 2049, 1 << 20
    gen = torch.Generator(device=card).manual_seed(0)
    freqs = torch.randint(1, 60000, (M, K), generator=gen, device=card, dtype=torch.int32)
    starts = torch.randint(0, 5000, (M, K), generator=gen, device=card, dtype=torch.int32)
    got = rk.rans_encode(starts, freqs)
    want = rk.rans_encode_plain(starts, freqs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # words where emitted
    assert torch.equal(torch.where(got[1], got[2], 0), torch.where(want[1], want[2], 0))


@pytest.mark.parametrize("C,HW,K,esc", [(16, 81, 32, 0.03), (7, 211, 96, 0.0), (16, 300, 1500, 0.05)])
def test_rans_decode_rowplan_equals_plain(card, rng, eb_table, C, HW, K, esc):
    table = CdfTable(eb_table.quantized_cdf[:C], eb_table.cdf_length[:C], eb_table.offset[:C])
    idx = np.repeat(np.arange(C, dtype=np.int32), HW)
    sym = _sample(rng, table, idx, esc)
    coder = LaneCoder(table, num_lanes=K, device=card)
    data = coder.encode(sym, idx)
    (n, _, _, _, srt, _, _), states, words, _ = coder._upload(data, parse_v2_header(data))
    assert not srt
    M = -(-n // K)
    idx2 = torch.from_numpy(np.concatenate([idx, np.zeros(M * K - n, np.int32)]).reshape(M, K)).to(card)
    args = (coder._cdf, idx2, states, words, coder._max_values, coder._offsets)
    before = rk.rans_decode_generic.launches
    got = rk.rans_decode_generic(*args)
    want = rk.lane_decode_plain(*args)
    torch.cuda.synchronize()
    assert _equal(got, want)
    np.testing.assert_array_equal(coder.decode(data, idx), sym)  # the coder routes to K2
    assert rk.rans_decode_generic.launches == before + 2


# K3 cases (K, steps, rows, escape share, empty word stream): whole and
# ragged clusters (2176 lanes: 4 blocks of 544 threads), one and two lanes a
# thread (8192, 16384), 40 steps over 26 rows of >= K symbols so the rows
# change every step, 30% escapes, and no words at all (every refill past
# the stream's end reads 0).
SORTED_CASES = [(2048, 5, 4, 0.01, False), (4096, 6, 4, 0.01, False), (8192, 4, 3, 0.01, False),
                (8192, 40, 26, 0.01, False), (16384, 40, 26, 0.01, False),
                (2176, 8, 4, 0.01, False), (8192, 6, 4, 0.3, False), (2048, 5, 4, 0.01, True)]


@pytest.mark.parametrize("K,steps,rows,esc,empty", SORTED_CASES)
def test_rans_decode_sorted_equals_plain(card, rng, gc_table, K, steps, rows, esc, empty):
    """GC table (max_len 3133), a ragged tail, escapes; the symbols fall
    mostly on a few rows of >= K symbols each, so the stream is
    kernel-safe, and a few on other rows, which get merged."""
    n = K * steps + 333
    idx = np.concatenate([rng.integers(20, 20 + rows, n - 40),
                          rng.integers(0, 64, 40)]).astype(np.int32)
    rng.shuffle(idx)
    sym = _sample(rng, gc_table, idx, esc)
    coder = LaneCoder(gc_table, num_lanes=K, device=card)
    data = coder.encode(sym, idx)
    hdr = parse_v2_header(data)
    assert hdr[4:7] == (True, True, True)
    _, states, words, _ = coder._upload(data, hdr)
    if empty:
        words = words[:0]
    M = -(-n // K)
    sidx, _ = _sort_by_index(torch.from_numpy(idx).to(card))
    sidx = merge_tiny_buckets(sidx, coder.num_indexes, K)
    idx2 = torch.cat([sidx, sidx[-1:].expand(M * K - n)]).reshape(M, K)
    args = (coder._cdf, *sorted_rows(idx2), states, words, coder._max_values, coder._offsets)
    before = rk.rans_decode_sorted.launches
    got = rk.rans_decode_sorted(*args)
    want = rk.rans_decode_sorted_plain(*args)
    torch.cuda.synchronize()
    assert rk.rans_decode_sorted.launches == before + 1
    assert _equal(got, want) and got[1].any()
    if not empty:
        np.testing.assert_array_equal(coder.decode(data, idx), sym)


@pytest.mark.parametrize("kernel", ["rowplan", "sorted"])  # rowplan: the lane decode K2
def test_decode_rejects_cdf_rows_outside_the_table(card, eb_table, kernel):
    """The wrapper raises on a row index past the table, and launches
    nothing: the kernels read rows unchecked."""
    coder = LaneCoder(eb_table, num_lanes=64, device=card)
    states = torch.full((64,), 1 << 16, dtype=torch.int32, device=card)
    words = torch.zeros(8, dtype=torch.int16, device=card)
    tabs = (coder._max_values, coder._offsets)
    fn = rk.rans_decode_generic if kernel == "rowplan" else rk.rans_decode_sorted
    before = fn.launches
    with pytest.raises(IndexError, match="16 rows"):
        if kernel == "rowplan":
            idx = torch.zeros((3, 64), dtype=torch.int32, device=card)
            idx[2, 63] = 16
            fn(coder._cdf, idx, states, words, *tabs)
        else:
            r = torch.tensor([0, 16], dtype=torch.int32, device=card)
            split = torch.tensor([10, 0], dtype=torch.int32, device=card)
            fn(coder._cdf, r, r.clone(), split, states, words, *tabs)
    assert fn.launches == before


@pytest.mark.parametrize("B,H,N", FLASH_BF16_SHAPES)
def test_flash_attn_fwd_close_to_plain(card, rng, B, H, N):
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, N, 64), np.float32) * 1.5)
               .to(card, torch.bfloat16) for _ in range(3))
    out, lse = flash_attention_forward(q, k, v, 0.125)
    ref, ref_lse = flash_attention_plain(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    bound = FLASH_OUT_RTOL * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= bound
    assert (lse - ref_lse).abs().max().item() <= FLASH_LSE_ATOL


def test_flash_attn_fwd_is_deterministic(card, rng):
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 777, 64), np.float32))
               .to(card, torch.bfloat16) for _ in range(3))
    a = flash_attention_forward(q, k, v)
    b = flash_attention_forward(q, k, v)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "z_grid"])
def test_lane_coder_bytes_do_not_depend_on_the_device(card, rng, gc_table, eb_table, kind):
    """The card writes the CPU's bytes, and each decodes the other's."""
    if kind == "z_grid":
        table, idx, K = eb_table, np.repeat(np.arange(16, dtype=np.int32), 96), 32
    else:  # sorted: three rows of >= K symbols each, so kernel-safe
        table = gc_table
        idx = rng.integers(20, 23, 2048 * 6 + 100) if kind == "sorted" else rng.integers(0, 64, 3000)
        idx, K = idx.astype(np.int32), 2048 if kind == "sorted" else 512
    sym = _sample(rng, table, idx, 0.02)
    gpu = LaneCoder(table, num_lanes=K, device=card)
    cpu = LaneCoder(table, num_lanes=K, device="cpu")
    data = gpu.encode(sym, idx)
    assert data == cpu.encode(sym, idx)
    np.testing.assert_array_equal(cpu.decode(data, idx), sym)
    before = rk.rans_decode_generic.launches
    np.testing.assert_array_equal(gpu.decode(data, idx), sym)
    assert rk.rans_decode_generic.launches == before + (kind != "sorted")


def test_tiny_codec_on_the_card_writes_the_cpu_bytes(card):
    """vaeformer_tiny in float32 with the same seeded weights: the card's
    streams equal the CPU's, and the card decodes the z stream and the
    tiny y stream (128 symbols on one lane, unsorted) through the lane
    decode K2, to the CPU's symbols and x_hat."""
    from cra5_tpu_torch.models.vaeformer import VAEformer, VAEformerCodec, vaeformer_tiny

    cfg = vaeformer_tiny()
    gpu = VAEformer(cfg, device=card).reset_parameters(0)
    cpu = VAEformer(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    x = np.random.default_rng(0).standard_normal((1, cfg.in_chans, *cfg.img_size), np.float32)
    a, b = VAEformerCodec(gpu), VAEformerCodec(cpu)
    out = a.compress(x)
    assert out["strings"] == b.compress(x)["strings"]
    z_shape = (1, cfg.z_channels, *out["z_shape"])
    before = rk.rans_decode_generic.launches
    z_gpu = a._eb_coder.decode_batch_to_device(out["strings"][1], a._channel_indexes(z_shape))
    assert rk.rans_decode_generic.launches == before + 1
    z_cpu = b._eb_coder.decode_batch_to_device(out["strings"][1], b._channel_indexes(z_shape))
    assert torch.equal(z_gpu.cpu(), z_cpu)
    before = rk.rans_decode_generic.launches
    x_gpu = a.decompress(out["strings"], out["z_shape"])["x_hat"]
    assert rk.rans_decode_generic.launches == before + 2
    x_hat = b.decompress(out["strings"], out["z_shape"])["x_hat"]
    assert tuple(x_hat.shape) == (1, cfg.in_chans, *cfg.img_size) and torch.isfinite(x_hat).all()
    assert (x_gpu.cpu() - x_hat).abs().max().item() <= 1e-4


# K2 cases (M, K, rows, escape share, empty word stream): one lane, a
# ragged block, one lane a thread on a cluster of 8 and two on 8 (written
# unsorted), a ragged cluster (2175 lanes), 30% escapes, no words at all.
GENERIC_CASES = [(1, 1, 64, 0.02, False), (128, 1, 64, 0.02, False), (37, 300, 64, 0.02, False),
                 (9, 4097, 64, 0.02, False), (40, 8192, 64, 0.02, False),
                 (40, 16384, 64, 0.02, False), (9, 2175, 64, 0.02, False),
                 (37, 300, 64, 0.3, False), (37, 300, 64, 0.02, True)]


@pytest.mark.parametrize("M,K,ncdf,esc,empty", GENERIC_CASES)
def test_rans_decode_generic_equals_plain(card, rng, gc_table, M, K, ncdf, esc, empty):
    """Random cdf rows per symbol (no row plan, unsorted, a row change at
    every step): the generic decode equals the plain per-lane decode
    exactly, and the coder routes such a stream to it."""
    n = M * K - (K // 3)
    idx = rng.integers(0, ncdf, max(n, 1)).astype(np.int32)
    sym = _sample(rng, gc_table, idx, esc)
    coder = LaneCoder(gc_table, num_lanes=K, device=card)
    coder._sorted_ok = lambda n, K: False  # unsorted at every K
    data = coder.encode(sym, idx)
    (n, _, _, _, srt, _, _), states, words, _ = coder._upload(data, parse_v2_header(data))
    assert not srt
    if empty:
        words = words[:0]
    Ms = -(-n // K)
    idx2 = torch.from_numpy(np.concatenate([idx, np.zeros(Ms * K - n, np.int32)]).reshape(Ms, K)).to(card)
    args = (coder._cdf, idx2, states, words, coder._max_values, coder._offsets)
    before = rk.rans_decode_generic.launches
    got = rk.rans_decode_generic(*args)
    want = rk.lane_decode_plain(*args)
    torch.cuda.synchronize()
    assert rk.rans_decode_generic.launches == before + 1
    assert _equal(got, want)
    if not empty:
        np.testing.assert_array_equal(coder.decode(data, idx), sym)
        assert rk.rans_decode_generic.launches == before + 2


@pytest.mark.parametrize("kind", ["sorted_32768", "unsorted_2^20-1"])
def test_lane_coder_decodes_more_than_16384_lanes_on_the_card(card, rng, gc_table, eb_table, kind):
    """Streams beyond the 16384 lanes one block held: 32768 lanes sorted
    on the GC table (K3 on a cluster of 8 blocks, 4 lanes a thread) and
    2**20 - 1 lanes unsorted on the EB table (K2 on a cooperative grid, 8
    lanes a thread), three steps each, encoded on the card; the card
    decodes them to the symbols the CPU's LaneCoder decodes."""
    if kind.startswith("sorted"):
        table, K, fn = gc_table, 32768, rk.rans_decode_sorted
        idx = rng.integers(20, 23, 3 * K - 100).astype(np.int32)
    else:
        table, K, fn = eb_table, 2**20 - 1, rk.rans_decode_generic
        idx = rng.integers(0, 16, 3 * K - 5).astype(np.int32)
    sym = _sample(rng, table, idx, 0.01)
    gpu = LaneCoder(table, num_lanes=K, device=card)
    cpu = LaneCoder(table, num_lanes=K, device="cpu")
    data = gpu.encode(sym, idx)
    hdr = parse_v2_header(data)
    assert hdr[1] == K and hdr[4:6] == ((True, True) if kind.startswith("sorted") else (False, False))
    before = fn.launches
    got = gpu.decode(data, idx)
    assert fn.launches == before + 1
    want = cpu.decode(data, idx)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sym)


def _grad_operands(rng, card, B, H, N):
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, N, 64), np.float32) * 1.5)
                   .to(card, torch.bfloat16) for _ in range(4))
    out, lse = flash_attention_forward(q, k, v, 0.125)
    delta = (do.float() * out.float()).sum(-1)
    return q, k, v, do, lse, delta


def _close(got, ref):
    bound = FLASH_GRAD_RTOL * ref.float().abs().max().item()
    return got.dtype == ref.dtype and (got.float() - ref.float()).abs().max().item() <= bound


@pytest.mark.parametrize("B,H,N", FLASH_BF16_SHAPES)
def test_flash_attn_bwd_close_to_plain(card, rng, B, H, N):
    ops = _grad_operands(rng, card, B, H, N)
    before = (flash_attention_backward_dq.launches, flash_attention_backward_dkv.launches)
    dq = flash_attention_backward_dq(*ops, 0.125)
    dk, dv = flash_attention_backward_dkv(*ops, 0.125)
    torch.cuda.synchronize()
    assert (flash_attention_backward_dq.launches,
            flash_attention_backward_dkv.launches) == (before[0] + 1, before[1] + 1)
    ref_dq = flash_attention_backward_dq_plain(*ops, 0.125)
    ref_dk, ref_dv = flash_attention_backward_dkv_plain(*ops, 0.125)
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert torch.isfinite(got).all() and _close(got, ref)


def test_flash_attn_bwd_is_deterministic(card, rng):
    ops = _grad_operands(rng, card, 1, 2, 777)
    a = (flash_attention_backward_dq(*ops, 0.125), *flash_attention_backward_dkv(*ops, 0.125))
    b = (flash_attention_backward_dq(*ops, 0.125), *flash_attention_backward_dkv(*ops, 0.125))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_attn_bwd_dq_is_deterministic_at_a_tile_edge(card, rng):
    """K5 at N = 129: a last query block of one row and a last key stage of
    one key; each block owns its dQ rows, so two calls are bitwise equal."""
    ops = _grad_operands(rng, card, 2, 3, 129)
    a = flash_attention_backward_dq(*ops, 0.125)
    b = flash_attention_backward_dq(*ops, 0.125)
    assert torch.isfinite(a).all() and torch.equal(a, b)


def test_flash_attention_gradients_on_the_card_match_the_plain_path(card, rng):
    """autograd through FlashAttention (K4, K5, K6) against the same
    Function on the CPU (the plain versions), same bf16 inputs."""
    base = [torch.from_numpy(rng.standard_normal((1, 2, 333, 64), np.float32))
            .to(torch.bfloat16) for _ in range(3)]
    w = torch.from_numpy(rng.standard_normal((1, 2, 333, 64), np.float32)).to(torch.bfloat16)
    grads = {}
    for dev in (card, torch.device("cpu")):
        qkv = [t.to(dev).requires_grad_() for t in base]
        out = flash_attention(*qkv)
        (out.float() * w.to(dev).float()).sum().backward()
        grads[dev.type] = [out.detach().cpu()] + [t.grad.cpu() for t in qkv]
    for got, ref in zip(grads["cuda"], grads["cpu"]):
        assert _close(got, ref)


@pytest.mark.parametrize("B,H,N", FLASH_F32_SHAPES)
def test_flash_attn_f32_close_to_plain(card, rng, B, H, N):
    """K4, K5 and K6 on float32 operands (3xTF32 on the tensor cores)
    against the float32 plain versions, on and off the kernels' tile edges
    and with ragged heads. N = 1 is left out: with one key dS = dP - delta
    is zero but for rounding, so dk is rounding noise on both sides and no
    bound relative to it holds."""
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, N, 64), np.float32) * 1.5)
                   .to(card) for _ in range(4))
    before = tuple(f.launches for f in (flash_attention_forward, flash_attention_backward_dq,
                                        flash_attention_backward_dkv))
    out, lse = flash_attention_forward(q, k, v, 0.125)
    ref, ref_lse = flash_attention_plain(q, k, v, 0.125)
    delta = (do * ref).sum(-1)
    ops = (q, k, v, do, ref_lse, delta, 0.125)
    dq = flash_attention_backward_dq(*ops)
    dk, dv = flash_attention_backward_dkv(*ops)
    torch.cuda.synchronize()
    after = tuple(f.launches for f in (flash_attention_forward, flash_attention_backward_dq,
                                       flash_attention_backward_dkv))
    assert after == tuple(b + 1 for b in before)
    assert (lse - ref_lse).abs().max().item() <= FLASH_F32_LSE_ATOL
    pairs = [(out, ref), (dq, flash_attention_backward_dq_plain(*ops)),
             *zip((dk, dv), flash_attention_backward_dkv_plain(*ops))]
    for got, want in pairs:
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        bound = FLASH_F32_RTOL * want.abs().max().item()
        assert (got - want).abs().max().item() <= bound


def test_flash_attn_f32_fwd_is_deterministic(card, rng):
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 777, 64), np.float32)).to(card)
               for _ in range(3))
    a = flash_attention_forward(q, k, v)
    b = flash_attention_forward(q, k, v)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("N", [97, 777])
def test_flash_attn_f32_bwd_is_deterministic(card, rng, N):
    """The float32 K5 and K6: each block owns its rows and its two
    consumers add their sums in one order, so two calls give equal bits."""
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 3, N, 64), np.float32)).to(card)
                   for _ in range(4))
    out, lse = flash_attention_forward(q, k, v, 0.125)
    ops = (q, k, v, do, lse, (do * out).sum(-1), 0.125)
    a = (flash_attention_backward_dq(*ops), *flash_attention_backward_dkv(*ops))
    b = (flash_attention_backward_dq(*ops), *flash_attention_backward_dkv(*ops))
    assert all(torch.isfinite(x).all() and torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_with_head_dim_72_computes_on_the_card(card, rng, dtype):
    """A global Attention of head dim 72 (the 268v hyperprior's) at N =
    2048, where the JAX package takes its Pallas kernels: it takes the
    flash route on the card (the any-head-dim tensor-core K4 and K6, the
    SIMT K5) once each. In float32 it matches the same module on the CPU,
    output and input gradient within FLASH_F32_RTOL x max |ref|; in bf16
    the same module on the card with attention on the plain path (matmul
    and softmax, which rounds elsewhere than the kernels), within
    FLASH_GRAD_RTOL x max |ref|."""
    from cra5_tpu_torch.device import resolve_device
    from cra5_tpu_torch.nn import blocks

    resolve_device(card)  # float32 matmuls in full float32
    gen = torch.Generator().manual_seed(0)
    cpu = blocks.Attention(144, 2, dtype=dtype, device="cpu")
    cpu.reset_parameters(gen)
    gpu = blocks.Attention(144, 2, dtype=dtype, device=card)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(rng.standard_normal((1, 2048, 144), np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((1, 2048, 144), np.float32)).to(dtype)
    flash = ("cuda", gpu, card, blocks._use_flash)
    ref = (("cpu", cpu, torch.device("cpu"), blocks._use_flash) if dtype == torch.float32
           else ("plain", gpu, card, lambda *a: False))
    got, counts = {}, None
    use_flash = blocks._use_flash
    for name, mod, dev, route in (flash, ref):
        kernels.reset_launch_counts()
        blocks._use_flash = route
        try:
            xg = x.to(dev).requires_grad_()
            y = mod(xg, 32, 64)
            (y.float() * w.to(dev).float()).sum().backward()
        finally:
            blocks._use_flash = use_flash
        got[name] = (y.detach().float().cpu(), xg.grad.float().cpu())
        counts = counts or kernels.launch_counts()
    assert [counts[k] for k in ("flash_attention_forward", "flash_attention_backward_dq",
                                "flash_attention_backward_dkv")] == [1, 1, 1]
    rtol = FLASH_F32_RTOL if dtype == torch.float32 else FLASH_GRAD_RTOL
    for a, want in zip(got["cuda"], got[ref[0]]):
        assert torch.isfinite(a).all()
        assert (a - want).abs().max().item() <= rtol * want.abs().max().item()


# Every head dim and dtype but head dim 64 in bf16 and float32: the
# any-head-dim tensor-core K4, K5 and K6 (csrc/flash_attn_anydim*.cu: bf16
# and float16 rows of a multiple of 8 up to 128 in 64-column boxes, float32
# rows of a multiple of 4 up to 96 in 32-column boxes; K4 takes 128 queries a
# block and 64 keys (16-bit) or 32 keys (float32) a stage, K6 128 keys (64
# past head dim 64) and 32 queries (16-bit) or 64 keys and 16 queries
# (float32), K5 128 queries and 64 keys (32 past 80 columns) in 16-bit, 64
# queries and 32 keys (16 past 80) in float32, with a 16-float tail box at
# 65-80), on and off those edges (N = 2, 31-33, 63-65, 127-129; at N = 1 dq
# is zero, so its bound would hold rounding noise to itself) and with
# ragged heads, up to the top of their reach; and the SIMT kernels
# (csrc/flash_attn_any.cu) for what the tensor-core ones do not take: 12-byte
# rows, float32 past 96, every head dim past 128, float64. Bounds as for the
# kernels of the same width (float16 as bf16); float64 sums in another order
# than the plain version only.
FLASH_ANY_CASES = [(torch.float32, 72, 1, 2, 333), (torch.bfloat16, 72, 2, 3, 129),
                   (torch.float16, 64, 1, 2, 200), (torch.float32, 40, 2, 1, 65),
                   (torch.float32, 8, 1, 2, 64), (torch.float32, 129, 1, 2, 100),
                   (torch.bfloat16, 256, 1, 1, 77), (torch.float64, 72, 1, 2, 150),
                   (torch.float64, 256, 1, 1, 33),
                   (torch.bfloat16, 8, 1, 2, 65), (torch.bfloat16, 16, 2, 3, 200),
                   (torch.float32, 16, 1, 2, 63), (torch.bfloat16, 40, 1, 2, 127),
                   (torch.bfloat16, 72, 2, 3, 200), (torch.float32, 72, 2, 3, 200),
                   (torch.float16, 72, 1, 2, 128), (torch.float32, 72, 1, 1, 64),
                   (torch.bfloat16, 80, 1, 2, 64), (torch.float32, 80, 1, 2, 129),
                   (torch.bfloat16, 96, 1, 2, 63), (torch.float32, 96, 1, 2, 127),
                   (torch.bfloat16, 120, 1, 2, 128), (torch.float32, 68, 1, 2, 65),
                   (torch.bfloat16, 128, 1, 2, 129), (torch.float16, 128, 1, 1, 65),
                   (torch.float32, 4, 1, 2, 33), (torch.float32, 120, 1, 1, 65),
                   (torch.bfloat16, 6, 1, 2, 65),
                   (torch.bfloat16, 72, 1, 2, 127), (torch.float16, 80, 1, 2, 129),
                   (torch.bfloat16, 88, 1, 2, 65), (torch.bfloat16, 128, 2, 3, 200),
                   (torch.float16, 32, 1, 2, 64), (torch.bfloat16, 24, 1, 1, 31),
                   (torch.float32, 72, 1, 2, 65), (torch.float32, 76, 1, 2, 63),
                   (torch.float32, 92, 1, 2, 33), (torch.float32, 96, 2, 3, 200),
                   (torch.float32, 48, 1, 2, 97), (torch.float32, 84, 1, 2, 17),
                   (torch.float32, 72, 1, 1, 2), (torch.bfloat16, 104, 1, 1, 2)]
FLASH_ANY_TOL = {torch.bfloat16: (FLASH_GRAD_RTOL, FLASH_LSE_ATOL),
                 torch.float16: (FLASH_GRAD_RTOL, FLASH_LSE_ATOL),
                 torch.float32: (FLASH_F32_RTOL, FLASH_F32_LSE_ATOL),
                 torch.float64: (1e-12, 1e-12)}


@pytest.mark.parametrize("dtype,D,B,H,N", FLASH_ANY_CASES)
def test_flash_attn_any_head_dim_close_to_plain(card, rng, dtype, D, B, H, N):
    """K4, K5 and K6 at another head dim or dtype than the head-dim-64
    kernels take, against the plain versions, and bitwise equal over two
    calls."""
    _check_any_head_dim(card, rng, dtype, D, B, H, N)


# Head dims past 256 (ROADMAP C5): the SIMT kernels walk the head dim in
# 256-column chunks, one chunk of the output a block (a second, partly
# filled chunk at 320, a third at 520); N = 257 crosses the walked tile's
# edge (16 rows in 32-bit, 8 in float64). Bounds as for the SIMT cases
# above.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
@pytest.mark.parametrize("D", [320, 520])
def test_flash_attn_past_256_head_dims_close_to_plain(card, rng, dtype, D):
    assert not anydim_supports(dtype, D)
    _check_any_head_dim(card, rng, dtype, D, 1, 2, 257)


def _check_any_head_dim(card, rng, dtype, D, B, H, N):
    rtol, lse_atol = FLASH_ANY_TOL[dtype]
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, N, D)) * 1.5).to(card, dtype)
                   for _ in range(4))
    scale = D ** -0.5
    wrappers = (flash_attention_forward, flash_attention_backward_dq, flash_attention_backward_dkv)
    before = tuple(f.launches for f in wrappers)
    out, lse = flash_attention_forward(q, k, v, scale)
    ref, ref_lse = flash_attention_plain(q, k, v, scale)
    delta = (do.to(lse.dtype) * ref.to(lse.dtype)).sum(-1)
    ops = (q, k, v, do, ref_lse, delta, scale)
    dq = flash_attention_backward_dq(*ops)
    dk, dv = flash_attention_backward_dkv(*ops)
    torch.cuda.synchronize()
    assert tuple(f.launches for f in wrappers) == tuple(b + 1 for b in before)
    assert lse.dtype == ref_lse.dtype and (lse - ref_lse).abs().max().item() <= lse_atol
    pairs = [(out, ref), (dq, flash_attention_backward_dq_plain(*ops)),
             *zip((dk, dv), flash_attention_backward_dkv_plain(*ops))]
    for got, want in pairs:
        assert got.dtype == dtype and torch.isfinite(got).all()
        bound = rtol * want.double().abs().max().item()
        assert (got.double() - want.double()).abs().max().item() <= bound
    again = (*flash_attention_forward(q, k, v, scale), flash_attention_backward_dq(*ops),
             *flash_attention_backward_dkv(*ops))
    assert all(torch.equal(a, b) for a, b in zip((out, lse, dq, dk, dv), again))


def test_268v_global_block_f32_through_flash_matches_the_plain_path(card):
    """One global block of the 268v towers in float32 (N = 72 x 144 = 10368
    tokens, width 1024, 16 heads), the default dtype of VAEformer and
    cra5_api: its output and the gradients of its input, qkv and proj
    through FlashAttention (K4, K5, K6 on float32) against the same block
    with attention on the plain path, each within FLASH_F32_RTOL x max
    |ref|. The float32 kernels raised NotImplementedError before they
    existed, so VAEformer(vaeformer_268()) could not run on the card."""
    from cra5_tpu_torch.models.vaeformer import vaeformer_268
    from cra5_tpu_torch.nn import blocks

    cfg = vaeformer_268()
    Hp, Wp = cfg.latent_grid
    gen = torch.Generator(device=card).manual_seed(0)
    blk = blocks.Block(cfg.y_channels, cfg.num_heads, layer_id=cfg.interval - 1, device=card)
    for m in blk.modules():
        if m is not blk and hasattr(m, "reset_parameters") and not isinstance(m, torch.nn.Linear):
            m.reset_parameters(gen)
    x = torch.randn((1, Hp * Wp, cfg.y_channels), generator=gen, device=card)
    w = torch.randn(x.shape, generator=gen, device=card)
    watch = ("attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight")
    got = {}
    use_flash = blocks._use_flash
    for route in ("flash", "plain"):
        if route == "plain":
            blocks._use_flash = lambda *a: False
        try:
            kernels.reset_launch_counts()
            blk.zero_grad(set_to_none=True)
            xg = x.clone().requires_grad_()
            y = blk(xg, Hp, Wp)
            (y * w).sum().backward()
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
        finally:
            blocks._use_flash = use_flash
        params = dict(blk.named_parameters())
        got[route] = {"y": y.detach(), "x": xg.grad, **{k: params[k].grad for k in watch}}
        want = (1, 1, 1) if route == "flash" else (0, 0, 0)
        assert tuple(launches[k] for k in ("flash_attention_forward", "flash_attention_backward_dq",
                                           "flash_attention_backward_dkv")) == want
    for key, ref in got["plain"].items():
        out = got["flash"][key]
        assert out.dtype == torch.float32 and torch.isfinite(out).all(), key
        assert (out - ref).abs().max().item() <= FLASH_F32_RTOL * ref.abs().max().item(), key


@pytest.mark.parametrize("R,Kd,density", [(8, 1024, 0.0), (8, 1024, 0.6), (8, 1024, 1.0),
                                          (16, 1024, 0.6), (3, 32, 0.5), (1, 64, 0.3),
                                          (16, 1024, 0.0), (16, 1024, 1.0), (1, 16384, 0.6),
                                          (5, 2, 0.5), (3, 1, 1.0)])
def test_expand_equals_plain(card, rng, R, Kd, density):
    """K7 in one block: (16, 1024) and (1, 16384) take 16 positions a
    thread and 96 KiB of dynamic shared memory, (3, 32) and (1, 64) fewer
    than 1024 threads, (5, 2) and (3, 1) a K that is not a multiple of 4
    (the kernel's scalar loads and stores)."""
    mask = torch.from_numpy((rng.random((R, Kd)) < density).astype(np.int32)).to(card)
    words = torch.from_numpy(rng.integers(0, 1 << 16, (R, Kd)).astype(np.int32)).to(card)
    before = pp.expand.launches
    got = pp.expand(mask, words)
    torch.cuda.synchronize()
    assert pp.expand.launches == before + 1
    assert torch.equal(got, pp.expand_plain(mask, words))


@pytest.mark.parametrize("shape", [(8, 1024), (3, 100)])
@pytest.mark.parametrize("shift", [0, 3, 1023, 1024, 5000, -3, -1025, 2047])
def test_dynroll_equals_plain(card, rng, shape, shift):
    x = torch.from_numpy(rng.integers(0, 1 << 16, shape).astype(np.int32)).to(card)
    s = torch.tensor([shift], dtype=torch.int32, device=card)
    before = pp.dynroll.launches
    got = pp.dynroll(x, s)
    torch.cuda.synchronize()
    assert pp.dynroll.launches == before + 1
    assert torch.equal(got, pp.dynroll_plain(x, s))


def test_raw_stream_is_the_current_stream(card):
    """The launch path's stream lookup gives the handle of
    torch.cuda.current_stream(), outside and inside a stream context."""
    index = card.index
    assert kernels.raw_stream(index) == torch.cuda.current_stream().cuda_stream
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        assert kernels.raw_stream(index) == torch.cuda.current_stream().cuda_stream == s.cuda_stream
    assert kernels.raw_stream(index) == torch.cuda.current_stream().cuda_stream != s.cuda_stream


def _side_stream_case(name, rng, card, gc_table):
    """(wrapper, args, late, same): the test fills args[late] late on the
    default stream; same(got, want) compares two results of the wrapper."""
    t = lambda a: torch.from_numpy(a).to(card)
    exact = lambda a, b: _equal(a, b) if isinstance(a, tuple) else torch.equal(a, b)
    if name in ("expand", "dynroll"):
        words = t(rng.integers(1, 1 << 16, (8, 1024)).astype(np.int32))
        if name == "expand":
            return pp.expand, (t((rng.random((8, 1024)) < 0.6).astype(np.int32)), words), 1, exact
        return pp.dynroll, (words, torch.tensor([3], dtype=torch.int32, device=card)), 0, exact
    if name == "rans_encode":
        freqs = t(rng.integers(1, 60000, (37, 300)).astype(np.int32))
        starts = t(rng.integers(1, 5000, (37, 300)).astype(np.int32))
        same = lambda a, b: (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                             and torch.equal(a[2][a[1]], b[2][b[1]]))  # words where emitted
        return rk.rans_encode, (starts, freqs), 0, same
    if name in ("rans_decode_generic", "rans_decode_sorted"):
        K, n = 2048, 2048 * 5
        idx = rng.integers(20, 24, n).astype(np.int32)
        coder = LaneCoder(gc_table, num_lanes=K, device=card)
        if name == "rans_decode_generic":
            coder._sorted_ok = lambda n, K: False
        data = coder.encode(_sample(rng, gc_table, idx, 0.01), idx)
        hdr = parse_v2_header(data)
        _, states, words, _ = coder._upload(data, hdr)
        assert hdr[4] == hdr[5] == (name == "rans_decode_sorted")  # sorted and kernel-safe
        if name == "rans_decode_sorted":
            sidx = merge_tiny_buckets(_sort_by_index(t(idx))[0], coder.num_indexes, K)
            rows = sorted_rows(sidx.reshape(-1, K))
        else:
            rows = (t(idx).reshape(-1, K),)
        args = (coder._cdf, *rows, states, words, coder._max_values, coder._offsets)
        return getattr(rk, name), args, len(args) - 1, exact  # late: the offsets
    if name == "container_write":
        states, words, escs = crx2.arrays(rng, 300, 20001, 4000, "mixed")
        args = (900, True, t(states.view(np.int32)), t(words.view(np.int16)), t(escs),
                torch.tensor(True, device=card))
        same = lambda a, b: torch.equal(a[:8 + int(a[:8].cpu().numpy().view("<i8")[0])],
                                        b[:8 + int(b[:8].cpu().numpy().view("<i8")[0])])
        return rk.container_write, args, 4, same  # late: the escapes
    if name == "container_read":
        states, words, escs = crx2.arrays(rng, 300, 20001, 4000, "mixed")
        data = assemble_container(900, 300, 20001, 4000, False, False, states, words, escs)
        return (rk.container_read, (t(np.frombuffer(data, np.uint8).copy()), 300, 20001, 4000), 0,
                exact)
    if name == "flash_attention_forward":
        q, k, v = (t(rng.standard_normal((1, 2, 300, 64), np.float32)).to(torch.bfloat16)
                   for _ in range(3))
        return flash_attention_forward, (q, k, v, 0.125), 2, exact
    ops = _grad_operands(rng, card, 1, 2, 300)
    fn = {"flash_attention_backward_dq": flash_attention_backward_dq,
          "flash_attention_backward_dkv": flash_attention_backward_dkv}[name]
    return fn, (*ops, 0.125), 3, exact  # late: dout


@pytest.mark.parametrize("name", ["expand", "dynroll", "rans_encode", "rans_decode_generic",
                                  "rans_decode_sorted", "container_write", "container_read",
                                  "flash_attention_forward",
                                  "flash_attention_backward_dq", "flash_attention_backward_dkv"])
def test_wrappers_launch_on_the_callers_stream(card, rng, gc_table, name):
    """Every kernel wrapper launches on the current stream. One input
    holds a decoy of zeros; the default stream sleeps ~0.1 s and then
    copies the real input over it; meanwhile, under
    ``with torch.cuda.stream(s)`` (a stream that does not wait for the
    default one), the wrapper launches. A launch on s runs at once and
    reads the decoy; one on the default or legacy stream would run after
    the copy and read the real input. The decode wrappers synchronize s
    on the host before they launch, which this order leaves harmless."""
    fn, args, late, same = _side_stream_case(name, rng, card, gc_table)
    decoy = list(args)
    decoy[late] = torch.zeros_like(args[late])
    real, want = fn(*args), fn(*decoy)
    torch.cuda.synchronize()
    assert not same(want, real)  # the two orders would differ
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):  # s's own allocator blocks, so no cudaMalloc below
        fn(*args)
    torch.cuda.synchronize()
    before = fn.launches
    torch.cuda._sleep(200_000_000)  # on the default stream: far longer than any launch here
    decoy[late].copy_(args[late])
    with torch.cuda.stream(s):
        got = fn(*decoy)
    s.synchronize()
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(decoy[late], args[late])
    assert same(got, want)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_ring_attention_at_one_rank_close_to_plain(card, rng, dtype, atol):
    """ring_attention_sharded at world size 1 on the card (no rotation):
    the float32 online softmax against the plain attention, on a ragged N;
    the bf16 output is q's dtype, within a few bf16 ulps."""
    import torch.distributed as dist

    from cra5_tpu_torch.ops.ring_attention import ring_attention_sharded
    from cra5_tpu_torch.parallel import make_mesh

    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 300, 64)).astype(np.float32))
               .to(card, dtype) for _ in range(3))
    try:
        out = ring_attention_sharded(q, k, v, make_mesh({"sp": 1}, device_type="cuda"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    logits = torch.matmul(q.float() * 64 ** -0.5, k.float().transpose(-1, -2))
    want = torch.matmul(torch.softmax(logits, -1), v.float())
    assert out.dtype == dtype and out.shape == q.shape
    assert (out.float() - want).abs().max().item() <= atol


def test_msgpack_roundtrip_of_card_params(card, tmp_path):
    """The port's writer on a card-resident model's params and its reader
    back: every tensor bitwise, and a fresh model on the card takes them."""
    from cra5_tpu_torch.models.vaeformer import VAEformer, vaeformer_tiny
    from cra5_tpu_torch.train.checkpoints import load_variables, save_variables

    model = VAEformer(vaeformer_tiny(), device=card).reset_parameters(5)
    path = str(tmp_path / "tiny.msgpack")
    save_variables(path, dict(model.named_parameters()), model=model)
    fresh = VAEformer(vaeformer_tiny(), device=card)
    params = load_variables(path, model=fresh)
    with torch.no_grad():
        for name, p in fresh.named_parameters():
            p.copy_(params[name])
    for name, p in model.named_parameters():
        assert torch.equal(fresh.get_parameter(name), p), name


# card against CPU for the image-codec zoo: the card's im2col / cuBLAS
# GEMMs (cuDNN off, TF32 off) sum the convolutions in other orders than
# the CPU's, so x_hat agrees within this share of max |x_hat| (the
# symbols exactly)
ZOO_XHAT_RTOL = 1e-4


def test_zoo_image_codec_on_the_card_gives_the_cpu_symbols(card):
    """mbt2018-mean at a small width (N=32, M=48) with the same seeded
    weights on the card and on the CPU, one ImageCodec v2 roundtrip of a
    seeded 3 x 128 x 192 image: the same symbols and bytes (K1 twice), the
    card decodes them (K2 on z and on y) to the encoded symbols, and x_hat
    equals reconstruct of them bitwise on the card and the CPU's within
    ZOO_XHAT_RTOL."""
    from cra5_tpu_torch.models import MeanScaleHyperprior, make_codec

    gpu = MeanScaleHyperprior(N=32, M=48, device=card).reset_parameters(0)
    cpu = MeanScaleHyperprior(N=32, M=48, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    x = np.random.default_rng(0).random((1, 3, 128, 192), np.float32)
    with torch.inference_mode():
        eg, ec = gpu.encode_symbols(torch.from_numpy(x).to(card)), cpu.encode_symbols(
            torch.from_numpy(x))
    for k in ("y_sym", "z_sym"):
        assert torch.equal(eg[k].cpu(), ec[k]), k
    a, b = make_codec(gpu), make_codec(cpu)
    kernels.reset_launch_counts()
    out = a.compress(x)
    assert kernels.launch_counts()["rans_encode"] == 2
    assert out["strings"] == b.compress(x)["strings"]
    kernels.reset_launch_counts()
    x_gpu = a.decompress(out["strings"], out["shape"])["x_hat"]
    assert kernels.launch_counts()["rans_decode_generic"] == 2
    with torch.inference_mode():
        assert torch.equal(x_gpu, gpu.reconstruct(eg["y_sym"], eg["means"]))
    x_cpu = b.decompress(out["strings"], out["shape"])["x_hat"]
    assert (x_gpu.cpu() - x_cpu).abs().max().item() <= ZOO_XHAT_RTOL * x_cpu.abs().max().item()


def test_y_stream_of_2048_lanes_decodes_on_k3(card, rng, gc_table):
    """A y-sized stream of 2048 x 512 symbols on the 64-row GC table: the
    format writes it on 2048 lanes, index-sorted and kernel-safe, and the
    card decodes it through K3 to the symbols."""
    idx = rng.integers(0, 64, 2048 * 512).astype(np.int32)
    sym = _sample(rng, gc_table, idx, 0.01)
    coder = LaneCoder(gc_table, device=card)
    data = coder.encode(sym, idx)
    n, K, _, _, sorted_mode, safe, _ = parse_v2_header(data)
    assert (n, K, sorted_mode, safe) == (idx.size, 2048, True, True)
    before = rk.rans_decode_sorted.launches
    np.testing.assert_array_equal(coder.decode(data, idx), sym)
    assert rk.rans_decode_sorted.launches == before + 1
    assert data == LaneCoder(gc_table, device="cpu").encode(sym, idx)


def test_serve_on_the_card_matches_the_cpu(card, tmp_path, capsys):
    """tools/serve.py on the tiny float32 model: three .bin files written
    by the CPU API with its seeded weights, served on the card and on the
    CPU from those weights (a .pt checkpoint: a seeded init on the card
    draws other numbers). Each .npy agrees within the 1e-4 of the tiny
    card-against-CPU codec test above; the card decodes every z and every
    (tiny, unsorted) y stream through K2, the warm decode included."""
    import json

    from cra5_tpu_torch.api.cra5_api import cra5_api
    from cra5_tpu_torch.tools import serve
    from cra5_tpu_torch.train.checkpoints import save_variables

    api = cra5_api(model_version=-1, device="cpu")
    weights = save_variables(str(tmp_path / "tiny.pt"), dict(api.net.named_parameters()))
    stamps = ("2021-06-01T00:00:00", "2021-06-01T06:00:00", "2021-06-01T12:00:00")
    for ts in stamps:
        api.encode_era5_as_bin(ts, save_root=str(tmp_path))
    bins = tmp_path / "CRA5" / "2021"
    out = {}
    for dev in ("cuda", "cpu"):
        kernels.reset_launch_counts()
        assert serve.main([str(bins), "-o", str(tmp_path / dev), "--device", dev,
                           "--checkpoint", weights, "--threads", "2"]) == 0
        launches = kernels.launch_counts()
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["decoded"] == len(stamps) and line["kernel_fallbacks"] == []
        out[dev] = {ts: np.load(tmp_path / dev / f"{ts}.npy") for ts in stamps}
        want = 2 * (len(stamps) + 1) if dev == "cuda" else 0
        assert launches.get("rans_decode_generic", 0) == want, launches
    for ts in stamps:
        assert np.abs(out["cuda"][ts] - out["cpu"][ts]).max() <= 1e-4, ts


def test_rdoq_on_the_card_equals_the_cpu_but_for_ties(card):
    """ops/rdoq.py on the card against the CPU on the same inputs. A symbol
    may differ only where the CPU's float32 costs of the two candidates
    lie within one ulp of each other: a tie that the card's log2 or its
    rounding of the sum breaks the other way. Such ties are counted."""
    from cra5_tpu_torch.ops.rdoq import rdoq, rdoq_costs

    table = gc_update(get_scale_table())
    rng = np.random.default_rng(11)
    n = 200_000
    idx = rng.integers(0, table.num_indexes, n).astype(np.int32)
    half = -table.offset[idx]
    x = rng.standard_normal(n) * (0.2 + half * 0.6)
    esc = rng.random(n) < 0.1
    x[esc] = np.sign(rng.standard_normal(esc.sum())) * (half[esc] + rng.uniform(1, 300, esc.sum()))
    x = torch.from_numpy(x.astype(np.float32))
    for lmbda in (0.01, 0.3, 4.0):
        got = rdoq(x.to(card), torch.from_numpy(idx).to(card), table, lmbda).cpu()
        cands, costs = rdoq_costs(x, torch.from_numpy(idx), table, lmbda)
        want = cands.gather(0, costs.argmin(dim=0)[None])[0]
        diff = (got != want).nonzero().flatten()
        pick = lambda s: costs[(cands[:, diff] == s[diff]).int().argmax(0), diff]  # noqa: E731
        a, b = pick(got).numpy(), pick(want).numpy()
        assert np.all(np.abs(a - b) <= np.spacing(np.maximum(np.abs(a), np.abs(b)))), lmbda
        print(f"rdoq lambda {lmbda}: {diff.numel()} ties of {n} broken the other way")


def test_variation_cnn_prior_on_the_card_gives_the_cpu_symbols_and_bytes(card):
    """VariationCNNPrior (vaeformer_tiny, float32) with the CPU's seeded
    weights, through VAEformerCodec v2 on the card and on the CPU: the same
    symbols and bytes (K1 on each stream), the card decodes them (K2 on z
    and on the tiny, unsorted y) to x_hat equal to reconstruct of the
    encoded symbols bitwise, and within ZOO_XHAT_RTOL of the CPU's (the
    conv hyperprior runs cuDNN off on the card)."""
    from cra5_tpu_torch.models import VAEformerCodec, VariationCNNPrior, vaeformer_tiny

    cpu = VariationCNNPrior(vaeformer_tiny(), device="cpu").reset_parameters(0)
    gpu = VariationCNNPrior(vaeformer_tiny(), device=card)
    gpu.load_state_dict({k: v.to(card) for k, v in cpu.state_dict().items()})
    x = np.random.default_rng(0).standard_normal((2, 8, 41, 40)).astype(np.float32) * 0.5
    with torch.inference_mode():
        eg = gpu.encode_symbols(torch.from_numpy(x).to(card))
        ec = cpu.encode_symbols(torch.from_numpy(x))
    for k in ("y_sym", "z_sym"):
        assert torch.equal(eg[k].cpu(), ec[k]), k
    a, b = VAEformerCodec(gpu), VAEformerCodec(cpu)
    kernels.reset_launch_counts()
    out = a.compress(x)
    assert kernels.launch_counts()["rans_encode"] == 4
    assert out["strings"] == b.compress(x)["strings"]
    kernels.reset_launch_counts()
    x_gpu = a.decompress(out["strings"], out["z_shape"])["x_hat"]
    assert kernels.launch_counts()["rans_decode_generic"] == 4
    with torch.inference_mode():
        assert torch.equal(x_gpu, gpu.reconstruct_from_y_symbols(eg["y_sym"], eg["means"]))
    x_cpu = b.decompress(out["strings"], out["z_shape"])["x_hat"]
    assert (x_gpu.cpu() - x_cpu).abs().max().item() <= ZOO_XHAT_RTOL * x_cpu.abs().max().item()


def test_general_patch_paths_on_the_card_match_the_cpu(card):
    """PatchEmbed / PatchUnembed off the fast geometry (F.unfold, F.fold
    and a matmul on the card), alone and ending a ViTDecoder, float32 with
    TF32 off, against the CPU within 1e-5 x max |ref| (summation order
    only)."""
    from cra5_tpu_torch.device import resolve_device
    from cra5_tpu_torch.nn.patch_embed import PatchEmbed, PatchUnembed
    from cra5_tpu_torch.nn.vit import ViTDecoder

    resolve_device(card)  # TF32 off
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 13, 17, generator=gen)
    tok = torch.randn(2, 30, 6, generator=gen)
    feat = torch.randn(1, 16, 6, 5, generator=gen)
    for cpu, args in (
            (PatchEmbed(3, 6, (3, 5), (2, 3)), (x,)),
            (PatchUnembed(6, 3, (3, 5), (2, 3)), (tok, (6, 5))),
            (ViTDecoder((13, 17), (3, 5), (2, 3), 3, 16, 4, 2, ((2, 2), (1, 4), (4, 1)), 2),
             (feat,))):
        with torch.no_grad():
            for p in cpu.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
            gpu = copy.deepcopy(cpu).to(card)
            want = cpu(*args)
            got = gpu(*(a.to(card) if isinstance(a, torch.Tensor) else a for a in args))
        want, got = (want[0], got[0]) if isinstance(want, tuple) else (want, got)
        assert got.shape == want.shape
        assert (got.cpu() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


CONTEXT_TINY = {
    "ELIC2022": dict(N=32, M=64, num_slices=3),
    "SymmetricalTransFormer2022": dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 2),
                                       num_slices=4),
}


@pytest.mark.parametrize("name", sorted(CONTEXT_TINY))
def test_context_codec_on_the_card_writes_the_cpu_bytes(card, name):
    """ELIC and STF at the JAX tests' tiny widths, the same seeded weights
    on the card and on the CPU: one roundtrip of a seeded 3 x 128 x 192
    image writes the same streams (K1 for each), the card decodes them
    (K2 for each) and x_hat agrees within ZOO_XHAT_RTOL x max|ref|."""
    from cra5_tpu_torch import models
    from cra5_tpu_torch.models import make_codec

    cls, kw = getattr(models, name), CONTEXT_TINY[name]
    gpu = cls(**kw, device=card).reset_parameters(0)
    cpu = cls(**kw, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    x = np.random.default_rng(0).random((1, 3, 128, 192), np.float32)
    a, b = make_codec(gpu), make_codec(cpu)
    kernels.reset_launch_counts()
    out = a.compress(x)
    n = len(out["strings"][0]) + 1
    assert kernels.launch_counts()["rans_encode"] == n
    assert out["strings"] == b.compress(x)["strings"]
    kernels.reset_launch_counts()
    x_gpu = a.decompress(out["strings"], out["shape"])["x_hat"]
    assert kernels.launch_counts()["rans_decode_generic"] == n
    x_cpu = b.decompress(out["strings"], out["shape"])["x_hat"]
    assert (x_gpu.cpu() - x_cpu).abs().max().item() <= ZOO_XHAT_RTOL * x_cpu.abs().max().item()


def test_elic_decoder_indexes_equal_the_encoders_on_the_card(card):
    """One ElicCodec roundtrip on the card: every pass's GC indexes and
    symbols on the decode side equal the encode side's, and x_hat equals
    synthesis of the encoder's y_hat bitwise."""
    from cra5_tpu_torch.models import ELIC2022, make_codec

    codec = make_codec(ELIC2022(**CONTEXT_TINY["ELIC2022"], device=card).reset_parameters(1))
    seen = {}
    for name in ("_indexes", "_symbols", "_decode", "_hat"):
        fn = getattr(codec, name)
        setattr(codec, name, lambda *a, _f=fn, _n=name: seen.setdefault(_n, []).append(_f(*a))
                or seen[_n][-1])
    x = np.random.default_rng(1).random((1, 3, 128, 192), np.float32)
    out = codec.compress(x)
    x_hat = codec.decompress(out["strings"], out["shape"])["x_hat"]
    n = 2 * 3
    idx, hats = seen["_indexes"], seen["_hat"]
    assert len(idx) == 2 * n and all(torch.equal(a, b) for a, b in zip(idx[:n], idx[n:]))
    assert all(torch.equal(a, b) for a, b in zip(seen["_symbols"], seen["_decode"]))
    y_hat = torch.cat([hats[p] + hats[p + 1] for p in range(0, n, 2)], dim=1)
    with torch.inference_mode():
        assert torch.equal(x_hat, codec.model.synthesis(y_hat))


def test_ssf_on_the_card_writes_the_cpu_bytes_and_rebuilds_its_chain(card):
    """ScaleSpaceFlow at tiny widths (planes = mid = 8, two levels), the
    same seeded weights on the card and on the CPU, a seeded 3-frame 128 x
    128 clip: the card writes the CPU's streams (K1 for each), decodes them
    (K2 for each) to frames bitwise equal to its encoder's reference frames,
    and those agree with the CPU's within ZOO_XHAT_RTOL x max|ref|."""
    from cra5_tpu_torch.models.video import ScaleSpaceFlow, ScaleSpaceFlowCodec

    kw = dict(num_levels=2, mid_planes=8, planes=8)
    cpu = ScaleSpaceFlow(**kw, device="cpu").reset_parameters(0)
    with torch.no_grad():
        for enc in (cpu.img_encoder, cpu.res_encoder, cpu.motion_encoder):
            enc.l6.conv.weight.mul_(6.0)
    gpu = ScaleSpaceFlow(**kw, device=card)
    gpu.load_state_dict({k: v.to(card) for k, v in cpu.state_dict().items()})
    a, b = ScaleSpaceFlowCodec(gpu), ScaleSpaceFlowCodec(cpu)
    clip = np.random.default_rng(0).random((3, 1, 3, 128, 128), np.float32)
    frames = [clip[i] for i in range(3)]
    refs = []
    fn = a._reference
    a._reference = lambda *args: refs.append(fn(*args)) or refs[-1]
    kernels.reset_launch_counts()
    out, shapes = a.compress(frames)
    assert kernels.launch_counts()["rans_encode"] == 10
    assert (out, shapes) == b.compress(frames)
    kernels.reset_launch_counts()
    dec = a.decompress(out, shapes)
    assert kernels.launch_counts()["rans_decode_generic"] == 10
    assert len(refs) == 4 and all(torch.equal(e, d) for e, d in zip(refs[:2], refs[2:]))
    assert torch.equal(dec[1], refs[2]) and torch.equal(dec[2], refs[3])
    for g, c in zip(dec, b.decompress(out, shapes)):
        assert (g.cpu() - c).abs().max().item() <= ZOO_XHAT_RTOL * c.abs().max().item()


def test_1080p_y_stream_decodes_on_k3_like_its_plain_version(card, rng, gc_table):
    """A UVG 1080p y stream's geometry (72 x 120 x 192 symbols, GC indexes
    constant over channel runs as a hyperprior's scales tend to be): 2048
    lanes, sorted and kernel-safe; K3 on the uploaded stream equals
    rans_decode_sorted_plain, and the decode gives back the symbols."""
    C, H, W = 192, 72, 120
    idx = np.repeat(rng.integers(0, 64, (C, 1, 1)), H * W, axis=1).reshape(C, H, W)
    idx = np.where(rng.random((C, H, W)) < 0.1, rng.integers(0, 64, (C, H, W)), idx)
    idx = idx.astype(np.int32).reshape(-1)
    sym = _sample(rng, gc_table, idx, 0.01)
    coder = LaneCoder(gc_table, device=card)
    data = coder.encode(sym, idx)
    n, K, _, _, sorted_mode, safe, _ = parse_v2_header(data)
    assert (n, K, sorted_mode, safe) == (C * H * W, 2048, True, True)
    up = coder.upload_batch([data])[0]
    idx_t = torch.from_numpy(idx).to(card)
    kernel, plain, args, _ = coder.decode_call(up, idx_t)
    assert kernel is rk.rans_decode_sorted
    got, want = kernel(*args, coder._slots), plain(*args)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    np.testing.assert_array_equal(coder.decode(data, idx), sym)
    assert data == LaneCoder(gc_table, device="cpu").encode(sym, idx)


# The attention shapes that the flash mode "on" adds at 268v: the window
# blocks' 576 tokens (18 windows of 24 x 24 or 12 x 48, 16 heads of 64; the
# 48 x 12 windows pad to 24 of them) and the hyperprior's global blocks
# (648 tokens, 5 heads of 72), in bf16 and float32.
SWITCH_SHAPES = [(18, 16, 576, 64), (24, 16, 576, 64), (1, 5, 648, 72)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("B,H,N,D", SWITCH_SHAPES)
def test_flash_attn_at_the_window_and_hyperprior_shapes_close_to_plain(card, rng, dtype,
                                                                       B, H, N, D):
    """K4, K5 and K6 at the shapes the flash mode "on" routes at 268v,
    each launched once and held against its plain version within the bf16
    (FLASH_OUT_RTOL, FLASH_GRAD_RTOL) or float32 (FLASH_F32_RTOL) bounds."""
    rtol, lse_atol = ((FLASH_GRAD_RTOL, FLASH_LSE_ATOL) if dtype == torch.bfloat16
                      else (FLASH_F32_RTOL, FLASH_F32_LSE_ATOL))
    scale = D ** -0.5
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, N, D), np.float32)).to(card, dtype)
                   for _ in range(4))
    fns = (flash_attention_forward, flash_attention_backward_dq, flash_attention_backward_dkv)
    before = tuple(f.launches for f in fns)
    out, lse = flash_attention_forward(q, k, v, scale)
    delta = (do.float() * out.float()).sum(-1)
    ops = (q, k, v, do, lse, delta, scale)
    dq = flash_attention_backward_dq(*ops)
    dk, dv = flash_attention_backward_dkv(*ops)
    torch.cuda.synchronize()
    assert tuple(f.launches for f in fns) == tuple(b + 1 for b in before)
    ref, ref_lse = flash_attention_plain(q, k, v, scale)
    assert (lse - ref_lse).abs().max().item() <= lse_atol
    pairs = [(out, ref), (dq, flash_attention_backward_dq_plain(*ops)),
             *zip((dk, dv), flash_attention_backward_dkv_plain(*ops))]
    for got, want in pairs:
        assert got.dtype == dtype and torch.isfinite(got).all()
        bound = rtol * want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= bound


def test_268v_sized_unsorted_y_decodes_on_k2(card, rng, gc_table):
    """A stream of the 268v y's size (2 654 208 symbols on 8192 lanes, its
    GC indexes 2-D with a channel's cdf rows as the scales give them)
    written under the sorted-lanes mode "off": unsorted, so it takes K2,
    which equals lane_decode_plain exactly, and the decode gives back the
    symbols."""
    from cra5_tpu_torch.coder import rans_kernels as rkm

    C, H, W = 256, 72, 144
    idx = np.clip(rng.normal(12, 5, (C, 1, 1)) + rng.normal(0, 3, (C, H, W)), 0,
                  gc_table.num_indexes - 1).astype(np.int32).reshape(-1)
    sym = _sample(rng, gc_table, idx, 0.01)
    saved = rkm.sorted_lanes_mode()
    rkm.set_sorted_lanes("off")
    try:
        coder = LaneCoder(gc_table, device=card)
        data = coder.encode(sym, idx)
    finally:
        rkm.set_sorted_lanes(saved)
    hdr = parse_v2_header(data)
    (n, K, _, _, srt, _, _), states, words, _ = coder._upload(data, hdr)
    assert (n, K, srt) == (C * H * W, 8192, False)
    idx2 = torch.from_numpy(idx).to(card).reshape(-1, K)
    args = (coder._cdf, idx2, states, words, coder._max_values, coder._offsets)
    before = rk.rans_decode_generic.launches
    got = rk.rans_decode_generic(*args, coder._slots)
    torch.cuda.synchronize()
    assert rk.rans_decode_generic.launches == before + 1
    assert _equal(got, rk.lane_decode_plain(*args))
    np.testing.assert_array_equal(coder.decode(data, idx), sym)


def _to_card(card, states, words, escs):
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a).view(dt)).to(card)
    return t(states, np.int32), t(words, np.int16), t(escs, np.int32)


@pytest.mark.parametrize("case", crx2.CARD_CASES + crx2.LAYOUT_CASES,
                         ids=[c[0] for c in crx2.CARD_CASES + crx2.LAYOUT_CASES])
def test_container_kernels_equal_the_host_reference(card, case):
    """K9's image of the host arrays is ``assemble_container``'s bytes, and
    K10 reads back ``container_arrays``'s, at the main path's streams
    (the 268v y and z, y at 16 384 lanes, an image codec's stream) and at
    the layout's edges; one launch each."""
    _, K, nw, ne, srt, safe, kind = case
    states, words, escs = crx2.arrays(np.random.default_rng(K + nw), K, nw, ne, kind)
    want = assemble_container(3 * K + ne, K, nw, ne, srt, safe, states, words, escs)
    before = (rk.container_write.launches, rk.container_read.launches)
    out = rk.container_write(3 * K + ne, srt, *_to_card(card, states, words, escs),
                             torch.tensor(safe, device=card))
    host = out.cpu().numpy()
    size = int(host[:8].view("<i8")[0])
    assert out.numel() == 8 + rk.container_layout(K, nw, ne).capacity
    assert size == len(want) and host[8:8 + size].tobytes() == want
    image = torch.from_numpy(np.frombuffer(want, np.uint8).copy()).to(card)
    got = rk.container_read(image, K, nw, ne)
    for g, w in zip(got, crx2.reference_arrays(want)):
        np.testing.assert_array_equal(g.cpu().numpy(), w)
    assert (rk.container_write.launches, rk.container_read.launches) == (before[0] + 1,
                                                                          before[1] + 1)


@pytest.mark.parametrize("kind", ["random", "overlong", "trailing"])
@pytest.mark.parametrize("ne", [1, 7, 300, 40000])
def test_container_read_on_fuzzed_escape_regions_equals_the_plain_decoder(card, kind, ne):
    rng = np.random.default_rng(ne + len(kind))
    for nw in (11, 12):  # the region at 2 and 0 mod 4 of the image
        words = rng.integers(0, 1 << 16, nw).astype(np.uint16)
        data = crx2.with_region(3, words, ne, crx2.escape_region(rng, kind, ne))
        image = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(card)
        got = rk.container_read(image, 3, nw, ne)
        for g, w in zip(got, crx2.reference_arrays(data)):
            np.testing.assert_array_equal(g.cpu().numpy(), w)


def test_lane_coder_on_the_card_packs_and_parses_with_one_k9_and_one_k10_a_stream(
        card, rng, gc_table, eb_table):
    """A y stream (sorted, 2048 lanes) and a z stream of a batch: the card's
    containers are the CPU coder's bytes, one K9 a stream; the card reads
    them back with one K10 a stream and decodes them on K3 and K2."""
    idx_y = rng.integers(20, 23, 2048 * 6 + 100).astype(np.int32)
    idx_z = np.repeat(np.arange(16, dtype=np.int32), 96)
    coders = [(LaneCoder(gc_table, num_lanes=2048, device=card),
               LaneCoder(gc_table, num_lanes=2048, device="cpu"), idx_y),
              (LaneCoder(eb_table, num_lanes=32, device=card),
               LaneCoder(eb_table, num_lanes=32, device="cpu"), idx_z)]
    syms = [_sample(rng, c[0].table, c[2], 0.05) for c in coders]
    t = lambda a: torch.from_numpy(a).to(card)
    before = {k: getattr(rk, k).launches for k in ("container_write", "container_read",
                                                    "rans_decode_sorted", "rans_decode_generic")}
    handles = [gpu.encode_dispatch(t(sym), t(idx)) for (gpu, _, idx), sym in zip(coders, syms)]
    streams = LaneCoder.encode_finalize_many(handles)
    assert rk.container_write.launches == before["container_write"] + 2
    for (gpu, cpu, idx), sym, data in zip(coders, syms, streams):
        assert data == cpu.encode(sym, idx) and parse_v2_header(data)[2] > 0
        np.testing.assert_array_equal(gpu.decode(data, idx), sym)
    got = {k: getattr(rk, k).launches - v for k, v in before.items()}
    assert got == {"container_write": 2, "container_read": 2, "rans_decode_sorted": 1,
                   "rans_decode_generic": 1}


def test_card_streams_equal_the_jax_golden_vectors(card):
    """The JAX LaneCoder's golden streams (tests/goldens, unsorted on 4
    lanes and sorted on 128): the card writes them byte for byte through
    K1 and K9, and reads them through K10."""
    gold = Path(__file__).resolve().parent / "goldens"
    z = np.load(gold / "rans_golden.npz")
    table = CdfTable(z["quantized_cdf"], z["cdf_length"], z["offset"])
    s = np.load(gold / "sorted_golden.npz")
    for sym, idx, name, kw in ((z["sym"], z["idx"], "stream_v2.bin", {}),
                               (s["sym"], s["idx"], "stream_v2_sorted.bin",
                                dict(num_lanes=128, sorted_lanes=True))):
        data = (gold / name).read_bytes()
        coder = LaneCoder(table, device=card, **kw)
        assert coder.encode(sym, idx) == data, name
        np.testing.assert_array_equal(coder.decode(data, idx), sym)


@pytest.mark.parametrize("which", range(11))
def test_malformed_streams_raise_the_cpus_error_on_the_card(card, gc_table, which):
    data = crx2.valid_stream(gc_table, np.random.default_rng(5), card)
    assert data == crx2.valid_stream(gc_table, np.random.default_rng(5), "cpu")
    name, bad, n, pattern = crx2.malformed_streams(data)[which]
    errors = []
    for dev in ("cpu", card):
        with pytest.raises(ValueError, match=pattern) as e:
            LaneCoder(gc_table, num_lanes=64, device=dev).upload_batch([bad], n)
        errors.append(str(e.value))
    assert errors[0] == errors[1], name


def test_codec_profile_on_the_card_keeps_the_coder_spans_free_of_device_work(card):
    """A tiny v2 roundtrip profiled on the card: 2 coder/pack and 2
    coder/parse spans, holding no torch operator (K9, K10 and the copies
    launch outside them), and one K9 and one K10 a stream."""
    from cra5_tpu_torch.models.vaeformer import VAEformer, VAEformerCodec, vaeformer_tiny

    codec = VAEformerCodec(VAEformer(vaeformer_tiny(), device=card).reset_parameters(5))
    codec.update()
    x = np.random.default_rng(7).standard_normal((1, 8, 41, 40)).astype(np.float32)
    out = codec.compress(x)
    codec.decompress(out["strings"], out["z_shape"])
    reset_span_totals()
    before = (rk.container_write.launches, rk.container_read.launches)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = codec.compress(x)
        codec.decompress(out["strings"], out["z_shape"])
        torch.cuda.synchronize()
    assert (rk.container_write.launches, rk.container_read.launches) == (before[0] + 2,
                                                                          before[1] + 2)
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id(),
            e.is_user_annotation()) for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CPU]
    ranges = [e for e in evs if e[4]]
    coder = [e for e in ranges if e[0] in ("coder/pack", "coder/parse")]
    assert sorted(e[0] for e in coder) == ["coder/pack"] * 2 + ["coder/parse"] * 2
    for name, s, e, thread, _ in coder:
        inside = [o[0] for o in evs if not o[4] and o[3] == thread and s <= o[1] <= e]
        assert inside == [], (name, inside)
    t = span_totals()
    assert t["coder/pack"]["calls"] == 2 and t["coder/parse"]["calls"] == 2
    reset_span_totals()
