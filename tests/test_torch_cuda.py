"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and takes the ``card`` fixture, which
skips when no NVIDIA card is present: the decision is made inside the
fixture, never at import time, so every pytest worker collects the same
tests. This file imports no JAX, and it uses no fixture of
``tests/conftest.py`` (which does), so on a machine with a card it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes are small and ragged (lane counts and sequence lengths off the
kernels' tile and block sizes). K1-K3, the generic lane decode, K7 and K8
must equal their plain versions exactly; K4-K6 must agree within the bf16
and float32 tolerances stated below.
"""

import numpy as np
import pytest
import torch

from cra5_tpu_torch import kernels
from cra5_tpu_torch.coder import rans_kernels as rk
from cra5_tpu_torch.coder.lane_coder import (
    LaneCoder,
    _sort_by_index,
    merge_tiny_buckets,
    parse_v2_header,
    sorted_rows,
)
from cra5_tpu_torch.entropy import EntropyBottleneck, eb_update, gc_update, get_scale_table
from cra5_tpu_torch.entropy.cdf import CdfTable
from cra5_tpu_torch.profiling import perm_probe as pp
from cra5_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_backward_dkv,
    flash_attention_backward_dkv_plain,
    flash_attention_backward_dq,
    flash_attention_backward_dq_plain,
    flash_attention_forward,
    flash_attention_plain,
)

pytestmark = pytest.mark.cuda

# K4: the kernel accumulates P V over 64-key tiles with a running maximum,
# the plain version over the whole row, and both round P to bf16 before
# the product. The size of out depends on the shape (an average of N rows
# of v: about sqrt(e / N) for unit logits), so its bound scales with the
# reference: max |out - ref| <= 2e-2 * max |ref|, a few bf16 ulps of the
# largest output. lse (f32) within the f32 summation-order noise of
# the row sums.
FLASH_OUT_RTOL = 2e-2
FLASH_LSE_ATOL = 2e-3
# K5/K6: dq, dk and dv are sums over N rows of bf16-rounded dS or P
# products; the kernels sum 64-wide tiles in another order than the plain
# versions, and round dq/dk/dv to bf16 once. Each is bounded as out is:
# max |got - ref| <= 2e-2 * max |ref|.
FLASH_GRAD_RTOL = 2e-2
# K4-K6 with float32 operands against the float32 plain versions: no
# rounding point differs, only the order of float32 sums. The plain
# versions sum in blocks (within 1.3e-6 x max |ref| of float64 for out,
# dq, dk and dv at N = 1000 and 10368 on the CPU); the kernels carry one
# running sum over N, about 5e-6 x max |ref| from them at N = 10368 on an
# H100. The bound is 1e-5 x max |ref|, and lse (|lse| < 10) within 1e-5.
FLASH_F32_RTOL = 1e-5
FLASH_F32_LSE_ATOL = 1e-5


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


@pytest.mark.parametrize("M,K", [(1, 1), (37, 300), (9, 4097), (130, 96)])
def test_rans_encode_equals_plain(card, rng, M, K):
    freqs = torch.from_numpy(rng.integers(1, 60000, (M, K)).astype(np.int32)).to(card)
    starts = torch.from_numpy(rng.integers(0, 5000, (M, K)).astype(np.int32)).to(card)
    before = rk.rans_encode.launches
    got = rk.rans_encode(starts, freqs)
    want = rk.rans_encode_plain(starts, freqs)
    torch.cuda.synchronize()
    assert rk.rans_encode.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2][got[1]], want[2][want[1]])  # words where emitted


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


@pytest.mark.parametrize("K,steps,rows", [(2048, 5, 4), (4096, 6, 4), (8192, 4, 3)])
def test_rans_decode_sorted_equals_plain(card, rng, gc_table, K, steps, rows):
    """GC table (max_len 3133), a ragged tail, about 1% escapes; the
    symbols fall mostly on a few rows of >= K symbols each, so the stream
    is kernel-safe, and a few on other rows, which get merged."""
    n = K * steps + 333
    idx = np.concatenate([rng.integers(20, 20 + rows, n - 40),
                          rng.integers(0, 64, 40)]).astype(np.int32)
    rng.shuffle(idx)
    sym = _sample(rng, gc_table, idx, 0.01)
    coder = LaneCoder(gc_table, num_lanes=K, device=card)
    data = coder.encode(sym, idx)
    hdr = parse_v2_header(data)
    assert hdr[4:7] == (True, True, True)
    _, states, words, _ = coder._upload(data, hdr)
    M = -(-n // K)
    sidx, _ = _sort_by_index(torch.from_numpy(idx).to(card))
    sidx = merge_tiny_buckets(sidx, coder.num_indexes, K)
    idx2 = torch.cat([sidx, sidx[-1:].expand(M * K - n)]).reshape(M, K)
    args = (coder._cdf, *sorted_rows(idx2), states, words, coder._max_values, coder._offsets)
    got = rk.rans_decode_sorted(*args)
    want = rk.rans_decode_sorted_plain(*args)
    torch.cuda.synchronize()
    assert _equal(got, want) and got[1].any()
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


@pytest.mark.parametrize("B,H,N", [(1, 1, 1), (2, 3, 63), (1, 2, 65), (1, 2, 300), (2, 1, 1000)])
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
    z_gpu = a._eb_coder.decode_batch_to_device(out["strings"][1], a._z_indexes(z_shape).to(card))
    assert rk.rans_decode_generic.launches == before + 1
    z_cpu = b._eb_coder.decode_batch_to_device(out["strings"][1], b._z_indexes(z_shape))
    assert torch.equal(z_gpu.cpu(), z_cpu)
    before = rk.rans_decode_generic.launches
    x_gpu = a.decompress(out["strings"], out["z_shape"])["x_hat"]
    assert rk.rans_decode_generic.launches == before + 2
    x_hat = b.decompress(out["strings"], out["z_shape"])["x_hat"]
    assert tuple(x_hat.shape) == (1, cfg.in_chans, *cfg.img_size) and torch.isfinite(x_hat).all()
    assert (x_gpu.cpu() - x_hat).abs().max().item() <= 1e-4


@pytest.mark.parametrize("M,K,ncdf", [(1, 1, 64), (128, 1, 64), (37, 300, 64), (9, 4097, 64)])
def test_rans_decode_generic_equals_plain(card, rng, gc_table, M, K, ncdf):
    """Random cdf rows per symbol (no row plan, unsorted): the generic
    decode equals the plain per-lane decode exactly, and the coder
    routes such a stream to it."""
    n = M * K - (K // 3)
    idx = rng.integers(0, ncdf, max(n, 1)).astype(np.int32)
    sym = _sample(rng, gc_table, idx, 0.02)
    coder = LaneCoder(gc_table, num_lanes=K, device=card)
    data = coder.encode(sym, idx)
    (n, _, _, _, srt, _, _), states, words, _ = coder._upload(data, parse_v2_header(data))
    assert not srt
    Ms = -(-n // K)
    idx2 = torch.from_numpy(np.concatenate([idx, np.zeros(Ms * K - n, np.int32)]).reshape(Ms, K)).to(card)
    args = (coder._cdf, idx2, states, words, coder._max_values, coder._offsets)
    before = rk.rans_decode_generic.launches
    got = rk.rans_decode_generic(*args)
    want = rk.lane_decode_plain(*args)
    torch.cuda.synchronize()
    assert rk.rans_decode_generic.launches == before + 1
    assert _equal(got, want)
    np.testing.assert_array_equal(coder.decode(data, idx), sym)
    assert rk.rans_decode_generic.launches == before + 2


def _grad_operands(rng, card, B, H, N):
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, N, 64), np.float32) * 1.5)
                   .to(card, torch.bfloat16) for _ in range(4))
    out, lse = flash_attention_forward(q, k, v, 0.125)
    delta = (do.float() * out.float()).sum(-1)
    return q, k, v, do, lse, delta


def _close(got, ref):
    bound = FLASH_GRAD_RTOL * ref.float().abs().max().item()
    return got.dtype == ref.dtype and (got.float() - ref.float()).abs().max().item() <= bound


@pytest.mark.parametrize("B,H,N", [(1, 1, 1), (2, 3, 63), (1, 2, 65), (1, 2, 300), (2, 1, 1000)])
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


@pytest.mark.parametrize("B,H,N", [(1, 1, 2), (2, 3, 63), (1, 2, 65), (1, 2, 300), (2, 1, 1000)])
def test_flash_attn_f32_close_to_plain(card, rng, B, H, N):
    """K4, K5 and K6 on float32 operands (the SIMT entries) against the
    float32 plain versions. N = 1 is left out: with one key dS = dP - delta
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
                                          (16, 1024, 0.6), (3, 32, 0.5), (1, 64, 0.3)])
def test_expand_equals_plain(card, rng, R, Kd, density):
    """K7 in one block: (16, 1024) takes 64 KiB of dynamic shared memory,
    (3, 32) and (1, 64) fewer than 1024 threads."""
    mask = torch.from_numpy((rng.random((R, Kd)) < density).astype(np.int32)).to(card)
    words = torch.from_numpy(rng.integers(0, 1 << 16, (R, Kd)).astype(np.int32)).to(card)
    before = pp.expand.launches
    got = pp.expand(mask, words)
    torch.cuda.synchronize()
    assert pp.expand.launches == before + 1
    assert torch.equal(got, pp.expand_plain(mask, words))


@pytest.mark.parametrize("shape", [(8, 1024), (3, 100)])
@pytest.mark.parametrize("shift", [0, 3, 1023, 1024, 5000, -3])
def test_dynroll_equals_plain(card, rng, shape, shift):
    x = torch.from_numpy(rng.integers(0, 1 << 16, shape).astype(np.int32)).to(card)
    s = torch.tensor([shift], dtype=torch.int32, device=card)
    before = pp.dynroll.launches
    got = pp.dynroll(x, s)
    torch.cuda.synchronize()
    assert pp.dynroll.launches == before + 1
    assert torch.equal(got, pp.dynroll_plain(x, s))
