"""Port vs JAX: the VAEformer and its codec at vaeformer_tiny() geometry.

Symbols, GC indexes and stream bytes must be identical; reconstructions
agree within the stated tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cra5_tpu.models.vaeformer import VAEformer as JVAEformer
from cra5_tpu.models.vaeformer import VAEformerCodec as JCodec
from cra5_tpu.models.vaeformer import vaeformer_tiny as j_tiny
from cra5_tpu_torch.convert import load_flax_variables
from cra5_tpu_torch.models.vaeformer import VAEformer, VAEformerCodec, vaeformer_tiny

# x_hat tolerance: float32 towers differ only in summation order; in
# bfloat16 every tower rounds at slightly different places (bias adds,
# LayerNorm output), a few bf16 ulps at |x_hat| < 1
XHAT_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _random_variables(shapes, rng):
    """Fill the flax variable tree with seeded random values: Dense/conv
    kernels at 1/sqrt(fan_in), LayerNorm scales near 1, small biases, and
    the entropy bottleneck near its own init."""

    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name == "quantiles":
            return np.tile(np.float32([-10, 0, 10]), shape[:-1] + (1,)) + 0.3 * rng.standard_normal(shape)
        if name.startswith("matrix"):
            return 1.0 + 0.2 * rng.standard_normal(shape)
        if name == "kernel":
            return rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(shape)
        return 0.1 * rng.standard_normal(shape)  # biases, factors, pos_embed

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


@pytest.fixture(scope="module")
def setup():
    cfg = j_tiny()
    x = np.random.default_rng(7).standard_normal((1, cfg.in_chans, *cfg.img_size)).astype(np.float32)
    shapes = jax.eval_shape(JVAEformer(cfg).init, jax.random.PRNGKey(0), jnp.asarray(x))
    return x, _random_variables(shapes, np.random.default_rng(3))


def _pair(setup, dtype):
    x, variables = setup
    jd, td = DTYPES[dtype]
    jcodec = JCodec(JVAEformer(j_tiny(), dtype=jd), variables)
    jcodec.update()
    model = load_flax_variables(VAEformer(vaeformer_tiny(), dtype=td, device="cpu"), variables)
    codec = VAEformerCodec(model)
    codec.update()
    return x, jcodec, codec


def _port_symbols(codec, x):
    with torch.inference_mode():
        got = codec.model.encode_symbols(torch.from_numpy(x))
        got["gc_idx"] = codec._gc_indexes(got["scales"])
    return got


def _jax_symbols(jcodec, x):
    return jcodec._encode_symbols(jcodec.variables, jnp.asarray(x), jcodec._scale_table_dev)


def test_f32_symbols_indexes_exact_and_x_hat(setup):
    x, jcodec, codec = _pair(setup, "float32")
    want, got = _jax_symbols(jcodec, x), _port_symbols(codec, x)
    for key in ("z_sym", "y_sym", "gc_idx"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    with torch.inference_mode():
        x_hat = codec.model.reconstruct_from_y_symbols(got["y_sym"], got["means"])
    want_x = jcodec._reconstruct(jcodec.variables, want["y_sym"], want["means"])
    np.testing.assert_allclose(x_hat.numpy(), np.asarray(want_x), atol=XHAT_ATOL["float32"],
                               rtol=XHAT_ATOL["float32"])


def test_bf16_symbols_and_x_hat(setup):
    """bfloat16 towers round at other places in the two frameworks, so a
    symbol or index sitting on a rounding boundary may flip by one (the
    full-geometry count is in PARITY.md): none moves by more than 1, and
    at least 90% agree (a bf16 scale is an 8-bit mantissa against a table
    spaced 13% apart). g_s, fed the same symbols and means, agrees within
    the bf16 tolerance."""
    x, jcodec, codec = _pair(setup, "bfloat16")
    want, got = _jax_symbols(jcodec, x), _port_symbols(codec, x)
    for key in ("z_sym", "y_sym", "gc_idx"):
        d = np.abs(got[key].numpy().astype(np.int64) - np.asarray(want[key]))
        assert d.max() <= 1 and (d == 0).mean() >= 0.9, key
    means = np.asarray(want["means"], np.float32)
    with torch.inference_mode():
        x_hat = codec.model.reconstruct_from_y_symbols(
            torch.from_numpy(np.array(want["y_sym"])), torch.from_numpy(means).to(torch.bfloat16))
    want_x = jcodec._reconstruct(jcodec.variables, want["y_sym"], want["means"])
    np.testing.assert_allclose(x_hat.float().numpy(), np.asarray(want_x, np.float32),
                               atol=XHAT_ATOL["bfloat16"], rtol=XHAT_ATOL["bfloat16"])


def test_f32_codec_bytes_equal_and_cross_decode(setup):
    x, jcodec, codec = _pair(setup, "float32")
    jout = jcodec.compress(x)
    out = codec.compress(x)
    assert out["z_shape"] == tuple(jout["z_shape"])
    assert out["strings"] == [list(s) for s in jout["strings"]]
    mine = codec.decompress(jout["strings"], jout["z_shape"])["x_hat"]
    theirs = jcodec.decompress(out["strings"], out["z_shape"])["x_hat"]
    assert tuple(mine.shape) == (1, 8, 41, 40)
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=XHAT_ATOL["float32"],
                               rtol=XHAT_ATOL["float32"])


def test_bf16_codec_roundtrip_is_exact(setup):
    """In bfloat16 the decode re-derives the GC indexes from h_s on the
    decoded z; every z and y symbol comes back, and x_hat is bit-identical
    to reconstructing from the encoder's own symbols."""
    x, _, codec = _pair(setup, "bfloat16")
    out = codec.compress(x)
    x_hat = codec.decompress(out["strings"], out["z_shape"])["x_hat"]
    got = _port_symbols(codec, x)
    (y_str,), (z_str,) = out["strings"]
    with torch.inference_mode():
        z_dec = codec._eb_coder.decode_batch_to_device(
            [z_str], codec._channel_indexes(got["z_sym"].shape))
        scales, _ = codec.model.scales_from_z_symbols(z_dec)
        y_dec = codec._gc_coder.decode_batch_to_device([y_str], codec._gc_indexes(scales))
        want = codec.model.reconstruct_from_y_symbols(got["y_sym"], got["means"])
    assert torch.equal(z_dec, got["z_sym"]) and torch.equal(y_dec, got["y_sym"])
    assert x_hat.dtype == torch.bfloat16 and torch.equal(x_hat, want)


def test_codec_stage_times_leave_the_bytes_and_output_unchanged(setup):
    """With ``stage_times`` set, every stage of compress and decompress
    records its seconds, and the streams and x_hat equal an untimed run's."""
    x, _, codec = _pair(setup, "float32")
    out = codec.compress(x)
    x_hat = codec.decompress(out["strings"], out["z_shape"])["x_hat"]
    codec.stage_times = {}
    timed = codec.compress(x)
    timed_x_hat = codec.decompress(timed["strings"], timed["z_shape"])["x_hat"]
    assert timed["strings"] == out["strings"] and torch.equal(timed_x_hat, x_hat)
    assert list(codec.stage_times) == [
        "compress/h2d_input", "compress/g_a", "compress/hyper", "compress/encode_z",
        "compress/encode_y", "compress/finalize", "decompress/upload_y", "decompress/decode_z",
        "decompress/h_s", "decompress/decode_y", "decompress/g_s"]
    assert all(t >= 0 for t in codec.stage_times.values())


def test_seeded_init_is_deterministic_and_mirrors_flax():
    a = VAEformer(vaeformer_tiny(), device="cpu").reset_parameters(5)
    b = VAEformer(vaeformer_tiny(), device="cpu").reset_parameters(5)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    blocks = a.g_a.blocks
    # trunc_normal(0.02) cut at 2 * 0.02, as flax's; proj/fc2 rescaled by
    # 1/sqrt(2 (layer_id + 1))
    w = blocks[0].attn.qkv.weight
    assert w.abs().max() <= 0.02 * 2 + 1e-6
    assert blocks[1].mlp.fc2.weight.abs().max() <= 0.04 * 0.5 + 1e-6
    assert torch.equal(a.entropy_bottleneck.medians(), torch.zeros(8))


def test_seeded_init_matches_the_flax_init():
    """The port's own init against flax's at vaeformer_tiny: every
    deterministic leaf (sin-cos pos_embed, LayerNorm, zero biases, the EB
    matrices, factors and quantiles) is equal; every random leaf has the
    flax initializer's standard deviation within 20%, and their mean
    ratio is 1 within 5% (the draws differ, as the generators do)."""
    cfg = j_tiny()
    x = jnp.zeros((1, cfg.in_chans, *cfg.img_size), jnp.float32)
    flax_init = load_flax_variables(VAEformer(vaeformer_tiny(), device="cpu"),
                                    jax.device_get(JVAEformer(cfg).init(jax.random.PRNGKey(0), x)))
    own = VAEformer(vaeformer_tiny(), device="cpu").reset_parameters(0).requires_grad_(False)
    want = dict(flax_init.named_parameters())
    ratios = []
    for name, got in own.named_parameters():
        ref = want[name].detach()
        if name.endswith("weight") and not name.endswith(("norm1.weight", "norm2.weight", "norm.weight")) \
                or ".bias" in name and "entropy_bottleneck" in name:
            if ref.numel() >= 200:
                ratios.append(float(got.std() / ref.std()))
                assert 0.8 <= ratios[-1] <= 1.25, name
        else:
            assert torch.equal(got, ref), name
    assert len(ratios) > 30 and abs(np.mean(ratios) - 1) < 0.05


def test_tiny_codec_decodes_y_through_the_generic_route(setup, monkeypatch):
    """The tiny z stream (32 symbols) and y stream (128 symbols), each on
    one lane and unsorted, go to rans_decode_generic, the counterpart of
    decode_scan_pallas, on every device; on the CPU it runs the plain
    per-lane decode."""
    from cra5_tpu_torch.coder import lane_coder

    calls = []
    real = lane_coder.rans_decode_generic

    def spy(cdf, idx, *rest):
        calls.append(tuple(idx.shape))
        return real(cdf, idx, *rest)

    monkeypatch.setattr(lane_coder, "rans_decode_generic", spy)
    x, _, codec = _pair(setup, "float32")
    out = codec.compress(x)
    x_hat = codec.decompress(out["strings"], out["z_shape"])["x_hat"]
    assert calls == [(32, 1), (128, 1)]
    got = _port_symbols(codec, x)
    with torch.inference_mode():
        want = codec.model.reconstruct_from_y_symbols(got["y_sym"], got["means"])
    assert torch.equal(x_hat, want)
