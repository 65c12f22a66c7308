"""Port vs JAX: the rest of VAEformerCodec at vaeformer_tiny in float32 --
both coders, batches of two, compress_from_latent, the latent decompress
and the float paths (forward, encode_latent, decode_latent).

The two codecs share the flax init's weights. float32 tiny symbols and
CDF indexes are exact across the packages, so streams are compared byte
for byte; floats agree within 1e-5 (summation order only)."""

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

ATOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    cfg = j_tiny()
    x = np.random.default_rng(11).standard_normal((2, cfg.in_chans, *cfg.img_size)).astype(np.float32)
    variables = jax.device_get(JVAEformer(cfg).init(jax.random.PRNGKey(1), jnp.asarray(x[:1])))
    model = load_flax_variables(VAEformer(vaeformer_tiny(), device="cpu"), variables)
    codecs = {c: (JCodec(JVAEformer(cfg), variables, coder=c), VAEformerCodec(model, coder=c))
              for c in ("v2", "v1")}
    return x, codecs


def _np(a):
    return a.detach().float().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("coder", ["v2", "v1"])
def test_batch_of_two_writes_the_bytes_of_two_single_calls(setup, coder):
    x, codecs = setup
    jcodec, codec = codecs[coder]
    out = codec.compress(x)
    singles = [codec.compress(x[i:i + 1]) for i in range(2)]
    for k in (0, 1):  # y strings, z strings
        assert out["strings"][k] == [s["strings"][k][0] for s in singles]
    assert [list(s) for s in jcodec.compress(x)["strings"]] == out["strings"]
    x_hat = codec.decompress(out["strings"], out["z_shape"])["x_hat"]
    for i, s in enumerate(singles):
        one = codec.decompress(s["strings"], s["z_shape"])["x_hat"]
        assert torch.equal(x_hat[i:i + 1], one)
    np.testing.assert_allclose(_np(x_hat), _np(jcodec.decompress(out["strings"], out["z_shape"])["x_hat"]),
                               atol=ATOL)


@pytest.mark.parametrize("coder", ["v2", "v1"])
def test_compress_from_latent_equals_jax_and_compress(setup, coder):
    x, codecs = setup
    jcodec, codec = codecs[coder]
    y = np.array(jcodec.encode_latent(x))
    np.testing.assert_allclose(_np(codec.encode_latent(x)), y, atol=ATOL)
    out = codec.compress_from_latent(y)
    assert out["strings"] == [list(s) for s in jcodec.compress_from_latent(y)["strings"]]
    assert out["strings"] == codec.compress(x)["strings"]
    assert out["z_shape"] == (2, 2)


@pytest.mark.parametrize("coder", ["v2", "v1"])
def test_latent_decompress_equals_jax(setup, coder):
    x, codecs = setup
    jcodec, codec = codecs[coder]
    out = codec.compress(x)
    lat = codec.decompress(out["strings"], out["z_shape"], return_format="latent")
    want = jcodec.decompress(out["strings"], out["z_shape"], return_format="latent")
    assert lat.dtype == torch.float32 and tuple(lat.shape) == want.shape == (2, 8, 4, 4)
    np.testing.assert_allclose(_np(lat), want, atol=ATOL)
    np.testing.assert_allclose(_np(codec.decode_latent(lat)), _np(jcodec.decode_latent(want)),
                               atol=ATOL)
    assert torch.equal(codec.decode_latent(lat),
                       codec.decompress(out["strings"], out["z_shape"])["x_hat"])


def test_codec_forward_equals_jax(setup):
    x, codecs = setup
    jcodec, codec = codecs["v2"]
    got, want = codec.forward(x), jcodec.forward(x)
    for key in ("x_hat", "posterior_mean", "posterior_logvar", "kl"):
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), atol=ATOL, err_msg=key)
    for key in ("y", "z"):
        np.testing.assert_allclose(_np(got["likelihoods"][key]), _np(want["likelihoods"][key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)


def test_codec_refuses_unknown_options(setup):
    _, codecs = setup
    codec = codecs["v2"][1]
    with pytest.raises(ValueError, match="coder"):
        VAEformerCodec(codec.model, coder="v3")
    out = codec.compress(setup[0][:1])
    with pytest.raises(ValueError, match="return_format"):
        codec.decompress(out["strings"], out["z_shape"], return_format="symbols")
