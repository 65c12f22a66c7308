"""Port vs JAX: the seven latent codecs of models/latent_codecs.py on the
CPU, mirroring tests/test_latent_codecs.py. Each pair shares the flax
init's variables (moved off the init, so the gains and biases matter),
carried across by convert.load_flax_variables; the eval-mode outputs
(y_hat, parameters, likelihoods) agree within 1e-5 x max|ref|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cra5_tpu.models import latent_codecs as J
from cra5_tpu.models.google import _ConvStack as JStack
from cra5_tpu.nn.conv import MaskedConv2d as JMasked
from cra5_tpu_torch.convert import load_flax_variables
from cra5_tpu_torch.models import latent_codecs as P
from cra5_tpu_torch.models.google import _ConvStack as PStack
from cra5_tpu_torch.nn.conv import MaskedConv2d as PMasked

RTOL = 1e-5


def _y(shape=(1, 8, 8, 8), seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 2.0).astype(np.float32)


def _mini_h():
    """(flax h_a, h_s), (port h_a, h_s): z of 4 channels from y of 8, and
    16 entropy parameters back."""
    j = (JStack((("conv", 4, 3, 1), ("relu",), ("conv", 4, 5, 2)), name="h_a"),
         JStack((("deconv", 16, 5, 2),), name="h_s"))
    p = (PStack((("conv", 4, 3, 1), ("relu",), ("conv", 4, 5, 2)), 8, "cpu"),
         PStack((("deconv", 16, 5, 2),), 4, "cpu"))
    return j, p


def _carry(jcodec, pcodec, *args, seed=1):
    v = jax.device_get(jcodec.init(jax.random.PRNGKey(1), *args))
    rng = np.random.default_rng(seed)
    v = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
        np.float32), v)
    return v, load_flax_variables(pcodec, v)


def _close(got, want, what):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= RTOL * max(np.abs(want).max(), 1e-30), f"{what}: err {err}"


def _compare(jout, pout):
    for k in ("y_hat", "parameters"):
        if k in jout:
            _close(pout[k], jout[k], k)
    assert set(pout["likelihoods"]) == set(jout["likelihoods"])
    for k, v in jout["likelihoods"].items():
        _close(pout["likelihoods"][k], v, k)


def _run(jcodec, pcodec, *args, **kwargs):
    v, pcodec = _carry(jcodec, pcodec, *args)
    jout = jcodec.apply(v, *args, **kwargs)
    with torch.no_grad():
        pout = pcodec(*[torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray) else a
                        for a in args], **kwargs)
    _compare(jout, pout)
    return v, pcodec


def test_eb_latent_codec():
    y = _y()
    _run(J.EntropyBottleneckLatentCodec(channels=8), P.EntropyBottleneckLatentCodec(8, "cpu"), y)


@pytest.mark.parametrize("quantizer,chunk", [("ste", ("scales", "means")),
                                             ("noise", ("means", "scales"))])
def test_gc_latent_codec(quantizer, chunk):
    y = _y()
    ctx = _y((1, 16, 8, 8), 2)
    ctx[:, :8] = np.abs(ctx[:, :8])  # positive scales in the first half
    _run(J.GaussianConditionalLatentCodec(quantizer=quantizer, chunk=chunk),
         P.GaussianConditionalLatentCodec(quantizer=quantizer, chunk=chunk), y, ctx)


def test_gc_latent_codec_with_entropy_parameters():
    y, ctx = _y(), _y((1, 16, 8, 8), 3)
    _run(J.GaussianConditionalLatentCodec(
        entropy_parameters=JStack((("conv", 16, 1, 1),), name="ep")),
        P.GaussianConditionalLatentCodec(
            entropy_parameters=PStack((("conv", 16, 1, 1),), 16, "cpu")), y, ctx)


def test_hyper_latent_codec():
    (ja, js), (pa, ps) = _mini_h()
    _run(J.HyperLatentCodec(z_channels=4, h_a=ja, h_s=js),
         P.HyperLatentCodec(4, pa, ps, device="cpu"), _y())


def test_hyperprior_latent_codec_composition():
    (ja, js), (pa, ps) = _mini_h()
    _run(J.HyperpriorLatentCodec(z_channels=4, h_a=ja, h_s=js),
         P.HyperpriorLatentCodec(4, pa, ps, device="cpu"), _y())


def test_rasterscan_latent_codec():
    M = 8
    jc = J.RasterScanLatentCodec(M=M, context_prediction=JMasked(2 * M, 5, "A", name="cp"),
                                 entropy_parameters=JStack((("conv", 2 * M, 1, 1),), name="ep"))
    pc = P.RasterScanLatentCodec(M, PMasked(M, 2 * M, 5, "A", device="cpu"),
                                 PStack((("conv", 2 * M, 1, 1),), 4 * M, "cpu"))
    _run(jc, pc, _y(), _y((1, 2 * M, 8, 8), 4))


@pytest.mark.parametrize("gain_index", [0, 1])
def test_gain_hyper_latent_codec(gain_index):
    (ja, js), (pa, ps) = _mini_h()
    y = _y()
    v, pc = _carry(J.GainHyperLatentCodec(z_channels=4, num_gains=2, h_a=ja, h_s=js),
                   P.GainHyperLatentCodec(4, 2, pa, ps, device="cpu"), y, 0)
    jout = J.GainHyperLatentCodec(z_channels=4, num_gains=2, h_a=ja, h_s=js).apply(
        v, jnp.asarray(y), gain_index)
    with torch.no_grad():
        _compare(jout, pc(torch.from_numpy(y), gain_index))


@pytest.mark.parametrize("gain_index", [0, 1])
def test_gain_hyperprior_latent_codec(gain_index):
    (ja, js), (pa, ps) = _mini_h()
    y = _y()
    jc = J.GainHyperpriorLatentCodec(z_channels=4, y_channels=8, num_gains=2, h_a=ja, h_s=js)
    v, pc = _carry(jc, P.GainHyperpriorLatentCodec(4, 8, 2, pa, ps, device="cpu"), y, 0)
    with torch.no_grad():
        _compare(jc.apply(v, jnp.asarray(y), gain_index), pc(torch.from_numpy(y), gain_index))


def test_gain_hyperprior_rate_ladder():
    """Larger gains -> finer quantization -> more bits on y."""
    (_, _), (pa, ps) = _mini_h()
    codec = P.GainHyperpriorLatentCodec(4, 8, 2, pa, ps, device="cpu")
    with torch.no_grad():
        codec.y_gain.copy_(torch.tensor([[4.0] * 8, [0.25] * 8]))
    y = torch.from_numpy(_y())

    def bits(gain_index):
        with torch.no_grad():
            return float(-torch.log2(codec(y, gain_index)["likelihoods"]["y"]).sum())

    assert bits(0) > bits(1)


def test_shared_transforms_are_listed_once():
    """A transform handed to a codec and to its inner hyper codec is one
    module: its parameters appear once, under the outer name."""
    (_, _), (pa, ps) = _mini_h()
    codec = P.HyperpriorLatentCodec(4, pa, ps, device="cpu")
    names = [n for n, _ in codec.named_parameters()]
    assert codec.hyper.h_a is codec.h_a and len(names) == len(set(names))
    assert any(n.startswith("h_a.") for n in names) and not any("hyper.h_a" in n for n in names)
