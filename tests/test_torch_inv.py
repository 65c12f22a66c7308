"""Port vs JAX: InvCompress 2021 (models/inv2021.py) through
AutoregressiveCodec, on the CPU at tests/test_inv_sampled.py's tiny width
(N = M = 8, enh_nf 8) on 64x64 images.

Weights are shared as tests/_torch_pairs.py describes, with the couplings'
zero-initialised last convs set to small seeded values so that the flow is
not the identity. The flow's 1x1 mixes are inverted with torch.linalg.inv
in float32 (JAX: jnp.linalg.inv), so g_s is held by tolerance: floats
within 1e-4 x max|ref|, z symbols exactly, the AR y stream JAX's bytes on
JAX's y and hyper parameters; the port alone rebuilds the encoder's y_hat
exactly. Also C11: JAX's invcompress at qualities 1-3 (N = M = 128)
cannot build, and the port raises a ValueError naming the cause."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pairs import close, image, pair
from cra5_tpu.models import inv2021 as J
from cra5_tpu.models import zoo as jzoo
from cra5_tpu.models.codec import make_codec as j_make_codec
from cra5_tpu_torch import models as pmodels
from cra5_tpu_torch.models import inv2021 as P
from cra5_tpu_torch.models.codec import AutoregressiveCodec, make_codec

KW = dict(N=8, M=8, enh_nf=8)
_PAIR = []


def _tweak(model):
    g = torch.Generator().manual_seed(7)
    for m in model.modules():
        if isinstance(m, P._ZeroConv):
            m.conv.weight.copy_(0.01 * torch.randn(m.conv.weight.shape, generator=g))


def _pair():
    if not _PAIR:
        jm, v, pm = pair(lambda: J.InvCompress(**KW), lambda: P.InvCompress(**KW, device="cpu"),
                         (1, 3, 64, 64), tweak=_tweak)
        _PAIR.extend([(jm, v, pm), j_make_codec(jm, v)])
    return _PAIR[0]


def _jcodec():
    _pair()
    return _PAIR[1]


@pytest.mark.parametrize("shape", [(2, 3, 8, 12), (1, 12, 4, 6)])
def test_squeeze_unsqueeze_equal_jax(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = P.squeeze2d(torch.from_numpy(x))
    assert np.array_equal(got.numpy(), np.asarray(J.squeeze2d(jnp.asarray(x))))
    assert np.array_equal(P.unsqueeze2d(got).numpy(), x)
    if shape[1] % 4 == 0:
        assert np.array_equal(P.unsqueeze2d(torch.from_numpy(x)).numpy(),
                              np.asarray(J.unsqueeze2d(jnp.asarray(x))))


def test_the_flow_matches_jax_both_ways_and_inverts():
    jm, v, pm = _pair()
    x = image(seed=1)
    jinv = J.InvComp(KW["M"], 3)
    jv = {"params": v["params"]["inv"]}
    flow = jax.jit(lambda a, rev: jinv.apply(jv, a, rev=rev), static_argnums=1)
    y = flow(jnp.asarray(x), False)
    with torch.no_grad():
        got = pm.inv(torch.from_numpy(x), rev=False)
        close(got, y, "flow forward")
        assert got.shape == (1, 8, 8, 8)
        back = pm.inv(got, rev=True)
        close(back, flow(y, True), "flow reverse")
        full = P.InvComp(192, 3)
        full.load_state_dict(pm.inv.state_dict())  # M = the flow's channels: no reduction
        xt = torch.from_numpy(x)
        assert torch.allclose(full(full(xt), rev=True), xt, atol=1e-4)


def test_forward_and_device_halves_match_jax():
    jm, v, pm = _pair()
    jc = _jcodec()
    x = image(seed=2)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    a = jc._analysis(v, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
        close(got["x_hat"], want["x_hat"], "x_hat")
        for k in ("y", "z"):
            close(got["likelihoods"][k], want["likelihoods"][k], k)
        b = pm.analysis(torch.from_numpy(x))
        assert np.array_equal(b["z_sym"].numpy(), np.asarray(a["z_sym"]))
        close(b["y"], a["y"], "y")
        close(pm.hyper_synthesis(b["z_sym"]), jc._hyper_synthesis(v, a["z_sym"]), "params")
        close(pm.synthesis(b["y"]), jc._synthesis(v, a["y"]), "synthesis")


def test_ar_y_stream_is_jax_bytes_and_the_roundtrip_rebuilds_y_hat():
    jm, v, pm = _pair()
    jc = _jcodec()
    x = image(seed=3)
    a = jax.device_get(jc._analysis(v, jnp.asarray(x)))
    params = np.asarray(jc._hyper_synthesis(v, a["z_sym"]), np.float32)
    y = np.asarray(a["y"], np.float32)
    codec = make_codec(pm)
    assert isinstance(codec, AutoregressiveCodec)
    codec.update()
    jc.update()
    stream = codec._compress_ar(y[0], params[0])
    assert stream == jc._compress_ar(y[0], params[0])
    y_hat = codec._decompress_ar(stream, params[0], *y.shape[-2:])
    assert np.array_equal(y_hat, codec._encode_ar(y[0], params[0])[2])

    out = codec.compress(x)
    assert out["strings"][1] == [bytes(s) for s in jc.compress(x)["strings"][1]]
    with torch.no_grad():
        b = pm.analysis(torch.from_numpy(x))
        own = pm.hyper_synthesis(b["z_sym"]).numpy()
        ref = pm.synthesis(torch.from_numpy(codec._encode_ar(b["y"][0].numpy(), own[0])[2])[None])
    assert torch.equal(codec.decompress(out["strings"], out["shape"])["x_hat"], ref)


def test_c11_quality_1_to_3_cannot_build_in_jax_and_raises_in_the_port():
    jm = jzoo.create_model("invcompress", 1)
    with pytest.raises(TypeError, match="reshape"):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jax.ShapeDtypeStruct((1, 3, 64, 64), jnp.float32))
    for q in (1, 2, 3):
        with pytest.raises(ValueError, match="M=128"):
            pmodels.create_model("invcompress", q, device="cpu")
    model = pmodels.create_model("invcompress", 4, device="cpu")
    assert (model.N, model.M, model.inv.total_nc) == (192, 192, 192)
