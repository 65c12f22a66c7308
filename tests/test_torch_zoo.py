"""Port vs JAX: the image-codec zoo (models/google.py, waseda.py, codec.py,
zoo.py) on the CPU at N=8, M=12 (N=M=8 for Cheng 2020) on 64x64 images.

Each pair of models shares the flax init's weights (carried across by
convert.load_flax_variables). Floats agree within 1e-4 x max|ref|
(summation order only); symbols are compared exactly. The coders are held
to the JAX codecs byte for byte when fed the same symbols and indexes: the
port model's device method is made to return the JAX model's output, so
both codecs code the same symbols and scales."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import cra5_tpu.models as J
import cra5_tpu_torch.models as P
from cra5_tpu.models.codec import make_codec as j_make_codec
from cra5_tpu_torch import registry
from cra5_tpu_torch.convert import flax_layout, load_flax_variables
from cra5_tpu_torch.models.codec import AutoregressiveCodec, ImageCodec, make_codec

RTOL = 1e-4  # x max|ref|
IMAGE_MODELS = ["FactorizedPrior", "FactorizedPriorReLU", "ScaleHyperprior",
                "MeanScaleHyperprior", "SampledYInBmshj2018"]
AR_MODELS = ["JointAutoregressiveHierarchicalPriors", "Cheng2020Anchor", "Cheng2020Attention"]
ALL = IMAGE_MODELS + AR_MODELS
PORTED_ARCHS = ["bmshj2018-factorized", "bmshj2018-factorized-relu", "bmshj2018-hyperprior",
                "mbt2018-mean", "mbt2018", "cheng2020-anchor", "cheng2020-attn",
                "sampled-y-bmshj2018", "elic2022", "stf", "tcm2023", "invcompress"]


def _nm(name):
    return dict(N=8, M=8) if name.startswith("Cheng") else dict(N=8, M=12)


def _image(b=1, seed=0):
    return np.random.default_rng(seed).random((b, 3, 64, 64)).astype(np.float32)


_PAIRS = {}


def _pair(name):
    """(JAX model, its variables, the port model with those weights)."""
    if name not in _PAIRS:
        jm = getattr(J, name)(**_nm(name))
        v = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(_image())))
        _PAIRS[name] = (jm, v, load_flax_variables(getattr(P, name)(**_nm(name), device="cpu"), v))
    return _PAIRS[name]


def _np(a):
    return a.detach().float().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, what):
    want = np.asarray(want)
    err = np.abs(_np(got) - want).max()
    assert err <= RTOL * np.abs(want).max(), f"{what}: err {err}, max|ref| {np.abs(want).max()}"


@pytest.mark.parametrize("name", ALL)
def test_forward_matches_jax(name):
    jm, v, pm = _pair(name)
    x = _image(seed=1)
    want = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    _close(got["x_hat"], want["x_hat"], "x_hat")
    assert set(got["likelihoods"]) == set(want["likelihoods"])
    for k in want["likelihoods"]:
        _close(got["likelihoods"][k], want["likelihoods"][k], k)
    if "kl" in want:
        _close(got["kl"], want["kl"], "kl")


@pytest.mark.parametrize("name", ALL)
def test_device_halves_give_jax_symbols(name):
    jm, v, pm = _pair(name)
    x = _image(seed=2)
    cls = type(jm)
    with torch.no_grad():
        if name in AR_MODELS:
            want = jm.apply(v, jnp.asarray(x), method=cls.analysis)
            got = pm.analysis(torch.from_numpy(x))
            assert np.array_equal(_np(got["z_sym"]), np.asarray(want["z_sym"]))
            _close(got["y"], want["y"], "y")
            _close(pm.hyper_synthesis(got["z_sym"]),
                   jm.apply(v, want["z_sym"], method=cls.hyper_synthesis), "params")
            return
        want = jm.apply(v, jnp.asarray(x), method=cls.encode_symbols)
        got = pm.encode_symbols(torch.from_numpy(x))
    for k in ("y_sym", "z_sym"):
        if k in want:
            assert got[k].dtype == torch.int32
            assert np.array_equal(_np(got[k]), np.asarray(want[k])), k
    for k in ("scales", "means"):
        if k in want:
            _close(got[k], want[k], k)


def _spy(fn, seen, key):
    """fn, recording its first argument under ``key``."""
    def wrapped(*args, **kwargs):
        seen[key] = args[0]
        return fn(*args, **kwargs)
    return wrapped


def _feed_jax_symbols(pm, jm, v, x):
    """Make the port model's encode_symbols return the JAX model's output."""
    want = jax.device_get(jm.apply(v, jnp.asarray(x), method=type(jm).encode_symbols))
    fed = {k: torch.from_numpy(np.array(a)) if not isinstance(a, tuple) else a
           for k, a in want.items()}
    pm.encode_symbols = lambda _x: fed
    return want


@pytest.mark.parametrize("coder", ["v2", "v1"])
@pytest.mark.parametrize("name", IMAGE_MODELS)
def test_image_codec_writes_jax_bytes_and_recovers_the_symbols(name, coder):
    jm, v, _ = _pair(name)
    pm = load_flax_variables(getattr(P, name)(**_nm(name), device="cpu"), v)
    x = _image(2, seed=3)
    want = _feed_jax_symbols(pm, jm, v, x)
    codec = make_codec(pm, coder=coder)
    assert isinstance(codec, ImageCodec) and codec.kind == jm.CODEC_KIND
    jcodec = j_make_codec(jm, v, coder=coder)
    out, jout = codec.compress(x), jcodec.compress(x)
    assert out["shape"] == tuple(jout["shape"])
    assert out["strings"] == [[bytes(s) for s in group] for group in jout["strings"]]

    seen = {}
    pm.reconstruct = _spy(pm.reconstruct, seen, "y")
    x_hat = codec.decompress(jout["strings"], jout["shape"])["x_hat"]
    assert np.array_equal(_np(seen["y"]), want["y_sym"])
    assert x_hat.shape == (2, 3, 64, 64)
    _close(x_hat, jcodec.decompress(jout["strings"], jout["shape"])["x_hat"], "x_hat")


def test_image_codec_roundtrip_on_its_own_symbols():
    """compress -> decompress on the port alone: x_hat equals reconstruct
    of the encoded symbols, bitwise; a second compress writes the same
    bytes."""
    _, _, pm = _pair("MeanScaleHyperprior")
    x = torch.from_numpy(_image(seed=4))
    for coder in ("v2", "v1"):
        codec = make_codec(pm, coder=coder)
        out = codec.compress(x)
        assert codec.compress(x)["strings"] == out["strings"]
        with torch.no_grad():
            sym = pm.encode_symbols(x)
            ref = pm.reconstruct(sym["y_sym"], sym["means"])
        assert torch.equal(codec.decompress(out["strings"], out["shape"])["x_hat"], ref)


def _ar_inputs(name, seed=5):
    jm, v, pm = _pair(name)
    cls = type(jm)
    x = _image(seed=seed)
    a = jax.device_get(jm.apply(v, jnp.asarray(x), method=cls.analysis))
    params = np.asarray(jm.apply(v, jnp.asarray(a["z_sym"]), method=cls.hyper_synthesis),
                        np.float32)
    return jm, v, pm, np.asarray(a["y"], np.float32), params


@pytest.mark.parametrize("name", AR_MODELS)
def test_ar_codec_y_stream_is_jax_bytes_and_decodes_back(name):
    jm, v, pm, y, params = _ar_inputs(name)
    codec = make_codec(pm)
    assert isinstance(codec, AutoregressiveCodec)
    jcodec = j_make_codec(jm, v)
    codec.update()
    jcodec.update()
    stream = codec._compress_ar(y[0], params[0])
    assert stream == jcodec._compress_ar(y[0], params[0])
    H, W = y.shape[-2:]
    y_hat = codec._decompress_ar(stream, params[0], H, W)
    assert np.array_equal(y_hat, jcodec._decompress_ar(stream, params[0], H, W))
    assert np.array_equal(y_hat, codec._encode_ar(y[0], params[0])[2])


@pytest.mark.parametrize("name", AR_MODELS)
def test_ar_codec_roundtrip(name):
    """The port's AR codec alone: decompress rebuilds the encoder's y_hat
    exactly (x_hat equals synthesis of it, bitwise), and the z stream is
    JAX's."""
    jm, v, pm = _pair(name)
    x = _image(seed=6)
    codec = make_codec(pm)
    out = codec.compress(x)
    assert out["strings"][1] == [bytes(s) for s in j_make_codec(jm, v).compress(x)["strings"][1]]
    with torch.no_grad():
        a = pm.analysis(torch.from_numpy(x))
        params = pm.hyper_synthesis(a["z_sym"]).numpy()
    _, _, y_hat = codec._encode_ar(a["y"][0].numpy(), params[0])
    x_hat = codec.decompress(out["strings"], out["shape"])["x_hat"]
    with torch.no_grad():
        assert torch.equal(x_hat, pm.synthesis(torch.from_numpy(y_hat)[None]))
    assert x_hat.shape == (1, 3, 64, 64)


def test_load_model_reads_a_flax_msgpack(tmp_path):
    """load_model(pretrained=True) on a .msgpack written by flax's
    serializer gives the JAX model's weights (full zoo width, q1)."""
    jm = J.create_model("bmshj2018-factorized", 1)
    x = _image(seed=7)
    v = jax.device_get(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    path = tmp_path / "bmshj2018-factorized-1.msgpack"
    path.write_bytes(serialization.to_bytes(v))
    model, codec = P.load_model("bmshj2018-factorized", 1, pretrained=True,
                                checkpoint_path=str(path), device="cpu")
    assert (model.N, model.M) == (128, 192) and isinstance(codec, ImageCodec)
    with torch.no_grad():
        got = model(torch.from_numpy(x))["x_hat"]
    _close(got, jm.apply(v, jnp.asarray(x))["x_hat"], "x_hat")
    os.environ["CRA5_TPU_CKPT_DIR"] = str(tmp_path)
    try:
        again, _ = P.load_model("bmshj2018-factorized", 1, pretrained=True, device="cpu")
    finally:
        del os.environ["CRA5_TPU_CKPT_DIR"]
    assert all(torch.equal(p, again.get_parameter(k)) for k, p in model.named_parameters())


def test_zoo_tables_keep_every_key_and_build_the_ported():
    assert P.cfgs == J.cfgs
    assert set(P.model_architectures) == set(J.model_architectures)
    for arch in PORTED_ARCHS:
        q = 4 if arch == "invcompress" else min(P.cfgs[arch])  # q1-3 cannot build (C11)
        model = P.create_model(arch, q, device="cpu")
        jm = J.create_model(arch, q)
        assert type(model).__name__ == type(jm).__name__
        assert (model.N, model.M) == (jm.N, jm.M)
    assert isinstance(P.create_model("vaeformer-pretrained", 268, device="cpu"), P.VAEformer)
    model = P.init_model(P.create_model("mbt2018-mean", 1, device="cpu"), seed=3)
    assert len(flax_layout(model)) == len(list(model.parameters()))


@pytest.mark.parametrize("arch", ["elic2022", "stf", "tcm2023", "invcompress"])
def test_context_model_architectures_build_at_the_jax_widths(arch):
    """q4 of each: every parameter of the port's model at the shape of the
    JAX model's leaf (jax.eval_shape of its init), TCM's at its published
    block's, the plain reference's names and shapes (ROADMAP C21), and
    load_model gives the codec its CODEC_KIND names."""
    from cra5_tpu_torch.convert import to_flax_params

    model, codec = P.load_model(arch, 4, device="cpu")
    if arch == "tcm2023":
        import reference_tcm2023

        shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
        assert shapes == reference_tcm2023.param_shapes({})
    else:
        want = jax.eval_shape(J.create_model(arch, 4).init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, 3, 64, 64), jnp.float32))
        flat = lambda t, p="": {k2: v2 for k, v in t.items() for k2, v2 in (  # noqa: E731
            flat(v, f"{p}/{k}").items() if isinstance(v, dict) else
            [(f"{p}/{k}", tuple(v.shape))])}
        assert flat(to_flax_params(model, dict(model.named_parameters()))) == flat(
            want["params"])
    kind = {"elic": "ElicCodec", "charm": "CharmCodec", "autoregressive": "AutoregressiveCodec"}
    assert type(codec).__name__ == kind[model.CODEC_KIND]


def test_zoo_refuses_what_jax_refuses_and_what_is_not_ported():
    with pytest.raises(ValueError):
        P.create_model("nope", 1, device="cpu")
    with pytest.raises(ValueError):
        P.create_model("mbt2018", 99, device="cpu")
    with pytest.raises(ValueError, match="metric"):
        P.ssf2020(1, metric="psnr")
    with pytest.raises(ValueError, match="quality"):
        P.ssf2020(10)
    # ssf2020 is ported: it builds (model, state, codec) once its arguments pass
    model, state, codec = P.ssf2020(3, "ms-ssim", device="cpu", num_levels=2, mid_planes=8,
                                    planes=8)
    assert isinstance(model, P.ScaleSpaceFlow) and isinstance(codec, P.ScaleSpaceFlowCodec)
    assert model.num_levels == 2 and set(state) == set(model.state_dict())
    for kind, codec_cls in (("elic", P.ElicCodec), ("charm", P.CharmCodec)):
        stub = type("Stub", (), {"CODEC_KIND": kind, "device": torch.device("cpu")})()
        assert type(make_codec(stub)) is codec_cls and make_codec(stub, coder="v1").coder == "v2"
    with pytest.raises(ValueError, match="coder"):
        ImageCodec(_pair("ScaleHyperprior")[2], coder="v3")


def test_make_codec_routes_the_vaeformer():
    from cra5_tpu_torch.models.vaeformer import VAEformer, VAEformerCodec, vaeformer_tiny

    assert isinstance(make_codec(VAEformer(vaeformer_tiny(), device="cpu")), VAEformerCodec)


def test_registry_builds_the_zoo_models():
    for name in ALL:
        assert name in registry.MODELS.keys() and name not in registry.NOT_PORTED["models"]
        model = registry.MODELS.build({"type": name, **_nm(name)}, device="cpu")
        assert isinstance(model, getattr(P, name))
