"""Port vs JAX: the ERA5 VAEformer variants and the patch geometries.

The same numpy-seeded inputs and the same flax params (seeded random
values on JAX's ``jax.eval_shape`` tree, as ``test_torch_model.py`` makes
them, so no JAX init compiles) go through both packages:

  - ``PatchEmbed`` / ``PatchUnembed`` at geometries off the fast path
    (JAX's ``conv_general_dilated`` / ``conv_transpose``; the port's
    im2col / col2im matmuls);
  - ``ViTEncoder`` / ``ViTDecoder`` at those geometries;
  - ``VariationCNNPrior`` in both modes and the former baseline: the
    forward, the float32 symbols and GC indexes, and ``VAEformerCodec``'s
    bytes with the v1 and v2 coders; in bf16, z symbols past 256 decode
    to the encoder's scales;
  - ``VITAutoencoderKL``'s mode path, and its sampled path;
  - the param trees (the port's names are the flax paths), two Trainer
    steps, the train CLI, and C9 (JAX's 268v former baseline cannot
    build).

Tolerances: float32 towers differ only in summation order, so x_hat,
moments and tower outputs agree within 1e-5 (``test_torch_model.py``'s
XHAT_ATOL), likelihoods and the KL within rtol 1e-5; bf16 symbols within
one (C2); symbols, indexes and bytes in float32 exactly; the Trainer's
metrics within rtol 1e-3 and its parameters within 1e-3 of each leaf's
largest entry (``test_torch_train.py``'s bounds)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cra5_tpu.entropy import entropy_bottleneck as j_ebm
from cra5_tpu.entropy import gaussian_conditional as j_gcm
from cra5_tpu.entropy import ops as j_ops
from cra5_tpu.models.baseline import VariationCNNPrior as JVCP
from cra5_tpu.models.baseline import vaeformer_former_baseline as j_former
from cra5_tpu.models.baseline import vaeformer_former_baseline_tiny as j_former_tiny
from cra5_tpu.models.vaeformer import VAEformer as JVAEformer
from cra5_tpu.models.vaeformer import VAEformerCodec as JCodec
from cra5_tpu.models.vaeformer import vaeformer_tiny as j_tiny
from cra5_tpu.models.vit_vae import VITAutoencoderKL as JVKL
from cra5_tpu.nn.patch_embed import PatchEmbed as JPatchEmbed
from cra5_tpu.nn.patch_embed import PatchUnembed as JPatchUnembed
from cra5_tpu.nn.vit import ViTDecoder as JViTDecoder
from cra5_tpu.nn.vit import ViTEncoder as JViTEncoder
from cra5_tpu.train.ema import ema_init as j_ema_init
from cra5_tpu.train.loop import TrainerConfig as JTrainerConfig
from cra5_tpu.train.loop import TrainState as JTrainState
from cra5_tpu.train.loop import make_train_step as j_make_train_step
from cra5_tpu.train.optim import make_net_aux_optimizers as j_make_tx
from cra5_tpu_torch import convert
from cra5_tpu_torch.convert import load_flax_variables
from cra5_tpu_torch.entropy import entropy_bottleneck as ebm
from cra5_tpu_torch.entropy import gaussian_conditional as gcm
from cra5_tpu_torch.entropy import ops
from cra5_tpu_torch.models import (VAEformer, VAEformerCodec, VariationCNNPrior,
                                   VITAutoencoderKL, make_codec, vaeformer_268,
                                   vaeformer_former_baseline, vaeformer_former_baseline_tiny,
                                   vaeformer_tiny)
from cra5_tpu_torch.models.codec import ImageCodec
from cra5_tpu_torch.nn.patch_embed import PatchEmbed, PatchUnembed
from cra5_tpu_torch.nn.vit import ViTDecoder, ViTEncoder
from cra5_tpu_torch.train import TrainerConfig, TrainState, make_net_aux_optimizers, make_train_step
from cra5_tpu_torch.train.ema import ema_init
from test_torch_model import _random_variables

ATOL = 1e-5  # float32 towers: summation order only
LIK_RTOL = 1e-5
T = dict(window_sizes=((2, 2), (1, 4), (4, 1)), interval=2)  # vaeformer_tiny's windows


def _x(cfg, seed=7, batch=1):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.in_chans, *cfg.img_size)).astype(np.float32) * 0.5


def _variables(jmodel, x, *static, seed=3, **kw):
    """Seeded random values on the tree of ``jmodel.init(key, x, *static,
    **kw)``, its shapes from ``jax.eval_shape``."""
    shapes = jax.eval_shape(lambda k, a: jmodel.init(k, a, *static, **kw),
                            jax.random.PRNGKey(0), x)
    return _random_variables(shapes, np.random.default_rng(seed))


def _close(got, want, atol=ATOL, rtol=ATOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=rtol,
                               err_msg=what)


# --------------------------------------------------------------- patch paths
# (patch, stride, (H, W)): rows and columns overlapping, a kernel shorter
# than its stride (lax.conv_transpose pads the output to Hp * s), and the
# fast geometry at a width that is not a whole number of patches
GEOMETRIES = [((3, 5), (2, 3), (13, 17)), ((2, 2), (3, 3), (11, 14)),
              ((11, 10), (10, 10), (41, 43)), ((4, 4), (4, 4), (16, 20))]


@pytest.mark.parametrize("patch,stride,hw", GEOMETRIES, ids=lambda g: str(g))
def test_patch_embed_and_unembed_at_other_geometries(patch, stride, hw):
    rng = np.random.default_rng(0)
    C, D = 3, 6
    x = rng.standard_normal((2, C, *hw)).astype(np.float32)
    jemb = JPatchEmbed(D, patch, stride)
    v = _variables(jemb, jnp.asarray(x))
    (jtok, grid) = jemb.apply(v, jnp.asarray(x))
    emb = load_flax_variables(PatchEmbed(C, D, patch, stride), v)
    tok, g = emb(torch.from_numpy(x))
    assert g == tuple(grid)
    _close(tok, jtok, what="embed")

    junemb = JPatchUnembed(C, patch, stride)
    tokens = rng.standard_normal(np.asarray(jtok).shape).astype(np.float32)
    vu = _variables(junemb, jnp.asarray(tokens), grid)
    want = junemb.apply(vu, jnp.asarray(tokens), grid)
    unemb = load_flax_variables(PatchUnembed(D, C, patch, stride), vu)
    got = unemb(torch.from_numpy(tokens), g)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, what="unembed")


# ------------------------------------------------------------- ViT towers
@pytest.mark.parametrize("patch,stride,hw", GEOMETRIES[:1], ids=lambda g: str(g))
def test_vit_towers_at_other_patch_geometries(patch, stride, hw):
    """g_a then g_s at a patch geometry off the fast path, against JAX's."""
    kw = dict(img_size=hw, patch_size=patch, patch_stride=stride, embed_dim=16, depth=2,
              num_heads=2, **T)
    x = np.random.default_rng(2).standard_normal((1, 3, *hw)).astype(np.float32)
    jenc, jdec = JViTEncoder(**kw, in_chans=3), JViTDecoder(**kw, out_chans=3)
    venc = _variables(jenc, jnp.asarray(x))
    moments = jenc.apply(venc, jnp.asarray(x))
    feat = np.array(moments[:, :16])
    vdec = _variables(jdec, jnp.asarray(feat))
    want = jdec.apply(vdec, jnp.asarray(feat))
    enc = load_flax_variables(ViTEncoder(**kw, in_chans=3), venc)
    dec = load_flax_variables(ViTDecoder(**kw, out_chans=3), vdec)
    with torch.no_grad():
        got_m = enc(torch.from_numpy(x))
        got = dec(torch.from_numpy(feat))
    _close(got_m, moments, what="g_a")
    assert tuple(got.shape) == want.shape
    _close(got, want, what="g_s")


def test_use_conv_transpose_false_is_not_ported():
    """The linear un-patchify raised NotImplementedError before the JAX
    towers' options were ported. It now builds as JAX's does: g_s ends in
    a bias-free Dense named ``final`` (the flax path ``g_s/final/kernel``)
    and gives x at the patch grid's size, Hp * p1 rows; the default keeps
    the exact ConvTranspose (``tests/test_torch_tower_options.py`` holds
    both against JAX)."""
    cfg = dataclasses.replace(vaeformer_tiny(), use_conv_transpose=False)
    model = VAEformer(cfg, device="cpu").reset_parameters(0)
    assert isinstance(model.g_s.final, torch.nn.Linear) and model.g_s.final.bias is None
    assert convert.flax_layout(model)["g_s.final.weight"] == ("g_s/final/kernel", "dense")
    x = torch.from_numpy(_x(cfg))
    with torch.no_grad():
        x_hat = model(x)["x_hat"]
    (Hp, Wp), (p1, p2) = cfg.latent_grid, cfg.patch_size
    assert tuple(x_hat.shape) == (1, cfg.in_chans, Hp * p1, Wp * p2)
    assert torch.isfinite(x_hat).all()
    assert isinstance(VAEformer(vaeformer_tiny(), device="cpu").g_s.final, PatchUnembed)


# ------------------------------------------------------------------ variants
# name: (the JAX module, the port's model), each built with dtype= (and
# the port's with device=)
VARIANTS = {
    "cnn_prior": (lambda **k: JVCP(j_tiny(), **k),
                  lambda **k: VariationCNNPrior(vaeformer_tiny(), **k)),
    "mean_scale": (lambda **k: JVCP(j_tiny(), variational=False, **k),
                   lambda **k: VariationCNNPrior(vaeformer_tiny(), variational=False, **k)),
    "former": (lambda **k: JVAEformer(j_former_tiny(), **k),
               lambda **k: VAEformer(vaeformer_former_baseline_tiny(), **k)),
}


@pytest.fixture(scope="module")
def params():
    """Each variant's flax variables, and the input."""
    x = _x(j_tiny())
    return x, {k: _variables(jm(), jnp.asarray(x)) for k, (jm, _) in VARIANTS.items()}


def _port(params, name, dtype=torch.float32):
    return load_flax_variables(VARIANTS[name][1](dtype=dtype, device="cpu"),
                               params[1][name])


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_forward_matches_jax(params, name):
    x, variables = params
    want = VARIANTS[name][0]().apply(variables[name], jnp.asarray(x))
    with torch.no_grad():
        got = _port(params, name)(torch.from_numpy(x))
    _close(got["x_hat"], want["x_hat"])
    for k in ("y", "z"):
        _close(got["likelihoods"][k], want["likelihoods"][k], atol=1e-7, rtol=LIK_RTOL, what=k)
    _close(got["kl"], want["kl"], atol=0, rtol=LIK_RTOL, what="kl")
    if name == "mean_scale":
        assert torch.equal(got["kl"], torch.zeros(1))


def _codec_pair(params, name, coder, dtype="float32"):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcodec = JCodec(VARIANTS[name][0](dtype=jd), params[1][name], coder=coder)
    jcodec.update()
    codec = VAEformerCodec(_port(params, name, td), coder=coder)
    codec.update()
    return jcodec, codec


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_float32_symbols_and_indexes_exact(params, name):
    x = params[0]
    jcodec, codec = _codec_pair(params, name, "v2")
    want = jcodec._encode_symbols(jcodec.variables, jnp.asarray(x), jcodec._scale_table_dev)
    with torch.inference_mode():
        got = codec.model.encode_symbols(torch.from_numpy(x))
        got["gc_idx"] = codec._gc_indexes(got["scales"])
        x_hat = codec.model.reconstruct_from_y_symbols(got["y_sym"], got["means"])
    for key in ("z_sym", "y_sym", "gc_idx"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    _close(x_hat, jcodec._reconstruct(jcodec.variables, want["y_sym"], want["means"]))


@pytest.mark.parametrize("coder", ["v1", "v2"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_codec_bytes_equal_jax(params, name, coder):
    """VAEformerCodec around each variant writes JAX's bytes; each package
    decodes the other's streams to the same x_hat."""
    x = np.concatenate([params[0], _x(j_tiny(), seed=8)])  # batch 2
    jcodec, codec = _codec_pair(params, name, coder)
    jout, out = jcodec.compress(x), codec.compress(x)
    assert out["strings"] == [list(g) for g in jout["strings"]]
    assert out["z_shape"] == tuple(jout["z_shape"])
    mine = codec.decompress(jout["strings"], jout["z_shape"])["x_hat"]
    theirs = jcodec.decompress(out["strings"], out["z_shape"])["x_hat"]
    assert tuple(mine.shape) == (2, 8, 41, 40)
    _close(mine, theirs)


def test_cnn_prior_bf16_symbols_within_one(params):
    """bf16 g_a rounds at other places in the two packages (C2): a symbol
    on a rounding boundary may move by one, no further, and 90% agree.
    The conv hyperprior computes in float32 in both."""
    x = params[0]
    jcodec, codec = _codec_pair(params, "cnn_prior", "v2", "bfloat16")
    want = jcodec._encode_symbols(jcodec.variables, jnp.asarray(x), jcodec._scale_table_dev)
    with torch.inference_mode():
        got = codec.model.encode_symbols(torch.from_numpy(x))
        got["gc_idx"] = codec._gc_indexes(got["scales"])
    assert got["scales"].dtype == torch.float32
    for key in ("z_sym", "y_sym", "gc_idx"):
        d = np.abs(got[key].numpy().astype(np.int64) - np.asarray(want[key]))
        assert d.max() <= 1 and (d == 0).mean() >= 0.9, key


def test_cnn_prior_bf16_wide_z_symbols_decode_exactly(params):
    """bf16 holds integers exactly only up to 256: with h_a's last conv
    scaled so z symbols pass that, the decoder's scales from the z symbols
    still equal the encoder's bitwise, and y decodes to the encoder's
    symbols."""
    from cra5_tpu_torch import bench

    codec = VAEformerCodec(_port(params, "cnn_prior", torch.bfloat16), coder="v2")
    with torch.no_grad():
        codec.model.h_a.l4.conv.weight.mul_(4096.0)
    codec.update()
    x = params[0]
    with torch.inference_mode():
        enc = codec.model.encode_symbols(torch.from_numpy(x))
        scales, means = codec.model.scales_from_z_symbols(enc["z_sym"])
    z_sym = enc["z_sym"]
    assert not torch.equal(z_sym.to(torch.bfloat16).int(), z_sym)  # bf16 cannot hold them
    assert torch.equal(scales, enc["scales"]) and torch.equal(means, enc["means"])
    out = codec.compress(x)
    z_dec, y_dec = bench.decode_symbols(codec, out["strings"], out["z_shape"])
    assert torch.equal(z_dec, enc["z_sym"]) and torch.equal(y_dec, enc["y_sym"])


def test_former_baseline_has_no_quant_convs(params):
    assert not j_former_tiny().lower_dim and not vaeformer_former_baseline_tiny().lower_dim
    assert "quant_conv" not in params[1]["former"]["params"]
    model = _port(params, "former")
    assert not hasattr(model, "quant_conv") and not hasattr(model, "post_quant_conv")
    assert all("quant_conv" not in n for n, _ in model.named_parameters())


def test_variation_cnn_prior_gets_the_image_codec():
    """Like JAX's, it has no CODEC_KIND: make_codec gives it the
    ImageCodec, and it is coded by wrapping it in VAEformerCodec."""
    model = VariationCNNPrior(vaeformer_tiny(), device="cpu")
    assert not hasattr(model, "CODEC_KIND")
    assert type(make_codec(model)) is ImageCodec


@pytest.mark.parametrize("name", list(VARIANTS) + ["vit_vae"])
def test_param_trees_round_trip_bitwise(params, name):
    """The port's params laid out as flax (``to_flax_params``) have JAX's
    tree, leaf for leaf and shape for shape, and come back bitwise."""
    if name == "vit_vae":
        x = params[0]
        jshapes = jax.eval_shape(lambda k, a: JVKL(j_tiny()).init(k, a, sample_posterior=False),
                                 jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        model = VITAutoencoderKL(vaeformer_tiny(), device="cpu").reset_parameters(1)
    else:
        jshapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                               params[1][name]["params"])
        model = VARIANTS[name][1](device="cpu").reset_parameters(1)
    tree = convert.to_flax_params(model, dict(model.named_parameters()))
    assert jax.tree.structure(tree) == jax.tree.structure(jshapes)
    assert all(a.shape == b.shape for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jshapes)))
    back = convert.from_flax_params(model, {"params": tree})
    for n, p in model.named_parameters():
        assert np.array_equal(back[n], p.detach().numpy()), n


# ------------------------------------------------------------ VITAutoencoderKL
def test_vit_autoencoder_kl_mode_and_sampled_paths():
    cfg = j_tiny()
    x = np.concatenate([_x(cfg), _x(cfg, seed=9)])
    jm = JVKL(cfg)
    v = _variables(jm, jnp.asarray(x), sample_posterior=False)
    want = jm.apply(v, jnp.asarray(x), sample_posterior=False)
    model = load_flax_variables(VITAutoencoderKL(vaeformer_tiny(), device="cpu"), v)
    with torch.no_grad():
        got = model(torch.from_numpy(x), sample_posterior=False)
        sampled = model(torch.from_numpy(x), generator=torch.Generator().manual_seed(2))
        unseeded = model(torch.from_numpy(x))  # no generator: the mode
    for k in ("x_hat", "posterior_mean", "posterior_logvar"):
        _close(got[k], want[k], what=k)
    _close(got["kl"], want["kl"], atol=0, rtol=LIK_RTOL, what="kl")
    assert got["kl"].shape == (2,) and torch.isfinite(got["kl"]).all()
    assert torch.equal(unseeded["x_hat"], got["x_hat"])
    assert not np.allclose(sampled["x_hat"].numpy(), got["x_hat"].numpy())
    j_sampled = jm.apply(v, jnp.asarray(x), sample_posterior=True, rng=jax.random.PRNGKey(2))
    assert not np.allclose(np.asarray(j_sampled["x_hat"]), np.asarray(want["x_hat"]))


# ----------------------------------------------------------------------- C9
def test_c9_jax_268v_former_baseline_cannot_build_and_the_ports_can():
    """JAX's 268v former baseline keeps embed_dim=256 while y carries the
    ViT's 1024 channels: its GaussianConditional cannot broadcast. The
    port's config sets embed_dim = y_channels, as both tiny variants do;
    with that one field changed JAX's builds, y of (1, 1024, 72, 144)."""
    x = jax.ShapeDtypeStruct((1, 268, 721, 1440), jnp.float32)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(JVAEformer(j_former()).init, jax.random.PRNGKey(0), x)
    mine = vaeformer_former_baseline()
    assert mine.embed_dim == mine.y_channels == 1024 and not mine.lower_dim
    want = dataclasses.replace(j_former(), embed_dim=1024)
    assert dataclasses.asdict(mine) == dataclasses.asdict(want)
    assert {k: v for k, v in dataclasses.asdict(mine).items()
            if k not in ("embed_dim", "lower_dim", "name")} == {
        k: v for k, v in dataclasses.asdict(vaeformer_268()).items()
        if k not in ("embed_dim", "lower_dim", "name")}
    shapes = jax.eval_shape(JVAEformer(want).init, jax.random.PRNGKey(0), x)
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) == 416_640_800
    out = jax.eval_shape(lambda v, xx: JVAEformer(want).apply(v, xx), shapes, x)
    assert out["likelihoods"]["y"].shape == (1, 1024, 72, 144)


# ---------------------------------------------------------------- training
def _shape_noise(shape):
    """The same uniform(-0.5, 0.5) noise for one shape in both packages."""
    seed = int(np.prod([int(s) + 7 for s in shape])) % (2**31)
    return np.random.default_rng(seed).uniform(-0.5, 0.5, size=shape).astype(np.float32)


@pytest.fixture
def shared_noise(monkeypatch):
    def jq(inputs, mode, means=None, rng=None):
        if mode == "noise":
            return inputs + jnp.asarray(_shape_noise(inputs.shape)).astype(inputs.dtype)
        return j_ops.quantize(inputs, mode, means=means, rng=rng)

    def tq(inputs, mode, means=None, generator=None):
        if mode == "noise":
            return inputs + torch.from_numpy(_shape_noise(tuple(inputs.shape))).to(inputs.dtype)
        return ops.quantize(inputs, mode, means=means, generator=generator)

    for mod in (j_ebm, j_gcm):
        monkeypatch.setattr(mod, "quantize", jq)
    for mod in (ebm, gcm):
        monkeypatch.setattr(mod, "quantize", tq)


@pytest.mark.parametrize("name", ["cnn_prior", "mean_scale"])
def test_two_trainer_steps_match_jax(params, name, shared_noise):
    """Two steps of JAX's jitted train step and the port's from the same
    params under the same noise (use_kl on the variational model, so its
    KL reaches the loss): every metric, then every parameter and its EMA."""
    x = params[0]
    variables = params[1][name]["params"]
    tcfg = dict(learning_rate=1e-3, aux_learning_rate=1e-2, max_grad_norm=1.0, use_ema=True,
                use_kl=name == "cnn_prior", kl_weight=0.5)
    jtx = j_make_tx(1e-3, 1e-2, 1.0)
    jstep = jax.jit(j_make_train_step(VARIANTS[name][0](), jtx, JTrainerConfig(**tcfg)))
    jstate = JTrainState(step=jnp.int32(0), params=variables, opt_state=jtx.init(variables),
                         ema=j_ema_init(variables))
    model = _port(params, name)
    tx = make_net_aux_optimizers(1e-3, 1e-2, 1.0)
    pp = dict(model.named_parameters())
    state = TrainState(step=0, params=pp, opt_state=tx.init(pp), ema=ema_init(pp))
    pstep = make_train_step(model, tx, TrainerConfig(**tcfg))
    for _ in range(2):
        jstate, jm = jstep(jstate, jnp.asarray(x), jax.random.PRNGKey(1))
        state, m = pstep(state, torch.from_numpy(x), 0)
        assert set(m) == set(jm)
        for k in jm:
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-3), k
    want = dict(_port((x, {name: {"params": jax.device_get(jstate.params)}}), name)
                .named_parameters())
    jema = dict(_port((x, {name: {"params": jax.device_get(jstate.ema.params)}}), name)
                .named_parameters())
    for n, p in state.params.items():
        for got, ref, what in ((p, want[n], n), (state.ema.params[n], jema[n], f"ema {n}")):
            scale = ref.detach().abs().max().item()
            assert (got.detach() - ref.detach()).abs().max().item() <= 1e-3 * max(scale, 1e-12), \
                what


def test_train_cli_builds_variation_cnn_prior(tmp_path):
    """tools/train.py builds the model named by a config file through the
    MODELS registry, as the JAX CLI does, and trains it."""
    from cra5_tpu_torch.tools import train

    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        "from cra5_tpu_torch.models import vaeformer_tiny\n"
        "model = dict(type='VariationCNNPrior', cfg=vaeformer_tiny(), variational=False)\n"
        "dataset = dict(type='synthetic', shape=(1, 8, 41, 40))\n"
        "trainer = dict(learning_rate=1e-3, log_every=1)\n")
    trainer, state, path = train.run([str(cfg), "--steps", "2", "--ckpt-dir",
                                      str(tmp_path / "ckpt"), "--device", "cpu"], log_fn=None)
    assert type(trainer.model) is VariationCNNPrior and not trainer.model.variational
    assert state.step == 2 and path.endswith("step_2.pt")
