"""Port vs JAX: the ViT towers' options and ``DropPath``.

JAX's ``ViTEncoder`` / ``ViTDecoder`` take ``window``, ``z_dim`` (the
internal ``quan_mlp`` / ``post_quan_mlp``), ``use_conv_transpose=False``
(the linear un-patchify), ``qkv_bias`` and ``drop_path_rate``. The same
numpy-seeded inputs and flax variables (seeded values on JAX's
``jax.eval_shape`` tree, so no JAX init compiles) go through both packages
via ``convert.from_flax_params``; float32 outputs differ only in summation
order and agree within 1e-5. ``to_flax_params`` of the port's parameters
gives back the flax tree exactly. A whole ``VAEformer`` with the linear
un-patchify at 40 x 40 (patch = stride = (10, 10)) writes JAX's bytes.
``DropPath`` in training draws from a seeded ``torch.Generator``, so its
masks are the port's own; its statistics are held to the rate."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cra5_tpu.models.vaeformer import VAEformer as JVAEformer
from cra5_tpu.models.vaeformer import VAEformerCodec as JCodec
from cra5_tpu.models.vaeformer import vaeformer_tiny as j_tiny
from cra5_tpu.nn.blocks import DropPath as JDropPath
from cra5_tpu.nn.vit import ViTDecoder as JViTDecoder
from cra5_tpu.nn.vit import ViTEncoder as JViTEncoder
from cra5_tpu_torch import convert
from cra5_tpu_torch.models.vaeformer import VAEformer, VAEformerCodec, vaeformer_tiny
from cra5_tpu_torch.nn.blocks import Block, Dense, DropPath
from cra5_tpu_torch.nn.vit import ViTDecoder, ViTEncoder, _run_block
from test_torch_model import _random_variables

ATOL = 1e-5  # float32 towers: summation order only
TOWER = dict(img_size=(16, 24), patch_size=(4, 4), patch_stride=(4, 4), embed_dim=16, depth=4,
             num_heads=2, window_sizes=((2, 2), (1, 3), (4, 1)), interval=2)
# option name: keyword arguments given to both towers of both packages
# (z_dim to the decoder as well, whose input then has z_dim channels)
OPTIONS = {
    "window_false": dict(window=False),
    "z_dim": dict(z_dim=4),
    "qkv_bias_false": dict(qkv_bias=False),
    "drop_path_eval": dict(drop_path_rate=0.3),
    "linear_final": dict(use_conv_transpose=False),
}


def _variables(jmodel, x, seed=3):
    shapes = jax.eval_shape(lambda k, a: jmodel.init(k, a), jax.random.PRNGKey(0), x)
    return _random_variables(shapes, np.random.default_rng(seed))


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=atol, err_msg=what)


def _towers(option):
    """(JAX encoder, JAX decoder, port encoder, port decoder) with the
    option's keywords; the linear un-patchify is the decoder's alone."""
    kw = dict(OPTIONS[option])
    dec_only = {k: kw.pop(k) for k in ("use_conv_transpose",) if k in kw}
    enc = dict(TOWER, in_chans=3, **kw)
    dec = dict(TOWER, out_chans=3, **kw, **dec_only)
    return JViTEncoder(**enc), JViTDecoder(**dec), ViTEncoder(**enc), ViTDecoder(**dec)


@pytest.fixture(scope="module", params=list(OPTIONS))
def towers(request):
    """Each option's towers in both packages, the flax variables, the
    port's towers loaded from them, and the inputs."""
    jenc, jdec, enc, dec = _towers(request.param)
    x = np.random.default_rng(1).standard_normal((2, 3, *TOWER["img_size"])).astype(np.float32)
    venc = _variables(jenc, jnp.asarray(x))
    moments = np.asarray(jenc.apply(venc, jnp.asarray(x)))
    feat = np.ascontiguousarray(moments[:, : moments.shape[1] // 2])
    vdec = _variables(jdec, jnp.asarray(feat), seed=4)
    enc, dec = (convert.load_flax_variables(m.eval(), v) for m, v in ((enc, venc), (dec, vdec)))
    return request.param, dict(venc=venc, vdec=vdec, enc=enc, dec=dec, jdec=jdec, x=x,
                               moments=moments, feat=feat)


def test_tower_option_matches_jax(towers):
    option, t = towers
    want = t["jdec"].apply(t["vdec"], jnp.asarray(t["feat"]))
    with torch.no_grad():
        moments = t["enc"](torch.from_numpy(t["x"]))
        x_hat = t["dec"](torch.from_numpy(t["feat"]))
    _close(moments, t["moments"], what=f"{option}: g_a")
    assert tuple(x_hat.shape) == tuple(want.shape)
    _close(x_hat, want, what=f"{option}: g_s")


def test_tower_option_layout(towers):
    """What each option builds: every block global; quan_mlp with 2 *
    _mlp_hidden hidden and 2 * z_dim out, post_quan_mlp into the width; a
    qkv without bias; the drop-path schedule as JAX indexes it; the
    linear un-patchify a bias-free Dense at JAX's path."""
    option, t = towers
    enc, dec = t["enc"], t["dec"]
    params = t["venc"]["params"]
    if option == "window_false":
        assert all(b.window_size is None for b in (*enc.blocks, *dec.blocks))
    elif option == "z_dim":
        assert tuple(enc.quan_mlp.fc1.weight.shape) == (2 * 8, 2 * 16)
        assert tuple(enc.quan_mlp.fc2.weight.shape) == (2 * 4, 2 * 8)
        assert tuple(dec.post_quan_mlp.fc1.weight.shape) == (8, 4)
        assert tuple(dec.post_quan_mlp.fc2.weight.shape) == (16, 8)
        assert set(params["quan_mlp"]) == {"fc1", "fc2"}
    elif option == "qkv_bias_false":
        assert all(b.attn.qkv.bias is None for b in (*enc.blocks, *dec.blocks))
        assert "bias" not in params["blocks_0"]["attn"]["qkv"]
    elif option == "drop_path_eval":
        rates = np.linspace(0.0, 0.3, 4)
        assert [b.drop_path.rate for b in enc.blocks] == pytest.approx(list(rates[[0, 1, 1]]))
        assert [b.drop_path.rate for b in dec.blocks] == pytest.approx(list(rates[2:]))
    else:
        assert isinstance(dec.final, Dense) and dec.final.bias is None
        assert convert.flax_layout(dec)["final.weight"] == ("final/kernel", "dense")
        assert set(t["vdec"]["params"]["final"]) == {"kernel"}


def test_to_flax_params_inverts_from_flax_params(towers):
    """to_flax_params of the converted parameters gives JAX's tree back,
    leaf for leaf and bit for bit, for each option."""
    option, t = towers
    for model, v in ((t["enc"], t["venc"]), (t["dec"], t["vdec"])):
        port = {k: torch.from_numpy(a) for k, a in convert.from_flax_params(model, v).items()}
        back = convert._flatten(convert.to_flax_params(model, port))
        want = convert._flatten(v["params"])
        assert back.keys() == want.keys(), option
        for k, a in want.items():
            np.testing.assert_array_equal(back[k], a, err_msg=f"{option}: {k}")


# ------------------------------------------------- the linear un-patchify
def _linear_cfgs():
    geo = dict(img_size=(40, 40), patch_size=(10, 10), patch_stride=(10, 10),
               use_conv_transpose=False)
    return dataclasses.replace(j_tiny(), **geo), dataclasses.replace(vaeformer_tiny(), **geo)


@pytest.fixture(scope="module")
def linear_pair():
    jcfg, cfg = _linear_cfgs()
    x = np.random.default_rng(7).standard_normal((1, cfg.in_chans, 40, 40)).astype(np.float32)
    jmodel = JVAEformer(jcfg)
    variables = _variables(jmodel, jnp.asarray(x))
    model = convert.load_flax_variables(VAEformer(cfg, device="cpu"), variables)
    return x, jmodel, variables, model


def test_linear_unpatchify_vaeformer_matches_jax(linear_pair):
    x, jmodel, variables, model = linear_pair
    want = jmodel.apply(variables, jnp.asarray(x))["x_hat"]
    with torch.no_grad():
        got = model(torch.from_numpy(x))["x_hat"]
    assert tuple(got.shape) == tuple(want.shape) == (1, 8, 40, 40)
    _close(got, want, what="x_hat")


def test_linear_unpatchify_codec_writes_jax_bytes(linear_pair):
    """The codec around it writes JAX's v2 bytes, and each package decodes
    the other's streams to the same x_hat."""
    x, jmodel, variables, model = linear_pair
    jcodec = JCodec(jmodel, variables, coder="v2")
    jcodec.update()
    codec = VAEformerCodec(model, coder="v2")
    codec.update()
    jout, out = jcodec.compress(x), codec.compress(x)
    assert out["strings"] == [list(g) for g in jout["strings"]]
    mine = codec.decompress(jout["strings"], jout["z_shape"])["x_hat"]
    theirs = jcodec.decompress(out["strings"], out["z_shape"])["x_hat"]
    assert tuple(mine.shape) == (1, 8, 40, 40)
    _close(mine, theirs, what="cross-decoded x_hat")


# ------------------------------------------------------------- DropPath
def test_drop_path_is_the_identity_in_eval_and_at_rate_0():
    x = np.random.default_rng(0).standard_normal((6, 5, 4)).astype(np.float32)
    jx = jnp.asarray(x)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    for rate, training in ((0.3, False), (0.0, True), (0.0, False)):
        layer = DropPath(rate).train(training)
        got = layer(torch.from_numpy(x), gen)
        want = JDropPath(rate).apply({}, jx, deterministic=not training or rate == 0.0)
        np.testing.assert_array_equal(got.numpy(), x)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(gen.get_state(), state)  # nothing drawn


def test_drop_path_in_training_drops_whole_samples_at_the_rate():
    """A seeded generator repeats the draw; each sample's branch is 0 or
    x / (1 - rate); the kept share of 20 000 samples lies within 3 sigma
    of 1 - rate; without a generator it raises."""
    rate, n = 0.3, 20000
    x = torch.from_numpy(np.random.default_rng(0).uniform(1.0, 2.0, (n, 3, 2)).astype(np.float32))
    layer = DropPath(rate).train()
    a = layer(x, torch.Generator().manual_seed(5))
    assert torch.equal(a, layer(x, torch.Generator().manual_seed(5)))
    assert not torch.equal(a, layer(x, torch.Generator().manual_seed(6)))
    kept = (a != 0).all(dim=(1, 2))
    assert torch.equal(kept | (a == 0).all(dim=(1, 2)), torch.ones(n, dtype=torch.bool))
    assert torch.equal(a[kept], x[kept] / (1.0 - rate))
    share, sigma = kept.double().mean().item(), np.sqrt(rate * (1 - rate) / n)
    assert abs(share - (1 - rate)) <= 3 * sigma
    with pytest.raises(ValueError, match="generator"):
        layer(x)


@pytest.mark.parametrize("remat", [True, "dots"])
def test_drop_path_masks_survive_the_recompute(remat):
    """A block with drop path run under remat, whose backward recomputes
    the forward, gives the output and gradients of the same block run
    without remat from the same seed: the masks are drawn once, outside
    the recompute."""
    blk = Block(16, 2, drop_path=0.5, window_size=(2, 2)).train()
    for m in blk.modules():
        if hasattr(m, "reset_parameters") and not isinstance(m, torch.nn.Linear):
            m.reset_parameters(torch.Generator().manual_seed(0))
    for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
        lin.init_(torch.Generator().manual_seed(1))
    x0 = torch.from_numpy(np.random.default_rng(2).standard_normal((8, 16, 16)).astype(np.float32))
    outs, grads = [], []
    for r in (False, remat):
        x = x0.clone().requires_grad_()
        out = _run_block(blk, x, 4, 4, r, torch.Generator().manual_seed(9))
        (out * out).sum().backward()
        outs.append(out.detach())
        grads.append([x.grad] + [p.grad.clone() for p in blk.parameters()])
        blk.zero_grad(set_to_none=True)
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_encoder_drop_path_draws_from_the_generator_in_training():
    """In training the encoder's drop path draws from the generator passed
    to forward (the same seed gives the same moments, another seed other
    ones); in eval it draws nothing and ignores the generator."""
    enc = ViTEncoder(**dict(TOWER, in_chans=3, drop_path_rate=0.5))
    for m in enc.modules():
        if hasattr(m, "reset_parameters") and not isinstance(m, torch.nn.Linear):
            m.reset_parameters(torch.Generator().manual_seed(0))
    x = np.random.default_rng(1).standard_normal((4, 3, 16, 24)).astype(np.float32)
    x = torch.from_numpy(x)
    with torch.no_grad():
        a = enc(x, torch.Generator().manual_seed(3))
        assert torch.equal(a, enc(x, torch.Generator().manual_seed(3)))
        assert not torch.equal(a, enc(x, torch.Generator().manual_seed(4)))
        enc.eval()
        assert torch.equal(enc(x, torch.Generator().manual_seed(3)), enc(x))
