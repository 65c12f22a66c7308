"""Port vs JAX: every layer of nn/conv.py and nn/gdn.py on the CPU.

Each flax layer is initialised on a seeded input, its variables carried
into the port's layer (convert.load_flax_variables), and the outputs held
within 1e-5 x max|ref|; the gradients of qrelu, GDN and MaskedConv2d
against jax.grad within 1e-5 x max|ref|. deconv2d's padded transposed conv
is held to the VALID-and-crop geometry of the JAX layer at odd and even
sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cra5_tpu.nn import conv as jconv
from cra5_tpu.nn import gdn as jgdn
from cra5_tpu_torch.convert import flax_layout, from_flax_leaf, load_flax_variables
from cra5_tpu_torch.nn import conv, gdn

RTOL = 1e-5  # x max|ref|


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _perturb(v, seed=1):
    """The variables moved off their init, so biases and GDN's identity
    gamma do not hide a transposed layout."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
        np.float32), v)


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= RTOL * np.abs(want).max(), f"{what}: err {err}, max|ref| {np.abs(want).max()}"


def _pair(jmod, pmod, x, seed=1):
    v = _perturb(jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))), seed)
    return v, load_flax_variables(pmod, v)


# (name, flax layer, port layer, input shape)
LAYERS = [
    ("conv2d_5x5_s2", jconv.conv2d(6, 5, 2), conv.conv2d(4, 6, 5, 2), (2, 4, 9, 10)),
    ("conv2d_3x3_s1", jconv.conv2d(6, 3, 1), conv.conv2d(4, 6, 3, 1), (1, 4, 8, 7)),
    ("conv2d_1x1", jconv.conv2d(5, 1, 1), conv.conv2d(4, 5, 1, 1), (1, 4, 6, 6)),
    ("deconv2d_even", jconv.deconv2d(5, 5, 2), conv.deconv2d(4, 5, 5, 2), (1, 4, 6, 8)),
    ("deconv2d_odd", jconv.deconv2d(5, 5, 2), conv.deconv2d(4, 5, 5, 2), (2, 4, 5, 7)),
    ("masked_A", jconv.MaskedConv2d(6, 5, "A"), conv.MaskedConv2d(4, 6, 5, "A"), (1, 4, 7, 7)),
    ("masked_B", jconv.MaskedConv2d(6, 5, "B"), conv.MaskedConv2d(4, 6, 5, "B"), (1, 4, 7, 7)),
    ("checkerboard", jconv.CheckerboardMaskedConv2d(6, 5), conv.CheckerboardMaskedConv2d(4, 6, 5),
     (1, 4, 8, 8)),
    ("subpel", jconv.subpel_conv3x3(3, 2), conv.subpel_conv3x3(4, 3, 2), (1, 4, 5, 6)),
    ("residual_block", jconv.ResidualBlock(4), conv.ResidualBlock(4, 4), (1, 4, 8, 8)),
    ("residual_block_skip", jconv.ResidualBlock(6), conv.ResidualBlock(4, 6), (1, 4, 8, 8)),
    ("residual_stride", jconv.ResidualBlockWithStride(6, 2),
     conv.ResidualBlockWithStride(4, 6, 2), (1, 4, 8, 8)),
    ("residual_upsample", jconv.ResidualBlockUpsample(6, 2),
     conv.ResidualBlockUpsample(4, 6, 2), (1, 4, 5, 5)),
    ("attention", jconv.AttentionBlock(8), conv.AttentionBlock(8), (1, 8, 6, 6)),
    ("gdn_stub", jconv.GDNStub(4), conv.GDNStub(4), (1, 4, 5, 5)),
    ("igdn_stub", jconv.GDNStub(4, inverse=True), conv.GDNStub(4, inverse=True), (1, 4, 5, 5)),
    ("gdn", jgdn.GDN(4), gdn.GDN(4), (2, 4, 5, 5)),
    ("igdn", jgdn.GDN(4, inverse=True), gdn.GDN(4, inverse=True), (2, 4, 5, 5)),
    ("gdn1", jgdn.GDN1(4), gdn.GDN1(4), (2, 4, 5, 5)),
    ("igdn1", jgdn.GDN1(4, inverse=True), gdn.GDN1(4, inverse=True), (2, 4, 5, 5)),
]


@pytest.mark.parametrize("name,jmod,pmod,shape", LAYERS, ids=[l[0] for l in LAYERS])
def test_layer_matches_flax(name, jmod, pmod, shape):
    x = _x(shape)
    v, pmod = _pair(jmod, pmod, x)
    with torch.no_grad():
        got = pmod(torch.from_numpy(x))
    _close(got, jmod.apply(v, jnp.asarray(x)), name)


@pytest.mark.parametrize("size", [(5, 5), (6, 6), (5, 8), (1, 1)])
@pytest.mark.parametrize("k,s", [(5, 2), (3, 2), (3, 1)])
def test_deconv_padding_equals_valid_and_crop(size, k, s):
    """conv_transpose2d(padding=k//2, output_padding=s-1) is the window
    [k//2, k//2 + H*s) of the VALID transpose, at odd and even sizes."""
    H, W = size
    x = torch.from_numpy(_x((1, 3, H, W)))
    layer = conv.deconv2d(3, 4, k, s)
    with torch.no_grad():
        layer.conv.weight.copy_(torch.from_numpy(_x(layer.conv.weight.shape, 2)))
        layer.conv.bias.copy_(torch.from_numpy(_x((4,), 3)))
        got = layer(x)
        full = F.conv_transpose2d(x, layer.conv.weight, layer.conv.bias, stride=s)
    p = k // 2
    assert got.shape == (1, 4, H * s, W * s)
    want = full[..., p:p + H * s, p:p + W * s]
    assert torch.allclose(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))


def test_deconv_refuses_a_window_past_the_padding():
    with pytest.raises(ValueError, match="output_padding"):
        conv.deconv2d(3, 4, 3, 3)


def test_qrelu_forward_and_gradient_match_jax():
    x = np.concatenate([np.linspace(-3.0, 258.0, 401), [0.0, 255.0, -1e-3, 255.001]]).astype(
        np.float32)
    g = _x(x.shape, 4)
    want = jax.vjp(lambda v: jconv.qrelu(v, 8, 100), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = conv.QReLU(8, 100)(xt)
    out.backward(torch.from_numpy(g))
    _close(out, want[0], "qrelu")
    _close(xt.grad, want[1](jnp.asarray(g))[0], "qrelu grad")
    # at a lower bit depth the relaxation is visible across a wide span
    x4 = np.linspace(-20, 35, 111).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jconv.qrelu(v, 4, 2) * jnp.asarray(x4)))(jnp.asarray(x4))
    xt = torch.from_numpy(x4).requires_grad_()
    (conv.qrelu(xt, 4, 2) * torch.from_numpy(x4)).sum().backward()
    _close(xt.grad, want, "qrelu grad, 4 bits")
    assert float(np.abs(np.asarray(want)).min()) < 1.0  # the relaxed branch is taken


def _grads_match(jmod, pmod, x, seed):
    """d(sum(out * w))/d(x, params) of the flax and port layers."""
    v, pmod = _pair(jmod, pmod, x, seed)
    w = _x(np.shape(jmod.apply(v, jnp.asarray(x))), seed + 10)
    loss = lambda params, xx: jnp.sum(jmod.apply({"params": params}, xx) * w)
    gp, gx = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (pmod(xt) * torch.from_numpy(w)).sum().backward()
    _close(xt.grad, gx, "d/dx")
    flat = {"/".join(str(p.key) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(gp)[0]}
    for name, (path, kind) in flax_layout(pmod).items():
        _close(pmod.get_parameter(name).grad, from_flax_leaf(kind, np.asarray(flat[path])), name)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_gradients_match_jax(inverse):
    """Through NonNegativeParam's lower_bound: beta moved below its bound
    on some channels, so the bound's gradient rule is exercised."""
    x = _x((2, 4, 5, 5), 5)
    _grads_match(jgdn.GDN(4, inverse=inverse), gdn.GDN(4, inverse=inverse), x, 6)
    jm, pm = jgdn.GDN(4), gdn.GDN(4)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v = {"params": {**v["params"], "beta": np.array([1.0, 1e-4, -0.5, 2.0], np.float32)}}
    load_flax_variables(pm, v)
    gb = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x))))(v["params"])["beta"]
    pm(torch.from_numpy(x)).sum().backward()
    _close(pm.beta.grad, gb, "beta grad below the bound")


def test_masked_conv_gradients_match_jax():
    x = _x((1, 4, 7, 7), 7)
    _grads_match(jconv.MaskedConv2d(6, 5, "A"), conv.MaskedConv2d(4, 6, 5, "A"), x, 8)


def test_masked_conv_weight_stays_raw_and_its_masked_taps_get_no_gradient():
    layer = conv.MaskedConv2d(3, 4, 5, "A")
    conv.reset_parameters_(layer, torch.Generator().manual_seed(0))
    assert (layer.weight[:, :, 2, 2:] != 0).all()  # stored unmasked, as flax stores it
    layer(torch.from_numpy(_x((1, 3, 6, 6)))).sum().backward()
    assert (layer.weight.grad[:, :, 2, 2:] == 0).all() and (layer.weight.grad[:, :, 3:] == 0).all()
