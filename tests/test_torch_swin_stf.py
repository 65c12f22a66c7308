"""Port vs JAX: the Swin blocks (nn/swin.py) and STF 2022 with CharmCodec
(models/stf2022.py) on the CPU.

Swin: ``SwinBlock`` alone at (H, W) = (8, 12) (shifted), (7, 10) (padded)
and (3, 3) (the window shrunk to 3), ``PatchMerging`` / ``PatchSplit``, the
shift mask and the relative-position index. STF at tests/test_stf.py's tiny
width (embed_dim 8, depths (1, 1, 1, 1), heads (1, 2, 2, 2), 4 slices) on
64x64 images. Weights are shared as tests/_torch_pairs.py describes.
Floats agree within 1e-4 x max|ref|; symbols exactly; every CharmCodec
stream is JAX's bytes when both code the same symbols and indexes (the
port model fed the JAX codec's device methods; batch 2) and decodes back
to them; on the port alone the decoder's indexes equal the encoder's slice
by slice and x_hat equals synthesis of the encoder's y_hat bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pairs import (_flat, charm_bytes_check, charm_feed, charm_roundtrip_check, close,
                          image, pair)
from cra5_tpu.models import stf2022 as J
from cra5_tpu.models.codec import make_codec as j_make_codec
from cra5_tpu.nn import swin as JS
from cra5_tpu_torch.coder.lane_coder import MAGIC
from cra5_tpu_torch.convert import load_flax_variables, to_flax_params
from cra5_tpu_torch.models import stf2022 as P
from cra5_tpu_torch.models.codec import make_codec
from cra5_tpu_torch.nn import swin as PS

KW = dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 2), window_size=4,
          num_slices=4)
_PAIR = []


def _pair():
    if not _PAIR:
        jm, v, pm = pair(lambda: J.SymmetricalTransFormer2022(**KW),
                         lambda: P.SymmetricalTransFormer2022(**KW, device="cpu"), (1, 3, 64, 64))
        _PAIR.extend([(jm, v, pm), j_make_codec(jm, v)])
    return _PAIR[0]


def _jcodec():
    _pair()
    return _PAIR[1]


def _module_pair(jmod, pmod, x, *static, seed=0):
    """A JAX Swin module's variables from the port module's seeded init
    (bias tables scaled up so that they matter), checked against JAX's
    init tree."""
    PS.reset_swin_parameters_(pmod, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for m in pmod.modules():
            if isinstance(m, PS.SwinWindowAttention):
                m.relative_position_bias_table.mul_(50.0)
    params = to_flax_params(pmod, dict(pmod.named_parameters()))
    want = jax.eval_shape(lambda k, a: jmod.init(k, a, *static), jax.random.PRNGKey(0), x)
    assert _flat(params) == _flat(want["params"])
    return {"params": params}


@pytest.mark.parametrize("hw,shift", [((8, 12), 2), ((7, 10), 2), ((3, 3), 2), ((8, 8), 0)])
def test_swin_block_matches_jax(hw, shift):
    H, W = hw
    dim, heads = 16, 2
    x = np.random.default_rng(H * W).normal(size=(2, H * W, dim)).astype(np.float32)
    jmod = JS.SwinBlock(dim, heads, window_size=4, shift_size=shift)
    # flax sizes the table by the window the input gives; so is the port's
    # block built here: at (3, 3) both run 3 x 3 windows, unshifted
    win = min(4, H, W)
    pmod = PS.SwinBlock(dim, heads, window_size=win, shift_size=shift if min(H, W) > 4 else 0)
    v = _module_pair(jmod, pmod, jnp.asarray(x), H, W)
    want = jax.jit(jmod.apply, static_argnums=(2, 3))(v, jnp.asarray(x), H, W)
    with torch.no_grad():
        got = pmod(torch.from_numpy(x), H, W)
    close(got, want, f"SwinBlock {hw}")


def test_a_shrunk_window_takes_the_tables_offsets():
    """Built for 4 x 4 windows, a 3 x 3 input takes the table's rows of the
    offsets a 3 x 3 window has: a block built for 3 x 3 windows with those
    rows gives the same output (ROADMAP C13)."""
    dim, x = 8, torch.randn(1, 9, 8, generator=torch.Generator().manual_seed(1))
    big = PS.reset_swin_parameters_(PS.SwinBlock(dim, 1, 4, 2), torch.Generator().manual_seed(0))
    big.attn.relative_position_bias_table.data.normal_(generator=torch.Generator().manual_seed(2))
    small = PS.SwinBlock(dim, 1, 3, 0)
    small.load_state_dict({**big.state_dict(), "attn.relative_position_bias_table":
                           big.attn.relative_position_bias_table.reshape(7, 7, 1)[1:6, 1:6]
                           .reshape(25, 1)})
    with torch.no_grad():
        assert torch.allclose(big(x, 3, 3), small(x, 3, 3), atol=1e-6)


def test_patch_merging_and_split_match_jax():
    x = np.random.default_rng(3).normal(size=(2, 8 * 12, 16)).astype(np.float32)
    for jcls, pcls, out in ((JS.PatchMerging, PS.PatchMerging, (2, 24, 32)),
                            (JS.PatchSplit, PS.PatchSplit, (2, 384, 8))):
        jmod, pmod = jcls(16), pcls(16)
        v = _module_pair(jmod, pmod, jnp.asarray(x), 8, 12)
        want = jmod.apply(v, jnp.asarray(x), 8, 12)
        with torch.no_grad():
            got = pmod(torch.from_numpy(x), 8, 12)
        assert tuple(got.shape) == out
        close(got, want, jcls.__name__)


@pytest.mark.parametrize("shape", [(8, 12, 4, 2), (8, 8, 4, 2), (4, 8, 2, 1), (8, 8, 4, 0)])
def test_shift_mask_and_index_equal_jax(shape):
    """The port masks token pairs of two region labels by MASKED: the mask
    those labels make is JAX's additive mask."""
    regions, want = PS._shift_regions(*shape), JS._shift_attn_mask(*shape)
    assert (regions is None) == (want is None)
    if want is not None:
        got = np.where(regions[:, None, :] != regions[:, :, None], PS.MASKED, 0.0)
        assert np.array_equal(got.astype(want.dtype), want)
    w = shape[2]
    assert np.array_equal(PS._relative_position_index(w, w), JS._relative_position_index(w, w))


def test_stf_forward_matches_jax():
    jm, v, pm = _pair()
    x = image(seed=1)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    close(got["x_hat"], want["x_hat"], "x_hat")
    for k in ("y", "z"):
        close(got["likelihoods"][k], want["likelihoods"][k], k)


def test_stf_device_halves_match_jax():
    """z symbols exact; y, the hyper outputs and every slice's mu, sigma and
    lrp within the bound, on JAX's own slices."""
    jm, v, pm = _pair()
    jc = _jcodec()
    x = image(seed=2)
    a = jc._analysis(v, jnp.asarray(x))
    t = lambda a_: torch.from_numpy(np.array(a_))  # noqa: E731
    with torch.no_grad():
        b = pm.analysis(torch.from_numpy(x))
        assert np.array_equal(b["z_sym"].numpy(), np.asarray(a["z_sym"]))
        close(b["y"], a["y"], "y")
        lm, ls = jc._hyper(v, a["z_sym"])
        got = pm.hyper_params_from_z(b["z_sym"])
        close(got[0], lm, "latent means")
        close(got[1], ls, "latent scales")
        slices = []
        for i, y_slice in enumerate(jnp.split(a["y"], jm.num_slices, axis=1)):
            mu, sigma = jc._slice_params(v, lm, ls, tuple(slices), i)
            got = pm.slice_entropy(t(lm), t(ls), [t(s) for s in slices], i)
            close(got[0], mu, f"mu {i}")
            close(got[1], sigma, f"sigma {i}")
            y_hat = jnp.round(y_slice - mu) + mu
            lrp = jc._slice_lrp(v, lm, tuple(slices), y_hat, i)
            close(pm.slice_residual(got[2], t(y_hat), i), lrp, f"lrp {i}")
            slices.append(y_hat + lrp)
        y_hat = jnp.concatenate(slices, 1)
        close(pm.synthesis(t(y_hat)), jc._synthesis(v, y_hat), "synthesis")


def test_charm_codec_writes_jax_bytes_and_decodes_back():
    jm, v, _ = _pair()
    pm = load_flax_variables(P.SymmetricalTransFormer2022(**KW, device="cpu"), v)
    charm_feed(pm, _jcodec(), v)
    codec = make_codec(pm)
    assert isinstance(codec, P.CharmCodec) and isinstance(_jcodec(), J.CharmCodec)
    # batch 2: each slice's streams sample by sample
    charm_bytes_check(codec, _jcodec(), image(2, seed=3), KW["num_slices"])


def test_charm_codec_roundtrip_on_its_own_indexes_and_symbols():
    charm_roundtrip_check(make_codec(_pair()[2]), image(seed=4), KW["num_slices"])


@pytest.mark.parametrize("coder", ["v1", "v2"])
def test_the_charm_codec_writes_v2_whatever_coder_says(coder):
    """C12, as for ElicCodec."""
    codec = make_codec(_pair()[2], coder=coder)
    assert isinstance(codec, P.CharmCodec) and codec.coder == "v2"
    out = codec.compress(image(seed=5))
    assert all(int.from_bytes(s[:4], "little") == MAGIC for g in out["strings"] for s in g)
