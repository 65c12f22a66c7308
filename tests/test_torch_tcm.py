"""Port vs JAX: TCM 2023 (models/tcm2023.py) coded by CharmCodec, on the CPU
at tests/test_tcm.py's tiny width (config (1,) * 6, head_dim (4,) * 6, N=8,
M=20, 4 slices, 2 support slices) on 128x128 images, where every Swin
window of the model, the hyper stages' included, is the full 4 x 4.

Weights are shared as tests/_torch_pairs.py describes. Floats agree within
1e-4 x max|ref|; symbols exactly; every stream is JAX's bytes when both
codecs code the same symbols and indexes and decodes back to
them; on the port alone the decoder's indexes equal the encoder's. Also
C13: JAX's tcm2023 seeded at its zoo's default 64x64 input builds
2 x 2-window tables in its hyper stages and cannot then run a 128x128
image; the port's tables cover the full window."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pairs import (charm_bytes_check, charm_feed, charm_roundtrip_check, close, image,
                          pair)
from cra5_tpu.models import tcm2023 as J
from cra5_tpu.models.codec import make_codec as j_make_codec
from cra5_tpu_torch.convert import load_flax_variables
from cra5_tpu_torch.models import tcm2023 as P
from cra5_tpu_torch.models.codec import make_codec
from cra5_tpu_torch.models.stf2022 import CharmCodec

KW = dict(config=(1,) * 6, head_dim=(4,) * 6, N=8, M=20, num_slices=4, max_support_slices=2)
HW = (128, 128)
_PAIR = []


def _pair():
    if not _PAIR:
        jm, v, pm = pair(lambda: J.TCM2023(**KW), lambda: P.TCM2023(**KW, device="cpu"),
                         (1, 3, *HW))
        _PAIR.extend([(jm, v, pm), j_make_codec(jm, v)])
    return _PAIR[0]


def _jcodec():
    _pair()
    return _PAIR[1]


def test_tcm_forward_matches_jax():
    jm, v, pm = _pair()
    x = image(seed=1, hw=HW)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    close(got["x_hat"], want["x_hat"], "x_hat")
    for k in ("y", "z"):
        close(got["likelihoods"][k], want["likelihoods"][k], k)


def test_tcm_device_halves_match_jax():
    """z symbols exact (192 hyper channels); y, the hyper outputs and every
    slice's mu, sigma (through the SWAtten gates) and lrp within the bound,
    on JAX's own slices."""
    jm, v, pm = _pair()
    jc = _jcodec()
    x = image(seed=2, hw=HW)
    a = jc._analysis(v, jnp.asarray(x))
    t = lambda a_: torch.from_numpy(np.array(a_))  # noqa: E731
    with torch.no_grad():
        b = pm.analysis(torch.from_numpy(x))
        assert b["z_sym"].shape[1] == P.TCM2023.hyper_channels == 192
        assert np.array_equal(b["z_sym"].numpy(), np.asarray(a["z_sym"]))
        close(b["y"], a["y"], "y")
        lm, ls = jc._hyper(v, a["z_sym"])
        got = pm.hyper_params_from_z(b["z_sym"])
        close(got[0], lm, "latent means")
        close(got[1], ls, "latent scales")
        slices = []
        for i, y_slice in enumerate(jnp.split(a["y"], jm.num_slices, axis=1)):
            mu, sigma = jc._slice_params(v, lm, ls, tuple(slices), i)
            got = pm.slice_params(t(lm), t(ls), [t(s) for s in slices], i)
            close(got[0], mu, f"mu {i}")
            close(got[1], sigma, f"sigma {i}")
            y_hat = jnp.round(y_slice - mu) + mu
            lrp = jc._slice_lrp(v, lm, tuple(slices), y_hat, i)
            close(pm.slice_lrp(t(lm), [t(s) for s in slices], t(y_hat), i), lrp, f"lrp {i}")
            slices.append(y_hat + lrp)
        y_hat = jnp.concatenate(slices, 1)
        close(pm.synthesis(t(y_hat)), jc._synthesis(v, y_hat), "synthesis")


def test_tcm_codec_writes_jax_bytes_and_decodes_back():
    jm, v, _ = _pair()
    pm = load_flax_variables(P.TCM2023(**KW, device="cpu"), v)
    charm_feed(pm, _jcodec(), v)
    codec = make_codec(pm)
    assert isinstance(codec, CharmCodec)
    # batch 1, so that the JAX codec's jitted methods compiled above serve
    # (batch 2 is held on STF's charm codec, test_torch_swin_stf.py)
    charm_bytes_check(codec, _jcodec(), image(seed=3, hw=HW), KW["num_slices"])


def test_tcm_codec_roundtrip_on_its_own_indexes_and_symbols():
    charm_roundtrip_check(make_codec(_pair()[2]), image(seed=4, hw=HW), KW["num_slices"])


def test_c13_jax_tcm_seeded_at_64_cannot_run_128_and_the_port_can():
    jm = J.TCM2023(**KW)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 3, 64, 64), jnp.float32))
    table = shapes["params"]["ha_down1"]["ctb_0"]["trans_block"]["swin"]["attn"][
        "relative_position_bias_table"]
    assert table.shape == (9, 1)  # a 2 x 2 window's table
    with pytest.raises(flax.errors.ScopeParamShapeError):
        jax.eval_shape(jm.apply, shapes, jax.ShapeDtypeStruct((1, 3, *HW), jnp.float32))
    pm = _pair()[2]
    assert pm.ha_down1.ctb_0.trans_block.swin.attn.relative_position_bias_table.shape == (49, 1)
    with torch.no_grad():
        for hw in ((64, 64), HW):
            out = pm(torch.from_numpy(image(seed=5, hw=hw)))
            assert out["x_hat"].shape == (1, 3, *hw) and torch.isfinite(out["x_hat"]).all()
