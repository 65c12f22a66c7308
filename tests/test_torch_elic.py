"""Port vs JAX: ELIC 2022 (models/elic2022.py) and ElicCodec on the CPU at
N=32, M=64, three groups [16, 16, 32] (tests/test_elic.py's tiny width), on
64x64 images.

The two models share one set of weights (tests/_torch_pairs.py::pair).
Floats agree within 1e-4 x max|ref| (summation order only); symbols
exactly. The codec is held to JAX's byte for byte: the port model's device
methods are made to return the JAX model's outputs, so both codecs code
the same symbols and indexes (batch 2); every y and z stream must be JAX's
bytes and decode back to the symbols. On the port alone, the decoder's
indexes equal the encoder's, pass by pass, and x_hat equals synthesis of
the encoder's y_hat bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pairs import close as _close, feed, image as _image, pair, record
from cra5_tpu.models import elic2022 as J
from cra5_tpu.models.codec import make_codec as j_make_codec
from cra5_tpu_torch.coder.lane_coder import MAGIC
from cra5_tpu_torch.convert import flax_layout, load_flax_variables
from cra5_tpu_torch.models import elic2022 as P
from cra5_tpu_torch.models.codec import make_codec

KW = dict(N=32, M=64, num_slices=3)
_PAIR = []


def _pair():
    """(JAX model, its variables, the port model with those weights)."""
    if not _PAIR:
        _PAIR.append(pair(lambda: J.ELIC2022(**KW), lambda: P.ELIC2022(**KW, device="cpu"),
                          (1, 3, 64, 64)))
    return _PAIR[0]


def _jcodec():
    """The JAX ElicCodec of the pair (its jitted device methods serve the
    other tests too)."""
    if len(_PAIR) < 2:
        jm, v, _ = _pair()
        _PAIR.append(j_make_codec(jm, v))
    return _PAIR[1]


@pytest.mark.parametrize("anchor", [True, False])
@pytest.mark.parametrize("shape", [(2, 3, 8, 12), (1, 5, 6, 4)])
def test_checkerboard_pack_unpack_equal_jax(shape, anchor):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = P.checkerboard_pack(torch.from_numpy(x), anchor)
    want = J.checkerboard_pack(jnp.asarray(x), anchor)
    assert np.array_equal(got.numpy(), np.asarray(want))
    back = P.checkerboard_unpack(got, anchor, shape[-1])
    assert np.array_equal(back.numpy(), np.asarray(J.checkerboard_unpack(want, anchor, shape[-1])))
    assert np.array_equal(P._anchor_mask(*shape[-2:]), J._anchor_mask(*shape[-2:]))


def test_groups_and_the_m_check():
    assert P.ELIC2022(**KW, device="cpu").groups == [0, 16, 16, 32]
    assert P.ELIC2022(device="cpu").groups == J.ELIC2022().groups == [0, 16, 16, 32, 64, 192]
    with pytest.raises(ValueError, match="sum of channel groups"):
        P.ELIC2022(N=32, M=72, num_slices=3, device="cpu")
    model = P.ELIC2022(**KW, device="cpu").reset_parameters(3)
    assert len(flax_layout(model)) == len(list(model.parameters()))


def test_forward_matches_jax():
    jm, v, pm = _pair()
    x = _image(seed=1)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    _close(got["x_hat"], want["x_hat"], "x_hat")
    for k in ("y", "z"):
        _close(got["likelihoods"][k], want["likelihoods"][k], k)


def test_device_halves_match_jax():
    """z symbols exact; y, the hyper parameters and each group's anchor and
    non-anchor parameters within the bound, on JAX's own slices."""
    jm, v, pm = _pair()
    jc = _jcodec()
    x = _image(seed=2)
    a = jc._analysis(v, jnp.asarray(x))
    with torch.no_grad():
        b = pm.analysis(torch.from_numpy(x))
        assert b["z_sym"].dtype == torch.int32
        assert np.array_equal(b["z_sym"].numpy(), np.asarray(a["z_sym"]))
        _close(b["y"], a["y"], "y")
        hp = jc._hyper(v, a["z_sym"])
        _close(pm.hyper_params_from_z(b["z_sym"]), hp, "hyper")
        amask = jnp.asarray(J._anchor_mask(*a["y"].shape[-2:]))
        slices = []
        for i, y_slice in enumerate(jnp.split(a["y"], np.cumsum(jm.groups[1:-1]), axis=1)):
            ts = [torch.from_numpy(np.array(s)) for s in slices]
            ma, sa = jc._anchor_params(v, tuple(slices), hp, i)
            got = pm.anchor_params(ts, torch.from_numpy(np.array(hp)), i)
            _close(got[0], ma, f"anchor means {i}")
            _close(got[1], sa, f"anchor scales {i}")
            ya = jc._anchor_hat(y_slice, ma, amask)
            mn, sn = jc._non_anchor_params(v, ya, tuple(slices), hp, i)
            got = pm.non_anchor_params(torch.from_numpy(np.array(ya)), ts,
                                       torch.from_numpy(np.array(hp)), i)
            _close(got[0], mn, f"non-anchor means {i}")
            _close(got[1], sn, f"non-anchor scales {i}")
            slices.append(jc._blend_hat(ya, y_slice, mn, amask))
        y_hat = jnp.concatenate(slices, 1)
        _close(pm.synthesis(torch.from_numpy(np.array(y_hat))), jc._synthesis(v, y_hat),
               "synthesis")


def test_codec_writes_jax_bytes_and_decodes_back(batch=2):
    jm, v, _ = _pair()
    pm = load_flax_variables(P.ELIC2022(**KW, device="cpu"), v)
    jcodec = _jcodec()
    feed(pm, {"analysis": lambda x: jcodec._analysis(v, x),
              "hyper_params_from_z": lambda z: jcodec._hyper(v, z),
              "anchor_params": lambda sl, hp, i: jcodec._anchor_params(v, sl, hp, i),
              "non_anchor_params": lambda ya, sl, hp, i: jcodec._non_anchor_params(v, ya, sl,
                                                                                  hp, i),
              "synthesis": lambda y: jcodec._synthesis(v, y)})
    codec = make_codec(pm)
    assert isinstance(codec, P.ElicCodec) and isinstance(jcodec, J.ElicCodec)
    x = _image(batch, seed=3)
    seen = {}
    record(codec, "_symbols", seen)
    out, jout = codec.compress(x), jcodec.compress(x)
    assert out["shape"] == tuple(jout["shape"]) and out["y_shape"] == tuple(jout["y_shape"])
    assert len(out["strings"][0]) == 2 * KW["num_slices"] * batch
    assert out["strings"] == [[bytes(s) for s in group] for group in jout["strings"]]

    record(codec, "_decode", seen)
    x_hat = codec.decompress(jout["strings"], jout["shape"])["x_hat"]  # y_shape from z's
    assert len(seen["_decode"]) == len(seen["_symbols"]) == 2 * KW["num_slices"]
    for enc, dec in zip(seen["_symbols"], seen["_decode"]):
        assert dec.dtype == torch.int32 and torch.equal(enc, dec)
    assert x_hat.shape == x.shape


def test_codec_roundtrip_on_its_own_indexes_and_symbols():
    """The port alone: each pass's decoder indexes and symbols equal the
    encoder's, x_hat equals synthesis of the encoder's y_hat bitwise, and
    a second compress writes the same bytes."""
    _, _, pm = _pair()
    codec = make_codec(pm)
    x = _image(seed=4)
    seen = {}
    for name in ("_indexes", "_symbols", "_hat"):
        record(codec, name, seen)
    out = codec.compress(x)
    n_enc = {k: len(s) for k, s in seen.items()}
    record(codec, "_decode", seen)
    x_hat = codec.decompress(out["strings"], out["shape"], out["y_shape"])["x_hat"]
    S = KW["num_slices"]
    assert n_enc == {"_indexes": 2 * S, "_symbols": 2 * S, "_hat": 2 * S}
    idx = seen["_indexes"]
    assert all(torch.equal(a, b) for a, b in zip(idx[:2 * S], idx[2 * S:]))
    assert all(torch.equal(a, b) for a, b in zip(seen["_symbols"], seen["_decode"]))
    hats = seen["_hat"]
    y_hat = torch.cat([hats[2 * i] + hats[2 * i + 1] for i in range(S)], dim=1)
    with torch.no_grad():
        assert torch.equal(x_hat, pm.synthesis(y_hat))
    assert codec.compress(x)["strings"] == out["strings"]


@pytest.mark.parametrize("coder", ["v1", "v2"])
def test_the_codec_writes_v2_whatever_coder_says(coder):
    """C12: make_codec passes no coder to ElicCodec, as JAX's does, so
    eval_model --entropy-coder v1 codes v2 streams."""
    _, _, pm = _pair()
    codec = make_codec(pm, coder=coder)
    assert codec.coder == "v2"
    out = codec.compress(_image(seed=5))
    for group in out["strings"]:
        for s in group:
            assert int.from_bytes(s[:4], "little") == MAGIC
