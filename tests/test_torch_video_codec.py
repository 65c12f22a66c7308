"""Port vs JAX: ScaleSpaceFlowCodec (models/video.py) on the CPU at the
smallest geometry the codec takes: 128 x 128 frames, planes = mid = 8, two
levels, batch 1 and 2.

Fed the same latents, the port's hyperprior symbols and GC indexes equal
JAX's exactly. The coder is compared as ROADMAP's "What the reference
fixes" asks, not end to end: the port model's device methods return the
JAX codec's own jitted functions on the same arguments, so both codecs code
the same symbols and scales, and the port's streams must equal JAX's byte
for byte; each package then decodes the other's streams to the same frames.
On its own towers the port's decoder rebuilds the encoder's reference
frames bitwise, frame after frame.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cra5_tpu.models import video as J
from cra5_tpu_torch.convert import load_flax_variables
from cra5_tpu_torch.models import video as P

from _torch_pairs import feed, np_, one_thread, pair, record  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SSF = dict(num_levels=2, mid_planes=8, planes=8)


def _frames(T=3, B=1, seed=0):
    return np.random.default_rng(seed).random((T, B, 3, 128, 128)).astype(np.float32)


@pytest.fixture(scope="module")
def codecs():
    """(JAX codec, its variables, the port codec) with the same weights."""
    def tweak(m):  # latents of a few units, scales over the table, medians off 0
        g = torch.Generator().manual_seed(3)
        for enc in (m.img_encoder, m.res_encoder, m.motion_encoder):
            enc.l6.conv.weight.mul_(6.0)
        for hp in (m.img_hyperprior, m.res_hyperprior, m.motion_hyperprior):
            hp.hyper_encoder.l4.conv.weight.mul_(4.0)
            hp.hyper_decoder_scale.d3.conv.bias.uniform_(0.0, 6.0, generator=g)
            q = hp.entropy_bottleneck.quantiles
            q.add_(torch.randn(q.shape[0], 1, 1, generator=g) * 0.4)
    jm, v, pm = pair(lambda: J.ScaleSpaceFlow(**SSF),
                     lambda: P.ScaleSpaceFlow(**SSF, device="cpu"), (3, 1, 3, 128, 128),
                     seed=1, tweak=tweak)
    return J.ScaleSpaceFlowCodec(jm, v), v, P.ScaleSpaceFlowCodec(pm)


def _fed_codec(jc, v):
    """A port codec whose model's device methods are the JAX codec's."""
    pm = load_flax_variables(P.ScaleSpaceFlow(**SSF, device="cpu"), v)
    feed(pm, {"analyze": lambda x, w: jc._analyze(v, x, w),
              "hp_symbols": lambda y, w: jc._hp_symbols(v, y, w),
              "hp_params": lambda z, w: jc._hp_params(v, z, w),
              "synthesize_keyframe": lambda y: jc._syn_kf(v, y),
              "motion_to_pred": lambda x, y: jc._motion_pred(v, x, y),
              "synthesize_res": lambda r, m: jc._syn_res(v, r, m)})
    return P.ScaleSpaceFlowCodec(pm)


def _bytes(strings):
    """Every stream of a compress, in order, as bytes."""
    out = []
    for s in strings:
        for group in (s.values() if isinstance(s, dict) else [s]):
            out += [bytes(b) for part in group for b in part]
    return out


@pytest.mark.parametrize("which", P.WHICH)
@pytest.mark.parametrize("B", [1, 2])
def test_symbols_and_indexes_equal_jax_on_the_same_latents(codecs, which, B):
    jc, v, pc = codecs
    y = np.random.default_rng(B).normal(size=(B, 8, 8, 8)).astype(np.float32) * 4
    want = jc._hp_symbols(v, jnp.asarray(y), which)
    with torch.inference_mode():
        got = pc.model.hp_symbols(torch.from_numpy(y), which)
        idx = pc._indexes(got["scales"])
        scales, _ = pc.model.hp_params(got["z_sym"], which)
        dec_idx = pc._indexes(scales)
    for k in ("y_sym", "z_sym"):
        np.testing.assert_array_equal(np_(got[k]).astype(np.int32), np.asarray(want[k]))
    j_idx = np.asarray(jc._gc_index(want["scales"], jc._scale_table_dev))
    np.testing.assert_array_equal(np_(idx).astype(np.int32), j_idx)
    np.testing.assert_array_equal(np_(dec_idx).astype(np.int32), j_idx)
    assert len(np.unique(j_idx)) > 3  # the indexes spread over the table


@pytest.mark.parametrize("B", [1, 2])
def test_streams_equal_jax_bytes_and_decode_across(codecs, B):
    """Fed the JAX codec's device functions, the port writes JAX's bytes,
    stream by stream (2 + 4 (T - 1) a sample), with JAX's shapes; the port
    decodes JAX's streams, and JAX the port's, to the same frames."""
    jc, v, _ = codecs
    fc = _fed_codec(jc, v)
    frames = _frames(3, B, seed=10 + B)
    j_strings, j_shapes = jc.compress([frames[i] for i in range(3)])
    strings, shapes = fc.compress([frames[i] for i in range(3)])
    assert shapes == [tuple(j_shapes[0])] + [{k: tuple(s[k]) for k in s} for s in j_shapes[1:]]
    assert len(_bytes(strings)) == (2 + 4 * 2) * B
    assert _bytes(strings) == _bytes(j_strings)
    j_dec = jc.decompress(strings, shapes)
    p_dec = fc.decompress(j_strings, j_shapes)
    assert len(p_dec) == len(j_dec) == 3
    for p, j in zip(p_dec, j_dec):
        np.testing.assert_array_equal(np_(p), np.asarray(j))


@pytest.mark.parametrize("B", [1, 2])
def test_decoded_frames_equal_the_encoders_reference_chain(codecs, B):
    """On the port's own towers: the decoder's GC indexes and symbols equal
    the encoder's, and every decoded frame is bitwise the encoder's
    reference frame (the keyframe's synthesis, then each inter frame's
    prediction plus residual)."""
    _, _, pc = codecs
    frames = _frames(3, B, seed=20 + B)
    seen = {}
    spies = ((pc, "_indexes"), (pc.model, "synthesize_keyframe"), (pc, "_reference"),
             (pc.model, "hp_symbols"))
    for obj, name in spies:
        record(obj, name, seen)
    try:
        strings, shapes = pc.compress([frames[i] for i in range(3)])
        n = len(seen["_indexes"])
        record(pc, "_decode", seen)
        dec = pc.decompress(strings, shapes)
    finally:
        for obj, name in (*spies, (pc, "_decode")):
            obj.__dict__.pop(name, None)
    assert n == 5 and len(seen["_indexes"]) == 2 * n
    for a, b in zip(seen["_indexes"][:n], seen["_indexes"][n:]):
        assert torch.equal(a, b)
    (kf_enc, kf_dec), refs = seen["synthesize_keyframe"], seen["_reference"]
    chain_enc, chain_dec = [kf_enc, *refs[:2]], [kf_dec, *refs[2:]]
    for t, (e, d, f) in enumerate(zip(chain_enc, chain_dec, dec)):
        assert torch.equal(e, d) and torch.equal(d, f), f"frame {t}"
    enc = [s[k] for s in seen["hp_symbols"] for k in ("z_sym", "y_sym")]
    assert len(seen["_decode"]) == len(enc) == 2 * n  # z then y, five hyperpriors
    assert all(torch.equal(a, b) for a, b in zip(enc, seen["_decode"]))
    again, _ = pc.compress([frames[i] for i in range(3)])
    assert _bytes(again) == _bytes(strings)
    err = max(float((f - torch.from_numpy(frames[t])).abs().max()) for t, f in enumerate(dec))
    assert np.isfinite(err)
