"""The plain reference against the program at the tiny size on the CPU:
the codec's symbols and tables exactly, the CRX2 decoder on every lane
layout, the training step within float32 round-off."""

import numpy as np
import pytest
import torch

from conftest import TINY
from benchlib import fields, params, program
from reference import crx2, model as ref, tables


@pytest.fixture(scope="module")
def pair():
    P = params.make(TINY, 11, "cpu")
    return P, program.build(TINY, P, "float32", torch.device("cpu"))


def test_seeded_weights_repeat_and_differ_by_seed():
    a, b, c = (params.make(TINY, s, "cpu") for s in (1, 1, 2 ** 40 + 1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["g_a.blocks.0.attn.qkv.weight"], c["g_a.blocks.0.attn.qkv.weight"])


def test_codec_symbols_match_the_program(pair):
    P, model = pair
    x = fields.field(TINY, 4, 0, "cpu") * 30
    st = torch.from_numpy(tables.scale_table())
    with torch.no_grad():
        r = ref.VAEformer(TINY, P).codec_symbols(x, st)
        e = model.encode_symbols(x)
        x_p = model.reconstruct_from_y_symbols(e["y_sym"], e["means"])
        x_r = ref.VAEformer(TINY, P).g_s(r["y_sym"].float() + r["means"])
    assert torch.equal(r["z_sym"], e["z_sym"]) and torch.equal(r["y_sym"], e["y_sym"])
    assert torch.allclose(x_p, x_r, rtol=1e-5, atol=1e-6)


def test_tables_match_the_program(pair):
    from cra5_tpu_torch.models.vaeformer import VAEformerCodec

    P, model = pair
    codec = VAEformerCodec(model)
    codec.update(force=True)
    eb = tables.factorized_table({k.split(".")[-1]: v.numpy() for k, v in P.items()
                                  if k.startswith("entropy_bottleneck.")})
    gc = tables.gaussian_table(tables.scale_table())
    for mine, theirs in ((eb, codec._eb_table), (gc, codec._gc_table)):
        assert np.array_equal(mine.cdf, theirs.quantized_cdf)
        assert np.array_equal(mine.length, theirs.cdf_length)
        assert np.array_equal(mine.offset, theirs.offset)


@pytest.mark.parametrize("lanes,sorted_lanes", [(None, False), (64, False), (128, True),
                                                (256, True)])
def test_crx2_decoder_reads_the_programs_streams(lanes, sorted_lanes):
    from cra5_tpu_torch.coder.lane_coder import LaneCoder

    table = tables.gaussian_table(tables.scale_table())
    g = np.random.default_rng(5)
    n = 20000
    idx = np.clip((g.gamma(2.0, 6.0, n)).astype(np.int32), 0, 63)
    scale = tables.scale_table()[idx]
    sym = np.round(g.normal(0, 1, n) * scale).astype(np.int32)
    sym[::997] = 5000  # escapes
    coder = LaneCoder(_as_program_table(table), lanes, device="cpu", sorted_lanes=sorted_lanes)
    data = coder.encode(sym, idx)
    assert np.array_equal(crx2.decode(data, idx, table), sym)
    broken = bytearray(data)
    broken[24 + 4 * (lanes or 1)] ^= 0x40
    with pytest.raises(crx2.StreamError):
        if np.array_equal(crx2.decode(bytes(broken), idx, table), sym):
            raise crx2.StreamError("a flipped word decoded to the same symbols")


def _as_program_table(t):
    from cra5_tpu_torch.entropy.cdf import CdfTable

    return CdfTable(t.cdf, t.length, t.offset)


def test_training_step_matches_the_program():
    from conftest import run_tiny

    line = run_tiny("vaeformer_159.train_b4", seconds=0.5)
    checks = {k: v["value"] for k, v in line["checks"].items()}
    assert checks["loss_gap"] < 1e-5 and checks["grad_gap"] < 1e-4
    assert checks["change_gap"] < 1e-3 and checks["ema_med_gap"] < 1e-3
