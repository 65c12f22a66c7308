"""The FLOP counter against torch's own count on the plain reference at
the tiny size, and against a hand count of 268v blocks."""

import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import BENCH, TINY
from benchlib import fields, flops, params
from reference import model as ref, tables


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_roundtrip_count_matches_flop_counter_mode():
    P = params.make(TINY, 3, "cpu")
    R = ref.VAEformer(TINY, P)
    x = fields.field(TINY, 3, 0, "cpu")
    st = torch.from_numpy(tables.scale_table())

    def codec():
        with torch.no_grad():
            r = R.codec_symbols(x, st)
            _, means, _ = R.hyper_from_z(r["z_sym"], st)
            R.g_s(r["y_sym"].float() + means)

    assert _counted(codec) == flops.roundtrip(TINY)


def test_training_forward_count_matches_flop_counter_mode():
    P = params.make(TINY, 3, "cpu")
    R = ref.VAEformer(TINY, P)
    x = fields.field(TINY, 3, 0, "cpu")
    eb = torch.zeros(TINY["z_channels"], 1, 2 * 2)  # the 2 x 2 hyper grid's noise
    gc = torch.zeros(1, TINY["embed_dim"], 4, 4)

    def forward():
        with torch.no_grad():
            ref.train_terms(R, x, eb, gc, 1, 1, 0.01, 0.01)
            ref.aux_loss(R)

    t = flops.towers(TINY)
    assert _counted(forward) == flops.train_forward(TINY) + t["eb_aux"]
    assert flops.train_step(TINY, 4) == 3 * (4 * flops.train_forward(TINY) + t["eb_aux"])


def test_268v_blocks_by_hand():
    c = json.loads((BENCH / "configs" / "vaeformer_268.json").read_text())["model"]
    d, n = 1024, 72 * 144
    # a 24 x 24 window block: 18 windows of 576 tokens, no padding
    assert flops.block(d, (72, 144), (24, 24)) == 24 * n * d * d + 4 * n * 576 * d
    # a 48 x 12 window block: the 72 rows padded to 96, 24 windows of 576
    n_pad = 96 * 144
    assert flops.block(d, (72, 144), (48, 12)) == (2 * n_pad * d * 4 * d + 2 * n * d * 8 * d
                                                   + 4 * n_pad * 576 * d)
    # a global block over all 10 368 tokens
    assert flops.block(d, (72, 144), None) == 24 * n * d * d + 4 * n * n * d
    # the roundtrip: about 12 TFLOP, as reckoned from the towers' sizes
    assert 11e12 < flops.roundtrip(c) < 14e12
