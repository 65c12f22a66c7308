"""The port's TCM 2023 (models/tcm2023.py, coded by CharmCodec) against
the plain reference (tests/reference_tcm2023.py), on the CPU at tiny widths
(config (1,) * 6, head_dim (4,) * 6, N=8, M=20, 4 slices, 2 support
slices) on 128 x 128 images, at the published windows: 8 in the towers and
the SWAtten gates (so the latent's 8 x 8 grid is one window, shifted by 4
in SW), 4 in the hyper stages.

Weights: the port's seeded init with the relative-position tables drawn
N(0, 1), so that they matter. Floats agree within 1e-5 x max|ref|: the two
compute the same float32 operations in another order (the reference's
-inf mask against the port's -100 adds e^-100, below float32's smallest
normal number, to a softmax sum of at least 1); symbols and indexes
exactly. The codec's streams are read back by the benchmark's plain CRX2
decoder (benchmark/reference/crx2.py)."""

import filecmp
import importlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import reference_tcm2023 as R
from cra5_tpu_torch.models import TCM2023, make_codec
from cra5_tpu_torch.models.stf2022 import CharmCodec
from cra5_tpu_torch.models.tcm2023 import ConvTransBlock, SWAtten

ROOT = Path(__file__).resolve().parents[1]
KW = dict(config=(1,) * 6, head_dim=(4,) * 6, N=8, M=20, num_slices=4, max_support_slices=2)
CFG = {k: list(v) if isinstance(v, tuple) else v for k, v in KW.items()}
HW = (128, 128)
RTOL = 1e-5  # x max|ref|: the same float32 operations in another order
_MODEL = []


def close(got, want, what):
    got, want = got.detach().float(), want.detach().float()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, bound = (got - want).abs().max().item(), RTOL * max(want.abs().max().item(), 1e-30)
    assert err <= bound, f"{what}: max err {err:.3g} > {bound:.3g}"


def _tables(module, seed):
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed)
        for m in module.modules():
            if hasattr(m, "relative_position_bias_table"):
                m.relative_position_bias_table.normal_(generator=g)
    return module


def _pair():
    """(the port's tiny TCM, the reference on its weights)."""
    if not _MODEL:
        pm = _tables(TCM2023(**KW, device="cpu").reset_parameters(0), 1)
        _MODEL.append((pm, R.TCM(CFG, {k: p.detach() for k, p in pm.named_parameters()})))
    return _MODEL[0]


def image(seed, hw=HW):
    return torch.from_numpy(np.random.default_rng(seed).random((1, 3, *hw), np.float32))


def _bench_reference():
    """The benchmark's plain CRX2 decoder and tables, loaded under a name of
    their own."""
    name = "bench_reference_for_tests"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "benchmark" / "reference" / "__init__.py",
            submodule_search_locations=[str(ROOT / "benchmark" / "reference")])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.crx2"), importlib.import_module(f"{name}.tables")


def test_published_configuration_is_the_zoo_default():
    """N 128, M 320, head widths 8/16/32/32/16/8 at window 8, hyper window
    4 at head width 32, SWAtten 16 / 8 / 128, 5 slices: the zoo's
    tcm2023 holds the reference's every parameter name and shape."""
    m = TCM2023(device="cpu")
    assert (m.window_size, m.hyper_window, m.hyper_head_dim) == (8, 4, 32)
    assert (m.N, m.M, m.num_slices, m.max_support) == (128, 320, 5, 5)
    assert m.atten_mean_0.mask_swin_1.swin.attn.window_size == (8, 8)
    assert m.atten_mean_0.mask_swin_1.swin.attn.num_heads == 128 // 16
    assert m.hs_up1.ctb_1.trans_block.swin.shift_size == 2
    shapes = {k: tuple(p.shape) for k, p in m.named_parameters()}
    assert shapes == R.param_shapes({}) and sum(map(np.prod, shapes.values())) == 76_568_148


def test_tcm_forward_matches_the_reference():
    pm, ref = _pair()
    x = image(seed=1)
    with torch.no_grad():
        got, want = pm(x), ref.forward(x)
    close(got["x_hat"], want["x_hat"], "x_hat")
    for k in ("y", "z"):
        close(got["likelihoods"][k], want["likelihoods"][k], k)


def test_tcm_device_halves_match_the_reference():
    """z symbols exact (192 hyper channels); y, the hyper outputs and every
    slice's mu, sigma (through the SWAtten gates) and lrp within the bound,
    on the reference's own slices; the synthesis."""
    pm, ref = _pair()
    x = image(seed=2)
    with torch.no_grad():
        a, want = pm.analysis(x), ref.encode(x)
        assert a["z_sym"].shape[1] == TCM2023.hyper_channels == 192
        assert torch.equal(a["z_sym"], want["z_sym"])
        close(a["y"], want["y"], "y")
        lm, ls = pm.hyper_params_from_z(a["z_sym"])
        close(lm, want["latent_means"], "latent means")
        close(ls, want["latent_scales"], "latent scales")
        slices = []
        for i in range(KW["num_slices"]):
            mu, sigma, m = pm.slice_entropy(lm, ls, slices, i)
            r_mu, r_sigma, r_m = ref.slice_entropy(lm, ls, slices, i)
            close(mu, want["mu"][i], f"mu {i}")
            close(sigma, want["sigma"][i], f"sigma {i}")
            close(m, r_m, f"attended mean support {i}")
            y_hat = want["sym"][i].float() + want["mu"][i]
            close(pm.slice_residual(m, y_hat, i), ref.slice_residual(r_m, y_hat, i), f"lrp {i}")
            slices.append(want["y_hat"][i])
        y_hat = torch.cat(slices, 1)
        close(pm.synthesis(y_hat), ref.g_s(y_hat), "synthesis")


@pytest.mark.parametrize("shifted", [False, True], ids=["W", "SW"])
def test_conv_trans_block_matches_the_reference(shifted):
    """One ConvTransBlock at window 8 on a 12 x 20 grid, which each block
    pads to 16 x 24 after its norm."""
    from cra5_tpu_torch.nn.conv import reset_parameters_
    from cra5_tpu_torch.nn.swin import reset_swin_parameters_

    blk = ConvTransBlock(8, 8, 4, 8, shifted, device="cpu")
    reset_parameters_(blk, torch.Generator().manual_seed(4))
    reset_swin_parameters_(blk, torch.Generator().manual_seed(5))
    _tables(blk, 3)
    ref = R.TCM({"N": 8}, {f"b.{k}": p.detach() for k, p in blk.named_parameters()})
    x = torch.randn(2, 16, 12, 20, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        close(blk(x), ref.ctb(x, "b", 4, 8, shifted), "ConvTransBlock")


@pytest.mark.parametrize("hw", [(8, 8), (12, 20)])
def test_swatten_matches_the_reference(hw):
    """One SWAtten gate (its Swin pair W then SW at window 8) on one whole
    window, and on a 12 x 20 grid padded to 16 x 24."""
    from cra5_tpu_torch.nn.conv import reset_parameters_
    from cra5_tpu_torch.nn.swin import reset_swin_parameters_

    gate = SWAtten(24, 20, 16, 8, 128, device="cpu")
    reset_parameters_(gate, torch.Generator().manual_seed(7))
    reset_swin_parameters_(gate, torch.Generator().manual_seed(8))
    _tables(gate, 9)
    ref = R.TCM({}, {f"g.{k}": p.detach() for k, p in gate.named_parameters()})
    x = torch.randn(1, 24, *hw, generator=torch.Generator().manual_seed(10))
    with torch.no_grad():
        close(gate(x), ref.swatten(x, "g"), f"SWAtten {hw}")


def test_tcm_codec_streams_decode_to_the_encoders_symbols():
    """CharmCodec: the symbols and indexes of every slice equal the
    reference's; the plain decoder reads the z stream and each y stream
    back to the encoder's symbols; the decoder's indexes and y_hat equal
    the encoder's, and x_hat is the synthesis of that y_hat."""
    crx2, tables = _bench_reference()
    pm, ref = _pair()
    codec = make_codec(pm)
    assert isinstance(codec, CharmCodec)
    seen = {}
    for name in ("_indexes", "_symbols", "_slice_hat", "_decode"):
        fn = getattr(codec, name)
        setattr(codec, name, lambda *a, _f=fn, _n=name: seen.setdefault(_n, []).append(_f(*a))
                or seen[_n][-1])
    x = image(seed=3)
    out = codec.compress(x)
    x_hat = codec.decompress(out["strings"], out["shape"])["x_hat"]
    S = KW["num_slices"]
    with torch.no_grad():
        want = ref.encode(x)
    table = torch.from_numpy(tables.scale_table())
    z = crx2.decode(out["strings"][1][0], np.broadcast_to(
        np.arange(192, dtype=np.int32)[:, None, None], (192, *out["shape"])),
        tables.factorized_table(pm.entropy_bottleneck.params_numpy()))
    assert np.array_equal(z, want["z_sym"][0].numpy())
    gc = tables.gaussian_table(tables.scale_table())
    for i in range(S):
        assert torch.equal(seen["_symbols"][i], want["sym"][i])
        assert torch.equal(seen["_indexes"][i], R.indexes(want["sigma"][i], table))
        y = crx2.decode(out["strings"][0][i], seen["_indexes"][i][0].numpy(), gc)
        assert np.array_equal(y, seen["_symbols"][i][0].numpy())
        assert torch.equal(seen["_decode"][i], seen["_symbols"][i])
        assert torch.equal(seen["_indexes"][S + i], seen["_indexes"][i])
        assert torch.equal(seen["_slice_hat"][S + i], seen["_slice_hat"][i])
    with torch.no_grad():
        assert torch.equal(x_hat, pm.synthesis(torch.cat(seen["_slice_hat"][:S], 1)))


def test_the_two_reference_copies_are_one_file():
    assert filecmp.cmp(ROOT / "tests" / "reference_tcm2023.py",
                       ROOT / "benchmark" / "reference" / "tcm2023.py", shallow=False)


class _PassCoder:
    """A coder whose streams are the symbols themselves (the coder's own
    spans are held in test_torch_spans.py; its plain versions would add
    ~10^5 profiled operators here)."""

    def encode_dispatch_batch(self, sym, idx):
        return list(sym)

    def upload_batch(self, strings):
        return strings

    def decode_batch_to_device(self, strings, idx):
        return torch.stack(strings)

    def decode_uploaded_batch(self, ups, idx):
        return torch.stack(ups)


def test_charm_and_swin_spans_hold_their_work(monkeypatch):
    """A profiled roundtrip: ``charm/params`` and ``charm/lrp`` once a slice
    each way, ``swin/attn`` once a Swin block run (22 on compress, 21 on
    decompress); every softmax inside ``swin/attn`` and no projection; no
    convolution left in ``compress/encode_y`` or ``decompress/decode_y``."""
    from cra5_tpu_torch.models import codec as codec_mod

    pm, _ = _pair()
    codec = make_codec(pm)
    codec.update()
    codec._eb_coder = codec._gc_coder = _PassCoder()
    monkeypatch.setattr(codec_mod.LaneCoder, "encode_finalize_many", staticmethod(list))
    x = image(seed=4)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = codec.compress(x)
        codec.decompress(out["strings"], out["shape"])
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id(),
            e.is_user_annotation()) for e in prof.profiler.kineto_results.events()]
    ranges = [e for e in evs if e[4]]
    count = lambda n: sum(e[0] == n for e in ranges)  # noqa: E731
    S = KW["num_slices"]
    assert count("charm/params") == count("charm/lrp") == 2 * S
    assert count("swin/attn") == 43
    comp = next(e for e in ranges if e[0] == "compress/encode_y")
    assert sum(e[0] == "swin/attn" and comp[1] <= e[1] <= comp[2] for e in ranges) == 4 * S

    def innermost(op):
        inside = [r for r in ranges if r[3] == op[3] and r[1] <= op[1] and op[2] <= r[2]]
        return min(inside, key=lambda r: r[2] - r[1])[0] if inside else None

    ops = [e for e in evs if not e[4]]
    assert all(innermost(o) == "swin/attn" for o in ops if o[0] == "aten::softmax")
    assert not any(innermost(o) == "swin/attn" for o in ops if o[0] == "aten::linear")
    convs = [innermost(o) for o in ops if o[0] == "aten::convolution"]
    assert convs and not {"compress/encode_y", "decompress/decode_y"} & set(convs)
