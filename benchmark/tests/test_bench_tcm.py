"""The TCM 2023 cell at tiny sizes on the CPU: its job through the harness; the TCM FLOP count against torch's own
count on the reference; the attention count against the program's
``swin/attn`` span args; the bound's arithmetic; the per-layer readers on
a synthetic trace; a program without the published parameters refused in
set-up; the reference's two copies one file."""

import filecmp
import json
import math
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import BENCH
from benchlib import harness, peaks, tcm, tcm_count
from benchlib.trace import Op, Trace
from reference import tcm2023 as ref

BENCHMARK = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
TCM_CELL = "tcm2023_n128.uhd_c1"
TCM_TINY = {"N": 8, "M": 20, "config": [1] * 6, "head_dim": [4] * 6, "num_slices": 4,
            "max_support_slices": 2}


def _tiny():
    bench = harness.load_json(BENCH.parent / "BENCHMARK.json")
    _, config, _, _ = harness.cell_files(bench, TCM_CELL)
    over = {"model": {**config["model"], **TCM_TINY},
            "codec": {**config["codec"], "fit_steps": 3, "fit_crop": 64, "contrast": 6.4}}
    # at 100 x 120 the z stream is most of the 600-B target and a 3-step
    # fit barely moves the rate with the contrast: the tiny search takes
    # its first probe, at a contrast where z carries the image (a missed
    # target is held below, at 0.01 bpp)
    traffic = {"trace_at": 0.2, "trace_seconds": 0.3, "height": 100, "width": 120,
               "rate_tolerance": 1.0}
    return over, traffic


def _run(trace=False, seconds=1.0):
    over, traffic = _tiny()
    return harness.run(TCM_CELL, 2 ** 31 + 11, seconds, trace, time.perf_counter(), device="cpu",
                       config_override=over, traffic_override=traffic, log=lambda msg: None)


def test_cell_runs_at_the_tiny_size():
    line = _run()
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    want = {m["name"]: m["unit"] for m in harness.metrics_of(BENCHMARK, TCM_CELL, False)}
    assert set(line["metrics"]) == set(want) - {"peak_gib"}
    assert {"timesteps_per_s", "request_p95_ms", "bytes_per_timestep", "setup_s"} <= set(want)
    for m in line["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0
    assert set(line["checks"]) == {"stream_faults", "z_far", "y_far", "idx_gap", "x_rel"}


def test_traced_tcm_line_reads_mfu():
    line = _run(trace=True, seconds=1.5)
    want = {m["name"] for m in harness.metrics_of(BENCHMARK, TCM_CELL, True)}
    assert "mfu" in line["metrics"] and set(line["metrics"]) <= want
    assert {"swin_attn_device_ms", "swin_attn_roofline", "slice_model_device_ms",
            "transform_device_ms", "coder_device_ms"} <= want


def test_tcm_flops_match_flop_counter_mode():
    P = tcm.make(TCM_TINY, 5, "cpu")
    R = ref.TCM(TCM_TINY, P)
    x = tcm.frame(tcm.field(5, 0, 100, 120, "cpu"), 0.1)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        enc = R.encode(x)
        lm, ls = R.hyper(enc["z_sym"])
        R.g_s(torch.cat(R.slices(lm, ls, syms=enc["sym"])["y_hat"], 1))
    assert fc.get_total_flops() == tcm_count.roundtrip_flops(TCM_TINY, 128, 128)
    # the published model at the cell's 2176 x 3840: about 16 TMAC a roundtrip
    assert 30e12 < tcm_count.roundtrip_flops({}, 2176, 3840) < 36e12


def test_attention_count_is_the_programs_span_args(monkeypatch):
    """Every ``swin/attn`` call of a tiny TCM roundtrip, in order, as the
    count lists it (windows, heads, tokens, head_dim)."""
    import contextlib

    from cra5_tpu_torch.models import make_codec
    from cra5_tpu_torch.nn import swin

    seen = []

    @contextlib.contextmanager
    def record(name, **args):
        seen.append((name, args))
        yield

    monkeypatch.setattr(swin, "span", record)
    model = tcm.fill(tcm.empty_program(TCM_TINY, "cpu"), tcm.make(TCM_TINY, 3, "cpu"))
    codec = make_codec(model)
    x = tcm.frame(tcm.field(3, 0, 100, 120, "cpu"), 0.1)
    out = codec.compress(x)
    codec.decompress(out["strings"], out["shape"])
    got = [args for name, args in seen if name == "swin/attn"]
    want = [{k: a[k] for k in ("windows", "heads", "tokens", "head_dim")}
            for a in tcm_count.attention_calls(TCM_TINY, 128, 128)]
    assert got == want and len(got) == 43


def test_attention_bound_by_hand():
    """The published first stage's block at 2176 x 3840: 272 x 480 windows
    of 64 tokens, 16 heads of width 8; memory-bound."""
    a = tcm_count.attention_calls({}, 2176, 3840, ("compress",))[0]
    assert a == {"windows": 136 * 240, "heads": 16, "tokens": 64, "head_dim": 8, "w": 8}
    ops = 4 * 136 * 240 * 16 * 64 * 64 * 8
    nbytes = 4 * (4 * 136 * 240 * 64 * 128 + 15 * 15 * 16)
    assert nbytes / peaks.BYTES_PER_S > ops / peaks.FLOPS["float32"]
    total = tcm_count.attention_bound_s({}, 2176, 3840)
    assert nbytes / peaks.BYTES_PER_S < total < 10 * nbytes / peaks.BYTES_PER_S


def test_readers_split_the_tcm_trace():
    ops = [Op("gemm", 0.004, 0, "compress/analysis"), Op("softmax", 0.002, 0, "swin/attn"),
           Op("conv", 0.003, 1, "charm/params"), Op("conv", 0.001, 1, "charm/lrp"),
           Op("rans", 0.0005, 1, "decompress/decode_y"), Op("conv", 0.002, 1, "decompress/synthesis"),
           Op("softmax", 0.006, None, "swin/attn")]  # outside the traced requests
    run = {"trace": Trace(1.0, 0.5, 2, ops, [], [], {}), "batch": 1, "attention_bound_s": 0.0005}
    read = lambda name: harness.reader(name)(run)  # noqa: E731
    assert read("swin_attn_device_ms") == pytest.approx(1.0)
    assert read("slice_model_device_ms") == pytest.approx(2.0)
    assert read("transform_device_ms") == pytest.approx(3.0)
    assert read("coder_device_ms") == pytest.approx(0.25)
    assert read("swin_attn_roofline") == pytest.approx(50.0)
    bare = {"trace": Trace(1.0, 0.5, 2, [Op("gemm", 0.01, 0, "compress/analysis")], [], [], {}),
            "batch": 1, "attention_bound_s": 0.0005}
    for name in ("swin_attn_device_ms", "slice_model_device_ms", "swin_attn_roofline"):
        assert harness.reader(name)(bare) is None
        assert harness.reader(name)({"trace": None, "batch": 1}) is None


def test_a_program_without_the_published_parameters_is_refused(monkeypatch):
    import cra5_tpu_torch.models as models

    class Old(torch.nn.Module):
        def __init__(self, **kw):
            super().__init__()
            self.trunk = torch.nn.Linear(2, 2)

    monkeypatch.setattr(models, "TCM2023", Old)
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match="differ from the configuration"):
        tcm.empty_program({}, "cpu")
    assert time.perf_counter() - t < 5


def test_a_contrast_search_that_misses_the_rate_fails_set_up():
    """A target the tiny model cannot reach (its z alone codes ~500 B)
    stops set-up: the cell never runs at another rate than its traffic's."""
    over, traffic = _tiny()
    with pytest.raises(RuntimeError, match="missed the traffic's rate"):
        harness.run(TCM_CELL, 2 ** 31 + 11, 1.0, False, time.perf_counter(), device="cpu",
                    config_override=over, traffic_override={**traffic, "bpp": 0.01},
                    log=lambda msg: None)


def test_the_two_reference_copies_are_one_file():
    assert filecmp.cmp(BENCH / "reference" / "tcm2023.py",
                       BENCH.parent / "tests" / "reference_tcm2023.py", shallow=False)


def test_tcm_controls_run_at_the_tiny_size():
    """The TF32 control and the planted z faults, judged as the program is:
    every number of each; every z symbol a step up is far from most."""
    from benchlib import tcm_controls

    bench = harness.load_json(BENCH.parent / "BENCHMARK.json")
    cell, config, traffic, limits = harness.cell_files(bench, TCM_CELL)
    over, tr = _tiny()
    ctx = harness.Context(cell, {**config, **over}, {**traffic, **tr, "check_requests": 2},
                          torch.device("cpu"), 2 ** 31 + 13, 1.0, False, time.perf_counter(),
                          lambda msg: None, limits)
    out = tcm_controls.codec(ctx)
    assert set(out) == set(tcm_controls.CASES)
    for nums in out.values():
        assert set(limits) <= set(nums) and all(math.isfinite(v) for v in nums.values())
    assert out["z_plus_one"]["z_far"] > 0.5 and out["h_a_zero"]["z_far"] > 0
    assert 0 < out["tf32"]["x_rel"] < 0.1
