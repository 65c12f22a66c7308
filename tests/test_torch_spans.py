"""The port's spans (``utils/profiling.py``) on the CPU: totals that count
only while a profiler records, with self time under nesting and apart per
thread; the codec's stages in a profile of a v2 roundtrip, with the
coder's host-only ``coder/pack`` and ``coder/parse`` holding no torch
operator; the train step's phases, and ``train/recompute`` once per
rematerialised block a step and never without remat; and ``stage_times``
summing a repeated stage."""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from cra5_tpu_torch.models.vaeformer import VAEformer, VAEformerCodec, vaeformer_tiny
from cra5_tpu_torch.nn import vit
from cra5_tpu_torch.train.ema import ema_init
from cra5_tpu_torch.train.loop import TrainerConfig, TrainState, make_train_step
from cra5_tpu_torch.train.optim import make_net_aux_optimizers
from cra5_tpu_torch.utils import profiling
from cra5_tpu_torch.utils.profiling import reset_span_totals, span, span_totals

STAGES = ["compress/h2d_input", "compress/g_a", "compress/hyper", "compress/encode_z",
          "compress/encode_y", "compress/finalize", "decompress/upload_y", "decompress/decode_z",
          "decompress/h_s", "decompress/decode_y", "decompress/g_s"]


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _events(prof):
    """(name, start, end, thread, is a range) of every host event."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id(),
             e.is_user_annotation()) for e in prof.profiler.kineto_results.events()]


def test_totals_count_only_under_a_recording_profiler():
    reset_span_totals()
    with span("outer"):
        pass
    assert span_totals() == {}
    with _profile():
        with span("outer", words=3):
            time.sleep(0.01)
            for _ in range(2):
                with span("inner"):
                    time.sleep(0.005)
    with span("inner"):
        pass
    t = span_totals()
    assert set(t) == {"outer", "inner"}
    assert t["outer"]["calls"] == 1 and t["inner"]["calls"] == 2
    assert t["inner"]["s"] == pytest.approx(t["inner"]["self_s"]) and t["inner"]["s"] >= 0.01
    assert t["outer"]["self_s"] == pytest.approx(t["outer"]["s"] - t["inner"]["s"])
    assert t["outer"]["self_s"] >= 0.01
    reset_span_totals()
    assert span_totals() == {}


def test_a_thread_without_the_profiler_adds_nothing():
    reset_span_totals()
    inside, done = threading.Event(), threading.Event()

    def other():
        inside.wait()
        with span("other"):
            time.sleep(0.005)
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with _profile(), span("main"):
        inside.set()
        done.wait()
    t.join()
    assert set(span_totals()) == {"main"}


def test_self_time_subtracts_only_the_same_threads_children(monkeypatch):
    """Two threads counting at once (the profiler's flag held up on both):
    one thread's spans inside another's open span are not its children,
    and the totals lose no call."""
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    reset_span_totals()
    opened, closed = threading.Event(), threading.Event()
    n = 50

    def other():
        opened.wait()
        for _ in range(n):
            with span("other"):
                with span("leaf"):
                    time.sleep(0.0002)
        closed.set()

    t = threading.Thread(target=other)
    t.start()
    with span("main"):
        opened.set()
        for _ in range(n):
            with span("leaf"):
                pass
        closed.wait()
    t.join()
    tot = span_totals()
    assert tot["main"]["calls"] == 1 and tot["other"]["calls"] == n and tot["leaf"]["calls"] == 2 * n
    main_leaves = tot["main"]["s"] - tot["main"]["self_s"]
    other_leaves = tot["other"]["s"] - tot["other"]["self_s"]
    assert main_leaves + other_leaves == pytest.approx(tot["leaf"]["s"])
    # the other thread's leaves (each >= 0.2 ms) are the other span's alone
    assert other_leaves >= n * 0.0002 and main_leaves < other_leaves
    reset_span_totals()


def test_stage_span_sums_a_repeated_stage():
    codec = VAEformerCodec(VAEformer(vaeformer_tiny(), device="cpu"))
    with codec._stage("compress/g_a"):
        pass
    assert codec.stage_times is None
    codec.stage_times = {}
    for _ in range(2):
        with codec._stage("compress/g_a"):
            time.sleep(0.01)
    assert list(codec.stage_times) == ["compress/g_a"] and codec.stage_times["compress/g_a"] >= 0.02
    times = {}
    with profiling.stage_span("x", times, torch.device("cpu")):
        pass
    with profiling.stage_span("x", times, torch.device("cpu")):
        time.sleep(0.005)
    assert list(times) == ["x"] and times["x"] >= 0.005


def test_codec_profile_keeps_its_stages_and_the_coder_spans_launch_nothing():
    torch.manual_seed(0)
    codec = VAEformerCodec(VAEformer(vaeformer_tiny(), device="cpu").reset_parameters(5))
    codec.update()
    x = np.random.default_rng(7).standard_normal((1, 8, 41, 40)).astype(np.float32)
    codec.compress(x)
    reset_span_totals()
    with _profile() as prof:
        out = codec.compress(x)
        x_hat = codec.decompress(out["strings"], out["z_shape"])["x_hat"]
    assert torch.isfinite(x_hat.float()).all()
    evs = _events(prof)
    ranges = [e for e in evs if e[4]]
    assert [e[0] for e in ranges if e[0].split("/")[0] in ("compress", "decompress")] == STAGES
    coder = [e for e in ranges if e[0] in ("coder/pack", "coder/parse")]
    assert sorted(e[0] for e in coder) == ["coder/pack"] * 2 + ["coder/parse"] * 2
    for name, s, e, thread, _ in coder:
        inside = [o[0] for o in evs if not o[4] and o[3] == thread and s <= o[1] <= e]
        assert inside == [], (name, inside)
    # each coder span lies in the stage that calls it (the z parse in decode_z)
    stage_of = {"coder/pack": {"compress/finalize"},
                "coder/parse": {"decompress/upload_y", "decompress/decode_z"}}
    for name, s, e, thread, _ in coder:
        outer = [r[0] for r in ranges if r[0] in STAGES and r[1] <= s and e <= r[2]]
        assert len(outer) == 1 and outer[0] in stage_of[name], (name, outer)
    t = span_totals()
    assert t["coder/pack"]["calls"] == 2 and t["coder/parse"]["calls"] == 2
    assert t["compress/finalize"]["self_s"] < t["compress/finalize"]["s"]
    reset_span_totals()


@pytest.mark.parametrize("remat", [False, True, "dots"])
def test_train_step_phases_and_one_recompute_per_rematerialised_block(monkeypatch, remat):
    checkpointed = []
    real = vit.checkpoint
    monkeypatch.setattr(vit, "checkpoint", lambda *a, **k: checkpointed.append(1) or real(*a, **k))
    torch.manual_seed(0)
    model = VAEformer(dataclasses.replace(vaeformer_tiny(), remat=remat),
                      device="cpu").reset_parameters(5)
    tx = make_net_aux_optimizers(1e-4, 1e-3, 1.0)
    step = make_train_step(model, tx, TrainerConfig())
    ps = dict(model.named_parameters())
    state = TrainState(step=0, params=ps, opt_state=tx.init(ps), ema=ema_init(ps))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 8, 41, 40)).astype(np.float32))
    step(state, x, 0)
    checkpointed.clear()
    with _profile() as prof:
        step(state, x, 0)
    ranges = [e for e in _events(prof) if e[4] and e[0].startswith("train/")]
    count = {n: sum(e[0] == n for e in ranges) for n in {e[0] for e in ranges}}
    phases = {"train/forward": 1, "train/backward": 1, "train/optimizer": 1, "train/ema": 1}
    if remat:
        assert len(checkpointed) == len(model.g_a.blocks) + len(model.g_s.blocks)
        phases["train/recompute"] = len(checkpointed)
    else:
        assert checkpointed == []
    assert count == phases
    backward = next(e for e in ranges if e[0] == "train/backward")
    for e in ranges:
        if e[0] == "train/recompute":
            assert backward[1] <= e[1] and e[2] <= backward[2]
    order = [e[0] for e in sorted(ranges, key=lambda e: e[1]) if e[0] != "train/recompute"]
    assert order == ["train/forward", "train/backward", "train/optimizer", "train/ema"]
