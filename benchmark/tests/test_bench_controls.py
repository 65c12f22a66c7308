"""The controls and the faults at the tiny size on the CPU.

The controls (``benchlib/controls.py``) are the reference one precision
below the configuration's in the program's place: fp8 for the bf16 codec,
TF32 for float32 training; they read well above the program. The faults
break the timed path underneath a whole run of the harness and must turn
``correct`` false: a stream, the hyperprior's z or a reconstruction
altered where it is produced; a training step that leaves its state unchanged, or that drops
half of the batch and takes the mean over the rest."""

import time

import pytest
import torch

from conftest import CELLS, run_tiny, tiny_overrides
from benchlib import controls, harness, judge

BENCHMARK = harness.load_json(harness.HERE.parent / "BENCHMARK.json")


def _ctx(workload, seed):
    cell, config, traffic, limits = harness.cell_files(BENCHMARK, workload)
    over, tr = tiny_overrides(workload)
    return harness.Context(cell, {**config, **over}, {**traffic, **tr}, torch.device("cpu"), seed,
                           1.0, False, time.perf_counter(), lambda msg: None, limits)


def test_codec_control_reads_well_above_the_program():
    for seed in (21, 22):
        prog = {k: v["value"] for k, v in run_tiny(CELLS[0], seed=seed)["checks"].items()}
        ctl = controls.codec(_ctx(CELLS[0], seed))
        assert ctl["fp8"]["x_rel"] >= 3 * prog["x_rel"], (ctl, prog)


def test_codec_z_fault_is_not_correct():
    """Every z symbol one step up, with the rest of the codec consistent
    with it: only ``z_far`` can see it, and it must."""
    ctx = _ctx(CELLS[0], 24)
    out = controls.codec(ctx)["z_plus_one"]
    assert out["z_far"] > 100 * ctx.limits["z_far"], out
    assert out["y_far"] == 0 and out["idx_gap"] == 0 and out["x_rel"] == 0, out
    assert judge.decide(out, ctx.limits)[0] is False


def test_training_control_and_half_batch_read_well_above_the_program():
    for seed in (21, 22):
        prog = {k: v["value"] for k, v in run_tiny(CELLS[1], seed=seed, seconds=0.3)["checks"].items()}
        out = controls.training(_ctx(CELLS[1], seed))
        assert out["tf32"]["grad_gap"] >= 100 * prog["grad_gap"], (out, prog)
        assert out["half_batch"]["grad_gap"] >= 100 * prog["grad_gap"], (out, prog)


def _flip_y_words(monkeypatch):
    from cra5_tpu_torch.coder import lane_coder

    orig = lane_coder.LaneCoder.encode_finalize_many

    def broken(handles):
        out = orig(handles)
        return [s[:-1] + bytes([s[-1] ^ 0x5A]) if len(s) > 40 else s for s in out]

    monkeypatch.setattr(lane_coder.LaneCoder, "encode_finalize_many", staticmethod(broken))


def _alter_reconstruction(monkeypatch):
    from cra5_tpu_torch.models import vaeformer

    orig = vaeformer.VAEformerCodec.decompress

    def broken(self, *a, **k):
        out = orig(self, *a, **k)
        return {"x_hat": out["x_hat"] * 1.25}

    monkeypatch.setattr(vaeformer.VAEformerCodec, "decompress", broken)


def _shift_z(monkeypatch):
    from cra5_tpu_torch.nn import vit

    orig = vit.HyperEncoder.forward
    monkeypatch.setattr(vit.HyperEncoder, "forward", lambda self, *a, **k: orig(self, *a, **k) + 1.0)


def _state_unchanged(monkeypatch):
    from cra5_tpu_torch.train import loop

    orig = loop.make_train_step

    def make(model, tx, cfg, dp_group=None):
        step = orig(model, type("NoUpdate", (), {"update_": lambda *a, **k: None})(), cfg)

        def no_update(state, batch, rng):
            saved = state.step
            ema, state.ema = state.ema, None
            state, metrics = step(state, batch, rng)
            state.ema, state.step = ema, saved
            return state, metrics
        return no_update

    monkeypatch.setattr(loop, "make_train_step", make)


def _half_batch(monkeypatch):
    from cra5_tpu_torch.train import loop

    orig = loop.make_train_step

    def make(*a, **k):
        step = orig(*a, **k)
        return lambda state, batch, rng: step(state, batch[: batch.shape[0] // 2], rng)

    monkeypatch.setattr(loop, "make_train_step", make)


@pytest.mark.parametrize("workload,fault", [
    (CELLS[0], _flip_y_words), (CELLS[0], _alter_reconstruction), (CELLS[0], _shift_z),
    (CELLS[1], _state_unchanged), (CELLS[1], _half_batch)])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    line = run_tiny(workload, seed=23, seconds=0.3)
    assert line["correct"] is False, line["checks"]
