"""Port vs JAX: the walkthroughs of cra5_tpu_torch.examples on the CPU.

The demo's field upsampling against jax.image.resize on the same numpy
noise (within 1e-5); the report's render against the JAX script's, line
for line but the one naming the run; the tiny demo end to end (its resume
restores every tensor bitwise, repeats the resumed step bitwise, and its
loss trajectory equals an uninterrupted run's; a corrupted restore is
caught); the step-0 eval's bytes equal to those JAX's VAEformerCodec
writes for the same field and weights (MSE within 1e-5 relative); the
quickstart's .bin and figures, test_model, roundtrip_timing, the train
smoke and the profile on the tiny config, and the profile's decision
rule."""

import importlib.util
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cra5_tpu.models.vaeformer import VAEformer as JVAEformer
from cra5_tpu.models.vaeformer import VAEformerCodec as JCodec
from cra5_tpu.models.vaeformer import vaeformer_tiny as j_tiny
from cra5_tpu_torch.examples import (profile_268_train, quickstart, roundtrip_timing, test_model,
                                     train_268v_smoke, train_demo_268, train_demo_report)
from cra5_tpu_torch.models.vaeformer import VAEformer, vaeformer_tiny
from cra5_tpu_torch.train import Trainer, TrainerConfig

from _torch_pairs import pair

ROOT = Path(__file__).resolve().parents[1]
MODULES = ("quickstart", "test_model", "roundtrip_timing", "train_268v_smoke", "train_demo_268",
           "train_demo_report", "profile_268_train")
JAX_KEYS = {"config", "codec_step0", "resume", "losses", "codec_trained", "codec_trained_ema"}
TINY_DEMO = ["--device", "cpu", "--config", "tiny", "--steps", "6", "--save-at", "3",
             "--pool", "2"]


@pytest.fixture(scope="module")
def helps():
    """Each module's --help, run as ``python -m`` would run it."""
    code = textwrap.dedent(f"""
        import contextlib, io, json, runpy, sys
        out = {{}}
        for name in {MODULES!r}:
            sys.argv = [name, "--help"]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                try:
                    runpy.run_module("cra5_tpu_torch.examples." + name, run_name="__main__")
                except SystemExit as e:
                    out[name] = [e.code, buf.getvalue()]
        print(json.dumps(out))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.splitlines()[-1])


@pytest.mark.parametrize("name", MODULES)
def test_help_wiring(helps, name):
    code, text = helps[name]
    assert code == 0 and text.startswith("usage:")
    assert ("--device" in text) == (name != "train_demo_report")


@pytest.mark.parametrize("coarse,shape", [((4, 6, 10), (4, 96, 160)),
                                          ((2, 5, 9), (2, 77, 144)),
                                          ((1, 2, 2), (8, 41, 40))])
def test_field_upsampling_equals_jax_resize(coarse, shape):
    """The demo's upsampling (an integer factor, the 268v field's
    non-integer 46 -> 721, and the tiny config's channel axis 1 -> 8) is
    jax.image.resize's bilinear one, borders included."""
    rng = np.random.default_rng(5)
    c = rng.standard_normal(coarse).astype(np.float32)
    fine = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(c), shape, method="bilinear"))
    got = train_demo_268.upsample(torch.from_numpy(c), shape).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    field = train_demo_268.make_field(torch.from_numpy(c), torch.from_numpy(fine)).numpy()
    np.testing.assert_allclose(field, ((want + 0.05 * fine)[None] * 0.5), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    d = tmp_path_factory.mktemp("demo")
    out = d / "result.json"
    res = train_demo_268.main(TINY_DEMO + ["--ckpt-dir", str(d / "ckpt"), "--out", str(out)])
    return res, json.loads(out.read_text())


def test_tiny_demo_resumes_bitwise_and_writes_jax_keys(demo):
    res, saved = demo
    assert set(saved) == JAX_KEYS | {"timing"}
    assert set(res) == set(saved) | {"total_loss"}
    assert saved["resume"]["checksums_match"] and saved["resume"]["resumed_step"] == 3
    assert saved["resume"]["repeat_bitwise"] and saved["resume"]["bytes"] > 0
    assert sorted(int(k) for k in saved["losses"]) == [3, 4, 6]
    assert all(np.isfinite(v) for m in saved["losses"].values() for v in m.values())
    for k in ("codec_step0", "codec_trained", "codec_trained_ema"):
        assert set(saved[k]) >= {"bin_bytes", "bpp", "mse", "wall_s"}
        assert saved[k]["bpp"] == 8 * saved[k]["bin_bytes"] / (41 * 40)


def test_tiny_demo_trajectory_equals_an_uninterrupted_run(demo):
    """Six steps of one Trainer on the same fields give the demo's losses
    exactly: the save, the fresh Trainer and the restore change nothing."""
    res, _ = demo
    shape, coarse = (8, 41, 40), (1, 2, 2)
    fields = [train_demo_268.seeded_field(1000 + i % 2, shape, coarse, "cpu") for i in range(6)]
    tcfg = TrainerConfig(learning_rate=1e-4, lmbda=1.0, bpp_weight=0.02, use_ema=True,
                         log_every=1, ckpt_every=10**9)
    trainer = Trainer(VAEformer(vaeformer_tiny(), device="cpu"), tcfg)
    total = []
    state = trainer.init_state(fields[0])
    trainer.fit(fields, state=state, num_steps=6, log_fn=lambda s, m: total.append(m["total_loss"]))
    assert total == res["total_loss"]


@pytest.mark.parametrize("fault,match", [
    ("ema tensor", "restored state differs"), ("ema count", "restored state differs"),
    ("step noise", "from the restored state differs from the live one")])
def test_tiny_demo_catches_a_corrupted_restore(monkeypatch, tmp_path, fault, match):
    """A restore that misses a tensor or a count, or a resumed step that
    draws other noise than the live one, fails the demo."""
    restore = Trainer.restore

    def corrupt(self, *args, **kwargs):
        state = restore(self, *args, **kwargs)
        if fault == "ema count":
            state.ema.steps -= 1
        elif fault == "ema tensor":
            next(iter(state.ema.params.values())).view(-1)[0] += 1e-3
        else:
            self.seed += 1  # fit folds seed + 1 and the step into the noise
        return state

    monkeypatch.setattr(Trainer, "restore", corrupt)
    with pytest.raises(RuntimeError, match=match):
        train_demo_268.main(TINY_DEMO + ["--ckpt-dir", str(tmp_path)])


def test_render_matches_the_jax_report(demo):
    _, saved = demo
    spec = importlib.util.spec_from_file_location("jax_demo_report",
                                                  ROOT / "examples" / "train_demo_report.py")
    jax_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_report)
    ours, theirs = train_demo_report.render(saved).split("\n"), jax_report.render(saved).split("\n")
    assert len(ours) == len(theirs)
    differ = [(a, b) for a, b in zip(ours, theirs) if a != b]
    assert len(differ) == 1 and all(s.startswith("Generated ") for s in differ[0])


def test_step0_eval_writes_jax_bytes():
    """The eval's bytes are JAX's VAEformerCodec's for the same field and
    the same float32 tiny weights (a flax tree carried into the port by
    convert.from_flax_params, ``pair``); MSE within 1e-5 relative."""
    cfg = j_tiny()
    x = train_demo_268.seeded_field(99, (cfg.in_chans, *cfg.img_size), (1, 2, 2), "cpu").numpy()
    jm, variables, model = pair(lambda: JVAEformer(cfg),
                                lambda: VAEformer(vaeformer_tiny(), device="cpu"), x.shape, seed=3)
    r = train_demo_268.eval_codec(model, torch.from_numpy(x))
    jcodec = JCodec(jm, variables, coder="v2")
    jcodec.update()
    out = jcodec.compress(x)
    x_hat = np.asarray(jcodec.decompress(out["strings"], out["z_shape"])["x_hat"], np.float32)
    assert r["bin_bytes"] == sum(len(s) for grp in out["strings"] for s in grp)
    assert r["mse"] == pytest.approx(float(np.mean(np.square(x_hat - x))), rel=1e-5)


def test_quickstart_writes_the_bin_and_both_figures(tmp_path):
    r = quickstart.main(["--device", "cpu", "--tiny", "--out", str(tmp_path)])
    assert (tmp_path / "CRA5" / "2024" / "2024-06-01T00:00:00.bin").exists()
    for f in ("2024-06-01T00:00:00_latent.png", "2024-06-01T00:00:00_reconstruction.png"):
        assert (tmp_path / "vis" / f).stat().st_size > 0
    assert r["x_hat_shape"] == (8, 41, 40) and r["x_hat_finite"] and r["bin_bytes"] > 0


def test_zoo_and_timing_examples_run_tiny(tmp_path):
    r = test_model.main(["--device", "cpu"])
    assert r["zoo_x_hat_shape"] == (1, 3, 64, 64) and r["vaeformer_x_hat_shape"] == (1, 8, 41, 40)
    assert r["finite"] and r["zoo_bytes"] > 0 and r["vaeformer_bytes"] > 0
    t = roundtrip_timing.main(["2", "--tiny", "--device", "cpu", "--out", str(tmp_path)])
    assert len(t["encode_s"]) == len(t["decode_s"]) == 2
    assert t["encode_mean_s"] == pytest.approx(np.mean(t["encode_s"]))
    assert t["decode_pstdev_s"] == pytest.approx(np.std(t["decode_s"]))


def test_smoke_and_profile_run_on_the_tiny_config(monkeypatch, capsys, tmp_path):
    """The 268v train smoke and profile, with vaeformer_268 swapped for the
    tiny config: finite metrics; both remat variants timed and decided;
    the trace written."""
    monkeypatch.setattr(train_268v_smoke, "vaeformer_268", vaeformer_tiny)
    monkeypatch.setattr(profile_268_train, "vaeformer_268", vaeformer_tiny)
    r = train_268v_smoke.main(["--device", "cpu"])
    assert all(np.isfinite(v) for v in r["metrics"].values()) and r["step_s"] > 0
    capsys.readouterr()
    assert profile_268_train.main(["--device", "cpu", "--steps", "2", "--trace",
                                   "--trace-dir", str(tmp_path)]) == 0
    res = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert {"auto+full", "auto+dots", "decision", "dots_remat_speedup"} <= set(res)
    assert len(res["auto+dots"]["all_steps_s"]) == 2
    assert Path(res["trace"]).stat().st_size > 0


@pytest.mark.parametrize("full_s,dots_s,dots", [(1.0, 0.9, True), (1.0, 0.95, False),
                                                (1.0, 0.96, False), (2.0, 1.0, True),
                                                (1.0, 1.2, False)])
def test_profile_decision_rule(full_s, dots_s, dots):
    d = profile_268_train.decide(full_s, dots_s)
    assert d["dots_remat_speedup"] == round(full_s / dots_s, 3)
    assert d["decision"].startswith("use remat='dots'") == dots
