"""Port vs JAX: the published training configurations and their repairs.

A schedule a user registers on the ``SCHEDULERS`` registry builds through
``build_schedule`` and trains through ``TrainerConfig.scheduler`` in both
packages, with the same learning rates and losses; the 268v profile
example runs each variant under the flash mode "auto" and restores the
caller's; the "auto" rule puts the 268v window blocks on the flash path
from batch 3 up; both training CLIs on a 4-stamp tree at the published
batch of 4 with the published trainer block (EMA, clip, warmup-cosine)
from one saved JAX state give the same losses and EMA; a 159-channel
codec writes the same symbols, indexes and bytes as JAX's; and ``serve
--denormalize`` applies the leading 268v statistics to a 159-channel field
in both packages alike (a departure both share)."""

import dataclasses
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cra5_tpu.entropy.entropy_bottleneck as j_ebm
import cra5_tpu.entropy.gaussian_conditional as j_gcm
import cra5_tpu.models.vaeformer as j_vaeformer
from cra5_tpu.api import era5 as j_era5
from cra5_tpu.api.bitstream import save_bin as j_save_bin
from cra5_tpu.entropy import ops as j_ops
from cra5_tpu.models.vaeformer import VAEformer as JVAEformer
from cra5_tpu.models.vaeformer import VAEformerCodec as JCodec
from cra5_tpu.models.vaeformer import vaeformer_tiny as j_tiny
from cra5_tpu.tools import serve as j_serve
from cra5_tpu.tools import train as j_train
from cra5_tpu.train import checkpoints as j_ckpt
from cra5_tpu.train import loop as j_loop
from cra5_tpu.train.ema import ema_init as j_ema_init
from cra5_tpu.train.schedulers import build_schedule as j_build_schedule
from cra5_tpu.utils.registry import SCHEDULERS as J_SCHEDULERS
from cra5_tpu.utils.config import Config as JConfig
from cra5_tpu_torch.data import ERA5NpyDataset
from cra5_tpu_torch.entropy import entropy_bottleneck as ebm
from cra5_tpu_torch.entropy import gaussian_conditional as gcm
from cra5_tpu_torch.entropy import ops
from cra5_tpu_torch.examples import profile_268_train
from cra5_tpu_torch.models import vaeformer as p_vaeformer
from cra5_tpu_torch.models.vaeformer import VAEformer, VAEformerCodec, vaeformer_tiny
from cra5_tpu_torch.nn import blocks
from cra5_tpu_torch.profiling.train_memory import attention_layout
from cra5_tpu_torch.tools import serve, train
from cra5_tpu_torch.train import Trainer, TrainerConfig, TrainState, build_schedule, ema_init
from cra5_tpu_torch.train.schedulers import SCHEDULERS as TRAIN_SCHEDULERS
from cra5_tpu_torch.utils.config import Config
from cra5_tpu_torch.utils.registry import SCHEDULERS

from _torch_pairs import close, pair

ROOT = Path(__file__).resolve().parents[1]
J_CONFIGS = ROOT / "cra5_tpu" / "api" / "configs"
P_CONFIGS = ROOT / "cra5_tpu_torch" / "api" / "configs"
LOSS_RTOL = 1e-3  # tests/test_torch_train.py's trajectory: every metric within rtol 1e-3
PARAM_RTOL = 1e-3  # x the leaf's largest entry, as that file's params and EMA


def _shape_noise(shape):
    """The same uniform(-0.5, 0.5) noise for one shape in both packages,
    every step (tests/test_torch_train.py's rule)."""
    seed = int(np.prod([int(s) + 7 for s in shape])) % (2**31)
    return np.random.default_rng(seed).uniform(-0.5, 0.5, size=shape).astype(np.float32)


@pytest.fixture
def noise_patch(monkeypatch):
    def jq(inputs, mode, means=None, rng=None):
        if mode == "noise":
            return inputs + jnp.asarray(_shape_noise(inputs.shape)).astype(inputs.dtype)
        return j_ops.quantize(inputs, mode, means=means, rng=rng)

    def tq(inputs, mode, means=None, generator=None):
        if mode == "noise":
            return inputs + torch.from_numpy(_shape_noise(tuple(inputs.shape))).to(inputs.dtype)
        return ops.quantize(inputs, mode, means=means, generator=generator)

    for mod in (j_ebm, j_gcm):
        monkeypatch.setattr(mod, "quantize", jq)
    for mod in (ebm, gcm):
        monkeypatch.setattr(mod, "quantize", tq)


# ------------------------------------------------------------------ C16
def reciprocal_lr(base_lr, half_life=2.0):
    """A user's schedule: base_lr * h / (h + count). Plain arithmetic, so
    the same function serves optax (a traced count) and the port."""
    return lambda count: base_lr * half_life / (half_life + count)


USER_LR = "UserReciprocalLR_published_configs"


@pytest.fixture
def user_schedule():
    """USER_LR registered on both packages' registries, and removed
    afterwards, so that no other test of the worker sees it."""
    for registry in (SCHEDULERS, J_SCHEDULERS):
        registry.register(USER_LR)(reciprocal_lr)
    yield dict(type=USER_LR, half_life=3.0)
    for registry in (SCHEDULERS, J_SCHEDULERS):
        del registry._items[USER_LR]
    assert USER_LR not in SCHEDULERS and USER_LR not in J_SCHEDULERS


def test_one_schedule_table():
    """The schedules' module and the registry hold one table: the four
    built-ins are registered once, into utils.registry.SCHEDULERS."""
    from cra5_tpu_torch import registry

    assert TRAIN_SCHEDULERS is SCHEDULERS is registry.SCHEDULERS
    assert sorted(SCHEDULERS.keys()) == sorted(J_SCHEDULERS.keys()) == [
        "ConstantLR", "LinearWarmupLR", "MultiStepLR", "WarmupCosineLR"]


def test_unknown_names_and_options_keep_their_messages():
    with pytest.raises(KeyError, match=r"'NoSuchLR' not found in registry 'schedulers' "
                                       r"\(available: \['ConstantLR'"):
        build_schedule(dict(type="NoSuchLR"), 1e-3)
    with pytest.raises(ValueError, match=r"scheduler 'ConstantLR' got unknown option\(s\) "
                                         r"\['warmup'\]; accepted: \[\]"):
        build_schedule(dict(type="ConstantLR", warmup=3), 1e-3)


def test_a_registered_schedule_trains_as_in_jax(user_schedule, noise_patch):
    """USER_LR builds through each package's build_schedule with the same
    rates (within 1e-9 relative), and three tiny steps through each
    Trainer's TrainerConfig.scheduler, from one set of weights, agree:
    every metric within 1e-3 relative, the parameters and the EMA within
    1e-3 of each leaf's largest entry."""
    lr, steps = 2e-3, 3
    want_rates = [float(j_build_schedule(user_schedule, lr)(c)) for c in range(steps)]
    got_rates = [build_schedule(user_schedule, lr)(c) for c in range(steps)]
    assert got_rates == pytest.approx(want_rates, rel=1e-9, abs=0)
    assert got_rates[0] == lr and got_rates[2] == pytest.approx(lr * 3 / 5, rel=1e-12)

    jm, variables, model = pair(lambda: JVAEformer(j_tiny()),
                                lambda: VAEformer(vaeformer_tiny(), device="cpu"),
                                (1, 8, 41, 40), seed=2)
    x = np.random.default_rng(4).standard_normal((2, 8, 41, 40)).astype(np.float32)
    tcfg = dict(learning_rate=lr, aux_learning_rate=1e-2, max_grad_norm=0.05,
                scheduler=user_schedule, use_ema=True)
    jtrainer = j_loop.Trainer(jm, j_loop.TrainerConfig(**tcfg))
    params = variables["params"]
    jstate = j_loop.TrainState(step=jnp.int32(0), params=params, opt_state=jtrainer.tx.init(params),
                               ema=j_ema_init(params))
    jlosses = []
    for _ in range(steps):
        jstate, m = jtrainer._step_fn(jstate, jnp.asarray(x), jax.random.PRNGKey(1))
        jlosses.append({k: float(v) for k, v in m.items()})

    trainer = Trainer(model, TrainerConfig(**tcfg))
    assert [trainer.tx.net_rate(c) for c in range(steps)] == got_rates
    pp = dict(model.named_parameters())
    state = TrainState(step=0, params=pp, opt_state=trainer.tx.init(pp), ema=ema_init(pp))
    losses = []
    trainer.cfg.log_every = 1
    state = trainer.fit([torch.from_numpy(x)] * steps, state=state, num_steps=steps,
                        log_fn=lambda s, m: losses.append(m))
    assert len(losses) == steps
    for got, want in zip(losses, jlosses):
        for k in want:  # the step alone: no steps_per_sec
            assert got[k] == pytest.approx(want[k], rel=LOSS_RTOL), k
    jp = dict(_port_tree(jstate.params).named_parameters())
    je = dict(_port_tree(jstate.ema.params).named_parameters())
    init = dict(_port_tree(params).named_parameters())
    moved = 0
    for name, p in state.params.items():
        close(p, jp[name].detach(), name, PARAM_RTOL)
        close(state.ema.params[name], je[name].detach(), f"ema {name}", PARAM_RTOL)
        moved += not torch.equal(p.detach(), init[name].detach())
    assert moved > 0.9 * len(state.params)


def _port_tree(flax_params, cfg=None):
    from cra5_tpu_torch.convert import load_flax_variables

    return load_flax_variables(VAEformer(cfg or vaeformer_tiny(), device="cpu"),
                               {"params": jax.device_get(flax_params)})


# ------------------------------------------------------------------ C17
def test_profile_runs_each_variant_under_auto_and_restores_on(monkeypatch, capsys, tmp_path):
    """Under "on", profile_268_train (the tiny config in place of 268v)
    runs every step of both variants under "auto" and leaves "on" set; a
    variant that raises leaves "on" set too."""
    seen = []

    class Recording(Trainer):
        def fit(self, *a, **kw):
            seen.append(blocks.flash_attention_mode())
            return super().fit(*a, **kw)

    monkeypatch.setattr(profile_268_train, "vaeformer_268", vaeformer_tiny)
    monkeypatch.setattr(profile_268_train, "Trainer", Recording)
    mode = blocks.flash_attention_mode()
    blocks.set_flash_attention("on")
    try:
        assert profile_268_train.main(["--device", "cpu", "--steps", "2"]) == 0
        res = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert {"auto+full", "auto+dots", "decision"} <= set(res)
        assert seen == ["auto"] * 6  # (a warm-up and 2 timed steps) x 2 variants
        assert blocks.flash_attention_mode() == "on"

        def boom(*a, **kw):
            assert blocks.flash_attention_mode() == "auto"
            raise RuntimeError("variant failed")

        monkeypatch.setattr(profile_268_train, "_variant", boom)
        with pytest.raises(RuntimeError, match="variant failed"):
            profile_268_train.main(["--device", "cpu", "--steps", "1"])
        assert blocks.flash_attention_mode() == "on"
    finally:
        blocks.set_flash_attention(mode)


# ------------------------------------------------------------------ the "auto" rule
@pytest.mark.parametrize("batch,flash", [(1, False), (2, False), (3, True), (4, True)])
def test_auto_puts_the_268v_window_blocks_on_flash_from_batch_3(batch, flash):
    """A 268v window block attends over B x 18 windows x 16 heads of 576
    tokens: its float32 logits reach the 1 GiB rule at B = 3 (1.15 GB),
    not at B = 2 (0.76 GB). Arithmetic only: no card is asked."""
    mode = blocks.flash_attention_mode()
    blocks.set_flash_attention("auto")
    try:
        cfg = p_vaeformer.vaeformer_268()
        wh, ww = cfg.window_sizes[0]
        windows = (cfg.img_size[0] // cfg.patch_stride[0]) * (cfg.img_size[1] // cfg.patch_stride[1]) \
            // (wh * ww)
        assert (wh * ww, windows, cfg.num_heads) == (576, 18, 16)
        bh = batch * windows * cfg.num_heads
        assert blocks._use_flash(576, bh, torch.device("cuda")) is flash
        assert (bh * 576 * 576 * 4 >= blocks.FLASH_MIN_LOGIT_BYTES) is flash
        assert blocks._use_flash(576, bh, torch.device("cpu")) is False
    finally:
        blocks.set_flash_attention(mode)


def test_the_268v_blocks_put_18_window_and_7_global_attentions_on_flash_at_batch_4():
    """profiling/train_memory.py::attention_layout reads the built 268v
    model's blocks: 18 window blocks of 576 tokens in g_a and g_s (12 at
    18 windows, 6 of 48 x 12 at 24 over the grid padded to 96 rows), 7
    global blocks of 10 368 tokens and 8 hyperprior blocks of 648. Under
    "auto" on the card the 7 global blocks take K4 at every batch, the
    window blocks from batch 3, the hyperprior never (the counts
    chip_smoke.CONFIG_FLASH holds). Arithmetic only: no card is asked."""
    mode = blocks.flash_attention_mode()
    blocks.set_flash_attention("auto")
    try:
        rows = attention_layout(VAEformer(p_vaeformer.vaeformer_268(), device="cpu"))
        window = [r for r in rows if r[0] in ("g_a", "g_s") and r[2] > 1]
        assert sorted({(n, w, h) for _, n, w, h in window}) == [(576, 18, 16), (576, 24, 16)]
        assert [sum(r[2] == w for r in window) for w in (18, 24)] == [12, 6]
        assert [r[1:] for r in rows if r[0] in ("g_a", "g_s") and r[2] == 1] == [(10368, 1, 16)] * 7
        assert [r[1:] for r in rows if r[0] in ("h_a", "h_s")] == [(648, 1, 5)] * 8
        for batch, want in ((1, (0, 7)), (2, (0, 7)), (3, (18, 7)), (4, (18, 7))):
            on = [blocks._use_flash(n, batch * w * h, torch.device("cuda")) for _, n, w, h in rows]
            got = [sum(f for f, r in zip(on, rows) if r[0] in ("g_a", "g_s") and (r[2] > 1) is k)
                   for k in (True, False)]
            assert tuple(got) == want and not any(
                f for f, r in zip(on, rows) if r[0] in ("h_a", "h_s")), batch
    finally:
        blocks.set_flash_attention(mode)


# ------------------------------------------------------------------ the CLIs at batch 4
VNAMES = dict(pressure=["z", "t"], single=["t2m", "msl"])  # 2 x 3 + 2 = 8 channels
LEVELS = [1000.0, 850.0, 500.0]
YEARS = ("2020-01-01T00:00:00", "2020-01-01T18:00:00")  # four six-hourly stamps


def _cli_config(path, base, root):
    path.write_text(
        f"_base_ = [{str(base / 'train_era5_base.py')!r}]\n"
        f"model = dict(type='VAEformer', cfg='tiny')\n"
        f"dataset = dict(root={root!r}, vnames={VNAMES!r}, pressure_level={LEVELS!r}, "
        f"years={YEARS!r})\n"
        f"trainer = dict(log_every=1)\n"
        f"mesh = dict(dp=1)\n")
    return str(path)


def test_both_clis_train_the_published_block_at_batch_4_alike(tmp_path, noise_patch, monkeypatch):
    """Both CLIs, each on a config whose _base_ is its package's
    train_era5_base.py (batch 4, EMA, clip 1.0, WarmupCosineLR over the
    300 000-step horizon), resume one saved JAX state of seeded weights and
    train three steps on the same 4-stamp tree: every metric within 1e-3
    relative, the parameters and the EMA within 1e-3 of each leaf's largest
    entry, and the port's rates the published schedule's."""
    root = str(tmp_path / "era5_np")
    ds = ERA5NpyDataset(root, VNAMES, LEVELS, YEARS)
    assert len(ds) == 4
    rng = np.random.default_rng(0)
    for ts in ds.timestamps:
        ERA5NpyDataset.save_timestep(root, ts, rng.standard_normal((8, 41, 40)).astype(np.float32),
                                     ds.channel_names())
    jcfg = _cli_config(tmp_path / "j.py", J_CONFIGS, root)
    pcfg = _cli_config(tmp_path / "p.py", P_CONFIGS, root)
    published = Config.fromfile(pcfg)
    assert published["dataset"]["batch_size"] == 4 and published["steps"] == 300_000
    assert JConfig.fromfile(jcfg)["trainer"] == published["trainer"]

    # one saved JAX train state at step 0: seeded weights, zero moments, EMA
    tc = dict(published["trainer"], scheduler=dict(published["trainer"]["scheduler"]),
              total_steps=300_000)
    init_dir = str(tmp_path / "init")
    jt = j_loop.Trainer(JVAEformer(j_tiny()), j_loop.TrainerConfig(**dict(tc, ckpt_dir=init_dir)))
    j_ckpt.save_train_state(os.path.join(init_dir, "state_0.msgpack"),
                            jax.device_get(jt.init_state(jnp.zeros((4, 8, 41, 40)))))
    state0 = os.path.join(init_dir, "state_0.msgpack")

    jlosses = []
    fit = j_loop.Trainer.fit
    monkeypatch.setattr(j_loop.Trainer, "fit", lambda self, data, state=None, num_steps=None,
                        log_fn=None: fit(self, data, state, num_steps,
                                         lambda s, m: jlosses.append(m)))
    jdir = str(tmp_path / "jax_ckpt")
    assert j_train.main([jcfg, "--steps", "3", "--ckpt-dir", jdir, "--resume", state0]) == 0
    losses = []
    trainer, state, path = train.run([pcfg, "--steps", "3", "--ckpt-dir", str(tmp_path / "pt"),
                                      "--device", "cpu", "--resume", state0],
                                     log_fn=lambda s, m: losses.append(m))
    assert len(losses) == len(jlosses) == 3 and state.step == 3 and state.ema.steps == 3
    for got, want in zip(losses, jlosses):
        assert set(got) == set(want)
        for k in set(want) - {"steps_per_sec"}:
            assert got[k] == pytest.approx(float(want[k]), rel=LOSS_RTOL), k
    want_lr = build_schedule(dict(type="WarmupCosineLR", warmup_steps=2000, min_lr_ratio=0.1),
                             1e-4, 300_000)
    for c in (0, 1, 2, 2000, 150_000, 299_999):
        assert trainer.tx.net_rate(c) == pytest.approx(want_lr(c), rel=1e-9, abs=0)
    assert trainer.cfg.total_steps == 300_000 and trainer.tx.max_grad_norm == 1.0
    jstate = Trainer(VAEformer(vaeformer_tiny(), device="cpu"), trainer.cfg).restore(
        torch.zeros(4, 8, 41, 40), path=os.path.join(jdir, "state_3.msgpack"))
    assert jstate.step == 3 and jstate.ema.steps == 3
    for name, p in state.params.items():
        close(p, jstate.params[name].detach(), name, PARAM_RTOL)
        close(state.ema.params[name], jstate.ema.params[name], f"ema {name}", PARAM_RTOL)
    assert os.path.basename(path) == "step_3.pt"


@pytest.mark.parametrize("form", ["bf16 by name", "remat config object"])
def test_the_published_configs_build_in_bf16_through_both_clis(form, tmp_path):
    """The `model` key a derived config adds, written to a config file as
    the card's smoke writes it and read by each package's Config: by name
    with dtype="bfloat16", which builds a bf16 model, or as a
    dataclasses.replace(vaeformer_<m>(), remat=True) object, which builds a
    float32 remat model (the tiny geometry here)."""
    line = {"bf16 by name": "model = dict(type='VAEformer', cfg='tiny', dtype='bfloat16')\n",
            "remat config object": "model = dict(type='VAEformer', "
                                   "cfg=dataclasses.replace(vaeformer_tiny(), remat=True))\n"}[form]
    built = {}
    for pkg, config, cli in (("cra5_tpu", JConfig, j_train), ("cra5_tpu_torch", Config, train)):
        path = tmp_path / f"{pkg}.py"
        path.write_text(f"import dataclasses\n\nfrom {pkg}.models.vaeformer import "
                        f"vaeformer_tiny\n\n{line}")
        model_cfg = config.fromfile(str(path))["model"]
        built[pkg] = (cli.build_model(model_cfg) if pkg == "cra5_tpu"
                      else cli.build_model(model_cfg, device="cpu"))
    jm, pm = built["cra5_tpu"], built["cra5_tpu_torch"]
    bf16 = form == "bf16 by name"
    assert jnp.dtype(jm.dtype) == (jnp.bfloat16 if bf16 else jnp.float32)
    assert pm.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert jm.cfg.remat is (not bf16) and pm.cfg.remat is (not bf16)
    assert pm.cfg == dataclasses.replace(vaeformer_tiny(), remat=not bf16)
    assert pm.g_a.remat is (not bf16) and pm.g_s.remat is (not bf16)


@pytest.mark.parametrize("config", ["train_era5_268v_1h.py", "train_era5_159v_1h.py"])
def test_one_tree_serves_both_published_models(config):
    """159v's channels are 268v's (z, q, u, v, t, w at 25 of the 37
    levels, eight of the nine surface fields) plus tp6h, in both packages'
    configs; each config's model is its own VAEformer at batch 4."""
    def names(cfg):
        d = cfg["dataset"]
        return ERA5NpyDataset("", d["vnames"], d["pressure_level"], ("2020-01-01", "2020-01-01"),
                              ).channel_names()

    p268, p159 = (Config.fromfile(str(P_CONFIGS / c)) for c in
                  ("train_era5_268v_1h.py", "train_era5_159v_1h.py"))
    got, want = Config.fromfile(str(P_CONFIGS / config)), JConfig.fromfile(str(J_CONFIGS / config))
    assert names(got) == names(want) and got["model"] == want["model"]
    assert got["dataset"]["batch_size"] == 4
    n268, n159 = names(p268), names(p159)
    assert (len(n268), len(n159)) == (268, 159)
    assert set(n159) - set(n268) == {"tp6h"} and len(set(n268) | set(n159)) == 269


# ------------------------------------------------------------------ the 159-channel codec
def test_159_channel_codec_writes_jax_s_symbols_indexes_and_bytes():
    """vaeformer_tiny(in_chans=159): the 159-channel patch embed and the
    exact-41 ConvTranspose back to 159 channels (721's geometry at tiny
    size). Float32 symbols and GC indexes exact, the containers byte for
    byte, and each package decodes the other's within the float32
    towers' tolerance."""
    gen = torch.Generator().manual_seed(9)

    def spread(m):
        for p in m.parameters():
            p.add_(0.2 * torch.randn(p.shape, generator=gen))

    jm, variables, model = pair(lambda: JVAEformer(j_tiny(in_chans=159)),
                                lambda: VAEformer(vaeformer_tiny(in_chans=159), device="cpu"),
                                (1, 159, 41, 40), seed=1, tweak=spread)
    jcodec = JCodec(jm, variables)
    jcodec.update()
    codec = VAEformerCodec(model)
    codec.update()
    x = np.random.default_rng(11).standard_normal((2, 159, 41, 40)).astype(np.float32)
    want = jcodec._encode_symbols(jcodec.variables, jnp.asarray(x), jcodec._scale_table_dev)
    with torch.inference_mode():
        got = codec.model.encode_symbols(torch.from_numpy(x))
        got["gc_idx"] = codec._gc_indexes(got["scales"])
    for key in ("z_sym", "y_sym", "gc_idx"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert np.unique(got["y_sym"].numpy()).size > 3 and np.unique(got["gc_idx"].numpy()).size > 3
    jout, out = jcodec.compress(x), codec.compress(x)
    assert out["strings"] == [list(s) for s in jout["strings"]]
    mine = codec.decompress(jout["strings"], jout["z_shape"])["x_hat"]
    theirs = jcodec.decompress(out["strings"], out["z_shape"])["x_hat"]
    assert tuple(mine.shape) == (2, 159, 41, 40)
    close(mine, theirs, "x_hat", 1e-4)


# ------------------------------------------------------------------ C19
def test_c19_serve_denormalizes_159_channels_with_the_leading_268v_statistics(
        tmp_path, monkeypatch):
    """Kept as JAX has it: ``serve --config 159 --denormalize`` scales a
    159-channel field by the first 159 of the 268v means and stds in both
    packages. The 268v channel order puts z, q, u, v at 37 levels and t at
    11 there, where 159v's channel 25 is q1000: the units come out wrong
    alike. (The 159v geometry is the tiny one here.)"""
    tiny159 = lambda: j_tiny(in_chans=159)
    monkeypatch.setattr(j_vaeformer, "vaeformer_159", tiny159)
    monkeypatch.setattr(p_vaeformer, "vaeformer_159", lambda: vaeformer_tiny(in_chans=159))
    jm, variables, _ = pair(lambda: JVAEformer(tiny159()),
                            lambda: VAEformer(vaeformer_tiny(in_chans=159), device="cpu"),
                            (1, 159, 41, 40), seed=3)
    ckpt = str(tmp_path / "tiny159.msgpack")
    j_ckpt.save_variables(ckpt, variables)
    jcodec = JCodec(jm, variables)
    jcodec.update()
    x = np.random.default_rng(5).standard_normal((1, 159, 41, 40)).astype(np.float32)
    out = jcodec.compress(x)
    bins = tmp_path / "bins"
    bins.mkdir()
    j_save_bin(str(bins / "a.bin"), out["strings"], out["z_shape"])
    x_hat = np.asarray(jcodec.decompress(out["strings"], out["z_shape"])["x_hat"])[0]

    api_cfg = JConfig.fromfile(str(J_CONFIGS / "cra5_268v.py"))
    mean, std = j_era5.load_mean_std(api_cfg)
    lead = x_hat * std[:159].reshape(-1, 1, 1) + mean[:159].reshape(-1, 1, 1)
    args = [str(bins), "--config", "159", "--checkpoint", ckpt, "--denormalize", "--threads", "1"]
    assert j_serve.main(args + ["-o", str(tmp_path / "jax")]) == 0
    assert serve.main(args + ["-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    got_j, got_p = np.load(tmp_path / "jax" / "a.npy"), np.load(tmp_path / "port" / "a.npy")
    assert got_j.shape == got_p.shape == (159, 41, 40)
    close(got_j, lead, "JAX serve vs the leading 268v statistics", 1e-5)
    close(got_p, got_j, "port serve vs JAX serve", 1e-4)
    names_268 = [f"{v}{lv}" for v in api_cfg["vnames"]["pressure"]
                 for lv in api_cfg["pressure_level"]] + list(api_cfg["vnames"]["single"])
    p159 = Config.fromfile(str(P_CONFIGS / "train_era5_159v_1h.py"))["dataset"]
    names_159 = [f"{v}{lv}" for v in p159["vnames"]["pressure"]
                 for lv in p159["pressure_level"]] + list(p159["vnames"]["single"])
    assert names_159[25].startswith("q") and names_268[25].startswith("z")
    assert sum(a != b for a, b in zip(names_268[:159], names_159)) > 100
