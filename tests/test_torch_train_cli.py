"""``python -m cra5_tpu_torch.tools.train`` on the CPU: a tiny config over a
synthetic per-channel .npy tree, three steps, a checkpoint and a resume;
the mesh rule (a mesh of one device is the one-device trainer, a mesh of
more devices than the world raises the JAX package's ValueError; a dp x tp
mesh over ranks: tests/test_torch_tensor_parallel.py); the data the CLI feeds bitwise equal to the
JAX CLI's ``build_data``; the card by default."""

import os

import numpy as np
import pytest
import torch

from cra5_tpu.tools import train as j_train
from cra5_tpu_torch.data import ERA5NpyDataset
from cra5_tpu_torch.tools import train
from cra5_tpu_torch.train.checkpoints import load_variables, resolve_last_checkpoint

VNAMES = dict(pressure=["z", "t"], single=["t2m", "msl"])  # 2 x 3 + 2 = 8 channels
LEVELS = [1000.0, 850.0, 500.0]
YEARS = ("2020-01-01T00:00:00", "2020-01-01T06:00:00")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("era5_np"))
    ds = ERA5NpyDataset(root, VNAMES, LEVELS, YEARS)
    rng = np.random.default_rng(0)
    for ts in ds.timestamps:
        ERA5NpyDataset.save_timestep(root, ts, rng.standard_normal((8, 41, 40)).astype(np.float32),
                                     ds.channel_names())
    return root


def _config(tmp_path, root, mesh="dict(dp=-1)", extra=""):
    path = tmp_path / "cfg.py"
    path.write_text(
        f"model = dict(type='VAEformer', cfg='tiny')\n"
        f"dataset = dict(type='ERA5NpyDataset', root={root!r}, vnames={VNAMES!r}, "
        f"pressure_level={LEVELS!r}, years={YEARS!r}, time_interval=6, batch_size=1)\n"
        f"trainer = dict(learning_rate=1e-3, log_every=1, "
        f"scheduler=dict(type='LinearWarmupLR', warmup_steps=2))\n"
        f"mesh = {mesh}\nsteps = 10\n{extra}")
    return str(path)


def test_three_steps_checkpoint_and_resume(tree, tmp_path, capsys):
    """main() trains three steps on the CPU and prints the params file it
    wrote, which reloads equal to the parameters; --resume from the
    directory continues at step 3 with the saved moments and EMA."""
    cfg, ckpt = _config(tmp_path, tree), str(tmp_path / "ckpt")
    assert train.main([cfg, "--steps", "3", "--ckpt-dir", ckpt, "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == os.path.join(ckpt, "step_3.pt") and len(out) == 4  # 3 log lines
    trainer, state, path = train.run([cfg, "--steps", "2", "--ckpt-dir", ckpt, "--device", "cpu",
                                      "--resume", ckpt])
    assert state.step == 5 and state.opt_state.count == 5 and state.ema.steps == 5
    assert path == os.path.join(ckpt, "step_5.pt")
    saved = load_variables(path)
    assert set(saved) == set(state.params)
    assert all(torch.equal(saved[k], p.detach()) for k, p in state.params.items())
    assert resolve_last_checkpoint(ckpt, "last_state") == os.path.join(ckpt, "state_5.pt")
    assert trainer.model.device.type == "cpu" and trainer.model.dtype == torch.float32


def test_resume_from_a_state_file_and_from_params(tree, tmp_path):
    """--resume state_N.pt restores the whole state; --resume step_N.pt the
    parameters only (the optimizer and the EMA start fresh), as in JAX."""
    cfg, ckpt = _config(tmp_path, tree), str(tmp_path / "ckpt")
    _, first, _ = train.run([cfg, "--steps", "2", "--ckpt-dir", ckpt, "--device", "cpu"])
    params = {k: p.detach().clone() for k, p in first.params.items()}
    _, s, _ = train.run([cfg, "--steps", "1", "--ckpt-dir", str(tmp_path / "a"),
                         "--device", "cpu", "--resume", os.path.join(ckpt, "state_2.pt")])
    assert s.step == 3 and s.opt_state.count == 3
    _, p, _ = train.run([cfg, "--steps", "1", "--ckpt-dir", str(tmp_path / "b"),
                         "--device", "cpu", "--resume", os.path.join(ckpt, "step_2.pt")])
    assert p.step == 1 and p.opt_state.count == 1
    assert any(not torch.equal(p.params[k].detach(), params[k]) for k in params)


@pytest.mark.parametrize("mesh,visible,need", [({"dp": -1}, 1, 1), ({"dp": -1}, 4, 4),
                                               ({"dp": -1, "tp": 2}, 4, 4), ({"dp": 2}, 4, 2),
                                               ({}, 3, 3), ({"dp": 1, "tp": 1}, 1, 1)])
def test_mesh_devices_resolve_as_make_mesh(mesh, visible, need):
    assert train.mesh_devices(mesh, visible) == need


@pytest.mark.parametrize("mesh,visible,err", [({"dp": -1, "tp": -1}, 4, "at most one"),
                                              ({"dp": -1, "tp": 3}, 4, "not divisible"),
                                              ({"dp": 8}, 4, "needs 8 devices")])
def test_mesh_devices_refuse_what_make_mesh_refuses(mesh, visible, err):
    with pytest.raises(ValueError, match=err):
        train.mesh_devices(mesh, visible)


def test_a_tp_mesh_larger_than_the_world_raises_jax_s_value_error(tree, tmp_path):
    """A tp axis of 2 in a world of one rank: the JAX package's make_mesh
    refuses it on one device with the same message."""
    import jax

    from cra5_tpu.parallel import make_mesh as j_make_mesh

    with pytest.raises(ValueError) as want:
        j_make_mesh({"dp": -1, "tp": 2}, devices=jax.devices()[:1])
    cfg = _config(tmp_path, tree, mesh="dict(dp=-1, tp=2)")
    with pytest.raises(ValueError) as got:
        train.run([cfg, "--steps", "1", "--ckpt-dir", str(tmp_path / "c"), "--device", "cpu"])
    assert str(got.value) == str(want.value)


def test_the_cli_feeds_the_jax_clis_batches(tree, tmp_path):
    """build_data: the registered dataset's batches, shuffled by the seed,
    bitwise the JAX CLI's (moved to the CPU here), and the synthetic
    stream's."""
    from cra5_tpu_torch.utils.config import Config

    dcfg = Config.fromfile(_config(tmp_path, tree))["dataset"]
    got = train.build_data(dict(dcfg, epochs=3), seed=4, device="cpu")
    want = j_train.build_data(dict(dcfg, epochs=3), seed=4)
    got, want = [b.numpy() for b in got], list(want)
    assert len(got) == len(want) == 6
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(got, want))
    syn = dict(type="synthetic", shape=(2, 8, 41, 40))
    a, b = train.build_data(syn, seed=1), j_train.build_data(syn, seed=1)
    assert all(np.array_equal(next(a), next(b)) for _ in range(3))


def test_the_cli_defaults_to_the_card(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.run([_config(tmp_path, tree), "--steps", "1"])
