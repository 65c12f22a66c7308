"""Port vs JAX: the evaluation and profiling tools on the CPU.

``era5_eval.evaluate_fields`` against JAX's on seeded fields (both input
ranks, with channel names) within RTOL relative: float32 sums in another
order. ``forecast_eval.main`` against JAX's on a tiny HRES eval tree (the
trees of test_torch_data.py: per-channel .npy timesteps, forecast runs and
day-of-year climate means, written by the JAX package's writers), within
RTOL, and the anomaly correlations within ACC_ATOL. ``update_model``
writes JAX's bytes under JAX's SHA-stamped name, and each package's
``unpack_with_tables`` reads the other's file. And ``decode_profile.main``
on the tiny model runs to its end on the CPU with the JAX tool's keys, its
batched ``bin_bytes_b2`` the streams of both samples."""

import json

import numpy as np
import pytest
import torch

import cra5_tpu.data as jdata
from cra5_tpu.tools import era5_eval as j_era5_eval
from cra5_tpu.tools import forecast_eval as j_forecast_eval
from cra5_tpu.tools import update_model as j_update_model
from cra5_tpu_torch.tools import decode_profile, era5_eval, forecast_eval, update_model
from test_torch_convert_torch import _assert_trees_equal

RTOL = 1e-6
ACC_ATOL = 1e-6  # a correlation in [-1, 1]: near 0 a relative bound means nothing


def _close(a, b, atol=0.0):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k], ACC_ATOL if k == "acc" else atol)
    elif isinstance(a, float) or (isinstance(a, list) and not isinstance(a[0], str)):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=RTOL, atol=atol)
    else:
        assert a == b


@pytest.mark.parametrize("rank,names", [(3, False), (4, False), (4, True)])
def test_evaluate_fields_equals_jax(rank, names):
    rng = np.random.default_rng(rank + 10 * names)
    shape = (3, 19, 36) if rank == 3 else (2, 3, 19, 36)
    target = (rng.standard_normal(shape) * 50 + 280).astype(np.float32)
    recon = (target + rng.standard_normal(shape) * 2).astype(np.float32)
    cn = ["z_500", "t_850", "t2m"] if names else None
    got = era5_eval.evaluate_fields(recon, target, cn, device="cpu")
    want = j_era5_eval.evaluate_fields(recon, target, cn)
    _close(got, want)
    if names:
        assert list(got["wrmse"]) == cn


def test_era5_eval_main_equals_jax(tmp_path, capsys):
    rng = np.random.default_rng(1)
    t = rng.standard_normal((4, 9, 16)).astype(np.float32)
    np.save(tmp_path / "t.npy", t)
    np.save(tmp_path / "r.npy", t + 0.1 * rng.standard_normal(t.shape).astype(np.float32))
    args = [str(tmp_path / "r.npy"), str(tmp_path / "t.npy")]
    assert j_era5_eval.main(args) == 0
    want = json.loads(capsys.readouterr().out)
    assert era5_eval.main(args + ["--device", "cpu", "-o", str(tmp_path / "o.json")]) == 0
    got = json.loads(capsys.readouterr().out)
    _close(got, want)
    assert json.loads((tmp_path / "o.json").read_text()) == got


VNAMES = dict(pressure=["z", "t"], single=["t2m"])
LEVELS = [50, 100]
YEARS = ("2020-01-01T00:00:00", "2020-01-02T00:00:00")
HW = (9, 16)


@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    """An archive of per-channel .npy timesteps (YEARS plus the 12 hours
    past its end), HRES runs of two steps per init time, and climate means."""
    base = tmp_path_factory.mktemp("fc")
    root, runs, clim = str(base / "era5"), str(base / "runs"), str(base / "clim")
    ds = jdata.ERA5NpyDataset(root, VNAMES, LEVELS, (YEARS[0], "2020-01-02T12:00:00"))
    rng = np.random.default_rng(3)
    C, names = ds.num_channels, ds.channel_names()
    for ts in ds.timestamps:
        jdata.ERA5NpyDataset.save_timestep(
            root, ts, rng.standard_normal((C, *HW)).astype(np.float32) * 7, names)
        jdata.ERA5EvalDataset.save_prediction_run(
            runs, ts, [rng.standard_normal((C, *HW)).astype(np.float32) * 7 for _ in range(2)])
    for md in ("01-01", "01-02", "01-03"):
        jdata.ERA5EvalDataset.save_climate_mean(
            clim, md, rng.standard_normal((C, *HW)).astype(np.float32), names)
    return root, runs, clim


def test_forecast_eval_equals_jax(eval_tree, tmp_path):
    root, runs, clim = eval_tree
    args = [root, "--mode", "hres", "--pred-root", runs, "--climate-root", clim,
            "--years", *YEARS, "--gt-offsets", "6", "12", "--vnames", "z,t",
            "--levels", "50,100", "--singles", "t2m"]
    assert j_forecast_eval.main(args + ["-o", str(tmp_path / "j.json")]) == 0
    assert forecast_eval.main(args + ["--device", "cpu", "-o", str(tmp_path / "t.json")]) == 0
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert set(got) == {"channels", "lead_hours", "wrmse", "mae", "acc", "mode", "n_init_times"}
    assert got["n_init_times"] > 1
    _close(got, want)


def test_update_model_writes_jax_bytes_and_each_reads_the_other(tmp_path):
    """The checkpoint both read: a seeded mbt2018-mean q1 in the JAX
    package's .msgpack format (the port's writer, byte-equal to flax's)."""
    from cra5_tpu_torch.models import load_model
    from cra5_tpu_torch.train.checkpoints import save_variables

    model, _ = load_model("mbt2018-mean", 1, seed=3, device="cpu")
    ckpt = tmp_path / "ckpt.msgpack"
    save_variables(str(ckpt), dict(model.named_parameters()), model=model)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    argv = [str(ckpt), "-a", "mbt2018-mean", "-q", "1", "-d"]
    assert j_update_model.main(argv + [str(tmp_path / "j")]) == 0
    assert update_model.main(argv + [str(tmp_path / "t"), "--device", "cpu"]) == 0
    (jf,), (tf,) = list((tmp_path / "j").iterdir()), list((tmp_path / "t").iterdir())
    assert tf.name == jf.name and tf.name.startswith("mbt2018-mean-1-")
    assert tf.read_bytes() == jf.read_bytes()
    for reader in (j_update_model.unpack_with_tables, update_model.unpack_with_tables):
        (va, ta), (vb, tb) = reader(tf.read_bytes()), reader(jf.read_bytes())
        assert set(ta) == set(tb) == {"eb", "gc", "scale_table"}
        for k in ("eb", "gc"):
            for f in ("quantized_cdf", "cdf_length", "offset"):
                assert np.array_equal(getattr(ta[k], f), getattr(tb[k], f))
        assert np.array_equal(ta["scale_table"], tb["scale_table"])
        _assert_trees_equal(va, vb)


def test_decode_profile_on_the_tiny_model(capsys):
    from cra5_tpu_torch import bench

    assert decode_profile.main(["--model", "tiny", "--device", "cpu", "--depths", "2",
                                "--batches", "1,2", "--iters", "2", "--per-window", "4",
                                "--phase-iters", "2"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(result) == {"model", "amp", "bin_bytes_b1", "bin_bytes_b2", "seq_b1", "seq_b2",
                           "pipelined_b1", "pipelined_b2", "phase_chain_cumulative_s",
                           "phase_budget_s"}
    assert set(result["seq_b2"]) == {"median_s", "per_sample_s", "decodes_per_sec"}
    assert set(result["pipelined_b2"]["2"]) == {"decodes_per_sec", "windows"}
    assert list(result["phase_budget_s"]) == ["z_upload+scan", "+hyper/scales", "+y_scan",
                                              "+g_s/reconstruct"]
    # the batched figure counts both samples' streams
    s = bench.setup("cpu", "tiny", torch.bfloat16, calibrate=False)
    out = s.codec.compress(bench.field(s.model.cfg, s.device, seed=0, batch=2))
    assert len(out["strings"][0]) == 2
    assert result["bin_bytes_b2"] == sum(len(b) for grp in out["strings"] for b in grp) // 2
