"""Port vs JAX: the VIVT-69 experiment, the RD plot and the host-finalize
bench (``tools/vivt69_experiment.py``, ``tools/plot.py``,
``tools/finalize_scaling.py``).

The field generators are numpy in both packages and must give the same
fields bit for bit for one seed; ``vivt69_config`` must equal JAX's field
by field. The port's on-device sampler draws from a ``torch.Generator``
(other numbers than JAX's by design) and is held to the statistics JAX's
own test holds its sampler to (``tests/test_tools_extra.py``): unit
channel variance within 1e-3, and the cross-channel correlation within
0.08 of the host generator's and of the drivers' mix @ mix.T / (1 +
eps^2). ``main --pilot`` runs on the CPU at a small geometry, writes its
JSON and resumes from its checkpoints. finalize_scaling's replayed
containers must equal the recorded ones byte for byte, and its host
parse (the arrays ``LaneCoder._upload`` copies to the card) must read
what JAX's ``_host_parse`` reads from the same containers (JAX pads its
buffers to its transfer buckets: equal up to that zero padding)."""

import dataclasses
import filecmp
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cra5_tpu.tools import finalize_scaling as j_fin
from cra5_tpu.tools import vivt69_experiment as jv
from cra5_tpu_torch.tools import finalize_scaling as fin
from cra5_tpu_torch.tools import plot
from cra5_tpu_torch.tools import vivt69_experiment as v

ROOT = Path(__file__).resolve().parents[1]


def test_field_generators_equal_jax_bitwise():
    got = v.spectral_fields(np.random.default_rng(4), 2, 3, 19, 24, alpha=3.5)
    want = jv.spectral_fields(np.random.default_rng(4), 2, 3, 19, 24, alpha=3.5)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    got = v.correlated_fields(np.random.default_rng(5), 2, 7, 21, 30, rank=3, eps=0.1)
    want = jv.correlated_fields(np.random.default_rng(5), 2, 7, 21, 30, rank=3, eps=0.1)
    assert np.array_equal(got, want)
    mix = np.random.default_rng(6).normal(size=(7, 3)).astype(np.float32)
    got = v.correlated_fields(np.random.default_rng(7), 1, 7, 21, 30, rank=3, mix=mix)
    want = jv.correlated_fields(np.random.default_rng(7), 1, 7, 21, 30, rank=3, mix=mix)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(pilot=True), {}, dict(width=512, depth=6, embed=64)])
def test_vivt69_config_equals_jax(kw):
    got = v.vivt69_config(181, 360, **kw)
    want = jv.vivt69_config(181, 360, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(AssertionError):
        v.vivt69_config(180, 360)


def test_device_sampler_matches_host_statistics():
    c, rank, h, w, eps = 6, 3, 32, 48, 0.2
    rng = np.random.default_rng(3)
    mix = rng.normal(size=(c, rank)).astype(np.float32)
    mix /= np.linalg.norm(mix, axis=1, keepdims=True) + 1e-12
    sampler = v.make_device_sampler(mix, h, w, eps, 3.0, batch=8, device="cpu")
    gen = torch.Generator().manual_seed(0)
    xs = torch.cat([sampler(gen) for _ in range(8)]).numpy()  # (64, c, h, w)
    assert xs.shape == (64, c, h, w) and xs.dtype == np.float32
    host = v.correlated_fields(rng, 64, c, h, w, rank=rank, eps=eps, mix=mix)
    np.testing.assert_allclose(xs.std(axis=(-2, -1)), 1.0, atol=1e-3)

    def corr(a):
        return np.corrcoef(a.transpose(1, 0, 2, 3).reshape(a.shape[1], -1))

    np.testing.assert_allclose(corr(xs), corr(host), atol=0.08)
    np.testing.assert_allclose(corr(xs), mix @ mix.T / (1.0 + eps**2), atol=0.08)
    again = v.make_device_sampler(mix, h, w, eps, 3.0, batch=8, device="cpu")(
        torch.Generator().manual_seed(0))
    assert np.array_equal(again.numpy(), xs[:8])  # the generator decides


PILOT = ["--pilot", "--device", "cpu", "--geometry", "41", "40", "--lmbdas", "128",
         "--nval", "1"]


def test_main_pilot_writes_its_json_and_resumes(tmp_path, capsys):
    out, ckpt = str(tmp_path / "rd.json"), str(tmp_path / "ckpt")
    args = PILOT + ["-o", out, "--ntrain", "2", "--ckpt-dir", ckpt, "--ckpt-every", "1"]
    assert v.main(args + ["--steps", "2"]) == 0
    res = json.loads(Path(out).read_text())
    assert res["geometry"] == [69, 41, 40] and res["steps"] == 2
    (p,) = res["points"]
    assert np.isfinite(p["bpsp"]) and p["bpsp"] > 0 and np.isfinite(p["MSE"])
    assert res["results"] == {"bpsp": [p["bpsp"]], "MSE": [p["MSE"]]}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["out"] == out
    lam = tmp_path / "ckpt" / "lmbda128"
    assert (lam / "last_state").read_text().endswith("state_2.pt")
    # a larger horizon resumes at step 2 and trains one more
    assert v.main(args + ["--steps", "3"]) == 0
    assert "resumed" in capsys.readouterr().err
    assert (lam / "last_state").read_text().endswith("state_3.pt")
    with pytest.raises(ValueError, match="different experiment"):
        v.main(args + ["--steps", "3", "--lr", "1e-3"])


def test_main_pilot_on_the_device_sampler(tmp_path):
    out = str(tmp_path / "rd.json")
    assert v.main(PILOT + ["-o", out, "--ntrain", "0", "--steps", "2", "--ema"]) == 0
    assert np.isfinite(json.loads(Path(out).read_text())["points"][0]["MSE"])


def test_plot_anchors_are_jax_copies_and_plot_writes_a_png(tmp_path, capsys):
    anchors = sorted((ROOT / "cra5_tpu" / "tools" / "plot_data").glob("*.json"))
    assert [a.name for a in anchors] == [f"{n}.json" for n in plot.list_anchors()]
    for a in anchors:
        assert filecmp.cmp(a, plot.ANCHOR_DIR / a.name, shallow=False)
    with pytest.raises(FileNotFoundError, match="VIVT-69"):
        plot.resolve_result_path("no-such-anchor")
    pytest.importorskip("matplotlib")
    mine = tmp_path / "mine.json"
    mine.write_text(json.dumps({"name": "mine", "results": {"bpsp": [0.2, 0.1],
                                                            "MSE": [0.01, 0.02]}}))
    png = tmp_path / "rd.png"
    assert plot.main(["-f", "VIVT-69", str(mine), "--metric", "MSE", "-o", str(png)]) == 0
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert plot.main(["-f", str(mine), "--metric", "psnr", "-o", str(png)]) == 1


def test_finalize_record_replay_and_host_parse(tmp_path, capsys):
    npz = str(tmp_path / "fin.npz")
    assert fin.main(["record", "-o", npz, "--model", "tiny", "--device", "cpu",
                     "--no-calibrate"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["recorded_streams"] == 2  # z + y
    streams = fin.load_recording(npz)
    assert sum(len(s["container"]) for s in streams) == rec["bin_bytes"]
    assert fin.main(["replay", npz, "--workers", "1,2", "--seconds", "0.2", "--parse"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rep["encode_finalize"]) == set(rep["decode_parse"]) == {"1", "2"}
    assert rep["streams_per_sample"] == 2 and rep["bin_bytes"] == rec["bin_bytes"]
    datas = [s["container"] for s in streams]
    for d, got in zip(datas, fin.host_parse(datas)):
        for g, w in zip(got, j_fin._host_parse([d])):
            g = g.view(w.dtype)
            assert np.array_equal(w[0, : g.size], g) and not w[0, g.size:].any()
    # a replay that does not reproduce the recording fails
    bad = dict(np.load(npz))
    bad["s0_container"] = bad["s0_container"][:-1]
    np.savez(tmp_path / "bad.npz", **bad)
    with pytest.raises(SystemExit, match="differs from the recording"):
        fin.main(["replay", str(tmp_path / "bad.npz"), "--workers", "1", "--seconds", "0.1"])
