"""The port stands alone: it imports without JAX, its entry points default
to the card and never fall back to the CPU, and chip_smoke.py gives no
result without a card. This file imports no JAX."""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from cra5_tpu_torch import kernels
from cra5_tpu_torch.coder.lane_coder import LaneCoder
from cra5_tpu_torch.entropy import gc_update, get_scale_table
from cra5_tpu_torch.models.vaeformer import VAEformer, vaeformer_268, vaeformer_tiny
from cra5_tpu_torch.nn.blocks import _use_flash
from cra5_tpu_torch.nn.vit import _win_for_block
from cra5_tpu_torch.ops import attention
from cra5_tpu_torch.ops.attention import flash_attention_forward

ROOT = Path(__file__).resolve().parents[1]
NO_CARD = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}


def test_every_module_imports_with_jax_blocked():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "optax", "msgpack", "cra5_tpu"):
            sys.modules[name] = None  # any import of these now raises
        import cra5_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(cra5_tpu_torch.__path__, "cra5_tpu_torch.")]
        for m in mods:
            importlib.import_module(m)
        import chip_smoke
        print(" ".join(mods))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=NO_CARD,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    mods = set(r.stdout.split())
    assert len(mods) >= 15
    assert {f"cra5_tpu_torch.{m}" for m in (
        "bench", "tools.train", "train.calibrate", "data.era5", "data.prefetch", "utils.config",
        "utils.registry", "registry", "api.downloader", "api.configs.train_era5_base",
        "utils.msgpack", "parallel", "parallel.mesh", "parallel.distributed", "parallel.sharding",
        "parallel.tensor_parallel", "ops.ring_attention", "tools.recompress", "train.checkpoints", "nn.conv", "nn.gdn",
        "models.google", "models.waseda", "models.latent_codecs", "models.codec", "models.zoo",
        "tools.eval_model", "tools.convert_torch", "tools.serve", "tools.decode_profile",
        "tools.era5_eval", "tools.forecast_eval", "tools.update_model", "utils.profiling",
        "ops.rdoq", "models.baseline", "models.vit_vae", "tools.plot", "tools.vivt69_experiment",
        "tools.finalize_scaling", "data.image", "data.transforms", "nn.swin", "models.elic2022",
        "models.stf2022", "models.tcm2023", "models.inv2021", "models.video",
        "tools.video_eval", "tools.video_bench", "tools.bench", "tools.find_close",
        "tools.ext_codecs", "tools.era5_jpeg2000", "standalone", "standalone.export")} <= mods


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_gives_no_result_without_a_card(tmp_path, alone):
    """Without a card (and, alone in a directory, without the package)
    the script exits non-zero and prints no ok line."""
    script = ROOT / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    r = subprocess.run([sys.executable, str(script)], cwd=script.parent, env=NO_CARD,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = gc_update(get_scale_table())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VAEformer(vaeformer_tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LaneCoder(table)
    assert VAEformer(vaeformer_tiny(), device="cpu").device.type == "cpu"
    assert LaneCoder(table, device="cpu").device.type == "cpu"


def test_zoo_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """The zoo's models, load_model and eval_model resolve their device as
    every entry point does: the card unless the caller asks for the CPU."""
    from cra5_tpu_torch.models import MeanScaleHyperprior, create_model, load_model
    from cra5_tpu_torch.tools import eval_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MeanScaleHyperprior(N=8, M=12)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model("bmshj2018-factorized", 1)
    np.save(tmp_path / "x.npy", np.zeros((3, 64, 64), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_model.main([str(tmp_path), "-a", "bmshj2018-factorized"])
    assert create_model("mbt2018-mean", 1, device="cpu").device.type == "cpu"


def test_distributed_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """recompress and a world's join resolve their device as every entry
    point does: the card unless the caller asks for the CPU."""
    from cra5_tpu_torch.parallel import init_distributed
    from cra5_tpu_torch.tools import recompress

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        recompress.main([str(tmp_path), "-o", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed(coordinator="127.0.0.1:1", num_processes=2, process_id=0)


def test_serving_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """serve, decode_profile and the evaluation tools resolve their device
    as every entry point does: the card unless the caller asks for the CPU."""
    from cra5_tpu_torch.tools import decode_profile, era5_eval, forecast_eval, serve, update_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main([str(tmp_path), "-o", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode_profile.main(["--model", "tiny"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        forecast_eval.main([str(tmp_path), "--years", "2020-01-01", "2020-01-02"])
    f = np.zeros((2, 3, 4), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        era5_eval.evaluate_fields(f, f)
    np.save(tmp_path / "f.npy", f)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        era5_eval.main([str(tmp_path / "f.npy"), str(tmp_path / "f.npy")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        update_model.main([str(tmp_path / "x.pt"), "-a", "bmshj2018-factorized"])
    assert era5_eval.evaluate_fields(f, f, device="cpu")["mse"] == 0.0


def test_variant_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """The VAEformer variants, the vivt69 experiment and finalize_scaling's
    record resolve their device as every entry point does."""
    from cra5_tpu_torch.models import (VariationCNNPrior, VITAutoencoderKL,
                                       vaeformer_former_baseline_tiny)
    from cra5_tpu_torch.tools import finalize_scaling, vivt69_experiment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda **k: VariationCNNPrior(vaeformer_tiny(), **k),
                  lambda **k: VariationCNNPrior(vaeformer_tiny(), variational=False, **k),
                  lambda **k: VAEformer(vaeformer_former_baseline_tiny(), **k),
                  lambda **k: VITAutoencoderKL(vaeformer_tiny(), **k)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
        assert build(device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vivt69_experiment.main(["--pilot", "--steps", "1", "--geometry", "41", "40",
                                "-o", str(tmp_path / "rd.json")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vivt69_experiment.make_device_sampler(np.ones((2, 1), np.float32), 8, 8, 0.1, 3.0, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        finalize_scaling.main(["record", "-o", str(tmp_path / "f.npz"), "--model", "tiny"])


def test_kernel_wrappers_take_no_other_route():
    """A tensor neither on the CPU nor on the card is refused, not
    computed some other way."""
    q = torch.empty((1, 1, 8, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_forward(q, q, q)


def test_flash_routing_selects_the_seven_global_blocks_of_268v():
    """Every attention of the 268v roundtrip, as (tokens, batch*heads):
    on the card exactly the 4 global blocks of g_a and the 3 of g_s take
    the flash kernel; windows and the hyperprior stay plain."""
    cfg = vaeformer_268()
    Hp, Wp = cfg.latent_grid
    n_seq, cuda, cpu = cfg.depth // 2, torch.device("cuda"), torch.device("cpu")
    blocks = [min(i, n_seq - 1) for i in range(n_seq + 1)]  # g_a, dual final pair
    blocks += [cfg.depth // 2 + j for j in range(cfg.depth - cfg.depth // 2)]  # g_s
    flash = 0
    for i in blocks:
        win = _win_for_block(i, True, cfg.interval, cfg.window_sizes)
        if win is None:
            n, bh = Hp * Wp, cfg.num_heads
        else:
            nw = -(-Hp // win[0]) * -(-Wp // win[1])
            n, bh = win[0] * win[1], nw * cfg.num_heads
        flash += _use_flash(n, bh, cuda)
        assert not _use_flash(n, bh, cpu)
    hz = cfg.hyper_grid[0] * cfg.hyper_grid[1]
    assert not _use_flash(hz, cfg.hyper_num_heads, cuda)
    assert flash == 7


FWD, DQ, DKV = "cra5_flash_attn_fwd", "cra5_flash_attn_bwd_dq", "cra5_flash_attn_bwd_dkv"


@pytest.mark.parametrize("head_dim,dtype,kernel,entry,code", [
    (64, torch.bfloat16, FWD, FWD, None),
    (64, torch.float32, FWD, FWD + "_f32", None),
    (72, torch.float32, FWD, FWD + "_anydim", 2),
    (72, torch.bfloat16, FWD, FWD + "_anydim", 0),
    (72, torch.float16, FWD, FWD + "_anydim", 1),
    (64, torch.float16, FWD, FWD + "_anydim", 1),
    (72, torch.bfloat16, DKV, DKV + "_anydim", 0),
    (72, torch.float16, DKV, DKV + "_anydim", 1),
    (72, torch.float32, DKV, DKV + "_anydim", 2),
    (64, torch.float16, DKV, DKV + "_anydim", 1),
    (128, torch.bfloat16, DKV, DKV + "_anydim", 0),
    (96, torch.float32, FWD, FWD + "_anydim", 2),
    (64, torch.float32, DKV, DKV + "_f32", None),
    (6, torch.bfloat16, FWD, FWD + "_any", 0),
    (6, torch.bfloat16, DKV, DKV + "_any", 0),
    (72, torch.float64, FWD, FWD + "_any", 3),
    (72, torch.float64, DKV, DKV + "_any", 3),
    (100, torch.float32, FWD, FWD + "_any", 2),
    (100, torch.float32, DKV, DKV + "_any", 2),
    (136, torch.bfloat16, FWD, FWD + "_any", 0),
    (72, torch.float32, DQ, DQ + "_anydim", 2),
    (72, torch.bfloat16, DQ, DQ + "_anydim", 0),
    (64, torch.float16, DQ, DQ + "_anydim", 1),
    (128, torch.bfloat16, DQ, DQ + "_anydim", 0),
    (96, torch.float32, DQ, DQ + "_anydim", 2),
    (100, torch.float32, DQ, DQ + "_any", 2),
    (136, torch.bfloat16, DQ, DQ + "_any", 0),
    (6, torch.bfloat16, DQ, DQ + "_any", 0),
    (3, torch.float32, DQ, DQ + "_any", 2),
    (72, torch.float64, DQ, DQ + "_any", 3),
    (64, torch.float32, DQ, DQ + "_f32", None),
    (256, torch.float64, FWD, FWD + "_any", 3),
    (320, torch.bfloat16, FWD, FWD + "_any", 0),
])
def test_flash_route_takes_every_head_dim_and_dtype_to_a_kernel(monkeypatch, head_dim, dtype,
                                                                kernel, entry, code):
    """At N = 4096 on the card attention takes the flash route whatever its
    head dim and dtype, as the JAX package's takes its Pallas kernels; the
    route picks by dtype and shape alone: the head-dim-64 tensor-core
    kernels in bf16 and float32, the any-head-dim tensor-core K4, K5 and K6
    where anydim_supports (16-bit rows of a multiple of 8 up to 128,
    float32 rows of a multiple of 4 up to 96), and the SIMT kernels for
    everything else (float64, 12-byte rows, head dims past the reach, up to
    and past 256, which the SIMT kernels walk in 256-column chunks), the
    last two told the dtype's code. The library is replaced by a recorder,
    so no card and no build is needed."""
    assert _use_flash(4096, 16, torch.device("cuda"))
    assert not _use_flash(4096, 16, torch.device("cpu"))
    calls = []

    class Recorder:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(kernels, "lib", Recorder)
    q = torch.zeros((1, 2, 8, head_dim), dtype=dtype)
    assert attention._kernel_entry(kernel, q, q, q)(1, 0.5, "stream") == 0
    want = (1, 0.5, "stream") if code is None else (1, 0.5, code, "stream")
    assert calls == [(entry, want)]
    if entry.endswith(("_anydim", "_any")):
        assert attention.anydim_supports(dtype, head_dim) == entry.endswith("_anydim")


@pytest.mark.parametrize("head_dim,dtype", [(64, torch.int16), (0, torch.bfloat16),
                                            (64, torch.int32), (64, torch.complex64)])
def test_flash_kernels_raise_for_what_none_computes(monkeypatch, head_dim, dtype):
    """No kernel takes a head dim of 0 or a dtype that is not a float: the
    entry raises before any build, and never hands such operands to a
    plain version."""
    monkeypatch.setattr(kernels, "lib", lambda: pytest.fail("built a library"))
    q = torch.zeros((1, 1, 4, head_dim), dtype=dtype)
    assert not attention.flash_supports(dtype, head_dim)
    with pytest.raises(NotImplementedError, match="head dim of at least 1"):
        attention._kernel_entry("cra5_flash_attn_fwd", q, q, q)


def test_video_and_baseline_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """ScaleSpaceFlow, ssf2020, video_eval and the baseline tools resolve
    their device as every entry point does: the card unless the caller asks
    for the CPU (the baseline tools compute their metrics there)."""
    from cra5_tpu_torch.models import ScaleSpaceFlow, ssf2020
    from cra5_tpu_torch.tools import bench, find_close, video_bench, video_eval

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: ScaleSpaceFlow(planes=8, mid_planes=8),
                  lambda: ssf2020(1, planes=8, mid_planes=8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    (tmp_path / "train" / "c").mkdir(parents=True)
    img = tmp_path / "x.png"
    img.write_bytes(b"")
    for run in (lambda: video_eval.main([str(tmp_path)]),
                lambda: bench.main(["jpeg", str(tmp_path)]),
                lambda: find_close.main(["jpeg", str(img), "30"]),
                lambda: video_bench.main(["jpeg", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()


def test_video_and_standalone_paths_read_nothing_of_the_jax_package(tmp_path):
    """With the JAX package blocked, video_eval on a PNG clip, the baseline
    bench, era5_jpeg2000 and the standalone codec's build and export open
    no file under cra5_tpu/ (an audit hook records every open)."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax", "msgpack", "cra5_tpu"):
            sys.modules[name] = None
        opened = []
        sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                         if ev == "open" and args and isinstance(args[0], str) else None)
        import numpy as np
        from PIL import Image
        from cra5_tpu_torch.standalone import export
        from cra5_tpu_torch.models import load_model
        from cra5_tpu_torch.tools import bench, era5_jpeg2000, video_eval
        root = {str(tmp_path)!r}
        import os
        os.makedirs(root + "/train/c0")
        rng = np.random.default_rng(0)
        for f in range(2):
            Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
                root + f"/train/c0/{{f}}.png")
        assert video_eval.main([root, "--frames", "2", "--planes", "8", "--mid-planes", "8",
                                "--num-levels", "2", "--device", "cpu"]) == 0
        assert bench.main(["jpeg", root, "-q", "50", "--device", "cpu"]) == 0
        np.save(root + "/f.npy", rng.normal(size=(2, 32, 32)).astype(np.float32))
        assert era5_jpeg2000.main([root + "/f.npy", "-q", "10"]) == 0
        assert "cra5_tpu_torch" in str(export._SRC) and export._SRC.exists()
        model, codec = load_model("bmshj2018-factorized", 1, device="cpu")
        export.export_synthesis(root + "/g_s.crs", model.g_s)
        export.export_codec(codec, root + "/art", params=model)
        bad = [p for p in opened if "/cra5_tpu/" in p.replace(os.sep, "/")]
        print("BAD", bad)
        assert not bad, bad
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=NO_CARD,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
