"""Port vs JAX: the classical-codec baseline tools (tools/bench.py,
find_close.py, ext_codecs.py, era5_jpeg2000.py, video_bench.py) on the CPU.

The PIL codecs write the same bytes in both packages (the same bpp), and
the port's metrics (its metrics.py, on the CPU here) agree with JAX's
within PSNR_ATOL dB and MSSSIM_ATOL. The external codecs run against the
mock binaries of tests/test_ext_codecs.py (no codec binary ships with the
repository); the raw YUV the port hands VTM equals JAX's byte for byte;
a missing binary exits 2 naming it. era5_jpeg2000 is numpy and PIL only,
so its JSON equals JAX's exactly.
"""

import json
import stat
from types import SimpleNamespace

import numpy as np
import pytest

from cra5_tpu.tools import bench as j_bench
from cra5_tpu.tools import era5_jpeg2000 as j_era5_jpeg2000
from cra5_tpu.tools import ext_codecs as j_ext
from cra5_tpu.tools import video_bench as j_video_bench
from cra5_tpu.tools.find_close import find_close as j_find_close
from cra5_tpu_torch.tools import bench, era5_jpeg2000, ext_codecs, find_close, video_bench

from _torch_pairs import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

PSNR_ATOL = 1e-3  # dB: float32 means in another order
MSSSIM_ATOL = 1e-5
CPU = ["--device", "cpu"]


def _write_mock(path, body: str) -> str:
    """An executable python script; body sees sys.argv."""
    path.write_text("#!/usr/bin/env python3\nimport sys, shutil, os, glob\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def _flag_value(flag):
    return f"args = sys.argv[1:]\nval = args[args.index('{flag}') + 1]\n"


@pytest.fixture
def gradient_image(tmp_path):
    from PIL import Image

    x = np.linspace(0, 255, 48, dtype=np.uint8)
    arr = np.stack(np.broadcast_arrays(x[None, :], x[:, None], x[None, :]), -1)
    p = tmp_path / "img" / "img.png"
    p.parent.mkdir()
    Image.fromarray(np.ascontiguousarray(arr)).save(p)
    return p


def _same_results(got, want, exact=("bpp",)):
    assert set(got) == set(want)
    for k in exact:
        assert got[k] == want[k], k
    for k, tol in (("psnr-rgb", PSNR_ATOL), ("ms-ssim-rgb", MSSSIM_ATOL)):
        assert np.allclose(got[k], want[k], rtol=0, atol=tol), (k, got[k], want[k])


@pytest.mark.parametrize("codec,qualities", [("jpeg", ["20", "80"]), ("webp", ["50"]),
                                             ("jpeg2000", ["10", "40"])])
def test_bench_pil_codecs_match_jax(tmp_path, capsys, codec, qualities):
    from PIL import Image

    rng = np.random.default_rng(0)
    for i, size in enumerate(((40, 56), (64, 48))):
        base = rng.integers(0, 255, (*size, 3)).astype(np.float32)
        img = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3  # some structure
        Image.fromarray(img.astype(np.uint8)).save(tmp_path / f"im{i}.png")
    assert j_bench.main([codec, str(tmp_path), "-q", *qualities]) == 0
    want = json.loads(capsys.readouterr().out)
    assert bench.main([codec, str(tmp_path), "-q", *qualities, *CPU,
                       "-o", str(tmp_path / "o.json")]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == json.loads((tmp_path / "o.json").read_text())
    assert (got["name"], got["description"]) == (want["name"], want["description"])
    _same_results(got["results"], want["results"])
    assert bench.main([codec, str(tmp_path / "none"), *CPU]) == 1


def test_bpg_identity_mock(tmp_path, gradient_image, capsys):
    """bpgenc/bpgdec mocks that copy the bytes through: a lossless
    roundtrip, the same JSON as JAX's but the times."""
    enc = _write_mock(tmp_path / "bpgenc", _flag_value("-o") + "shutil.copy(args[-1], val)\n")
    dec = _write_mock(tmp_path / "bpgdec", _flag_value("-o") + "shutil.copy(args[-1], val)\n")
    argv = ["bpg", str(gradient_image.parent), "-q", "30", "--encoder-path", enc,
            "--decoder-path", dec]
    assert bench.main(argv + CPU) == 0
    out = json.loads(capsys.readouterr().out)
    res = out["results"]
    assert out["description"] == "external (bpg)"
    assert res["bpp"][0] > 0 and res["psnr-rgb"][0] > 60
    assert res["encoding_time"][0] >= 0 and res["decoding_time"][0] >= 0
    assert j_bench.main(argv) == 0
    _same_results(res, json.loads(capsys.readouterr().out)["results"])


def test_missing_binaries_exit_2_naming_them(tmp_path, gradient_image, capsys):
    root = str(gradient_image.parent)
    assert bench.main(["bpg", root, "-q", "30", "--encoder-path", "/nonexistent/bpgenc",
                       *CPU]) == 2
    err = capsys.readouterr().err
    assert "bpgenc" in err and "unavailable" in err
    assert bench.main(["vtm", root, "-q", "30", *CPU]) == 2  # no --build-dir/--codec-config
    assert "--build-dir" in capsys.readouterr().err
    assert bench.main(["tfci", root, *CPU]) == 2
    assert find_close.main(["bpg", str(gradient_image), "0.5", "--metric", "bpp", *CPU]) == 2
    assert "bpgenc" in capsys.readouterr().err
    assert video_bench.main(["x264", root, "--frames", "2", "--encoder-path",
                             "/nonexistent/ffmpeg", *CPU]) == 2
    assert "ffmpeg" in capsys.readouterr().err


def test_yuv_conversion_is_jaxs_byte_for_byte():
    rng = np.random.default_rng(1)
    ramp = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for rgb in (rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
                np.stack([*ramp, np.full((256, 256), 128)], -1).astype(np.uint8)):
        yuv = ext_codecs._rgb_to_yuv444_u8(rgb)
        np.testing.assert_array_equal(yuv, j_ext._rgb_to_yuv444_u8(rgb))
        np.testing.assert_array_equal(ext_codecs._yuv444_u8_to_rgb(yuv),
                                      j_ext._yuv444_u8_to_rgb(yuv))


def _vtm_mocks(tmp_path, keep: str, frames: str = None):
    """A VTM build dir whose encoder copies the YUV it is given to the
    bitstream and to ``keep``, and whose decoder copies the bitstream back;
    with ``frames`` the encoder checks its -f."""
    build = tmp_path / "build"
    build.mkdir(exist_ok=True)
    check = f"assert args[args.index('-f') + 1] == '{frames}'\n" if frames else ""
    for name in ("EncoderAppStatic", "TAppEncoderStatic"):
        _write_mock(build / name, _flag_value("-i") + "out = args[args.index('-b') + 1]\n"
                    + check + f"shutil.copy(val, out)\nshutil.copy(val, {keep!r})\n")
    for name in ("DecoderAppStatic", "TAppDecoderStatic"):
        _write_mock(build / name,
                    _flag_value("-b") + "out = args[args.index('-o') + 1]\nshutil.copy(val, out)\n")
    cfg = tmp_path / "vtm.cfg"
    cfg.write_text("# mock cfg\n")
    return build, cfg


@pytest.mark.parametrize("cls", ["VTM", "HM"])
def test_vtm_and_hm_write_jaxs_yuv(tmp_path, gradient_image, cls):
    """The raw YUV each package writes for the reference encoders is the
    same file; the identity mock leaves only the YCbCr u8 roundtrip's
    error; a quality out of range is refused."""
    from PIL import Image

    kept = {}
    for pkg, mod in (("port", ext_codecs), ("jax", j_ext)):
        keep = str(tmp_path / f"{pkg}.yuv")
        build, cfg = _vtm_mocks(tmp_path, keep)
        kw = {"device": "cpu"} if pkg == "port" else {}
        codec = getattr(mod, cls)(str(build), str(cfg), **kw)
        assert codec.available()
        rv = codec.run(Image.open(gradient_image), 32)
        assert rv["bpp"] > 0 and rv["psnr-rgb"] > 40
        kept[pkg] = (open(keep, "rb").read(), rv)
    assert kept["port"][0] == kept["jax"][0]
    _same_results(kept["port"][1], kept["jax"][1])
    with pytest.raises(ValueError):
        codec.run(Image.open(gradient_image), 99)
    hm = ext_codecs.HM(str(tmp_path), str(tmp_path / "c.cfg"))
    assert hm.encoder_path.endswith("TAppEncoderStatic") and hm.quality_range == (0, 51)
    assert "--SEIDecodedPictureHash" in hm.encode_cmd("a.yuv", 30, "b.bin", 8, 8)


def test_av1_and_tfci_mocks(tmp_path, gradient_image):
    from PIL import Image

    build = tmp_path / "aom"
    build.mkdir()
    _write_mock(build / "aomenc", _flag_value("-o") + "shutil.copy(args[-1], val)\n")
    _write_mock(build / "aomdec", _flag_value("-o") + "shutil.copy(args[0], val)\n")
    rv = ext_codecs.AV1(str(build), device="cpu").run(Image.open(gradient_image), 40)
    assert rv["bpp"] > 0 and rv["psnr-rgb"] > 40
    _same_results(rv, j_ext.AV1(str(build)).run(Image.open(gradient_image), 40))
    script = tmp_path / "tfci.py"
    script.write_text("import sys, shutil\nmode = sys.argv[1]\n"
                      "if mode == 'compress': shutil.copy(sys.argv[3], sys.argv[4])\n"
                      "else: shutil.copy(sys.argv[2], sys.argv[3])\n")
    codec = ext_codecs.TFCI(str(script), device="cpu")
    rv = codec.run(Image.open(gradient_image), 4)
    assert rv["bpp"] > 0 and rv["psnr-rgb"] > 60
    with pytest.raises(ValueError):
        codec.run(Image.open(gradient_image), 9)
    with pytest.raises(ValueError):
        ext_codecs.TFCI(str(script), model="nope")
    with pytest.raises(ext_codecs.CodecUnavailable, match="tfci"):
        ext_codecs.TFCI(str(tmp_path / "missing.py"))._check()


def test_build_codecs_from_cli_args(tmp_path):
    args = SimpleNamespace(encoder_path="e", decoder_path="d", build_dir=str(tmp_path),
                           codec_config="c.cfg", tfci_script=None, tfci_model="m",
                           preset="fast", device="cpu")
    for name, cls in (("bpg", "BPG"), ("vtm", "VTM"), ("hm", "HM"), ("av1", "AV1")):
        c = ext_codecs.build_image_codec(name, args)
        assert type(c).__name__ == cls and c.device == "cpu"
        assert (c.encoder_path, c.decoder_path) == ("e", "d")
    assert ext_codecs.build_image_codec("jpeg", args) is None
    with pytest.raises(ext_codecs.CodecUnavailable):
        ext_codecs.build_image_codec("tfci", args)
    for name, cls in (("x264", "X264"), ("x265", "X265"), ("vtm", "VTMVideo"),
                      ("hm", "HMVideo")):
        c = ext_codecs.build_video_codec(name, args)
        assert type(c).__name__ == cls and c.device == "cpu"
    assert ext_codecs.build_video_codec("x265", args).preset == "fast"
    with pytest.raises(RuntimeError, match="command failed"):
        ext_codecs.run_command(["sh", "-c", "echo boom >&2; exit 3"])
    assert ext_codecs.run_command(["sh", "-c", "exit 3"], ignore_returncodes=(3,)) == ""


def _make_clip(tmp_path, n=2, size=32, name="clip0"):
    from PIL import Image

    rng = np.random.default_rng(0)
    d = tmp_path / "train" / name
    d.mkdir(parents=True)
    paths = []
    for f in range(n):
        p = d / f"f{f}.png"
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    return tmp_path, paths


# a mock ffmpeg: encode packs the input pngs into one container file,
# decode unpacks them to the rec_%05d.png pattern
_MOCK_FFMPEG = """
args = sys.argv[1:]
inp = args[args.index('-i') + 1]
if '-c:v' in args:  # encode: pack pattern -> container
    files = sorted(glob.glob(inp.replace('%05d', '*')))
    out = args[-1]
    with open(out, 'wb') as fh:
        for f in files:
            data = open(f, 'rb').read()
            fh.write(len(data).to_bytes(8, 'big') + data)
else:  # decode: unpack container -> pattern
    pattern = args[-1]
    blob = open(inp, 'rb').read()
    i, idx = 0, 1
    while i < len(blob):
        n = int.from_bytes(blob[i:i+8], 'big'); i += 8
        open(pattern % idx, 'wb').write(blob[i:i+n]); i += n; idx += 1
"""


def test_x265_mock_ffmpeg(tmp_path, capsys):
    root, _ = _make_clip(tmp_path)
    ffmpeg = _write_mock(tmp_path / "ffmpeg", _MOCK_FFMPEG)
    argv = ["x265", str(root), "--frames", "2", "-q", "30", "--encoder-path", ffmpeg]
    assert video_bench.main(argv + CPU) == 0
    out = json.loads(capsys.readouterr().out)
    assert (out["name"], out["description"]) == ("x265", "external")
    assert out["results"]["bpp"][0] > 0 and out["results"]["psnr-rgb"][0] > 60
    assert j_video_bench.main(argv) == 0
    _same_results(out["results"], json.loads(capsys.readouterr().out)["results"])


def test_vtm_video_multiframe_identity(tmp_path):
    _, paths = _make_clip(tmp_path, n=3)
    build, cfg = _vtm_mocks(tmp_path, str(tmp_path / "kept.yuv"), frames="3")
    rv = ext_codecs.VTMVideo(str(build), str(cfg), device="cpu").run_clip(
        [str(p) for p in paths], 32)
    assert rv["bpp"] > 0 and rv["psnr-rgb"] > 40
    port_yuv = (tmp_path / "kept.yuv").read_bytes()
    want = j_ext.VTMVideo(str(build), str(cfg)).run_clip([str(p) for p in paths], 32)
    assert (tmp_path / "kept.yuv").read_bytes() == port_yuv
    _same_results(rv, want)


def test_video_bench_pil_matches_jax(tmp_path, capsys):
    root, _ = _make_clip(tmp_path, n=3)
    _make_clip(tmp_path, n=3, name="clip1")
    argv = ["jpeg", str(root), "-q", "30", "70"]
    assert video_bench.main(argv + CPU) == 0
    got = json.loads(capsys.readouterr().out)
    assert j_video_bench.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert (got["name"], got["description"]) == ("jpeg-intra", "all-intra PIL")
    assert len(got["results"]["bpp"]) == 2
    _same_results(got["results"], want["results"])
    (root / "valid").mkdir()
    assert video_bench.main(["jpeg", str(root), "--split", "valid", *CPU]) == 1


def test_find_close_matches_jax(gradient_image, capsys):
    from PIL import Image

    img = Image.open(gradient_image)
    q_low, v_low, _ = find_close.find_close("jpeg", img, 30.0, "psnr-rgb", device="cpu")
    q_high, v_high, _ = find_close.find_close("jpeg", img, 45.0, "psnr-rgb", device="cpu")
    assert q_high > q_low and abs(v_high - 45.0) < abs(v_low - 45.0)
    got = find_close.find_close("jpeg2000", img, 1.0, "bpp", device="cpu")
    want = j_find_close("jpeg2000", img, 1.0, "bpp")
    assert got[0] == want[0] and got[2]["bpp"] == want[2]["bpp"]
    assert find_close.main(["jpeg", str(gradient_image), "35", "--metric", "psnr-rgb",
                            *CPU]) == 0
    out = capsys.readouterr().out
    assert "jpeg quality=" in out and "psnr-rgb=" in out


def _write_sh(path, body: str) -> str:
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_find_close_bisects_an_external_qp_range(tmp_path, gradient_image, capsys):
    """A mock bpg whose output shrinks as -q grows, like a real QP (shell
    mocks: a Python start a bisection step is slow on a loaded host)."""
    from PIL import Image

    Image.fromarray(np.zeros((48, 48, 3), np.uint8)).save(tmp_path / "black.png")
    # bpgenc -o OUT -q Q ... IN: keep max(64, size * (52 - Q) / 52) bytes of IN
    enc = _write_sh(tmp_path / "bpgenc", 'out=$2; q=$4; for a; do in=$a; done\n'
                    'n=$(( $(wc -c < "$in") * (52 - q) / 52 )); [ $n -lt 64 ] && n=64\n'
                    'head -c $n "$in" > "$out"\n')
    dec = _write_sh(tmp_path / "bpgdec", f'cp {tmp_path / "black.png"} "$2"\n')
    assert find_close.main(["bpg", str(gradient_image), "0.5", "--metric", "bpp",
                            "--encoder-path", enc, "--decoder-path", dec, *CPU]) == 0
    assert "bpg quality=" in capsys.readouterr().out


def test_era5_jpeg2000_equals_jax(tmp_path, capsys):
    rng = np.random.default_rng(0)
    xx, yy = np.meshgrid(np.linspace(0, 4, 96), np.linspace(0, 4, 64))
    data = np.stack([np.sin(xx * (c + 1)) * np.cos(yy) + 0.05 * rng.normal(size=xx.shape)
                     for c in range(3)]).astype(np.float32)
    path = tmp_path / "ts.npy"
    np.save(path, data[None])  # (1, C, H, W) takes the first sample
    assert era5_jpeg2000.main([str(path), "-q", "5", "80", "-o", str(tmp_path / "o.json")]) == 0
    got = capsys.readouterr().out
    assert j_era5_jpeg2000.main([str(path), "-q", "5", "80"]) == 0
    assert got == capsys.readouterr().out
    res = json.loads(got)["results"]
    assert res["bpsp"][1] < res["bpsp"][0] and res["mse"][1] >= res["mse"][0]
    assert json.loads((tmp_path / "o.json").read_text()) == json.loads(got)
    stream, shift, scale = era5_jpeg2000.compress_channel(data[0], 5.0)
    assert (stream, shift, scale) == j_era5_jpeg2000.compress_channel(data[0], 5.0)
    rec = era5_jpeg2000.decompress_channel(stream, shift, scale)
    assert float(np.mean((rec - data[0]) ** 2)) < float(np.var(data[0]))
