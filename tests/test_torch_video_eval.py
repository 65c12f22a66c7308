"""Port vs JAX: tools/video_eval.py and zoo.ssf2020 with a JAX-written
.msgpack, on the CPU.

One clip of three seeded 64 x 64 PNG frames (padded to 128 x 128), the
smallest geometry the codec takes (planes = mid = 8, two levels), one set
of weights written as the JAX package's .msgpack variables: the port's
``video_eval.main --device cpu`` writes as many bytes as JAX's
``video_eval.main`` (the same bpp), and its PSNR and MS-SSIM agree within
PSNR_ATOL dB and MSSSIM_ATOL (the towers agree to float32 summation order).
"""

import json

import numpy as np
import pytest
import torch
from flax import serialization

from cra5_tpu.models import video as J
from cra5_tpu.tools import video_eval as j_video_eval
from cra5_tpu_torch.models import ssf2020
from cra5_tpu_torch.models import video as P
from cra5_tpu_torch.tools import video_eval

from _torch_pairs import one_thread, pair  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

PSNR_ATOL = 1e-3  # dB
MSSSIM_ATOL = 1e-5
SSF = dict(num_levels=2, mid_planes=8, planes=8)
ARGS = ["--frames", "3", "--planes", "8", "--mid-planes", "8", "--num-levels", "2"]


@pytest.fixture(scope="module")
def clip_and_ckpt(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("video")
    d = root / "train" / "clip0"
    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (64, 64, 3))
    for f in range(3):  # a drifting texture, so motion and residual both code
        frame = np.roll(base, 2 * f, axis=1) + rng.integers(-8, 8, (64, 64, 3))
        Image.fromarray(np.clip(frame, 0, 255).astype(np.uint8)).save(d / f"f{f}.png")

    def tweak(m):
        for enc in (m.img_encoder, m.res_encoder, m.motion_encoder):
            enc.l6.conv.weight.mul_(6.0)
        g = torch.Generator().manual_seed(5)
        for hp in (m.img_hyperprior, m.res_hyperprior, m.motion_hyperprior):
            hp.hyper_decoder_scale.d3.conv.bias.uniform_(0.0, 6.0, generator=g)

    _, v, pm = pair(lambda: J.ScaleSpaceFlow(**SSF),
                    lambda: P.ScaleSpaceFlow(**SSF, device="cpu"), (3, 1, 3, 128, 128),
                    seed=2, tweak=tweak)
    ckpt = root / "ssf.msgpack"
    ckpt.write_bytes(serialization.to_bytes(v))
    return root, ckpt, pm


def test_video_eval_matches_jax_on_a_msgpack(clip_and_ckpt, capsys):
    root, ckpt, _ = clip_and_ckpt
    assert j_video_eval.main([str(root), *ARGS, "--checkpoint", str(ckpt)]) == 0
    want = json.loads(capsys.readouterr().out)["results"]
    assert video_eval.main([str(root), *ARGS, "--checkpoint", str(ckpt), "--device", "cpu",
                            "-o", str(root / "out.json")]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == json.loads((root / "out.json").read_text())
    assert got["name"] == "ssf2020" and set(got["results"]) == set(want)
    got = got["results"]
    assert got["bpp"] == want["bpp"] and got["bpp"][0] > 0
    assert abs(got["psnr-rgb"][0] - want["psnr-rgb"][0]) <= PSNR_ATOL
    assert abs(got["ms-ssim-rgb"][0] - want["ms-ssim-rgb"][0]) <= MSSSIM_ATOL
    assert got["encoding_time"][0] > 0 and got["decoding_time"][0] > 0


def test_video_eval_seeded_init_and_an_empty_split(clip_and_ckpt, capsys):
    root, _, _ = clip_and_ckpt
    assert video_eval.main([str(root), *ARGS, "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out)["results"]
    assert all(np.isfinite(v[0]) for v in res.values()) and res["bpp"][0] > 0
    (root / "valid").mkdir(exist_ok=True)
    assert video_eval.main([str(root), *ARGS, "--split", "valid", "--device", "cpu"]) == 1


def test_pad_frames_is_jaxs():
    x = np.random.default_rng(0).random((2, 3, 100, 130)).astype(np.float32)
    got, hw = video_eval._pad_frames(x)
    want, jhw = j_video_eval._pad_frames(x)
    assert hw == jhw == (100, 130) and got.shape == (2, 3, 128, 256)
    np.testing.assert_array_equal(got, want)


def test_ssf2020_loads_the_msgpack(clip_and_ckpt):
    """ssf2020(pretrained=True) reads the JAX variables into the port's
    model; the seeded build is the init's, repeatable by seed."""
    _, ckpt, pm = clip_and_ckpt
    model, state, codec = ssf2020(3, "ms-ssim", pretrained=True, checkpoint_path=str(ckpt),
                                  device="cpu", **SSF)
    assert isinstance(codec, P.ScaleSpaceFlowCodec) and codec.model is model
    for name, p in pm.named_parameters():
        assert torch.equal(model.get_parameter(name), p), name
    assert set(state) == set(model.state_dict())
    a, _, _ = ssf2020(1, device="cpu", seed=4, **SSF)
    b, _, _ = ssf2020(1, device="cpu", seed=4, **SSF)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
