"""Port vs JAX: tools/eval_model.py on the CPU (--device cpu), on .npy and
PNG inputs, both given the same flax variables through --checkpoint (a
.msgpack written by flax's serializer). The JSON has the JAX CLI's keys;
where the two models' symbols are equal (checked) the bpp is equal, and
the distortion metrics agree within float32 summation order."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import cra5_tpu.models as J
from cra5_tpu.tools import eval_model as j_eval
from cra5_tpu_torch.models import load_model
from cra5_tpu_torch.tools import eval_model as p_eval

ARCH, Q = "mbt2018-mean", 1  # 128 / 192 channels: the zoo's full width at q1


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Two seeded .npy images (3 x 64 x 64 in [0, 1]), one 48 x 80 PNG (padded
    to 64 x 128), and the flax variables of the model as a .msgpack."""
    from PIL import Image

    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(0)
    (root / "npy").mkdir()
    for i in range(2):
        np.save(root / "npy" / f"img{i}.npy", rng.random((3, 64, 64)).astype(np.float32))
    (root / "png").mkdir()
    Image.fromarray(rng.integers(0, 256, (48, 80, 3), dtype=np.uint8)).save(root / "png" / "a.png")
    jm = J.create_model(ARCH, Q)
    v = jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 3, 64, 64))))
    ckpt = root / f"{ARCH}-{Q}.msgpack"
    ckpt.write_bytes(serialization.to_bytes(v))
    return root, ckpt, jm, v


def _run(main, folder, ckpt, out, *extra):
    rc = main([str(folder), "-a", ARCH, "-q", str(Q), "--checkpoint", str(ckpt), "-o", str(out),
               *extra])
    assert rc == 0
    return json.loads(out.read_text())


def _symbols_equal(folder, jm, v, ckpt, min_div=64):
    model, _ = load_model(ARCH, Q, pretrained=True, checkpoint_path=str(ckpt), device="cpu")
    for f in p_eval.collect_files(str(folder)):
        xp, _ = p_eval._pad(p_eval.read_input(f)[None], min_div)
        want = jm.apply(v, jnp.asarray(xp), method=type(jm).encode_symbols)
        with torch.no_grad():
            got = model.encode_symbols(torch.from_numpy(xp))
        for k in ("y_sym", "z_sym"):
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), (f, k)


@pytest.mark.parametrize("folder,coder", [("npy", "v2"), ("npy", "v1"), ("png", "v2")])
def test_eval_model_matches_the_jax_cli(inputs, tmp_path, folder, coder):
    root, ckpt, jm, v = inputs
    _symbols_equal(root / folder, jm, v, ckpt)
    got = _run(p_eval.main, root / folder, ckpt, tmp_path / "port.json", "--entropy-coder",
               coder, "--device", "cpu", "--per-image", str(tmp_path / "per"))
    want = _run(j_eval.main, root / folder, ckpt, tmp_path / "jax.json", "--entropy-coder", coder)
    assert got.keys() == want.keys() and got["results"].keys() == want["results"].keys()
    assert got["name"] == ARCH and got["description"] == want["description"]
    assert got["results"]["bpp"] == want["results"]["bpp"]
    for k in set(want["results"]) - {"bpp", "encoding_time", "decoding_time"}:
        assert math.isclose(got["results"][k][0], want["results"][k][0], rel_tol=1e-4), k
    per = sorted(p.name for p in (tmp_path / "per").iterdir())
    assert len(per) == len(p_eval.collect_files(str(root / folder)))
    assert json.loads((tmp_path / "per" / per[0]).read_text())["results"].keys() == \
        got["results"].keys()


def test_entropy_estimation_matches_the_jax_cli(inputs, tmp_path):
    root, ckpt, _, _ = inputs
    extra = ("--entropy-estimation",)
    got = _run(p_eval.main, root / "npy", ckpt, tmp_path / "port.json", *extra, "--device", "cpu")
    want = _run(j_eval.main, root / "npy", ckpt, tmp_path / "jax.json", *extra)
    assert got["description"] == want["description"] == "Inference (entropy-estimation)"
    assert got["results"].keys() == want["results"].keys()
    for k in ("bpp", "mse", "psnr"):
        assert math.isclose(got["results"][k][0], want["results"][k][0], rel_tol=1e-4), k


def test_eval_model_reads_npy_without_pil_and_reports_an_empty_folder(tmp_path, monkeypatch, capsys):
    import builtins

    real = builtins.__import__
    monkeypatch.setattr(builtins, "__import__", lambda name, *a, **k: (_ for _ in ()).throw(
        ImportError("no PIL")) if name == "PIL" else real(name, *a, **k))
    np.save(tmp_path / "flat.npy", np.ones((6, 5), np.float32))
    assert p_eval.read_input(tmp_path / "flat.npy").shape == (1, 6, 5)
    (tmp_path / "empty").mkdir()
    assert p_eval.main([str(tmp_path / "empty"), "-a", ARCH, "--device", "cpu"]) == 1
    assert "no inputs" in capsys.readouterr().err
