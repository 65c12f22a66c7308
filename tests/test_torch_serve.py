"""Port vs JAX: ``tools/serve.py``, the decoder-only serving loop, on the
CPU at vaeformer_tiny in float32.

The ``.bin`` files are written by the port's ``cra5_api(weights=tiny.pth)``
(test_torch_convert_torch.tiny_pth: trained-style tables, a 48-level scale
table) for three timesteps; ``serve.main(..., "--checkpoint", tiny.pth,
"--device", "cpu")`` decodes them. Each ``.npy`` must equal the API's
``decode_from_bin`` of the same file bitwise, normalized and with
``--denormalize``; 1 and 4 threads give the same bytes; and the field
agrees within ATOL (the tolerance of test_torch_api.py) with the JAX
package's ``VAEformerCodec.decompress`` of the same file, its codec given
the file's scale table and tables (JAX's ``serve.main`` is a slow test of
its own package). ``recompress`` installs the .pth's tables too: from the
same normalized field it writes the bytes ``cra5_api`` wrote."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from cra5_tpu.api.bitstream import load_bin as j_load_bin
from cra5_tpu.models.vaeformer import VAEformer as JVAEformer
from cra5_tpu.models.vaeformer import VAEformerCodec as JCodec
from cra5_tpu.models.vaeformer import vaeformer_tiny as j_tiny
from cra5_tpu.tools import convert_torch as jct
from cra5_tpu_torch.api.cra5_api import cra5_api
from cra5_tpu_torch.tools import recompress, serve
from test_torch_convert_torch import tiny_pth

ATOL = 1e-5
STAMPS = ("2021-06-01T00:00:00", "2021-06-01T06:00:00", "2021-06-01T12:00:00")
KEYS = {"decoded", "seconds", "decodes_per_sec", "threads", "kernel_fallbacks"}


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    path, _, _ = tiny_pth(root / "tiny.pth")
    api = cra5_api(model_version=-1, weights=path, device="cpu")
    for ts in STAMPS:
        api.encode_era5_as_bin(ts, save_root=str(root))
    return path, root / "CRA5" / "2021", api


def _serve(archive, out, *flags, capsys):
    path, bins, _ = archive
    assert serve.main([str(bins), "-o", str(out), "--checkpoint", path, "--device", "cpu",
                       *flags]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == KEYS and line["decoded"] == len(STAMPS)
    assert line["kernel_fallbacks"] == []
    return {ts: np.load(out / f"{ts}.npy") for ts in STAMPS}


@pytest.mark.parametrize("denormalize", [False, True])
def test_serve_equals_the_api_decode_bitwise(archive, tmp_path, capsys, denormalize):
    _, bins, api = archive
    got = _serve(archive, tmp_path, "--threads", "4",
                 *(["--denormalize"] if denormalize else []), capsys=capsys)
    for ts in STAMPS:
        if denormalize:
            want = api.decode_from_bin(custom_path=str(bins / f"{ts}.bin"))["x_hat"]
        else:
            want = api.decode_from_bin(custom_path=str(bins / f"{ts}.bin"),
                                       return_format="normalized")["x_hat"][0].numpy()
        assert got[ts].dtype == np.float32 and got[ts].shape == want.shape
        assert np.array_equal(got[ts], want), ts


def test_one_and_four_threads_give_the_same_bytes(archive, tmp_path, capsys):
    one = _serve(archive, tmp_path / "one", "--threads", "1", capsys=capsys)
    four = _serve(archive, tmp_path / "four", "--threads", "4", capsys=capsys)
    for ts in STAMPS:
        assert np.array_equal(one[ts], four[ts]), ts


def test_serve_agrees_with_the_jax_decode(archive, tmp_path, capsys):
    path, bins, _ = archive
    got = _serve(archive, tmp_path, capsys=capsys)
    variables = jct.convert_checkpoint(path)
    tables = variables.pop("_cdf_tables")
    jcodec = JCodec(JVAEformer(j_tiny(), dtype=jnp.float32), variables,
                    scale_table=tables["scale_table"])
    jcodec.set_tables(tables["eb"], tables["gc"])
    for ts in STAMPS:
        strings, shape = j_load_bin(str(bins / f"{ts}.bin"))
        want = np.asarray(jcodec.decompress(strings, shape)["x_hat"])[0]
        np.testing.assert_allclose(got[ts], want, atol=ATOL, rtol=0)


def test_recompress_from_the_pth_writes_the_api_bytes(archive, tmp_path):
    path, bins, api = archive
    codec = recompress.build_codec("tiny", path, "cpu")
    assert np.array_equal(codec.scale_table, api.codec.scale_table)
    assert np.array_equal(codec._gc_table.quantized_cdf, api.codec._gc_table.quantized_cdf)
    x = np.stack([api.normalization(api._read_or_synthesize(ts)) for ts in STAMPS])
    names = [f"{ts}.npy" for ts in STAMPS]
    for got in recompress.write_bins(str(tmp_path), names, recompress.recompress_batch(
            codec, None, x)):
        with open(got, "rb") as a, open(bins / os.path.basename(got), "rb") as b:
            assert a.read() == b.read(), got


def test_serve_without_bins_exits_1(tmp_path, capsys):
    assert serve.main([str(tmp_path), "-o", str(tmp_path / "out"), "--device", "cpu"]) == 1
    assert "no .bin" in capsys.readouterr().err
