"""Port vs JAX: the cra5_api entry point, its .bin framing and the ERA5
normalization, on the CPU at vaeformer_tiny in float32.

Both packages' APIs hold the same flax weights (the JAX API's seeded init,
copied into the port by ``convert.load_flax_variables``) and read the same
synthetic timestep (keyed by ``hash(time_stamp)``, equal within one
process). float32 tiny symbols and CDF indexes are exact across the two
packages, so the .bin files must be byte-identical and each package's file
must decode in the other to the same symbols; reconstructions and latents
agree within 1e-5 (float32 towers that differ only in summation order)."""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cra5_tpu.api import bitstream as j_bitstream
from cra5_tpu.api import era5 as j_era5
from cra5_tpu.api.cra5_api import cra5_api as j_cra5_api
from cra5_tpu_torch.api import bitstream, era5
from cra5_tpu_torch.api.cra5_api import cra5_api
from cra5_tpu_torch.convert import load_flax_variables

TS = "2021-06-01T12:00:00"
ATOL = 1e-5


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def apis():
    """{coder: (jax api, port api)} sharing weights."""
    out = {}
    for coder in ("v2", "v1"):
        japi = j_cra5_api(model_version=-1, coder=coder, dtype=jnp.float32)
        api = cra5_api(model_version=-1, coder=coder, device="cpu")
        load_flax_variables(api.net, jax.device_get(japi.codec.variables))
        out[coder] = (japi, api)
    return out


# ---------------------------------------------------------------- framing
def test_bin_framing_is_byte_identical_to_jax(tmp_path):
    rng = np.random.default_rng(0)
    strings = [[rng.integers(0, 256, 1237).astype(np.uint8).tobytes()], [b""],
               rng.integers(0, 256, 77).astype(np.uint8).tobytes()]
    a, b = tmp_path / "port.bin", tmp_path / "jax.bin"
    assert bitstream.save_bin(str(a), strings, (18, 36)) == j_bitstream.save_bin(str(b), strings, (18, 36))
    assert a.read_bytes() == b.read_bytes()
    assert bitstream.load_bin(str(a)) == j_bitstream.load_bin(str(b))


@pytest.mark.parametrize("cut", ["header", "streams_declared", "length_overrun", "payload_short",
                                 "length_field_short"])
def test_truncated_bin_raises_as_jax(tmp_path, cut):
    good = struct.pack(">III", 18, 36, 2) + struct.pack(">I", 5) + b"abcde" + struct.pack(">I", 3) + b"xyz"
    data = {
        "header": good[:8],
        "streams_declared": struct.pack(">III", 18, 36, 1000) + good[12:],
        "length_overrun": struct.pack(">III", 18, 36, 1) + struct.pack(">I", 10**6) + b"abc",
        "payload_short": good[:-1],
        "length_field_short": good[:21] + b"\x00\x00",
    }[cut]
    path = tmp_path / "cut.bin"
    path.write_bytes(data)
    with pytest.raises(ValueError) as want:
        j_bitstream.load_bin(str(path))
    with pytest.raises(ValueError) as got:
        bitstream.load_bin(str(path))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="Invalid file"):
        bitstream.load_bin(str(tmp_path / "absent.bin"))


# ---------------------------------------------------------------- ERA5 stats
def test_mean_std_and_channel_mapping_equal_jax(apis):
    japi, api = apis["v2"]
    m, s = era5.load_mean_std(api.cfg)
    jm, js = j_era5.load_mean_std(japi.cfg)
    assert m.shape == (268,) and m.dtype == np.float32
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(s, js)
    assert era5.channel_vname_mapping(api.cfg) == j_era5.channel_vname_mapping(japi.cfg)
    np.testing.assert_array_equal(api.mean, japi.mean)  # the tiny model's leading 8
    x = np.random.default_rng(1).standard_normal((8, 5, 6)).astype(np.float32) * 100
    np.testing.assert_array_equal(api.normalization(x), japi.normalization(x))
    np.testing.assert_array_equal(api.de_normalization(x), japi.de_normalization(x))
    np.testing.assert_array_equal(era5.synthetic_timestep(api.cfg, 3, (4, 5)),
                                  j_era5.synthetic_timestep(japi.cfg, 3, (4, 5)))
    np.testing.assert_array_equal(api._read_or_synthesize(TS), japi._read_or_synthesize(TS))


def test_read_data_from_nc_without_xarray_raises(apis, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "xarray", None)
    with pytest.raises(RuntimeError, match="xarray"):
        apis["v2"][1].read_data_from_nc(TS)


# ---------------------------------------------------------------- .bin files
def _port_symbols(api, strings, z_shape):
    """Decode a .bin's streams with the port's coder: (z_sym, y_sym)."""
    codec, cfg = api.codec, api.model_cfg
    full_z = (1, cfg.z_channels, *z_shape)
    with torch.inference_mode():
        z_idx = codec._z_indexes(full_z)
        if codec.coder == "v1":
            z = codec._v1_decode(codec._eb_table, strings[1], z_idx)
            y = codec._v1_decode(codec._gc_table, strings[0],
                                 codec._gc_indexes(api.net.scales_from_z_symbols(z)[0]))
        else:
            z = codec._eb_coder.decode_batch_to_device(strings[1], z_idx)
            y = codec._gc_coder.decode_batch_to_device(
                strings[0], codec._gc_indexes(api.net.scales_from_z_symbols(z)[0]))
    return z.numpy(), y.numpy()


@pytest.mark.parametrize("coder", ["v2", "v1"])
def test_jax_bin_decodes_in_the_port_and_the_port_writes_the_same_bytes(apis, coder, tmp_path):
    japi, api = apis[coder]
    jres = japi.encode_era5_as_bin(TS, save_root=str(tmp_path / "jax"))
    res = api.encode_era5_as_bin(TS, save_root=str(tmp_path / "port"))
    jfile, pfile = jres["save_path"], res["save_path"]
    assert pfile.endswith(f"/CRA5/2021/{TS}.bin")
    assert open(pfile, "rb").read() == open(jfile, "rb").read()

    # the JAX file, decoded by the port: the encoder's own symbols
    x = japi.normalization(japi._read_or_synthesize(TS))[None]
    want = japi.codec._encode_symbols(japi.codec.variables, jnp.asarray(x),
                                      japi.codec._scale_table_dev)
    strings, z_shape = bitstream.load_bin(jfile)
    z, y = _port_symbols(api, strings, z_shape)
    np.testing.assert_array_equal(z, np.asarray(want["z_sym"]))
    np.testing.assert_array_equal(y, np.asarray(want["y_sym"]))

    got = api.decode_from_bin(custom_path=jfile, return_format="normalized")["x_hat"]
    ref = japi.decode_from_bin(custom_path=jfile, return_format="normalized")["x_hat"]
    assert got.shape == (1, 8, 41, 40)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL)
    full = api.decode_from_bin(custom_path=jfile)["x_hat"]
    assert isinstance(full, np.ndarray) and full.shape == (8, 41, 40)
    np.testing.assert_allclose(full, api.de_normalization(_np(got)[0]), rtol=1e-6)


@pytest.mark.parametrize("coder", ["v2", "v1"])
def test_latent_entry_points_agree_with_jax(apis, coder, tmp_path):
    japi, api = apis[coder]
    y = api.encode_to_latent(TS)
    jy = np.array(japi.encode_to_latent(TS))
    np.testing.assert_allclose(_np(y), jy, atol=ATOL)
    np.testing.assert_allclose(_np(api.encode_to_latent(TS, latent_type="quantized")),
                               np.asarray(japi.encode_to_latent(TS, latent_type="quantized")),
                               atol=ATOL)
    # one latent, fed to both: the same streams
    out, jout = api.latent_to_bin(jy), japi.latent_to_bin(jy)
    assert out["strings"] == [list(s) for s in jout["strings"]]
    assert out["z_shape"] == tuple(jout["z_shape"])
    path = tmp_path / "a.bin"
    bitstream.save_bin(str(path), [s[0] for s in out["strings"]], out["z_shape"])
    lat = api.bin_to_latent(bin_path=str(path))
    jlat = np.array(japi.bin_to_latent(bin_path=str(path)))
    assert lat.dtype == torch.float32 and lat.shape == jlat.shape
    np.testing.assert_allclose(_np(lat), jlat, atol=ATOL)
    np.testing.assert_allclose(_np(api.latent_to_reconstruction(jlat)),
                               np.asarray(japi.latent_to_reconstruction(jlat)), atol=ATOL)


def test_show_image_and_show_latent_write_their_figures(apis, tmp_path):
    _, api = apis["v2"]
    field = api._read_or_synthesize(TS)
    p1 = api.show_image(torch.from_numpy(field), TS, show_variables=("z_1000",),
                        save_path=str(tmp_path))
    p2 = api.show_latent(torch.zeros((1, 8, 4, 4)), TS, show_channels=(0, 1, 2, 3),
                         save_path=str(tmp_path))
    for p in (p1, p2):
        assert p.startswith(str(tmp_path)) and open(p, "rb").read(4) == b"\x89PNG"


def test_unknown_model_version_and_coder_raise():
    with pytest.raises(ValueError, match="model_version"):
        cra5_api(model_version=159, device="cpu")
    with pytest.raises(ValueError, match="coder"):
        cra5_api(model_version=-1, coder="v3", device="cpu")
