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
from cra5_tpu_torch import convert
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
        z_idx = codec._channel_indexes(full_z)
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


# ---------------------------------------------------------------- reference .pth weights
# A tiny reference .pth (test_torch_convert_torch.tiny_pth) carries trained
# CDF tables: its EB params' own table and a GC table built from a 48-level
# scale table, other than get_scale_table()'s default, so that the install
# shows in the y stream. The JAX package's cra5_api sets codec.scale_table
# after its codec copied the default table to the device for its index
# builder, so it codes the file's GC rows under the default table's indexes;
# the port builds the indexes from the file's table, as the reference's
# GaussianConditional does from its loaded buffer (ROADMAP C8). With the
# default table, the published checkpoint's, the two give the same bytes
# as they stand; with the 48-level one the JAX instance's index table is
# set to its own scale_table first.
@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    from cra5_tpu.entropy import get_scale_table as j_get_scale_table
    from test_torch_convert_torch import tiny_pth

    root = tmp_path_factory.mktemp("pth")
    return {"st48": tiny_pth(root / "st48.pth"),
            "default": tiny_pth(root / "default.pth", scale_table=j_get_scale_table())}


def test_pth_weights_install_the_files_tables(pth):
    from test_torch_convert_torch import _assert_tables_equal

    path, params, tables = pth["st48"]
    api = cra5_api(model_version=-1, weights=path, device="cpu")
    c = api.codec
    _assert_tables_equal({"eb": c._eb_table, "gc": c._gc_table, "scale_table": c.scale_table},
                         tables)
    assert torch.equal(c._scale_table_dev, torch.from_numpy(tables["scale_table"]))
    assert c._gc_coder is not None  # v2 coders made from the installed tables
    for name, value in convert.from_flax_params(api.net, {"params": params}).items():
        assert np.array_equal(api.net.get_parameter(name).detach().numpy(), value), name


@pytest.mark.parametrize("table", ["st48", "default"])
def test_pth_bin_equals_jax_and_shows_the_install(pth, tmp_path, table):
    from cra5_tpu_torch.models.vaeformer import VAEformerCodec

    path, _, _ = pth[table]
    api = cra5_api(model_version=-1, weights=path, device="cpu")
    japi = j_cra5_api(model_version=-1, weights=path, dtype=jnp.float32)
    if table == "st48":
        japi.codec._scale_table_dev = jnp.asarray(japi.codec.scale_table)
    out = api.encode_era5_as_bin(TS, save_root=str(tmp_path / "port"))
    jout = japi.encode_era5_as_bin(TS, save_root=str(tmp_path / "jax"))
    with open(out["save_path"], "rb") as a, open(jout["save_path"], "rb") as b:
        assert a.read() == b.read()
    # a codec with tables recomputed by update() writes other y bytes where
    # the file's scale table is not the default, the same bytes where it is
    fresh = VAEformerCodec(api.net)
    fresh.update()
    x = api.normalization(api._read_or_synthesize(TS))[None]
    y_fresh, z_fresh = fresh.compress(x)["strings"]
    assert z_fresh == out["output"]["strings"][1]
    assert (y_fresh == out["output"]["strings"][0]) == (table == "default")


def test_pth_without_tables_keeps_todays_behaviour(tmp_path):
    """A reference .pth that carries no CDF buffers installs nothing: the
    codec builds its tables at first use with the default scale table, as
    for the port's own weight files."""
    from cra5_tpu_torch.entropy import get_scale_table
    from cra5_tpu_torch.models.vaeformer import VAEformerCodec
    from test_torch_convert_torch import reference_state_dict, tiny_flax_params

    path = str(tmp_path / "plain.pth")
    torch.save(reference_state_dict(tiny_flax_params()), path)
    api = cra5_api(model_version=-1, weights=path, device="cpu")
    assert api.codec._eb_table is None
    assert np.array_equal(api.codec.scale_table, get_scale_table())
    x = api.normalization(api._read_or_synthesize(TS))[None]
    fresh = VAEformerCodec(api.net)
    fresh.update()
    assert api.codec.compress(x)["strings"] == fresh.compress(x)["strings"]
