"""Port vs JAX: the standalone C++ codec package (standalone/export.py).

The port keeps its own byte-for-byte copy of the JAX package's
``cra5_codec.cpp`` and builds it into build/cra5_tpu_torch/; JAX's binary is
built here from JAX's source into a temporary directory (not beside its
source, where the JAX package's own tests build theirs). Held exactly:
the CRT1 / CRX1 / CRXf / CRS1 / CRSq files the port writes equal JAX's
for the same weights and tables (bmshj2018-factorized's g_s and g_a with
perturbed GDNs and biases, float and int16), and each package's binary
decodes the streams the other package writes. Against the port's own codec
(bmshj2018-factorized q1, seeded): decode-full within DECODE_RTOL /
DECODE_ATOL of its x_hat (the float engine) and the int16 engine within
INT16_REL of the float one; encode-full gives its symbols (the float
engine exactly, the int16 engine on >= 99% of them).
"""

import json
import stat
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import cra5_tpu.standalone.export as jx
import cra5_tpu_torch.standalone.export as px
from cra5_tpu_torch.coder import native
from cra5_tpu_torch.coder.lane_coder import LaneCoder, parse_v2_header
from cra5_tpu_torch.convert import to_flax_params
from cra5_tpu_torch.entropy.cdf import CdfTable
from cra5_tpu_torch.models import load_model
from cra5_tpu_torch.standalone import (
    build_codec_binary,
    export_analysis,
    export_codec,
    export_synthesis,
    extract_cdf_from_latents,
    load_tables_file,
    read_tensor_file,
    run_codec,
    write_tables_file,
    write_tensor_file,
)

from _torch_pairs import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "goldens"
DECODE_RTOL, DECODE_ATOL = 1e-3, 1e-4  # the C++ float engine vs the port's x_hat
INT16_REL = 2e-3  # ||int16 engine - float engine|| / ||float engine||


@pytest.fixture(scope="module")
def binaries(tmp_path_factory):
    """(the port's binary, a binary of the JAX package's source), compiled
    in parallel."""
    jax_bin = tmp_path_factory.mktemp("jaxbin") / "cra5_codec"
    proc = subprocess.Popen(["g++", *px.GXX_FLAGS, jx._SRC, "-o", str(jax_bin)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    port_bin = build_codec_binary()
    assert proc.wait(timeout=300) == 0, proc.stderr.read().decode()
    return port_bin, str(jax_bin)


@pytest.fixture(scope="module")
def latents():
    return (np.random.default_rng(0).normal(size=(4, 6, 8, 16)) * 3.0).astype(np.float32)


@pytest.fixture(scope="module")
def table(latents):
    return extract_cdf_from_latents(latents)


@pytest.fixture(scope="module")
def factorized():
    """bmshj2018-factorized q1 on the CPU, seeded, its GDNs and biases
    perturbed so every effective value and sign is exercised, and its
    codec with tables built."""
    model, codec = load_model("bmshj2018-factorized", 1, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("beta", "gamma")):
                p.add_(torch.rand(p.shape, generator=g) * 0.05)
            elif name.endswith("conv.bias"):
                p.add_(torch.randn(p.shape, generator=g) * 0.05)
    codec.update()
    return model, codec


def _medians(model):
    return model.entropy_bottleneck.medians().detach().numpy()


def _crb2(path, payload: bytes, dims) -> None:
    with open(path, "wb") as f:
        f.write(b"CRB2" + struct.pack("<i", len(dims)) + np.asarray(dims, np.int32).tobytes())
        f.write(struct.pack("<I", len(payload)) + payload)


def _payload(path) -> bytes:
    blob = Path(path).read_bytes()
    off = 8 + 4 * struct.unpack_from("<i", blob, 4)[0]
    (nbytes,) = struct.unpack_from("<I", blob, off)
    return blob[off + 4:off + 4 + nbytes]


def test_the_cpp_source_is_jaxs():
    assert px._SRC.read_bytes() == Path(jx._SRC).read_bytes()


def test_build_raises_without_gxx(monkeypatch, tmp_path):
    """With no g++ on PATH, or a g++ that fails, the build raises with the
    compiler's message; it never returns a missing binary."""
    monkeypatch.setattr(px, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        px.build_codec_binary()
    fake = tmp_path / "bin" / "g++"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'cra5_codec.cpp:1: error: broken' >&2\nexit 1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(fake.parent))
    with pytest.raises(RuntimeError, match="error: broken"):
        px.build_codec_binary()
    assert not list((tmp_path / "build").iterdir())  # no binary, no temporary left


def test_tables_and_tensor_files_equal_jaxs(table, tmp_path):
    for write, name in ((px.write_tables_file, "p.crt"), (jx.write_tables_file, "j.crt")):
        write(str(tmp_path / name), table)
    assert (tmp_path / "p.crt").read_bytes() == (tmp_path / "j.crt").read_bytes()
    t2 = load_tables_file(str(tmp_path / "j.crt"))
    for k in ("quantized_cdf", "cdf_length", "offset"):
        np.testing.assert_array_equal(getattr(t2, k), getattr(table, k))
    t2.validate()
    for arr in (np.arange(24, dtype=np.int32).reshape(2, 3, 4),
                (np.arange(6) / 3.0).astype(np.float32).reshape(2, 3)):
        write_tensor_file(str(tmp_path / "p.crx"), arr)
        jx.write_tensor_file(str(tmp_path / "j.crx"), arr)
        assert (tmp_path / "p.crx").read_bytes() == (tmp_path / "j.crx").read_bytes()
        got = read_tensor_file(str(tmp_path / "j.crx"))
        assert got.dtype == arr.dtype
        np.testing.assert_array_equal(got, arr)
    with pytest.raises(ValueError):
        write_tensor_file(str(tmp_path / "x.crx"), np.zeros(3, np.float64))


def test_extract_cdf_equals_jaxs(latents, table):
    want = jx.extract_cdf_from_latents(latents)
    for k in ("quantized_cdf", "cdf_length", "offset"):
        np.testing.assert_array_equal(getattr(table, k), getattr(want, k))
    t1 = extract_cdf_from_latents(latents[:, 0])  # (C, ...) layout
    np.testing.assert_array_equal(t1.quantized_cdf,
                                  jx.extract_cdf_from_latents(latents[:, 0]).quantized_cdf)


@pytest.mark.parametrize("dtype", ["f32", "int16"])
def test_crs_files_equal_jaxs(factorized, tmp_path, dtype):
    """g_s (deconvs, IGDNs, the medians' channel bias first) and g_a
    (convs, GDNs, -medians last) through both exporters, byte for byte."""
    model, _ = factorized
    tree = to_flax_params(model, dict(model.named_parameters()))
    med = _medians(model)
    for stack, port_fn, jax_fn in (("g_s", export_synthesis, jx.export_synthesis),
                                   ("g_a", export_analysis, jx.export_analysis)):
        p, j = tmp_path / f"{stack}.p.crs", tmp_path / f"{stack}.j.crs"
        port_fn(str(p), getattr(model, stack), medians=model.entropy_bottleneck.medians(),
                dtype=dtype)
        jax_fn(str(j), getattr(model, stack).specs, tree[stack], medians=med, dtype=dtype)
        assert p.read_bytes()[:4] == (b"CRSq" if dtype == "int16" else b"CRS1")
        assert p.read_bytes() == j.read_bytes(), stack
    with pytest.raises(ValueError, match="dtype"):
        export_synthesis(str(tmp_path / "x.crs"), model.g_s, dtype="int8")


def test_cpp_roundtrips_and_rdoq(binaries, latents, table, tmp_path):
    """v1 encode/decode exact (escapes past the histogram included), the
    stream decodable by the port's host coder; RDOQ: round() when
    distortion dominates, within 1 of it and no more bytes when rate does."""
    sym = np.round(latents[0]).astype(np.int32)
    sym[0, 0, 0], sym[1, 0, 0] = 999, -999
    t, x, b, o = (str(tmp_path / n) for n in ("t.bin", "x.bin", "s.bin", "o.bin"))
    write_tables_file(t, table)
    write_tensor_file(x, sym)
    run_codec("encode", t, x, b)
    run_codec("decode", t, b, o)
    np.testing.assert_array_equal(read_tensor_file(o), sym)
    idx = np.broadcast_to(np.arange(6, dtype=np.int32)[:, None, None], sym.shape)
    raw = Path(b).read_bytes()[4 + 4 + 12 + 4:]
    dec = native.decode_with_indexes(raw, idx, table.quantized_cdf, table.cdf_length, table.offset)
    np.testing.assert_array_equal(dec.reshape(sym.shape), sym)

    xf, q = str(tmp_path / "xf.bin"), str(tmp_path / "q.bin")
    write_tensor_file(xf, latents[0])
    run_codec("rdoq", t, xf, "1000000", q)
    q_hi = read_tensor_file(q)
    np.testing.assert_array_equal(q_hi, np.round(latents[0]).astype(np.int32))
    run_codec("rdoq", t, xf, "0.05", q)
    q_lo = read_tensor_file(q)
    assert np.all(np.abs(q_lo - np.round(latents[0])) <= 1)
    sizes = []
    for arr in (q_hi, q_lo):
        write_tensor_file(x, arr)
        sizes.append(int(run_codec("encode", t, x, b).stdout))
    assert sizes[1] <= sizes[0]
    with pytest.raises(subprocess.CalledProcessError):
        run_codec("encode", "/nonexistent", "/nonexistent", str(tmp_path / "z"))


def test_each_binary_decodes_the_other_packages_streams(binaries, latents, table, tmp_path):
    """v2 (CRB2): the JAX LaneCoder's and JAX binary's streams decode in the
    port's binary and LaneCoder; the port's binary's and LaneCoder's in
    JAX's; every container byte-identical across the four writers. v1
    (CRB1) both ways too."""
    from cra5_tpu.coder.rans_tpu import LaneCoder as JLaneCoder

    port_bin, jax_bin = binaries
    sym = np.round(latents[1] * 2).astype(np.int32)  # escapes included
    C, H, W = sym.shape
    idx = np.broadcast_to(np.arange(C, dtype=np.int32)[:, None, None], sym.shape)
    t, x = str(tmp_path / "t.bin"), str(tmp_path / "x.bin")
    write_tables_file(t, table)
    write_tensor_file(x, sym)
    run = lambda binary, *a: subprocess.run([binary, *a], check=True, capture_output=True)  # noqa: E731
    run(jax_bin, "encode2", t, x, str(tmp_path / "j.crb2"))
    run(port_bin, "encode2", t, x, str(tmp_path / "p.crb2"))
    payloads = {"jax binary": _payload(tmp_path / "j.crb2"),
                "port binary": _payload(tmp_path / "p.crb2"),
                "jax LaneCoder": bytes(JLaneCoder(table).encode(sym, idx)),
                "port LaneCoder": LaneCoder(table, device="cpu").encode(sym, idx)}
    assert len(set(payloads.values())) == 1, {k: len(v) for k, v in payloads.items()}
    _crb2(tmp_path / "jl.crb2", payloads["jax LaneCoder"], (C, H, W))
    for binary, src in ((port_bin, "j.crb2"), (port_bin, "jl.crb2"), (jax_bin, "p.crb2")):
        out = str(tmp_path / "o.crx")
        run(binary, "decode2", t, str(tmp_path / src), out)
        np.testing.assert_array_equal(read_tensor_file(out), sym)
    np.testing.assert_array_equal(LaneCoder(table, device="cpu").decode(payloads["jax binary"],
                                                                          idx), sym)
    np.testing.assert_array_equal(np.asarray(JLaneCoder(table).decode(payloads["port binary"],
                                                                        idx)), sym)
    run(jax_bin, "encode", t, x, str(tmp_path / "j.crb"))
    run(port_bin, "encode", t, x, str(tmp_path / "p.crb"))
    assert (tmp_path / "j.crb").read_bytes() == (tmp_path / "p.crb").read_bytes()
    for binary, src in ((port_bin, "j.crb"), (jax_bin, "p.crb")):
        run(binary, "decode", t, str(tmp_path / src), str(tmp_path / "o1.crx"))
        np.testing.assert_array_equal(read_tensor_file(str(tmp_path / "o1.crx")), sym)


def test_decode_full_matches_the_ports_codec(binaries, factorized, tmp_path):
    """decode-full (C++ entropy decode + deconv/IGDN synthesis) against the
    port codec's x_hat on a 64 x 64 image; the int16 engine (CRSq, under
    0.6 x the float file) against the float engine."""
    model, codec = factorized
    x = np.random.default_rng(1).normal(size=(1, 3, 64, 64)).astype(np.float32)
    out = codec.compress(x)
    x_hat = codec.decompress(out["strings"], out["shape"])["x_hat"].numpy()
    with torch.no_grad():
        sym = model.encode_symbols(torch.from_numpy(x))["y_sym"][0].numpy()
    t, s, b = (str(tmp_path / n) for n in ("eb.crt", "sym.crx", "y.bin"))
    write_tables_file(t, codec._eb_table)
    write_tensor_file(s, sym.astype(np.int32))
    run_codec("encode2", t, s, b)
    assert _payload(b) == out["strings"][0][0]  # the codec's own y stream
    f32, q = tmp_path / "g_s.crs", tmp_path / "g_s_q.crs"
    export_synthesis(str(f32), model.g_s, medians=_medians(model))
    export_synthesis(str(q), model.g_s, medians=_medians(model), dtype="int16")
    assert q.stat().st_size < 0.6 * f32.stat().st_size
    of, oq = str(tmp_path / "x_f.crx"), str(tmp_path / "x_q.crx")
    run_codec("decode-full", t, b, str(f32), of)
    run_codec("decode-full", t, b, str(q), oq)
    xf, xq = read_tensor_file(of), read_tensor_file(oq)
    assert xf.shape == x_hat.shape
    np.testing.assert_allclose(xf, x_hat, rtol=DECODE_RTOL, atol=DECODE_ATOL)
    assert np.linalg.norm(xq - xf) / np.linalg.norm(xf) < INT16_REL


def test_encode_full_gives_the_ports_symbols(binaries, factorized, tmp_path):
    """encode-full (C++ g_a, round half to even, entropy encode): the float
    engine's stream decodes to the port's symbols exactly, the int16
    engine's to them on >= 99%; encode-full then decode-full is the port
    codec's reconstruction within DECODE_RTOL / DECODE_ATOL."""
    model, codec = factorized
    x = np.random.default_rng(3).normal(size=(1, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        sym = model.encode_symbols(torch.from_numpy(x))["y_sym"][0].numpy()
    t, xp = str(tmp_path / "eb.crt"), str(tmp_path / "x.crx")
    write_tables_file(t, codec._eb_table)
    write_tensor_file(xp, x[0])
    for dtype, need in (("f32", 1.0), ("int16", 0.99)):
        ana = str(tmp_path / f"g_a_{dtype}.crs")
        export_analysis(ana, model.g_a, medians=_medians(model), dtype=dtype)
        b, o = str(tmp_path / f"y_{dtype}.bin"), str(tmp_path / f"s_{dtype}.crx")
        run_codec("encode-full", t, xp, ana, b)
        run_codec("decode2", t, b, o)
        got = read_tensor_file(o).reshape(sym.shape)
        assert np.mean(got == sym) >= need, dtype
    syn = str(tmp_path / "g_s.crs")
    export_synthesis(syn, model.g_s, medians=_medians(model))
    run_codec("decode-full", t, str(tmp_path / "y_f32.bin"), syn, str(tmp_path / "xh.crx"))
    out = codec.compress(x)
    x_hat = codec.decompress(out["strings"], out["shape"])["x_hat"].numpy()
    np.testing.assert_allclose(read_tensor_file(str(tmp_path / "xh.crx")), x_hat,
                               rtol=DECODE_RTOL, atol=DECODE_ATOL)


def test_encode_full_refuses_bad_inputs(binaries, table, tmp_path):
    """An int tensor where a float one is needed, a truncated network file
    and a channel mismatch each exit non-zero."""
    from cra5_tpu_torch.models.google import _ConvStack

    t = str(tmp_path / "t.crt")
    write_tables_file(t, table)
    ints, f = str(tmp_path / "i.crx"), str(tmp_path / "f.crx")
    write_tensor_file(ints, np.zeros((2, 4, 4), np.int32))
    write_tensor_file(f, np.zeros((2, 4, 4), np.float32))
    empty, bad, mis = (tmp_path / n for n in ("net.crs", "bad.crs", "mis.crs"))
    empty.write_bytes(b"CRS1" + (0).to_bytes(4, "little"))
    bad.write_bytes(b"CRS1" + (3).to_bytes(4, "little") + b"\x01")
    export_analysis(str(mis), _ConvStack((("conv", 4, 3, 2),), 5, "cpu"))  # expects 5 channels
    for x, net in ((ints, empty), (f, bad), (f, mis)):
        with pytest.raises(subprocess.CalledProcessError):
            run_codec("encode-full", t, x, str(net), str(tmp_path / "o.bin"))


def _sorted_stream(table, shape, K, seed):
    rng = np.random.default_rng(seed)
    idx = np.broadcast_to(np.arange(shape[0], dtype=np.int32)[:, None, None], shape).reshape(-1)
    mv = table.cdf_length[idx] - 2
    sym = (rng.random(idx.size) * mv).astype(np.int32) + table.offset[idx]
    esc = rng.random(idx.size) < 0.04
    sym = np.where(esc, sym + rng.integers(-200, 200, size=idx.size), sym).astype(np.int32)
    data = LaneCoder(table, num_lanes=K, device="cpu", sorted_lanes=True).encode(sym, idx)
    return sym, idx, data


@pytest.mark.parametrize("shape", [(6, 8, 16), (6, 4, 8)])
def test_cpp_decodes_the_ports_sorted_streams(binaries, table, tmp_path, shape):
    """Index-sorted v2 streams of the port's coder, dense buckets
    (kernel-safe) and all-sparse ones (unsafe, last-index padding), with
    escapes, decode in the binary."""
    sym, _, data = _sorted_stream(table, shape, 128, 21)
    assert parse_v2_header(data)[4]
    _crb2(tmp_path / "y.crb2", data, shape)
    t, o = str(tmp_path / "t.crt"), str(tmp_path / "o.crx")
    write_tables_file(t, table)
    run_codec("decode2", t, str(tmp_path / "y.crb2"), o)
    np.testing.assert_array_equal(read_tensor_file(o).reshape(-1), sym)


def test_cpp_decodes_the_ports_merged_stream_with_explicit_indexes(binaries, tmp_path):
    """The port's coder on the sorted golden's symbols and GC-style indexes
    writes the golden's sorted, kernel-safe, merged bytes; the binary
    decodes them against the explicit index tensor; an explicit-index
    encode2/decode2 roundtrip decodes in the port's coder."""
    z = np.load(GOLDEN / "rans_golden.npz")
    table = CdfTable(quantized_cdf=z["quantized_cdf"], cdf_length=z["cdf_length"],
                     offset=z["offset"])
    sg = np.load(GOLDEN / "sorted_golden.npz")
    sym, idx = sg["sym"], sg["idx"]
    data = LaneCoder(table, num_lanes=128, device="cpu", sorted_lanes=True).encode(sym, idx)
    assert data == (GOLDEN / "stream_v2_sorted.bin").read_bytes()
    assert parse_v2_header(data)[4:7] == (True, True, True)
    t, ip, o = (str(tmp_path / n) for n in ("t.crt", "idx.crx", "o.crx"))
    write_tables_file(t, table)
    write_tensor_file(ip, idx.astype(np.int32))
    _crb2(tmp_path / "y.crb2", data, (sym.size,))
    run_codec("decode2", t, str(tmp_path / "y.crb2"), o, ip)
    np.testing.assert_array_equal(read_tensor_file(o), sym)
    sp, b = str(tmp_path / "s.crx"), str(tmp_path / "e.crb2")
    write_tensor_file(sp, sym.astype(np.int32))
    run_codec("encode2", t, sp, b, ip)
    np.testing.assert_array_equal(
        LaneCoder(table, device="cpu").decode(_payload(b), idx.astype(np.int32)), sym)


def test_cpp_refuses_corrupted_sorted_streams(binaries, table, tmp_path):
    """Truncated, zeroed or absurd-header sorted containers of the port's
    coder exit non-zero and write no tensor."""
    shape = (6, 8, 16)
    _, _, payload = _sorted_stream(table, shape, 128, 41)
    t = str(tmp_path / "t.crt")
    write_tables_file(t, table)
    cases = [
        payload[:len(payload) // 2],
        payload[:12],
        b"\x00" * len(payload),
        payload[:8] + b"\xff\xff\xff\xff" + payload[12:],
        payload[:4] + b"\xff\xff\xff\xff" + payload[8:],
        payload[:16] + b"\x01\x00\x00\x80" + payload[20:],  # n_words >= 2^31
        payload[:12] + b"\xff\xff\xff\xff" + payload[16:],  # n_esc = 2^32 - 1
    ]
    for i, raw in enumerate(cases):
        _crb2(tmp_path / "bad.crb2", raw, shape)
        out = tmp_path / "bad.crx"
        r = subprocess.run([binaries[0], "decode2", t, str(tmp_path / "bad.crb2"), str(out)],
                           capture_output=True, timeout=120)
        assert r.returncode != 0 and not out.exists(), f"case {i} accepted corrupt input"


def test_export_codec_writes_jaxs_artifact(factorized, tmp_path):
    """eb_tables.bin and quantizers.json equal JAX's writers' on the same
    tables; params.npz holds the model's flax tree, path by path; a codec
    without tables builds them first; the hyperprior adds gc_tables.bin."""
    model, codec = factorized
    paths = export_codec(codec, str(tmp_path / "a"), params=model, meta={"arch": "f"})
    assert set(paths) == {"eb_tables", "quantizers", "params"}
    jx.write_tables_file(str(tmp_path / "j.crt"), codec._eb_table)
    assert Path(paths["eb_tables"]).read_bytes() == (tmp_path / "j.crt").read_bytes()
    assert json.loads(Path(paths["quantizers"]).read_text()) == {
        "precision": 16, "bypass_precision": 4, "scale_table": None, "arch": "f"}
    tree = to_flax_params(model, dict(model.named_parameters()))
    flat, loaded = {}, np.load(paths["params"])

    def walk(t, prefix=""):
        for k, v in t.items():
            name = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, name)
            else:
                flat[name] = v

    walk(tree)
    assert set(loaded.files) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(loaded[k], flat[k])
    _, hyper = load_model("bmshj2018-hyperprior", 1, device="cpu")
    assert hyper._eb_table is None
    paths = export_codec(hyper, str(tmp_path / "h"))
    assert set(paths) == {"eb_tables", "gc_tables", "quantizers"}
    load_tables_file(paths["gc_tables"]).validate()
    assert json.loads(Path(paths["quantizers"]).read_text())["scale_table"] == pytest.approx(
        hyper.scale_table.tolist())
