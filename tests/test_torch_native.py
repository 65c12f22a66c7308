"""Port vs JAX: the v1 host coder (cra5_tpu_torch/coder/native.py, a g++
build of the port's own copy of rans64.cpp) and its pure-Python oracle.

Streams must be byte-identical to cra5_tpu.coder.native's and to the
oracle's; the v1 golden decodes and re-encodes byte for byte; invalid
tables and out-of-range indexes raise ValueError as in the JAX package."""

from pathlib import Path

import numpy as np
import pytest

from cra5_tpu.coder import native as j_native
from cra5_tpu_torch.coder import native
from cra5_tpu_torch.coder.lane_coder import zigzag_varint_encode as np_varint_encode
from cra5_tpu_torch.coder.rans_py import RansDecoder, RansEncoder
from cra5_tpu_torch.entropy.cdf import CdfTable, build_cdf_table

GOLDEN = Path(__file__).parent / "goldens"


def make_table(rng, ncdfs=4, max_bins=12):
    lengths = rng.integers(1, max_bins, size=ncdfs)
    pmfs = np.zeros((ncdfs, int(lengths.max())), dtype=np.float32)
    for i, L in enumerate(lengths):
        p = rng.random(L).astype(np.float32) + 0.01
        pmfs[i, :L] = p / (p.sum() * 1.05)
    table = build_cdf_table(pmfs, np.full(ncdfs, 0.01, np.float32), lengths)
    table.offset = rng.integers(-10, 10, size=ncdfs).astype(np.int32)
    return table


def sample(rng, table, n, escape_frac=0.02, far=300):
    idx = rng.integers(0, table.num_indexes, size=n).astype(np.int32)
    bins = (rng.random(n) * (table.cdf_length[idx] - 2)).astype(np.int32)
    sym = bins + table.offset[idx]
    esc = rng.random(n) < escape_frac
    sym = np.where(esc, sym + rng.integers(-far, far, size=n), sym)
    return sym.astype(np.int32), idx


def tabs(table):
    return table.quantized_cdf, table.cdf_length, table.offset


def _golden():
    z = np.load(GOLDEN / "rans_golden.npz")
    return z["sym"], z["idx"], CdfTable(z["quantized_cdf"], z["cdf_length"], z["offset"])


def test_v1_golden_decodes_and_reencodes_byte_identically():
    sym, idx, table = _golden()
    data = (GOLDEN / "stream_v1.bin").read_bytes()
    np.testing.assert_array_equal(native.decode_with_indexes(data, idx, *tabs(table)), sym)
    assert native.encode_with_indexes(sym, idx, *tabs(table)) == data


@pytest.mark.parametrize("seed,n,ncdfs,esc,far", [
    (0, 1, 1, 0.0, 300), (1, 2000, 4, 0.02, 300), (2, 5000, 16, 0.2, 1 << 20),
    (3, 777, 64, 0.5, 40000), (4, 3000, 3, 0.0, 300)])
def test_bytes_equal_the_jax_coder_on_random_tables(seed, n, ncdfs, esc, far):
    rng = np.random.default_rng(seed)
    table = make_table(rng, ncdfs=ncdfs, max_bins=40)
    sym, idx = sample(rng, table, n, esc, far)
    data = native.encode_with_indexes(sym, idx, *tabs(table))
    assert data == j_native.encode_with_indexes(sym, idx, *tabs(table))
    np.testing.assert_array_equal(native.decode_with_indexes(data, idx, *tabs(table)), sym)
    np.testing.assert_array_equal(j_native.decode_with_indexes(data, idx, *tabs(table)), sym)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_equals_the_python_oracle(seed):
    rng = np.random.default_rng(seed)
    table = make_table(rng)
    sym, idx = sample(rng, table, 1500, 0.05)
    lists = [t.tolist() for t in tabs(table)]
    py = RansEncoder().encode_with_indexes(sym.tolist(), idx.tolist(), *lists)
    assert native.encode_with_indexes(sym, idx, *tabs(table)) == py
    assert RansDecoder().decode_with_indexes(py, idx.tolist(), *lists) == sym.tolist()
    np.testing.assert_array_equal(native.decode_with_indexes(py, idx, *tabs(table)), sym)


def test_ragged_rows_equal_the_padded_table():
    rng = np.random.default_rng(9)
    table = make_table(rng)
    sym, idx = sample(rng, table, 400)
    rows = [table.quantized_cdf[i, : table.cdf_length[i]].tolist() for i in range(table.num_indexes)]
    assert (native.encode_with_indexes(sym, idx, rows, table.cdf_length, table.offset)
            == native.encode_with_indexes(sym, idx, *tabs(table)))


def test_streaming_decoder_continues_across_calls():
    rng = np.random.default_rng(4)
    table = make_table(rng)
    sym, idx = sample(rng, table, 900, 0.05)
    sd = native.StreamingDecoder(native.encode_with_indexes(sym, idx, *tabs(table)))
    parts = [sd.decode(idx[a:b], *tabs(table)) for a, b in ((0, 1), (1, 500), (500, 900))]
    np.testing.assert_array_equal(np.concatenate(parts), sym)
    js = j_native.StreamingDecoder(native.encode_with_indexes(sym, idx, *tabs(table)))
    np.testing.assert_array_equal(js.decode(idx, *tabs(table)), sym)


@pytest.mark.parametrize("who", ["port", "jax"])
@pytest.mark.parametrize("fault", ["zero_start", "not_monotone", "bad_length", "index_high", "index_negative"])
def test_invalid_tables_and_indexes_raise_value_error(who, fault):
    """The same faults raise ValueError in both packages, on encode, on
    decode and in the streaming decoder."""
    mod = native if who == "port" else j_native
    rng = np.random.default_rng(1)
    table = make_table(rng)
    sym, idx = sample(rng, table, 50)
    data = native.encode_with_indexes(sym, idx, *tabs(table))
    cdf, lengths = table.quantized_cdf.copy(), table.cdf_length.copy()
    idx = idx.copy()
    if fault == "zero_start":
        cdf[1, 0] = 5
    elif fault == "not_monotone":
        cdf[2, 1] = cdf[2, 2]
    elif fault == "bad_length":
        lengths[0] = cdf.shape[1] + 1
    elif fault == "index_high":
        idx[7] = table.num_indexes
    else:
        idx[3] = -1
    match = "out of range" if fault.startswith("index") else "invalid CDF table"
    with pytest.raises(ValueError, match=match):
        mod.encode_with_indexes(sym, idx, cdf, lengths, table.offset)
    with pytest.raises(ValueError, match=match):
        mod.decode_with_indexes(data, idx, cdf, lengths, table.offset)
    with pytest.raises(ValueError, match=match):
        mod.StreamingDecoder(data).decode(idx, cdf, lengths, table.offset)


def test_malformed_stream_raises():
    rng = np.random.default_rng(2)
    table = make_table(rng)
    _, idx = sample(rng, table, 10)
    for mod in (native, j_native):
        with pytest.raises(ValueError, match="malformed"):
            mod.decode_with_indexes(b"\x00" * 6, idx, *tabs(table))


def test_varints_equal_the_numpy_oracle_and_jax():
    rng = np.random.default_rng(6)
    vals = np.concatenate([rng.integers(-(1 << 31), (1 << 31) - 1, 500),
                           rng.integers(-300, 300, 500), [0, -1, 1, (1 << 31) - 1, -(1 << 31)]])
    enc = native.zigzag_varint_encode(vals)
    assert enc == np_varint_encode(vals.astype(np.int32)) == j_native.zigzag_varint_encode(vals)
    np.testing.assert_array_equal(native.zigzag_varint_decode(enc, vals.size), vals.astype(np.int32))
    with pytest.raises(ValueError, match="truncated"):
        native.zigzag_varint_decode(enc[:-1], vals.size)


def test_build_goes_to_the_build_directory_by_content_hash():
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.name.startswith("librans64_")
    assert not list((Path(native.__file__).parent / "csrc").glob("*.so"))


def test_a_missing_compiler_raises(monkeypatch, tmp_path):
    """No fallback: without g++ the build raises."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()
