"""Port vs JAX: the lane-rANS kernels' plain versions against the Pallas
kernels in interpret mode, and the port's LaneCoder against the JAX one.

All comparisons are exact (integers and bytes)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cra5_tpu.coder import rans_tpu as rt
from cra5_tpu.coder.rans_pallas import (
    decode_rowplan_pallas,
    decode_sorted_pallas,
    encode_scan_pallas,
    set_sorted_lanes,
)
from cra5_tpu.entropy.cdf import CdfTable as JCdfTable
from cra5_tpu_torch.coder import rans_kernels as rk
from cra5_tpu_torch.coder.lane_coder import (
    LaneCoder,
    _sort_by_index,
    merge_tiny_buckets,
    parse_v2_header,
    sorted_rows,
)
from cra5_tpu_torch.entropy import EntropyBottleneck, eb_update, gc_update, get_scale_table
from cra5_tpu_torch.entropy.cdf import CdfTable

GOLDEN = Path(__file__).parent / "goldens"


@pytest.fixture(scope="module")
def gc_table():
    return gc_update(get_scale_table())


@pytest.fixture(scope="module")
def eb_table():
    eb = EntropyBottleneck(16, device="cpu")
    eb.reset_parameters(torch.Generator().manual_seed(0))
    return eb_update(eb.params_numpy())


def _jax_table(t: CdfTable) -> JCdfTable:
    return JCdfTable(t.quantized_cdf, t.cdf_length, t.offset)


def _sample(rng, table, idx, escape_frac):
    """Symbols from each row's own pmf, plus far out-of-range escapes."""
    sym = np.empty(idx.size, np.int64)
    for r in np.unique(idx):
        m = idx == r
        L = int(table.cdf_length[r])
        u = rng.integers(0, 1 << 16, int(m.sum()))
        bins = np.searchsorted(table.quantized_cdf[r, :L], u, side="right") - 1
        sym[m] = np.minimum(bins, L - 3) + int(table.offset[r])
    esc = rng.random(idx.size) < escape_frac
    sym[esc] += rng.integers(50, 3000, int(esc.sum())) * rng.choice([-1, 1], int(esc.sum()))
    return sym.astype(np.int32)


def _jax_sorted_encode(table, sym, idx, K):
    set_sorted_lanes("on")
    try:
        return rt.LaneCoder(_jax_table(table), num_lanes=K).encode(sym, idx)
    finally:
        set_sorted_lanes("auto")


def _parts(coder: LaneCoder, data: bytes):
    hdr, states, words, _ = coder._upload(data, parse_v2_header(data))
    return hdr, states, words


# ------------------------------------------------------------- K1
@pytest.mark.parametrize("M,K,unroll", [(13, 256, 4), (7, 1024, 8), (29, 128, None), (5, 384, 8)])
def test_encode_plain_matches_pallas(rng, M, K, unroll):
    """The plain K1 equals encode_scan_pallas (interpret) bit for bit; the
    unrolls that do not divide M make the Pallas side pad M with its
    identity steps."""
    freqs = rng.integers(1, 60000, (M, K)).astype(np.int32)
    starts = rng.integers(0, 5000, (M, K)).astype(np.int32)
    zeros = jnp.zeros((M, K), jnp.int32)
    x1, e1, w1 = encode_scan_pallas(zeros, jnp.asarray(starts), jnp.asarray(freqs), zeros,
                                    zeros, M, interpret=True, unroll=unroll)
    x0, e0, w0 = rk.rans_encode(torch.from_numpy(starts), torch.from_numpy(freqs))
    np.testing.assert_array_equal(x0.numpy().view(np.uint32), np.asarray(x1))
    np.testing.assert_array_equal(e0.numpy(), np.asarray(e1))
    emit = e0.numpy()
    np.testing.assert_array_equal(w0.numpy().view(np.uint16)[emit], np.asarray(w1)[emit])


def test_encode_padding_steps_are_identities(rng):
    """Steps with start 0 and freq 2**16 leave every lane unchanged."""
    M, K = 9, 200
    freqs = rng.integers(1, 60000, (M, K)).astype(np.int32)
    starts = rng.integers(0, 5000, (M, K)).astype(np.int32)
    pad_s = np.zeros((3, K), np.int32)
    pad_f = np.full((3, K), 1 << 16, np.int32)
    a = rk.rans_encode(torch.from_numpy(starts), torch.from_numpy(freqs))
    b = rk.rans_encode(torch.from_numpy(np.concatenate([starts, pad_s])),
                       torch.from_numpy(np.concatenate([freqs, pad_f])))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1][:M])
    assert not b[1][M:].any()


def _f32_toward_zero(v: np.ndarray) -> np.ndarray:
    """float64 values rounded to float32 toward zero (the card's _rz forms)."""
    c = v.astype(np.float32)
    over = np.abs(c.astype(np.float64)) > np.abs(v)
    c[over] = np.nextafter(c[over], np.float32(0))
    return c


def _k1_step(x: np.ndarray, f: np.ndarray, s: np.ndarray, rcp_ulps: int):
    """A mirror in numpy of one step of the card's K1 (csrc/rans_encode.cu):
    the emit test against (f << 16) - 1, the integer reciprocal R =
    trunc(rz(rcp(f) (2^32 - 2^10))) with rcp(f) taken ``rcp_ulps`` ulps off
    the nearest float to 1 / f (rcp.approx is within one), the estimate qe =
    mulhi(xe, R), the corrections by r >= f and r >= 2f, and the push x + s
    + q (2^16 - f). Returns (renormalized x, its quotient, the pushed state,
    emit)."""
    x, f, s = (a.astype(np.uint64) for a in (x, f, s))
    e = x > (f << np.uint64(16)) - np.uint64(1)
    xe = np.where(e, x >> np.uint64(16), x)
    rcp = (1.0 / f.astype(np.float64)).astype(np.float32)
    for _ in range(abs(rcp_ulps)):
        rcp = np.nextafter(rcp, np.float32(np.inf if rcp_ulps > 0 else 0))
    R = np.trunc(_f32_toward_zero(rcp.astype(np.float64) * 4294966272.0)).astype(np.uint64)
    qe = (xe * R) >> np.uint64(32)
    re = xe - qe * f  # in [0, 3f): qe is q, q - 1 or q - 2
    q = qe + (re >= f) + (re >= 2 * f)
    g = np.uint64(1 << 16) - f
    pushed = (xe + s + q * g) & np.uint64(0xFFFFFFFF)
    return xe, q, pushed, e


@pytest.mark.parametrize("rcp_ulps", [-1, 0, 1])
def test_k1_quotient_is_exact_division(rng, rcp_ulps):
    """K1's quotient, as the card computes it, equals exact division for
    every freq the format allows (1 to 2^16) at the edges of the state (0, f
    - 1, f, (2^16 - 1) f, (f << 16) - 1, 2^32 - 1) and at seeded random
    states, with its reciprocal one ulp either side of the nearest; the
    pushed state equals the plain version's (q << 16) + x mod f + start.
    (2^16 - 1) f, the largest multiple of f a renormalized state holds, is
    where the estimate falls two short for freqs near 2^16 (65494 with the
    reciprocal an ulp low), which the second correction mends."""
    f = np.repeat(np.arange(1, (1 << 16) + 1, dtype=np.uint64), 12)
    f1 = f[::12]
    edges = np.stack([np.zeros_like(f1), f1 - 1, f1, np.uint64(0xFFFF) * f1,
                      (f1 << np.uint64(16)) - 1, np.full_like(f1, 0xFFFFFFFF)], 1)
    x = np.concatenate([edges, rng.integers(0, 1 << 32, (edges.shape[0], 6), dtype=np.uint64)],
                       1).reshape(-1)
    s = rng.integers(0, 1 << 16, f.size, dtype=np.uint64) % (np.uint64(65537) - f)
    xe, q, pushed, e = _k1_step(x, f, s, rcp_ulps)
    assert np.array_equal(e, x >= f << np.uint64(16))
    np.testing.assert_array_equal(q, xe // f)
    want = ((xe // f) << np.uint64(16)) + xe % f + s
    np.testing.assert_array_equal(pushed, want)
    assert want.max() < 1 << 32


# ------------------------------------------------------------- K2
@pytest.mark.parametrize("C,HW,K,esc", [(16, 81, 32, 0.03), (7, 40, 16, 0.0), (4, 200, 128, 0.1)])
def test_rowplan_plain_matches_pallas(rng, eb_table, C, HW, K, esc):
    table = CdfTable(eb_table.quantized_cdf[:C], eb_table.cdf_length[:C], eb_table.offset[:C])
    idx = np.repeat(np.arange(C, dtype=np.int32), HW)
    sym = _sample(rng, table, idx, esc)
    coder = LaneCoder(table, num_lanes=K, device="cpu")
    (n, _, _, _, srt, _, _), states, words = _parts(coder, coder.encode(sym, idx))
    assert not srt
    M = -(-n // K)
    idx2 = np.concatenate([idx, np.zeros(M * K - n, np.int32)]).reshape(M, K)
    cdf = coder._cdf.numpy()
    c0, c1 = idx2[:, 0], idx2.max(1)
    rows = cdf[np.stack([c0, c1, np.zeros_like(c0)], 1)]
    sel = np.where(idx2 == c0[:, None], 0, np.where(idx2 == c1[:, None], 1, 2))
    mv_t, off_t = coder._max_values.numpy(), coder._offsets.numpy()
    stream = np.pad(words.numpy().view(np.uint16).astype(np.int32), (0, K))
    v1, s1 = decode_rowplan_pallas(
        jnp.asarray(rows), jnp.asarray(sel.astype(np.int32)),
        jnp.asarray(states.numpy().view(np.uint32)), jnp.asarray(stream),
        jnp.asarray(mv_t[idx2]), jnp.asarray(off_t[idx2]), M, interpret=True)
    v0, s0 = rk.rans_decode_generic(coder._cdf, torch.from_numpy(idx2), states, words,
                                    coder._max_values, coder._offsets)
    np.testing.assert_array_equal(v0.numpy(), np.asarray(v1))
    np.testing.assert_array_equal(s0.numpy(), np.asarray(s1))


# ------------------------------------------------------------- K3
def test_sorted_plain_matches_pallas(rng, gc_table):
    """GC table (64 rows, max_len 3133), K = 2048, ~1% escapes, on a
    stream the JAX coder wrote in sorted+merged mode."""
    K = 2048
    n = K * 11 + 777
    idx = np.concatenate([rng.integers(20, 28, n - 40), rng.integers(0, 64, 40)]).astype(np.int32)
    rng.shuffle(idx)
    sym = _sample(rng, gc_table, idx, 0.01)
    data = _jax_sorted_encode(gc_table, sym, idx, K)
    coder = LaneCoder(gc_table, num_lanes=K, device="cpu")
    (n_, K_, _, _, srt, safe, merged), states, words = _parts(coder, data)
    assert (n_, K_, srt, safe, merged) == (n, K, True, True, True)
    M = -(-n // K)
    sidx, _ = _sort_by_index(torch.from_numpy(idx))
    sidx = merge_tiny_buckets(sidx, coder.num_indexes, K)
    idx2 = torch.cat([sidx, sidx[-1:].expand(M * K - n)]).reshape(M, K)
    r0, r1, split = sorted_rows(idx2)
    v0, s0 = rk.rans_decode_sorted(coder._cdf, r0, r1, split, states, words,
                                   coder._max_values, coder._offsets)

    jc = rt.LaneCoder(_jax_table(gc_table), num_lanes=K)
    coarse_tab, chunk_tab, G, Lc = jc._sorted_tables()
    r0n, r1n = r0.numpy(), r1.numpy()
    coarse = jnp.stack([coarse_tab[r0n], coarse_tab[r1n]], axis=-1)
    chunk = jnp.concatenate([chunk_tab[r0n], chunk_tab[r1n]], axis=-1)
    mv_t, off_t = coder._max_values.numpy(), coder._offsets.numpy()
    stream = np.pad(words.numpy().view(np.uint16).astype(np.int32), (0, K + 256))
    v1, s1 = decode_sorted_pallas(
        coarse, chunk, jnp.asarray(split.numpy()), jnp.asarray(mv_t[r0n]), jnp.asarray(mv_t[r1n]),
        jnp.asarray(off_t[r0n]), jnp.asarray(off_t[r1n]),
        jnp.asarray(states.numpy().view(np.uint32)), jnp.asarray(stream), M, G, Lc,
        interpret=True)
    np.testing.assert_array_equal(v0.numpy(), np.asarray(v1))
    np.testing.assert_array_equal(s0.numpy(), np.asarray(s1))
    assert s0.any()  # the escapes reached the kernel as sentinels


# ------------------------------------------------------------- coder
def _streams(rng, gc_table, eb_table):
    gi = rng.integers(0, 64, 2048 * 6 + 100).astype(np.int32)
    zi = np.repeat(np.arange(16, dtype=np.int32), 96)
    return {
        "gc_sorted": (gc_table, _sample(rng, gc_table, gi, 0.02), gi, 2048),
        "gc_unsorted": (gc_table, _sample(rng, gc_table, gi, 0.02), gi, 512),
        "eb_z_grid": (eb_table, _sample(rng, eb_table, zi, 0.02), zi, 32),
    }


@pytest.mark.parametrize("kind", ["gc_sorted", "gc_unsorted", "eb_z_grid"])
def test_lane_coder_bytes_and_cross_decode(rng, gc_table, eb_table, kind):
    """Same bytes as the JAX LaneCoder (sorted+merged at K=2048, as the
    JAX package writes on its accelerator), and each package decodes the
    other's bytes."""
    table, sym, idx, K = _streams(rng, gc_table, eb_table)[kind]
    if K >= 2048:
        want = _jax_sorted_encode(table, sym, idx, K)
    else:
        want = rt.LaneCoder(_jax_table(table), num_lanes=K).encode(sym, idx)
    port = LaneCoder(table, num_lanes=K, device="cpu")
    got = port.encode(sym, idx)
    assert got == want
    assert parse_v2_header(got)[4] == (K >= 2048)
    np.testing.assert_array_equal(port.decode(want, idx), sym)
    np.testing.assert_array_equal(rt.LaneCoder(_jax_table(table), num_lanes=K).decode(got, idx), sym)
    dev = port.decode_to_device(want, torch.from_numpy(idx))
    np.testing.assert_array_equal(dev.numpy(), sym)


def _golden_table():
    z = np.load(GOLDEN / "rans_golden.npz")
    return z["sym"], z["idx"], CdfTable(z["quantized_cdf"], z["cdf_length"], z["offset"])


def test_v2_golden_decodes_and_reencodes():
    sym, idx, table = _golden_table()
    data = (GOLDEN / "stream_v2.bin").read_bytes()
    coder = LaneCoder(table, device="cpu")
    np.testing.assert_array_equal(coder.decode(data, idx), sym)
    assert coder.encode(sym, idx) == data


def test_v2_sorted_golden_decodes_and_reencodes():
    _, _, table = _golden_table()
    z = np.load(GOLDEN / "sorted_golden.npz")
    sym, idx = z["sym"], z["idx"]
    data = (GOLDEN / "stream_v2_sorted.bin").read_bytes()
    assert parse_v2_header(data)[4:7] == (True, True, True)
    coder = LaneCoder(table, num_lanes=128, device="cpu", sorted_lanes=True)
    np.testing.assert_array_equal(coder.decode(data, idx), sym)
    assert coder.encode(sym, idx) == data


def test_kernel_unsafe_sorted_stream_decodes_on_cpu(rng, gc_table):
    """A sorted stream whose buckets are all below K carries no bit 30; no
    ported kernel covers it, and the CPU decodes it with the plain per-lane
    decode."""
    idx = rng.integers(0, 64, 1500).astype(np.int32)
    sym = _sample(rng, gc_table, idx, 0.0)
    data = _jax_sorted_encode(gc_table, sym, idx, 256)
    assert parse_v2_header(data)[4:6] == (True, False)
    coder = LaneCoder(gc_table, num_lanes=256, device="cpu", sorted_lanes=True)
    np.testing.assert_array_equal(coder.decode(data, idx), sym)
    assert coder.encode(sym, idx) == data


@pytest.mark.parametrize("kind,route", [("safe_sorted", "sorted"), ("gc_unsorted", "lanes"),
                                        ("eb_z_grid", "lanes"), ("unsafe_sorted", "lanes")])
def test_decode_routes_by_the_stream_format(rng, gc_table, eb_table, monkeypatch, kind, route):
    """A sorted kernel-safe stream goes to K3; every other stream, the
    channel-broadcast z grid and a sorted stream without bit 30 included,
    goes to the lane decode K2 (rans_decode_generic)."""
    from cra5_tpu_torch.coder import lane_coder

    calls = []
    for name, tag in (("rans_decode_generic", "lanes"), ("rans_decode_sorted", "sorted")):
        real = getattr(lane_coder, name)
        monkeypatch.setattr(lane_coder, name,
                            lambda *a, _real=real, _tag=tag: calls.append(_tag) or _real(*a))
    if kind.endswith("sorted"):
        # three rows of >= K symbols each: bit 30; every bucket below K: none
        idx = (rng.integers(20, 23, 2048 * 6 + 100) if kind == "safe_sorted"
               else rng.integers(0, 64, 1500)).astype(np.int32)
        K = 2048 if kind == "safe_sorted" else 256
        table, sym = gc_table, _sample(rng, gc_table, idx, 0.01)
        coder = LaneCoder(table, num_lanes=K, device="cpu", sorted_lanes=True)
        assert parse_v2_header(coder.encode(sym, idx))[4:6] == (True, kind == "safe_sorted")
    else:
        table, sym, idx, K = _streams(rng, gc_table, eb_table)[kind]
        coder = LaneCoder(table, num_lanes=K, device="cpu")
    data = coder.encode(sym, idx)
    np.testing.assert_array_equal(coder.decode(data, idx), sym)
    assert calls == [route]


@pytest.mark.parametrize("kind", ["safe_sorted", "gc_unsorted", "eb_z_grid"])
def test_decode_call_pairs_each_kernel_with_its_plain_version(rng, gc_table, eb_table, kind):
    """decode_call names the kernel a stream takes and that kernel's plain
    version; the plain version on its arguments, escapes applied and the
    sort undone, gives the encoded symbols."""
    from cra5_tpu_torch.coder.lane_coder import _apply_escapes

    if kind == "safe_sorted":
        idx = rng.integers(20, 23, 2048 * 6 + 100).astype(np.int32)
        table, sym, K = gc_table, _sample(rng, gc_table, idx, 0.01), 2048
        coder = LaneCoder(table, num_lanes=K, device="cpu", sorted_lanes=True)
    else:
        table, sym, idx, K = _streams(rng, gc_table, eb_table)[kind]
        coder = LaneCoder(table, num_lanes=K, device="cpu")
    data = coder.encode(sym, idx)
    up = coder.upload_batch([data])[0]
    kernel, plain, args, perm = coder.decode_call(up, torch.from_numpy(idx))
    want = ((rk.rans_decode_sorted, rk.rans_decode_sorted_plain) if kind == "safe_sorted"
            else (rk.rans_decode_generic, rk.lane_decode_plain))
    assert (kernel, plain) == want and (perm is None) == (kind != "safe_sorted")
    values, n_sent = _apply_escapes(*plain(*args), up[3], sym.size)
    if perm is not None:
        values = torch.empty_like(values).index_copy_(0, perm, values)
    np.testing.assert_array_equal(values.reshape(idx.shape).numpy(), sym)
    assert int(n_sent) == parse_v2_header(data)[2]


def test_empty_stream_matches_jax(eb_table):
    empty = np.zeros(0, np.int32)
    data = LaneCoder(eb_table, device="cpu").encode(empty, empty)
    assert data == rt.LaneCoder(_jax_table(eb_table)).encode(empty, empty)
    assert LaneCoder(eb_table, device="cpu").decode(data, empty).shape == (0,)


@pytest.mark.parametrize("kernel", ["rowplan", "sorted"])  # rowplan: the lane decode K2
@pytest.mark.parametrize("bad", [-1, 16])
def test_decode_rejects_cdf_rows_outside_the_table(eb_table, kernel, bad):
    """A row index outside [0, ncdfs) raises in the wrapper, on every
    device, before any decode: the kernels read rows unchecked."""
    coder = LaneCoder(eb_table, num_lanes=8, device="cpu")
    states = torch.full((8,), 1 << 16, dtype=torch.int32)
    words = torch.zeros(4, dtype=torch.int16)
    tabs = (coder._max_values, coder._offsets)
    with pytest.raises(IndexError, match="16 rows"):
        if kernel == "rowplan":
            idx = torch.zeros((3, 8), dtype=torch.int32)
            idx[1, 5] = bad
            rk.rans_decode_generic(coder._cdf, idx, states, words, *tabs)
        else:
            r0 = torch.tensor([0, 2, 3], dtype=torch.int32)
            r1 = torch.tensor([1, bad, 3], dtype=torch.int32)
            split = torch.tensor([4, 8, 0], dtype=torch.int32)
            rk.rans_decode_sorted(coder._cdf, r0, r1, split, states, words, *tabs)


@pytest.mark.parametrize("kind", ["gc_unsorted", "eb_z_grid"])
def test_lane_encode_decode_helpers_and_encode_from_device_match_jax(rng, gc_table, eb_table,
                                                                     kind):
    """lane_encode / lane_decode write and read the JAX helpers' bytes, and
    encode_from_device on tensors already on the coder's device writes what
    encode writes from numpy."""
    from cra5_tpu_torch.coder import lane_decode, lane_encode

    table, sym, idx, K = _streams(rng, gc_table, eb_table)[kind]
    want = rt.lane_encode(sym, idx, _jax_table(table), K)
    got = lane_encode(sym, idx, table, K, device="cpu")
    assert got == want
    np.testing.assert_array_equal(lane_decode(want, idx, table, K, device="cpu"), sym)
    np.testing.assert_array_equal(rt.lane_decode(got, idx, _jax_table(table), K), sym)
    coder = LaneCoder(table, num_lanes=K, device="cpu")
    assert coder.encode_from_device(torch.from_numpy(sym), torch.from_numpy(idx)) == got
    assert rt.LaneCoder(_jax_table(table), num_lanes=K).encode_from_device(
        jnp.asarray(sym), jnp.asarray(idx)) == got
