"""Port vs JAX: the permutation probe (profiling/_perm_probe.py) and its two
Pallas kernels, on the CPU.

The JAX probe is loaded from its file with ``importlib`` and run once with
a small N, its ``pl`` replaced by a namespace whose ``pallas_call`` runs
in interpret mode and records each (kernel, keyword arguments); the
recorded kernels then run on this file's own inputs. K7's and K8's plain
versions must equal them exactly."""

import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl

from cra5_tpu_torch import kernels
from cra5_tpu_torch.profiling import perm_probe as pp

PROBE = Path(__file__).resolve().parents[1] / "profiling" / "_perm_probe.py"


@pytest.fixture(scope="module")
def jax_kernels():
    """{"expand": (kernel, kwargs), "dynroll": (kernel, kwargs)} as the JAX
    probe hands them to pallas_call."""
    spec = importlib.util.spec_from_file_location("_perm_probe_under_test", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    calls = []

    def pallas_call(kernel, **kw):
        calls.append((kernel, kw))
        return jpl.pallas_call(kernel, interpret=True, **kw)

    mod.pl = types.SimpleNamespace(pallas_call=pallas_call, BlockSpec=jpl.BlockSpec)
    mod.N = 4096
    mod.timeit = lambda fn, *args, iters=10, name="": jax.block_until_ready(fn(*args))
    mod.main()
    names = [k.__name__ for k, _ in calls]
    assert names == ["expand_kernel", "dynroll_kernel"], names
    return {"expand": calls[0], "dynroll": calls[1]}


def _run(recorded, *args):
    kernel, kw = recorded
    return np.asarray(jpl.pallas_call(kernel, interpret=True, **kw)(*(jnp.asarray(a) for a in args)))


@pytest.mark.parametrize("density", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expand_plain_equals_the_pallas_kernel(jax_kernels, density, seed):
    rng = np.random.default_rng(seed)
    mask = (rng.random((pp.R, pp.KD)) < density).astype(np.int32)
    words = rng.integers(0, 1 << 16, (pp.R, pp.KD)).astype(np.int32)
    want = _run(jax_kernels["expand"], mask, words)
    got = pp.expand_plain(torch.from_numpy(mask), torch.from_numpy(words))
    np.testing.assert_array_equal(got.numpy(), want)


def test_expand_plain_equals_the_numpy_recipe():
    """The flat log-shift passes, written once more in numpy."""
    rng = np.random.default_rng(5)
    R, Kd = 4, 64
    mask = (rng.random((R, Kd)) < 0.5).astype(np.int32)
    words = rng.integers(0, 1 << 16, (R, Kd)).astype(np.int32)
    K = R * Kd
    mf = mask.reshape(-1) != 0
    rank = np.cumsum(mf) - mf
    rem = np.where(mf, np.arange(K) - rank, 0)
    buf = words.reshape(-1).copy()
    b = 1
    while b < K:
        mv = (rem & b) != 0
        buf = np.where(mv, np.roll(buf, b), buf)
        rem = np.where(mv, rem - b, rem)
        b *= 2
    got = pp.expand(torch.from_numpy(mask), torch.from_numpy(words))
    np.testing.assert_array_equal(got.numpy().reshape(-1), buf)


@pytest.mark.parametrize("shift", [0, 3, 1023, 1024, 1027, -3])
def test_dynroll_plain_equals_the_pallas_kernel(jax_kernels, shift):
    """Shifts outside [0, Kd) as interpret mode takes them: modulo Kd."""
    x = np.random.default_rng(shift % 7).integers(0, 1 << 16, (pp.R, pp.KD)).astype(np.int32)
    s = np.array([shift], np.int32)
    want = _run(jax_kernels["dynroll"], x, s)
    got = pp.dynroll(torch.from_numpy(x), torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), want)


def test_expand_refuses_shapes_it_cannot_roll_flat():
    with pytest.raises(ValueError, match="power of two"):
        pp.expand(torch.zeros((8, 1000), dtype=torch.int32), torch.zeros((8, 1000), dtype=torch.int32))
    with pytest.raises(ValueError, match="power of two"):
        pp.expand(torch.zeros((32, 1024), dtype=torch.int32), torch.zeros((32, 1024), dtype=torch.int32))


def k7_mirror(mask: np.ndarray, words: np.ndarray) -> np.ndarray:
    """K7 as csrc/perm_probe.cu computes it, in numpy: thread t of each
    of expand_geometry(K)'s blocks reads position e * T + t of each
    segment e; each warp's set lanes of a segment are a ballot, whose count
    goes to entry e * 32 + w of a flat array; warp 0 turns that array into
    exclusive prefixes, lane l summing its E entries from l * E and then
    taking a Hillis-Steele scan of the lane sums (__shfl_up_sync: lane l
    adds lane l - o where l >= o); a position's rank is its entry plus the
    ballot's lower lanes; d is kept as 16 bits; then each
    position (block e walks segment e) steps q back by b, for b from the
    highest power of two below K down to 1, where d[q] has bit b, reading
    d[q] again only after q moved, and takes words[q]. d[q] <= q, so q
    never passes 0: the passes' flat roll never wraps."""
    K = mask.size
    E, T = pp.expand_geometry(K)
    W = T // 32
    assert T % 32 == 0 and 32 <= T <= 1024 and E & (E - 1) == 0 and T * E >= K
    flags = np.zeros(E * T, np.int64)
    flags[:K] = mask.reshape(-1) != 0
    ballot = flags.reshape(E, W, 32)  # [segment, warp, lane]
    count = np.zeros((E, 32), np.int64)  # entries of warps >= W read as 0
    count[:, :W] = ballot.sum(2)
    v = count.reshape(32, E)  # lane l's E entries
    inc = v.sum(1)
    for o in (1, 2, 4, 8, 16):
        inc[o:] += inc[:-o].copy()
    base = ((inc - v.sum(1))[:, None] + np.cumsum(v, 1) - v).reshape(E, 32)
    rank = base[:, :W, None] + np.cumsum(ballot, 2) - ballot
    pos = np.arange(E * T).reshape(E, W, 32)
    d = np.where(ballot != 0, pos - rank, 0).reshape(-1)
    assert d[K:].max(initial=0) == 0 and d.min() >= 0 and d.max() < 1 << 16
    ds = d[:K].astype(np.uint16)
    q = np.arange(K)
    dq = ds.astype(np.int64)  # each position's own d, kept in registers
    b = 1 << (K - 1).bit_length() - 1 if K > 1 else 0
    while b:
        moved = (dq & b) != 0
        q = np.where(moved, q - b, q)
        assert q.min() >= 0
        dq = np.where(moved, ds[q], dq)
        b >>= 1
    return words.reshape(-1)[q].reshape(words.shape)


@pytest.mark.parametrize("density", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k7_mirror_equals_plain_and_the_pallas_kernel(jax_kernels, density, seed):
    rng = np.random.default_rng(seed)
    mask = (rng.random((pp.R, pp.KD)) < density).astype(np.int32)
    words = rng.integers(0, 1 << 16, (pp.R, pp.KD)).astype(np.int32)
    got = k7_mirror(mask, words)
    np.testing.assert_array_equal(got, _run(jax_kernels["expand"], mask, words))
    np.testing.assert_array_equal(
        got, pp.expand_plain(torch.from_numpy(mask), torch.from_numpy(words)).numpy())


@pytest.mark.parametrize("R,Kd", [(16, 1024), (3, 32), (1, 64), (1, 16384), (5, 2), (3, 1)])
def test_k7_mirror_equals_plain(R, Kd):
    """16 segments of 1024 threads, one segment of fewer, a last warp that
    is part empty."""
    rng = np.random.default_rng(R * Kd)
    mask = (rng.random((R, Kd)) < 0.5).astype(np.int32)
    words = rng.integers(0, 1 << 16, (R, Kd)).astype(np.int32)
    np.testing.assert_array_equal(
        k7_mirror(mask, words),
        pp.expand_plain(torch.from_numpy(mask), torch.from_numpy(words)).numpy())


def test_expand_geometry():
    assert pp.expand_geometry(8192) == (8, 1024)
    assert pp.expand_geometry(16384) == (16, 1024)
    assert pp.expand_geometry(4096) == (4, 1024)
    assert pp.expand_geometry(1024) == (1, 1024)
    assert pp.expand_geometry(96) == (1, 96)
    assert pp.expand_geometry(3) == (1, 32)
    assert pp.expand_geometry(4100) == (8, 1024)  # segments 5-7 empty


def _i32(shape, device, **kw):
    return torch.zeros(shape, dtype=kw.pop("dtype", torch.int32), device=device)


# (what, mask, words, error) for K7; every refusal holds on each device
EXPAND_REFUSALS = {
    "rank": (lambda d: _i32((8, 4, 32), d), lambda d: _i32((8, 4, 32), d), ValueError),
    "shapes differ": (lambda d: _i32((8, 64), d), lambda d: _i32((8, 32), d), ValueError),
    "dtype": (lambda d: _i32((8, 32), d, dtype=torch.int64), lambda d: _i32((8, 32), d),
              TypeError),
    "words dtype": (lambda d: _i32((8, 32), d), lambda d: _i32((8, 32), d, dtype=torch.float32),
                    TypeError),
    "non-contiguous": (lambda d: _i32((32, 8), d).t(), lambda d: _i32((8, 32), d), TypeError),
    "other device": (lambda d: _i32((8, 32), "meta" if d == "cpu" else "cpu"),
                     lambda d: _i32((8, 32), d), ValueError),
}


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("case", list(EXPAND_REFUSALS))
def test_expand_refuses(device, case):
    mask, words, err = EXPAND_REFUSALS[case]
    kernels.reset_launch_counts()
    with pytest.raises(err):
        pp.expand(mask(device), words(device))
    assert kernels.launch_counts()["expand"] == 0


DYNROLL_REFUSALS = {
    "rank": (lambda d: _i32((8,), d), lambda d: _i32((1,), d), ValueError),
    "shift size": (lambda d: _i32((8, 32), d), lambda d: _i32((2,), d), ValueError),
    "dtype": (lambda d: _i32((8, 32), d, dtype=torch.int64), lambda d: _i32((1,), d),
              TypeError),
    "shift dtype": (lambda d: _i32((8, 32), d), lambda d: _i32((1,), d, dtype=torch.int64),
                    TypeError),
    "non-contiguous": (lambda d: _i32((32, 8), d).t(), lambda d: _i32((1,), d), TypeError),
    "shift on another device": (lambda d: _i32((8, 32), d),
                                lambda d: _i32((1,), "meta" if d == "cpu" else "cpu"),
                                ValueError),
}


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("case", list(DYNROLL_REFUSALS))
def test_dynroll_refuses(device, case):
    x, shift, err = DYNROLL_REFUSALS[case]
    kernels.reset_launch_counts()
    with pytest.raises(err):
        pp.dynroll(x(device), shift(device))
    assert kernels.launch_counts()["dynroll"] == 0


@pytest.mark.parametrize("fn,args", [
    (pp.expand, lambda: (_i32((8, 32), "meta"), _i32((8, 32), "meta"))),
    (pp.dynroll, lambda: (_i32((8, 32), "meta"), _i32((1,), "meta"))),
])
def test_meta_tensors_that_pass_the_checks_are_refused(fn, args):
    """Neither wrapper computes on a device that is neither the CPU nor a
    card."""
    with pytest.raises(ValueError, match="unsupported device"):
        fn(*args())


def test_xla_probe_counterparts_match_jax():
    """take (fill) and scatter (drop), negative and out-of-range indexes
    included, and the packed-key sort, against the JAX calls of the probe."""
    rng = np.random.default_rng(3)
    n = 1000
    v = rng.integers(0, 1 << 15, n).astype(np.int32)
    p = rng.integers(-1200, 1200, n).astype(np.int32)
    want_take = np.asarray(jnp.take(jnp.asarray(v), jnp.asarray(p), mode="fill", fill_value=0))
    np.testing.assert_array_equal(pp.take_fill(torch.from_numpy(v), torch.from_numpy(p)).numpy(),
                                  want_take)
    q = rng.permutation(n).astype(np.int32)
    q[::7] += 5000  # dropped
    q[3::11] -= n   # negative, counted from the end
    want_sc = np.asarray(jnp.zeros_like(jnp.asarray(v)).at[jnp.asarray(q)].set(jnp.asarray(v), mode="drop"))
    np.testing.assert_array_equal(pp.scatter_drop(torch.from_numpy(v), torch.from_numpy(q)).numpy(),
                                  want_sc)
    idx = rng.integers(0, pp.NCDFS, n).astype(np.int32)
    skey = np.sort((idx.astype(np.int64) << 22) | np.arange(n))
    s, perm = pp.packed_sort(torch.from_numpy(idx))
    np.testing.assert_array_equal(s.numpy(), skey >> 22)
    np.testing.assert_array_equal(perm.numpy(), skey & ((1 << 22) - 1))


def test_main_on_the_cpu_runs_the_plain_versions():
    kernels.reset_launch_counts()
    res = pp.main(device="cpu", n=20000, iters=1)
    assert res["dynroll_matches"]
    assert set(res["ms"]) >= {"expansion kernel (K7)", "sort+take+scatter"}
    counts = kernels.launch_counts()
    assert counts["expand"] == 0 and counts["dynroll"] == 0  # no kernel on the CPU
