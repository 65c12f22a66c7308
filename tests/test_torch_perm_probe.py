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
