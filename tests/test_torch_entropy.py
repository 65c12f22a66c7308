"""Port vs JAX: the entropy side (CDF tables, GC indexes, quantization).

Every comparison here is exact: the tables, indexes and symbols decide
the bytes of a stream."""

import hashlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cra5_tpu.entropy import cdf as j_cdf
from cra5_tpu.entropy import entropy_bottleneck as j_eb
from cra5_tpu.entropy import gaussian_conditional as j_gc
from cra5_tpu.entropy import ops as j_ops
from cra5_tpu_torch.entropy import (
    EntropyBottleneck,
    eb_params_from_variables,
    build_indexes,
    eb_update,
    gc_update,
    get_scale_table,
    pmf_to_quantized_cdf,
    quantize,
)

GOLDEN = Path(__file__).parent / "goldens" / "fullgeom_entropy.npz"


def _tables_equal(a, b):
    return (np.array_equal(a.quantized_cdf, b.quantized_cdf)
            and np.array_equal(a.cdf_length, b.cdf_length)
            and np.array_equal(a.offset, b.offset))


@pytest.mark.parametrize("n,zeros", [(5, 0), (40, 7), (300, 120)])
def test_pmf_to_quantized_cdf_exact(rng, n, zeros):
    """Random pmfs, including zero-frequency bins that need the repair."""
    pmf = rng.random(n).astype(np.float32)
    pmf[rng.choice(n, zeros, replace=False)] = 0.0
    pmf[0] += 0.5
    pmf /= pmf.sum()
    np.testing.assert_array_equal(
        pmf_to_quantized_cdf(pmf), j_cdf.pmf_to_quantized_cdf(pmf))


def test_gc_update_matches_jax_and_golden():
    """Exactly the JAX table. Against the golden, which the torch reference
    built, lengths and offsets are equal and 63 of 64 rows too; row 57
    differs by at most 2 counts in both packages (their pmfs are float64)."""
    g = np.load(GOLDEN)
    port = gc_update(get_scale_table())
    assert _tables_equal(port, j_gc.gc_update(j_gc.get_scale_table()))
    diff = np.abs(port.quantized_cdf.astype(np.int64) - g["gc_cdf"])
    assert set(np.nonzero(diff)[0]) == {57} and diff.max() <= 2
    np.testing.assert_array_equal(port.cdf_length, g["gc_len"])
    np.testing.assert_array_equal(port.offset, g["gc_off"])
    np.testing.assert_array_equal(get_scale_table(), j_gc.get_scale_table())
    # the reference's float32 table differs in the last bits only
    np.testing.assert_allclose(get_scale_table(), g["scale_table"], rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_eb_update_matches_jax(seed):
    """eb_update on perturbed EB parameters (init plus noise, quantiles
    moved off the integers) gives the JAX integers exactly."""
    r = np.random.default_rng(seed)
    eb = EntropyBottleneck(12, device="cpu")
    eb.reset_parameters(torch.Generator().manual_seed(seed))
    params = {k: v + r.normal(0, 0.3, v.shape).astype(np.float32)
              for k, v in eb.params_numpy().items()}
    assert _tables_equal(eb_update(params), j_eb.eb_update(params))


def test_build_indexes_matches_jax_incl_table_entries(rng):
    table = get_scale_table()
    scales = np.concatenate([
        np.exp(rng.uniform(np.log(0.01), np.log(400.0), 5000)),
        table, np.nextafter(table, 0), np.nextafter(table, 1e9), [0.11, 0.0, -3.0],
    ]).astype(np.float32)
    want = np.asarray(j_gc.build_indexes(jnp.asarray(scales), jnp.asarray(table)))
    got = build_indexes(torch.from_numpy(scales), torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(got, want)
    # a scale exactly on entry i maps to row i
    np.testing.assert_array_equal(got[5000:5064], np.arange(64))


def test_build_indexes_fullgeom_golden_sha():
    """The 2.65 M full-geometry GC indexes hash to the reference's."""
    g = np.load(GOLDEN)
    rng = np.random.default_rng(int(g["rng_seed"]))
    rng.normal(size=(1, 256, 18, 36))  # z draw, as the golden's generator
    scales = np.exp(
        rng.uniform(np.log(0.12), np.log(12.0), size=(1, 256, 72, 144))
    ).astype(np.float32)
    idx = build_indexes(torch.from_numpy(scales), torch.from_numpy(g["scale_table"]))
    digest = hashlib.sha256(idx.numpy().astype(np.int32).tobytes()).digest()
    assert digest == g["y_idx_sha"].tobytes()


@pytest.mark.parametrize("mode", ["dequantize", "symbols"])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_matches_jax(rng, mode, dtype):
    """Half-integers included: both round half to even."""
    x = np.concatenate([rng.normal(0, 20, 2000), np.arange(-10, 10) + 0.5]).astype(np.float32)
    means = rng.normal(0, 3, x.shape).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    want = j_ops.quantize(jnp.asarray(x, jd), mode, means=jnp.asarray(means, jd))
    got = quantize(torch.from_numpy(x).to(td), mode, means=torch.from_numpy(means).to(td))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_eb_params_from_variables_matches_jax(rng):
    """The EB params read from a flax variables tree (nested numpy dicts)
    give the JAX codec's z table."""
    eb = EntropyBottleneck(6, device="cpu")
    eb.reset_parameters(torch.Generator().manual_seed(2))
    leaves = {k: v + rng.normal(0, 0.2, v.shape).astype(np.float32)
              for k, v in eb.params_numpy().items()}
    variables = {"params": {"entropy_bottleneck": leaves, "other": {"kernel": np.zeros(2)}}}
    got = eb_params_from_variables(variables, "entropy_bottleneck")
    want = j_eb.eb_params_from_variables(variables, "entropy_bottleneck")
    assert sorted(got) == sorted(want)
    assert _tables_equal(eb_update(got), j_eb.eb_update(want))


@pytest.mark.parametrize("means", [False, True])
def test_dequantize_matches_jax(rng, means):
    from cra5_tpu_torch.entropy import dequantize

    sym = rng.integers(-50, 50, (2, 3, 4, 5)).astype(np.int32)
    mu = rng.standard_normal((2, 3, 4, 5)).astype(np.float32) if means else None
    want = j_ops.dequantize(jnp.asarray(sym), None if mu is None else jnp.asarray(mu))
    got = dequantize(torch.from_numpy(sym), None if mu is None else torch.from_numpy(mu))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("h,w,kw", [(512, 768, dict(min_div=64)), (1365, 2048, dict(min_div=64)),
                                    (37, 51, dict(min_div=16)), (64, 64, {}),
                                    (30, 40, dict(out_h=64, out_w=48, min_div=16))])
def test_compute_padding_matches_jax(h, w, kw):
    from cra5_tpu_torch.entropy import compute_padding

    assert compute_padding(h, w, **kw) == j_ops.compute_padding(h, w, **kw)
    with pytest.raises(ValueError):
        compute_padding(10, 10, out_h=20, out_w=20, min_div=16)
