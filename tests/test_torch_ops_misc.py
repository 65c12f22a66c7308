"""Port vs JAX: the small pieces of the serving slice, on the CPU.

``ops/rdoq.py`` equals JAX's ``rdoq`` exactly on seeded latents with
escapes on both sides, at three lambdas; ``CdfTable.validate`` raises where
JAX's raises (``AssertionError``, the same message) and passes where it
passes; ``coder/native.pmf_to_quantized_cdf_native`` equals JAX's native
builder and the Python ``pmf_to_quantized_cdf``; ``rate_distortion_loss``
equals JAX's within LOSS_RTOL (float32 sums in another order); and
``utils/profiling`` nests a trace, an annotation and a synchronising span."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cra5_tpu.coder import native as j_native
from cra5_tpu.entropy.cdf import CdfTable as JCdfTable
from cra5_tpu.entropy.cdf import pmf_to_quantized_cdf as j_pmf_to_quantized_cdf
from cra5_tpu.ops.rdoq import rdoq as j_rdoq
from cra5_tpu.train.loss import rate_distortion_loss as j_rate_distortion_loss
from cra5_tpu_torch.coder import native
from cra5_tpu_torch.entropy import gc_update, get_scale_table
from cra5_tpu_torch.entropy.cdf import CdfTable, pmf_to_quantized_cdf
from cra5_tpu_torch.ops.rdoq import rdoq
from cra5_tpu_torch.train.loss import rate_distortion_loss
from cra5_tpu_torch.utils.profiling import Timings, annotate, profile_trace

LOSS_RTOL = 1e-5  # float32 means of a few thousand terms, summed in another order


def _jtable(t: CdfTable) -> JCdfTable:
    return JCdfTable(quantized_cdf=t.quantized_cdf.copy(), cdf_length=t.cdf_length.copy(),
                     offset=t.offset.copy())


# ---------------------------------------------------------------- rdoq
@pytest.mark.parametrize("lmbda", [0.01, 0.3, 4.0])
def test_rdoq_equals_jax_exactly(lmbda):
    table = gc_update(get_scale_table())
    rng = np.random.default_rng(11)
    n = 6000
    idx = rng.integers(0, table.num_indexes, n).astype(np.int32)
    half = -table.offset[idx]  # each row codes [-half, half] before escaping
    x = rng.standard_normal(n) * (0.2 + half * 0.6)
    esc = rng.random(n) < 0.1  # a tenth past the row's range, on both sides
    x[esc] = np.sign(rng.standard_normal(esc.sum())) * (half[esc] + rng.uniform(1, 300, esc.sum()))
    x = x.astype(np.float32)
    got = rdoq(torch.from_numpy(x), torch.from_numpy(idx), table, lmbda)
    want = np.asarray(j_rdoq(jnp.asarray(x), jnp.asarray(idx), _jtable(table), lmbda))
    assert got.dtype == torch.int32 and got.shape == (n,)
    v = got.numpy() - table.offset[idx]
    assert (v < 0).any() and (v >= table.cdf_length[idx] - 2).any()  # escapes both ways
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != np.round(x)).any()  # the rate moved some symbols


# ---------------------------------------------------------------- CdfTable.validate
def _broken(kind: str) -> CdfTable:
    t = gc_update(get_scale_table()[:6])
    q = t.quantized_cdf.copy()
    if kind == "first":
        q[2, 0] = 1
    elif kind == "last":
        q[3, t.cdf_length[3] - 1] -= 1
    elif kind == "flat":
        q[4, 2] = q[4, 1]
    return CdfTable(quantized_cdf=q, cdf_length=t.cdf_length.copy(), offset=t.offset.copy())


@pytest.mark.parametrize("kind", ["valid", "first", "last", "flat"])
def test_cdf_validate_raises_where_jax_raises(kind):
    t = _broken(kind)
    if kind == "valid":
        t.validate()
        _jtable(t).validate()
        return
    with pytest.raises(AssertionError) as want:
        _jtable(t).validate()
    with pytest.raises(AssertionError) as got:
        t.validate()
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- native CDF
def test_native_cdf_builder_equals_jax_and_python():
    assert native.native_available() and j_native.native_available()
    rng = np.random.default_rng(2)
    for n in (1, 2, 7, 64, 1000):
        for zeros in (False, True):
            pmf = rng.random(n).astype(np.float32)
            if zeros and n > 2:
                pmf[rng.integers(0, n, n // 3)] = 0  # the zero-frequency repair
                pmf[0] = max(pmf[0], 0.5)
            pmf /= pmf.sum()
            got = native.pmf_to_quantized_cdf_native(pmf)
            assert got.dtype == np.int32 and got.shape == (n + 1,)
            np.testing.assert_array_equal(got, j_native.pmf_to_quantized_cdf_native(pmf))
            np.testing.assert_array_equal(got, pmf_to_quantized_cdf(pmf))
            np.testing.assert_array_equal(got, j_pmf_to_quantized_cdf(pmf))
    for bad in ([0.5, -0.1], [0.0, 0.0], [np.nan, 1.0]):
        with pytest.raises(ValueError):
            j_native.pmf_to_quantized_cdf_native(bad)
        with pytest.raises(ValueError, match="invalid pmf"):
            native.pmf_to_quantized_cdf_native(bad)


def test_native_cdf_builder_raises_without_its_library(monkeypatch):
    """No Python fallback: a library that does not build raises."""
    def no_gxx():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", no_gxx)
    assert not native.native_available()
    with pytest.raises(RuntimeError, match="g..? not found"):
        native.pmf_to_quantized_cdf_native([0.5, 0.5])


# ---------------------------------------------------------------- loss
def test_rate_distortion_loss_equals_jax():
    rng = np.random.default_rng(4)
    target = rng.standard_normal((2, 3, 16, 24)).astype(np.float32)
    out = {"x_hat": (target + 0.1 * rng.standard_normal(target.shape)).astype(np.float32),
           "likelihoods": {"y": rng.uniform(0.01, 1, (2, 8, 4, 6)).astype(np.float32),
                           "z": rng.uniform(0.01, 1, (2, 4, 2, 3)).astype(np.float32)}}
    t_out = {"x_hat": torch.from_numpy(out["x_hat"]),
             "likelihoods": {k: torch.from_numpy(v) for k, v in out["likelihoods"].items()}}
    j_out = {"x_hat": jnp.asarray(out["x_hat"]),
             "likelihoods": {k: jnp.asarray(v) for k, v in out["likelihoods"].items()}}
    for kw in ({}, {"lmbda": 0.3, "bpp_weight": 1.0}):
        got = rate_distortion_loss(t_out, torch.from_numpy(target), **kw)
        want = j_rate_distortion_loss(j_out, jnp.asarray(target), **kw)
        assert set(got) == set(want) == {"bpp_loss", "mse_loss", "loss"}
        for k in want:
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=LOSS_RTOL)


# ---------------------------------------------------------------- profiling
def test_timings_trace_and_annotation_nest(tmp_path):
    t = Timings()
    with profile_trace(str(tmp_path)):
        with annotate("outer"), t.span("a", block_on={"x": [torch.ones(3)]}):
            with t.span("a"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    with profile_trace(None), t.span("b"):
        pass
    assert set(t.as_dict()) == {"a", "b"} and t.as_dict()["a"] > 0
    traces = list(tmp_path.glob("*.json"))
    assert len(traces) == 1 and b"outer" in traces[0].read_bytes()
