"""Entropy-side calibration of the port against the JAX package's, on
``vaeformer_tiny`` from the same flax init, 5 steps with the same
shape-keyed noise in both packages (the packages' own noise draws cannot
match). Tolerances: the fitted h_a/h_s/EntropyBottleneck parameters
within 1e-4 of each leaf's largest entry, and the bits per latent element
within rtol 1e-5, float32 on both sides with sums in other orders; the
towers bitwise unchanged. The cache test holds a second call to the
stored fit bitwise."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cra5_tpu.entropy.entropy_bottleneck as j_ebm
import cra5_tpu.entropy.gaussian_conditional as j_gcm
from cra5_tpu.entropy import ops as j_ops
from cra5_tpu.models.vaeformer import VAEformer as JVAEformer
from cra5_tpu.models.vaeformer import vaeformer_tiny as j_tiny
from cra5_tpu.train.calibrate import calibrate_entropy as j_calibrate
from cra5_tpu_torch.convert import load_flax_variables
from cra5_tpu_torch.entropy import entropy_bottleneck as ebm
from cra5_tpu_torch.entropy import gaussian_conditional as gcm
from cra5_tpu_torch.entropy import ops
from cra5_tpu_torch.models.vaeformer import VAEformer, vaeformer_tiny
from cra5_tpu_torch.train import TRAINABLE, calibrate_entropy, calibrate_entropy_cached
from cra5_tpu_torch.train.calibrate import _cache_key

STEPS = 5


def _shape_noise(shape):
    seed = int(np.prod([int(s) + 11 for s in shape])) % (2**31)
    return np.random.default_rng(seed).uniform(-0.5, 0.5, size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def noise_patch():
    mp = pytest.MonkeyPatch()

    def jq(inputs, mode, means=None, rng=None):
        if mode == "noise":
            return inputs + jnp.asarray(_shape_noise(inputs.shape)).astype(inputs.dtype)
        return j_ops.quantize(inputs, mode, means=means, rng=rng)

    def tq(inputs, mode, means=None, generator=None):
        if mode == "noise":
            return inputs + torch.from_numpy(_shape_noise(tuple(inputs.shape))).to(inputs.dtype)
        return ops.quantize(inputs, mode, means=means, generator=generator)

    for mod in (j_ebm, j_gcm):
        mp.setattr(mod, "quantize", jq)
    for mod in (ebm, gcm):
        mp.setattr(mod, "quantize", tq)
    yield
    mp.undo()


def _bpe(out, n_el):
    return float(sum(-np.sum(np.log2(np.asarray(l, np.float64))) for l in
                     out["likelihoods"].values()) / n_el)


@pytest.fixture(scope="module")
def fits(noise_patch):
    """The flax init of vaeformer_tiny, two latents, and both packages'
    5-step fits from them."""
    cfg = j_tiny()
    x = np.random.default_rng(5).standard_normal((1, cfg.in_chans, *cfg.img_size)).astype(
        np.float32)
    jmodel = JVAEformer(cfg)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    rng = np.random.default_rng(9)
    lats = [rng.standard_normal((1, cfg.embed_dim, *cfg.latent_grid)).astype(np.float32) * 3
            for _ in range(2)]
    jfit = jax.device_get(j_calibrate(jmodel, variables, [jnp.asarray(y) for y in lats],
                                      steps=STEPS))
    yb = np.concatenate(lats)
    rate = lambda v: jmodel.apply(v, jnp.asarray(yb), jax.random.PRNGKey(0),
                                  method=JVAEformer.entropy_rate)
    model = load_flax_variables(VAEformer(vaeformer_tiny(), device="cpu"), variables)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    res = calibrate_entropy(model, [torch.from_numpy(y) for y in lats], steps=STEPS)
    with torch.no_grad():
        got_end = _bpe(model.entropy_rate(torch.from_numpy(yb), torch.Generator()), yb.size)
    return dict(variables=variables, jfit=jfit, lats=lats, model=model, before=before, res=res,
                j_first=_bpe(rate(variables), yb.size), j_end=_bpe(rate(jfit), yb.size),
                got_end=got_end)


@pytest.mark.parametrize("prefix", TRAINABLE)
def test_fitted_entropy_side_matches_jax(fits, prefix):
    want = dict(load_flax_variables(VAEformer(vaeformer_tiny(), device="cpu"),
                                    fits["jfit"]).named_parameters())
    moved = 0.0
    for name, p in fits["model"].named_parameters():
        if name.split(".")[0] != prefix:
            continue
        w = want[name].detach()
        bound = 1e-4 * float(w.abs().max())
        assert float((p.detach() - w).abs().max()) <= bound, name
        moved = max(moved, float((p.detach() - fits["before"][name]).abs().max()))
    assert moved > 0


def test_bits_per_element_match_jax_and_fall(fits):
    res = fits["res"]
    assert res["steps"] == STEPS
    assert res["bpe_first"] == pytest.approx(fits["j_first"], rel=1e-5)
    assert fits["got_end"] == pytest.approx(fits["j_end"], rel=1e-5)
    assert fits["got_end"] < res["bpe_first"]


def test_towers_do_not_move_or_get_gradients(fits):
    for name, p in fits["model"].named_parameters():
        if name.split(".")[0] not in TRAINABLE:
            assert p.grad is None and torch.equal(p.detach(), fits["before"][name]), name


def test_cached_call_returns_the_stored_fit(fits, tmp_path):
    """A first cached call fits and writes the fit; a second, on a fresh
    model of the same init, reads it and ends bitwise equal to the first;
    a model of another dtype has another key and fits anew."""
    lats = [torch.from_numpy(y) for y in fits["lats"]]
    fresh = lambda dtype=torch.float32: load_flax_variables(
        VAEformer(vaeformer_tiny(), dtype=dtype, device="cpu"), fits["variables"])
    a, b = fresh(), fresh()
    first = calibrate_entropy_cached(a, lats, str(tmp_path), steps=STEPS)
    assert first["cached"] is False and os.path.exists(first["path"])
    second = calibrate_entropy_cached(b, lats, str(tmp_path), steps=STEPS)
    assert second == {"cached": True, "path": first["path"]}
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    bf = fresh(torch.bfloat16)
    assert _cache_key(bf, STEPS, 2) != _cache_key(a, STEPS, 2) != _cache_key(a, STEPS + 1, 2)
    third = calibrate_entropy_cached(bf, lats, str(tmp_path), steps=STEPS)
    assert third["cached"] is False and third["path"] != first["path"]
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(r["path"]) for r in (first, third))
