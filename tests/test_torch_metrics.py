"""Port vs JAX: cra5_tpu_torch/metrics.py against cra5_tpu/metrics.py on
the same seeded numpy inputs, and the ms-ssim distortion of the port's
RateDistortionLoss against the JAX loss. float32 throughout; the
convolutions and sums differ in order only (1e-5 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cra5_tpu import metrics as jm
from cra5_tpu.train.loss import RateDistortionLoss as JRD
from cra5_tpu_torch import metrics as tm
from cra5_tpu_torch.train import RateDistortionLoss

t = torch.from_numpy
j = jnp.asarray


def _pair(seed, shape, noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    return a, np.clip(a + noise * rng.standard_normal(shape), 0, 1).astype(np.float32)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def test_mse_psnr_and_bpp():
    a, b = _pair(0, (2, 3, 20, 24))
    _close(tm.mse(t(a), t(b)), jm.mse(j(a), j(b)))
    _close(tm.psnr(t(a), t(b)), jm.psnr(j(a), j(b)))
    _close(tm.psnr(t(a), t(b), max_val=255.0), jm.psnr(j(a), j(b), max_val=255.0))
    lik = {"y": np.random.default_rng(1).random((1, 4, 5, 5)).astype(np.float32) + 0.01,
           "z": np.random.default_rng(2).random((1, 4, 2, 2)).astype(np.float32) + 0.01}
    _close(tm.bpp_from_likelihoods({k: t(v) for k, v in lik.items()}, 400),
           jm.bpp_from_likelihoods({k: j(v) for k, v in lik.items()}, 400))


@pytest.mark.parametrize("return_cs", [False, True])
def test_ssim(return_cs):
    a, b = _pair(3, (2, 3, 32, 40))
    got = tm.ssim(t(a), t(b), return_cs=return_cs)
    want = jm.ssim(j(a), j(b), return_cs=return_cs)
    for g, w in zip(got, want) if return_cs else ((got, want),):
        _close(g, w)


@pytest.mark.parametrize("weights,shape", [(None, (1, 2, 180, 190)), ((0.5, 0.3, 0.2), (2, 3, 50, 47))])
def test_ms_ssim(weights, shape):
    a, b = _pair(4, shape)
    kw = {} if weights is None else {"weights": weights}
    _close(tm.ms_ssim(t(a), t(b), **kw), jm.ms_ssim(j(a), j(b), **kw))


@pytest.mark.parametrize("per_channel", [False, True])
def test_weather_scores(per_channel):
    rng = np.random.default_rng(5)
    pred, target, clim = (rng.standard_normal((2, 3, 37, 16)).astype(np.float32) for _ in range(3))
    np.testing.assert_array_equal(tm.lat_weights(721), jm.lat_weights(721))
    np.testing.assert_array_equal(tm.lat_weights(720, endpoint=False), jm.lat_weights(720, endpoint=False))
    _close(tm.wrmse(t(pred), t(target), per_channel=per_channel),
           jm.wrmse(j(pred), j(target), per_channel=per_channel))
    w = rng.random(37).astype(np.float32)
    _close(tm.wrmse(t(pred), t(target), weights=t(w)), jm.wrmse(j(pred), j(target), weights=j(w)))
    _close(tm.mean_abs_error(t(pred), t(target), per_channel=per_channel),
           jm.mean_abs_error(j(pred), j(target), per_channel=per_channel))
    _close(tm.acc(t(pred), t(target), t(clim), per_channel=per_channel),
           jm.acc(j(pred), j(target), j(clim), per_channel=per_channel))


def test_ms_ssim_rate_distortion_loss_equals_jax():
    a, b = _pair(6, (1, 2, 48, 52))
    lik = {"y": np.random.default_rng(7).random((1, 4, 5, 5)).astype(np.float32) + 0.01}
    weights = (0.6, 0.4)
    got = RateDistortionLoss(lmbda=0.3, metric="ms-ssim", ms_ssim_weights=weights)(
        {"x_hat": t(b), "likelihoods": {k: t(v) for k, v in lik.items()}}, t(a))
    want = JRD(lmbda=0.3, metric="ms-ssim", ms_ssim_weights=weights)(
        {"x_hat": j(b), "likelihoods": {k: j(v) for k, v in lik.items()}}, j(a))
    assert set(got) == set(want) == {"bpp_loss", "ms_ssim_loss", "loss"}
    for k in want:
        _close(got[k], want[k])
