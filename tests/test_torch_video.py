"""Port vs JAX: ScaleSpaceFlow's building blocks and its forward
(models/video.py) on the CPU.

The blur, the Gaussian volume and the trilinear warp are held against the
JAX functions on seeded inputs, float32, within VOL_RTOL x max|ref| (the
summation order of the blur and of the resize contraction is all that
differs); level 0 of the volume is exact. The model runs at the smallest
geometry the codec takes (3 frames of 128 x 128, planes = mid = 8, two
levels) with the port's seeded weights carried into the flax tree
(tests/_torch_pairs.py): the eval forward's x_hat and every likelihood,
aux_loss, the training forward under shared noise and the gradients of a
rate-distortion loss through it (the warp's gather included) against
jax.grad, each within the stated bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cra5_tpu.entropy.entropy_bottleneck as j_ebm
import cra5_tpu.entropy.gaussian_conditional as j_gcm
from cra5_tpu.entropy import ops as j_ops
from cra5_tpu.models import video as J
from cra5_tpu_torch.convert import to_flax_params
from cra5_tpu_torch.entropy import entropy_bottleneck as ebm
from cra5_tpu_torch.entropy import gaussian_conditional as gcm
from cra5_tpu_torch.entropy import ops
from cra5_tpu_torch.models import video as P

from _torch_pairs import close, np_, one_thread, pair  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

VOL_RTOL = 2e-6  # x max|ref|: blur and resize sums in another order
GRAD_RTOL = 1e-4  # x max|ref| of each parameter's gradient
SSF = dict(num_levels=2, mid_planes=8, planes=8)
CLIP = (3, 1, 3, 128, 128)


def _clip(shape=CLIP, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.fixture(scope="module")
def ssf():
    """(JAX model, its variables, the port model with the same weights)."""
    return pair(lambda: J.ScaleSpaceFlow(**SSF),
                lambda: P.ScaleSpaceFlow(**SSF, device="cpu"), CLIP)


def test_gaussian_blur_matches_jax():
    x = np.random.default_rng(1).normal(size=(2, 3, 13, 22)).astype(np.float32)
    k = P._gaussian_kernel1d(1.5)
    want = np.asarray(J.gaussian_blur(jnp.asarray(x), jnp.asarray(k)))
    got = P.gaussian_blur(torch.from_numpy(x), torch.from_numpy(k))
    close(got, want, "blur", VOL_RTOL)


@pytest.mark.parametrize("shape,levels", [((2, 3, 20, 28), 4), ((1, 2, 24, 40), 3),
                                          ((1, 3, 16, 16), 3)])
def test_gaussian_volume_matches_jax(shape, levels):
    """Level 0 exactly the input; every level within VOL_RTOL. 20 x 28 over
    four levels pools 20 -> 10 -> 5 -> 2 (an odd level, floored) and
    resizes 10, 5 and 2 rows back to 20."""
    x = np.random.default_rng(2).random(shape).astype(np.float32)
    want = np.asarray(J.gaussian_volume(jnp.asarray(x), 1.5, levels))
    got = P.gaussian_volume(torch.from_numpy(x), 1.5, levels)
    assert tuple(got.shape) == want.shape == (*shape[:2], levels + 1, *shape[2:])
    np.testing.assert_array_equal(np_(got[:, :, 0]), x)
    for lvl in range(levels + 1):
        close(got[:, :, lvl], want[:, :, lvl], f"level {lvl}", VOL_RTOL)


def test_resize_is_jax_image_resize():
    x = np.random.default_rng(3).random((2, 3, 5, 7)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, 20, 28), method="bilinear"))
    close(P.resize_bilinear(torch.from_numpy(x), (20, 28)), want, "resize", VOL_RTOL)


def test_warp_identity_at_level_zero():
    """Zero flow at scale level 0 gives back the input."""
    x = np.random.default_rng(4).random((1, 3, 8, 8)).astype(np.float32)
    vol = P.gaussian_volume(torch.from_numpy(x), 1.5, 2)
    L = vol.shape[2]
    out = P.warp_volume_3d(vol, torch.zeros(1, 2, 8, 8), torch.full((1, 1, 8, 8), 1.0 / L - 1.0))
    np.testing.assert_allclose(np_(out), x, atol=1e-5)


@pytest.mark.parametrize("N,H,W,L", [(2, 12, 20, 4), (1, 9, 7, 6)])
def test_warp_matches_jax_past_the_borders(N, H, W, L):
    """Flows of up to 1.5x the normalized extent and scales past both ends
    of the volume: the indexes clamp (border padding) as JAX's do."""
    rng = np.random.default_rng(5)
    vol = rng.normal(size=(N, 3, L, H, W)).astype(np.float32)
    flow = rng.uniform(-1.5, 1.5, size=(N, 2, H, W)).astype(np.float32)
    scale = rng.uniform(-1.4, 1.4, size=(N, 1, H, W)).astype(np.float32)
    want = np.asarray(J.warp_volume_3d(*map(jnp.asarray, (vol, flow, scale))))
    got = P.warp_volume_3d(*map(torch.from_numpy, (vol, flow, scale)))
    close(got, want, "warp", VOL_RTOL)


def test_warp_gradients_match_jax():
    """d/d(volume, flow, scale) of a weighted sum of the warp, the gather's
    scatter included."""
    rng = np.random.default_rng(6)
    vol = rng.normal(size=(1, 2, 3, 10, 12)).astype(np.float32)
    flow = rng.uniform(-1.2, 1.2, size=(1, 2, 10, 12)).astype(np.float32)
    scale = rng.uniform(-1.2, 1.2, size=(1, 1, 10, 12)).astype(np.float32)
    wts = rng.normal(size=(1, 2, 10, 12)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(J.warp_volume_3d(*a) * wts), argnums=(0, 1, 2))(
        *map(jnp.asarray, (vol, flow, scale)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (vol, flow, scale)]
    (P.warp_volume_3d(*ts) * torch.from_numpy(wts)).sum().backward()
    for t, w, name in zip(ts, want, ("volume", "flow", "scale")):
        close(t.grad, np.asarray(w), name, VOL_RTOL * 10)


def test_hyperprior_matches_jax(ssf):
    jm, v, pm = ssf
    y = np.random.default_rng(7).normal(size=(2, 8, 16, 16)).astype(np.float32) * 3
    hv = {"params": v["params"]["motion_hyperprior"]}
    jh = J.Hyperprior(8, 8)
    y_hat, lk = jax.jit(jh.apply)(hv, jnp.asarray(y))
    with torch.no_grad():
        got, glk = pm.motion_hyperprior(torch.from_numpy(y))
    close(got, y_hat, "y_hat")
    for k in ("y", "z"):
        close(glk[k], lk[k], k)
    sym = jax.jit(lambda a, b: jh.apply(a, b, method=J.Hyperprior.symbols))(hv, jnp.asarray(y))
    with torch.no_grad():
        gsym = pm.motion_hyperprior.symbols(torch.from_numpy(y))
        params = pm.motion_hyperprior.params_from_z_symbols(gsym["z_sym"])
    for k in ("y_sym", "z_sym"):
        np.testing.assert_array_equal(np_(gsym[k]).astype(np.int32), np.asarray(sym[k]))
    for k in ("scales", "means", "y_hat"):
        close(gsym[k], sym[k], k)
    want = jh.apply(hv, sym["z_sym"], method=J.Hyperprior.params_from_z_symbols)
    for g, w, k in zip(params, want, ("scales", "means")):
        close(g, w, k)
    assert gsym["z_shape"] == tuple(sym["z_shape"]) == (2, 2)


def test_forward_matches_jax(ssf):
    """The eval forward over a 3-frame clip: x_hat and every likelihood of
    every frame, and aux_loss."""
    jm, v, pm = ssf
    frames = _clip(seed=8)
    want = jax.jit(jm.apply)(v, jnp.asarray(frames))
    with torch.no_grad():
        got = pm(torch.from_numpy(frames))
    close(got["x_hat"], want["x_hat"], "x_hat")
    assert [set(lk) for lk in got["likelihoods"]] == [{"keyframe"}, {"motion", "residual"},
                                                      {"motion", "residual"}]
    for t, (g, w) in enumerate(zip(got["likelihoods"], want["likelihoods"])):
        for part in g:
            for k in ("y", "z"):
                close(g[part][k], w[part][k], f"frame {t} {part} {k}")
    close(pm.aux_loss().detach(), jm.apply(v, method=J.ScaleSpaceFlow.aux_loss), "aux_loss")


def _shape_noise(shape):
    seed = int(np.prod([int(s) + 13 for s in shape])) % (2**31)
    return np.random.default_rng(seed).uniform(-0.5, 0.5, size=shape).astype(np.float32)


@pytest.fixture
def noise_patch(monkeypatch):
    """The same shape-keyed noise in both packages (their own draws cannot
    agree: a JAX key split and a torch generator)."""
    def jq(inputs, mode, means=None, rng=None):
        if mode == "noise":
            return inputs + jnp.asarray(_shape_noise(inputs.shape)).astype(inputs.dtype)
        return j_ops.quantize(inputs, mode, means=means, rng=rng)

    def tq(inputs, mode, means=None, generator=None):
        if mode == "noise":
            return inputs + torch.from_numpy(_shape_noise(tuple(inputs.shape))).to(inputs.dtype)
        return ops.quantize(inputs, mode, means=means, generator=generator)

    for mod in (j_ebm, j_gcm):
        monkeypatch.setattr(mod, "quantize", jq)
    for mod in (ebm, gcm):
        monkeypatch.setattr(mod, "quantize", tq)


def _rd_loss_terms(x_hat, likelihoods, frames, lk_log, n_pix):
    bpp = sum(lk_log(l).sum() for f in likelihoods for part in f.values() for l in part.values())
    return -bpp / (np.log(2.0) * n_pix), ((x_hat - frames) ** 2).mean()


def test_training_forward_and_gradients_match_jax(ssf, noise_patch):
    """Under shared noise, on a 2-frame clip (a keyframe and an inter
    frame): the training forward's x_hat and likelihoods,
    and the gradients of bpp + 64 x mse w.r.t. every parameter against
    jax.grad, each leaf within GRAD_RTOL x its max |ref|."""
    jm, v, pm = ssf
    frames = _clip((2, 1, 3, 128, 128), seed=9)
    n_pix = frames.shape[0] * frames.shape[1] * frames.shape[-2] * frames.shape[-1]
    rng = jax.random.PRNGKey(0)

    def j_loss(params):
        out = jm.apply({"params": params}, jnp.asarray(frames), training=True, rng=rng)
        bpp, mse = _rd_loss_terms(out["x_hat"], out["likelihoods"], jnp.asarray(frames),
                                  jnp.log, n_pix)
        return bpp + 64.0 * mse, out

    (j_val, j_out), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(v["params"])
    pm.zero_grad(set_to_none=True)
    out = pm(torch.from_numpy(frames), training=True, generator=torch.Generator())
    bpp, mse = _rd_loss_terms(out["x_hat"], out["likelihoods"], torch.from_numpy(frames),
                              torch.log, n_pix)
    loss = bpp + 64.0 * mse
    loss.backward()
    close(out["x_hat"].detach(), j_out["x_hat"], "training x_hat")
    for g, w in zip(out["likelihoods"], j_out["likelihoods"]):
        for part in g:
            for k in ("y", "z"):
                close(g[part][k].detach(), w[part][k], f"training {part} {k}")
    close(loss.detach(), j_val, "loss")
    got = to_flax_params(pm, {n: p.grad if p.grad is not None else torch.zeros_like(p)
                              for n, p in pm.named_parameters()})
    flat = lambda t, p="": {k2: v2 for k, x in t.items() for k2, v2 in (  # noqa: E731
        flat(x, f"{p}/{k}").items() if isinstance(x, dict) else [(f"{p}/{k}", x)])}
    got, want = flat(got), flat(jax.device_get(j_grads))
    assert set(got) == set(want)
    moved = 0
    for k in sorted(want):
        w = np.asarray(want[k])
        if not np.abs(w).max() > 0:
            assert np.abs(got[k]).max() == 0, k
            continue
        moved += 1
        close(got[k], w, f"grad {k}", GRAD_RTOL)
    assert moved > len(want) // 2
