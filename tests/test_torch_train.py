"""Port vs JAX: the training slice on the CPU.

The same seed-made numpy inputs go through the JAX function and its port:
the STE ops, the entropy models' likelihoods and losses with their
gradients, the posterior's KL/NLL and sample, the losses (learned
log-variance and KL-weighted), the flash-attention backward (the JAX
kernels in interpret mode, as tests/test_flash_attention.py runs them), the
schedules, and a 5-step vaeformer_tiny trajectory through both packages'
``make_train_step`` with the same shape-keyed numpy noise patched into
both packages' ``quantize`` (and, with the same patch, a sampled-posterior
forward, ``entropy_rate`` and steps with ``use_kl``). Then the port alone:
remat changes no gradient, and a resumed run repeats an uninterrupted one
exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cra5_tpu.entropy.entropy_bottleneck as j_ebm
import cra5_tpu.entropy.gaussian_conditional as j_gcm
from cra5_tpu.entropy import ops as j_ops
from cra5_tpu.entropy.entropy_bottleneck import EntropyBottleneck as JEB
from cra5_tpu.entropy.gaussian_conditional import GaussianConditional as JGC
from cra5_tpu.models.vaeformer import DiagonalGaussian as JDiag
from cra5_tpu.models.vaeformer import VAEformer as JVAEformer
from cra5_tpu.models.vaeformer import vaeformer_tiny as j_tiny
from cra5_tpu.ops.attention import flash_attention as j_flash
from cra5_tpu.train import schedulers as j_sched
from cra5_tpu.train.ema import ema_init as j_ema_init
from cra5_tpu.train.loop import TrainerConfig as JTrainerConfig
from cra5_tpu.train.loop import TrainState as JTrainState
from cra5_tpu.train.loop import make_train_step as j_make_train_step
from cra5_tpu.train.loss import RateDistortionLoss as JRD
from cra5_tpu.train.loss import kl_weighted_loss as j_kl_weighted_loss
from cra5_tpu.train.optim import make_net_aux_optimizers as j_make_tx
from cra5_tpu_torch.convert import load_flax_variables
from cra5_tpu_torch.entropy import EntropyBottleneck, GaussianConditional
from cra5_tpu_torch.entropy import entropy_bottleneck as ebm
from cra5_tpu_torch.entropy import gaussian_conditional as gcm
from cra5_tpu_torch.entropy import ops
from cra5_tpu_torch.models.vaeformer import DiagonalGaussian, VAEformer, vaeformer_tiny
from cra5_tpu_torch.ops.attention import FlashAttention, flash_attention
from cra5_tpu_torch.train import (
    RateDistortionLoss,
    Trainer,
    TrainerConfig,
    TrainState,
    build_schedule,
    ema_init,
    kl_weighted_loss,
    make_net_aux_optimizers,
    make_train_step,
)

t = torch.from_numpy
j = jnp.asarray


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, rtol, what=""):
    """max |got - want| <= rtol * max |want|: one tolerance for the leaf,
    set by its largest entry (elementwise rtol fails on entries near 0)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, f"{what}: max err {err} > {rtol} x {scale}"


# ------------------------------------------------------------------ ops
def test_lower_bound_and_ste_gradients(rng):
    x = rng.standard_normal(500).astype(np.float32)
    g = rng.standard_normal(500).astype(np.float32)
    want_y, vjp = jax.vjp(lambda a: j_ops.lower_bound(a, jnp.float32(0.3)), j(x))
    (want_g,) = vjp(j(g))
    xt = t(x).requires_grad_()
    y = ops.lower_bound(xt, 0.3)
    y.backward(t(g))
    np.testing.assert_array_equal(_np(y), np.asarray(want_y))
    np.testing.assert_array_equal(_np(xt.grad), np.asarray(want_g))
    assert ((x < 0.3) & (g > 0)).any()  # some gradients are blocked

    means = rng.standard_normal(500).astype(np.float32)
    f = lambda a, m: jnp.sum(j_ops.quantize(a, "ste", means=m) * j(g))
    want = jax.grad(f, argnums=(0, 1))(j(x * 3), j(means))
    xt, mt = t(x * 3).requires_grad_(), t(means).requires_grad_()
    out = ops.quantize(xt, "ste", means=mt)
    (out * t(g)).sum().backward()
    np.testing.assert_array_equal(_np(out), np.asarray(j_ops.quantize(j(x * 3), "ste", means=j(means))))
    for got, w in ((xt.grad, want[0]), (mt.grad, want[1])):
        np.testing.assert_array_equal(_np(got), np.asarray(w))


# ------------------------------------------------------------------ entropy models
def _eb_params(rng, C):
    dims = (1, 3, 3, 3, 3, 1)
    p = {}
    for i in range(5):
        p[f"matrix{i}"] = (0.8 + 0.3 * rng.standard_normal((C, dims[i + 1], dims[i])))
        p[f"bias{i}"] = rng.uniform(-0.5, 0.5, (C, dims[i + 1], 1))
        if i < 4:
            p[f"factor{i}"] = 0.5 * rng.standard_normal((C, dims[i + 1], 1))
    p["quantiles"] = np.tile(np.float64([-10, 0, 10]), (C, 1, 1)) + rng.standard_normal((C, 1, 3))
    return {k: v.astype(np.float32) for k, v in p.items()}


def _port_eb(params, C):
    eb = EntropyBottleneck(C, device="cpu")
    with torch.no_grad():
        for k, v in params.items():
            getattr(eb, k).copy_(t(v))
    return eb


def test_eb_likelihood_and_loss_with_gradients(rng):
    C = 5
    params = _eb_params(rng, C)
    values = (3 * rng.standard_normal((C, 1, 64))).astype(np.float32)
    w = rng.standard_normal((C, 1, 64)).astype(np.float32)  # a random cotangent
    jeb = JEB(channels=C)

    def jlik(p, v):
        return jnp.sum(jeb.apply({"params": p}, v, method=JEB.likelihood) * j(w))

    want_lik = jeb.apply({"params": params}, j(values), method=JEB.likelihood)
    want_g = jax.grad(jlik, argnums=(0, 1))(params, j(values))
    want_loss, want_lg = jax.value_and_grad(
        lambda p: jeb.apply({"params": p}, method=JEB.loss))(params)

    eb = _port_eb(params, C)
    vt = t(values).requires_grad_()
    lik = eb.likelihood(vt)
    (lik * t(w)).sum().backward()
    _close(lik, want_lik, 1e-5, "likelihood")
    _close(vt.grad, want_g[1], 1e-4, "d/dvalues")
    for k, prm in eb.named_parameters():
        if k != "quantiles":
            _close(prm.grad, want_g[0][k], 1e-4, f"d/d{k}")
    eb.zero_grad()
    loss = eb.loss()
    loss.backward()
    _close(loss, want_loss, 1e-6, "loss")
    _close(eb.quantiles.grad, want_lg["quantiles"], 1e-6, "d loss/d quantiles")
    assert all(p.grad is None or not p.grad.any()
               for k, p in eb.named_parameters() if k != "quantiles")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eb_forward_dtype_promotions(rng, noise_patch, dtype):
    """The training EB in a bf16 model: noise and outputs in bf16, the
    first MLP product rounded to bf16, likelihoods float32. The bf16 case
    agrees within 2e-2 of the largest likelihood (the two frameworks'
    first products round to bf16 separately)."""
    C = 4
    params = _eb_params(rng, C)
    z = (2 * rng.standard_normal((1, C, 3, 5))).astype(np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want_out, want_lik = JEB(channels=C).apply({"params": params}, j(z).astype(jd),
                                               training=True, rng=jax.random.PRNGKey(0))
    out, lik = _port_eb(params, C)(t(z).to(td), training=True, generator=torch.Generator())
    assert lik.dtype == torch.float32 and str(want_lik.dtype) == "float32"
    assert out.dtype == td and str(want_out.dtype) == dtype
    _close(out, want_out, 1e-6, "outputs")
    _close(lik, want_lik, 1e-5 if dtype == "float32" else 2e-2, "likelihood")


def test_gc_likelihood_with_gradients(rng):
    shape = (1, 6, 4, 5)
    y = (3 * rng.standard_normal(shape)).astype(np.float32)
    means = rng.standard_normal(shape).astype(np.float32)
    scales = rng.uniform(0.03, 4.0, shape).astype(np.float32)  # some below the 0.11 bound
    w = rng.standard_normal(shape).astype(np.float32)  # a random cotangent
    gc = JGC()

    def jf(a, s, m):
        return jnp.sum(gc.apply({}, a, s, m, method=JGC.likelihood) * j(w))

    want = gc.apply({}, j(y), j(scales), j(means), method=JGC.likelihood)
    want_g = jax.grad(jf, argnums=(0, 1, 2))(j(y), j(scales), j(means))
    ins = [t(a).requires_grad_() for a in (y, scales, means)]
    lik = GaussianConditional().likelihood(*ins)
    (lik * t(w)).sum().backward()
    _close(lik, want, 1e-5, "likelihood")
    for got, w, name in zip(ins, want_g, ("inputs", "scales", "means")):
        _close(got.grad, w, 1e-4, name)


def test_diagonal_gaussian_kl_and_nll(rng):
    moments = rng.standard_normal((2, 6, 3, 4)).astype(np.float32)
    moments[:, 3:] *= 4  # logvar, some past the clamp
    sample = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)

    def jf(mo):
        d = JDiag(mo)
        return jnp.sum(d.kl()) + jnp.sum(d.nll(j(sample)))

    d = JDiag(j(moments))
    want_kl, want_nll = d.kl(), d.nll(j(sample))
    want_g = jax.grad(jf)(j(moments))
    mt = t(moments).requires_grad_()
    pd = DiagonalGaussian(mt)
    kl, nll = pd.kl(), pd.nll(t(sample))
    (kl.sum() + nll.sum()).backward()
    _close(kl, want_kl, 1e-6, "kl")
    _close(nll, want_nll, 1e-6, "nll")
    _close(mt.grad, want_g, 1e-6, "d/dmoments")


@pytest.fixture
def same_normal(monkeypatch):
    """The posterior's standard-normal draw patched to the same seed-made
    numpy array (keyed by shape) in both packages."""
    draw = lambda shape: np.random.default_rng(int(np.prod(shape))).standard_normal(
        tuple(shape)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32: j(draw(shape)).astype(dtype))
    monkeypatch.setattr(torch, "randn", lambda shape, generator=None, dtype=torch.float32,
                        device=None: t(draw(shape)).to(device, dtype))


def test_diagonal_gaussian_sample_matches_jax(rng, same_normal):
    """mean + std * eps with the same eps: the sample and its gradient
    with respect to the moments (the reparameterization)."""
    moments = rng.standard_normal((2, 6, 3, 4)).astype(np.float32)
    w = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    want = JDiag(j(moments)).sample(key)
    want_g = jax.grad(lambda mo: jnp.sum(JDiag(mo).sample(key) * j(w)))(j(moments))
    mt = t(moments).requires_grad_()
    got = DiagonalGaussian(mt).sample(torch.Generator())
    (got * t(w)).sum().backward()
    _close(got, want, 1e-6, "sample")
    _close(mt.grad, want_g, 1e-6, "d/dmoments")


@pytest.mark.parametrize("kind", ["rd_mse", "rd_logvar", "kl", "kl_logvar"])
def test_losses_match_jax(rng, kind):
    """RateDistortionLoss (plain, and with a learned log-variance) and
    kl_weighted_loss (without and with a log-variance): every output and
    its gradients with respect to x_hat, the likelihoods, the KL and the
    log-variance."""
    shape = (2, 3, 5, 4)
    target = rng.standard_normal(shape).astype(np.float32)
    ins = dict(x_hat=rng.standard_normal(shape).astype(np.float32),
               y=rng.uniform(0.05, 1.0, (2, 4, 3, 2)).astype(np.float32),
               z=rng.uniform(0.05, 1.0, (2, 2, 1, 1)).astype(np.float32),
               kl=rng.uniform(0.0, 3.0, 2).astype(np.float32),
               logvar=(0.5 * rng.standard_normal((1, 3, 1, 1))).astype(np.float32))
    use_logvar = kind.endswith("logvar")

    def run(loss_fn, arr, d):
        out = {"x_hat": d["x_hat"], "likelihoods": {"y": d["y"], "z": d["z"]}, "kl": d["kl"]}
        lv = d["logvar"] if use_logvar else None
        return loss_fn(out, arr(target), logvar=lv)

    if kind.startswith("rd"):
        jfn = JRD(lmbda=0.3, bpp_weight=0.2, learn_log_variance=use_logvar)
        pfn = RateDistortionLoss(lmbda=0.3, bpp_weight=0.2, learn_log_variance=use_logvar)
        total = "loss"
    else:
        jfn = lambda o, tg, logvar: j_kl_weighted_loss(o, tg, kl_weight=0.7, logvar=logvar)
        pfn = lambda o, tg, logvar: kl_weighted_loss(o, tg, kl_weight=0.7, logvar=logvar)
        total = "vae_loss"
    want = run(jfn, j, {k: j(v) for k, v in ins.items()})
    want_g = jax.grad(lambda d: run(jfn, j, d)[total])({k: j(v) for k, v in ins.items()})
    tins = {k: t(v).requires_grad_() for k, v in ins.items()}
    got = run(pfn, t, tins)
    got[total].backward()
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], 1e-6, k)
    for k, v in tins.items():
        if v.grad is None:  # not an input of this loss
            assert not np.asarray(want_g[k]).any(), k
        else:
            _close(v.grad, want_g[k], 1e-5, f"d/d{k}")


# ------------------------------------------------------------------ flash backward
def _qkv_np(rng, shape, n=4):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _grads_both(q, k, v, g, jd, td):
    out, vjp = jax.vjp(lambda a, b, c: j_flash(a, b, c, None, 128, 128),
                       *(j(a).astype(jd) for a in (q, k, v)))
    want = (out,) + vjp(j(g).astype(jd))
    ins = [t(a).to(td).requires_grad_() for a in (q, k, v)]
    got_out = flash_attention(*ins)
    dq, dk, dv = torch.autograd.grad(got_out, ins, t(g).to(td))
    return (got_out, dq, dk, dv), want


def test_flash_backward_plain_matches_pallas_f32(rng):
    """(1, 2, 200, 64) with 128-blocks: a ragged key tile in both passes."""
    q, k, v, g = _qkv_np(rng, (1, 2, 200, 64))
    got, want = _grads_both(q, k, v, g, jnp.float32, torch.float32)
    for a, b, name in zip(got, want, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("N", [200, 127, 129, 257])
def test_flash_backward_plain_matches_pallas_bf16(rng, N):
    """bf16 inputs: both round q * scale, P and dS to bf16 at the same
    places, but sum in other orders and block sizes, so results differ
    by a few bf16 ulps: max err <= 2e-2 * max |ref| per output. N = 127,
    129 and 257 sit at the card kernels' 64- and 128-row tile edges."""
    q, k, v, g = _qkv_np(rng, (1, 2, N, 64))
    got, want = _grads_both(q, k, v, g, jnp.bfloat16, torch.bfloat16)
    for a, b, name in zip(got, want, ("out", "dq", "dk", "dv")):
        assert a.dtype == torch.bfloat16, name
        _close(a, np.asarray(b.astype(jnp.float32)), 2e-2, name)


def test_flash_attention_gradcheck():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 7, 8, dtype=torch.float64, generator=gen).requires_grad_()
               for _ in range(3))
    assert torch.autograd.gradcheck(lambda a, b, c: FlashAttention.apply(a, b, c, 0.4), (q, k, v))


# ------------------------------------------------------------------ schedules
SCHEDULES = [
    (dict(type="WarmupCosineLR", warmup_steps=4, min_lr_ratio=0.1), 20),
    (dict(type="WarmupCosineLR", warmup_steps=0), 9),
    (dict(type="MultiStepLR", milestones=(3, 7), gamma=0.5, warmup_steps=2), 12),
    (dict(type="LinearWarmupLR", warmup_steps=5), 10),
    (dict(type="ConstantLR"), 4),
]


@pytest.mark.parametrize("cfg,total", SCHEDULES, ids=[c["type"] for c, _ in SCHEDULES])
def test_schedules_match_optax(cfg, total):
    """optax evaluates in float32, the port in float64: rtol 1e-5."""
    want = j_sched.build_schedule(cfg, 3e-3, total)
    got = build_schedule(cfg, 3e-3, total)
    for step in range(total + 6):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-5, abs=1e-12), step


def test_schedule_validation_messages():
    with pytest.raises(ValueError, match="unknown option"):
        build_schedule(dict(type="WarmupCosineLR", warmup=5), 1e-3, 10)
    with pytest.raises(ValueError, match="needs a horizon"):
        build_schedule(dict(type="WarmupCosineLR"), 1e-3)
    with pytest.raises(KeyError, match="not found"):
        build_schedule(dict(type="NoSuchLR"), 1e-3)
    assert build_schedule(None, 2e-3) == 2e-3


def test_optimizer_matches_optax(rng):
    """Clip (it fires) + Adam on the net leaves, plain Adam on the
    quantiles, three updates, against optax."""
    shapes = {"a.weight": (7, 3), "b.bias": (5,), "eb.quantiles": (2, 1, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    sched = dict(type="WarmupCosineLR", warmup_steps=1, min_lr_ratio=0.2)
    nest = lambda flat: {k.split(".")[0]: {k.split(".")[1]: j(v)} for k, v in flat.items()}
    jtx = j_make_tx(1e-2, 3e-2, 0.5, scheduler=sched, total_steps=3)
    jp = nest(params)
    jstate = jtx.init(jp)
    tx = make_net_aux_optimizers(1e-2, 3e-2, 0.5, scheduler=sched, total_steps=3)
    tp = {k: t(v.copy()) for k, v in params.items()}
    state = tx.init(tp)
    for g in grads:
        upd, jstate = jtx.update(nest(g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tx.update_(tp, {k: t(v.copy()) for k, v in g.items()}, state)
    for k in shapes:
        a, b = k.split(".")
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[a][b]), rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------------ trajectory
STEPS = 5
LR, AUX_LR, CLIP = 1e-3, 1e-2, 0.02


def _shape_noise(shape):
    """The same uniform(-0.5, 0.5) noise for one shape in both packages,
    every step."""
    seed = int(np.prod([int(s) + 7 for s in shape])) % (2**31)
    return np.random.default_rng(seed).uniform(-0.5, 0.5, size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def noise_patch():
    mp = pytest.MonkeyPatch()

    def jq(inputs, mode, means=None, rng=None):
        if mode == "noise":
            return inputs + j(_shape_noise(inputs.shape)).astype(inputs.dtype)
        return j_ops.quantize(inputs, mode, means=means, rng=rng)

    def tq(inputs, mode, means=None, generator=None):
        if mode == "noise":
            return inputs + t(_shape_noise(tuple(inputs.shape))).to(inputs.dtype)
        return ops.quantize(inputs, mode, means=means, generator=generator)

    for mod in (j_ebm, j_gcm):
        mp.setattr(mod, "quantize", jq)
    for mod in (ebm, gcm):
        mp.setattr(mod, "quantize", tq)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def tiny_init():
    """A vaeformer_tiny input and the flax init both packages start from."""
    cfg = j_tiny()
    x = np.random.default_rng(5).standard_normal((1, cfg.in_chans, *cfg.img_size)).astype(np.float32)
    return x, jax.device_get(JVAEformer(cfg).init(jax.random.PRNGKey(3), j(x))["params"])


@pytest.fixture(scope="module")
def trajectory(noise_patch, tiny_init):
    """Both packages from the same flax init: the first-step gradients,
    then 5 steps with EMA, clipping and a warmup-cosine schedule."""
    x, params = tiny_init
    jmodel = JVAEformer(j_tiny())
    sched = dict(type="WarmupCosineLR", warmup_steps=2, min_lr_ratio=0.1)
    tcfg = dict(learning_rate=LR, aux_learning_rate=AUX_LR, max_grad_norm=CLIP,
                scheduler=sched, total_steps=STEPS, use_ema=True)

    # JAX
    rd = JRD()
    key = jax.random.PRNGKey(1)

    def jloss(p):
        out = jmodel.apply({"params": p}, j(x), training=True, rng=key)
        return rd(out, j(x))["loss"] + jmodel.apply({"params": p}, method=JVAEformer.aux_loss)

    jgrads = jax.device_get(jax.jit(jax.grad(jloss))(params))
    jtx = j_make_tx(LR, AUX_LR, CLIP, scheduler=sched, total_steps=STEPS)
    jstep = jax.jit(j_make_train_step(jmodel, jtx, JTrainerConfig(**tcfg)))
    jstate = JTrainState(step=jnp.int32(0), params=params, opt_state=jtx.init(params),
                         ema=j_ema_init(params))
    jlosses = []
    for _ in range(STEPS):
        jstate, m = jstep(jstate, j(x), key)
        jlosses.append({k: float(v) for k, v in m.items()})

    # port
    model = load_flax_variables(VAEformer(vaeformer_tiny(), device="cpu"), {"params": params})
    xt = t(x)
    out = model(xt, training=True, generator=torch.Generator())
    (RateDistortionLoss()(out, xt)["loss"] + model.aux_loss()).backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    tx = make_net_aux_optimizers(LR, AUX_LR, CLIP, scheduler=sched, total_steps=STEPS)
    pstep = make_train_step(model, tx, TrainerConfig(**tcfg))
    pp = dict(model.named_parameters())
    state = TrainState(step=0, params=pp, opt_state=tx.init(pp), ema=ema_init(pp))
    losses = []
    for _ in range(STEPS):
        state, m = pstep(state, xt, 0)
        losses.append({k: float(v) for k, v in m.items()})

    as_port = lambda tree: dict(load_flax_variables(
        VAEformer(vaeformer_tiny(), device="cpu"), {"params": jax.device_get(tree)}
    ).named_parameters())
    return dict(grads=grads, jgrads=as_port(jgrads), losses=losses, jlosses=jlosses,
                state=state, jparams=as_port(jstate.params), jema=as_port(jstate.ema.params),
                jema_steps=int(jstate.ema.steps))


GRAD_LEAVES = ["quant_conv.weight", "entropy_bottleneck.quantiles",
               "g_a.blocks.1.attn.qkv.weight", "h_a.blocks.0.attn.qkv.weight",
               "entropy_bottleneck.matrix0", "g_s.final.weight"]


@pytest.mark.parametrize("name", GRAD_LEAVES)
def test_first_step_gradients_match_jax(trajectory, name):
    """float32 on both sides; the sums run in other orders, so the
    gradients agree within 1e-3 of each leaf's largest entry. (g_a
    block 1 is a global-attention block of vaeformer_tiny.)"""
    got, want = trajectory["grads"][name], trajectory["jgrads"][name]
    assert got.abs().max() > 0
    _close(got, want, 1e-3, name)


def test_trajectory_losses_match_jax(trajectory):
    """Every metric of the 5 steps within rtol 1e-3, and clipping fired
    (the first net gradient norm is far above the clip)."""
    net_norm = torch.sqrt(sum((g.double() ** 2).sum() for k, g in trajectory["grads"].items()
                              if not k.endswith("quantiles")))
    assert net_norm > 10 * CLIP
    for got, want in zip(trajectory["losses"], trajectory["jlosses"]):
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-3), k
    assert trajectory["losses"][0]["loss"] != trajectory["losses"][-1]["loss"]


def test_trajectory_params_and_ema_match_jax(trajectory):
    """After 5 updates every parameter and its EMA agree within 1e-3 of
    the leaf's largest entry."""
    state = trajectory["state"]
    assert state.ema.steps == trajectory["jema_steps"] == STEPS
    for name, p in state.params.items():
        _close(p, trajectory["jparams"][name], 1e-3, name)
        _close(state.ema.params[name], trajectory["jema"][name], 1e-3, f"ema {name}")


def test_sample_posterior_forward_matches_jax(tiny_init, same_normal):
    """sample_posterior=True: the eval forward draws y from the posterior
    (the same eps in both packages) and gives the same x_hat, likelihoods
    and KL; without a generator the port refuses, as JAX does without an
    rng."""
    x, params = tiny_init
    jmodel = JVAEformer(dataclasses.replace(j_tiny(), sample_posterior=True))
    want = jmodel.apply({"params": params}, j(x), rng=jax.random.PRNGKey(1))
    cfg = dataclasses.replace(vaeformer_tiny(), sample_posterior=True)
    model = load_flax_variables(VAEformer(cfg, device="cpu"), {"params": params})
    with torch.no_grad():
        got = model(t(x), generator=torch.Generator())
    for k in ("x_hat", "kl", "posterior_mean", "posterior_logvar"):
        _close(got[k], want[k], 1e-4, k)
    for k in ("y", "z"):
        _close(got["likelihoods"][k], want["likelihoods"][k], 1e-4, f"likelihood {k}")
    with pytest.raises(ValueError, match="sample_posterior"):
        model(t(x))


def test_entropy_rate_matches_jax(tiny_init, noise_patch):
    """The training-mode likelihoods of a frozen latent and the aux loss,
    with the same noise in both packages."""
    x, params = tiny_init
    cfg = j_tiny()
    y = np.random.default_rng(6).standard_normal(
        (1, cfg.embed_dim, *cfg.latent_grid)).astype(np.float32)
    want = JVAEformer(cfg).apply({"params": params}, j(y), jax.random.PRNGKey(2),
                                 method=JVAEformer.entropy_rate)
    model = load_flax_variables(VAEformer(vaeformer_tiny(), device="cpu"), {"params": params})
    with torch.no_grad():
        got = model.entropy_rate(t(y), torch.Generator())
    _close(got["aux"], want["aux"], 1e-5, "aux")
    for k in ("y", "z"):
        _close(got["likelihoods"][k], want["likelihoods"][k], 1e-4, f"likelihood {k}")


def test_use_kl_steps_match_jax(tiny_init, noise_patch):
    """TrainerConfig(use_kl=True): two steps whose loss adds the
    KL-weighted L1 term. Every metric agrees within rtol 1e-3, and the
    posterior's logvar block, which only the KL term reaches, moves as in
    JAX (Adam's first update is about lr * sign(gradient))."""
    x, params = tiny_init
    tcfg = dict(learning_rate=LR, aux_learning_rate=AUX_LR, use_kl=True, kl_weight=0.5,
                use_ema=False)
    jmodel = JVAEformer(j_tiny())
    jtx = j_make_tx(LR, AUX_LR, 1.0)
    jstep = jax.jit(j_make_train_step(jmodel, jtx, JTrainerConfig(**tcfg)))
    jstate = JTrainState(step=jnp.int32(0), params=params, opt_state=jtx.init(params), ema=None)
    model = load_flax_variables(VAEformer(vaeformer_tiny(), device="cpu"), {"params": params})
    tx = make_net_aux_optimizers(LR, AUX_LR, 1.0)
    pp = dict(model.named_parameters())
    logvar_block = f"g_a.blocks.{model.g_a.n_seq}.attn.qkv.weight"
    before = pp[logvar_block].detach().clone()
    state = TrainState(step=0, params=pp, opt_state=tx.init(pp))
    pstep = make_train_step(model, tx, TrainerConfig(**tcfg))
    for _ in range(2):
        jstate, jm = jstep(jstate, j(x), jax.random.PRNGKey(1))
        state, m = pstep(state, t(x), 0)
        assert {"nll_loss", "kl_loss", "vae_loss"} <= set(m) and set(m) == set(jm)
        for k in jm:
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-3), k
    want = dict(load_flax_variables(VAEformer(vaeformer_tiny(), device="cpu"),
                                    {"params": jax.device_get(jstate.params)}).named_parameters())
    assert (state.params[logvar_block] - before).abs().max() > 0
    _close(state.params[logvar_block] - before, want[logvar_block] - before, 1e-2, logvar_block)


# ------------------------------------------------------------------ port alone
def _tiny_grads(remat):
    cfg = dataclasses.replace(vaeformer_tiny(), remat=remat)
    model = VAEformer(cfg, device="cpu").reset_parameters(4)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, cfg.in_chans, *cfg.img_size)).astype(np.float32))
    out = model(x, training=True, generator=torch.Generator().manual_seed(9))
    (RateDistortionLoss()(out, x)["loss"] + model.aux_loss()).backward()
    return {k: p.grad for k, p in model.named_parameters()}


def test_remat_changes_no_gradient():
    a, b = _tiny_grads(False), _tiny_grads(True)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_remat_dots_is_not_ported():
    """The name is older than the port of remat="dots", which raised
    NotImplementedError before the selective checkpointing policy was
    ported. Its gradients now equal remat=False's bit for bit (the saved
    matmul outputs and the recomputed rest are the same float32 ops)."""
    a, b = _tiny_grads(False), _tiny_grads("dots")
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_resume_repeats_an_uninterrupted_run(tmp_path):
    """fit(2) -> save -> restore -> fit(1) equals fit(3): params, moments,
    EMA and step, bit for bit."""
    cfg = vaeformer_tiny()
    rng = np.random.default_rng(8)
    data = [rng.standard_normal((1, cfg.in_chans, *cfg.img_size)).astype(np.float32)
            for _ in range(3)]
    tcfg = dict(log_every=10**9, ckpt_every=10**9, ckpt_dir=str(tmp_path), ckpt_keep=1,
                scheduler=dict(type="LinearWarmupLR", warmup_steps=2))

    full = Trainer(VAEformer(cfg, device="cpu"), TrainerConfig(**tcfg), seed=3)
    s_full = full.fit(data, num_steps=3)

    first = Trainer(VAEformer(cfg, device="cpu"), TrainerConfig(**tcfg), seed=3)
    s = first.fit(data[:2], num_steps=2)
    first.save(s)
    first.save(s)  # same step twice: the pointers stay valid
    second = Trainer(VAEformer(cfg, device="cpu"), TrainerConfig(**tcfg), seed=3)
    s2 = second.restore(data[0])
    assert s2.step == 2 and s2.opt_state.count == 2
    s2 = second.fit(data[2:], state=s2, num_steps=1)

    assert s2.step == s_full.step == 3 and s2.ema.steps == s_full.ema.steps
    for tree in ("params", "ema"):
        a = s_full.params if tree == "params" else s_full.ema.params
        b = s2.params if tree == "params" else s2.ema.params
        for k in a:
            assert torch.equal(a[k], b[k]), (tree, k)
    for k in s_full.opt_state.mu:
        assert torch.equal(s_full.opt_state.mu[k], s2.opt_state.mu[k]), k
        assert torch.equal(s_full.opt_state.nu[k], s2.opt_state.nu[k]), k
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "last_checkpoint", "last_state", "state_2.pt", "step_2.pt"]


def test_trainer_takes_a_tp_mesh_of_the_world_and_refuses_a_larger_one():
    """In one process a mesh with a tp axis of one device trains as no mesh
    does, bit for bit; a tp axis larger than the world raises the JAX
    package's ValueError (multi-rank tp: tests/test_torch_tensor_parallel.py)."""
    import torch.distributed as dist

    from cra5_tpu.parallel import make_mesh as j_make_mesh
    from cra5_tpu_torch.parallel import make_mesh

    cfg = vaeformer_tiny()
    data = [np.random.default_rng(4).standard_normal((1, cfg.in_chans, *cfg.img_size))
            .astype(np.float32)] * 2
    tcfg = TrainerConfig(log_every=10**9, ckpt_every=10**9)
    try:
        states = [Trainer(VAEformer(cfg, device="cpu"), tcfg, mesh=mesh, seed=2).fit(data)
                  for mesh in (None, make_mesh({"dp": 1, "tp": 1}, device_type="cpu"))]
        with pytest.raises(ValueError) as want:
            j_make_mesh({"dp": 1, "tp": 2}, devices=jax.devices()[:1])
        with pytest.raises(ValueError) as got:
            make_mesh({"dp": 1, "tp": 2}, device_type="cpu")
        assert str(got.value) == str(want.value)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert all(torch.equal(p, states[1].params[k]) for k, p in states[0].params.items())


def test_ms_ssim_distortion_is_not_ported():
    """The name is older than the port of the ms-ssim distortion, which
    raised NotImplementedError before metrics.py was ported. It now equals
    the JAX loss on a vaeformer_tiny-sized field (41 x 40, two scales)."""
    rng = np.random.default_rng(12)
    x, x_hat = (rng.random((1, 8, 41, 40)).astype(np.float32) for _ in range(2))
    lik = {"y": rng.random((1, 8, 4, 4)).astype(np.float32) + 0.01,
           "z": rng.random((1, 8, 2, 2)).astype(np.float32) + 0.01}
    kw = dict(lmbda=0.5, metric="ms-ssim", ms_ssim_weights=(0.4, 0.6))
    got = RateDistortionLoss(**kw)({"x_hat": t(x_hat), "likelihoods": {k: t(v) for k, v in lik.items()}},
                                   t(x))
    want = JRD(**kw)({"x_hat": j(x_hat), "likelihoods": {k: j(v) for k, v in lik.items()}}, j(x))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], 1e-5, k)
