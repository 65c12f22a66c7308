"""``remat="dots"`` (selective activation checkpointing under the JAX
package's ``dots_with_no_batch_dims_saveable`` policy) on the CPU: the
gradients of vaeformer_tiny's training loss equal remat=False's bit for
bit and JAX's ``"dots"`` gradients within tests/test_torch_train.py's
tolerance, under the shared shape-keyed noise; and the policy saves the
outputs of the Dense layers (four a block), which remat=True recomputes."""

import dataclasses

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
from cra5_tpu.train.loss import RateDistortionLoss as JRD
from cra5_tpu_torch.convert import load_flax_variables
from cra5_tpu_torch.entropy import entropy_bottleneck as ebm
from cra5_tpu_torch.entropy import gaussian_conditional as gcm
from cra5_tpu_torch.entropy import ops
from cra5_tpu_torch.models.vaeformer import VAEformer, vaeformer_tiny
from cra5_tpu_torch.nn import vit
from cra5_tpu_torch.train import RateDistortionLoss


def _shape_noise(shape):
    seed = int(np.prod([int(s) + 7 for s in shape])) % (2**31)
    return np.random.default_rng(seed).uniform(-0.5, 0.5, size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def grads():
    mp = pytest.MonkeyPatch()
    mp.setattr(j_ebm, "quantize", lambda i, mode, means=None, rng=None: (
        i + jnp.asarray(_shape_noise(i.shape)).astype(i.dtype) if mode == "noise"
        else j_ops.quantize(i, mode, means=means, rng=rng)))
    mp.setattr(j_gcm, "quantize", j_ebm.quantize)
    tq = lambda i, mode, means=None, generator=None: (
        i + torch.from_numpy(_shape_noise(tuple(i.shape))).to(i.dtype) if mode == "noise"
        else ops.quantize(i, mode, means=means, generator=generator))
    mp.setattr(ebm, "quantize", tq)
    mp.setattr(gcm, "quantize", tq)
    saved = []
    policy = vit.dots_policy

    def counting(ctx, op, *a, **k):
        decision = policy(ctx, op, *a, **k)
        if not ctx.is_recompute:
            saved.append((str(op), decision))
        return decision

    mp.setattr(vit, "dots_policy", counting)
    try:
        cfg = j_tiny()
        x = np.random.default_rng(5).standard_normal((1, cfg.in_chans, *cfg.img_size)).astype(np.float32)
        variables = jax.device_get(JVAEformer(cfg).init(jax.random.PRNGKey(3), jnp.asarray(x)))
        out = {}
        jmodel = JVAEformer(dataclasses.replace(cfg, remat="dots"))

        def jloss(p):
            o = jmodel.apply({"params": p}, jnp.asarray(x), training=True, rng=jax.random.PRNGKey(1))
            return JRD()(o, jnp.asarray(x))["loss"] + jmodel.apply({"params": p},
                                                                   method=JVAEformer.aux_loss)

        jg = jax.device_get(jax.grad(jloss)(variables["params"]))
        out["jax"] = dict(load_flax_variables(VAEformer(vaeformer_tiny(), device="cpu"),
                                              {"params": jg}).named_parameters())
        for remat in (False, True, "dots"):
            saved.clear()
            model = load_flax_variables(
                VAEformer(dataclasses.replace(vaeformer_tiny(), remat=remat), device="cpu"),
                variables)
            xt = torch.from_numpy(x)
            o = model(xt, training=True, generator=torch.Generator())
            (RateDistortionLoss()(o, xt)["loss"] + model.aux_loss()).backward()
            out[remat] = {k: p.grad for k, p in model.named_parameters()}
            out[f"saved_{remat}"] = list(saved)
        return out
    finally:
        mp.undo()


def test_dots_gradients_equal_no_remat_bit_for_bit(grads):
    assert grads["dots"].keys() == grads[False].keys()
    for k, g in grads["dots"].items():
        assert torch.equal(g, grads[False][k]), k


@pytest.mark.parametrize("name", ["g_a.blocks.0.attn.qkv.weight", "g_a.blocks.1.mlp.fc2.weight",
                                  "g_s.blocks.0.attn.proj.weight", "quant_conv.weight",
                                  "entropy_bottleneck.quantiles", "g_s.final.weight"])
def test_dots_gradients_match_jax_dots(grads, name):
    """float32 on both sides, sums in other orders: within 1e-3 of each
    leaf's largest entry, as tests/test_torch_train.py's first-step
    gradients."""
    got, want = grads["dots"][name], grads["jax"][name].detach()
    assert got.abs().max() > 0
    assert (got - want).abs().max() <= 1e-3 * want.abs().max(), name


def test_dots_policy_saves_the_dense_outputs(grads):
    """Under "dots" the policy saves four matmul outputs a rematerialized
    block (qkv, proj, fc1, fc2: aten.addmm) and recomputes the rest (the
    attention's aten.bmm among it); remat=True and remat=False consult no
    policy, so nothing but the block inputs (remat=True) is kept."""
    cfg = vaeformer_tiny()
    n_blocks = (cfg.depth // 2 + 1) + (cfg.depth - cfg.depth // 2)  # g_a + g_s
    decisions = grads["saved_dots"]
    must = [op for op, d in decisions if d == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE]
    assert must == ["aten.addmm.default"] * (4 * n_blocks)
    assert any(op == "aten.bmm.default" for op, d in decisions
               if d == torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)
    assert grads["saved_True"] == [] and grads["saved_False"] == []
