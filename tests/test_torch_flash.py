"""Port vs JAX: the float32 flash-attention path on the CPU (the plain
versions of K4, K5 and K6) against the JAX flash kernels in interpret mode,
with the bound the card's float32 kernels are held to: max |got - ref| <=
1e-5 x max |ref| for out, dq, dk and dv, and lse within 1e-5. No rounding
point differs in float32; the JAX kernels sum in 128-wide tiles, the plain
versions over whole rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cra5_tpu.ops.attention import _flash_forward as j_flash_forward
from cra5_tpu.ops.attention import flash_attention as j_flash
from cra5_tpu_torch.ops.attention import flash_attention, flash_attention_forward

RTOL = 1e-5


def _bounded(got, want):
    want = np.asarray(want)
    assert np.abs(got.detach().numpy() - want).max() <= RTOL * np.abs(want).max()


@pytest.mark.parametrize("B,H,N", [(1, 2, 300), (2, 1, 129)])
def test_f32_flash_matches_the_pallas_kernels(B, H, N):
    rng = np.random.default_rng(N)
    q, k, v, g = (rng.standard_normal((B, H, N, 64)).astype(np.float32) * 1.5 for _ in range(4))
    scale = 0.125
    jout, jlse = j_flash_forward(*(jnp.asarray(a) for a in (q, k, v)), scale, 128, 128)
    out, lse = flash_attention_forward(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    _bounded(out, np.asarray(jout).reshape(B, H, -1, 64)[:, :, :N])
    jlse = np.asarray(jlse).reshape(B, H, -1)[:, :, :N]
    assert np.abs(lse.numpy() - jlse).max() <= 1e-5

    jo, vjp = jax.vjp(lambda a, b, c: j_flash(a, b, c, scale, 128, 128),
                      *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = flash_attention(*ins, scale)
    got = torch.autograd.grad(o, ins, torch.from_numpy(g))
    _bounded(o, jo)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        _bounded(a, b)
