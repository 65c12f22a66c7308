"""Port vs JAX: the float32 flash-attention path on the CPU (the plain
versions of K4, K5 and K6) against the JAX flash kernels in interpret mode,
with the bound the card's float32 kernels are held to: max |got - ref| <=
1e-5 x max |ref| for out, dq, dk and dv, and lse within 1e-5. No rounding
point differs in float32; the JAX kernels sum in 128-wide tiles, the plain
versions over whole rows.

The card's float32 K4, K5 and K6 run their products on the tensor cores
as 3xTF32 (each operand split into hi = tf32(x) and lo = tf32(x - hi), each
product hi hi + hi lo + lo hi). That arithmetic is emulated here, bit for
bit in its roundings, and held to the same bound against the float32 plain
versions and float64, where the kernels themselves cannot run: at head dim 64
with the head-dim-64 kernels' stages (64 keys a K4 stage, 32 walked rows a K5
and K6 stage), and at head dims 72 and 96 with the any-head-dim kernels' (32
keys a K4 stage, 16 queries a K6 stage, 32 keys a K5 stage at 72 and 16 at
96). Their zero padding of the head dim adds exact zeros to every sum, so the
emulation leaves it out."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cra5_tpu.ops.attention import _flash_forward as j_flash_forward
from cra5_tpu.ops.attention import flash_attention as j_flash
from cra5_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_backward_dkv_plain,
    flash_attention_backward_dq_plain,
    flash_attention_forward,
    flash_attention_plain,
)

RTOL = 1e-5
LSE_ATOL = 1e-5


def _bounded(got, want):
    want = np.asarray(want)
    assert np.abs(got.detach().numpy() - want).max() <= RTOL * np.abs(want).max()


@pytest.mark.parametrize("D", [64, 72])
@pytest.mark.parametrize("B,H,N", [(1, 2, 300), (2, 1, 129)])
def test_f32_flash_matches_the_pallas_kernels(B, H, N, D):
    rng = np.random.default_rng(N)
    q, k, v, g = (rng.standard_normal((B, H, N, D)).astype(np.float32) * 1.5 for _ in range(4))
    scale = 0.125
    jout, jlse = j_flash_forward(*(jnp.asarray(a) for a in (q, k, v)), scale, 128, 128)
    out, lse = flash_attention_forward(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    _bounded(out, np.asarray(jout).reshape(B, H, -1, D)[:, :, :N])
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


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the float32 bit pattern: the magnitude rounded to
    10 mantissa bits, ties away from zero (add half the weight of the 13
    dropped bits, then clear them)."""
    bits = x.contiguous().numpy().view(np.uint32)
    return torch.from_numpy(((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32))


def _split(x):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)  # x - hi is exact in float32


def _mm(a, b, products):
    """a @ b as TF32 split products, float32 sums: 3 = hi hi + hi lo + lo hi
    (the kernel's), 1 = hi hi alone."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    if products == 1:
        return ah @ bh
    return ah @ bh + ah @ bl + al @ bh


def _forward_tf32(q, k, v, scale, products, block_k=64):
    """The card's float32 K4 in float32 on the CPU, one (N, D) head: q
    scaled in float32, 64-key stages, the online softmax in log2 units, P
    split like the operands and multiplying V unrounded otherwise."""
    log2e = 1.4426950408889634
    qs = q * scale
    m = torch.full((q.shape[0], 1), -1e30)
    l = torch.zeros((q.shape[0], 1))
    o = torch.zeros_like(q)
    for k0 in range(0, k.shape[0], block_k):
        s = _mm(qs, k[k0:k0 + block_k].T, products)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * log2e)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * log2e - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _mm(p, v[k0:k0 + block_k], products)
        m = m_new
    l = l.clamp_min(1e-30)
    return o / l, (m / log2e + torch.log(l))[:, 0]


def _backward_tf32(q, k, v, do, lse, delta, scale, products, step=32, kv_step=32):
    """The card's float32 K5 and K6 in float32 on the CPU, one (N, D)
    head: the walked rows in stages (``step`` keys in K5, ``kv_step``
    queries in K6), P in log2 units, dS and P split like the operands, and
    each stage's dQ, dK and dV product summed fresh and then added to the
    running sum. K5 scales q in float32; K6 scales the logits of raw q."""
    log2e = 1.4426950408889634
    l2, dl = lse[:, None] * log2e, delta[:, None]
    qs = q * scale
    dq = torch.zeros_like(q)
    for k0 in range(0, k.shape[0], step):
        kj, vj = k[k0:k0 + step], v[k0:k0 + step]
        p = torch.exp2(_mm(qs, kj.T, products) * log2e - l2)
        ds = p * (_mm(do, vj.T, products) - dl)
        dq = dq + _mm(ds, kj, products)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for q0 in range(0, q.shape[0], kv_step):
        qi, oi = q[q0:q0 + kv_step], do[q0:q0 + kv_step]
        pt = torch.exp2(_mm(k, qi.T, products) * (scale * log2e) - l2[q0:q0 + kv_step].T)
        dst = pt * (_mm(v, oi.T, products) - dl[q0:q0 + kv_step].T)
        dv = dv + _mm(pt, oi, products)
        dk = dk + _mm(dst, qi, products)
    return dq * scale, dk * scale, dv


@pytest.mark.parametrize("D", [64, 72, 96])
@pytest.mark.parametrize("B,H,N", [(1, 2, 1000), (2, 3, 200)])
def test_3xtf32_backward_within_the_f32_bound(B, H, N, D):
    """The float32 K5 and K6 arithmetic: dq, dk and dv within RTOL x max
    |ref| of the float32 plain versions and of float64 (inputs N(0, 1.5^2),
    scale 0.125, lse and delta of the float32 plain forward), while one TF32
    product misses the float64 bound by more than 10x. Past head dim 64 the
    card runs K6 in 16-query stages and K5 in 32-key stages (16 at head
    dims past 80, where shared memory binds). This emulation sums
    in float32 rounded to nearest; the card's tensor cores truncate their
    sums, which no CPU run sees: the card test
    test_268v_global_block_f32_through_flash_matches_the_plain_path is the
    one that holds the kernels to this bound at N = 10368."""
    rng = np.random.default_rng(N + 1)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, N, D)).astype(np.float32) * 1.5)
                   for _ in range(4))
    scale = 0.125
    step = 16 if D > 80 else 32  # K5's key stage
    kv_step = 32 if D == 64 else 16  # K6's query stage
    out, lse = flash_attention_plain(q, k, v, scale)
    delta = (do * out).sum(-1)
    ops = (q, k, v, do, lse, delta)
    ref32 = (flash_attention_backward_dq_plain(*ops, scale),
             *flash_attention_backward_dkv_plain(*ops, scale))
    ops64 = tuple(t.double() for t in ops)
    ref64 = (flash_attention_backward_dq_plain(*ops64, scale),
             *flash_attention_backward_dkv_plain(*ops64, scale))
    for b in range(B):
        for h in range(H):
            head = tuple(t[b, h] for t in ops)
            got = _backward_tf32(*head, scale, products=3, step=step, kv_step=kv_step)
            for refs in (ref32, ref64):
                for a, ref in zip(got, refs):
                    bound = RTOL * ref[b, h].abs().max().item()
                    assert (a.double() - ref[b, h].double()).abs().max().item() <= bound
            one = _backward_tf32(*head, scale, products=1, step=step, kv_step=kv_step)
            for a, ref in zip(one, ref64):
                miss = (a.double() - ref[b, h]).abs().max().item()
                assert miss > 10 * RTOL * ref[b, h].abs().max().item()


@pytest.mark.parametrize("D", [64, 72, 96])
@pytest.mark.parametrize("B,H,N", [(1, 2, 1000), (2, 3, 200)])
def test_3xtf32_forward_within_the_f32_bound(B, H, N, D):
    """3xTF32 keeps float32 accuracy: out within RTOL x max |ref| and lse
    within LSE_ATOL of the float32 plain version and of float64 (inputs
    N(0, 1.5^2), scale 0.125, as on the card), in the card's stages: 64
    keys at head dim 64, 32 at the other head dims. One TF32 product (10
    mantissa bits) misses the same bound by orders of magnitude, so the
    bound tells the two apart."""
    rng = np.random.default_rng(N)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, N, D)).astype(np.float32) * 1.5)
               for _ in range(3))
    scale = 0.125
    block_k = 64 if D == 64 else 32
    ref32, lse32 = flash_attention_plain(q, k, v, scale)
    ref64, lse64 = flash_attention_plain(q.double(), k.double(), v.double(), scale)
    for b in range(B):
        for h in range(H):
            out, lse = _forward_tf32(q[b, h], k[b, h], v[b, h], scale, products=3,
                                     block_k=block_k)
            for ref, ref_lse in ((ref32[b, h], lse32[b, h]), (ref64[b, h], lse64[b, h])):
                bound = RTOL * ref.abs().max().item()
                assert (out.double() - ref.double()).abs().max().item() <= bound
                assert (lse.double() - ref_lse.double()).abs().max().item() <= LSE_ATOL
            one, _ = _forward_tf32(q[b, h], k[b, h], v[b, h], scale, products=1, block_k=block_k)
            assert (one.double() - ref64[b, h]).abs().max().item() > 10 * RTOL * ref64[b, h].abs().max().item()
