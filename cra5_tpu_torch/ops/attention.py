"""Flash attention K4 (forward), K5 (dQ) and K6 (dK/dV), each beside its
plain PyTorch version, and the differentiable ``flash_attention``.

Counterpart of ``cra5_tpu/ops/attention.py``. Given CUDA tensors a wrapper
launches its kernel (``csrc/flash_attn_fwd.cu``, ``csrc/flash_attn_bwd.cu``;
head dim 64, bf16 on tensor cores or float32 on a SIMT tile in full
float32) and counts the launch; given CPU tensors it runs the plain
version. ``FlashAttention`` is the ``custom_vjp`` of the JAX package
as a ``torch.autograd.Function``: its forward keeps (q, k, v, out, lse)
and its backward runs the two backward kernels, so no (N, N) logits are
ever kept for autograd.

Numerics follow the TPU kernels. Forward: q is scaled in float32 and
rounded back to its dtype once, logits and softmax statistics are float32,
P is rounded to v's dtype for the PV product while its row sums stay
float32, and the denominator is clamped at 1e-30. dQ: the same pre-scaled
q, dS rounded to k's dtype for the dS K product, the result scaled and
rounded to q's dtype once. dK/dV: the logits of raw q scaled in float32,
P rounded to dO's dtype for dV and dS to q's dtype for dK, both summed in
float32 and rounded to k's and v's dtype at the end. ``delta =
rowsum(dO * O)`` in float32 is a plain tensor op, as in the JAX package.
Float64 inputs (``gradcheck``) compute in float64 throughout.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels


_KERNEL_DTYPES = {torch.bfloat16: "", torch.float32: "_f32"}


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32 statistics and sums, or float64 for float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def _check_qkv(*ts: torch.Tensor) -> None:
    q = ts[0]
    if q.dim() != 4 or any(t.shape != q.shape for t in ts):
        raise ValueError("q, k and v must share one (B, H, N, D) shape")
    if any(t.dtype != q.dtype for t in ts):
        raise TypeError("q, k and v must share one dtype")
    if any(t.device != q.device for t in ts):
        raise ValueError("q, k and v must lie on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _kernel_entry(name: str, *ts: torch.Tensor):
    """The C entry for the operands' dtype: ``name`` for bf16, ``name_f32``
    for float32 (a SIMT tile in full float32), head dim 64 both."""
    D = ts[0].shape[-1]
    if ts[0].dtype not in _KERNEL_DTYPES or D != 64:
        raise NotImplementedError(
            f"the flash kernels take bf16 or float32 with head dim 64, got {ts[0].dtype} and {D}")
    for t in ts:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the flash kernels' operands must be contiguous and 16-byte aligned")
    return getattr(kernels.lib(), name + _KERNEL_DTYPES[ts[0].dtype])


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------------------ K4
def flash_attention_plain(q, k, v, scale: float):
    """(B, H, N, D) -> (out (B, H, N, D) in q's dtype, lse (B, H, N) f32),
    one (batch, head) slice at a time to bound the (N, N) logits."""
    B, H, N, D = q.shape
    acc = _acc_dtype(q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=acc, device=q.device)
    for b in range(B):
        for h in range(H):
            qs = (q[b, h].to(acc) * scale).to(q.dtype).to(acc)
            logits = qs @ k[b, h].to(acc).T
            m = logits.amax(-1, keepdim=True)
            p = torch.exp(logits - m)
            l = p.sum(-1, keepdim=True).clamp_min(1e-30)
            out[b, h] = ((p.to(v.dtype).to(acc) @ v[b, h].to(acc)) / l).to(q.dtype)
            lse[b, h] = (m + torch.log(l))[:, 0]
    return out, lse


@kernels.counted
def flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: Optional[float] = None):
    """Fused attention forward over (B, H, N, D); returns (out, lse)."""
    _check_qkv(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    entry = _kernel_entry("cra5_flash_attn_fwd", q, k, v)
    B, H, N, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    status = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B * H, N, D, float(scale), _stream(q),
    )
    kernels.check(status, "flash_attention_forward")
    flash_attention_forward.launches += 1
    return out, lse


def _check_backward(q, k, v, dout, lse, delta) -> None:
    _check_qkv(q, k, v, dout)
    rows = q.shape[:3]
    for t, name in ((lse, "lse"), (delta, "delta")):
        if t.shape != rows or t.dtype != _acc_dtype(q.dtype) or t.device != q.device:
            raise ValueError(f"{name} must be {_acc_dtype(q.dtype)} of shape {tuple(rows)} "
                             f"on {q.device}")


# ------------------------------------------------------------------ K5
def flash_attention_backward_dq_plain(q, k, v, dout, lse, delta, scale: float):
    """dQ over (B, H, N, D), one (batch, head) slice at a time."""
    B, H, N, D = q.shape
    acc = _acc_dtype(q.dtype)
    dq = torch.empty_like(q)
    for b in range(B):
        for h in range(H):
            qs = (q[b, h].to(acc) * scale).to(q.dtype).to(acc)
            kf = k[b, h].to(acc)
            p = torch.exp(qs @ kf.T - lse[b, h, :, None])
            dp = dout[b, h].to(acc) @ v[b, h].to(acc).T
            ds = p * (dp - delta[b, h, :, None])
            dq[b, h] = ((ds.to(k.dtype).to(acc) @ kf) * scale).to(q.dtype)
    return dq


@kernels.counted
def flash_attention_backward_dq(q, k, v, dout, lse, delta, scale: float):
    """dQ of attention from the forward's lse rows and delta = rowsum(dO *
    O); (B, H, N, D) operands, (B, H, N) float32 lse and delta."""
    _check_backward(q, k, v, dout, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_backward_dq_plain(q, k, v, dout, lse, delta, scale)
    entry = _kernel_entry("cra5_flash_attn_bwd_dq", q, k, v, dout, lse, delta)
    B, H, N, D = q.shape
    dq = torch.empty_like(q)
    status = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), B * H, N, D, float(scale), _stream(q),
    )
    kernels.check(status, "flash_attention_backward_dq")
    flash_attention_backward_dq.launches += 1
    return dq


# ------------------------------------------------------------------ K6
def flash_attention_backward_dkv_plain(q, k, v, dout, lse, delta, scale: float):
    """(dK, dV) over (B, H, N, D), one (batch, head) slice at a time."""
    B, H, N, D = q.shape
    acc = _acc_dtype(q.dtype)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for b in range(B):
        for h in range(H):
            qf, do = q[b, h].to(acc), dout[b, h].to(acc)
            p = torch.exp((qf @ k[b, h].to(acc).T) * scale - lse[b, h, :, None])
            dv[b, h] = (p.to(dout.dtype).to(acc).T @ do).to(v.dtype)
            dp = do @ v[b, h].to(acc).T
            ds = p * (dp - delta[b, h, :, None])
            dk[b, h] = ((ds.to(q.dtype).to(acc).T @ qf) * scale).to(k.dtype)
    return dk, dv


@kernels.counted
def flash_attention_backward_dkv(q, k, v, dout, lse, delta, scale: float):
    """(dK, dV) of attention, same operands as the dQ wrapper."""
    _check_backward(q, k, v, dout, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_backward_dkv_plain(q, k, v, dout, lse, delta, scale)
    entry = _kernel_entry("cra5_flash_attn_bwd_dkv", q, k, v, dout, lse, delta)
    B, H, N, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    status = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B * H, N, D, float(scale),
        _stream(q),
    )
    kernels.check(status, "flash_attention_backward_dkv")
    flash_attention_backward_dkv.launches += 1
    return dk, dv


# ------------------------------------------------------------------ autograd
class FlashAttention(torch.autograd.Function):
    """Attention whose forward is K4 and whose backward is K5 + K6."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        out, lse = flash_attention_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        acc = _acc_dtype(q.dtype)
        delta = (dout.to(acc) * out.to(acc)).sum(-1)
        dq = flash_attention_backward_dq(q, k, v, dout, lse, delta, ctx.scale)
        dk, dv = flash_attention_backward_dkv(q, k, v, dout, lse, delta, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable fused attention over (B, H, N, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), float(scale))
