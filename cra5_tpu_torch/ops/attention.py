"""K4: the flash-attention forward, beside its plain PyTorch version.

Counterpart of the forward half of ``cra5_tpu/ops/attention.py``. Given
CUDA tensors the wrapper launches ``csrc/flash_attn_fwd.cu`` (bf16, head
dim 64) and counts the launch; given CPU tensors it runs the plain version.
Both return the attention output and the float32 log-sum-exp rows, which
the flash backward of the training slice will need.

Numerics follow the TPU kernel: q is scaled in float32 and rounded back to
its dtype once, logits and softmax statistics are float32, P is rounded to
v's dtype for the PV product while its row sums stay float32, and the
denominator is clamped at 1e-30.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels


def flash_attention_plain(q, k, v, scale: float):
    """(B, H, N, D) -> (out (B, H, N, D) in q's dtype, lse (B, H, N) f32),
    one (batch, head) slice at a time to bound the (N, N) logits."""
    B, H, N, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    for b in range(B):
        for h in range(H):
            qs = (q[b, h].float() * scale).to(q.dtype).float()
            logits = qs @ k[b, h].float().T
            m = logits.amax(-1, keepdim=True)
            p = torch.exp(logits - m)
            l = p.sum(-1, keepdim=True).clamp_min(1e-30)
            out[b, h] = ((p.to(v.dtype).float() @ v[b, h].float()) / l).to(q.dtype)
            lse[b, h] = (m + torch.log(l))[:, 0]
    return out, lse


@kernels.counted
def flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: Optional[float] = None):
    """Fused attention forward over (B, H, N, D); returns (out, lse)."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("q, k and v must share one (B, H, N, D) shape")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, N, D = q.shape
    if q.dtype != torch.bfloat16 or D != 64:
        raise NotImplementedError(
            f"the flash kernel takes bf16 with head dim 64, got {q.dtype} and {D}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("q, k and v must be contiguous and 16-byte aligned")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    status = kernels.lib().cra5_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B * H, N, D, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(status, "flash_attention_forward")
    flash_attention_forward.launches += 1
    return out, lse
