"""RMSNorm (port of ``layerskip_tpu/ops/rmsnorm.py``): fp32 reduce, weight
multiply in fp32, result in the input dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             offset: float = 0.0) -> torch.Tensor:
    """``offset=1.0`` multiplies by ``(1 + weight)`` (Gemma convention)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (weight.float() + offset)).to(x.dtype)


def rms_norm_residual(x: torch.Tensor, residual: torch.Tensor,
                      weight: torch.Tensor, eps: float, offset: float = 0.0):
    """``(rms_norm(x + residual), x + residual)``."""
    h = x + residual
    return rms_norm(h, weight, eps, offset), h
