"""Dense weight products (the dense half of ``layerskip_tpu/ops/linear.py``).

These are plain large matrix products, which the JAX package leaves to XLA;
here they go to ``torch.matmul``. Quantized weights (``QuantTensor``) belong
to a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def apply_weight(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] -> [..., N]."""
    return torch.matmul(x, w)


def apply_weight_t(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w^T where w is stored [N, K] (HF [out, in] orientation)."""
    return F.linear(x, w)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ b [K, N] accumulated AND returned in fp32.

    The JAX package asks XLA for fp32 results of bf16 products
    (``preferred_element_type``); a bf16 ``torch.matmul`` would round them
    to bf16, and rounded logits tie where fp32 ones do not. On CUDA the
    product takes bf16 operands with an fp32 output (``torch.mm``'s
    ``out_dtype``); elsewhere the operands are upcast, which gives the same
    exact products.
    """
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda and a.dtype == b.dtype and hasattr(torch.ops.aten.mm, "dtype"):
        lead = a.shape[:-1]
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*lead, b.shape[-1])
    return torch.matmul(a.float(), b.float())
