"""Plain PyTorch references that decide ``correct``, one file a model
family (``<family>.py``: ``logits_at(w, hf, seqs, spans, precision)``),
and the precisions they compute in. They import neither JAX nor anything
of the program under test."""

from __future__ import annotations

import contextlib

import torch

_FP8_MAX = 448.0


@contextlib.contextmanager
def float32_exact():
    """float32 products in float32 (no TF32) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, scaled so each slice along ``dim``
    spans the format, back in float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
