"""Rotary position embeddings, HF-Llama "rotate_half" convention, all in fp32
(port of ``layerskip_tpu/ops/rope.py``)."""

from __future__ import annotations

import math

import torch

from layerskip_tpu_torch.config import ModelConfig


def rope_inv_freq(cfg: ModelConfig, device=None) -> torch.Tensor:
    """Per-channel inverse frequencies, fp32, shape [head_dim // 2], with
    llama3 and linear frequency scaling."""
    half = cfg.head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    inv_freq = 1.0 / (cfg.rope_theta ** exponent)
    rs = cfg.rope_scaling
    if rs.rope_type == "llama3":
        low_wl = rs.original_max_position_embeddings / rs.low_freq_factor
        high_wl = rs.original_max_position_embeddings / rs.high_freq_factor
        wavelen = 2.0 * math.pi / inv_freq
        scaled = inv_freq / rs.factor
        smooth = (rs.original_max_position_embeddings / wavelen
                  - rs.low_freq_factor) / (rs.high_freq_factor - rs.low_freq_factor)
        smoothed = (1.0 - smooth) * scaled + smooth * inv_freq
        is_low = wavelen > low_wl
        is_high = wavelen < high_wl
        mid = ~is_low & ~is_high
        inv_freq = torch.where(is_low, scaled, inv_freq)
        inv_freq = torch.where(mid, smoothed, inv_freq)
    elif rs.rope_type == "linear":
        inv_freq = inv_freq / rs.factor
    return inv_freq


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor):
    """cos/sin tables for absolute ``positions`` (any shape), fp32, shape
    ``positions.shape + (head_dim,)`` (half-table duplicated, HF style)."""
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, Dh]; cos/sin [B, T, Dh] (broadcast over heads)."""
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)
