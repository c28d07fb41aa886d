"""Preallocated KV cache (port of ``layerskip_tpu/ops/kv_cache.py``).

The cache is a pair of ``[L, B, S_max, H_kv, Dh]`` buffers; rollback after a
rejected speculation is a counter update, never a copy. Unlike the JAX
package, writes are IN PLACE: ``write_kv`` stores into the given layer
buffers (views of the stacked cache) and returns them, so a cache passed to
a forward function is updated by it. ``QuantKV`` is the int8 cache
(``GenerationConfig.kv_quant``), written in place the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from layerskip_tpu_torch.config import ModelConfig


@dataclasses.dataclass
class KVCache:
    """Preallocated KV for a group of layers. k/v: [L, B, S_max, H_kv, Dh]."""

    k: torch.Tensor
    v: torch.Tensor


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                  device="cuda") -> KVCache:
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads,
             cfg.head_dim)
    dtype = dtype or cfg.dtype
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _store(buf: torch.Tensor, new: torch.Tensor, write_pos: Union[int, torch.Tensor]):
    """buf [B, S, ...] <- new [B, T, ...] at sequence offset ``write_pos`` (an
    int, or a [B] tensor of per-row offsets), in place. As
    ``jax.lax.dynamic_update_slice`` does, the start is clamped to
    ``[0, S - T]``, so a block never runs past the buffer's end."""
    b, t = new.shape[:2]
    s = buf.shape[1]
    if isinstance(write_pos, torch.Tensor) and write_pos.dim() == 0:
        write_pos = int(write_pos)
    if isinstance(write_pos, int):
        start = min(max(write_pos, 0), s - t)
        buf[:, start:start + t] = new
        return
    start = write_pos.long().clamp(0, s - t)
    slots = start[:, None] + torch.arange(t, device=buf.device)  # [B, T]
    buf[torch.arange(b, device=buf.device)[:, None], slots] = new


@dataclasses.dataclass
class QuantKV:
    """int8 KV buffer with per-(token, head) symmetric scales.

    q: [..., S, H, Dh] int8; scale: [..., S, H] bf16, as in the JAX package.
    A stacked [L, B, S, H, Dh] buffer indexes per layer as ``kv[i]`` (views).
    """

    q: torch.Tensor
    scale: torch.Tensor

    @staticmethod
    def zeros(shape, device) -> "QuantKV":
        return QuantKV(q=torch.zeros(shape, dtype=torch.int8, device=device),
                       scale=torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device))

    @property
    def shape(self):
        return self.q.shape

    def __getitem__(self, idx) -> "QuantKV":
        return QuantKV(q=self.q[idx], scale=self.scale[idx])

    def write(self, new: torch.Tensor, write_pos: Union[int, torch.Tensor]) -> "QuantKV":
        """Quantize a [B, T, H, Dh] block and store it at ``write_pos`` (a
        shared frontier or [B] per-row frontiers), in place. The values are
        rounded with the fp32 scale, which is then stored in bf16."""
        nf = new.float()
        scale = (nf.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)  # [B, T, H]
        q = torch.round(nf / scale[..., None]).clamp(-127, 127).to(torch.int8)
        _store(self.q, q, write_pos)
        _store(self.scale, scale.to(self.scale.dtype), write_pos)
        return self

    def dequantize(self, dtype) -> torch.Tensor:
        return (self.q.float() * self.scale.float()[..., None]).to(dtype)


def init_quant_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                        device="cuda") -> KVCache:
    """KVCache whose k/v are stacked QuantKV buffers ([L, B, S, H, Dh])."""
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads,
             cfg.head_dim)
    return KVCache(k=QuantKV.zeros(shape, device), v=QuantKV.zeros(shape, device))


def write_kv(k_layer, v_layer, k_new: torch.Tensor, v_new: torch.Tensor,
             write_pos: Union[int, torch.Tensor]):
    """Store [B, T, H, Dh] blocks at sequence offset ``write_pos`` in place.

    ``k_layer``/``v_layer`` are [B, S, H, Dh] tensors or per-layer
    ``QuantKV`` buffers. ``write_pos`` is an int (one frontier for every row)
    or a [B] tensor (per-row frontiers); see ``_store`` for the clamp.
    Positions beyond the valid length may hold stale data; the attention
    mask (key ``j <= q_pos``) never reads them.
    """
    if isinstance(k_layer, QuantKV):
        return k_layer.write(k_new, write_pos), v_layer.write(v_new, write_pos)
    _store(k_layer, k_new, write_pos)
    _store(v_layer, v_new, write_pos)
    return k_layer, v_layer
