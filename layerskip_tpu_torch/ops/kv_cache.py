"""Preallocated KV cache (port of ``layerskip_tpu/ops/kv_cache.py``).

The cache is a pair of ``[L, B, S_max, H_kv, Dh]`` buffers; rollback after a
rejected speculation is a counter update, never a copy. Unlike the JAX
package, writes are IN PLACE: ``write_kv`` stores into the given layer
buffers (views of the stacked cache) and returns them, so a cache passed to
a forward function is updated by it.
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


def write_kv(k_layer: torch.Tensor, v_layer: torch.Tensor,
             k_new: torch.Tensor, v_new: torch.Tensor,
             write_pos: Union[int, torch.Tensor]):
    """Store [B, T, H, Dh] blocks at sequence offset ``write_pos`` in place.

    ``write_pos`` is an int (one frontier for every row) or a [B] tensor
    (per-row frontiers). As ``jax.lax.dynamic_update_slice`` does in the JAX
    package, the start is clamped to ``[0, S - T]``, so a block never runs
    past the buffer's end. Positions beyond the valid length may hold stale
    data; the attention mask (key ``j <= q_pos``) never reads them.
    """
    b, t = k_new.shape[:2]
    s = k_layer.shape[1]
    if isinstance(write_pos, torch.Tensor) and write_pos.dim() == 0:
        write_pos = int(write_pos)
    if isinstance(write_pos, int):
        start = min(max(write_pos, 0), s - t)
        k_layer[:, start:start + t] = k_new
        v_layer[:, start:start + t] = v_new
        return k_layer, v_layer
    start = write_pos.long().clamp(0, s - t)
    slots = start[:, None] + torch.arange(t, device=k_layer.device)  # [B, T]
    rows = torch.arange(b, device=k_layer.device)[:, None]
    k_layer[rows, slots] = k_new
    v_layer[rows, slots] = v_new
    return k_layer, v_layer
