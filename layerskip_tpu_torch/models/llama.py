"""Llama decoder as plain functions over stacked weights (port of
``layerskip_tpu/models/llama.py``).

  * ``forward``           — all layers
  * ``forward_early``     — layers ``[0, exit_layer)`` + shared norm/head (draft)
  * ``forward_remainder`` — the verification pass over the speculation window
  * ``forward_split``     — all layers over the split early/full caches (prefill)

Per-layer weights stay stacked on a leading ``[L]`` axis; ``w[i]`` is a view,
so running a layer range copies no weights. A Python loop over layers takes
the place of ``lax.scan``. KV caches are written in place (ops/kv_cache.py),
so the caches in a result are the caches that were passed in.

This slice carries dense Llama only: a config with another family's features
raises ``NotImplementedError`` instead of running wrong.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from layerskip_tpu_torch.config import ModelConfig
from layerskip_tpu_torch.ops.attention import gqa_attention
from layerskip_tpu_torch.ops.kv_cache import KVCache, write_kv
from layerskip_tpu_torch.ops.linear import (
    QuantTensor,
    apply_weight,
    apply_weight_t,
    matmul_f32,
)
from layerskip_tpu_torch.ops.rmsnorm import rms_norm, rms_norm_residual
from layerskip_tpu_torch.ops.rope import apply_rope, rope_cos_sin, rope_inv_freq


@dataclasses.dataclass
class LayerParams:
    """Per-layer weights, stacked on a leading [L] axis (the JAX package's
    storage orientation). The seven matmul weights may be ``QuantTensor``s
    (quant.py), which index per layer the same way."""

    attn_norm: torch.Tensor  # [L, D]
    wq: torch.Tensor  # [L, Hq*Dh, D]   ([out, in])
    wk: torch.Tensor  # [L, Hkv*Dh, D]
    wv: torch.Tensor  # [L, Hkv*Dh, D]
    wo: torch.Tensor  # [L, Hq*Dh, D]   ([in, out])
    mlp_norm: torch.Tensor  # [L, D]
    w_gate: torch.Tensor  # [L, D, F]
    w_up: torch.Tensor  # [L, D, F]
    w_down: torch.Tensor  # [L, F, D]


@dataclasses.dataclass
class LlamaParams:
    embed: torch.Tensor  # [V, D]
    layers: LayerParams
    final_norm: torch.Tensor  # [D]
    lm_head: Optional[Union[torch.Tensor, QuantTensor]]  # [D, V]; None => tied


# family features this slice does not carry, by ModelConfig field
_UNSUPPORTED = (
    ("attention_bias", "QKV biases"),
    ("qk_norm", "q/k norms"),
    ("num_local_experts", "mixture-of-experts MLPs"),
    ("post_norms", "post-sublayer norms"),
    ("sliding_layer_flags", "per-layer sliding windows"),
    ("rope_local_theta", "a local RoPE base"),
    ("rms_norm_offset", "the (1 + w) norm"),
    ("scale_embeddings", "scaled embeddings"),
    ("final_logit_softcap", "final logit soft-capping"),
)


def check_supported(cfg: ModelConfig) -> None:
    for field, what in _UNSUPPORTED:
        if getattr(cfg, field):
            raise NotImplementedError(f"{what} ({field}) is not ported yet")
    if cfg.hidden_act != "silu":
        raise NotImplementedError(f"activation {cfg.hidden_act!r} is not ported yet")


def embed_tokens(params: LlamaParams, ids: torch.Tensor) -> torch.Tensor:
    return params.embed[ids]


def _one_layer(
    cfg: ModelConfig,
    layers: LayerParams,
    i: int,  # absolute layer index into the stacked weights
    h: torch.Tensor,  # [B, T, D]
    k_layer: torch.Tensor,  # [B, S, Hkv, Dh]
    v_layer: torch.Tensor,
    cos: torch.Tensor,  # [B, T, Dh]
    sin: torch.Tensor,
    write_pos: Union[int, torch.Tensor],
    q_positions: torch.Tensor,  # [B, T]
    past_scalar: Optional[int],
) -> torch.Tensor:
    b, t, _ = h.shape
    hq, hkv, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    x = rms_norm(h, layers.attn_norm[i], cfg.rms_norm_eps)
    q = apply_weight_t(x, layers.wq[i]).reshape(b, t, hq, dh)
    k = apply_weight_t(x, layers.wk[i]).reshape(b, t, hkv, dh)
    v = apply_weight_t(x, layers.wv[i]).reshape(b, t, hkv, dh)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    write_kv(k_layer, v_layer, k, v, write_pos)
    attn = gqa_attention(
        q, k_layer, v_layer, q_positions, q_heads_per_kv=cfg.q_heads_per_kv,
        past_scalar=past_scalar, sliding_window=cfg.sliding_window,
        score_scale=(cfg.query_pre_attn_scalar ** -0.5
                     if cfg.query_pre_attn_scalar else None),
        logit_softcap=cfg.attn_logit_softcap,
    )
    attn_out = apply_weight(attn.reshape(b, t, hq * dh), layers.wo[i])
    x, h = rms_norm_residual(attn_out, h, layers.mlp_norm[i], cfg.rms_norm_eps)
    gated = F.silu(apply_weight(x, layers.w_gate[i])) * apply_weight(x, layers.w_up[i])
    return h + apply_weight(gated, layers.w_down[i])


def run_layers(
    cfg: ModelConfig,
    layers: LayerParams,  # FULL stacked [L, ...] weights
    h: torch.Tensor,  # [B, T, D]
    k: torch.Tensor,  # [Lsub, B, S, Hkv, Dh] — KV of the layer group being run
    v: torch.Tensor,
    past_len: Union[int, torch.Tensor],  # int (shared) or [B] tensor (per row)
    layer_offset: int = 0,  # group = layers [offset, offset + Lsub)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run a contiguous layer range; returns (h, k, v) with k/v updated in
    place. An int ``past_len`` gives every row the same contiguous positions
    (the flash-prefill kernel may run); a [B] tensor gives each row its own
    positions, frontier and KV write offset (the masked path)."""
    check_supported(cfg)
    b, t, _ = h.shape
    if isinstance(past_len, torch.Tensor) and past_len.dim() == 0:
        past_len = int(past_len)
    steps = torch.arange(t, device=h.device)
    if isinstance(past_len, int):
        past_scalar = past_len
        q_positions = (past_len + steps).expand(b, t)
    else:
        past_scalar = None
        past_len = past_len.long()
        q_positions = past_len[:, None] + steps
    cos, sin = rope_cos_sin(q_positions, rope_inv_freq(cfg, h.device))
    for j in range(k.shape[0]):
        h = _one_layer(cfg, layers, layer_offset + j, h, k[j], v[j], cos, sin,
                       past_len, q_positions, past_scalar)
    return h, k, v


def lm_logits(params: LlamaParams, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Shared final norm + LM head, fp32 logits. A quantized head takes the
    fp32 hidden states (K5 or K6 at fp32)."""
    h = rms_norm(h, params.final_norm, cfg.rms_norm_eps)
    head = params.lm_head if params.lm_head is not None else params.embed.T
    if isinstance(head, QuantTensor):
        return apply_weight(h.float(), head)
    return matmul_f32(h, head)


@dataclasses.dataclass
class ForwardResult:
    logits: torch.Tensor  # [B, T, V] fp32
    cache: KVCache
    hidden: torch.Tensor  # [B, T, D] pre-final-norm hidden at the last run layer


@dataclasses.dataclass
class RemainderResult:
    logits: torch.Tensor  # [B, W+1, V] fp32 (or [B, 1, V] with last_pos)
    early_cache: KVCache
    full_cache: KVCache


def forward(params: LlamaParams, cfg: ModelConfig, ids: torch.Tensor,
            cache: KVCache, past_len) -> ForwardResult:
    """Full-model forward."""
    h = embed_tokens(params, ids)
    h, k, v = run_layers(cfg, params.layers, h, cache.k, cache.v, past_len)
    return ForwardResult(logits=lm_logits(params, cfg, h),
                         cache=KVCache(k=k, v=v), hidden=h)


def forward_early(params: LlamaParams, cfg: ModelConfig, ids: torch.Tensor,
                  early_cache: KVCache, draft_len, exit_layer: int) -> ForwardResult:
    """Draft pass: layers [0, exit_layer) + shared norm/head, over the early
    group's cache only."""
    h = embed_tokens(params, ids)
    h, ke, ve = run_layers(cfg, params.layers, h, early_cache.k, early_cache.v,
                           draft_len, layer_offset=0)
    return ForwardResult(logits=lm_logits(params, cfg, h),
                         cache=KVCache(k=ke, v=ve), hidden=h)


def forward_remainder(
    params: LlamaParams,
    cfg: ModelConfig,
    last_draft_token: torch.Tensor,  # [B, 1] — the one token early layers haven't seen
    exit_hidden: torch.Tensor,  # [B, W, D] — exit-layer activations of the window prefix
    early_cache: KVCache,  # layers [0, E)
    full_cache: KVCache,  # layers [E, L)
    draft_len,  # early-group past length (== full_len + W)
    full_len,  # full-group past length
    exit_layer: int,
) -> RemainderResult:
    """Verification pass: early layers run the last draft token at
    ``draft_len``; full layers run the stitched window
    ``cat(exit_hidden, h_last)`` at ``full_len``. Returns fp32 logits over
    the window; both groups then hold ``full_len + W + 1`` valid positions."""
    h1 = embed_tokens(params, last_draft_token)
    h1, ke, ve = run_layers(cfg, params.layers, h1, early_cache.k,
                            early_cache.v, draft_len, layer_offset=0)
    full_h = torch.cat([exit_hidden, h1], dim=1)
    full_h, kf, vf = run_layers(cfg, params.layers, full_h, full_cache.k,
                                full_cache.v, full_len, layer_offset=exit_layer)
    return RemainderResult(logits=lm_logits(params, cfg, full_h),
                           early_cache=KVCache(k=ke, v=ve),
                           full_cache=KVCache(k=kf, v=vf))


def forward_split(
    params: LlamaParams,
    cfg: ModelConfig,
    ids: torch.Tensor,  # [B, T]
    early_cache: KVCache,  # layers [0, E)
    full_cache: KVCache,  # layers [E, L)
    past_len,  # int or [B] tensor (both groups aligned)
    exit_layer: int,
    last_pos: Optional[torch.Tensor] = None,  # [B]: logits only at this
    # position per row, returned as [B, 1, V]
) -> RemainderResult:
    """Full-model forward over the split early/full caches (engine prefill)."""
    h = embed_tokens(params, ids)
    h, ke, ve = run_layers(cfg, params.layers, h, early_cache.k, early_cache.v,
                           past_len, layer_offset=0)
    h, kf, vf = run_layers(cfg, params.layers, h, full_cache.k, full_cache.v,
                           past_len, layer_offset=exit_layer)
    if last_pos is not None:
        rows = torch.arange(h.shape[0], device=h.device)
        h = h[rows, last_pos.long()][:, None]  # [B, 1, D]
    return RemainderResult(logits=lm_logits(params, cfg, h),
                           early_cache=KVCache(k=ke, v=ve),
                           full_cache=KVCache(k=kf, v=vf))
