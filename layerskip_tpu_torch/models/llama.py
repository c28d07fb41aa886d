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

Every family of the JAX package runs through the same layer: Qwen2's QKV
biases, Qwen3's per-head q/k norms, Mistral's window, Gemma's ``(1 + w)``
norms, sqrt(D)-scaled embeddings and gelu-tanh MLP, Gemma-2's post-sublayer
norms, softcaps and alternating windows, Gemma-3's local RoPE base on its
sliding layers, and the Mixtral/Qwen3-MoE expert MLP (ops/moe.py). Phi-3 is
Llama once its fused projections are split (models/params.py).

A pass given a ``RouteSink`` (``routes``) puts the experts each MoE layer
chose for a token where the pass writes that token's KV: the continuous
session's route records (generation/continuous.py). Every other caller
passes none.

Under a sharded context (parallel/collectives.py) the weights are this
rank's Megatron slices (parallel/sharding.py): the local head counts come
from the local shapes, ``wo`` and ``w_down`` give partial sums that one
all-reduce over tp completes each, the vocab-parallel embedding looks up
the ids its slice holds and all-reduces, and ``lm_logits`` gathers the
logits of every vocab slice, so every rank holds the same full logits.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from layerskip_tpu_torch.config import ModelConfig, RopeScaling
from layerskip_tpu_torch.ops.attention import gqa_attention
from layerskip_tpu_torch.ops.kv_cache import KVCache, write_kv
from layerskip_tpu_torch.ops.linear import (
    QuantTensor,
    apply_weight,
    apply_weight_t,
    matmul_f32,
)
from layerskip_tpu_torch.ops.moe import moe_mlp
from layerskip_tpu_torch.ops.rmsnorm import rms_norm, rms_norm_residual
from layerskip_tpu_torch.ops.rope import apply_rope, rope_cos_sin, rope_inv_freq
from layerskip_tpu_torch.parallel.collectives import all_gather, all_reduce, axis


@dataclasses.dataclass
class LayerParams:
    """Per-layer weights, stacked on a leading [L] axis (the JAX package's
    storage orientation and field names). The seven matmul weights may be
    ``QuantTensor``s (quant.py), which index per layer the same way; a
    family's optional fields are None where the family has none."""

    attn_norm: torch.Tensor  # [L, D]
    wq: torch.Tensor  # [L, Hq*Dh, D]   ([out, in])
    wk: torch.Tensor  # [L, Hkv*Dh, D]
    wv: torch.Tensor  # [L, Hkv*Dh, D]
    wo: torch.Tensor  # [L, Hq*Dh, D]   ([in, out])
    mlp_norm: torch.Tensor  # [L, D] (Gemma-2/3: the pre-feedforward norm)
    # dense: [L, D, F] / [L, F, D]; MoE (w_router set): [L, E, D, F] / [L, E, F, D]
    w_gate: torch.Tensor
    w_up: torch.Tensor
    w_down: torch.Tensor
    bq: Optional[torch.Tensor] = None  # [L, Hq*Dh]  Qwen2 QKV biases
    bk: Optional[torch.Tensor] = None  # [L, Hkv*Dh]
    bv: Optional[torch.Tensor] = None  # [L, Hkv*Dh]
    w_router: Optional[torch.Tensor] = None  # [L, D, E]  MoE router
    post_attn_norm: Optional[torch.Tensor] = None  # [L, D]  Gemma-2/3
    post_mlp_norm: Optional[torch.Tensor] = None  # [L, D]
    q_norm: Optional[torch.Tensor] = None  # [L, Dh]  Qwen3/Gemma-3, before RoPE
    k_norm: Optional[torch.Tensor] = None  # [L, Dh]


NO_ROUTE = 255  # a route record no pass has written (uint8 ids: at most 255 experts)


@dataclasses.dataclass
class RouteSink:
    """Where a pass's MoE layers put each token's chosen expert ids: ``buf``
    [L, slots, positions, k] (uint8), batch row b of the pass at slot
    ``rows[b]`` (slot b when None), each token at the position where the
    pass writes its KV (clamped to the buffer)."""

    buf: torch.Tensor
    rows: Optional[torch.Tensor] = None  # [B] long

    def flat_index(self, q_positions: torch.Tensor) -> torch.Tensor:
        """[B*T] flat (slot, position) indices of one layer's [slots *
        positions, k] view, for a pass at ``q_positions`` [B, T]."""
        b = q_positions.shape[0]
        n_pos = self.buf.shape[2]
        rows = (self.rows if self.rows is not None
                else torch.arange(b, device=q_positions.device))
        return (rows[:, None] * n_pos + q_positions.clamp(max=n_pos - 1)).reshape(-1)

    def put(self, index: torch.Tensor, layer: int, ids: torch.Tensor) -> None:
        """Layer ``layer``'s ids [B*T, k] at ``index`` (``flat_index``)."""
        self.buf[layer].view(-1, self.buf.shape[-1]).index_copy_(
            0, index, ids.to(self.buf.dtype))


@dataclasses.dataclass
class LlamaParams:
    embed: torch.Tensor  # [V, D]
    layers: LayerParams
    final_norm: torch.Tensor  # [D]
    lm_head: Optional[Union[torch.Tensor, QuantTensor]]  # [D, V]; None => tied


def embed_tokens(params: LlamaParams, ids: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    tp = axis("tp")
    if tp is None:
        h = params.embed[ids]
    else:  # vocab-parallel: ids outside this rank's slice look up 0
        rows = params.embed.shape[0]
        local = ids - tp.rank * rows
        inside = (local >= 0) & (local < rows)
        h = params.embed[local.clamp(0, rows - 1)]
        h = all_reduce(torch.where(inside[..., None], h, torch.zeros_like(h)), tp)
    if cfg.scale_embeddings:
        # Gemma: the sqrt(D) normalizer is cast to the model dtype first
        h = h * torch.tensor(cfg.hidden_size ** 0.5, dtype=h.dtype, device=h.device)
    return h


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The MLP gate's activation: gelu-tanh for Gemma, silu otherwise."""
    if cfg.hidden_act in ("gelu_pytorch_tanh", "gelu"):
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


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
    tree_meta=None,  # tree chains (ops/attention.gqa_attention)
    window: Optional[int] = None,  # this layer's window (0 = global)
    routes: Optional[RouteSink] = None,
    route_index: Optional[torch.Tensor] = None,  # routes.flat_index of the pass
) -> torch.Tensor:
    b, t, _ = h.shape
    dh = cfg.head_dim  # the head counts are this rank's (the weights' local shapes)
    eps, off = cfg.rms_norm_eps, cfg.norm_offset
    tp = axis("tp")
    x = rms_norm(h, layers.attn_norm[i], eps, off)
    q = apply_weight_t(x, layers.wq[i])
    k = apply_weight_t(x, layers.wk[i])
    v = apply_weight_t(x, layers.wv[i])
    if layers.bq is not None:  # Qwen2
        q = q + layers.bq[i]
        k = k + layers.bk[i]
        v = v + layers.bv[i]
    q = q.reshape(b, t, -1, dh)
    k = k.reshape(b, t, -1, dh)
    v = v.reshape(b, t, -1, dh)
    if layers.q_norm is not None:  # Qwen3, Gemma-3: per-head norms before RoPE
        q = rms_norm(q, layers.q_norm[i], eps, off)
        k = rms_norm(k, layers.k_norm[i], eps, off)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    write_kv(k_layer, v_layer, k, v, write_pos)
    attn = gqa_attention(
        q, k_layer, v_layer, q_positions, q_heads_per_kv=cfg.q_heads_per_kv,
        past_scalar=past_scalar,
        sliding_window=cfg.sliding_window if window is None else window,
        tree_meta=tree_meta,
        score_scale=(cfg.query_pre_attn_scalar ** -0.5
                     if cfg.query_pre_attn_scalar else None),
        logit_softcap=cfg.attn_logit_softcap,
    )
    attn_out = all_reduce(apply_weight(attn.reshape(b, t, -1), layers.wo[i]), tp)
    if layers.post_attn_norm is not None:  # Gemma-2/3: norm the sublayer's output
        attn_out = rms_norm(attn_out, layers.post_attn_norm[i], eps, off)
    x, h = rms_norm_residual(attn_out, h, layers.mlp_norm[i], eps, off)
    if layers.w_router is not None:
        routes_out = (None if route_index is None
                      else functools.partial(routes.put, route_index, i))
        mlp_out, _ = moe_mlp(x, layers.w_router[i], layers.w_gate[i], layers.w_up[i],
                             layers.w_down[i], cfg.num_experts_per_tok,
                             norm_topk=cfg.norm_topk_prob, routes_out=routes_out)
    else:
        gated = _act(cfg, apply_weight(x, layers.w_gate[i])) * apply_weight(x, layers.w_up[i])
        mlp_out = apply_weight(gated, layers.w_down[i])
    mlp_out = all_reduce(mlp_out, tp)
    if layers.post_mlp_norm is not None:
        mlp_out = rms_norm(mlp_out, layers.post_mlp_norm[i], eps, off)
    return h + mlp_out


def run_layers(
    cfg: ModelConfig,
    layers: LayerParams,  # FULL stacked [L, ...] weights
    h: torch.Tensor,  # [B, T, D]
    k: torch.Tensor,  # [Lsub, B, S, Hkv, Dh] — KV of the layer group being run
    v: torch.Tensor,
    past_len: Union[int, torch.Tensor],  # int (shared) or [B] tensor (per row)
    layer_offset: int = 0,  # group = layers [offset, offset + Lsub)
    q_positions: Optional[torch.Tensor] = None,  # override: [B, T] or [T]
    write_pos: Union[None, int, torch.Tensor] = None,  # override: KV write slot(s)
    tree_meta=None,  # tree chains (ops/attention.gqa_attention)
    routes: Optional[RouteSink] = None,  # where MoE layers put their expert ids
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run a contiguous layer range; returns (h, k, v) with k/v updated in
    place. An int ``past_len`` gives every row the same contiguous positions
    (the flash-prefill kernel may run); a [B] tensor gives each row its own
    positions, frontier and KV write offset (the masked path).

    ``q_positions`` / ``write_pos`` decouple logical positions from cache
    slots (tree speculation writes several same-position chain tokens to
    distinct interleaved slots, generation/tree.py); with ``q_positions``
    the positions are never taken as one shared past, so K1 never runs.

    ``routes`` (MoE layers only) takes each token's expert ids at its query
    position, where the KV of a pass without ``write_pos`` goes.

    Gemma-2/3 choose each layer's window on the host from
    ``cfg.sliding_layer_flags`` (a Python int, 0 = global, for the kernels'
    runtime window), and Gemma-3's sliding layers take the cos/sin of
    ``rope_local_theta``; both tables are built once per call."""
    b, t, _ = h.shape
    if isinstance(past_len, torch.Tensor) and past_len.dim() == 0:
        past_len = int(past_len)
    steps = torch.arange(t, device=h.device)
    if q_positions is not None:
        past_scalar = None
        q_positions = q_positions.long().expand(b, t)
    elif isinstance(past_len, int):
        past_scalar = past_len
        q_positions = (past_len + steps).expand(b, t)
    else:
        past_scalar = None
        past_len = past_len.long()
        q_positions = past_len[:, None] + steps
    kv_write_pos = past_len if write_pos is None else write_pos
    route_index = None
    if routes is not None and layers.w_router is not None:
        if write_pos is not None:
            raise ValueError("route records follow the query positions: no write_pos")
        route_index = routes.flat_index(q_positions)
    cos, sin = rope_cos_sin(q_positions, rope_inv_freq(cfg, h.device))
    flags = cfg.sliding_layer_flags
    local = None
    if cfg.rope_local_theta and (flags is not None or cfg.sliding_window):
        local_cfg = dataclasses.replace(cfg, rope_theta=cfg.rope_local_theta,
                                        rope_scaling=RopeScaling())
        local = rope_cos_sin(q_positions, rope_inv_freq(local_cfg, h.device))
    for j in range(k.shape[0]):
        i = layer_offset + j
        window, cs = None, (cos, sin)
        if flags is not None:
            window = cfg.sliding_window if flags[i] else 0
            if local is not None and flags[i]:
                cs = local
        elif local is not None:  # every layer slides: the local base throughout
            cs = local
        h = _one_layer(cfg, layers, i, h, k[j], v[j], *cs, kv_write_pos, q_positions,
                       past_scalar, tree_meta, window, routes, route_index)
    return h, k, v


def lm_logits(params: LlamaParams, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Shared final norm + LM head, fp32 logits. A quantized head takes the
    fp32 hidden states (K5 or K6 at fp32)."""
    h = rms_norm(h, params.final_norm, cfg.rms_norm_eps, cfg.norm_offset)
    head = params.lm_head if params.lm_head is not None else params.embed.T
    if isinstance(head, QuantTensor):
        logits = apply_weight(h.float(), head)
    else:
        logits = matmul_f32(h, head)
    logits = all_gather(logits, axis("tp"), dim=-1)  # vocab slices, in rank order
    if cfg.final_logit_softcap:  # Gemma-2, on the fp32 logits
        cap = float(cfg.final_logit_softcap)
        logits = cap * torch.tanh(logits / cap)
    return logits


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
    h = embed_tokens(params, ids, cfg)
    h, k, v = run_layers(cfg, params.layers, h, cache.k, cache.v, past_len)
    return ForwardResult(logits=lm_logits(params, cfg, h),
                         cache=KVCache(k=k, v=v), hidden=h)


def forward_early(params: LlamaParams, cfg: ModelConfig, ids: torch.Tensor,
                  early_cache: KVCache, draft_len, exit_layer: int,
                  routes: Optional[RouteSink] = None) -> ForwardResult:
    """Draft pass: layers [0, exit_layer) + shared norm/head, over the early
    group's cache only."""
    h = embed_tokens(params, ids, cfg)
    h, ke, ve = run_layers(cfg, params.layers, h, early_cache.k, early_cache.v,
                           draft_len, layer_offset=0, routes=routes)
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
    routes: Optional[RouteSink] = None,
) -> RemainderResult:
    """Verification pass: early layers run the last draft token at
    ``draft_len``; full layers run the stitched window
    ``cat(exit_hidden, h_last)`` at ``full_len``. Returns fp32 logits over
    the window; both groups then hold ``full_len + W + 1`` valid positions."""
    h1 = embed_tokens(params, last_draft_token, cfg)
    h1, ke, ve = run_layers(cfg, params.layers, h1, early_cache.k,
                            early_cache.v, draft_len, layer_offset=0, routes=routes)
    full_h = torch.cat([exit_hidden, h1], dim=1)
    full_h, kf, vf = run_layers(cfg, params.layers, full_h, full_cache.k,
                                full_cache.v, full_len, layer_offset=exit_layer,
                                routes=routes)
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
    routes: Optional[RouteSink] = None,
) -> RemainderResult:
    """Full-model forward over the split early/full caches (engine prefill)."""
    h = embed_tokens(params, ids, cfg)
    h, ke, ve = run_layers(cfg, params.layers, h, early_cache.k, early_cache.v,
                           past_len, layer_offset=0, routes=routes)
    h, kf, vf = run_layers(cfg, params.layers, h, full_cache.k, full_cache.v,
                           past_len, layer_offset=exit_layer, routes=routes)
    if last_pos is not None:
        rows = torch.arange(h.shape[0], device=h.device)
        h = h[rows, last_pos.long()][:, None]  # [B, 1, D]
    return RemainderResult(logits=lm_logits(params, cfg, h),
                           early_cache=KVCache(k=ke, v=ve),
                           full_cache=KVCache(k=kf, v=vf))
