"""Grouped-query attention over the static KV cache (port of
``layerskip_tpu/ops/attention.py``).

One masking rule, ``key_slot <= query_position``, covers prefill, one-token
drafting and the verification window; masks are built from position
counters, never stored. Scores and softmax are fp32 and the weighted sum
returns in the activation dtype.

Dispatch: a prompt block with one shared past (``past_scalar``), no tree,
more than 16 queries and a head_dim the kernel takes goes to
``flash_prefill_attention``, which launches the CUDA kernel for CUDA tensors
and runs its plain version for CPU tensors. Every other call (one-token
drafts, the verify window, per-row pasts) takes the masked path below, as
the JAX package's contiguous-cache decode does.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from layerskip_tpu_torch.ops.cuda.flash_prefill import (
    HEAD_DIMS,
    flash_prefill_attention,
)

NEG_INF = -1e30  # large-but-finite: avoids NaNs from (-inf) - (-inf)
_MAX_SHORT_QUERY = 16  # drafts (T=1) and verify windows (T=W+1) stay masked


def gqa_attention(
    q: torch.Tensor,  # [B, T, Hq, Dh] (post-RoPE)
    k_cache: torch.Tensor,  # [B, S, Hkv, Dh] (post-RoPE, updated)
    v_cache: torch.Tensor,  # [B, S, Hkv, Dh]
    q_positions: torch.Tensor,  # [T] or [B, T] absolute query positions
    *,
    q_heads_per_kv: int,
    past_scalar: Optional[int] = None,  # set when positions are past + arange(T)
    sliding_window: Union[None, int, torch.Tensor] = None,  # int, or a 0-d
    # tensor (runtime window, 0 = global)
    tree_meta=None,
    score_scale: Optional[float] = None,  # None/0 => head_dim ** -0.5
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Returns attention output [B, T, Hq, Dh] in q's dtype."""
    if tree_meta is not None:
        raise NotImplementedError("tree attention is not ported yet")
    b, t, hq, dh = q.shape
    if past_scalar is not None and t > _MAX_SHORT_QUERY and dh in HEAD_DIMS:
        return flash_prefill_attention(
            q, k_cache, v_cache, int(past_scalar),
            q_heads_per_kv=q_heads_per_kv,
            sliding_window=int(sliding_window or 0),
            score_scale=float(score_scale or 0.0),
            logit_softcap=float(logit_softcap or 0.0),
        )
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = q_heads_per_kv
    assert hq == hkv * g, (hq, hkv, g)
    q_positions = q_positions.long().expand(b, t)

    qg = q.reshape(b, t, hkv, g, dh)
    # fp32 scores from the operands' exact products: [B, Hkv, G, T, S]
    scores = torch.einsum("bthgd,bshd->bhgts", qg.float(), k_cache.float())
    scores = scores * (float(score_scale) if score_scale else dh ** -0.5)
    if logit_softcap:
        cap = float(logit_softcap)
        scores = cap * torch.tanh(scores / cap)

    key_idx = torch.arange(s, device=q.device)
    q_pos = q_positions[:, :, None]  # [B, T, 1]
    mask = key_idx[None, None, :] <= q_pos  # [B, T, S]
    if isinstance(sliding_window, torch.Tensor):
        win = sliding_window.long()
        mask &= (win <= 0) | (key_idx[None, None, :] > q_pos - win)
    elif sliding_window:
        mask &= key_idx[None, None, :] > q_pos - int(sliding_window)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)

    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhgts,bshd->bthgd", probs.to(v_cache.dtype).float(), v_cache.float()
    )
    return out.reshape(b, t, hq, dh).to(q.dtype)
