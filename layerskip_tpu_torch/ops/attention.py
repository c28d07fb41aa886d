"""Grouped-query attention over the static KV cache (port of
``layerskip_tpu/ops/attention.py``).

One masking rule, ``key_slot <= query_position``, covers prefill, one-token
drafting and the verification window; masks are built from position
counters, never stored. Scores and softmax are fp32 and the weighted sum
returns in the activation dtype.

Dispatch, as in the JAX package:

  * a paged cache (``PagedKV``/``PagedQuantKV``, ops/paged_kv.py) with at
    most 16 queries and a head_dim the kernels take goes to K2 or K3
    (``ops/cuda/paged_decode.py``), which read the pages in place, the tree
    clause included (tree drafts and verify windows); any other
    paged call (the insert prefill of a prompt bucket, at past 0 or at
    per-row prefix lengths) gathers the logical view in q's dtype and goes
    on below;
  * a prompt block with one shared past (``past_scalar``), no tree, more
    than 16 queries and a head_dim the kernel takes goes to
    ``flash_prefill_attention`` (K1);
  * every other call (one-token drafts, the verify window, per-row pasts)
    takes the masked path below, as the JAX package's contiguous-cache
    decode does. An int8 cache (``QuantKV``) is first dequantized to q's
    dtype, as the JAX package does, and then takes the same dispatch.

Tree speculation (generation/tree.py) keeps ``fanout`` draft chains in
interleaved slots past a row's scratch start: slot ``scratch + d * fanout +
c`` holds depth ``d + 1`` of chain ``c``. ``tree_meta`` = (query chains [B, T],
scratch starts [] or [B], fanout) adds one clause to the rule: a key in the
scratch region sits at logical position ``scratch + rel // fanout`` on chain
``rel % fanout``, and a query sees it when its position is visible and the
key's chain is -1 (committed) or the query's own.

Sequence-sharded decode (an ``sp`` axis in the sharded context,
parallel/collectives.py; the engine's ``kv_shard_axis``): each rank holds a
contiguous slab of the contiguous cache's positions. The masked path scores
its slab's keys at their global positions, and the softmax's max, its sum
and the weighted values are combined over sp by an all-reduce MAX and two
all-reduce SUMs. K1 and the paged kernels stay off under sp, as they are
in the JAX package (a kernel's KV dim is not split across devices).

Each kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
plain version for CPU tensors. While a ``torch.profiler`` records, each K1
and K2 call appends its shapes to ``utils/profiling.RECORDS`` (K2's
positions tensor by reference, never read here), so a device trace can put
the kernels' times beside their rooflines; while a CUDA graph's function
runs under ``RECORDS.calls_of``, the calls go to that block instead.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.autograd.profiler as _autograd_profiler

from layerskip_tpu_torch.ops.cuda.flash_prefill import (
    HEAD_DIMS,
    flash_prefill_attention,
)
from layerskip_tpu_torch.ops.cuda.paged_decode import (
    MAX_QUERY,
    paged_decode_attention,
    paged_decode_attention_q8,
)
from layerskip_tpu_torch.ops.kv_cache import QuantKV
from layerskip_tpu_torch.ops.paged_kv import PagedKV, PagedQuantKV
from layerskip_tpu_torch.parallel.collectives import all_reduce, axis
from layerskip_tpu_torch.utils import profiling

NEG_INF = -1e30  # large-but-finite: avoids NaNs from (-inf) - (-inf)
_MAX_SHORT_QUERY = MAX_QUERY  # drafts (T=1) and verify windows (T=W+1)


def gqa_attention(
    q: torch.Tensor,  # [B, T, Hq, Dh] (post-RoPE)
    k_cache,  # [B, S, Hkv, Dh] tensor, QuantKV, or a per-layer PagedKV /
    # PagedQuantKV (post-RoPE, updated)
    v_cache,  # [B, S, Hkv, Dh]
    q_positions: torch.Tensor,  # [T] or [B, T] absolute query positions
    *,
    q_heads_per_kv: int,
    past_scalar: Optional[int] = None,  # set when positions are past + arange(T)
    sliding_window: Union[None, int, torch.Tensor] = None,  # int, or a 0-d
    # tensor (runtime window, 0 = global)
    tree_meta=None,  # (q_chain [B, T], scratch [] or [B], fanout): see above
    score_scale: Optional[float] = None,  # None/0 => head_dim ** -0.5
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Returns attention output [B, T, Hq, Dh] in q's dtype."""
    b, t, hq, dh = q.shape
    sp = axis("sp")
    if isinstance(k_cache, (PagedKV, PagedQuantKV)):
        if sp is not None:
            raise ValueError("a paged cache is not sequence-sharded")
        if t <= _MAX_SHORT_QUERY and dh in HEAD_DIMS:
            kw = dict(q_heads_per_kv=q_heads_per_kv,
                      sliding_window=sliding_window or 0,
                      score_scale=float(score_scale or 0.0),
                      logit_softcap=float(logit_softcap or 0.0))
            if tree_meta is not None:
                chain, scratch, fanout = tree_meta
                kw.update(tree_chain=chain, tree_scratch=scratch, tree_fanout=int(fanout))
            if isinstance(k_cache, PagedKV):
                on = _autograd_profiler._is_profiler_enabled
                if on or profiling.RECORDS.collecting:
                    profiling.RECORDS.add("k2", (
                        (b, t, hq, dh), q_positions, int(k_cache.pool.shape[1]),
                        int(k_cache.table.shape[1]) * int(k_cache.pool.shape[2]),
                        kw["sliding_window"], q.element_size()), kept=on)
                return paged_decode_attention(q, k_cache.pool, v_cache.pool, k_cache.table,
                                              q_positions, **kw)
            return paged_decode_attention_q8(q, k_cache.pool, k_cache.scale, v_cache.pool,
                                             v_cache.scale, k_cache.table, q_positions,
                                             **kw)
        k_cache = k_cache.gather_view(q.dtype)
        v_cache = v_cache.gather_view(q.dtype)
    elif isinstance(k_cache, QuantKV):
        k_cache = k_cache.dequantize(q.dtype)
        v_cache = v_cache.dequantize(q.dtype)
    if (past_scalar is not None and tree_meta is None and t > _MAX_SHORT_QUERY
            and dh in HEAD_DIMS and sp is None):
        window = int(sliding_window or 0)
        on = _autograd_profiler._is_profiler_enabled
        if on or profiling.RECORDS.collecting:
            profiling.RECORDS.add("k1", ((b, t, hq, dh), int(k_cache.shape[1]),
                                         int(k_cache.shape[2]), int(past_scalar), window,
                                         q.element_size()), kept=on)
        return flash_prefill_attention(
            q, k_cache, v_cache, int(past_scalar),
            q_heads_per_kv=q_heads_per_kv,
            sliding_window=window,
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

    # the keys' global positions (under sp: this rank's slab)
    key_pos = torch.arange(s, device=q.device)[None, None, :]  # [1, 1, S]
    if sp is not None:
        key_pos = key_pos + sp.rank * s
    q_pos = q_positions[:, :, None]  # [B, T, 1]
    tree_mask = None
    if tree_meta is not None:
        q_chain, scratch, fanout = tree_meta
        scratch = torch.as_tensor(scratch, device=q.device).long().reshape(-1).expand(b)
        rel = key_pos[0] - scratch[:, None]  # [B, S]
        in_scr = rel >= 0
        key_chain = torch.where(in_scr, torch.remainder(rel, fanout), -1)[:, None, :]
        key_pos = torch.where(in_scr, scratch[:, None] + torch.div(
            rel, fanout, rounding_mode="floor"), key_pos[0])[:, None, :]  # [B, 1, S]
        q_chain = torch.as_tensor(q_chain, device=q.device).long().expand(b, t)
        tree_mask = (key_chain < 0) | (key_chain == q_chain[:, :, None])
    mask = key_pos <= q_pos  # [B, T, S]
    if tree_mask is not None:
        mask = mask & tree_mask
    if isinstance(sliding_window, torch.Tensor):
        win = sliding_window.long()
        mask &= (win <= 0) | (key_pos > q_pos - win)
    elif sliding_window:
        mask &= key_pos > q_pos - int(sliding_window)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)

    if sp is None:
        probs = torch.softmax(scores, dim=-1)
    else:  # the softmax over every slab's keys
        peak = all_reduce(scores.amax(dim=-1, keepdim=True), sp, "max")
        e = torch.exp(scores - peak)
        probs = e / all_reduce(e.sum(dim=-1, keepdim=True), sp)
    out = torch.einsum(
        "bhgts,bshd->bthgd", probs.to(v_cache.dtype).float(), v_cache.float()
    )
    out = all_reduce(out, sp)
    return out.reshape(b, t, hq, dh).to(q.dtype)
