"""Ring attention: exact causal attention over a sequence-sharded mesh axis
(port of ``layerskip_tpu/ops/ring_attention.py``).

Q/K/V are split along the sequence over one axis of the sharded context:
each rank keeps its Q shard in place while the K/V shards travel around the
ring (``parallel/collectives.ring_shift``), one hop a step, and online-softmax
accumulators (m, l, acc) in fp32 combine the partial attention, so the
whole T x T score matrix exists nowhere. Causality is the global rule
``k_pos <= q_pos`` from the shard indices; a block wholly in the future is
an exact no-op of the update (its block max is NEG_INF, so its weight is 0).

Torch operations only: the JAX package computes this with ``jnp`` under
``shard_map``, not with a Pallas kernel. Gradients come from autograd
through ``ring_shift`` (its backward shifts the other way); the running
maxima are held constant in backward (the result does not depend on them).
Like the JAX ring it has no window, no softcap and only the 1/sqrt(Dh)
scale: those raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from layerskip_tpu_torch.parallel.collectives import Axis, all_gather, ring_shift, split

NEG_INF = -1e30


def _block_attend(q, k, v, q_pos, k_pos, scale):
    """Partial (unnormalized) attention of one Q shard against one K/V shard.
    q [B, Tq, Hq, Dh], k/v [B, Tk, Hkv, Dh] -> (block max m [B, Hkv, G, Tq,
    1], exp-sum l, weighted sum acc [B, Hkv, G, Tq, Dh]), all fp32."""
    b, tq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, tq, hkv, g, dh).permute(0, 2, 3, 1, 4).float()  # [B, Hkv, G, Tq, Dh]
    kt = k.permute(0, 2, 3, 1).float()[:, :, None]  # [B, Hkv, 1, Dh, Tk]
    s = torch.matmul(qg, kt) * scale  # [B, Hkv, G, Tq, Tk]
    mask = k_pos[None, :] <= q_pos[:, None]  # [Tq, Tk]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.where(mask, torch.exp(s - m), 0.0)  # exp(NEG_INF - NEG_INF) guard
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741
    acc = torch.matmul(p, v.permute(0, 2, 1, 3).float()[:, :, None])
    return m, l, acc


def _refuse(window, logit_softcap, score_scale) -> None:
    if window or logit_softcap or score_scale is not None:
        raise ValueError("ring attention has no window, softcap or query scale "
                         f"(window={window}, softcap={logit_softcap}, "
                         f"score_scale={score_scale}), as in the JAX package")


def ring_attention(q: torch.Tensor,  # [B, Tloc, Hq, Dh] this rank's queries (post-RoPE)
                   k: torch.Tensor,  # [B, Tloc, Hkv, Dh] this rank's keys
                   v: torch.Tensor,  # [B, Tloc, Hkv, Dh]
                   ax: Optional[Axis], window: Optional[int] = None,
                   logit_softcap: Optional[float] = None,
                   score_scale: Optional[float] = None) -> torch.Tensor:
    """The per-shard body: the sequence is split over ``ax`` (rank r holds
    positions ``[r * Tloc, (r + 1) * Tloc)``); returns this rank's output
    shard [B, Tloc, Hq, Dh] in q's dtype. With ``ax`` None, plain causal
    attention of the whole sequence."""
    _refuse(window, logit_softcap, score_scale)
    b, t_loc, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    p_size, my = (1, 0) if ax is None else (ax.size, ax.rank)
    scale = 1.0 / (dh ** 0.5)
    steps = torch.arange(t_loc, device=q.device)
    q_pos = my * t_loc + steps
    m = torch.full((b, hkv, g, t_loc, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, t_loc, 1), dtype=torch.float32, device=q.device)  # noqa: E741
    acc = torch.zeros((b, hkv, g, t_loc, dh), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for step in range(p_size):
        src = (my - step) % p_size  # the shard this K/V block came from
        bm, bl, bacc = _block_attend(q, k_blk, v_blk, q_pos, src * t_loc + steps, scale)
        m_new = torch.maximum(m, bm)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(torch.clamp(bm, min=NEG_INF) - m_new)
        m = m_new
        l = l * alpha + bl * beta  # noqa: E741
        acc = acc * alpha + bacc * beta
        if step + 1 < p_size:  # the block to the next rank, the previous one's here
            k_blk, v_blk = ring_shift(k_blk, ax), ring_shift(v_blk, ax)
    out = acc / torch.clamp(l, min=1e-30)  # [B, Hkv, G, Tq, Dh]
    return out.permute(0, 3, 1, 2, 4).reshape(b, t_loc, hq, dh).to(q.dtype)


def ring_attention_sharded(q: torch.Tensor,  # [B, T, Hq, Dh] the whole sequence
                           k: torch.Tensor,  # [B, T, Hkv, Dh]
                           v: torch.Tensor,
                           ax: Optional[Axis], window: Optional[int] = None,
                           logit_softcap: Optional[float] = None,
                           score_scale: Optional[float] = None) -> torch.Tensor:
    """The whole sequence, the same on every rank of ``ax``: each rank takes
    its chunk of T, runs the ring and the chunks are gathered back into
    [B, T, Hq, Dh]. The gradients of q/k/v are whole on every rank (the
    split gathers them, the gather hands each rank its chunk's)."""
    _refuse(window, logit_softcap, score_scale)
    if ax is not None and q.shape[1] % ax.size:
        raise ValueError(f"seq_len={q.shape[1]} does not divide by the ring's {ax.size} ranks")
    out = ring_attention(split(q, ax, 1), split(k, ax, 1), split(v, ax, 1), ax)
    return all_gather(out, ax, 1, grad="slice")
