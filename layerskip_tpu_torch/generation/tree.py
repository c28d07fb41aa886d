"""Tree speculation (port of ``layerskip_tpu/generation/tree.py``).

``tree_width`` (k) draft chains branch at a round's first draft position:
the early-exit model's top-k candidates (i.i.d. draws when sampling) each
continue for ``num_speculations`` (W) depths. Chains live in interleaved
cache slots past the committed frontier (slot ``scratch + d * k + c`` holds
depth ``d + 1`` of chain ``c``); visibility is one clause of the attention
mask (ops/attention.gqa_attention ``tree_meta``), which K2/K3 carry over a
paged cache. All 1 + W * k window tokens verify in one pass of the remaining
layers, and the winning chain's KV is then moved into the contiguous
frontier.

Greedy: the drafts are argmax chains and the commits follow the verifier's
argmax, so greedy tree == greedy AR token for token (the top-k candidates
are distinct, so at most one chain matches at depth 1). Sampling:
SpecInfer-style rejection over the siblings (each rejection shrinks the
target to ``norm(max(q - p, 0))``), then pairwise rejection along the
accepted chain. A row's random draws come from its own generator (when there
is one per row) in a fixed order: the k candidates, the chain steps by
depth, the branch and chain uniforms, the extra token.
"""

from __future__ import annotations

from typing import Tuple

import torch

from layerskip_tpu_torch.config import ModelConfig
from layerskip_tpu_torch.generation.core import RoundPlan, _SpecState, _is_eos, _row_update
from layerskip_tpu_torch.generation.processors import apply_ban, no_repeat_ngram_banned
from layerskip_tpu_torch.generation.sampling import draw, token_distribution, uniform
from layerskip_tpu_torch.models import llama
from layerskip_tpu_torch.models.llama import LlamaParams
from layerskip_tpu_torch.ops.kv_cache import KVCache, QuantKV
from layerskip_tpu_torch.ops.paged_kv import PagedKV, PagedQuantKV


def _tree_compact(buf: torch.Tensor, start: torch.Tensor, first: torch.Tensor,
                  stride: int, w: int) -> torch.Tensor:
    """Move the winning chain's slots to the contiguous frontier, in place.

    ``buf`` [L, B, S, ...] (KV values, or an int8 cache's [L, B, S, H]
    scales); the source slots of row b are ``first[b] + d * stride`` and the
    destination ``start[b] + d``, d in [0, w). Each start is clamped so its
    run fits the buffer, as the JAX package's slices clamp. The sources are
    gathered into a new tensor before the scatter, since the two runs
    overlap."""
    s = buf.shape[2]
    d = torch.arange(w, device=buf.device)
    rows = torch.arange(buf.shape[1], device=buf.device)[:, None]
    src = first.long().clamp(0, s - ((w - 1) * stride + 1))[:, None] + d * stride
    dst = start.long().clamp(0, s - w)[:, None] + d
    buf[:, rows, dst] = buf[:, rows, src]
    return buf


def _compact(kv, scratch: torch.Tensor, c_star: torch.Tensor, kk: int, w: int) -> None:
    """The winning chain's W slots of one K or V group to ``scratch ..
    scratch + W - 1``: a gather and a scatter through the page table for a
    paged group, strided runs per row for a contiguous one."""
    first = scratch + c_star
    if isinstance(kv, (PagedKV, PagedQuantKV)):
        kv.tree_compact(scratch, first[:, None] + torch.arange(w, device=first.device) * kk)
    elif isinstance(kv, QuantKV):
        _tree_compact(kv.q, scratch, first, kk, w)
        _tree_compact(kv.scale, scratch, first, kk, w)
    else:
        _tree_compact(kv, scratch, first, kk, w)


def _chain_bans(hist_tree: torch.Tensor, hist_len: torch.Tensor, kk: int, ngram: int,
                v_size: int) -> torch.Tensor:
    """[B, k, V] n-gram bans of k chain histories ``hist_tree`` [B * k, L]
    (row-major over (row, chain)) of valid length ``hist_len`` [B]."""
    banned = no_repeat_ngram_banned(hist_tree, hist_len.repeat_interleave(kk), ngram, v_size)
    return banned.reshape(-1, kk, v_size)


def _tree_round(
    params: LlamaParams,
    cfg: ModelConfig,
    s: _SpecState,
    plan: RoundPlan,
) -> Tuple[_SpecState, torch.Tensor, torch.Tensor]:
    """One multi-candidate draft+verify round of a ``tree`` plan. Returns
    (the new state, the round's window [B, W+1], the accepted counts n [B])
    as ``_spec_round`` does; the caches are updated in place."""
    b = s.next_tok.shape[0]
    e, w, kk = plan.exit_layer, plan.num_speculations, plan.tree_width
    scfg, eos_ids, ngram = plan.scfg, plan.eos_ids, plan.ngram
    v_size = cfg.vocab_size
    dev = s.next_tok.device
    gen = s.generator
    rows = torch.arange(b, device=dev)
    hist_len0 = s.prompt_len + s.out_len
    scratch = s.ctx + 1  # [B] first scratch slot (depth 1)

    # ---- draft: the root pass, then W chain steps of width k (the scratch
    # region is empty at the root, so the plain causal rule applies) ----
    r0 = llama.forward_early(params, cfg, s.next_tok, s.early, s.ctx, e)
    root_logits = r0.logits[:, -1]
    if ngram > 0:
        root_logits = apply_ban(root_logits, no_repeat_ngram_banned(
            s.hist, hist_len0, ngram, v_size))
    if scfg.sample:
        p0 = token_distribution(root_logits, scfg)  # [B, V]
        top = draw(p0[:, None].expand(b, kk, v_size), gen, scfg)  # [B, k] i.i.d.
    else:
        top = torch.topk(root_logits, kk, dim=-1).indices  # [B, k] candidates
    q_chain_d = torch.arange(kk, device=dev).expand(b, kk)
    # per-chain history for the n-gram bans along each chain: [B * k, L]
    hist_tree = None
    if ngram > 0:
        hist_tree = _row_update(s.hist.repeat_interleave(kk, 0), top.reshape(-1, 1),
                                hist_len0.repeat_interleave(kk))

    ke, ve = r0.cache.k, r0.cache.v
    tips, chain_toks, h_steps, pd_steps = top, [], [], []
    for i in range(w):
        h = llama.embed_tokens(params, tips, cfg)
        h, ke, ve = llama.run_layers(
            cfg, params.layers, h, ke, ve, s.ctx, 0,
            q_positions=(s.ctx + 1 + i)[:, None].expand(b, kk),
            write_pos=scratch + i * kk, tree_meta=(q_chain_d, scratch, kk))
        chain_toks.append(tips)
        h_steps.append(h)
        if i == w - 1:
            break  # the last depth's continuation is never verified
        logits = llama.lm_logits(params, cfg, h)  # [B, k, V]
        if ngram > 0:
            logits = apply_ban(logits, _chain_bans(hist_tree, hist_len0 + 1 + i, kk, ngram,
                                                   v_size))
        if scfg.sample:
            pd = token_distribution(logits, scfg)  # [B, k, V]
            tips = draw(pd, gen, scfg)
            pd_steps.append(pd)
        else:
            tips = torch.argmax(logits, dim=-1)
        if ngram > 0:
            hist_tree = _row_update(hist_tree, tips.reshape(-1, 1),
                                    (hist_len0 + 1 + i).repeat_interleave(kk))
    chain_toks = torch.stack(chain_toks, dim=1)  # [B, W, k]

    # ---- verify: one pass of the remaining layers over the whole tree ----
    win_h = torch.cat([r0.hidden, torch.stack(h_steps, dim=1).reshape(b, w * kk, -1)], 1)
    offs = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                      1 + torch.arange(w, device=dev).repeat_interleave(kk)])
    q_chain_v = torch.cat([torch.full((1,), -1, dtype=torch.long, device=dev),
                           torch.arange(kk, device=dev).repeat(w)])
    full_h, kf, vf = llama.run_layers(
        cfg, params.layers, win_h, s.full.k, s.full.v, s.ctx, e,
        q_positions=s.ctx[:, None] + offs, write_pos=s.ctx,
        tree_meta=(q_chain_v.expand(b, 1 + w * kk), scratch, kk))
    vlogits = llama.lm_logits(params, cfg, full_h)  # [B, 1 + W*k, V] fp32
    if ngram > 0:
        # the root verifies with the committed history; node (d, c) with
        # chain c's prefix of length hist_len0 + d + 1, as AR would along it
        bans = [no_repeat_ngram_banned(s.hist, hist_len0, ngram, v_size)[:, None]]
        bans += [_chain_bans(hist_tree, hist_len0 + 1 + d, kk, ngram, v_size)
                 for d in range(w)]
        vlogits = apply_ban(vlogits, torch.cat(bans, dim=1))

    w_eff = (s.steps - s.out_len - 1).clamp(0, w)  # near-max_steps clamp
    if not scfg.sample:
        # ---- acceptance (greedy): the longest verifier-argmax chain prefix
        g = torch.argmax(vlogits, dim=-1)  # [B, 1 + W*k]
        g_nodes = g[:, 1:].reshape(b, w, kk)  # greedy continuation of (d, c)
        ok = torch.cat([chain_toks[:, :1] == g[:, :1, None],
                        chain_toks[:, 1:] == g_nodes[:, :-1]], dim=1)  # [B, W, k]
        n_c = torch.cumprod(ok.long(), dim=1).sum(dim=1)  # [B, k]
        c_star = torch.argmax(n_c, dim=1)  # the first longest chain
        n = torch.minimum(n_c.amax(dim=1), w_eff)
        # the extra token: the verifier's token after the accepted prefix
        bonus = torch.where(n > 0, 1 + (n - 1) * kk + c_star, 0)
        extra_tok = g.gather(1, bonus[:, None])[:, 0]
    else:
        # ---- acceptance (sampling): multi-round rejection at the branch,
        # pairwise rejection along the accepted chain ----
        q_all = token_distribution(vlogits, scfg)  # [B, 1 + W*k, V]
        q_root = q_all[:, 0]
        q_nodes = q_all[:, 1:].reshape(b, w, kk, v_size)
        p_chain = (torch.stack(pd_steps, dim=1) if pd_steps
                   else q_nodes.new_zeros((b, 0, kk, v_size)))  # [B, W-1, k, V]
        u_br = uniform((b, kk), gen, dev)
        u_ch = uniform((b, w - 1), gen, dev)
        qq, acc_c = q_root, torch.full((b,), -1, dtype=torch.long, device=dev)
        for c in range(kk):  # candidates are i.i.d. ~ p0: test them in order
            x_c = top[:, c:c + 1]
            qx, px = qq.gather(1, x_c)[:, 0], p0.gather(1, x_c)[:, 0]
            acc_c = torch.where((u_br[:, c] * px <= qx) & (acc_c < 0), c, acc_c)
            resid = (qq - p0).clamp_min(0.0)
            resid = resid / resid.sum(dim=-1, keepdim=True).clamp_min(1e-30)
            qq = torch.where((acc_c < 0)[:, None], resid, qq)
        branch_resid = qq  # the target left after every candidate was rejected
        c_star = acc_c.clamp_min(0)
        toks_c = chain_toks[rows, :, c_star]  # [B, W]
        q_c = q_nodes[rows, :, c_star]  # [B, W, V]
        p_c = p_chain[rows, :, c_star]  # [B, W-1, V]: depth d+2 drawn from p_c[d]
        xq = q_c[:, :w - 1].gather(2, toks_c[:, 1:, None])[..., 0]
        xp = p_c.gather(2, toks_c[:, 1:, None])[..., 0]
        ok_full = torch.cat([(acc_c >= 0)[:, None], u_ch * xp <= xq], dim=1)  # [B, W]
        n_acc = torch.cumprod(ok_full.long(), dim=1).sum(dim=1)
        n = torch.minimum(n_acc, w_eff)
        # the extra token: a residual draw on a true rejection, else a bonus
        q_n = torch.cat([q_root[:, None], q_c], dim=1)[rows, n]
        p_n = torch.cat([p0[:, None], p_c], dim=1)[rows, n.clamp(max=w - 1)]
        pair_resid = (q_n - p_n).clamp_min(0.0)
        pair_resid = pair_resid / pair_resid.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        true_reject = (n == n_acc) & (n_acc < w)
        extra_dist = torch.where(true_reject[:, None], torch.where(
            (n == 0)[:, None], branch_resid, pair_resid), q_n)
        extra_tok = draw(extra_dist, gen, scfg)

    # ---- commit: the winning chain's prefix + the extra token ----
    win_toks = chain_toks[rows, :, c_star]  # [B, W]
    window = torch.cat([win_toks, torch.zeros((b, 1), dtype=win_toks.dtype, device=dev)], 1)
    idx = torch.arange(w + 1, device=dev)[None, :]
    window = torch.where(idx == n[:, None], extra_tok[:, None], window)
    active = ~s.done
    out = torch.where(active[:, None], _row_update(s.out, window, s.out_len), s.out)
    hist = torch.where(active[:, None], _row_update(s.hist, window, hist_len0), s.hist)
    committed = torch.where(active, n + 1, 0)
    out_len = s.out_len + committed
    eos_hit = (_is_eos(window, eos_ids) & (idx <= n[:, None])).any(dim=1)
    done = s.done | eos_hit | (out_len >= s.steps)

    # ---- the winning chain's KV into the contiguous frontier ----
    for kv in (ke, ve, kf, vf):
        _compact(kv, scratch, c_star, kk, w)

    d_eos = _is_eos(win_toks, eos_ids)
    eos_cap = torch.where(d_eos.any(dim=1), torch.argmax(d_eos.int(), dim=1) + 1, w)
    drafted = torch.minimum(w_eff, eos_cap)
    act = active.long()
    return (_SpecState(
        early=KVCache(k=ke, v=ve),
        full=KVCache(k=kf, v=vf),
        ctx=s.ctx + committed,
        prompt_len=s.prompt_len,
        next_tok=extra_tok[:, None],
        out=out,
        hist=hist,
        out_len=out_len,
        steps=s.steps,
        done=done,
        matches=s.matches + torch.minimum(n, drafted) * act,
        drafts=s.drafts + drafted * act,
        generator=gen,
    ), window, n)
