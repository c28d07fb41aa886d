"""Self-speculative decoding rounds (port of ``layerskip_tpu/generation/spec.py``).

Prompt prefill, the draft+verify round with static-W early-exit drafting,
rejection-sampling acceptance, and the whole-generation loop. The loop is a
Python ``while`` with one host sync per round (``done.all()``) where the JAX
package runs ``lax.while_loop``. A quantized drafter (``draft_params``)
drafts from its own weights and the verify re-runs the window through the
base stack; the int8 KV cache (``kv_quant``) runs in every round.
Prompt-lookup, hybrid and adaptive drafting and tree speculation belong to
later slices and raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from layerskip_tpu_torch.config import ModelConfig
from layerskip_tpu_torch.generation.core import (
    GenerateOutput,
    _SpecState,
    _is_eos,
    _mk_group_cache,
    _row_update,
)
from layerskip_tpu_torch.generation.processors import apply_ban, no_repeat_ngram_banned
from layerskip_tpu_torch.generation.sampling import (
    SamplingConfig,
    draw,
    token_distribution,
)
from layerskip_tpu_torch.models import llama
from layerskip_tpu_torch.models.llama import LlamaParams


def _spec_prefill(
    params: LlamaParams,
    cfg: ModelConfig,
    ids: torch.Tensor,  # [B, P] right-padded prompt
    true_len: torch.Tensor,  # [B]
    generator: Optional[torch.Generator],
    *,
    max_steps: int,
    exit_layer: int,
    num_speculations: int,
    scfg: SamplingConfig,
    eos_ids: Tuple[int, ...],
    max_cache_len: int,
    ngram: int = 0,
    kv_quant: bool = False,
) -> _SpecState:
    """Prompt prefill through all layers (one shared past of 0, so the
    flash-prefill kernel runs) -> the initial speculation state."""
    b, p = ids.shape
    e, nl, w = exit_layer, cfg.num_hidden_layers, num_speculations
    if not (0 < e < nl and w >= 1):
        raise ValueError(f"need 0 < exit_layer < {nl} and num_speculations >= 1")
    dev = ids.device
    res = llama.forward_split(
        params, cfg, ids,
        _mk_group_cache(cfg, e, b, max_cache_len, dev, kv_quant),
        _mk_group_cache(cfg, nl - e, b, max_cache_len, dev, kv_quant),
        0, e, last_pos=true_len - 1,
    )
    last_logits = res.logits[:, 0]  # [B, V]
    out_size = max_steps + w + 1  # rounds may overshoot max_steps by <= W
    hist = torch.cat([ids, torch.zeros((b, out_size), dtype=ids.dtype, device=dev)], 1)
    if ngram > 0:
        last_logits = apply_ban(
            last_logits, no_repeat_ngram_banned(hist, true_len, ngram, cfg.vocab_size)
        )
    tok0 = draw(token_distribution(last_logits, scfg), generator, scfg)  # [B]
    hist = _row_update(hist, tok0[:, None], true_len)
    out = torch.zeros((b, out_size), dtype=torch.long, device=dev)
    out[:, 0] = tok0
    zeros = torch.zeros((b,), dtype=torch.long, device=dev)
    return _SpecState(
        early=res.early_cache,
        full=res.full_cache,
        ctx=true_len.clone(),
        prompt_len=true_len.clone(),
        next_tok=tok0[:, None],
        out=out,
        hist=hist,
        out_len=torch.ones((b,), dtype=torch.long, device=dev),
        steps=torch.full((b,), max_steps, dtype=torch.long, device=dev),
        done=_is_eos(tok0, eos_ids) | (max_steps <= 1),
        matches=zeros,
        drafts=zeros.clone(),
    )


def spec_generate(
    params: LlamaParams,
    cfg: ModelConfig,
    ids: torch.Tensor,  # [B, P] right-padded prompt
    true_len: torch.Tensor,  # [B]
    generator: Optional[torch.Generator],
    *,
    max_steps: int,
    exit_layer: int,
    num_speculations: int,
    scfg: SamplingConfig,
    eos_ids: Tuple[int, ...],
    max_cache_len: int,
    ngram: int = 0,
    kv_quant: bool = False,
    draft_exit_prob: float = 0.0,
    pld_ngram: int = 0,
    hybrid: bool = False,
    tree_width: int = 0,
    draft_params: Optional[LlamaParams] = None,
) -> GenerateOutput:
    """Whole self-speculative generation: prefill, then draft+verify rounds
    until every row is done."""
    for on, what in ((draft_exit_prob > 0, "adaptive drafting"),
                     (pld_ngram > 0 or hybrid, "prompt-lookup drafting"),
                     (tree_width > 1, "tree speculation")):
        if on:
            raise NotImplementedError(f"{what} is not ported yet")
    state = _spec_prefill(
        params, cfg, ids, true_len, generator,
        max_steps=max_steps, exit_layer=exit_layer,
        num_speculations=num_speculations, scfg=scfg, eos_ids=eos_ids,
        max_cache_len=max_cache_len, ngram=ngram, kv_quant=kv_quant,
    )
    while not bool(state.done.all()):
        state = _spec_round(
            params, cfg, state, generator, exit_layer=exit_layer,
            num_speculations=num_speculations, scfg=scfg, eos_ids=eos_ids,
            ngram=ngram, draft_params=draft_params,
        )
    return GenerateOutput(
        tokens=state.out,
        num_tokens=torch.minimum(state.out_len, state.steps),
        matches=state.matches.sum(),
        drafts=state.drafts.sum(),
    )


def _spec_round(
    params: LlamaParams,
    cfg: ModelConfig,
    s: _SpecState,
    generator: Optional[torch.Generator],
    *,
    exit_layer: int,
    num_speculations: int,
    scfg: SamplingConfig,
    eos_ids: Tuple[int, ...],
    ngram: int = 0,
    draft_params: Optional[LlamaParams] = None,
) -> _SpecState:
    """One draft+verify round: each active row commits its accepted drafts
    plus one extra token. The state's caches are updated in place.

    With ``draft_params`` (a quantized copy of layers [0, E), see
    quant.quantize_draft_params) the drafts read the cheap weights, but the
    verify must not reuse their exit hiddens: it re-runs
    ``[next_tok, drafts]`` through the full base stack (``forward_split``
    from ``s.ctx``), so committed tokens are judged by the base model and
    greedy output equals base AR. That pass rewrites the early KV the
    drafts wrote at positions ``ctx .. ctx + W - 1``."""
    b = s.next_tok.shape[0]
    e, w = exit_layer, num_speculations
    dev = s.next_tok.device
    hist_len0 = s.prompt_len + s.out_len  # committed history incl. next_tok

    def ban(logits, hist, hist_len):
        if ngram <= 0:
            return logits
        return apply_ban(logits, no_repeat_ngram_banned(hist, hist_len, ngram, cfg.vocab_size))

    # ---- draft: W early-exit steps ----
    dparams = params if draft_params is None else draft_params
    early, tok, hist = s.early, s.next_tok, s.hist
    d_toks, d_probs, exit_h = [], [], []
    for i in range(w):
        r = llama.forward_early(dparams, cfg, tok, early, s.ctx + i, e)
        logits = ban(r.logits[:, -1], hist, hist_len0 + i)
        probs = token_distribution(logits, scfg)  # [B, V]
        d_tok = draw(probs, generator, scfg)  # [B]
        hist = _row_update(hist, d_tok[:, None], hist_len0 + i)
        early, tok = r.cache, d_tok[:, None]
        d_toks.append(d_tok)
        d_probs.append(probs)
        exit_h.append(r.hidden[:, 0])
    drafts = torch.stack(d_toks, dim=1)  # [B, W]
    p_draft = torch.stack(d_probs, dim=1)  # [B, W, V]
    w_dyn = torch.full((b,), w, dtype=torch.long, device=dev)

    # ---- verify: the stitched window through the remaining layers, or,
    # after a quantized draft, the whole window through the base stack ----
    if draft_params is None:
        vres = llama.forward_remainder(
            params, cfg, tok, torch.stack(exit_h, dim=1), early, s.full,
            draft_len=s.ctx + w, full_len=s.ctx, exit_layer=e,
        )
    else:
        vres = llama.forward_split(
            params, cfg, torch.cat([s.next_tok, drafts], dim=1), s.early, s.full,
            s.ctx, e,
        )
    vlogits = vres.logits
    if ngram > 0:
        vlogits = torch.stack(
            [ban(vlogits[:, j], hist, hist_len0 + j) for j in range(w + 1)], dim=1
        )
    p_verify = token_distribution(vlogits, scfg)  # [B, W+1, V]

    # ---- acceptance: rejection sampling; one-hot => greedy prefix match ----
    pv_d = torch.gather(p_verify[:, :w], 2, drafts[..., None])[..., 0]  # [B, W]
    pd_d = torch.gather(p_draft, 2, drafts[..., None])[..., 0]
    u = torch.rand((b, w), generator=generator, device=dev)
    accept = (u * pd_d < pv_d) & (torch.arange(w, device=dev)[None, :] < w_dyn[:, None])
    n_raw = torch.cumprod(accept.long(), dim=1).sum(dim=1)  # [B]
    # clamp acceptances near max_steps so committed counts match the
    # reference's shrinking window
    w_eff = (s.steps - s.out_len - 1).clamp(0, w)
    n = torch.minimum(n_raw, w_eff)

    # extra token: residual resample on rejection, bonus draw otherwise
    rows = torch.arange(b, device=dev)
    pv_n = p_verify[rows, n]  # [B, V]
    pd_n = p_draft[rows, torch.minimum(n, w_dyn - 1)]
    residual = (pv_n - pd_n).clamp_min(0.0)
    residual = residual / residual.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    all_accepted = (n == w_dyn) | (n == w_eff)
    extra_tok = draw(torch.where(all_accepted[:, None], pv_n, residual), generator, scfg)

    # ---- commit: accepted drafts + extra token; KV rollback is ctx ----
    window = torch.cat([drafts, torch.zeros((b, 1), dtype=drafts.dtype, device=dev)], 1)
    idx = torch.arange(w + 1, device=dev)[None, :]
    window = torch.where(idx == n[:, None], extra_tok[:, None], window)
    active = ~s.done  # frozen rows keep buffers and counters fixed
    out = torch.where(active[:, None], _row_update(s.out, window, s.out_len), s.out)
    hist = torch.where(active[:, None], _row_update(hist, window, hist_len0), s.hist)
    committed = torch.where(active, n + 1, 0)
    out_len = s.out_len + committed

    eos_hit = (_is_eos(window, eos_ids) & (idx <= n[:, None])).any(dim=1)
    done = s.done | eos_hit | (out_len >= s.steps)

    # acceptance stats: a round drafts min(W, first drafted EOS + 1) tokens,
    # none past the max_steps clamp; matches are capped to that count
    d_eos = _is_eos(drafts, eos_ids) & (torch.arange(w, device=dev)[None, :] < w_dyn[:, None])
    eos_cap = torch.where(d_eos.any(dim=1), torch.argmax(d_eos.int(), dim=1) + 1, w)
    drafted = torch.minimum(torch.minimum(w_eff, eos_cap), w_dyn)
    act = active.long()
    return _SpecState(
        early=vres.early_cache,
        full=vres.full_cache,
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
    )
