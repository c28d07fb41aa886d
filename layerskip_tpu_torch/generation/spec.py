"""Self-speculative decoding rounds (port of ``layerskip_tpu/generation/spec.py``).

Prompt prefill, the draft+verify round and its draft sources, rejection-
sampling acceptance, and the whole-generation loop. The loop is a Python
``while`` with one host sync per round (``done.all()``) where the JAX
package runs ``lax.while_loop``. The draft sources, each a request's
``RoundPlan.source`` (generation/core.py):

  * early-exit drafting: W steps of layers [0, E) through the shared head,
    verified by the remaining layers over the stitched window; a quantized
    drafter (``draft_params``) drafts from its own weights and the verify
    re-runs the window through the base stack;
  * confidence-adaptive drafting (``draft_exit_prob``): a row stops
    extending its window once a drafted token's probability falls below
    the threshold, and the loop stops when no row is drafting (one host
    read a draft step);
  * prompt lookup (``pld_ngram``): the window copies what followed the most
    recent earlier occurrence of the last n committed tokens, no model
    call, and the full stack verifies it;
  * hybrid: prompt lookup in rounds where every live row has a match, early
    exit otherwise (a host branch, one read a round);
  * tree speculation (``tree_width`` > 1, generation/tree.py).

Committed tokens do not depend on the draft source: greedy output equals
greedy AR for every one. The int8 KV cache (``kv_quant``) runs in every
round.

The W early-exit draft passes are one function, ``early_exit_draft``, and
the verify of their window with acceptance and commit another,
``early_exit_verify`` (acceptance and commit, ``accept_and_commit``, serve
every draft source). A continuous session whose rounds are greedy
early-exit drafts from the base weights (dense, unsharded, on a CUDA
device) replays each from one CUDA graph of that function
(generation/draft_graph.py), copying each round's inputs into their
static buffers; sampled, adaptive, prompt-lookup, hybrid, tree,
quantized-drafter, MoE and sharded sessions, and ``spec_generate``'s solo
loop, launch them eagerly. A greedy round draws nothing.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from layerskip_tpu_torch.config import ModelConfig
from layerskip_tpu_torch.generation.core import (
    GenerateOutput,
    RoundPlan,
    _SpecState,
    _is_eos,
    _mk_group_cache,
    _row_update,
)
from layerskip_tpu_torch.generation.processors import apply_ban, no_repeat_ngram_banned
from layerskip_tpu_torch.generation.sampling import (
    Generators,
    SamplingConfig,
    draw,
    token_distribution,
    uniform,
)
from layerskip_tpu_torch.generation.tree import _tree_round
from layerskip_tpu_torch.models import llama
from layerskip_tpu_torch.models.llama import LlamaParams, RouteSink
from layerskip_tpu_torch.ops.kv_cache import KVCache
from layerskip_tpu_torch.utils.profiling import span


def _spec_prefill(
    params: LlamaParams,
    cfg: ModelConfig,
    ids: torch.Tensor,  # [B, P] right-padded prompt
    true_len: torch.Tensor,  # [B]
    generator: Generators,  # one generator, or one per row
    plan: RoundPlan,
    *,
    max_steps: int,
    max_cache_len: int,
) -> _SpecState:
    """Prompt prefill through all layers (one shared past of 0, so the
    flash-prefill kernel runs) -> the initial speculation state."""
    b, p = ids.shape
    e, nl, w = plan.exit_layer, cfg.num_hidden_layers, plan.num_speculations
    if not (0 < e < nl and w >= 1):
        raise ValueError(f"need 0 < exit_layer < {nl} and num_speculations >= 1")
    dev = ids.device
    res = llama.forward_split(
        params, cfg, ids,
        _mk_group_cache(cfg, e, b, max_cache_len, dev, plan.kv_quant),
        _mk_group_cache(cfg, nl - e, b, max_cache_len, dev, plan.kv_quant),
        0, e, last_pos=true_len - 1,
    )
    out_size = max_steps + w + 1  # rounds may overshoot max_steps by <= W
    hist = torch.cat([ids, torch.zeros((b, out_size), dtype=ids.dtype, device=dev)], 1)
    last_logits = _ban(res.logits[:, 0], hist, true_len, plan.ngram, cfg.vocab_size)
    tok0 = draw(token_distribution(last_logits, plan.scfg), generator, plan.scfg)  # [B]
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
        done=_is_eos(tok0, plan.eos_ids) | (max_steps <= 1),
        matches=zeros,
        drafts=zeros.clone(),
        generator=generator,
    )


def _ban(logits: torch.Tensor, hist: torch.Tensor, hist_len: torch.Tensor, ngram: int,
         vocab_size: int) -> torch.Tensor:
    """``logits`` with the no-repeat n-gram ban of ``hist`` applied (none
    when ``ngram`` <= 0)."""
    if ngram <= 0:
        return logits
    return apply_ban(logits, no_repeat_ngram_banned(hist, hist_len, ngram, vocab_size))


def early_exit_draft(
    params: LlamaParams,
    cfg: ModelConfig,
    early: KVCache,  # layers [0, E), written in place
    next_tok: torch.Tensor,  # [B, 1] committed but not yet in KV
    ctx: torch.Tensor,  # [B] committed context length
    hist: torch.Tensor,  # [B, H] prompt + generated
    hist_len0: torch.Tensor,  # [B] valid history, next_tok included
    *,
    exit_layer: int,
    num_speculations: int,
    scfg: SamplingConfig,
    generator: Generators = None,
    ngram: int = 0,
    routes: Optional[RouteSink] = None,
):
    """The W early-exit draft passes of a round, each through layers
    [0, E) and the shared head: (drafts [B, W], their distributions (W of
    [B, V]), the history with the drafts from ``hist_len0`` on, the last
    draft [B, 1], the exit hiddens (W of [B, D]), the early KV). The eager
    round calls it, and a session's ``DraftGraph`` captures this same
    function (generation/draft_graph.py)."""
    d_toks, d_probs, exit_h = [], [], []
    tok = next_tok
    for i in range(num_speculations):
        r = llama.forward_early(params, cfg, tok, early, ctx + i, exit_layer, routes)
        logits = _ban(r.logits[:, -1], hist, hist_len0 + i, ngram, cfg.vocab_size)
        probs = token_distribution(logits, scfg)  # [B, V]
        d_tok = draw(probs, generator, scfg)  # [B]
        hist = _row_update(hist, d_tok[:, None], hist_len0 + i)
        early, tok = r.cache, d_tok[:, None]
        d_toks.append(d_tok)
        d_probs.append(probs)
        exit_h.append(r.hidden[:, 0])
    return torch.stack(d_toks, dim=1), d_probs, hist, tok, exit_h, early


def _pld_propose(hist: torch.Tensor, hist_len: torch.Tensor, w: int, n: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prompt-lookup proposals ``(proposals [B, W], has_match [B])``: the W
    tokens that followed the most recent earlier occurrence of each row's
    last ``n`` committed tokens in ``hist`` [B, L] (valid length
    ``hist_len`` [B], next_tok included), and whether there is one (the
    hybrid strategy's selector). Rows without a match propose their own
    trailing tokens, which the verifier rejects."""
    b, l = hist.shape
    dev = hist.device
    idx = torch.arange(l, device=dev)
    hist_len = hist_len.long()
    sfx = hist.gather(1, (hist_len[:, None] - n + torch.arange(n, device=dev)).clamp(0, l - 1))
    # match[j]: the n-window ending at j equals the suffix
    match = torch.ones((b, l), dtype=torch.bool, device=dev)
    for i in range(n):
        shift = idx - (n - 1) + i
        match &= (hist[:, shift.clamp(0, l - 1)] == sfx[:, i:i + 1]) & (shift >= 0)
    # strictly before the suffix's own occurrence, with a whole window
    match &= (idx[None] < (hist_len - 1)[:, None]) & (idx[None] >= n - 1)
    has = match.any(dim=1)
    last = (l - 1) - torch.argmax(match.flip(1).int(), dim=1)  # the latest match
    last = torch.where(has, last, (hist_len - 2).clamp_min(0))
    prop = last[:, None] + 1 + torch.arange(w, device=dev)
    return hist.gather(1, prop.clamp(0, l - 1)), has


def spec_generate(
    params: LlamaParams,
    cfg: ModelConfig,
    ids: torch.Tensor,  # [B, P] right-padded prompt
    true_len: torch.Tensor,  # [B]
    generator: Generators,  # one generator, or one per row
    plan: RoundPlan,
    *,
    max_steps: int,
    max_cache_len: int,
    on_round: Optional[Callable[[List[int], List[int]], None]] = None,
) -> GenerateOutput:
    """Whole self-speculative generation: prefill, then draft+verify rounds
    until every row is done.

    ``on_round(drafted, accepted)``, when given, gets row 0's token lists:
    first ``([], [first token])`` after the prefill, then after each round
    the window's W drafted positions (the extra token in place of the first
    rejected draft) and the tokens the round committed. It takes the place
    of the per-round ``done`` sync, so streaming adds no host transfer.

    A ``tree`` plan runs tree rounds (generation/tree.py), every other
    source ``_spec_round``'s."""
    state = _spec_prefill(params, cfg, ids, true_len, generator, plan,
                          max_steps=max_steps, max_cache_len=max_cache_len)
    if on_round is None:
        done = bool(state.done.all())
    else:
        *first, done = torch.cat([state.next_tok[0], state.done.all()[None]]).tolist()
        on_round([], first)
    while not done:
        if plan.source == "tree":
            state, window, n = _tree_round(params, cfg, state, plan)
        else:
            state, window, n = _spec_round(params, cfg, state, plan)
        if on_round is None:
            done = bool(state.done.all())
        else:
            *win, n0, done = torch.cat([window[0], n[:1], state.done.all()[None]]).tolist()
            on_round(win[:plan.num_speculations], win[:n0 + 1])
    return GenerateOutput(
        tokens=state.out,
        num_tokens=torch.minimum(state.out_len, state.steps),
        matches=state.matches.sum(),
        drafts=state.drafts.sum(),
    )


def _full_verify(params: LlamaParams, cfg: ModelConfig, s: _SpecState, plan: RoundPlan,
                 drafts: torch.Tensor, routes: Optional[RouteSink]) -> llama.RemainderResult:
    """The window [next_tok, drafts] through every layer from ``s.ctx``."""
    return llama.forward_split(params, cfg, torch.cat([s.next_tok, drafts], dim=1), s.early,
                               s.full, s.ctx, plan.exit_layer, routes=routes)


def accept_and_commit(
    cfg: ModelConfig,
    s: _SpecState,
    plan: RoundPlan,
    hist_len0: torch.Tensor,  # [B] committed history incl. next_tok
    drafts: torch.Tensor,  # [B, W]
    p_draft: torch.Tensor,  # [B, W, V] the drafts' distributions
    hist: torch.Tensor,  # [B, H] the history with the drafts
    w_dyn: torch.Tensor,  # [B] each row's window
    vres: llama.RemainderResult,  # the verify pass
) -> Tuple[_SpecState, torch.Tensor, torch.Tensor]:
    """Acceptance by rejection sampling, the extra token, and the commit:
    the round's return value, for every draft source. A greedy round draws
    nothing: its distributions are one-hot, so ``u * pd_d < pv_d`` holds
    exactly where ``pv_d`` is 1 for any u in [0, 1), and it takes u = 0."""
    b, w = drafts.shape[0], plan.num_speculations
    scfg, ngram, eos_ids, generator = plan.scfg, plan.ngram, plan.eos_ids, s.generator
    dev = drafts.device
    vlogits = vres.logits
    if ngram > 0:
        vlogits = torch.stack([_ban(vlogits[:, j], hist, hist_len0 + j, ngram, cfg.vocab_size)
                               for j in range(w + 1)], dim=1)
    p_verify = token_distribution(vlogits, scfg)  # [B, W+1, V]

    # ---- acceptance: rejection sampling; one-hot => greedy prefix match ----
    pv_d = torch.gather(p_verify[:, :w], 2, drafts[..., None])[..., 0]  # [B, W]
    pd_d = torch.gather(p_draft, 2, drafts[..., None])[..., 0]
    u = uniform((b, w), generator, dev) if scfg.sample else torch.zeros((b, w), device=dev)
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
    return (_SpecState(
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
        generator=generator,
    ), window, n)


def early_exit_verify(
    params: LlamaParams,
    cfg: ModelConfig,
    s: _SpecState,
    plan: RoundPlan,
    drafted: tuple,  # early_exit_draft's outputs
    hist_len0: torch.Tensor,  # [B] committed history incl. next_tok
    routes: Optional[RouteSink] = None,
) -> Tuple[_SpecState, torch.Tensor, torch.Tensor]:
    """The verify of an early-exit round, then ``accept_and_commit``: the
    stitched window (the exit hiddens, then the last draft through layers
    [0, E)) through the remaining layers or, after a quantized draft, the
    whole window through the base stack. The eager round calls it, and a
    session's ``VerifyGraph`` captures this same function
    (generation/draft_graph.py)."""
    drafts, d_probs, hist, tok, exit_h, early = drafted
    b, w = drafts.shape
    if plan.draft_params is None:
        vres = llama.forward_remainder(
            params, cfg, tok, torch.stack(exit_h, dim=1), early, s.full,
            draft_len=s.ctx + w, full_len=s.ctx, exit_layer=plan.exit_layer, routes=routes,
        )
    else:
        vres = _full_verify(params, cfg, s, plan, drafts, routes)
    w_dyn = torch.full((b,), w, dtype=torch.long, device=drafts.device)
    return accept_and_commit(cfg, s, plan, hist_len0, drafts, torch.stack(d_probs, dim=1),
                             hist, w_dyn, vres)


def _spec_round(
    params: LlamaParams,
    cfg: ModelConfig,
    s: _SpecState,
    plan: RoundPlan,
    *,
    draft_graph=None,
    verify_graph=None,
    routes: Optional[RouteSink] = None,
) -> Tuple[_SpecState, torch.Tensor, torch.Tensor]:
    """One draft+verify round: each active row commits its accepted drafts
    plus one extra token. Returns (the new state, the round's window [B, W+1]
    and its accepted-draft counts n [B]): window[:, :n + 1] are the tokens a
    row committed, and window[:, :W] the drafts with the extra token in place
    of the first rejected one. The state's caches are updated in place;
    random draws come from the state's generator(s), row r's from its own
    when there is one per row.

    The draft source is ``plan.source``: prompt lookup (``lookup``, and
    ``hybrid`` in rounds where every live row has a match), else early
    exit, confidence-adaptive for ``adaptive``. Prompt-lookup drafts are
    one-hot distributions, under which rejection sampling accepts while
    the verifier agrees, and the window is verified through every layer.

    With ``plan.draft_params`` (a quantized copy of layers [0, E), see
    quant.quantize_draft_params) the drafts read the cheap weights, but the
    verify must not reuse their exit hiddens: it re-runs
    ``[next_tok, drafts]`` through the full base stack (``forward_split``
    from ``s.ctx``), so committed tokens are judged by the base model and
    greedy output equals base AR. That pass rewrites the early KV the
    drafts wrote at positions ``ctx .. ctx + W - 1``.

    ``draft_graph`` and ``verify_graph`` (generation/draft_graph.py
    ``DraftGraph`` and ``VerifyGraph``, built together by a continuous
    session whose plan is greedy early-exit drafting with the base weights)
    replay the W draft passes, then the verify with acceptance and commit,
    from two CUDA graphs in place of launching them; the new state is then
    the verify graph's static outputs, which the next replay overwrites.

    ``routes`` (a continuous session's route records) takes the experts
    each MoE layer chose where the round writes KV: the draft passes at
    layers [0, E), the verify at [E, L) and the last draft's [0, E) (a
    full-stack verify at every layer)."""
    b = s.next_tok.shape[0]
    e, w = plan.exit_layer, plan.num_speculations
    scfg, ngram, draft_params = plan.scfg, plan.ngram, plan.draft_params
    generator = s.generator
    dev = s.next_tok.device
    hist_len0 = s.prompt_len + s.out_len  # committed history incl. next_tok

    def ban(logits, hist, hist_len):
        return _ban(logits, hist, hist_len, ngram, cfg.vocab_size)

    def full_verify(drafts):
        return _full_verify(params, cfg, s, plan, drafts, routes)

    def pld_draft_verify(proposals):
        """Copied drafts, one-hot, verified through every layer."""
        return (proposals, F.one_hot(proposals, cfg.vocab_size).float(),
                _row_update(s.hist, proposals, hist_len0),
                torch.full((b,), w, dtype=torch.long, device=dev), full_verify(proposals))

    def model_draft():
        return early_exit_draft(
            params if draft_params is None else draft_params, cfg, s.early, s.next_tok, s.ctx,
            s.hist, hist_len0, exit_layer=e, num_speculations=w, scfg=scfg,
            generator=generator, ngram=ngram, routes=routes)

    def adaptive_draft_verify():
        """Early-exit drafts while a row's drafted token keeps a probability
        of at least ``plan.draft_exit_prob`` under the raw softmax (the token
        that falls below stays in the window). A row that stopped keeps its
        generator, history and buffers; its KV writes in later steps land
        past its own window. The loop ends when no row drafts."""
        tau = plan.draft_exit_prob
        dparams = params if draft_params is None else draft_params
        early, tok, hist = s.early, s.next_tok, s.hist
        drafting = ~s.done  # done rows never draft
        w_dyn = torch.zeros((b,), dtype=torch.long, device=dev)
        drafts = torch.zeros((b, w), dtype=torch.long, device=dev)
        p_draft = torch.zeros((b, w, cfg.vocab_size), device=dev)
        # the exit hiddens feed only the stitched verify; after a quantized
        # draft the base stack re-runs the window instead
        exit_h = (torch.zeros((b, w, cfg.hidden_size), dtype=params.embed.dtype, device=dev)
                  if draft_params is None else None)
        rows = drafting.tolist()  # one host read a draft step
        i = 0
        while i < w and any(rows):
            r = llama.forward_early(dparams, cfg, tok, early, s.ctx + i, e, routes)
            logits = ban(r.logits[:, -1], hist, hist_len0 + i)
            probs = token_distribution(logits, scfg)  # [B, V]
            d_tok = draw(probs, generator, scfg, rows=rows)  # [B]
            rec = drafting
            drafts[:, i] = torch.where(rec, d_tok, drafts[:, i])
            p_draft[:, i] = torch.where(rec[:, None], probs, p_draft[:, i])
            if exit_h is not None:
                exit_h[:, i] = torch.where(rec[:, None], r.hidden[:, 0].to(exit_h.dtype),
                                           exit_h[:, i])
            hist = torch.where(rec[:, None], _row_update(hist, d_tok[:, None], hist_len0 + i),
                               hist)
            tok = torch.where(rec[:, None], d_tok[:, None], tok)
            w_dyn = w_dyn + rec.long()
            lf = logits.float()
            conf = torch.exp(lf.gather(1, d_tok[:, None])[:, 0] - torch.logsumexp(lf, dim=-1))
            drafting = rec & (conf >= tau)
            early = r.cache
            rows = drafting.tolist()
            i += 1
        # rows that drafted nothing (done rows) verify a window of one; their
        # acceptance is masked off below and they commit nothing
        w_dyn = w_dyn.clamp_min(1)
        if draft_params is not None:
            return drafts, p_draft, hist, w_dyn, full_verify(drafts)
        # the stitched window per row: the last draft's exit hidden goes at
        # position w_dyn, zeros past it (position j's logits see only < j)
        r_last = llama.forward_early(params, cfg, tok, early, s.ctx + w_dyn, e, routes)
        win_h = torch.cat([exit_h, torch.zeros_like(exit_h[:, :1])], dim=1)  # [B, W+1, D]
        sel = torch.arange(w + 1, device=dev)[None, :, None] == w_dyn[:, None, None]
        win_h = torch.where(sel, r_last.hidden.to(win_h.dtype), win_h)
        full_h, kf, vf = llama.run_layers(cfg, params.layers, win_h, s.full.k, s.full.v,
                                          s.ctx, layer_offset=e, routes=routes)
        vres = llama.RemainderResult(logits=llama.lm_logits(params, cfg, full_h),
                                     early_cache=r_last.cache,
                                     full_cache=KVCache(k=kf, v=vf))
        return drafts, p_draft, hist, w_dyn, vres

    if plan.source == "hybrid":
        proposals, has = _pld_propose(s.hist, hist_len0, w, plan.pld_ngram)
        # one host read a round picks the source
        if bool((has | s.done).all()):
            return accept_and_commit(cfg, s, plan, hist_len0, *pld_draft_verify(proposals))
        return early_exit_verify(params, cfg, s, plan, model_draft(), hist_len0, routes)
    if plan.source == "lookup":
        return accept_and_commit(cfg, s, plan, hist_len0, *pld_draft_verify(
            _pld_propose(s.hist, hist_len0, w, plan.pld_ngram)[0]))
    if plan.source == "adaptive":
        return accept_and_commit(cfg, s, plan, hist_len0, *adaptive_draft_verify())
    # the early-exit path's spans: the W draft passes, then the verify pass
    # with acceptance and commit, each replayed from the session's graph
    # (``graph`` 1) or launched one kernel at a time
    with span("spec.draft", graph=int(draft_graph is not None)):
        drafted = model_draft() if draft_graph is None else draft_graph.replay(s, hist_len0)
    with span("spec.verify", graph=int(verify_graph is not None)):
        if verify_graph is None:
            return early_exit_verify(params, cfg, s, plan, drafted, hist_len0, routes)
        return verify_graph.replay(s, drafted)
