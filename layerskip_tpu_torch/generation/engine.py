"""Generation engines: autoregressive and self-speculative (port of
``layerskip_tpu/generation/engine.py``).

Prompts are right-padded to a bucket length; every key slot a query can see
is written before the query reaches it, so pad contents never matter. The
loops run on the host with one device sync per step (AR) or per round
(spec); everything else stays on the device. EOS stops a row through its
``done`` flag, and the host drops the committed tokens from the first EOS on
(``postprocess_batch``).

Stepped mode, streaming and continuous batching belong to later slices.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from layerskip_tpu_torch.config import GenerationConfig, ModelConfig
from layerskip_tpu_torch.device import resolve_device
from layerskip_tpu_torch.generation.core import (
    GenerateOutput,
    _bucket,
    _is_eos,
    _mk_group_cache,
    _row_gather,
    _row_update,
)
from layerskip_tpu_torch.generation.processors import apply_ban, no_repeat_ngram_banned
from layerskip_tpu_torch.generation.sampling import (
    SamplingConfig,
    draw,
    token_distribution,
)
from layerskip_tpu_torch.generation.spec import spec_generate
from layerskip_tpu_torch.models import llama
from layerskip_tpu_torch.models.llama import LlamaParams


def ar_generate(
    params: LlamaParams,
    cfg: ModelConfig,
    ids: torch.Tensor,  # [B, P] right-padded prompt
    true_len: torch.Tensor,  # [B]
    generator: Optional[torch.Generator],
    *,
    max_steps: int,
    exit_layer: int,  # <= 0 => full model; > 0 => layers [0, E) + shared head
    scfg: SamplingConfig,
    eos_ids: Tuple[int, ...],
    max_cache_len: int,
    ngram: int = 0,
    kv_quant: bool = False,
) -> GenerateOutput:
    """Whole AR generation: prefill (shared past 0, so the flash-prefill
    kernel runs), then one token per step for every row not yet done."""
    if kv_quant:
        raise NotImplementedError("int8 KV is not ported yet")
    b, p = ids.shape
    dev = ids.device
    nlayers = exit_layer if exit_layer > 0 else cfg.num_hidden_layers
    cache = _mk_group_cache(cfg, nlayers, b, max_cache_len, dev)

    def ban(logits, hist, hist_len):
        if ngram <= 0:
            return logits
        return apply_ban(logits, no_repeat_ngram_banned(hist, hist_len, ngram, cfg.vocab_size))

    h = llama.embed_tokens(params, ids)
    h, k, v = llama.run_layers(cfg, params.layers, h, cache.k, cache.v, 0)
    last_h = _row_gather(h, true_len - 1)  # [B, D]
    logits0 = llama.lm_logits(params, cfg, last_h[:, None])[:, 0]  # [B, V]
    hist = torch.cat([ids, torch.zeros((b, max_steps + 1), dtype=ids.dtype, device=dev)], 1)
    logits0 = ban(logits0, hist, true_len)
    tok0 = draw(token_distribution(logits0, scfg), generator, scfg)
    hist = _row_update(hist, tok0[:, None], true_len)

    out = torch.zeros((b, max_steps), dtype=torch.long, device=dev)
    out[:, 0] = tok0
    ctx = true_len.clone()
    next_tok = tok0[:, None]
    out_len = torch.ones((b,), dtype=torch.long, device=dev)
    done = _is_eos(tok0, eos_ids) | (max_steps <= 1)
    while not bool(done.all()):
        h = llama.embed_tokens(params, next_tok)
        h, k, v = llama.run_layers(cfg, params.layers, h, k, v, ctx)
        logits = ban(llama.lm_logits(params, cfg, h)[:, -1], hist, true_len + out_len)
        tok = draw(token_distribution(logits, scfg), generator, scfg)
        active = ~done  # frozen rows keep buffers and counters unchanged
        out = torch.where(active[:, None], _row_update(out, tok[:, None], out_len), out)
        hist = torch.where(
            active[:, None], _row_update(hist, tok[:, None], true_len + out_len), hist
        )
        out_len = out_len + active.long()
        done = done | _is_eos(tok, eos_ids) | (out_len >= max_steps)
        ctx = ctx + active.long()
        next_tok = tok[:, None]
    zero = torch.zeros((), dtype=torch.long, device=dev)
    return GenerateOutput(tokens=out, num_tokens=out_len, matches=zero, drafts=zero)


class Engine:
    """Holds params on one device and runs ``generate`` requests.

    ``device`` defaults to ``"cuda"`` and the constructor raises when no GPU
    is present; pass ``device="cpu"`` to run on the CPU. The params must
    already live on that device (``init_params``/``make_random_params``/
    ``params_from_*`` take the same ``device``).
    """

    def __init__(self, params: LlamaParams, cfg: ModelConfig, device="cuda"):
        self.device = resolve_device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params on {params.embed.device}, engine on {self.device}")
        llama.check_supported(cfg)
        self.params = params
        self.cfg = cfg

    def generate(
        self,
        prompt_ids,  # list[int] (batch=1), list[list[int]] (ragged batch), or [B, T]
        gen_cfg: GenerationConfig,
        generator: Optional[torch.Generator] = None,  # default: seeded with 0
        eos_ids: Sequence[int] = (),
    ) -> GenerateOutput:
        padded, true_lens = _pad_prompts(
            prompt_ids, fixed_bucket=gen_cfg.max_prompt_len or None
        )
        b, bucket = padded.shape
        scfg = SamplingConfig(sample=gen_cfg.sample, temperature=gen_cfg.temperature,
                              top_k=gen_cfg.top_k, top_p=gen_cfg.top_p)
        eos = tuple(int(x) for x in eos_ids) or tuple(self.cfg.eos_token_ids)
        if gen_cfg.stop_token_ids:
            eos = eos + tuple(int(x) for x in gen_cfg.stop_token_ids)
        strategy = gen_cfg.generation_strategy
        if strategy in ("prompt_lookup", "hybrid"):
            raise NotImplementedError(f"strategy {strategy!r} is not ported yet")
        if strategy not in ("autoregressive", "self_speculative"):
            raise ValueError(f"unknown strategy: {strategy}")
        for on, what in ((gen_cfg.kv_quant, "int8 KV"),
                         (gen_cfg.draft_exit_prob, "adaptive drafting"),
                         (strategy == "self_speculative" and (gen_cfg.spec_tree_width or 0) > 1,
                          "tree speculation"),
                         (strategy == "self_speculative" and gen_cfg.draft_quant,
                          "quantized drafters")):
            if on:
                raise NotImplementedError(f"{what} is not ported yet")
        exit_layer = gen_cfg.exit_layer
        num_speculations = max(gen_cfg.num_speculations, 1)
        if strategy == "self_speculative" and not (
                exit_layer > 0 and gen_cfg.num_speculations > 0):
            raise ValueError("self_speculative needs exit_layer > 0 and num_speculations > 0")
        max_steps = gen_cfg.max_steps
        cap = gen_cfg.max_seq_len or self.cfg.max_position_embeddings
        if bucket + max_steps > cap:
            # keep positions inside the model's trained RoPE range
            max_steps = max(cap - bucket, 1)
        max_cache_len = bucket + max_steps + num_speculations + 2
        if bucket % 256 == 0:
            # the JAX package rounds to its TPU kernel's key block; kept so
            # both packages allocate the same cache
            max_cache_len = -(-max_cache_len // 512) * 512
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        ids = torch.as_tensor(padded, dtype=torch.long, device=self.device)
        true_len = torch.as_tensor(true_lens, dtype=torch.long, device=self.device)
        common = dict(max_steps=max_steps, exit_layer=exit_layer, scfg=scfg,
                      eos_ids=eos, max_cache_len=max_cache_len,
                      ngram=int(gen_cfg.no_repeat_ngram_size or 0))
        with torch.inference_mode():
            if strategy == "autoregressive":
                return ar_generate(self.params, self.cfg, ids, true_len, generator,
                                   **common)
            return spec_generate(self.params, self.cfg, ids, true_len, generator,
                                 num_speculations=num_speculations, **common)


def _pad_prompts(prompt_ids, fixed_bucket=None):
    """Normalize prompts to a right-padded [B, bucket] array + [B] lengths.

    Accepts a flat list of ints (batch=1), a list of per-row token lists
    (ragged batch), or a rectangular array. ``fixed_bucket`` pins the pad
    width; longer prompts keep their most recent tokens.
    """
    if (isinstance(prompt_ids, (list, tuple)) and prompt_ids
            and isinstance(prompt_ids[0], (list, tuple))):
        rows = [list(r) for r in prompt_ids]
    else:
        arr = np.asarray(prompt_ids)
        rows = [arr.tolist()] if arr.ndim == 1 else [r.tolist() for r in arr]
    if fixed_bucket:
        rows = [r[-fixed_bucket:] for r in rows]
    lens = [max(len(r), 1) for r in rows]
    bucket = fixed_bucket or _bucket(max(lens))
    padded = np.zeros((len(rows), bucket), np.int64)
    for i, r in enumerate(rows):
        padded[i, : len(r)] = r
    return padded, np.asarray(lens, np.int64)


def postprocess_batch(out: GenerateOutput, eos_ids: Sequence[int], max_steps: int) -> list:
    """Host-side EOS truncation per row (the EOS token itself is dropped)."""
    tokens = out.tokens.cpu().numpy()
    counts = out.num_tokens.cpu().numpy()
    result = []
    for r in range(tokens.shape[0]):
        toks = tokens[r][: int(counts[r])][:max_steps].tolist()
        for e in eos_ids:
            if e in toks:
                toks = toks[: toks.index(e)]
        result.append(toks)
    return result


def postprocess_output(out: GenerateOutput, eos_ids: Sequence[int], max_steps: int) -> list:
    """Row-0 convenience wrapper."""
    return postprocess_batch(out, eos_ids, max_steps)[0]
