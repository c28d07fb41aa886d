"""Generation engines: autoregressive and self-speculative (port of
``layerskip_tpu/generation/engine.py``).

Prompts are right-padded to a bucket length; every key slot a query can see
is written before the query reaches it, so pad contents never matter. The
loops run on the host with one device sync per step (AR) or per round
(spec); everything else stays on the device. EOS stops a row through its
``done`` flag, and the host drops the committed tokens from the first EOS on
(``postprocess_batch``).

Weight-quantized bases (quant.quantize_llama_params), quantized drafters
(``GenerationConfig.draft_quant``), the int8 KV cache (``kv_quant``) and
every draft source (early exit, confidence-adaptive, prompt lookup, hybrid,
tree speculation; generation/spec.py and generation/tree.py) run through
the same entry point. ``Engine.continuous_session`` serves rows that join
and leave at round granularity, over contiguous or paged KV
(generation/continuous.py). ``Engine.stream_generate`` runs the same
speculative loop with a host callback after each round (streaming).

The request contract is the JAX package's, with its assertions raised as
``ValueError``: ``prompt_lookup`` takes ``exit_layer = max(L // 2, 1)``
when none is set (the split does not change its drafts); ``hybrid`` needs
``exit_layer``, ``num_speculations`` and ``pld_ngram`` > 0; tree
speculation (``spec_tree_width`` > 1) applies to ``self_speculative`` only,
and neither trees nor hybrid drafting take adaptive drafting.
``Engine.round_plan`` makes these checks once a request and resolves how
its rounds draft into a ``RoundPlan`` (generation/core.py), which the solo
loops, the continuous session, the round and the draft graph read.

A sharded engine (``Engine(..., mesh=, kv_shard_axis=)``, parallel/) runs
every call under its rank's ``ShardContext``: the weights are the rank's
slices (``parallel.sharding.shard_params``), the layer functions issue the
collectives, and every rank holds the same full logits, so the host
decisions (acceptance, EOS, sampled tokens from identically seeded
generators, page allocation) agree on every rank. Under dp each dp group
runs its own rows (the batch must divide by dp) and the results are
gathered; under sp (the KV sequence dim) trees and continuous sessions are
refused, as their slot moves cross the slabs.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from layerskip_tpu_torch.config import GenerationConfig, ModelConfig
from layerskip_tpu_torch.device import resolve_device
from layerskip_tpu_torch.generation.continuous import ContinuousSession
from layerskip_tpu_torch.generation.core import (
    GenerateOutput,
    RoundPlan,
    _bucket,
    _is_eos,
    _mk_group_cache,
    _row_gather,
    _row_update,
)
from layerskip_tpu_torch.generation.processors import apply_ban, no_repeat_ngram_banned
from layerskip_tpu_torch.generation.sampling import (
    Generators,
    SamplingConfig,
    draw,
    token_distribution,
)
from layerskip_tpu_torch.generation.spec import spec_generate
from layerskip_tpu_torch.models import llama
from layerskip_tpu_torch.models.llama import LlamaParams
from layerskip_tpu_torch.ops.linear import QuantTensor
from layerskip_tpu_torch.parallel.collectives import all_gather, all_reduce, sharded
from layerskip_tpu_torch.parallel.sharding import check_divisible, context_from_mesh
from layerskip_tpu_torch.quant import _MLP_FIELDS, _QUANT_FIELDS, quantize_draft_params


def ar_generate(
    params: LlamaParams,
    cfg: ModelConfig,
    ids: torch.Tensor,  # [B, P] right-padded prompt
    true_len: torch.Tensor,  # [B]
    generator: Generators,  # one generator, or one per row
    plan: RoundPlan,
    *,
    max_steps: int,
    max_cache_len: int,
) -> GenerateOutput:
    """Whole AR generation: prefill (shared past 0, so the flash-prefill
    kernel runs), then one token per step for every row not yet done.
    ``plan.exit_layer`` > 0 runs layers [0, E) and the shared head, and
    ``plan.kv_quant`` keeps the KV cache in int8."""
    b, p = ids.shape
    dev = ids.device
    scfg, eos_ids, ngram = plan.scfg, plan.eos_ids, plan.ngram
    nlayers = plan.exit_layer if plan.exit_layer > 0 else cfg.num_hidden_layers
    cache = _mk_group_cache(cfg, nlayers, b, max_cache_len, dev, plan.kv_quant)

    def ban(logits, hist, hist_len):
        if ngram <= 0:
            return logits
        return apply_ban(logits, no_repeat_ngram_banned(hist, hist_len, ngram, cfg.vocab_size))

    h = llama.embed_tokens(params, ids, cfg)
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
        h = llama.embed_tokens(params, next_tok, cfg)
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

    With a ``mesh`` (parallel/mesh.py) the params are this rank's slices
    (``shard_params(params, mesh)``) and every rank of the mesh makes the
    same calls; ``kv_shard_axis`` names the mesh dim that splits the KV
    sequence (sequence-sharded decode).
    """

    def __init__(self, params: LlamaParams, cfg: ModelConfig, device="cuda",
                 mesh=None, kv_shard_axis: Optional[str] = None):
        self.device = resolve_device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params on {params.embed.device}, engine on {self.device}")
        self.shard = context_from_mesh(mesh, kv_shard_axis)
        check_divisible(cfg, self.shard)
        tp = self.shard.tp.size if self.shard and self.shard.tp else 1
        if params.layers.wq.shape[1] * tp != cfg.num_attention_heads * cfg.head_dim:
            raise ValueError(f"wq has {params.layers.wq.shape[1]} rows at tp={tp}: pass "
                             "this rank's shard_params(params, mesh)")
        # quantized draft-layer-group copies keyed (exit_layer, bits, head,
        # mlp_only), built once per engine; declared before ``params``, whose
        # setter clears it
        self._draft_cache: dict = {}
        self.params = params
        self.cfg = cfg

    @property
    def params(self) -> LlamaParams:
        return self._params

    @params.setter
    def params(self, value: LlamaParams) -> None:
        # new weights must drop the drafters quantized from the old ones
        self._params = value
        self._draft_cache.clear()

    @contextlib.contextmanager
    def inference(self):
        """Inference mode under this engine's sharded context: the frame of
        every device call (the session's methods too)."""
        with torch.inference_mode(), sharded(self.shard):
            yield

    def _draft_params(self, exit_layer: int, bits: int, head: bool = False,
                      mlp_only: bool = False) -> LlamaParams:
        """Quantized copy of layers [0, exit_layer) for cheap drafting
        (``GenerationConfig.draft_quant``, group 128 for int4). ``head`` also
        quantizes the drafter's head (``draft_quant_head``); ``mlp_only``
        quantizes only the MLP triple (``draft_quant_mlp_only``)."""
        key = (exit_layer, bits, head, mlp_only)
        if key not in self._draft_cache:
            self._draft_cache[key] = quantize_draft_params(
                self.params, exit_layer, bits=bits, group=0 if bits == 8 else 128,
                quantize_head=head, fields=_MLP_FIELDS if mlp_only else _QUANT_FIELDS,
            )
        return self._draft_cache[key]

    def round_plan(self, gen_cfg: GenerationConfig, eos_ids: Sequence[int] = ()) -> RoundPlan:
        """How every round of a ``gen_cfg`` request drafts, after the JAX
        engine's contract checks (see the module docstring): its end tokens
        (``eos_ids``, else the model's, then ``stop_token_ids``), its
        sampling and n-gram ban, the draft source and its settings. Only
        early-exit drafting (adaptive included) takes a quantized drafter
        (``draft_quant``): a base that is already quantized drafts cheaply
        as it is."""
        strategy = gen_cfg.generation_strategy
        if strategy not in ("autoregressive",) + _SPEC_STRATEGIES:
            raise ValueError(f"unknown strategy: {strategy}")
        eos = tuple(int(x) for x in eos_ids) or tuple(self.cfg.eos_token_ids)
        eos += tuple(int(x) for x in gen_cfg.stop_token_ids or ())
        exit_layer, w = gen_cfg.exit_layer, gen_cfg.num_speculations
        tree_width = int(gen_cfg.spec_tree_width or 0) if strategy == "self_speculative" else 0
        pld = int(gen_cfg.pld_ngram or 0) if strategy in ("prompt_lookup", "hybrid") else 0
        prob = float(gen_cfg.draft_exit_prob or 0.0)
        if strategy == "self_speculative":
            if not (exit_layer > 0 and w > 0):
                raise ValueError("self_speculative needs exit_layer > 0 and num_speculations > 0")
            if tree_width > 1 and prob:
                raise ValueError("spec_tree_width excludes adaptive drafting")
        elif strategy == "prompt_lookup":
            if w <= 0:
                raise ValueError("prompt_lookup needs num_speculations > 0")
            if exit_layer <= 0:  # the split does not change lookup drafts
                exit_layer = max(self.cfg.num_hidden_layers // 2, 1)
        elif strategy == "hybrid":
            if not (exit_layer > 0 and w > 0 and pld > 0):
                raise ValueError("hybrid needs exit_layer > 0, num_speculations > 0 and "
                                 "pld_ngram > 0")
            if prob:
                raise ValueError("hybrid and adaptive drafting are mutually exclusive")
        source = ("autoregressive" if strategy == "autoregressive"
                  else "hybrid" if strategy == "hybrid" else "tree" if tree_width > 1
                  else "lookup" if pld > 0 else "adaptive" if prob > 0 else "early_exit")
        draft = None
        if (gen_cfg.draft_quant and strategy == "self_speculative" and tree_width <= 1
                and not isinstance(self.params.layers.wq, QuantTensor)):
            with self.inference():
                draft = self._draft_params(exit_layer, int(gen_cfg.draft_quant),
                                           bool(gen_cfg.draft_quant_head),
                                           bool(gen_cfg.draft_quant_mlp_only))
        return RoundPlan(
            source=source, exit_layer=exit_layer, num_speculations=max(w, 1),
            scfg=SamplingConfig(sample=gen_cfg.sample, temperature=gen_cfg.temperature,
                                top_k=gen_cfg.top_k, top_p=gen_cfg.top_p),
            eos_ids=eos, ngram=int(gen_cfg.no_repeat_ngram_size or 0), pld_ngram=pld,
            tree_width=tree_width, draft_exit_prob=prob if source == "adaptive" else 0.0,
            draft_params=draft, kv_quant=bool(gen_cfg.kv_quant))

    def _request(self, prompt_ids, gen_cfg: GenerationConfig, generator: Generators,
                 eos_ids: Sequence[int]):
        """The validated inputs of one generation: (its plan, ids [B, bucket],
        true lengths [B], generator(s), the loops' per-request keywords)."""
        padded, true_lens = _pad_prompts(
            prompt_ids, fixed_bucket=gen_cfg.max_prompt_len or None
        )
        b, bucket = padded.shape
        if isinstance(generator, (list, tuple)):
            if len(generator) != b:
                raise ValueError(f"{len(generator)} generators for {b} rows")
            generator = list(generator)
        plan = self.round_plan(gen_cfg, eos_ids)
        max_steps = gen_cfg.max_steps
        cap = gen_cfg.max_seq_len or self.cfg.max_position_embeddings
        if bucket + max_steps > cap:
            # keep positions inside the model's trained RoPE range
            max_steps = max(cap - bucket, 1)
        # tree speculation parks k interleaved chains past the frontier
        max_cache_len = bucket + max_steps + plan.num_speculations * max(plan.tree_width, 1) + 2
        if bucket % 256 == 0:
            # the JAX package rounds to its TPU kernel's key block; kept so
            # both packages allocate the same cache
            max_cache_len = -(-max_cache_len // 512) * 512
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        dp = self.shard.dp if self.shard else None
        if dp is not None:  # this dp group's rows
            if b % dp.size:
                raise ValueError(f"batch {b} does not divide by dp={dp.size}")
            rows = slice(dp.rank * b // dp.size, (dp.rank + 1) * b // dp.size)
            padded, true_lens = padded[rows], true_lens[rows]
            if isinstance(generator, list):
                generator = generator[rows]
        if self.shard and self.shard.sp and plan.source == "tree":
            raise ValueError("tree speculation moves KV slots across the sp slabs; "
                             "it does not run sequence-sharded")
        ids = torch.as_tensor(padded, dtype=torch.long, device=self.device)
        true_len = torch.as_tensor(true_lens, dtype=torch.long, device=self.device)
        return plan, ids, true_len, generator, dict(max_steps=max_steps,
                                                    max_cache_len=max_cache_len)

    def generate(
        self,
        prompt_ids,  # list[int] (batch=1), list[list[int]] (ragged batch), or [B, T]
        gen_cfg: GenerationConfig,
        generator: Generators = None,  # one generator (default: seeded with 0),
        # or one per row, so each row samples from its own stream
        eos_ids: Sequence[int] = (),
    ) -> GenerateOutput:
        with self.inference():
            plan, ids, true_len, generator, common = self._request(
                prompt_ids, gen_cfg, generator, eos_ids)
            loop = ar_generate if plan.source == "autoregressive" else spec_generate
            return self._gather_rows(loop(self.params, self.cfg, ids, true_len, generator,
                                          plan, **common))

    def _gather_rows(self, out: GenerateOutput) -> GenerateOutput:
        """Every dp group's rows and summed counters, on every rank."""
        dp = self.shard.dp if self.shard else None
        if dp is None:
            return out
        return GenerateOutput(tokens=all_gather(out.tokens, dp, 0),
                              num_tokens=all_gather(out.num_tokens, dp, 0),
                              matches=all_reduce(out.matches, dp),
                              drafts=all_reduce(out.drafts, dp))

    def stream_generate(
        self,
        prompt_ids,
        gen_cfg: GenerationConfig,
        generator: Generators = None,
        eos_ids: Sequence[int] = (),
        on_round=None,
    ) -> GenerateOutput:
        """Speculative ``generate`` (any draft source) with a host callback
        per round, ``on_round(drafted, accepted)`` over row 0 (see
        ``spec_generate``). It drives the draft-repaint streamer
        (generation/streamer.py)."""
        if self.shard and self.shard.dp:
            raise ValueError("stream_generate streams row 0: it does not run under dp")
        with self.inference():
            plan, ids, true_len, generator, common = self._request(
                prompt_ids, gen_cfg, generator, eos_ids)
            if plan.source == "autoregressive":
                raise ValueError("stream_generate runs a speculative strategy, not "
                                 "'autoregressive'")
            return spec_generate(self.params, self.cfg, ids, true_len, generator, plan,
                                 on_round=on_round, **common)

    def continuous_session(
        self, gen_cfg: GenerationConfig, batch: int, prompt_bucket: int,
        eos_ids: Sequence[int] = (), paged_pool_pages: int = 0, page_size: int = 256,
        prefix_cache: bool = False,
    ) -> ContinuousSession:
        """A live ``batch``-slot speculative session (continuous batching;
        generation/continuous.py) with the config's draft source.
        ``paged_pool_pages > 0`` puts the KV in a pool of that many shared
        pages of ``page_size`` tokens instead of per-slot worst-case
        buffers; ``prefix_cache`` (paged only) also shares page-aligned
        prompt-prefix KV across requests. ``draft_quant`` and ``kv_quant``
        apply as in ``generate``. A sharded engine serves under tp and ep
        (every rank inserts and steps alike); dp and sp are refused."""
        if self.shard and (self.shard.dp or self.shard.sp):
            raise ValueError("a continuous session shards over tp and ep only, not dp or sp")
        plan = self.round_plan(gen_cfg, eos_ids)
        if plan.source == "autoregressive":
            raise ValueError("continuous batching runs a speculative strategy, not "
                             "'autoregressive'")
        if not (0 < gen_cfg.exit_layer < self.cfg.num_hidden_layers):
            raise ValueError("continuous batching needs 0 < exit_layer < num_hidden_layers "
                             "and num_speculations > 0")
        paged = (int(paged_pool_pages), int(page_size)) if paged_pool_pages else None
        return ContinuousSession(self, gen_cfg, plan, batch, prompt_bucket, paged=paged,
                                 prefix_cache=prefix_cache)


_SPEC_STRATEGIES = ("self_speculative", "prompt_lookup", "hybrid")


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
