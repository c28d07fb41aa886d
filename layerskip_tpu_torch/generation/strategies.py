"""Strategy classes with the LayerSkip API's names (port of
``layerskip_tpu/generation/strategies.py``).

LayerSkip exposes ``GenerationStrategy`` and one subclass per strategy; here
each strategy is ``GenerationConfig.generation_strategy`` of one
``Engine.generate``, and these thin classes, which differ only in the name
they set, let code written against the class-based API run unchanged.
The speculative strategies report their acceptance (matches / drafts).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from layerskip_tpu_torch.config import GenerationConfig
from layerskip_tpu_torch.generation.engine import Engine, postprocess_output
from layerskip_tpu_torch.generation.generator import GenerationStrategyResult


SPECULATIVE = ("self_speculative", "prompt_lookup", "hybrid")


class GenerationStrategy:
    """One strategy of ``Engine.generate``, named by ``strategy_name``."""

    strategy_name: str = ""

    def generate_token_ids(
        self,
        engine: Engine,
        input_ids: List[int],
        eos_token_ids: Sequence[int],
        generation_config: GenerationConfig,
        generator: Optional[torch.Generator] = None,
        streamer=None,
    ) -> GenerationStrategyResult:
        cfg = dataclasses.replace(generation_config, generation_strategy=self.strategy_name)
        out = engine.generate(input_ids, cfg, generator, eos_token_ids)
        tokens = postprocess_output(out, eos_token_ids, cfg.max_steps)
        if streamer is not None:
            streamer.put(tokens)
        acceptance = None
        if self.strategy_name in SPECULATIVE:
            acceptance = int(out.matches) / max(int(out.drafts), 1)
        return GenerationStrategyResult(predicted_tokens=tokens, acceptance_rate=acceptance)


class AutoRegressiveGenerationStrategy(GenerationStrategy):
    """Greedy or sampled AR (early-exit AR when ``exit_layer > 0``)."""

    strategy_name = "autoregressive"


class SelfSpeculativeGenerationStrategy(GenerationStrategy):
    strategy_name = "self_speculative"


class PromptLookupGenerationStrategy(GenerationStrategy):
    """n-gram drafts copied from the context, verified through the full
    model: no draft-model calls (``GenerationConfig.pld_ngram`` sets the
    match length)."""

    strategy_name = "prompt_lookup"


class HybridGenerationStrategy(GenerationStrategy):
    """Per-round choice of the draft source: prompt lookup in rounds where
    every live row's committed suffix occurred earlier, early exit in the
    rest. Uses ``exit_layer``, ``num_speculations`` and ``pld_ngram``."""

    strategy_name = "hybrid"
