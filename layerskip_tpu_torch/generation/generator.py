"""Generator facade: tokenize -> engine -> detokenize, with timing (port of
``layerskip_tpu/generation/generator.py``).

The strategy is ``GenerationConfig.generation_strategy``; the speculative
ones (``self_speculative``, ``prompt_lookup``, ``hybrid``) report their
acceptance.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import torch

from layerskip_tpu_torch.config import GenerationConfig, ModelConfig
from layerskip_tpu_torch.generation.engine import Engine, postprocess_output
from layerskip_tpu_torch.models.llama import LlamaParams


@dataclasses.dataclass
class GenerationStrategyResult:
    predicted_tokens: List[int]
    acceptance_rate: Optional[float] = None


@dataclasses.dataclass
class GenerationResult:
    generation_strategy_result: GenerationStrategyResult
    decoded_prediction: str
    num_tokens_generated: int
    total_time: float
    time_per_token: float
    tokens_per_second: float


class LlamaGenerator:
    """Text in, text out over an ``Engine`` on ``device`` (default
    ``"cuda"``; raises without a GPU unless ``device="cpu"``).

    ``tokenizer`` is any object with ``encode(text) -> List[int]`` (or
    ``__call__(text)`` giving ``input_ids``) and ``decode(ids) -> str``; HF
    tokenizers qualify. The engine never sees text. With a ``mesh`` the
    params are this rank's shards (``Engine``'s ``mesh``).
    """

    def __init__(self, tokenizer, params: LlamaParams, cfg: ModelConfig,
                 eos_ids: Sequence[int] = (), device="cuda", mesh=None):
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.engine = Engine(params, cfg, device=device, mesh=mesh)
        self.eos_ids = list(eos_ids) or self._tokenizer_eos() or cfg.eos_token_ids

    def _tokenizer_eos(self) -> List[int]:
        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is None:
            return []
        return [int(e) for e in (eos if isinstance(eos, (list, tuple)) else [eos])]

    def _encode(self, prompt: str) -> List[int]:
        if hasattr(self.tokenizer, "encode"):
            return list(self.tokenizer.encode(prompt))
        out = self.tokenizer(prompt)
        return list(out["input_ids"] if isinstance(out, dict) else out.input_ids)

    def _truncate_at_stop_words(self, tokens: List[int],
                                stop_words: Sequence[str]) -> List[int]:
        """The shortest prefix of ``tokens`` whose decoding contains a stop
        word (all of ``tokens`` when none does). Containment is monotone in
        the prefix length, so a binary search needs O(log n) decodes."""
        def hits(n: int) -> bool:
            text = self.tokenizer.decode(tokens[:n])
            return any(swd in text for swd in stop_words if swd)

        if not hits(len(tokens)):
            return tokens
        lo, hi = 1, len(tokens)  # invariant: hits(hi) is True
        while lo < hi:
            mid = (lo + hi) // 2
            if hits(mid):
                hi = mid
            else:
                lo = mid + 1
        return tokens[:hi]

    def generate(
        self,
        prompt: str,
        generation_config: GenerationConfig,
        streamer=None,
        generator: Optional[torch.Generator] = None,
        seed: int = 0,
    ) -> GenerationResult:
        """Tokenize, generate, detokenize. ``generator`` defaults to a torch
        generator on the engine's device seeded with ``seed``. The clock
        covers the generation up to its tokens reaching the host."""
        prompt_ids = self._encode(prompt)
        # the end tokens and the draft source as the engine resolves them
        plan = self.engine.round_plan(generation_config, self.eos_ids)
        if generator is None:
            generator = torch.Generator(device=self.engine.device).manual_seed(seed)

        start = time.time()
        out = self.engine.generate(prompt_ids, generation_config, generator, self.eos_ids)
        tokens = postprocess_output(out, plan.eos_ids, generation_config.max_steps)  # host sync
        total_time = time.time() - start
        if generation_config.stop_words:
            tokens = self._truncate_at_stop_words(tokens, generation_config.stop_words)
        if streamer is not None:
            streamer.put(tokens)
            streamer.end()
        acceptance = None
        if plan.source != "autoregressive":
            acceptance = int(out.matches) / max(int(out.drafts), 1)
        return make_result(self.tokenizer, tokens, acceptance, total_time)


def make_result(tokenizer, tokens: List[int], acceptance: Optional[float],
                total_time: float) -> GenerationResult:
    """A ``GenerationResult`` of ``tokens`` generated in ``total_time`` s."""
    n = len(tokens)
    return GenerationResult(
        generation_strategy_result=GenerationStrategyResult(
            predicted_tokens=tokens, acceptance_rate=acceptance),
        decoded_prediction=tokenizer.decode(tokens),
        num_tokens_generated=n,
        total_time=total_time,
        time_per_token=total_time / max(n, 1),
        tokens_per_second=n / total_time if total_time > 0 else 0.0,
    )
