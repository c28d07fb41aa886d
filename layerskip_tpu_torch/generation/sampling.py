"""Token sampling: greedy and temperature / top-k / top-p (port of
``layerskip_tpu/generation/sampling.py``).

Greedy decoding is a one-hot distribution, so speculative rejection sampling
degenerates exactly to longest-prefix matching: one code path serves both.
Random draws come from an explicit ``torch.Generator``; they differ from
``jax.random``'s, so sampled streams are compared by distribution only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    sample: bool = True
    temperature: float = 0.6
    top_k: int = 0
    top_p: float = 0.9


def top_k_top_p_filter(logits: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """Mask [..., V] fp32 logits to the top-k, then to the nucleus (the token
    that crosses the ``top_p`` mass boundary is kept)."""
    v = logits.shape[-1]
    if top_k and 0 < top_k < v:
        kth = torch.sort(logits, dim=-1).values[..., v - top_k, None]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1) - probs  # mass strictly before each
        num_keep = (cum < top_p).sum(dim=-1, keepdim=True)  # >= 1
        thresh = torch.gather(sorted_logits, -1, num_keep - 1)
        logits = torch.where(logits < thresh, NEG_INF, logits)
    return logits


def token_distribution(logits: torch.Tensor, scfg: SamplingConfig) -> torch.Tensor:
    """[..., V] logits -> the distribution tokens are drawn from (one-hot of
    the argmax when greedy; the first maximum wins ties)."""
    logits = logits.float()
    if not scfg.sample:
        return F.one_hot(torch.argmax(logits, dim=-1), logits.shape[-1]).float()
    t = max(scfg.temperature, 1e-5)
    return torch.softmax(top_k_top_p_filter(logits / t, scfg.top_k, scfg.top_p), dim=-1)


def draw(probs: torch.Tensor, generator: Optional[torch.Generator],
         scfg: SamplingConfig) -> torch.Tensor:
    """Token ids from [..., V] probabilities: the argmax when greedy, else a
    Gumbel-max draw over log-probabilities (as ``jax.random.categorical``
    draws), one independent draw per row from ``generator``."""
    if not scfg.sample:
        return torch.argmax(probs, dim=-1)
    logp = torch.log(probs + 1e-30)
    u = torch.rand(probs.shape, generator=generator, device=probs.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logp + gumbel, dim=-1)
