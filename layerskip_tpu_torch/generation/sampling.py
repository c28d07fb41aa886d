"""Token sampling: greedy and temperature / top-k / top-p (port of
``layerskip_tpu/generation/sampling.py``).

Greedy decoding is a one-hot distribution, so speculative rejection sampling
degenerates exactly to longest-prefix matching: one code path serves both.
Random draws come from an explicit ``torch.Generator``, or from one
generator per batch row (continuous serving seeds each request's row, so its
stream depends only on its own seed). They differ from ``jax.random``'s, so
sampled streams are compared with the JAX package's by distribution only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

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


Generators = Union[None, torch.Generator, Sequence[torch.Generator]]


def uniform(shape, generator: Generators, device) -> torch.Tensor:
    """U[0, 1) of ``shape`` from ``generator``; with a sequence of generators,
    row r of the leading axis comes from generator r alone."""
    if isinstance(generator, (list, tuple)):
        return torch.stack([torch.rand(shape[1:], generator=g, device=device)
                            for g in generator])
    return torch.rand(shape, generator=generator, device=device)


def draw(probs: torch.Tensor, generator: Generators,
         scfg: SamplingConfig, rows: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Token ids from [..., V] probabilities: the argmax when greedy (no
    random draw), else a Gumbel-max draw over log-probabilities (as
    ``jax.random.categorical`` draws), one independent draw per row from
    ``generator`` (see ``uniform``). With one generator per row, ``rows``
    (host flags) limits the draws to the rows flagged; the others get the
    argmax and their generators stay untouched."""
    if not scfg.sample:
        return torch.argmax(probs, dim=-1)
    if rows is not None and isinstance(generator, (list, tuple)) and not all(rows):
        out = torch.argmax(probs, dim=-1)
        idx = [r for r, on in enumerate(rows) if on]
        if idx:
            out[idx] = draw(probs[idx], [generator[r] for r in idx], scfg)
        return out
    logp = torch.log(probs + 1e-30)
    u = uniform(probs.shape, generator, probs.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logp + gumbel, dim=-1)
