"""The comparison that decides ``correct`` for a served model.

Once the window has closed, a sample of the requests the program finished,
drawn from the seed and holding the one with the most served tokens, is run
through the plain reference (``reference/model.py``), each prompt with its
served tokens appended. For each served token the number read is the gap
by which the reference's logit of that token lies below the reference's
best logit at that position; the run's number is the widest gap over the
sample. Greedy decoding serves the program's own best token, so a sound
run reads only the rounding between the program's bf16 and the
reference's float32 (near ties); a wrong token reads the reference's full
margin.

The control takes the program's place in the same comparison: at each
position of the same prompts and served tokens, the token that the
reference computed in float8 (``precision="fp8"``) puts first is judged
instead of the program's (``control_tokens``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from loadbench.reference.model import float32_exact, logits_at


@dataclass
class Served:
    prompt: List[int]
    tokens: List[int]  # the tokens judged
    context: Optional[List[int]] = None  # the tokens fed after the prompt, if not these


def sample_indices(lengths: Sequence[Tuple[int, int]], seed: int,
                   min_tokens: int) -> List[int]:
    """Of requests with these (served, prompt) lengths: the one with the
    most served tokens, then others in an order drawn from the seed until
    ``min_tokens`` served tokens are held."""
    if not lengths:
        return []
    first = max(range(len(lengths)), key=lambda i: lengths[i])
    order = np.random.default_rng([int(seed) & (2 ** 63 - 1), 0xC4EC]).permutation(
        len(lengths))
    picked, total = [first], lengths[first][0]
    for i in order.tolist():
        if total >= min_tokens:
            break
        if i != first:
            picked.append(i)
            total += lengths[i][0]
    return picked


def sample(served: Sequence[Served], seed: int, min_tokens: int) -> List[Served]:
    lengths = [(len(r.tokens), len(r.prompt)) for r in served]
    return [served[i] for i in sample_indices(lengths, seed, min_tokens)]


def _spans(reqs: Sequence[Served]):
    fed = [r.tokens if r.context is None else r.context for r in reqs]
    seqs = [r.prompt + f[:-1] for r, f in zip(reqs, fed)]
    spans = [(len(r.prompt) - 1, len(r.prompt) - 1 + len(f)) for r, f in zip(reqs, fed)]
    return seqs, spans


def gaps(weights: Dict[str, torch.Tensor], hf: dict,
         reqs: Sequence[Served]) -> Dict[str, float]:
    """``{"max_gap": ..., "tokens": ...}`` of the judged tokens, with the
    mean, the 90th percentile and the share of tokens that are not the
    reference's best."""
    seqs, spans = _spans(reqs)
    with float32_exact():
        ref = logits_at(weights, hf, seqs, spans, "fp32")
    judged = []
    for r, lg in zip(reqs, ref):
        tok = torch.as_tensor(r.tokens, device=lg.device)
        judged.append(lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0])
    g = torch.cat(judged)
    return {"max_gap": float(g.max()), "mean_gap": float(g.mean()),
            "p90_gap": float(torch.quantile(g, 0.9)),
            "off_share": float((g > 0).float().mean()), "tokens": float(g.numel())}


def control_tokens(weights: Dict[str, torch.Tensor], hf: dict,
                   reqs: Sequence[Served]) -> List[Served]:
    """The control in the program's place: at each served position of these
    requests, the token that the reference computed in float8 puts first,
    fed the program's tokens before it."""
    seqs, spans = _spans(reqs)
    with float32_exact():
        low = logits_at(weights, hf, seqs, spans, "fp8")
    return [Served(r.prompt, lg.argmax(dim=-1).tolist(), context=r.tokens)
            for r, lg in zip(reqs, low)]
