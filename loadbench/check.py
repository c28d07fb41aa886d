"""What every cell's comparison shares: the sample of served requests it
judges, and the control that takes the program's place.

Once the window has closed, a sample of the requests the program finished,
drawn from the seed and holding the one with the most served tokens, is
handed to the cell's check (``checks/<check>.py``, ``gap`` where the cell
names none) with the configuration family's plain reference
(``reference/<family>.py``), each request with the records the program
kept for it.

The control takes the program's place in the same check: at each position
of the same prompts and served tokens, the token that the family's
reference computed in float8 (``precision="fp8"``) puts first is judged
instead of the program's (``control_tokens``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from loadbench.reference import float32_exact


@dataclass
class Served:
    prompt: List[int]
    tokens: List[int]  # the tokens judged
    context: Optional[List[int]] = None  # the tokens fed after the prompt, if not these
    records: dict = field(default_factory=dict)  # what the program kept for the request


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


def positions(reqs: Sequence[Served]):
    """(sequences, spans) for ``logits_at``: each prompt with the tokens fed
    after it, and the positions whose logits predict the judged tokens."""
    fed = [r.tokens if r.context is None else r.context for r in reqs]
    seqs = [r.prompt + f[:-1] for r, f in zip(reqs, fed)]
    spans = [(len(r.prompt) - 1, len(r.prompt) - 1 + len(f)) for r, f in zip(reqs, fed)]
    return seqs, spans


def control_tokens(reference, weights: Dict[str, torch.Tensor], hf: dict,
                   reqs: Sequence[Served]) -> List[Served]:
    """The control in the program's place: at each served position of these
    requests, the token that the family's reference computed in float8 puts
    first, fed the program's tokens before it."""
    seqs, spans = positions(reqs)
    with float32_exact():
        low = reference.logits_at(weights, hf, seqs, spans, "fp8")
    return [Served(r.prompt, lg.argmax(dim=-1).tolist(), context=r.tokens,
                   records=r.records)
            for r, lg in zip(reqs, low)]
