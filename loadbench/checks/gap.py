"""The widest gap: each sampled request, its prompt with its served tokens
appended, runs through the family's plain reference in float32; for each
served token the number read is the gap by which the reference's logit of
that token lies below the reference's best logit at that position, and the
run's number is the widest gap over the sample. Greedy decoding serves the
program's own best token, so a sound run reads only the rounding between
the program's bf16 and the reference's float32 (near ties); a wrong token
reads the reference's full margin."""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from loadbench.check import Served, positions
from loadbench.reference import float32_exact


def read(reference, weights: Dict[str, torch.Tensor], hf: dict,
         requests: Sequence[Served]) -> Dict[str, float]:
    """``{"max_gap": ..., "tokens": ...}`` of the judged tokens, with the
    mean, the 90th percentile and the share of tokens that are not the
    reference's best."""
    seqs, spans = positions(requests)
    with float32_exact():
        ref = reference.logits_at(weights, hf, seqs, spans, "fp32")
    judged = []
    for r, lg in zip(requests, ref):
        tok = torch.as_tensor(r.tokens, device=lg.device)
        judged.append(lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0])
    g = torch.cat(judged)
    return {"max_gap": float(g.max()), "mean_gap": float(g.mean()),
            "p90_gap": float(torch.quantile(g, 0.9)),
            "off_share": float((g > 0).float().mean()), "tokens": float(g.numel())}
