"""The widest gap with the program's expert choices followed: each sampled
request, its prompt with its served tokens appended, runs through the
family's ``routed_logits_at`` in float32 with the route records the
program kept for it (``records["routes"]``, uint8 [L, positions, k]) and
the configuration's ``route_margin``; the gap of each served token is read
as ``checks/gap.py`` reads it.

``max_gap``: the widest such gap. ``route_mismatch``: positions × MoE
layers where the program chose another expert set than the reference,
which the reference's router puts further than ``route_margin`` from its
own (a flip that rounding cannot explain). ``routes_missing``: fed
positions × MoE layers with no record (a program that keeps none misses
them all). ``followed_share``: the share of positions × layers where the
reference followed the program's set, reported (its limit, 1, is the
whole). ``widest_followed`` and ``widest_differing``: the widest stray a
followed set and any differing set needed, for setting the margin."""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from loadbench.check import Served, positions
from loadbench.reference import float32_exact


def read(reference, weights: Dict[str, torch.Tensor], hf: dict,
         requests: Sequence[Served]) -> Dict[str, float]:
    seqs, spans = positions(requests)
    routes = [r.records.get("routes") for r in requests]
    with float32_exact():
        ref, tally = reference.routed_logits_at(weights, hf, seqs, spans, routes,
                                                float(hf["route_margin"]), "fp32")
    judged = []
    for r, lg in zip(requests, ref):
        tok = torch.as_tensor(r.tokens, device=lg.device)
        judged.append(lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0])
    g = torch.cat(judged)
    return {"max_gap": float(g.max()), "mean_gap": float(g.mean()),
            "p90_gap": float(torch.quantile(g, 0.9)),
            "route_mismatch": float(tally["mismatch"]),
            "routes_missing": float(tally["missing"]),
            "followed_share": tally["followed"] / max(tally["judged"], 1),
            "widest_followed": tally["widest_followed"],
            "widest_differing": tally["widest_differing"],
            "tokens": float(g.numel())}
