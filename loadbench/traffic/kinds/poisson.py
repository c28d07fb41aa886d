"""Open loop: Poisson arrivals at the cell's rate.

The schedule has three blocks: a ramp before the window (not counted), the
window, and a tail after it that keeps the load on until every request due
in the window has finished. In each block the prompt lengths, the output
budgets and the gaps between arrivals are stratified draws (the quantiles
(i + 0.5) / n of their distributions), permuted by the seed, and the gaps
are scaled to fill the block exactly: every seed offers the same work and
the same number of requests, in another order. Token ids are drawn from the
seed.

Mix keys: ``prompt`` and ``output``, each ``{"dist": "lognormal" |
"uniform", "median", "sigma", "min", "max"}``. Cell keys: ``rate_rps``,
``ramp_s``, ``tail_s``.
"""

from __future__ import annotations

from typing import List

import numpy as np

from loadbench.traffic import Planned, lengths, rng, tokens


def schedule(mix: dict, cell: dict, seed: int, seconds: float, vocab: int
             ) -> List[Planned]:
    rate = float(cell["rate_rps"])
    out, start = [], 0.0
    blocks = (("ramp", float(cell["ramp_s"])), ("window", float(seconds)),
              ("tail", float(cell["tail_s"])))
    for b, (phase, dur) in enumerate(blocks):
        n = max(int(round(rate * dur)), 1)
        g = rng(seed, b)
        prompt = lengths(n, mix["prompt"])[g.permutation(n)]
        budget = lengths(n, mix["output"])[g.permutation(n)]
        u = (np.arange(n) + 0.5) / n
        gaps = (-np.log1p(-u))[g.permutation(n)]
        gaps *= dur / gaps.sum()
        due = start + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        for i in range(n):
            out.append(Planned(float(due[i]), tokens(g, int(prompt[i]), vocab),
                               int(budget[i]), phase))
        start += dur
    return out
