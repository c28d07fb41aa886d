"""Closed loop: ``clients`` clients, each sending its next request when its
previous one has come back.

Each client holds ``requests_per_client`` requests, more than a run can
send. The requests come in blocks of ``strata`` (a mix key): in each block
the prompt lengths and output budgets are stratified draws (the quantiles
(i + 0.5) / strata of their distributions), permuted by the seed, so the
first k blocks sent hold the same lengths for every seed. They are dealt
out to the clients in turn. Token ids are drawn from the seed. A
request's phase (ramp, window or tail) is the part of the run it is sent
in.

Mix keys: ``prompt`` and ``output`` as for ``poisson``, and ``strata``.
Cell keys: ``clients``, ``requests_per_client``, ``ramp_s``, ``tail_s``.
"""

from __future__ import annotations

from typing import List

from loadbench.traffic import Planned, lengths, rng, tokens


def schedule(mix: dict, cell: dict, seed: int, seconds: float, vocab: int
             ) -> List[Planned]:
    clients, per = int(cell["clients"]), int(cell["requests_per_client"])
    k = int(mix["strata"])
    g = rng(seed, 7)
    prompt_q, budget_q = lengths(k, mix["prompt"]), lengths(k, mix["output"])
    out = []
    for i in range(-(-clients * per // k)):
        for p, b in zip(prompt_q[g.permutation(k)], budget_q[g.permutation(k)]):
            out.append(Planned(0.0, tokens(g, int(p), vocab), int(b), "",
                               client=len(out) % clients))
    return out
