"""The least time one mixture-of-experts layer call could take on the chip,
whatever path computes it: the larger of its routed FLOPs over the peak
rate and its bytes over the memory rate.

FLOPs: 2 · 3 · D · F for each of the n · k (token, expert) assignments
(gate, up and down), plus 2 · D · E a token for the router. Bytes: the
weights of each expert the call hit (3 · D · F) read once, the router's
(D · E) once, and the tokens in and out (2 · n · D)."""

from __future__ import annotations

from typing import Tuple

from loadbench.yardstick.roofline import _seconds


def moe_bound(n: int, k: int, n_experts: int, d: int, f: int, hit: int,
              esize: int) -> Tuple[float, str]:
    """(seconds, what bounds it) of a call over ``n`` tokens, each routed to
    ``k`` of ``n_experts`` experts of width ``f``, that hit ``hit`` distinct
    experts, in elements of ``esize`` bytes."""
    flops = 2.0 * 3 * d * f * n * k + 2.0 * n * d * n_experts
    nbytes = esize * (hit * 3 * d * f + d * n_experts + 2 * n * d)
    return _seconds(nbytes, flops, esize)
