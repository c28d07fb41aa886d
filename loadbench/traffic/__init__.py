"""Traffic: a mix is a data file ``traffic/<name>.json`` whose ``kind``
names the generator ``traffic/kinds/<kind>.py`` that reads it."""

from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

FIRST_TOKEN_ID = 3  # ids 0-2 are the unknown, begin and end tokens


@dataclass
class Planned:
    due: float  # seconds after the schedule's start (open loop)
    prompt: List[int]
    budget: int  # output tokens: no end token is set, so the budget is the length
    phase: str  # "ramp", "window" or "tail"; closed loops: "" (set when sent)
    client: Optional[int] = None  # closed loops: the client that sends it


def rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), *salt])


def stratified_lognormal(n: int, dist: dict) -> np.ndarray:
    """``n`` lengths at the quantiles (i + 0.5) / n of a lognormal of the
    given ``median`` and ``sigma``, rounded and clipped to [min, max]: the
    same multiset for every seed."""
    z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.rint(dist["median"] * np.exp(dist["sigma"] * z))
    return np.clip(x, dist["min"], dist["max"]).astype(np.int64)


def stratified_uniform(n: int, dist: dict) -> np.ndarray:
    """``n`` integers at the quantiles (i + 0.5) / n of [min, max]."""
    u = (np.arange(n) + 0.5) / n
    return np.rint(dist["min"] + u * (dist["max"] - dist["min"])).astype(np.int64)


LENGTHS = {"lognormal": stratified_lognormal, "uniform": stratified_uniform}


def lengths(n: int, dist: dict) -> np.ndarray:
    return LENGTHS[dist["dist"]](n, dist)


def tokens(g: np.random.Generator, n: int, vocab: int) -> List[int]:
    return g.integers(FIRST_TOKEN_ID, vocab, size=n).tolist()
