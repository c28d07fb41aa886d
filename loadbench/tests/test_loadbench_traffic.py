"""The traffic generators: deterministic by seed, the same work for every
seed, the stated lengths and rate."""

import numpy as np
import pytest

from loadbench import catalog
from loadbench.traffic import FIRST_TOKEN_ID, lengths

CHAT = catalog.cell("mistral-7b.chat")


def _schedule(seed, seconds=45.0, rate=3.0):
    kind = catalog.load_module("traffic/kinds", "poisson")
    st = dict(CHAT.settings, rate_rps=rate)
    return kind.schedule(CHAT.traffic, st, seed, seconds, 32000)


def test_poisson_is_deterministic_by_seed():
    a, b = _schedule(2 ** 31 + 17), _schedule(2 ** 31 + 17)
    assert [(p.due, p.prompt, p.budget, p.phase) for p in a] == \
        [(p.due, p.prompt, p.budget, p.phase) for p in b]
    c = _schedule(5)
    assert [p.prompt for p in a] != [p.prompt for p in c]


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 + 5])
def test_poisson_offers_the_same_work_to_every_seed(seed):
    ref, got = _schedule(1), _schedule(seed)
    st = CHAT.settings
    ends = {"ramp": st["ramp_s"], "window": st["ramp_s"] + 45.0,
            "tail": st["ramp_s"] + 45.0 + st["tail_s"]}
    for phase in ("ramp", "window", "tail"):
        r = [p for p in ref if p.phase == phase]
        g = [p for p in got if p.phase == phase]
        assert sorted(len(p.prompt) for p in r) == sorted(len(p.prompt) for p in g)
        assert sorted(p.budget for p in r) == sorted(p.budget for p in g)
        gaps = [np.diff([p.due for p in x] + [ends[phase]]) for x in (r, g)]
        assert np.allclose(sorted(gaps[0]), sorted(gaps[1]))


def test_poisson_keeps_rate_and_lengths():
    seconds, rate = 45.0, 3.0
    plan = _schedule(9, seconds, rate)
    st = CHAT.settings
    win = [p for p in plan if p.phase == "window"]
    assert len(win) == round(rate * seconds)
    assert st["ramp_s"] <= win[0].due < st["ramp_s"] + 1e-9
    assert win[-1].due < st["ramp_s"] + seconds
    assert all(a.due <= b.due for a, b in zip(plan, plan[1:]))
    mix = CHAT.traffic
    for p in plan:
        assert mix["prompt"]["min"] <= len(p.prompt) <= mix["prompt"]["max"]
        assert mix["output"]["min"] <= p.budget <= mix["output"]["max"]
        assert min(p.prompt) >= FIRST_TOKEN_ID and max(p.prompt) < 32000
    med = float(np.median([len(p.prompt) for p in win]))
    assert abs(med - mix["prompt"]["median"]) <= 0.1 * mix["prompt"]["median"]


def test_stratified_lengths_follow_their_distribution():
    x = lengths(1001, {"dist": "lognormal", "median": 128, "sigma": 0.6, "min": 1,
                       "max": 10 ** 6})
    assert np.median(x) == 128
    u = lengths(5, {"dist": "uniform", "min": 512, "max": 2048})
    assert u.tolist() == [666, 973, 1280, 1587, 1894]


def test_closed_loop_deals_the_same_multiset():
    kind = catalog.load_module("traffic/kinds", "closed")
    mix = {"prompt": {"dist": "uniform", "min": 512, "max": 2048},
           "output": {"dist": "uniform", "min": 256, "max": 256}, "strata": 4}
    st = {"clients": 4, "requests_per_client": 8}
    a, b = kind.schedule(mix, st, 1, 10, 1000), kind.schedule(mix, st, 2, 10, 1000)
    assert len(a) == 32 and [p.client for p in a] == [i % 4 for i in range(32)]
    for i in range(0, 32, 4):  # every block of 4 holds the same lengths
        assert sorted(len(p.prompt) for p in a[i:i + 4]) == [704, 1088, 1472, 1856]
        assert sorted(len(p.prompt) for p in b[i:i + 4]) == [704, 1088, 1472, 1856]
    assert [len(p.prompt) for p in a] != [len(p.prompt) for p in b]
    assert all(p.budget == 256 for p in a)
