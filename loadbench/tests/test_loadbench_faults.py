"""``correct`` against a broken timed path, and the control, at a tiny size
on the CPU: a run drives the whole harness (traffic, the scheduler's
thread, the session, the reference) with the look for a card skipped.

The tiny cell's limit on the widest gap is 0.01: sound runs of its bf16
program read 0.0014-0.0029 on seeds 1 and 2, the float8 control
0.034-0.036."""

import dataclasses

import pytest
import torch

from loadbench import run as bench
from loadbench.tests.tiny import tiny_cell
from loadbench.families.mistral import make_weights

CPU = torch.device("cpu")
LIMIT = 0.01


def _cell(**settings):
    cell = tiny_cell()
    return dataclasses.replace(cell, settings=dict(cell.settings, limits={"max_gap": LIMIT},
                                                   **settings))


def _correct(cell, seed=1):
    run, peak, compared = bench.measure(cell, seed, 3.0, False, CPU)
    line = bench.result_line(cell, run, peak, compared, False, CPU)
    return line["correct"], compared


def test_a_sound_run_is_correct():
    ok, compared = _correct(_cell())
    assert ok, compared
    assert compared["max_gap"]["value"] < LIMIT


def test_a_token_altered_where_it_is_produced_is_not_correct(monkeypatch):
    from layerskip_tpu_torch.generation.continuous import ContinuousSession

    step = ContinuousSession.step

    def altered(self, max_rounds=1):
        out = step(self, max_rounds)
        return [(r, [(toks[0] + 1) % 512 or 3] + toks[1:], a) for r, toks, a in out]

    monkeypatch.setattr(ContinuousSession, "step", altered)
    ok, compared = _correct(_cell())
    assert not ok
    assert compared["max_gap"]["value"] > LIMIT


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    from layerskip_tpu_torch.generation.continuous import ContinuousSession

    step = ContinuousSession.step

    def half(self, max_rounds=1):
        return [f for f in step(self, max_rounds) if f[0] % 2 == 0]

    monkeypatch.setattr(ContinuousSession, "step", half)
    ok, compared = _correct(_cell(tail_s=3))
    assert not ok
    assert compared["missing"]["value"] > 0


@pytest.mark.parametrize("seed", [1, 2])
def test_the_float8_control_in_the_programs_place_is_not_correct(seed):
    cell = _cell()
    run, peak, compared = bench.measure(cell, seed, 3.0, False, CPU)
    w = make_weights(cell.config, cell.exit_layer, cell.tail_eps, seed, CPU)
    ctl = bench.judge(cell, run, w, seed, control=True)
    assert bench.result_line(cell, run, peak, compared, False, CPU)["correct"]
    assert not bench.result_line(cell, run, peak, ctl, False, CPU)["correct"]
    assert compared["max_gap"]["value"] < LIMIT < ctl["max_gap"]["value"]


@pytest.mark.gpu
def test_a_benchmark_run_on_the_card_is_correct():
    """One short run of the first cell through the command line (on the card)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the port's kernels)")
    p = subprocess.run([sys.executable, "-m", "loadbench.run", "--workload",
                        "mistral-7b.chat", "--seed", str(2 ** 31 + 11), "--seconds", "5",
                        "--trace", "0"], cwd=Path(__file__).resolve().parents[2],
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
