"""Every entry and traffic kind drives a whole tiny run on the CPU and comes
out correct, with the metrics the run can read there."""

import dataclasses

import pytest
import torch

from loadbench import run as bench
from loadbench.tests.tiny import tiny_cell

CPU = torch.device("cpu")
CLOSED = {"kind": "closed", "prompt": {"dist": "uniform", "min": 20, "max": 60},
          "output": {"dist": "uniform", "min": 12, "max": 12}, "strata": 4}


def _cells():
    chat = tiny_cell()
    longdoc = dataclasses.replace(chat, name="tiny.longdoc", traffic=CLOSED,
                                  settings=dict(chat.settings, clients=4,
                                                requests_per_client=100))
    return {"chat": chat, "longdoc": longdoc}


@pytest.mark.parametrize("which", ["chat", "longdoc"])
def test_a_tiny_run_is_correct_and_reads_its_window(which):
    cell = _cells()[which]
    run, _, compared = bench.measure(cell, 2 ** 31 + 7, 2.0, True, CPU)
    assert all(c["value"] <= c["limit"] for c in compared.values()), compared
    window = run.window_requests
    assert window and all(r.tokens is not None and len(r.tokens) == r.budget
                          for r in window)
    assert run.tokens_in_window() > 0 and run.setup_s > 0
    assert run.measured.tokens > 0 and run.measured.flops > 0
    assert run.traced.tokens > 0  # the profiled stretch after the window
    assert run.acceptance is not None and 0 < run.acceptance <= 1
    assert all(r.admitted_wall >= r.due_wall - 1e-3 for r in window)
    assert run.measured.rounds > 0
