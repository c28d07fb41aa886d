"""Host milliseconds of the early-exit draft passes a round: the program's
``spec.draft`` spans over its ``session.round`` spans, in the window."""

from loadbench.spans import per_round_ms


def read(run):
    return per_round_ms(run, "spec.draft")
