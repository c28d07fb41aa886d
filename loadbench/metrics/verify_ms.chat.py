"""Host milliseconds of the verify pass with acceptance and commit a round:
the program's ``spec.verify`` spans over its ``session.round`` spans, in
the window."""

from loadbench.spans import per_round_ms


def read(run):
    return per_round_ms(run, "spec.verify")
