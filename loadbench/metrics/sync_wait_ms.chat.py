"""Host milliseconds waiting on the device a round: the program's ``sync``
spans (every device-to-host read and blocking copy on the scheduler's
path) over its ``session.round`` spans, in the window."""

from loadbench.spans import per_round_ms


def read(run):
    return per_round_ms(run, "sync")
