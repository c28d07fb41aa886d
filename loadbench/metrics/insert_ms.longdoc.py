"""Median host milliseconds of the program's ``session.insert`` spans in the
window (host arrays, page allocation, the prefill's launches and the
copies that wait on the device)."""

from loadbench.spans import median_ms


def read(run):
    return median_ms(run, "session.insert")
