"""K2's share of its roofline: the summed ``paged_bound`` of the calls the
program recorded in the profiled stretch (``RECORDS.k2``, the draft
graph's replays included) over K2's summed device time there."""

from loadbench.spans import roofline_from_records


def read(run):
    return roofline_from_records(run, "k2", "paged_decode_kernel")
