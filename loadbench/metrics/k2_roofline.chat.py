"""K2's share of its roofline: the summed ``paged_bound`` of the calls
recorded in the profiled stretch over K2's summed device time there."""

from loadbench.readers import roofline


def read(run):
    return roofline(run, "k2", "paged_decode_kernel")
